"""The PyTorch port's slice as a whole (GGUF -> ModelLoader -> ModelRunner ->
Engine) against the JAX package on the same GGUF, on the CPU."""

import numpy as np
import pytest
import torch

import jax

from fixtures import make_tiny_model

from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.engine import runner as jrunner
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler
from llama_gguf_tpu.utils import synthetic as jsynthetic
from llama_gguf_tpu.utils.synthetic import build_synthetic_gguf

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.convert import kv_from_numpy, params_from_numpy
from llama_gguf_tpu_torch.engine import runner as trunner
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.models.transformer import forward
from llama_gguf_tpu_torch.ops.linear import (DenseLinear, QuantEmbedding,
                                             QuantExpertStack, QuantLinear)
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils import synthetic as tsynthetic

torch.set_num_threads(1)

PROMPT = "The quick brown fox jumps over the lazy dog, again and again."
VARIANTS = {
    # make_tiny_model: K >= 256 so the K-quants do not fall back; F32 table
    "llama-q4k": dict(arch="llama", quant=GGMLType.Q4_K),
    "llama-q6k": dict(arch="llama", quant=GGMLType.Q6_K),
    "qwen2-q4k": dict(arch="qwen2", quant=GGMLType.Q4_K),  # biases, NeoX
    # synthetic presets: quantized embedding table (Q6_K at hidden 256, Q8_0
    # at 128), Q5_1 fallback for K=128, tied QuantLinear LM head
    "small": dict(preset="small"),
    "tiny-tied": dict(preset="tiny-tied"),
    # sparse MoE (Mixtral convention, top-2): tiny-moe's hidden 128 makes
    # gate/up Q5_1 (q8 with mins); moe-h256 has Q4_K gate/up experts (q4
    # with mins) over 8 experts; Q6_K down (q8 without mins) in both
    "tiny-moe": dict(preset="tiny-moe"),
    "moe-h256": dict(preset="moe-h256"),
}
# written by both packages' MoE builders, registered for the build only
# (vocab, hidden, layers, heads, kv_heads, ffn, ctx, experts, topk)
TEST_MOE_PRESETS = {"moe-h256": (512, 256, 2, 4, 2, 512, 256, 8, 2)}
# f32 through two layers with a reassociated product, logits of order 1
LOGIT_ATOL = 1e-3


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m") / f"{request.param}.gguf")
    kw = VARIANTS[request.param]
    if "preset" in kw:
        with pytest.MonkeyPatch.context() as mp:
            for mod in (jsynthetic, tsynthetic):
                for name, geometry in TEST_MOE_PRESETS.items():
                    mp.setitem(mod.MOE_PRESETS, name, geometry)
            build_synthetic_gguf(path, preset=kw["preset"],
                                 quant=GGMLType.Q4_K)
    else:
        make_tiny_model(path, hidden=256, ffn=512, vocab=512, tokenizer=True,
                        **kw)
    jeng = JEngine.load(path, JConfig(weight_mode="quant"))
    teng = Engine.load(path, EngineConfig(weight_mode="quant"), device="cpu")
    return path, jeng, teng


def _prefill_logits(eng, ids):
    kv = eng.runner.init_kv()
    logits, _, _ = eng.runner.prefill(ids, kv)
    return np.asarray(logits) if not torch.is_tensor(logits) \
        else logits.numpy()


LAYOUTS = {  # variant: (wqkv source type, embedding kind, LM head type,
    #          MoE (fmt, group, mins?) of gate/up and of down)
    "llama-q4k": ("Q4_K", None, "Q4_K", None),
    "llama-q6k": ("Q6_K", None, "Q6_K", None),
    "qwen2-q4k": ("Q4_K", None, "Q4_K", None),
    "small": ("Q4_K", "Q6_K", "Q6_K", None),
    "tiny-tied": ("Q5_1", "Q8_0", "Q8_0", None),
    "tiny-moe": ("Q5_1", "Q5_1", "Q5_1", (("q8", 32, True),
                                         ("q8", 16, False))),
    "moe-h256": ("Q4_K", "Q6_K", "Q6_K", (("q4", 32, True),
                                         ("q8", 16, False))),
}


def test_loaded_layout(pair, request):
    _, _, teng = pair
    qkv_type, emb_type, head_type, experts = LAYOUTS[request.node.callspec.id]
    params = teng.runner.params
    layer = params["layers"][0]
    assert isinstance(layer["attn"]["wqkv"], QuantLinear)
    assert layer["attn"]["wqkv"].source_type == qkv_type
    if experts is None:
        assert isinstance(layer["ffn"]["gate_up"], QuantLinear)
        assert len(set(layer["ffn"]["gate_up"].splits)) == 1
    else:
        assert isinstance(layer["ffn"]["router"], DenseLinear)
        for key, want in zip(("gate", "up", "down"),
                             (experts[0], experts[0], experts[1])):
            st = layer["ffn"]["experts"][key]
            assert isinstance(st, QuantExpertStack)
            assert (st.fmt, st.group, st.mins is not None) == want
    assert isinstance(params["embed"], QuantEmbedding) == bool(emb_type)
    assert params["output"].source_type == head_type


def test_prefill_logits_match_jax(pair):
    _, jeng, teng = pair
    ids = jeng.tokenizer.encode(PROMPT)
    assert teng.tokenizer.encode(PROMPT) == ids
    want, got = _prefill_logits(jeng, ids), _prefill_logits(teng, ids)
    assert got.shape == want.shape == (teng.runner.cfg.vocab_size,)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_greedy_tokens_identical(pair):
    _, jeng, teng = pair
    ids = jeng.tokenizer.encode(PROMPT)
    want = jeng.greedy_tokens(ids, 16)
    assert len(want) == 16
    assert teng.greedy_tokens(ids, 16) == want


@pytest.mark.parametrize("sampling", ["greedy", "seeded"])
def test_generate_same_text(pair, sampling):
    _, jeng, teng = pair
    kw = dict(temperature=0.0) if sampling == "greedy" else dict(seed=11)
    want = jeng.generate(PROMPT, max_tokens=12, sampler=JSampler(**kw))
    got = teng.generate(PROMPT, max_tokens=12, sampler=SamplerConfig(**kw))
    assert got == want
    assert teng.stats.prompt_tokens == jeng.stats.prompt_tokens
    assert teng.stats.generated_tokens == jeng.stats.generated_tokens


def test_stop_strings_like_jax(pair):
    _, jeng, teng = pair
    greedy = dict(temperature=0.0)
    text = jeng.generate(PROMPT, max_tokens=12, sampler=JSampler(**greedy))
    stop = [text[3:5]] if len(text) >= 5 else ["\n"]
    want = list(jeng.generate_streaming(PROMPT, 12, JSampler(**greedy),
                                        stop=stop))
    got = list(teng.generate_streaming(PROMPT, 12, SamplerConfig(**greedy),
                                       stop=stop))
    assert "".join(got) == "".join(want)


def test_params_from_numpy_same_logits(pair):
    """The JAX package's params, carried across, give the port's own
    loader's logits."""
    _, jeng, teng = pair
    tree = jax.tree_util.tree_map(np.asarray, jeng.runner.params)
    params = params_from_numpy(tree, "cpu")
    ids = jeng.tokenizer.encode(PROMPT)
    cfg = teng.runner.cfg
    t = len(ids)
    toks = torch.tensor([ids], dtype=torch.int32)
    pos = torch.arange(t, dtype=torch.int32)[None]
    lens = torch.tensor([t], dtype=torch.int32)
    outs = []
    for p in (params, teng.runner.params):
        kv = teng.runner.init_kv()
        with torch.no_grad():
            logits, _ = forward(p, cfg, toks, pos, kv, lens)
        outs.append(logits.numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-6)


def test_kv_from_numpy_continues_jax_prefill(pair):
    """A KV cache prefilled by the JAX package, carried across, decodes the
    next token's logits as the JAX package does."""
    _, jeng, teng = pair
    ids = jeng.tokenizer.encode(PROMPT)
    jkv = jeng.runner.init_kv()
    logits, jkv, pos = jeng.runner.prefill(ids, jkv)
    tok = int(np.argmax(np.asarray(logits)))
    tkv = kv_from_numpy(jax.tree_util.tree_map(np.asarray, jkv), "cpu")
    want, _ = jeng.runner.decode_one(tok, pos, jkv)
    got, _ = teng.runner.decode_one(tok, pos, tkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)


def test_dequant_mode_matches_quant_mode(pair):
    path, jeng, teng = pair
    deq = Engine.load(path, EngineConfig(weight_mode="dequant"), device="cpu")
    assert not isinstance(deq.runner.params["layers"][0]["attn"]["wqkv"],
                          QuantLinear)
    ids = jeng.tokenizer.encode(PROMPT)
    np.testing.assert_allclose(_prefill_logits(deq, ids),
                               _prefill_logits(teng, ids), rtol=0, atol=1e-4)
    assert deq.greedy_tokens(ids, 8) == teng.greedy_tokens(ids, 8)


def test_greedy_decode_matches_greedy_tokens(pair):
    _, jeng, teng = pair
    ids = jeng.tokenizer.encode(PROMPT)
    want = teng.greedy_tokens(ids, 10)
    r = teng.runner
    kv = r.init_kv()
    logits, kv, pos = r.prefill(ids, kv)
    first = int(torch.argmax(logits))
    toks, _ = r.greedy_decode([first], [pos], kv, 9)
    assert toks.shape == (1, 9)
    assert [first] + toks[0].tolist() == want


def test_runner_helpers_match_jax():
    for n in (1, 7, 8, 9, 100, 513, 4096, 5000):
        assert trunner.bucket_len(n) == jrunner.bucket_len(n)
    for n in (0, 1, 255, 256, 257, 1000, 2047, 2048, 3000):
        assert trunner.read_bucket(n, 2048) == jrunner.read_bucket(n, 2048)
    for start, steps in ((0, 1), (100, 32), (250, 300), (2040, 20)):
        assert trunner.ModelRunner.plan_segments(start, steps, 2048) == \
            jrunner.ModelRunner.plan_segments(start, steps, 2048)


def test_unported_options_raise(pair):
    """matmul_precision="default" is ported (held against the JAX package by
    tests/test_torch_precision.py): it loads and gives bf16-rounded kernel
    outputs near the "highest" logits. The i8 KV cache (ported since the
    other formats were) loads and gives an i8 cache with its scales."""
    path, jeng, teng = pair
    eng = Engine.load(path, EngineConfig(matmul_precision="default"),
                      device="cpu")
    assert eng.runner.matmul_precision == "default"
    ids = jeng.tokenizer.encode(PROMPT)
    got, want = _prefill_logits(eng, ids), _prefill_logits(teng, ids)
    assert np.isfinite(got).all() and got.shape == want.shape
    assert not np.array_equal(got, want)  # the bf16 roundings took place
    # bf16 rounding of every kernel output through two layers moves the
    # logits by a few bf16 ulps of max |logit| (2^-7 relative each)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -5 * np.abs(want).max())
    kv = Engine.load(path, EngineConfig(kv_format="i8"),
                     device="cpu").runner.init_kv()
    assert kv["k"][0].dtype == torch.int8 and "k_scale" in kv


def test_cli_run_and_info(pair, capsys):
    path, jeng, _ = pair
    rc = cli.main(["run", path, "-p", PROMPT, "-n", "6", "-t", "0",
                   "--device", "cpu", "--no-stream"])
    out = capsys.readouterr()
    assert rc == 0
    want = jeng.generate(PROMPT, max_tokens=6,
                         sampler=JSampler(temperature=0.0))
    assert out.out == want + "\n"
    assert "decode" in out.err
    assert cli.main(["info", path, "--json"]) == 0
    assert '"tensor_count"' in capsys.readouterr().out
