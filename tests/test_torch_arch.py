"""Architectures the port loads differently from a llama decoder, against the
JAX package on the CPU: Apertus's per-layer xIELU FFN, and the encoder
model kinds (BERT, T5, t5encoder) through Engine.load and load_model."""

import numpy as np
import pytest
import torch

from fixtures import add_quant_tensor
from test_bert_mamba import build_bert_gguf

from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.gguf.writer import GGUFWriter as JWriter
from llama_gguf_tpu.models.loader import load_model as jload_model
from llama_gguf_tpu.utils.synthetic import build_synthetic_t5

from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.writer import GGUFWriter
from llama_gguf_tpu_torch.models.loader import load_model

torch.set_num_threads(1)

# vocab, hidden, layers, heads, kv heads, head dim, ffn, ctx
APERTUS = dict(vocab=300, hidden=64, layers=2, heads=4, kv=2, hd=16, ffn=96,
               ctx=64)
PROMPT = "xIELU: a quick brown fox."
# f32 through two layers with a reassociated product, relative to max |logit|
LOGIT_RTOL = 1e-3


def write_apertus(path, writer, ffn_quant, xielu=True, seed=0):
    """A random-weight Apertus GGUF: no-gate FFN, per-head QK-norm, and the
    four per-layer apertus.xielu.* metadata arrays (unless ``xielu`` is
    False). ``writer``: either package's GGUFWriter class."""
    c, a = APERTUS, "apertus"
    rng = np.random.default_rng(seed)
    w = writer()
    w.add_metadata("general.architecture", a)
    for key, val in [("embedding_length", c["hidden"]),
                     ("block_count", c["layers"]),
                     ("attention.head_count", c["heads"]),
                     ("attention.head_count_kv", c["kv"]),
                     ("attention.key_length", c["hd"]),
                     ("attention.value_length", c["hd"]),
                     ("feed_forward_length", c["ffn"]),
                     ("context_length", c["ctx"]),
                     ("vocab_size", c["vocab"])]:
        w.add_metadata(f"{a}.{key}", val)
    w.add_metadata(f"{a}.attention.layer_norm_rms_epsilon", 1e-5)
    w.add_metadata(f"{a}.rope.freq_base", 10000.0)
    if xielu:
        # effective constants: alpha_p = softplus(.), alpha_n = beta +
        # softplus(.), a different pair per layer
        sp = np.log1p(np.exp(rng.uniform(-1.0, 1.0, (2, c["layers"]))))
        beta = np.full(c["layers"], 0.5, np.float32)
        w.add_metadata(f"{a}.xielu.alpha_p", sp[0].astype(np.float32))
        w.add_metadata(f"{a}.xielu.alpha_n", (beta + sp[1]).astype(np.float32))
        w.add_metadata(f"{a}.xielu.beta", beta)
        w.add_metadata(f"{a}.xielu.eps", np.full(c["layers"], -1e-6,
                                                 np.float32))
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    toks += [f"tok{i}" for i in range(len(toks), c["vocab"])]
    w.add_metadata("tokenizer.ggml.model", "llama")
    w.add_metadata("tokenizer.ggml.tokens", toks)
    w.add_metadata("tokenizer.ggml.scores", np.zeros(c["vocab"], np.float32))
    w.add_metadata("tokenizer.ggml.token_type", np.array(
        [2, 3, 3] + [6] * 256 + [1] * (c["vocab"] - 259), np.int32))
    w.add_metadata("tokenizer.ggml.bos_token_id", 1)
    w.add_metadata("tokenizer.ggml.eos_token_id", 2)

    def put(name, *shape, q=GGMLType.F32, offset=0.0):
        arr = (rng.standard_normal(shape) * 0.3 + offset).astype(np.float32)
        add_quant_tensor(w, name, arr, q)

    h, hd = c["hidden"], c["hd"]
    put("token_embd.weight", c["vocab"], h)
    for i in range(c["layers"]):
        p = f"blk.{i}"
        put(f"{p}.attn_q.weight", c["heads"] * hd, h)
        put(f"{p}.attn_k.weight", c["kv"] * hd, h)
        put(f"{p}.attn_v.weight", c["kv"] * hd, h)
        put(f"{p}.attn_output.weight", h, c["heads"] * hd)
        put(f"{p}.attn_q_norm.weight", hd, offset=1.0)
        put(f"{p}.attn_k_norm.weight", hd, offset=1.0)
        put(f"{p}.attn_norm.weight", h, offset=1.0)
        put(f"{p}.ffn_norm.weight", h, offset=1.0)
        put(f"{p}.ffn_up.weight", c["ffn"], h, q=ffn_quant)
        put(f"{p}.ffn_down.weight", h, c["ffn"], q=ffn_quant)
    put("output_norm.weight", h, offset=1.0)
    put("output.weight", c["vocab"], h)
    w.write_to_path(path)


@pytest.fixture(scope="module", params=["F32", "Q8_0"])
def apertus(request, tmp_path_factory):
    """The same Apertus GGUF written by each package's writer (the up and
    down weights in the parameter's format), loaded by each package."""
    d = tmp_path_factory.mktemp("apertus")
    quant = GGMLType[request.param]
    paths = [str(d / f"{who}.gguf") for who in ("jax", "torch")]
    write_apertus(paths[0], JWriter, quant)
    write_apertus(paths[1], GGUFWriter, quant)
    with open(paths[0], "rb") as fa, open(paths[1], "rb") as fb:
        assert fa.read() == fb.read()
    jeng = JEngine.load(paths[0], JConfig(weight_mode="quant"))
    teng = Engine.load(paths[1], EngineConfig(weight_mode="quant"),
                       device="cpu")
    return jeng, teng


def test_apertus_loads_per_layer_xielu(apertus):
    _, teng = apertus
    layers = teng.runner.params["layers"]
    consts = [layer["ffn"]["xielu"] for layer in layers]
    assert len(consts) == APERTUS["layers"] and consts[0] != consts[1]
    for ap, an, beta, eps in consts:
        assert ap > 0 and an > beta == 0.5 and eps == pytest.approx(-1e-6)
    assert all("gate" not in layer["ffn"] for layer in layers)


def test_apertus_logits_and_tokens_match_jax(apertus):
    """Within 1e-3 of max |logit| (the JAX package applies the same xIELU;
    the port once fell through to SiLU and was 6.78 off at 8.64), and the
    same greedy tokens."""
    jeng, teng = apertus
    ids = jeng.tokenizer.encode(PROMPT)
    assert teng.tokenizer.encode(PROMPT) == ids
    want = np.asarray(jeng.runner.prefill(ids, jeng.runner.init_kv())[0])
    got = teng.runner.prefill(ids, teng.runner.init_kv())[0].numpy()
    assert got.shape == want.shape == (APERTUS["vocab"],)
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * scale)
    assert teng.greedy_tokens(ids, 12) == jeng.greedy_tokens(ids, 12)


def test_apertus_without_xielu_metadata_raises(tmp_path):
    """Both packages refuse an Apertus GGUF without the per-layer
    constants, rather than compute SiLU in their place."""
    path = str(tmp_path / "apertus-no-xielu.gguf")
    write_apertus(path, GGUFWriter, GGMLType.F32, xielu=False)
    with pytest.raises(ValueError, match="xielu"):
        JEngine.load(path, JConfig(weight_mode="dequant"))
    for mode in ("quant", "dequant"):
        with pytest.raises(ValueError, match="xielu"):
            Engine.load(path, EngineConfig(weight_mode=mode), device="cpu")


def _bert(path):
    build_bert_gguf(path)


def _t5(path):
    build_synthetic_t5(path)


def _t5encoder(path):
    build_synthetic_t5(path, decoder=False)


@pytest.mark.parametrize("build", [_bert, _t5, _t5encoder],
                         ids=["bert", "t5", "t5encoder"])
def test_unported_model_kinds_raise_not_implemented(tmp_path, build):
    """Once refused (NotImplementedError, ROADMAP queue 1 item 11), these
    kinds now load as in the JAX package: Engine.load gives a BERT encoder
    or a T5 runner whose embedding equals JAX's, and load_model gives the
    T5 tree (both packages' stacks of the same depth) or, on BERT, the
    JAX loader's KeyError (BERT loads through models/bert.load_bert from
    the engine only)."""
    path = str(tmp_path / "m.gguf")
    build(path)
    jeng = JEngine.load(path, JConfig(weight_mode="dequant"))
    eng = Engine.load(path, EngineConfig(weight_mode="dequant"), device="cpu")
    assert (eng.encoder is None) == (jeng.encoder is None)
    assert (eng.t5 is None) == (jeng.t5 is None)
    assert eng.runner is None and jeng.runner is None
    text = "tok3 tok9 tok17" if jeng.encoder is not None else "hi there"
    want = np.asarray(jeng.embed(text))
    got = eng.embed(text)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if jeng.encoder is not None:
        with pytest.raises(KeyError, match="output_norm"):
            jload_model(path, mode="dequant")
        with pytest.raises(KeyError, match="output_norm"):
            load_model(path, mode="dequant", device="cpu")
    else:
        jparams, _ = jload_model(path, mode="dequant")[:2]
        params, cfg, _ = load_model(path, mode="dequant", device="cpu")
        assert cfg.arch == jeng.t5.cfg.arch
        for stack in ("enc", "dec"):
            assert len(params.get(stack, {}).get("layers", ())) == \
                len(jparams.get(stack, {}).get("layers", ()))
