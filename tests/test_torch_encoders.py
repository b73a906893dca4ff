"""The port's encoder models (models/bert.py, models/t5.py and their Engine,
loader and convert paths) against the JAX package on the CPU.

Fixtures: the JAX package's BERT test builder (tests/test_bert_mamba.py,
F32) and the port's build_synthetic_bert at a Q4_K_M mix (hidden 256); T5
from build_synthetic_t5 (the JAX builder's bytes): ReLU and gated FFNs, tied
and untied heads (the port's ``untied`` option writes output.weight), a
Q4_K_M mix, and the t5encoder variant. Both packages load the same files;
in quant mode the JAX package runs its Pallas kernels in interpret mode and
the port its kernels' plain versions.

Tolerances, of max |value|: 1e-5 for f32 weights (the same operations, the
port's fused q|k|v and gate|up products summed in another order), 1e-4 for
quantized ones in quant mode (the JAX kernels sum in interpret mode in
another order than the plain dequantize-then-matmul). Buckets, tokens and
text: equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_bert_mamba import build_bert_gguf

from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.models import bert as JB
from llama_gguf_tpu.models import t5 as JT5
from llama_gguf_tpu.ops import linear as JL
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler

from llama_gguf_tpu_torch.convert import (kv_from_numpy, kv_to_numpy,
                                          params_from_numpy)
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.models import bert as TB
from llama_gguf_tpu_torch.models import t5 as TT5
from llama_gguf_tpu_torch.ops import linear as TL
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import (build_synthetic_bert,
                                                  build_synthetic_t5)

torch.set_num_threads(1)

REL = 1e-5
QREL = 1e-4
STEPS = 24  # decoder steps held against the JAX package's
ENC_IDS = [5, 17, 200, 3, 99, 41, 8, 260, 77, 2]
T5_KINDS = {
    # name: (build kwargs, weight mode)
    "relu-tied": (dict(), "dequant"),
    "gated-tied": (dict(gated=True), "dequant"),
    "relu-untied": (dict(untied=True), "dequant"),
    "gated-untied": (dict(gated=True, untied=True), "dequant"),
    "gated-untied-q4k": (dict(gated=True, untied=True, hidden=256, ffn=512,
                              heads=4, hd=64, quant=GGMLType.Q4_K),
                         "quant"),
}


def close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max diff {err:.3g} > {rel} * {scale:.3g}"


def host_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- relative position buckets ------------------------------------------------

@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidirectional", "causal"])
@pytest.mark.parametrize("buckets,max_distance", [(8, 20), (32, 128)])
def test_rel_buckets_bit_equal(bidirectional, buckets, max_distance):
    """Every relative distance in [-4 max_distance, 4 max_distance] lands in
    the JAX package's bucket, op by op and under jit."""
    rel = np.arange(-4 * max_distance, 4 * max_distance + 1, dtype=np.int32)
    got = TT5._rel_bucket(torch.from_numpy(rel), bidirectional, buckets,
                          max_distance).numpy()
    eager = np.asarray(JT5._rel_bucket(jnp.asarray(rel), bidirectional,
                                       buckets, max_distance))
    jitted = np.asarray(jax.jit(lambda r: JT5._rel_bucket(
        r, bidirectional, buckets, max_distance))(jnp.asarray(rel)))
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_equal(got, jitted)
    assert got.min() >= 0 and got.max() < buckets


# -- BERT ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def bert_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert")
    f32 = str(d / "bert-f32.gguf")
    build_bert_gguf(f32)
    q4k = build_synthetic_bert(str(d / "bert-q4k.gguf"), vocab=300,
                               hidden=256, layers=2, heads=4, ffn=512,
                               ctx=64, quant=GGMLType.Q4_K, wordpiece=True)
    return {"f32": (f32, "dequant", REL), "q4k": (q4k, "quant", QREL)}


@pytest.fixture(scope="module")
def bert_engines(bert_paths):
    out = {}
    for key, (path, mode, rel) in bert_paths.items():
        out[key] = (JEngine.load(path, JConfig(weight_mode=mode)),
                    Engine.load(path, EngineConfig(weight_mode=mode),
                                device="cpu"), rel)
    return out


@pytest.mark.parametrize("which", ["f32", "q4k"])
def test_bert_ragged_batch_matches_jax(bert_engines, which):
    """A padded batch of three lengths: the hidden states of every real row
    within tolerance of JAX's, and each sequence in the batch equal to it
    alone."""
    jeng, eng, rel = bert_engines[which]
    vocab = jeng.encoder.cfg.vocab_size
    rng = np.random.default_rng(1)
    seqs = [rng.integers(5, vocab, size=n).tolist() for n in (3, 11, 7)]
    want = np.asarray(jeng.encoder.encode(seqs))
    got = eng.encoder.encode(seqs)
    assert got.shape == want.shape
    for i, ids in enumerate(seqs):
        close(got[i, :len(ids)], want[i, :len(ids)], rel)
        alone = eng.encoder.encode([ids])[0, :len(ids)]
        close(got[i, :len(ids)], alone, REL)


@pytest.mark.parametrize("pooling", ["mean", "first", "last", "max"])
@pytest.mark.parametrize("which", ["f32", "q4k"])
def test_bert_embed_matches_jax(bert_engines, which, pooling):
    jeng, eng, rel = bert_engines[which]
    text = ("tok7 tok12 tok40 tok3 tok9" if which == "f32"
            else "the quick brown fox jumps over the lazy dog")
    assert len(eng.tokenizer.encode(text)) >= 5
    for normalize in (True, False):
        want = np.asarray(jeng.embed(text, pooling=pooling,
                                     normalize=normalize))
        got = eng.embed(text, pooling=pooling, normalize=normalize)
        close(got, want, rel)
    assert abs(np.linalg.norm(eng.embed(text, pooling=pooling)) - 1) < 1e-5


def test_bert_layer_fused_qkv_matches_separate(bert_engines):
    """The port fuses q|k|v into one product (with the biases); JAX's three
    products give the same layer output."""
    jeng, eng, _ = bert_engines["q4k"]
    assert "wqkv" in eng.encoder.params["layers"][0]["attn"]
    cfg = eng.encoder.cfg
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    want = JB.bert_layer(jeng.encoder.params["layers"][0], jeng.encoder.cfg,
                         jnp.asarray(x), jnp.asarray(mask))
    got = TB.bert_layer(eng.encoder.params["layers"][0], cfg,
                        torch.from_numpy(x), torch.from_numpy(mask))
    close(got.numpy(), want, QREL)


def test_bert_params_from_numpy(bert_engines):
    """The JAX package's BERT tree (unfused) converted to the port's runs
    the port's forward to JAX's values."""
    jeng, eng, _ = bert_engines["f32"]
    params = params_from_numpy(host_tree(jeng.encoder.params))
    assert "wq" in params["layers"][0]["attn"]
    toks = np.array([[4, 9, 33, 2, 0, 0]], np.int32)
    mask = toks > 0
    want = JB.bert_forward(jeng.encoder.params, jeng.encoder.cfg,
                           jnp.asarray(toks), jnp.asarray(mask))
    got = TB.bert_forward(params, eng.encoder.cfg, torch.from_numpy(toks),
                          torch.from_numpy(mask))
    close(got.numpy()[mask], np.asarray(want)[mask])


# -- T5 -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def t5_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("t5")
    out = {kind: build_synthetic_t5(str(d / f"{kind}.gguf"), **kw)
           for kind, (kw, _) in T5_KINDS.items()}
    out["t5encoder"] = build_synthetic_t5(str(d / "enc.gguf"), decoder=False)
    return out


@pytest.fixture(scope="module")
def t5_engines(t5_paths):
    out = {}
    for kind, path in t5_paths.items():
        mode = T5_KINDS.get(kind, (None, "dequant"))[1]
        out[kind] = (JEngine.load(path, JConfig(weight_mode=mode)),
                     Engine.load(path, EngineConfig(weight_mode=mode),
                                 device="cpu"),
                     QREL if mode == "quant" else REL)
    return out


@pytest.mark.parametrize("kind", list(T5_KINDS))
def test_t5_encode_cache_and_steps_match_jax(t5_engines, kind):
    """t5_encode, t5_init_cache's cross K/V and 24 t5_decode_steps (fed
    JAX's greedy tokens) against the JAX package's functions, the self cache
    after them too."""
    jeng, eng, rel = t5_engines[kind]
    jp, tp, cfg = jeng.t5.params, eng.t5.params, eng.t5.cfg
    ids = ENC_IDS + [2]
    pad = -len(ids) % 16
    toks = np.array([ids + [0] * pad], np.int32)
    mask = toks.copy().astype(bool)
    mask[0, len(ids):] = False
    j_enc = JT5.t5_encode(jp, jeng.t5.cfg, jnp.asarray(toks),
                          jnp.asarray(mask))
    t_enc = TT5.t5_encode(tp, cfg, torch.from_numpy(toks),
                          torch.from_numpy(mask))
    close(t_enc.numpy()[0, :len(ids)], np.asarray(j_enc)[0, :len(ids)], rel)
    max_seq = 32
    jc = JT5.t5_init_cache(jp, jeng.t5.cfg, 1, max_seq, j_enc)
    # the port's steps read the JAX encoder output's cross K/V, so each
    # step's difference is the step's own
    tc = TT5.t5_init_cache(tp, cfg, 1, max_seq,
                           torch.from_numpy(np.array(j_enc)))
    for key in ("ck", "cv"):
        for a, b in zip(tc[key], jc[key]):
            close(a.numpy(), b, rel)
    tc = kv_from_numpy(host_tree(dict(jc)))
    tok = cfg.decoder_start_token_id
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    for t in range(STEPS):
        jl, jc = JT5.t5_decode_step(
            jp, jeng.t5.cfg, jnp.asarray([[tok]], jnp.int32),
            jnp.asarray([[t]], jnp.int32), jnp.asarray([t + 1], jnp.int32),
            jc, jm)
        tl, tc = TT5.t5_decode_step(
            tp, cfg, torch.tensor([[tok]]), torch.tensor([[t]]),
            torch.tensor([t + 1]), tc, tm)
        close(tl.numpy(), jl, rel)
        tok = int(np.argmax(np.asarray(jl)[0, 0]))
    got = kv_to_numpy(tc)
    for key in ("k", "v"):
        for a, b in zip(got[key], jc[key]):
            close(a, b, rel)


@pytest.mark.parametrize("kind", list(T5_KINDS))
def test_t5_greedy_and_seeded_generate_match_jax(t5_engines, kind):
    jeng, eng, _ = t5_engines[kind]
    assert eng.greedy_tokens(ENC_IDS, 20) == jeng.greedy_tokens(ENC_IDS, 20)
    for seed in (3, 11):
        want = jeng.generate("abc def", max_tokens=16,
                             sampler=JSampler(temperature=0.9, seed=seed))
        got = eng.generate("abc def", max_tokens=16,
                           sampler=SamplerConfig(temperature=0.9, seed=seed))
        assert got == want
        assert eng.stats.prompt_tokens == jeng.stats.prompt_tokens


def test_t5_stop_string_does_not_leak(t5_engines):
    jeng, eng, _ = t5_engines["relu-untied"]
    sampler = dict(temperature=0.9, seed=5)
    full = eng.generate("hello there", max_tokens=24,
                        sampler=SamplerConfig(**sampler))
    assert len(full) >= 6, full
    stop = full[3:6]
    want = jeng.generate("hello there", max_tokens=24,
                         sampler=JSampler(**sampler), stop=[stop])
    pieces = list(eng.generate_streaming("hello there", max_tokens=24,
                                         sampler=SamplerConfig(**sampler),
                                         stop=[stop]))
    got = "".join(pieces)
    assert got == want == full[:full.index(stop)]
    assert stop not in got


def test_t5_refusals_match_jax(t5_engines):
    """Grammar with T5 raises ValueError; generation on a t5encoder raises
    RuntimeError; both as in the JAX package."""
    from llama_gguf_tpu_torch.sampling.grammar import json_grammar

    jeng, eng, _ = t5_engines["gated-tied"]
    with pytest.raises(ValueError, match="grammar"):
        eng.generate("x", 4, grammar=eng.make_grammar_sampler(json_grammar()))
    jenc, enc, _ = t5_engines["t5encoder"]
    for e in (jenc, enc):
        with pytest.raises(RuntimeError, match="t5encoder"):
            e.generate("x", 4)


@pytest.mark.parametrize("pooling", ["mean", "cls", "last"])
@pytest.mark.parametrize("kind", ["gated-untied", "gated-untied-q4k",
                                  "t5encoder"])
def test_t5_embed_matches_jax(t5_engines, kind, pooling):
    jeng, eng, rel = t5_engines[kind]
    for normalize in (True, False):
        want = np.asarray(jeng.embed("hello world", pooling=pooling,
                                     normalize=normalize))
        got = eng.embed("hello world", pooling=pooling, normalize=normalize)
        close(got, want, rel)


def test_t5_fused_products_match_separate(t5_engines):
    """The port's fused self-attention q|k|v and gated FFN gate|up (kernel
    3's plain version, act="gelu") against JAX's separate products."""
    jeng, eng, _ = t5_engines["gated-untied-q4k"]
    jl = jeng.t5.params["dec"]["layers"][1]
    tl = eng.t5.params["dec"]["layers"][1]
    assert "wqkv" in tl["attn"] and "gate_up" in tl["ffn"]
    assert isinstance(tl["ffn"]["gate_up"], TL.QuantLinear)
    cfg = eng.t5.cfg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 5, cfg.hidden_size)).astype(np.float32)
    got = TL.apply_qkv(tl["attn"], torch.from_numpy(x))
    for g, key in zip(got, ("wq", "wk", "wv")):
        close(g.numpy(), JL.apply(jl["attn"][key], jnp.asarray(x)), QREL)
    close(TT5._ffn(tl, cfg, torch.from_numpy(x)).numpy(),
          JT5._ffn(jl, jeng.t5.cfg, jnp.asarray(x)), QREL)


def test_t5_cross_cache_reuse(t5_paths):
    """A long prompt then a short one on the runner's own cache (the cross
    buffers hold the long prompt's rows): the short one's tokens and logits
    equal a fresh engine's."""
    path = t5_paths["gated-untied"]
    eng = Engine.load(path, EngineConfig(weight_mode="dequant"),
                      device="cpu")
    fresh = Engine.load(path, EngineConfig(weight_mode="dequant"),
                        device="cpu")
    long_ids = list(np.random.default_rng(6).integers(5, 500, size=70))
    eng.t5.generate_ids(long_ids, 8)
    assert eng.t5.enc_capacity >= 80
    short = [9, 10, 11, 2]
    got_l, want_l = [], []
    got = eng.t5.generate_ids(short, 12, record=got_l)
    want = fresh.t5.generate_ids(short, 12, record=want_l)
    assert got == want
    close(np.stack(got_l), np.stack(want_l), 1e-6)


def test_t5_params_from_numpy(t5_engines):
    """The JAX package's T5 tree (rel_b, enc/dec, cross; unfused) converted
    to the port's gives JAX's encoder output and first step."""
    jeng, eng, _ = t5_engines["gated-untied"]
    params = params_from_numpy(host_tree(jeng.t5.params))
    assert "gate" in params["dec"]["layers"][0]["ffn"]
    toks = np.array([ENC_IDS + [2] + [0] * 5], np.int32)
    mask = toks.copy().astype(bool)
    mask[0, 11:] = False
    cfg = eng.t5.cfg
    want = JT5.t5_encode(jeng.t5.params, jeng.t5.cfg, jnp.asarray(toks),
                         jnp.asarray(mask))
    got = TT5.t5_encode(params, cfg, torch.from_numpy(toks),
                        torch.from_numpy(mask))
    close(got.numpy()[0, :11], np.asarray(want)[0, :11])
    jc = JT5.t5_init_cache(jeng.t5.params, jeng.t5.cfg, 1, 16, want)
    tc = TT5.t5_init_cache(params, cfg, 1, 16, got)
    jl, _ = JT5.t5_decode_step(jeng.t5.params, jeng.t5.cfg,
                               jnp.zeros((1, 1), jnp.int32),
                               jnp.zeros((1, 1), jnp.int32),
                               jnp.ones((1,), jnp.int32), jc,
                               jnp.asarray(mask))
    zero = torch.zeros((1, 1), dtype=torch.int32)
    tl, _ = TT5.t5_decode_step(params, cfg, zero, zero,
                               torch.ones(1, dtype=torch.int32), tc,
                               torch.from_numpy(mask))
    close(tl.numpy(), jl)


def test_concurrent_requests_match_sequential(t5_engines, bert_engines):
    """Handler threads share one engine: T5 requests on the runner's own
    decoder cache and BERT embeddings, from more threads than the CPU
    runs at once with a short switch interval, each equal to its result
    alone."""
    import sys
    import threading

    t5 = t5_engines["gated-untied"][1]
    bert = bert_engines["f32"][1]
    prompts = [[5 + i, 17, 200 + 3 * i, 2] for i in range(6)]
    texts = [f"tok{3 + i} tok{9 + i} tok17" for i in range(6)]
    want_t5 = [t5.greedy_tokens(p, 10) for p in prompts]
    want_bert = [bert.embed(t) for t in texts]
    got: dict = {}
    errors = []

    def work(i):
        try:
            got[("t5", i)] = t5.greedy_tokens(prompts[i], 10)
            got[("bert", i)] = bert.embed(texts[i])
        except Exception as e:  # reported below, with the thread's index
            errors.append((i, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert not any(th.is_alive() for th in threads)
    for i in range(len(prompts)):
        assert got[("t5", i)] == want_t5[i]
        np.testing.assert_array_equal(got[("bert", i)], want_bert[i])


def test_bert_fused_qkv_variant_refused_like_jax(tmp_path):
    """A nomic-bert GGUF stores one attn_qkv tensor, which load_bert does
    not read: both packages raise the same KeyError at Engine.load."""
    from llama_gguf_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(0)
    w = GGUFWriter()
    w.add_metadata("general.architecture", "nomic-bert")
    for key, val in (("block_count", 1), ("embedding_length", 32),
                     ("attention.head_count", 4), ("feed_forward_length", 64),
                     ("context_length", 32),
                     ("attention.layer_norm_epsilon", 1e-5)):
        w.add_metadata(f"nomic-bert.{key}", val)
    w.add_metadata("tokenizer.ggml.model", "bert")
    w.add_metadata("tokenizer.ggml.tokens", [f"tok{i}" for i in range(64)])
    w.add_metadata("tokenizer.ggml.token_type", [1] * 64)
    for name, shape in (("token_embd.weight", (64, 32)),
                        ("token_embd_norm.weight", (32,)),
                        ("blk.0.attn_qkv.weight", (96, 32)),
                        ("blk.0.attn_output.weight", (32, 32)),
                        ("blk.0.attn_output_norm.weight", (32,)),
                        ("blk.0.ffn_up.weight", (64, 32)),
                        ("blk.0.ffn_down.weight", (32, 64)),
                        ("blk.0.layer_output_norm.weight", (32,))):
        w.add_tensor_np(name, rng.normal(size=shape).astype(np.float32))
    path = str(tmp_path / "nomic.gguf")
    w.write_to_path(path)
    with pytest.raises(KeyError) as jerr:
        JEngine.load(path, JConfig(weight_mode="dequant"))
    with pytest.raises(KeyError) as terr:
        Engine.load(path, EngineConfig(weight_mode="dequant"), device="cpu")
    assert str(terr.value) == str(jerr.value)
