"""The port's KV-cache formats (models/kv.py: f32, bf16, i8, f8_e4m3,
f8_e5m2, tq2, tq3, tq4, qjl) against the JAX package on the CPU: writes,
reads, scales, memory, dropped positions, the context shift, a tiny model's
logits, the batched engine with reused rows, prompt-cache session files and
kv_from_numpy / kv_to_numpy.

Tolerances. Bytes equal: the f32, bf16, i8 and f8 writes (f8_e4m3 with the
JAX package's NaN past 464, where torch alone saturates at 448), int8 bytes
and scales of the i8 quantizer, every slide. The tq and qjl writes rotate
with a [D, D] product whose sums torch and XLA may order differently: their
levels and sign bits agree on >= 99.9% of elements, never two levels
apart, scales within 1e-6 relative. Reads of the same bytes: within 1e-6
of max |value| (tq: 1e-5, the rotation back). A requantizing shift (i8,
f8): bytes equal on >= 99% and the values within one step of the format.
A 2-layer tiny model's prefill and 8 decode logits with the same format in
both packages: within 1e-5 of max |logit|, bf16 within the bound measured
for these inputs (BF16_LOGIT_REL): a key a few ulps from a rounding
boundary takes the neighbouring value in one package.
JAX's own round-trip tolerances (tests/test_kv_variants.py,
tests/test_turboquant.py) carry over to the port's write and read."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fixtures import make_tiny_model
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.engine.prompt_cache import PromptCache as JPromptCache
from llama_gguf_tpu.models import config as JC
from llama_gguf_tpu.models import kv as JKV
from llama_gguf_tpu.models import turboquant as JTQ
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.convert import kv_from_numpy, kv_to_numpy
from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.prompt_cache import PromptCache
from llama_gguf_tpu_torch.engine.runner import ModelRunner
from llama_gguf_tpu_torch.models import config as TC
from llama_gguf_tpu_torch.models import kv as KV
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.server.app import ServerConfig, ServerState

torch.set_num_threads(1)

FORMATS = list(KV.FORMATS)
PACKED = ("tq2", "tq3", "tq4", "qjl")
EXACT = ("f32", "bf16", "i8", "f8_e4m3", "f8_e5m2")
AGREE = 0.999
LOGIT_REL = 1e-5
# bf16 keys: an f32 key a few ulps from a bf16 rounding boundary rounds the
# other way in one package (2^-8 of that element); measured 4.7e-5-5.9e-5.
# The other formats measured 4.7e-7-7.2e-7 on these inputs (tq and qjl:
# no level of this model's keys flips)
BF16_LOGIT_REL = 2e-4
# JAX's test_kv_roundtrip tolerances and test_turboquant's error bounds
ROUNDTRIP = {"f32": 1e-6, "bf16": 0.05, "i8": 0.05, "f8_e4m3": 0.15,
             "f8_e5m2": 0.3}
TQ_REL = {"tq2": 0.45, "tq3": 0.25, "tq4": 0.11}
GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
JGREEDY = JSampler(temperature=0.0, repetition_penalty=1.0)
PROMPT = "tok1 tok2 tok3 tok4 tok5 tok6 tok7 tok8 tok9"


def close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{err:.3g} > {rel} of max"


def bits(a: np.ndarray) -> np.ndarray:
    """An array's raw bits (ml_dtypes bf16 and float8 included)."""
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return a
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def levels(a: np.ndarray, fmt: str, key: str, d: int) -> np.ndarray:
    """A packed tq/qjl buffer's levels (qjl keys: sign bits)."""
    if fmt == "qjl" and key == "k":
        return np.unpackbits(a, axis=-1).astype(int)
    b = 4 if fmt == "qjl" else int(fmt[2])
    return np.asarray(JTQ.unpack_levels(jnp.asarray(a), b, d)).astype(int)


def same_cache(tkv: dict, jkv: dict, fmt: str, d: int = 16,
               exact: bool = True) -> None:
    """The port's cache (without its drop slots) against the JAX cache:
    the same keys and shapes; bytes equal, or for tq/qjl levels equal on
    >= 99.9% (never two apart) and scales within 1e-6."""
    got = kv_to_numpy(tkv)
    assert set(got) == set(jkv)
    for key in jkv:
        for a, b in zip(got[key], jkv[key]):
            b = np.asarray(b)
            assert a.shape == b.shape, key
            if fmt in PACKED and key in ("k", "v") and not exact:
                la, lb = levels(a, fmt, key, d), levels(b, fmt, key, d)
                assert (la == lb).mean() >= AGREE and \
                    np.abs(la - lb).max() <= 1
            elif key.endswith("scale") and not exact:
                np.testing.assert_allclose(a, b, rtol=1e-6)
            else:
                np.testing.assert_array_equal(bits(a), bits(b), err_msg=key)


def randn(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def written(fmt: str, layers=2, batch=2, seq=8, heads=2, d=16, seed=0,
            positions=None):
    """The same K/V written into a JAX and a port cache of ``fmt`` (every
    position of every row unless ``positions`` is given)."""
    jkv = JKV.init_cache(layers, batch, seq, heads, d, fmt=fmt)
    tkv = KV.init_cache(layers, batch, seq, heads, d, fmt=fmt, device="cpu")
    pos = positions if positions is not None else \
        np.tile(np.arange(seq, dtype=np.int32), (batch, 1))
    for i in range(layers):
        k = randn(batch, pos.shape[1], heads, d, seed=seed + 2 * i, scale=3)
        v = randn(batch, pos.shape[1], heads, d, seed=seed + 2 * i + 1)
        jkv = JKV.write(jkv, i, jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(pos))
        KV.write(tkv, i, torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(pos))
    return jkv, tkv


# -- layout, writes and reads -------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_init_cache_matches_jax(fmt):
    """The same keys, dtypes and logical shapes (plus the drop slot), the
    same format, and the same memory_bytes."""
    jkv = JKV.init_cache(3, 2, 8, 2, 16, fmt=fmt)
    tkv = KV.init_cache(3, 2, 8, 2, 16, fmt=fmt, device="cpu")
    same_cache(tkv, jkv, fmt)
    for key in jkv:
        assert all(t.shape[1] == 9 for t in tkv[key])
    assert KV.cache_format(tkv, head_dim=16) == \
        JKV.cache_format(jkv, head_dim=16) == fmt
    assert KV.cache_format(tkv) == JKV.cache_format(jkv)
    assert KV.cache_shape(tkv) == JKV.cache_shape(jkv)
    assert KV.memory_bytes(tkv) == JKV.memory_bytes(jkv)


@pytest.mark.parametrize("fmt", FORMATS)
def test_write_matches_jax(fmt):
    """Both packages write the same K/V, one position out of range (it is
    dropped): the same bytes, or levels within the rotation's tolerance."""
    pos = np.array([[0, 1, 2, 99, 4], [5, 6, 7, 3, 8]], np.int32)
    jkv, tkv = written(fmt, positions=pos)
    same_cache(tkv, jkv, fmt, exact=False)


@pytest.mark.parametrize("fmt", [f for f in FORMATS if f != "qjl"])
@pytest.mark.parametrize("gather", ["all", "rows", "groups"])
def test_read_matches_jax(fmt, gather):
    """The port's read of a JAX cache's bytes (kv_from_numpy) equals the
    JAX read, whole, sliced to a bound, and gathered by rows ([C] global or
    [G, C] group-local, clamped)."""
    jkv, _ = written(fmt, batch=4)
    tkv = kv_from_numpy({k: [np.asarray(a) for a in v]
                         for k, v in jkv.items()})
    rows = {"all": None, "rows": np.array([3, 0, 9], np.int32),
            "groups": np.array([[1, 0], [2, 1]], np.int32)}[gather]
    for bound in (None, 5):
        kw = dict(head_dim=16, v_head_dim=16, bound=bound)
        jk, jv = JKV.read(jkv, 1, rows=None if rows is None
                          else jnp.asarray(rows), **kw)
        tk, tv = KV.read(tkv, 1, rows=None if rows is None
                         else torch.from_numpy(rows), **kw)
        rel = 1e-5 if fmt in PACKED else 1e-6
        close(tk.numpy(), np.asarray(jk), rel)
        close(tv.numpy(), np.asarray(jv), rel)


def test_qjl_read_raises_as_in_jax():
    _, tkv = written("qjl")
    with pytest.raises(ValueError, match="sign sketches"):
        KV.read(tkv, 0, head_dim=16)
    with pytest.raises(ValueError, match="requires head_dim"):
        KV.read(written("tq3")[1], 0)


@pytest.mark.parametrize("fmt", FORMATS[:-1])
def test_roundtrip_within_jax_tolerances(fmt):
    """The JAX package's round-trip checks on the port: written values come
    back within each format's tolerance, untouched positions read 0."""
    tkv = KV.init_cache(2, 1, 8, 2, 64, fmt=fmt, device="cpu")
    k, v = randn(1, 4, 2, 64, seed=1), randn(1, 4, 2, 64, seed=2)
    pos = torch.arange(4, dtype=torch.int32)[None]
    KV.write(tkv, 0, torch.from_numpy(k), torch.from_numpy(v), pos)
    ko, vo = KV.read(tkv, 0, head_dim=64, v_head_dim=64)
    for got, want in ((ko, k), (vo, v)):
        got = got.numpy()[0, :4]
        if fmt in TQ_REL:
            rel = np.linalg.norm(got - want[0]) / np.linalg.norm(want[0])
            assert rel < TQ_REL[fmt], rel
        else:
            tol = ROUNDTRIP[fmt]
            assert np.allclose(got, want[0], atol=tol, rtol=tol)
    assert np.all(ko.numpy()[0, 4:] == 0) and np.all(vo.numpy()[0, 4:] == 0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_out_of_range_positions_dropped(fmt):
    """JAX's test_oob_positions_dropped on each format: position 99 lands
    in the drop slot, never in the logical cache."""
    tkv = KV.init_cache(1, 1, 4, 1, 8, fmt=fmt, device="cpu")
    k = torch.ones(1, 2, 1, 8)
    KV.write(tkv, 0, k, k, torch.tensor([[0, 99]], dtype=torch.int32))
    got = kv_to_numpy(tkv)
    for key, layers in got.items():
        assert np.any(layers[0][0, 0] != 0), key
        assert np.all(layers[0][0, 1:] == 0), key
    assert torch.any(KV.byte_view(tkv["k"][0])[0, 4] != 0)  # the drop slot


@pytest.mark.parametrize("fmt,ratio", [("i8", 3.0), ("f8_e4m3", 4.0),
                                       ("f8_e5m2", 4.0), ("bf16", 2.0),
                                       ("tq2", 12.0), ("tq3", 9.0),
                                       ("tq4", 6.0), ("qjl", 5.0)])
def test_memory_ratios(fmt, ratio):
    """memory_bytes counts the logical bytes, as the JAX package does, so
    its ratios carry over: i8 under a third of f32, f8 a quarter, tq2 and
    tq3 over 12x and 9x smaller, qjl over 5x."""
    shape = (2, 1, 64, 4, 64)
    f32 = KV.memory_bytes(KV.init_cache(*shape, fmt="f32", device="cpu"))
    tkv = KV.init_cache(*shape, fmt=fmt, device="cpu")
    mine = KV.memory_bytes(tkv)
    assert mine == JKV.memory_bytes(JKV.init_cache(*shape, fmt=fmt))
    if fmt.startswith("f8") or fmt == "bf16":
        assert mine * ratio == f32
    else:
        assert f32 / mine > ratio


def test_f8_e4m3_overflow_is_nan_as_in_jax():
    """XLA casts |x| > 464 and +-inf to float8_e4m3fn NaN (of x's sign);
    torch alone saturates at +-448. The port writes JAX's bytes: 448 and
    464 stay 448, 464.5, 500 and inf become NaN. e5m2 agrees in both
    (+-inf past 61440)."""
    e4m3 = np.array([448, -448, 463.9, 464, 464.5, 500, -500, np.inf,
                     -np.inf, 1.0, -2.5e-3, 0.0], np.float32)
    e5m2 = np.array([61440, 61500, 70000, -70000, np.inf, -np.inf, 1.0],
                    np.float32)
    assert torch.from_numpy(e4m3).to(torch.float8_e4m3fn).view(
        torch.uint8)[5].item() == 126  # torch alone: 500 -> 448
    for fmt, x in (("f8_e4m3", e4m3), ("f8_e5m2", e5m2)):
        n = x.shape[0]
        x = np.tile(x[None, :, None, None], (1, 1, 1, 8))
        pos = np.arange(n, dtype=np.int32)[None]
        jkv = JKV.write(JKV.init_cache(1, 1, n, 1, 8, fmt=fmt), 0,
                        jnp.asarray(x), jnp.asarray(x), jnp.asarray(pos))
        tkv = KV.write(KV.init_cache(1, 1, n, 1, 8, fmt=fmt, device="cpu"),
                       0, torch.from_numpy(x), torch.from_numpy(x),
                       torch.from_numpy(pos))
        same_cache(tkv, jkv, fmt)
        got = kv_to_numpy(tkv)["k"][0][0, :, 0, 0]
        if fmt == "f8_e4m3":
            assert list(got[:9]) == [126, 254, 126, 126, 127, 127, 255,
                                     127, 255]
            assert np.isnan(KV.read(tkv, 0)[0].numpy()[0, 4:9]).all()
        else:
            assert np.isinf(KV.read(tkv, 0)[0].numpy()[0, 2:6]).all()


def test_i8_quantizer_bytes_match_jax():
    """_quantize_i8 on random K/V at several magnitudes, a zero row and
    exact halves: the same int8 bytes and f32 scales (round half to even,
    amax / 127 first, then the reciprocal)."""
    x = randn(3, 50, 4, 64, seed=9) * np.array([1e-3, 1.0, 300.0],
                                               np.float32)[:, None, None, None]
    x[0, 0, 0] = 0.0
    x[1, 1, 1, :4] = [127.0, 0.5, 1.5, -2.5]
    jq, js = JKV._quantize_i8(jnp.asarray(x))
    tq, ts = KV._quantize_i8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and np.all(ts.numpy()[0, 0, 0] == 0)


# -- the context shift --------------------------------------------------------


def model_pair():
    """The same 2-layer config in each package, layer 1 NoPE."""
    out = []
    for mod in (JC, TC):
        rope = mod.RopeConfig(freq_base=10000.0, n_dims=16,
                              rope_type=mod.RopeType.NEOX)
        out.append(mod.ModelConfig(
            arch="llama", vocab_size=8, hidden_size=32, num_layers=2,
            num_heads=2, num_kv_heads=2, intermediate_size=32,
            max_seq_len=8, rope=rope, nope_layer_interval=2))
    return out


@pytest.mark.parametrize("batch_idx", [None, 1], ids=["all", "row1"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_shift_left_matches_jax(fmt, batch_idx):
    """shift_left by 3 with per-layer RoPE (layer 1 NoPE), every row or row
    1, on a JAX cache's bytes: tq and qjl slide (bytes equal); f32 within
    1e-6; bf16 bytes equal; i8 and f8 requantize (bytes equal on >= 99%,
    values within one step). Every buffer keeps its address and drop
    slot."""
    jcfg, tcfg = model_pair()
    jkv, _ = written(fmt)
    tkv = kv_from_numpy({k: [np.asarray(a) for a in v]
                         for k, v in jkv.items()})
    ptrs = {k: [t.data_ptr() for t in v] for k, v in tkv.items()}
    drops = {k: [KV.byte_view(t)[:, -1].clone() for t in v]
             for k, v in tkv.items()}
    jkv = JKV.shift_left(jkv, 3, batch_idx=batch_idx, model_cfg=jcfg)
    KV.shift_left(tkv, 3, batch_idx=batch_idx, model_cfg=tcfg)
    for key in tkv:
        assert [t.data_ptr() for t in tkv[key]] == ptrs[key]
        for t, d in zip(tkv[key], drops[key]):
            assert torch.equal(KV.byte_view(t)[:, -1], d)
    if fmt in PACKED or fmt == "bf16":
        same_cache(tkv, jkv, fmt)
        return
    got = kv_to_numpy(tkv)
    for key in jkv:
        for layer, (a, b) in enumerate(zip(got[key], jkv[key])):
            b = np.asarray(b)
            if fmt == "f32":
                close(a, b, 1e-6)
            elif key == "k_scale":  # from the re-rotated keys' amax
                np.testing.assert_allclose(a, b, rtol=1e-6)
            elif key == "k":
                assert (bits(a) == bits(b)).mean() >= 0.99, (key, layer)
            else:  # values only slide
                np.testing.assert_array_equal(bits(a), bits(b))
    if fmt == "f32":
        return
    tk, _ = KV.read(tkv, 0)
    jk, _ = JKV.read(jkv, 0)
    step = {"i8": 1.0 / 127, "f8_e4m3": 2 ** -3, "f8_e5m2": 2 ** -2}[fmt]
    jk = np.asarray(jk)
    assert np.all(np.abs(tk.numpy() - jk) <= step * np.abs(jk).max() * 1.01)


# -- through the model --------------------------------------------------------


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    """The JAX KV-variant tests' model (qwen2, head_dim 16, ctx 96)."""
    path = str(tmp_path_factory.mktemp("kvf") / "tiny.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                    tokenizer=True)
    return path


@pytest.fixture(scope="module")
def engines(model_path):
    """(JAX, port) engines per format, dequant mode."""
    cache = {}

    def get(fmt):
        if fmt not in cache:
            cache[fmt] = (
                JEngine.load(model_path, JConfig(weight_mode="dequant",
                                                 kv_format=fmt)),
                Engine.load(model_path, EngineConfig(weight_mode="dequant",
                                                     kv_format=fmt),
                            device="cpu"))
        return cache[fmt]
    return get


@pytest.mark.parametrize("fmt", FORMATS)
def test_model_logits_match_jax(engines, fmt):
    """The 2-layer model with the same cache format in both packages: the
    prefill logits and 8 decode steps' (the JAX choice fed to both)."""
    je, te = engines(fmt)
    ids = je.tokenizer.encode(PROMPT)
    jkv, tkv = je.runner.init_kv(1), te.runner.init_kv(1)
    jl, jkv, pos = je.runner.prefill(ids, jkv)
    tl, tkv, _ = te.runner.prefill(ids, tkv)
    rel = BF16_LOGIT_REL if fmt == "bf16" else LOGIT_REL
    close(tl.numpy(), np.asarray(jl), rel)
    for _ in range(8):
        tok = int(np.argmax(np.asarray(jl)))
        jl, jkv = je.runner.decode_one(tok, pos, jkv)
        tl, tkv = te.runner.decode_one(tok, pos, tkv)
        pos += 1
        close(tl.numpy(), np.asarray(jl), rel)


@pytest.mark.parametrize("fmt", FORMATS)
def test_batched_reused_rows_match_single_stream(engines, fmt):
    """Six requests through a B = 2 BatchedEngine (rows reused four times,
    their old K/V, scales and sketches left in place): each completion
    equals the port's single-stream greedy tokens, and in the bytes-equal
    formats the JAX engine's."""
    je, te = engines(fmt)
    prompts = [PROMPT, "tok3 tok1", "tok5 tok6 tok7 tok8 tok9 tok10 tok11",
               "tok2", "tok9 tok8 tok7 tok6", "tok4 tok4 tok4"]
    runner = ModelRunner(te.runner.params, te.runner.cfg, max_batch=2,
                         max_seq=96, kv_format=fmt, device="cpu")
    with BatchedEngine(runner, te.tokenizer, max_queue=16,
                       prefill_chunk=8) as be:
        handles = [be.submit(p, max_tokens=6, sampler=GREEDY)
                   for p in prompts]
        got = [(h.text(timeout=120), h.token_ids) for h in handles]
    for p, (_, toks) in zip(prompts, got):
        ids = te.tokenizer.encode(p)
        want = te.greedy_tokens(ids, 6)
        assert toks == want[:len(toks)] and len(toks) >= 1
        if fmt in EXACT:
            assert toks == je.greedy_tokens(ids, 6)[:len(toks)]


@pytest.mark.parametrize("fmt", ["i8", "f8_e4m3", "f8_e5m2", "tq3", "qjl"])
def test_engine_session_file_cross_loads(engines, tmp_path, fmt):
    """A prompt-cache session file saved by each package loads into the
    other's engine in the same format: a hit, the same dtype labels
    (int8, float8_e4m3fn, ...) and the tokens of an uncached run."""
    je, te = engines(fmt)
    jfile, tfile = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    j1 = JEngine(je.runner, je.tokenizer, JConfig(
        weight_mode="dequant", kv_format=fmt, prompt_cache=True), je.gguf)
    t1 = Engine(te.runner, te.tokenizer, EngineConfig(
        kv_format=fmt, prompt_cache=True), te.gguf)
    want = te.generate(PROMPT, max_tokens=6, sampler=GREEDY)
    j1.generate(PROMPT, max_tokens=6, sampler=JGREEDY)
    assert t1.generate(PROMPT, max_tokens=6, sampler=GREEDY) == want
    assert j1.prompt_cache.save(jfile) == t1.prompt_cache.save(tfile) == 1
    jentry = next(iter(j1.prompt_cache._entries.values()))
    tentry = next(iter(t1.prompt_cache._entries.values()))
    assert set(tentry.dtypes) == set(jentry.arrays)
    for name, a in jentry.arrays.items():
        assert tentry.dtypes[name] == str(a.dtype)
    for src in (jfile, tfile):
        t2 = Engine(te.runner, te.tokenizer, EngineConfig(
            kv_format=fmt, prompt_cache_file=src), te.gguf)
        assert t2.generate(PROMPT, max_tokens=6, sampler=GREEDY) == want
        assert t2.prompt_cache.stats.hits == 1
        loaded = JPromptCache()
        assert loaded.load(src) == 1
        restored, n = loaded.restore(
            je.tokenizer.encode(PROMPT), je.runner.init_kv(1))
        assert n > 0 and all(np.asarray(restored[k][0]).dtype ==
                             np.asarray(je.runner.init_kv(1)[k][0]).dtype
                             for k in restored)


@pytest.mark.parametrize("fmt", FORMATS)
def test_prompt_cache_snapshot_bytes_match_jax(fmt):
    """put and restore of the same written caches: the snapshots' bytes and
    dtype names equal the JAX package's (float8 as its raw bytes under
    the ml_dtypes name), and a restore writes them back in place."""
    jkv, _ = written(fmt, seed=4)
    tkv = kv_from_numpy({k: [np.asarray(a) for a in v]
                         for k, v in jkv.items()})
    mine, ref = PromptCache(min_prefix=2), JPromptCache(min_prefix=2)
    mine.put([1, 2, 3, 4, 5], tkv, batch_idx=1)
    ref.put([1, 2, 3, 4, 5], jkv, batch_idx=1)
    (me,), (re,) = mine._entries.values(), ref._entries.values()
    for name, a in re.arrays.items():
        assert me.dtypes[name] == str(a.dtype)
        np.testing.assert_array_equal(bits(me.arrays[name]), bits(a))
    jdst, tdst = written(fmt, seed=8)[0], written(fmt, seed=8)[1]
    ptrs = [t.data_ptr() for t in tdst["k"]]
    jdst, n = ref.restore([1, 2, 3, 4, 5, 6], jdst, batch_idx=0)
    _, m = mine.restore([1, 2, 3, 4, 5, 6], tdst, batch_idx=0)
    assert n == m == 5 and [t.data_ptr() for t in tdst["k"]] == ptrs
    same_cache(tdst, jdst, fmt, exact=False)


@pytest.mark.parametrize("fmt", FORMATS)
def test_kv_from_numpy_round_trips(fmt):
    """kv_from_numpy of a JAX cache gives the port's layout (a drop slot on
    every positional buffer, float8 as torch float8) and kv_to_numpy gives
    the JAX bytes back."""
    jkv, _ = written(fmt, seed=6)
    tkv = kv_from_numpy({k: [np.asarray(a) for a in v]
                         for k, v in jkv.items()})
    want = KV.init_cache(2, 2, 8, 2, 16, fmt=fmt, device="cpu")
    for key in want:
        assert [(t.dtype, t.shape) for t in tkv[key]] == \
            [(t.dtype, t.shape) for t in want[key]]
    same_cache(tkv, jkv, fmt)


@pytest.mark.parametrize("fmt", ["i8", "tq4", "qjl"])
def test_entry_points_take_every_format(model_path, fmt, capsys):
    """The CLI's run and the server's state load and generate with the
    format; nothing raises "not ported"."""
    assert cli.main(["run", model_path, "--kv-cache-type", fmt, "--device",
                     "cpu", "-p", PROMPT, "-n", "3", "-t", "0"]) == 0
    state = ServerState(ServerConfig(model_path=model_path, device="cpu",
                                     kv_format=fmt, max_batch=2,
                                     warmup=False))
    try:
        _, batched = state.current()
        assert batched.runner.kv_format == fmt
        assert KV.cache_format(batched._kv, head_dim=16) == fmt
        h = batched.submit(PROMPT, max_tokens=3, sampler=GREEDY)
        h.text(timeout=120)
        ids = batched.tokenizer.encode(PROMPT)
        assert h.finish_reason in ("stop", "length")
        assert h.token_ids == state.engine.greedy_tokens(ids, 3)[
            :len(h.token_ids)]
    finally:
        state.shutdown()
