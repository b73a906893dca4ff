"""PyTorch port's plain ops against their JAX counterparts: norms, RoPE,
quantized embedding lookup, the KV cache write, attention, and the numpy
modules the port keeps its own copies of."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.models import config as jcfg
from llama_gguf_tpu.models import kv as JKV
from llama_gguf_tpu.ops import attention as JA
from llama_gguf_tpu.ops import linear as JL
from llama_gguf_tpu.ops import norms as JN
from llama_gguf_tpu.ops import rope as JR
from llama_gguf_tpu.quant import dequant as jdq
from llama_gguf_tpu.quant import quantize as jq
from llama_gguf_tpu.quant import repack as jrp
from llama_gguf_tpu.utils.synthetic import build_synthetic_gguf as jbuild

from llama_gguf_tpu_torch.models import config as tcfg
from llama_gguf_tpu_torch.models import kv as TKV
from llama_gguf_tpu_torch.ops import attention as TA
from llama_gguf_tpu_torch.ops import linear as TL
from llama_gguf_tpu_torch.ops import norms as TN
from llama_gguf_tpu_torch.ops import rope as TR
from llama_gguf_tpu_torch.quant import dequant as tdq
from llama_gguf_tpu_torch.quant import quantize as tq
from llama_gguf_tpu_torch.quant import repack as trp
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf as tbuild

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 elementwise / small reductions
PORTED = [GGMLType.F32, GGMLType.F16, GGMLType.BF16, GGMLType.Q8_0,
          GGMLType.Q5_1, GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q4_0,
          GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q8_1, GGMLType.Q2_K,
          GGMLType.Q3_K, GGMLType.Q5_K, GGMLType.Q8_K, GGMLType.IQ4_NL,
          GGMLType.IQ4_XS]


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# -- norms --------------------------------------------------------------------


@pytest.mark.parametrize("unit", [False, True])
def test_rms_norm(unit):
    x, w = rnd(0, 3, 5, 64), rnd(1, 64)
    want = np.asarray(JN.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, unit))
    got = TN.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6, unit)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("layer_norm", [False, True])
def test_apply_norm(layer_norm):
    x, w, b = rnd(2, 4, 48), rnd(3, 48), rnd(4, 48)
    want = np.asarray(JN.apply_norm(
        jnp.asarray(x), {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
        1e-5, layer_norm))
    got = TN.apply_norm(
        torch.from_numpy(x),
        {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)},
        1e-5, layer_norm)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- rope ---------------------------------------------------------------------

ROPES = {
    "normal": dict(n_dims=64, rope_type="normal"),
    "neox": dict(n_dims=64, rope_type="neox", freq_base=1e6),
    "partial": dict(n_dims=32, rope_type="neox"),
    "partial_end": dict(n_dims=32, rope_type="normal", partial_at_end=True),
    "linear": dict(n_dims=64, scaling_type="linear", freq_scale=0.25),
    "yarn": dict(n_dims=64, rope_type="neox", scaling_type="yarn",
                 freq_scale=0.25, yarn_ext_factor=1.0,
                 yarn_attn_factor=1.1, original_max_position_embeddings=512),
}


def _rope_cfgs(kw):
    def make(mod):
        d = dict(kw)
        d["rope_type"] = mod.RopeType(d.get("rope_type", "normal"))
        d["scaling_type"] = mod.RopeScalingType(d.get("scaling_type", "none"))
        return mod.RopeConfig(**d)
    return make(jcfg), make(tcfg)


@pytest.mark.parametrize("name", list(ROPES))
def test_rope(name):
    jc, tc = _rope_cfgs(ROPES[name])
    pos = np.random.default_rng(5).integers(0, 3000, size=(2, 7)).astype(
        np.int32)
    x = rnd(6, 2, 7, 4, 64)
    jcos, jsin = JR.rope_cos_sin(jnp.asarray(pos), jc)
    tcos, tsin = TR.rope_cos_sin(torch.from_numpy(pos), tc)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), **TOL)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), **TOL)
    want = np.asarray(JR.apply_rope(jnp.asarray(x), jcos, jsin, jc))
    got = TR.apply_rope(torch.from_numpy(x), tcos, tsin, tc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- quantized embedding ------------------------------------------------------


@pytest.mark.parametrize("t", [GGMLType.Q6_K, GGMLType.Q4_K],
                         ids=lambda t: t.name)
def test_embedding_lookup_bit_exact(t):
    v, h = 64, 512
    raw = jq.quantize(rnd(7, v, h, scale=0.05), t)
    packed, scales, mins, fmt, group = jrp.repack_rows(raw, t, (v, h))
    tp = trp.repack_rows(raw, t, (v, h))
    for a, b in zip((packed, scales, mins), tp[:3]):
        np.testing.assert_array_equal(a, b)
    jemb = JL.QuantEmbedding(jnp.asarray(packed), jnp.asarray(scales),
                             None if mins is None else jnp.asarray(mins),
                             fmt, group, v, h)
    temb = TL.QuantEmbedding(torch.from_numpy(packed),
                             torch.from_numpy(scales),
                             None if mins is None else torch.from_numpy(mins),
                             fmt, group, v, h)
    toks = np.random.default_rng(8).integers(0, v, size=(3, 5)).astype(
        np.int32)
    want = np.asarray(JL.embedding_lookup(jemb, jnp.asarray(toks)))
    got = TL.embedding_lookup(temb, torch.from_numpy(toks))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the table row equals llama.cpp's dequantization of that row
    full = jdq.dequantize(raw, t, shape=(v, h))
    np.testing.assert_allclose(got.numpy(), full[toks], rtol=1e-6, atol=1e-7)


def test_fuse_and_dequantize_weight():
    k = 256
    jls, tls = [], []
    for i, n in enumerate((128, 64, 64)):
        raw = jq.quantize(rnd(10 + i, n, k, scale=0.1), GGMLType.Q4_K)
        rw = jrp.repack(raw, GGMLType.Q4_K, (n, k))
        jls.append(JL.QuantLinear(jnp.asarray(rw.packed),
                                  jnp.asarray(rw.scales),
                                  jnp.asarray(rw.mins), None, rw.fmt,
                                  rw.group, k, n))
        tls.append(TL.QuantLinear(torch.from_numpy(rw.packed),
                                  torch.from_numpy(rw.scales),
                                  torch.from_numpy(rw.mins), None, rw.fmt,
                                  rw.group, k, n))
    jf, tf = JL.fuse_linears(jls), TL.fuse_linears(tls)
    assert tf.splits == jf.splits and tf.n == jf.n == 256
    np.testing.assert_array_equal(TL.unpack_q4(tf).numpy(),
                                  np.asarray(JL.unpack_q4(jf)))
    np.testing.assert_array_equal(TL.dequantize_weight(tf).numpy(),
                                  np.asarray(JL.dequantize_weight(jf)))


# -- KV cache -----------------------------------------------------------------


def test_kv_write_drops_out_of_range_positions():
    """Padding tokens carry pos >= max_seq (runner prefill); they must be
    dropped as JAX's scatter drops them, never clobbering live entries."""
    layers, b, s, h, d = 2, 2, 16, 2, 8
    jkv = JKV.init_cache(layers, b, s, h, d)
    tkv = TKV.init_cache(layers, b, s, h, d, device="cpu")
    steps = [
        np.array([[0, 1, 2, 16, 16, 16], [0, 1, 16, 16, 16, 16]]),  # prefill
        np.array([[3], [16]]),  # one row decodes, the other is padding
        np.array([[15, 16, 40, 14], [2, 3, 4, 15]]),  # last slot + OOB
    ]
    for i, pos in enumerate(steps):
        t = pos.shape[1]
        k, v = rnd(20 + i, b, t, h, d), rnd(30 + i, b, t, h, d)
        for layer in range(layers):
            jkv = JKV.write(jkv, layer, jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos, jnp.int32))
            TKV.write(tkv, layer, torch.from_numpy(k), torch.from_numpy(v),
                      torch.from_numpy(pos.astype(np.int32)))
    assert TKV.cache_shape(tkv) == JKV.cache_shape(jkv)
    for layer in range(layers):
        for bound in (None, 8):
            jk, jv = JKV.read(jkv, layer, bound=bound)
            tk, tv = TKV.read(tkv, layer, bound=bound)
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- attention ----------------------------------------------------------------

ATTN = {
    "causal": {},
    "window": dict(sliding_window=5),
    "chunked_window": dict(sliding_window=-4),
    "softcap": dict(softcap=3.0),
    "sinks": dict(sinks=True),
    "alibi": dict(alibi=True),
}


def _attn_inputs(b, t, kh, r, s, d, seed):
    q = rnd(seed, b, t, kh, r, d)
    keys, vals = rnd(seed + 1, b, s, kh, d), rnd(seed + 2, b, s, kh, d)
    start = np.array([3, 0][:b])[:, None]
    pos = (start + np.arange(t)[None, :]).astype(np.int32)
    pos[-1, -1] = s  # a padding token: sees nothing
    lengths = (start[:, 0] + t).astype(np.int32)
    sinks = rnd(seed + 3, kh, r)
    return q, keys, vals, pos, lengths, sinks


def _run_both(fn_j, fn_t, inputs, opts):
    q, keys, vals, pos, lengths, sinks = inputs
    kw = dict(scale=0.125, **{k: v for k, v in opts.items() if k != "sinks"})
    want = np.asarray(fn_j(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(vals),
        jnp.asarray(pos), jnp.asarray(lengths),
        sinks=jnp.asarray(sinks) if opts.get("sinks") else None, **kw))
    got = fn_t(
        torch.from_numpy(q), torch.from_numpy(keys), torch.from_numpy(vals),
        torch.from_numpy(pos), torch.from_numpy(lengths),
        sinks=torch.from_numpy(sinks) if opts.get("sinks") else None, **kw)
    return got.numpy(), want


@pytest.mark.parametrize("name", list(ATTN))
@pytest.mark.parametrize("side", ["dense", "chunked"])
def test_attention_scores(name, side):
    """Both sides of CHUNK_THRESHOLD: B*T*K*R*S = 2*32*2*4*S; the chunked
    side's S = 8448 is not a multiple of the 256-key block."""
    s = 64 if side == "dense" else 8448
    assert (2 * 32 * 2 * 4 * s > JA.CHUNK_THRESHOLD) == (side == "chunked")
    assert TA.CHUNK_THRESHOLD == JA.CHUNK_THRESHOLD
    inputs = _attn_inputs(2, 32, 2, 4, s, 16, 40)
    got, want = _run_both(JA.attention_scores, TA.attention_scores, inputs,
                          ATTN[name])
    np.testing.assert_allclose(got, want, **TOL)


def test_chunked_matches_dense_ragged_s():
    """S not a multiple of the block: the port's shorter last block agrees
    with the JAX chunked path (which pads)."""
    inputs = _attn_inputs(2, 4, 2, 2, 600, 16, 50)
    got, want = _run_both(JA.chunked_attention, TA.chunked_attention, inputs,
                          dict(sliding_window=7, sinks=True))
    np.testing.assert_allclose(got, want, **TOL)


# -- the numpy modules the port copies ----------------------------------------


@pytest.mark.parametrize("t", PORTED, ids=lambda t: t.name)
def test_quantize_and_dequantize_match_jax(t):
    x = rnd(60, 8, 512, scale=0.1)
    raw = tq.quantize(x, t)
    np.testing.assert_array_equal(raw, jq.quantize(x, t))
    np.testing.assert_array_equal(tdq.dequantize(raw, t),
                                  jdq.dequantize(raw, t))


def test_unported_types_raise_naming_the_roadmap():
    """The grid formats have no quantizer and no kernel layout in either
    package: both raise, and the port names the roadmap entry that says
    so."""
    for quantize in (tq.quantize, jq.quantize):
        with pytest.raises(NotImplementedError):
            quantize(np.zeros(256, np.float32), GGMLType.IQ2_XXS)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        tq.quantize(np.zeros(256, np.float32), GGMLType.IQ2_XXS)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        trp.repack(np.zeros(66 * 8, np.uint8), GGMLType.IQ2_XXS, (8, 256))


def test_synthetic_builder_matches_jax(tmp_path):
    """The port's builder writes the same file, byte for byte."""
    a, b = str(tmp_path / "jax.gguf"), str(tmp_path / "torch.gguf")
    jbuild(a, preset="tiny", quant=GGMLType.Q4_K, seed=3)
    tbuild(b, preset="tiny", quant=GGMLType.Q4_K, seed=3)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert os.path.getsize(b) > 0
