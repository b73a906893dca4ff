"""The port's TurboQuant and QJL primitives (models/turboquant.py) and
ops/attention.qjl_attention against the JAX package on the CPU.

Tolerances: the Hadamard matrix, the quantizer, the packing and the
unpacking are bit-identical on the same (rotated) input. The rotation is a
[D, D] product whose sums torch and XLA may order differently, so after it
a value within a few ulps of a level boundary (or of 0, for a sign) may
land one level over: ``compress`` gives equal levels on >= 99.9% of the
elements and never two levels apart, equal sign bits on >= 99.9%; scales
and norms within 1e-6 relative; rotations, decompressed values, QJL scores
and attention within 1e-5 of their largest magnitude."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from llama_gguf_tpu.models import turboquant as JTQ
from llama_gguf_tpu.ops import attention as JA

from llama_gguf_tpu_torch.models import turboquant as TQ
from llama_gguf_tpu_torch.ops import attention as TA

REL = 1e-5
AGREE = 0.999  # share of levels or sign bits equal after the rotation


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


def randn(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("d", [8, 64, 256])
def test_hadamard_and_rotation_match_jax(d):
    np.testing.assert_array_equal(TQ.hadamard_matrix(d),
                                  JTQ.hadamard_matrix(d))
    x = randn(3, 5, d)
    close(TQ.rotate(torch.from_numpy(x)).numpy(),
          np.asarray(JTQ.rotate(jnp.asarray(x))))
    with pytest.raises(ValueError, match="power of 2"):
        TQ.hadamard_matrix(24)


def test_hadamard_is_built_once_per_device():
    a = TQ._hadamard(64, torch.device("cpu"))
    assert TQ._hadamard(64, torch.device("cpu")) is a


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_quantize_and_pack_bit_equal_on_the_same_input(bits):
    """quantize_midrise, dequantize_midrise, pack_levels and unpack_levels
    on one rotated input (the JAX package's rotation, so no boundary
    moves): bit-identical levels, scales, bytes and values."""
    r = np.array(JTQ.rotate(jnp.asarray(randn(4, 7, 64, seed=bits))))
    jq, jd = JTQ.quantize_midrise(jnp.asarray(r), bits)
    tq, td = TQ.quantize_midrise(torch.from_numpy(r), bits)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jp = JTQ.pack_levels(jq, bits)
    tp = TQ.pack_levels(tq, bits)
    assert tp.dtype == torch.uint8 and tp.shape[-1] == 64 * bits // 8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(TQ.unpack_levels(tp, bits, 64).numpy(),
                                  np.asarray(JTQ.unpack_levels(jp, bits, 64)))
    np.testing.assert_array_equal(
        TQ.dequantize_midrise(tq, td, bits).numpy(),
        np.asarray(JTQ.dequantize_midrise(jq, jd, bits)))


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_pack_unpack_exact(bits):
    q = np.random.default_rng(bits).integers(0, 1 << bits, size=(3, 5, 64))
    q = torch.from_numpy(q.astype(np.uint8))
    assert torch.equal(TQ.unpack_levels(TQ.pack_levels(q, bits), bits, 64),
                       q)


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_compress_end_to_end_matches_jax(bits):
    """compress on 4,096 vectors of 128: levels equal on >= 99.9% and never
    more than one apart, scales within 1e-6; decompress of the port's own
    bytes equals the JAX decompress of them within 1e-5."""
    x = randn(64, 64, 128, seed=10 + bits)
    jp, jd = JTQ.compress(jnp.asarray(x), bits)
    tp, td = TQ.compress(torch.from_numpy(x), bits)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    jl = np.asarray(JTQ.unpack_levels(jp, bits, 128)).astype(int)
    tl = TQ.unpack_levels(tp, bits, 128).numpy().astype(int)
    assert (jl == tl).mean() >= AGREE
    assert np.abs(jl - tl).max() <= 1
    close(TQ.decompress(tp, td, bits, 128).numpy(),
          np.asarray(JTQ.decompress(jnp.asarray(tp.numpy()),
                                    jnp.asarray(td.numpy()), bits, 128)))


def test_qjl_compress_and_scores_match_jax():
    """Sign bits equal on >= 99.9%, norms within 1e-6; the score estimates
    on the same sketches within 1e-5 (both estimators, GQA-batched and
    plain)."""
    k = randn(16, 32, 4, 128, seed=3)
    jp, jn = JTQ.qjl_compress(jnp.asarray(k))
    tp, tn = TQ.qjl_compress(torch.from_numpy(k))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    jbits = np.unpackbits(np.asarray(jp), axis=-1)
    tbits = np.unpackbits(tp.numpy(), axis=-1)
    assert (jbits == tbits).mean() >= AGREE
    q = randn(16, 3, 4, 2, 128, seed=4)
    close(TQ.qjl_scores_batched(torch.from_numpy(q), tp, tn).numpy(),
          np.asarray(JTQ.qjl_scores_batched(
              jnp.asarray(q), jnp.asarray(tp.numpy()),
              jnp.asarray(tn.numpy()))))
    q1 = randn(5, 128, seed=6)
    close(TQ.qjl_scores(torch.from_numpy(q1), tp[0, :, 0],
                        tn[0, :, 0]).numpy(),
          np.asarray(JTQ.qjl_scores(jnp.asarray(q1),
                                    jnp.asarray(tp[0, :, 0].numpy()),
                                    jnp.asarray(tn[0, :, 0].numpy()))))


def test_qjl_unbiased_scores():
    """The JAX package's estimator check on the port: correlated with the
    true scores, slope near 1."""
    k = randn(64, 128, seed=7)
    q = randn(128, seed=8)
    packed, norms = TQ.qjl_compress(torch.from_numpy(k))
    est = TQ.qjl_scores(torch.from_numpy(q), packed, norms).numpy()
    true = k @ q
    assert np.corrcoef(true, est)[0, 1] > 0.75
    assert 0.7 < np.polyfit(true, est, 1)[0] < 1.3


@pytest.mark.parametrize("window", [0, 5, -4])
def test_qjl_attention_matches_jax(window):
    """qjl_attention on the same sketches and tq4 values, causal with
    lengths, a sliding window or chunks, softcap on: within 1e-5."""
    b, t, s, kh, r, d = 2, 3, 12, 2, 2, 64
    k, v = randn(b, s, kh, d, seed=1), randn(b, s, kh, d, seed=2)
    qg = randn(b, t, kh, r, d, seed=3)
    kp, kn = TQ.qjl_compress(torch.from_numpy(k))
    vp, vs = TQ.compress(torch.from_numpy(v), 4)
    pos = np.array([[7, 8, 9], [0, 1, 30]], np.int32)
    lengths = np.array([10, 2], np.int32)
    kw = dict(scale=d ** -0.5, v_head_dim=d, softcap=30.0,
              sliding_window=window)
    got = TA.qjl_attention(torch.from_numpy(qg), kp, kn, vp, vs,
                           torch.from_numpy(pos), torch.from_numpy(lengths),
                           **kw)
    want = JA.qjl_attention(
        jnp.asarray(qg), *(jnp.asarray(a.numpy()) for a in (kp, kn, vp, vs)),
        jnp.asarray(pos), jnp.asarray(lengths), **kw)
    close(got.numpy(), np.asarray(want))
