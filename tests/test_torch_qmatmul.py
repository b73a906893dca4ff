"""PyTorch port's dequant-matmul (the plain versions the wrappers take on the
CPU) against the JAX Pallas kernels run in interpret mode. The CUDA kernels
themselves are held against these plain versions on a card by
tests/test_torch_kernels.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.ops.linear import QuantLinear as JQuantLinear
from llama_gguf_tpu.ops.linear import _apply_quant_xla
from llama_gguf_tpu.ops.qmatmul import GLU_ACTS as J_GLU_ACTS
from llama_gguf_tpu.ops.qmatmul import _glu_combine, qmatmul as jqmatmul
from llama_gguf_tpu.ops.qmatmul import qmatmul_glu as jqmatmul_glu
from llama_gguf_tpu.quant.quantize import quantize
from llama_gguf_tpu.quant.repack import repack as jrepack

from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.ops import shortconv as SC
from llama_gguf_tpu_torch.ops.linear import QuantLinear
from llama_gguf_tpu_torch.quant.repack import repack

torch.set_num_threads(1)

# f32 against f32: only the order of summation differs (as tests/test_qmatmul)
TOL = dict(rtol=1e-4, atol=1e-4)

FORMATS = [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0, GGMLType.Q5_1]


def make_pair(t, n, k, seed, splits=None, bias=False):
    """The same quantized weight as a JAX QuantLinear and a port one (each
    package repacks the same GGUF bytes with its own repack)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.1
    raw = quantize(w, t)
    jr, tr = jrepack(raw, t, (n, k)), repack(raw, t, (n, k))
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    jl = JQuantLinear(
        jnp.asarray(jr.packed), jnp.asarray(jr.scales),
        jnp.asarray(jr.mins) if jr.mins is not None else None,
        jnp.asarray(b) if bias else None, jr.fmt, jr.group, k, n, t.name,
        splits=splits)
    pl = QuantLinear(
        torch.from_numpy(tr.packed), torch.from_numpy(tr.scales),
        torch.from_numpy(tr.mins) if tr.mins is not None else None,
        torch.from_numpy(b) if bias else None, tr.fmt, tr.group, k, n,
        t.name, splits=splits)
    return jl, pl


def make_x(b, k, seed):
    return np.random.default_rng(seed + 1).standard_normal(
        (b, k)).astype(np.float32)


@pytest.mark.parametrize("t", FORMATS, ids=lambda t: t.name)
def test_repack_matches_jax(t):
    jl, pl = make_pair(t, 256, 512, 0)
    np.testing.assert_array_equal(np.asarray(jl.packed), pl.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jl.scales), pl.scales.numpy())
    if jl.mins is None:
        assert pl.mins is None
    else:
        np.testing.assert_array_equal(np.asarray(jl.mins), pl.mins.numpy())
    assert (pl.fmt, pl.group) == (jl.fmt, jl.group)


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("t", FORMATS, ids=lambda t: t.name)
def test_qmatmul_matches_pallas(t, b):
    jl, pl = make_pair(t, 256, 512, 1)
    x = make_x(b, 512, 1)
    want = np.asarray(jqmatmul(jnp.asarray(x), jl, interpret=True,
                               precision="highest"))
    got = Q.qmatmul(torch.from_numpy(x), pl)
    assert got.shape == (b, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_qmatmul_ragged_n(t):
    """N not a multiple of 128 (the JAX entry takes its XLA path there)."""
    jl, pl = make_pair(t, 200, 512, 2)
    x = make_x(3, 512, 2)
    want = np.asarray(jqmatmul(jnp.asarray(x), jl, interpret=True,
                               precision="highest"))
    np.testing.assert_allclose(Q.qmatmul(torch.from_numpy(x), pl).numpy(),
                               want, **TOL)


def test_glu_acts_match_jax():
    assert Q.GLU_ACTS == J_GLU_ACTS


@pytest.mark.parametrize("act", Q.GLU_ACTS)
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda t: t.name)
def test_qmatmul_glu_matches_pallas(t, act):
    f = 256
    jl, pl = make_pair(t, 2 * f, 512, 3, splits=(f, f))
    x = make_x(3, 512, 3)
    want = np.asarray(jqmatmul_glu(jnp.asarray(x), jl, act, interpret=True,
                                   precision="highest"))
    got = Q.qmatmul_glu(torch.from_numpy(x), pl, act)
    assert got.shape == (3, f)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("t", [GGMLType.Q8_0, GGMLType.Q5_1],
                         ids=lambda t: t.name)
def test_qmatmul_glu_batches(t, b):
    f = 128
    jl, pl = make_pair(t, 2 * f, 256, 4, splits=(f, f))
    x = make_x(b, 256, 4)
    want = np.asarray(jqmatmul_glu(jnp.asarray(x), jl, "silu",
                                   interpret=True, precision="highest"))
    np.testing.assert_allclose(
        Q.qmatmul_glu(torch.from_numpy(x), pl, "silu").numpy(), want, **TOL)


def test_qmatmul_glu_ragged_f():
    """F not a multiple of 128: the JAX entry declines (None) while the port
    computes it; held against the JAX epilogue over the XLA product."""
    f = 96
    jl, pl = make_pair(GGMLType.Q4_K, 2 * f, 256, 5, splits=(f, f))
    x = make_x(5, 256, 5)
    assert jqmatmul_glu(jnp.asarray(x), jl, "gelu", interpret=True) is None
    y = _apply_quant_xla(jnp.asarray(x), jl)
    want = np.asarray(_glu_combine(y[:, :f], y[:, f:], "gelu"))
    np.testing.assert_allclose(
        Q.qmatmul_glu(torch.from_numpy(x), pl, "gelu").numpy(), want, **TOL)


@pytest.mark.parametrize("case", ["bias", "unequal", "three", "act"])
def test_qmatmul_glu_declines_like_jax(case):
    splits = {"unequal": (128, 256), "three": (128, 128, 128)}.get(
        case, (128, 128))
    jl, pl = make_pair(GGMLType.Q4_K, sum(splits), 256, 6, splits=splits,
                       bias=case == "bias")
    act = "tanh" if case == "act" else "silu"
    x = make_x(2, 256, 6)
    assert jqmatmul_glu(jnp.asarray(x), jl, act, interpret=True) is None
    assert Q.qmatmul_glu(torch.from_numpy(x), pl, act) is None


def test_cpu_path_does_not_count_launches():
    _, pl = make_pair(GGMLType.Q4_K, 128, 256, 7)
    Q.reset_launches()
    Q.qmatmul(torch.from_numpy(make_x(2, 256, 7)), pl)
    SC.causal_conv(torch.zeros(2, 3, 8), torch.zeros(2, 2, 8),
                   torch.ones(3, 8), None, torch.ones(2, dtype=torch.int32))
    assert Q.LAUNCHES == {"qmatmul_q4": 0, "qmatmul_q8": 0, "qmatmul_glu": 0,
                          "moe_slot": 0, "moe_grouped": 0,
                          "moe_glu_grouped": 0, "short_conv": 0}
