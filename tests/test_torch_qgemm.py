"""Kernels 1-2 of the port (csrc/qgemm.cu) on the CPU: the launch plan
(ops/qmatmul.qmatmul_plan) at the main paths' shapes, the exact three-part
bf16 split of x the tensor-core path rests on, its arithmetic written in
torch against the JAX Pallas kernel in interpret mode, and the bound of the
tensor-core path. The kernels themselves run on a card only
(tests/test_torch_kernels.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.ops.linear import QuantLinear as JQuantLinear
from llama_gguf_tpu.ops.qmatmul import qmatmul as jqmatmul
from llama_gguf_tpu.quant.quantize import quantize
from llama_gguf_tpu.quant.repack import repack as jrepack

from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.ops.linear import QuantLinear
from llama_gguf_tpu_torch.quant.repack import repack
from llama_gguf_tpu_torch.utils.timing import CARD_PEAKS, bound_ms

torch.set_num_threads(1)

# (name, K, N, group, fmt): TinyLlama-1.1B's and Mixtral-8x7B's projections
# on the q4/q8 kernels, and the probe's two Llama-3-8B shapes
SHAPES = [("TinyLlama qkv", 2048, 2560, 32, "q4"),
          ("TinyLlama o_proj", 2048, 2048, 32, "q4"),
          ("TinyLlama ffn_down", 5632, 2048, 16, "q8"),
          ("TinyLlama lm_head", 2048, 32000, 16, "q8"),
          ("Mixtral qkv", 4096, 6144, 32, "q4"),
          ("Mixtral lm_head", 4096, 32000, 16, "q8"),
          ("probe 4096x14336", 4096, 14336, 32, "q4"),
          ("probe 14336x4096", 14336, 4096, 32, "q4")]
ROWS = [1, 2, 4, 8, 16, 128, 512]
SMS = 132  # an H100 SXM


def slices(k, group, splits, path):
    """The kernels' cut of K: slice s holds units [s*U/S, (s+1)*U/S), the
    units being scale groups (split-K) or 32-element stages (tc)."""
    units = k // group if path == "splitk" else k // Q.TC_STAGE
    return [(s * units // splits, (s + 1) * units // splits)
            for s in range(splits)], units


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("name,k,n,group,fmt", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_at_main_path_shapes(name, k, n, group, fmt, b):
    plan = Q.qmatmul_plan(b, k, n, group, fmt, SMS)
    assert plan.path == ("tc" if b >= Q.TC_MIN_ROWS else "splitk")
    # the slices cover K in whole groups, none empty, in order
    cut, units = slices(k, group, plan.splits, plan.path)
    assert cut[0][0] == 0 and cut[-1][1] == units
    assert all(lo < hi for lo, hi in cut)
    assert all(a[1] == b_[0] for a, b_ in zip(cut, cut[1:]))
    if plan.path == "tc":  # a 32-element stage holds whole groups
        assert Q.TC_STAGE % group == 0 and k % Q.TC_STAGE == 0
        assert plan.rows in (16, 32, 64) and plan.cols == Q.TC_COLS
        assert min(hi - lo for lo, hi in cut) >= 8 or plan.splits == 1
    else:
        assert plan.rows == 1 and plan.cols == Q.SPLITK_COLS
    # the grid: splits x row tiles x column tiles, inside CUDA's limits
    assert plan.grid == (plan.splits, -(-b // plan.rows), -(-n // plan.cols))
    assert 1 <= plan.splits <= Q.MAX_SPLITS
    assert max(plan.grid[1:]) <= 65535
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    if b == 1:  # decode: a block of 64 threads for every SM at least
        assert blocks >= SMS
    # the split-K workspace: one f32 tile per (tile, slice), none unsplit
    want = (4 * plan.grid[1] * plan.grid[2] * plan.splits * plan.rows
            * plan.cols if plan.splits > 1 else 0)
    assert plan.scratch_bytes == want
    assert plan.tiles == plan.grid[1] * plan.grid[2]


@pytest.mark.parametrize("case", ["ragged", "unaligned", "q4 group 64"])
def test_plan_falls_back_to_split_k(case):
    """The tensor cores take 16-byte loads, N % 16 == 0 and groups of 16 or
    32; other layouts take split-K at any row count (byte loads when
    unaligned), and forcing tc on them raises."""
    n, aligned, group = 2048, True, 32
    if case == "ragged":
        n = 200
    elif case == "unaligned":
        aligned = False
    else:
        group = 64
    plan = Q.qmatmul_plan(512, 2048, n, group, "q4", aligned=aligned)
    assert plan.path == "splitk" and plan.rows == 1
    assert plan.vec == (case == "q4 group 64")
    with pytest.raises(ValueError):
        Q.qmatmul_plan(512, 2048, n, group, "q4", aligned=aligned, path="tc")


def test_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        Q.qmatmul_plan(1, 2048, 2048, 16, "q4")  # q4 needs groups of 32
    with pytest.raises(ValueError):
        Q.qmatmul_plan(1, 2048, 2048, 32, "q4", splits=65)
    with pytest.raises(ValueError):
        Q.qmatmul_plan(8, 2048, 2048, 32, "q4", path="tc", tile_rows=48)


def split3(x: torch.Tensor):
    """hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0, 1e4])
def test_three_part_split_is_exact(scale):
    x = torch.from_numpy(np.random.default_rng(int(scale * 7) % 1000)
                         .standard_normal(1 << 16).astype(np.float32) * scale)
    hi, mid, lo = split3(x)
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    # the two-part split of "default" keeps x to 2^-16 of itself
    assert ((hi.float() + mid.float() - x).abs()
            <= x.abs() * 2.0 ** -16).all()


def split_product(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """The tensor-core path's arithmetic in torch, f32 throughout: each x
    part times the integer levels q per scale group (exact products, f32
    sums), the group's product scaled, the min term factored out:
    y = sum_g s[g] * (sum_p x_p,g @ q_g) - xs[g]^T m[g]."""
    k, n, g = lin.k, lin.n, lin.group
    if lin.fmt == "q4":  # group-split nibbles -> q [K, N] in natural order
        p = lin.packed.to(torch.int32).reshape(k // g, g // 2, n)
        q = torch.cat([p & 0xF, p >> 4], dim=1).reshape(k, n)
    else:
        q = lin.packed.to(torch.int32)
    qg = q.float().reshape(k // g, g, n)
    parts = split3(x.float())
    b = x.shape[0]
    y = torch.zeros(b, n)
    for gi in range(k // g):
        c = torch.zeros(b, n)
        for part in reversed(parts):  # smallest first, as the kernel adds
            c = c + part.float()[:, gi * g:(gi + 1) * g] @ qg[gi]
        y = y + lin.scales[gi].float() * c
        if lin.mins is not None:
            xs = x[:, gi * g:(gi + 1) * g].sum(dim=1, keepdim=True)
            y = y - xs * lin.mins[gi].float()
    return y


@pytest.mark.parametrize("b", [1, 16, 130])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0,
                               GGMLType.Q5_1], ids=lambda t: t.name)
def test_split_product_matches_pallas(t, b):
    n, k = 160, 512
    rng = np.random.default_rng(40 + b)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.1
    raw = quantize(w, t)
    jr, tr = jrepack(raw, t, (n, k)), repack(raw, t, (n, k))
    jl = JQuantLinear(jnp.asarray(jr.packed), jnp.asarray(jr.scales),
                      jnp.asarray(jr.mins) if jr.mins is not None else None,
                      None, jr.fmt, jr.group, k, n, t.name)
    pl = QuantLinear(torch.from_numpy(tr.packed), torch.from_numpy(tr.scales),
                     torch.from_numpy(tr.mins) if tr.mins is not None
                     else None, None, tr.fmt, tr.group, k, n, t.name)
    x = rng.standard_normal((b, k)).astype(np.float32)
    want = np.asarray(jqmatmul(jnp.asarray(x), jl, interpret=True,
                               precision="highest"))
    got = split_product(torch.from_numpy(x), pl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,peaks", CARD_PEAKS, ids=[c[0] for c in CARD_PEAKS])
def test_bound_of_the_tensor_core_path(name, peaks):
    """"bf16x3": three bf16 passes at the tensor cores' peak; the byte bound
    wins when the bytes take longer."""
    ops, nbytes = 2 * 512 * 2048 * 32000, 70_000_000
    ms, by = bound_ms(nbytes, ops, "bf16x3", peaks)
    assert by == "operations"
    assert ms == pytest.approx(3 * ops / peaks["bf16"] * 1e3)
    assert ms < bound_ms(nbytes, ops, "f32", peaks)[0]
    ms, by = bound_ms(nbytes, 2 * 2048 * 32000, "bf16x3", peaks)
    assert by == "bytes" and ms == pytest.approx(nbytes / peaks["bytes"] * 1e3)


@pytest.mark.parametrize("b,precision,want", [
    (512, "highest", "bf16x3"), (512, None, "bf16x3"),
    (512, "default", "bf16x2"), (8, "default", "bf16x2"),
    (1, "highest", "f32"), (1, "default", "f32")])
def test_plan_op_type_follows_the_path(b, precision, want):
    """Three bf16 passes for an f32 output, two for the bf16 output of
    "default" (the kernel drops x's third part), f32 on the CUDA cores."""
    plan = Q.qmatmul_plan(b, 2048, 2048, 32, "q4")
    assert plan.op_type(precision) == want
    ops = 2 * b * 2048 * 2048
    if want != "f32":
        passes = int(want[-1])
        peaks = dict(CARD_PEAKS)["H100"]
        assert bound_ms(0, ops, want, peaks)[0] == pytest.approx(
            passes * ops / peaks["bf16"] * 1e3)


def test_plan_is_cached():
    """Decode asks for the same plan at every step: one object, made once."""
    a = Q.qmatmul_plan(1, 2048, 2560, 32, "q4", 132, True)
    assert Q.qmatmul_plan(1, 2048, 2560, 32, "q4", 132, True) is a
    assert Q.qmatmul_plan(1, 2048, 2560, 32, "q4", 132, False) is not a
