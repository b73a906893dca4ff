"""The kernels of csrc/qgemm.cu on the CPU (kernels 1-2, the GLU kernel 3
and the MoE kernels 4-6): the launch plans (ops/qmatmul.qmatmul_plan,
moe_slot_plan, moe_grouped_plan, moe_glu_grouped_plan) at the main paths'
shapes, the exact three-part bf16 split
of x the tensor-core path rests on, the tiles' arithmetic written in torch
against the JAX Pallas kernels in interpret mode, and the bound of the
tensor-core path. The kernels themselves run on a card only
(tests/test_torch_kernels.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.ops.linear import QuantExpertStack as JStack
from llama_gguf_tpu.ops.linear import QuantLinear as JQuantLinear
from llama_gguf_tpu.ops.qmatmul import moe_qmatmul as jmoe_qmatmul
from llama_gguf_tpu.ops.qmatmul import moe_qmatmul_glu as jmoe_qmatmul_glu
from llama_gguf_tpu.ops.qmatmul import qmatmul as jqmatmul
from llama_gguf_tpu.ops.qmatmul import qmatmul_glu as jqmatmul_glu
from llama_gguf_tpu.quant.quantize import quantize
from llama_gguf_tpu.quant.repack import repack as jrepack

from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.ops.linear import QuantExpertStack, QuantLinear
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


def slices(k, group, fmt, splits, path):
    """The kernels' cut of K: slice s holds units [s*U/S, (s+1)*U/S), the
    units (ops/qmatmul.slice_units) being scale groups (split-K; two groups
    of 8 packed rows at q4 group 16, 32 packed rows of a group of 256) or
    32-element stages (tc; whole groups of 256)."""
    units = Q.slice_units(k, group, fmt, path)
    return [(s * units // splits, (s + 1) * units // splits)
            for s in range(splits)], units


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("name,k,n,group,fmt", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_at_main_path_shapes(name, k, n, group, fmt, b):
    plan = Q.qmatmul_plan(b, k, n, group, fmt, SMS)
    assert plan.path == ("tc" if b >= Q.TC_MIN_ROWS else "splitk")
    # the slices cover K in whole groups, none empty, in order
    cut, units = slices(k, group, fmt, plan.splits, plan.path)
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
        Q.qmatmul_plan(1, 2048, 2048, 8, "q4")  # q4: 16 or a multiple of 32
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
                               GGMLType.Q5_1, GGMLType.Q2_K, GGMLType.Q8_K],
                         ids=lambda t: t.name)
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


# -- kernel 3: the GLU on the two paths of csrc/qgemm.cu ----------------------

# (name, K, F, group, fmt): TinyLlama-1.1B's gate|up (Q4_K), a q8 one
# (Llama-3-8B's width at Q8_0), and Mixtral-8x7B's expert gate|up width
GLU_SHAPES = [("TinyLlama gate|up", 2048, 5632, 32, "q4"),
              ("Llama-3-8B gate|up q8", 4096, 14336, 32, "q8"),
              ("Mixtral expert gate|up", 4096, 14336, 32, "q4")]


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("name,k,f,group,fmt", GLU_SHAPES,
                         ids=[s[0] for s in GLU_SHAPES])
def test_glu_plan_at_main_path_shapes(name, k, f, group, fmt, b):
    """A block reads 128 weight columns, 64 gate and their 64 up columns:
    the grid has ceil(F / 64) column tiles; the slices cover K in order."""
    plan = Q.qmatmul_plan(b, k, f, group, fmt, SMS, glu=True)
    assert plan.glu and plan.cols == 128 and plan.out_cols == 64
    assert plan.path == ("tc" if b >= Q.TC_MIN_ROWS else "splitk")
    cut, units = slices(k, group, fmt, plan.splits, plan.path)
    assert cut[0][0] == 0 and cut[-1][1] == units
    assert all(lo < hi for lo, hi in cut)
    assert all(a[1] == b_[0] for a, b_ in zip(cut, cut[1:]))
    if plan.path == "tc":
        assert plan.rows in (16, 32, 64)
        assert min(hi - lo for lo, hi in cut) >= 8 or plan.splits == 1
    else:
        assert plan.rows == 1
    assert plan.grid == (plan.splits, -(-b // plan.rows), -(-f // 64))
    assert 1 <= plan.splits <= Q.MAX_SPLITS
    if b == 1:  # decode fills the card as kernel 1 does
        assert plan.grid[0] * plan.grid[2] >= SMS
    # the workspace holds both halves of every tile: rows x 128 floats
    assert plan.scratch_bytes == (4 * plan.tiles * plan.splits * plan.rows
                                  * 128 if plan.splits > 1 else 0)


@pytest.mark.parametrize("case", ["ragged", "unaligned", "q4 group 64"])
def test_glu_plan_layout_rule(case):
    """F % 16 != 0, unaligned tensors or a q4 group other than 32 take
    split-K at any row count (byte loads unless only the group is off);
    forcing the tensor cores on them raises."""
    f, aligned, group = 5632, True, 32
    if case == "ragged":
        f = 200
    elif case == "unaligned":
        aligned = False
    else:
        group = 64
    plan = Q.qmatmul_plan(512, 2048, f, group, "q4", aligned=aligned,
                          glu=True)
    assert plan.path == "splitk" and plan.vec == (case == "q4 group 64")
    assert plan.grid[2] == -(-f // 64)
    with pytest.raises(ValueError):
        Q.qmatmul_plan(512, 2048, f, group, "q4", aligned=aligned, path="tc",
                       glu=True)


def levels(lin) -> torch.Tensor:
    """The integer levels q [K, N] of a q4/q8 weight, natural k order."""
    k, n, g = lin.k, lin.n, lin.group
    if lin.fmt == "q4":  # group-split nibbles
        p = lin.packed.to(torch.int32).reshape(k // g, g // 2, n)
        return torch.cat([p & 0xF, p >> 4], dim=1).reshape(k, n).float()
    return lin.packed.to(torch.int32).float()


def sliced_product(x: torch.Tensor, lin, splits: int) -> torch.Tensor:
    """The kernels' arithmetic with K cut into ``splits`` slices of whole
    split-K units: within a slice, each group's part (a whole group, or a
    unit's part of a longer one) as the product of the three bf16 parts of x
    (smallest first), scaled, less the min term, summed in K order; then the
    slices' partial tiles summed in slice order (split_sum)."""
    k, n, g = lin.k, lin.n, lin.group
    q = levels(lin)
    parts = split3(x.float())
    b = x.shape[0]
    cut, units = slices(k, g, lin.fmt, splits, "splitk")
    seg = min(g, k // units)  # K elements of one fold
    total = None
    for lo, hi in cut:
        part = torch.zeros(b, n)
        for k0 in range(lo * k // units, hi * k // units, seg):
            gi, k1 = k0 // g, k0 + seg
            c = torch.zeros(b, n)
            for p in reversed(parts):
                c = c + p.float()[:, k0:k1] @ q[k0:k1]
            part = part + lin.scales[gi].float() * c
            if lin.mins is not None:
                xs = x[:, k0:k1].sum(dim=1, keepdim=True)
                part = part - xs * lin.mins[gi].float()
        total = part if total is None else total + part
    return total


def both_linears(t, n, k, seed, splits=None):
    """The same random weight as a JAX QuantLinear and a port one."""
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32) * 0.1
    raw = quantize(w, t)
    jr, tr = jrepack(raw, t, (n, k)), repack(raw, t, (n, k))
    jl = JQuantLinear(jnp.asarray(jr.packed), jnp.asarray(jr.scales),
                      jnp.asarray(jr.mins) if jr.mins is not None else None,
                      None, jr.fmt, jr.group, k, n, t.name, splits)
    pl = QuantLinear(torch.from_numpy(tr.packed), torch.from_numpy(tr.scales),
                     torch.from_numpy(tr.mins) if tr.mins is not None
                     else None, None, tr.fmt, tr.group, k, n, t.name,
                     splits=splits)
    return jl, pl


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("act", Q.GLU_ACTS)
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0,
                               GGMLType.Q5_1, GGMLType.Q2_K, GGMLType.Q8_K],
                         ids=lambda t: t.name)
def test_glu_tile_arithmetic_matches_pallas(t, act, splits):
    """Kernel 3's arithmetic: both halves' partial tiles summed over the K
    slices in order, act(gate) * up taken after the sum; against the JAX
    GLU kernel in interpret mode."""
    f, k, b = 128, 512, 6
    jl, pl = both_linears(t, 2 * f, k, 50 + splits, splits=(f, f))
    x = np.random.default_rng(51).standard_normal((b, k)).astype(np.float32)
    want = jqmatmul_glu(jnp.asarray(x), jl, act, interpret=True,
                        precision="highest")
    assert want is not None
    y = sliced_product(torch.from_numpy(x), pl, splits)
    got = Q.glu_combine(y[:, :f], y[:, f:], act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("b,precision,want", [
    (128, "highest", "bf16x3"), (128, "default", "bf16x2"),
    (1, "highest", "f32"), (1, "default", "f32")])
def test_glu_bound_follows_the_path(b, precision, want):
    """Tensor cores: P x 2 B K 2F bf16 operations; split-K: the bytes."""
    k, f = 2048, 5632
    plan = Q.qmatmul_plan(b, k, f, 32, "q4", glu=True)
    assert plan.op_type(precision) == want
    peaks = dict(CARD_PEAKS)["H100"]
    ops = 2 * b * k * 2 * f
    nbytes = k // 2 * 2 * f + 2 * 4 * (k // 32) * 2 * f + 4 * b * (k + f)
    ms, by = bound_ms(nbytes, ops, plan.op_type(precision), peaks)
    if want == "f32":
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / peaks["bytes"] * 1e3)
    else:
        assert by == "operations"
        assert ms == pytest.approx(int(want[-1]) * ops / peaks["bf16"] * 1e3)


# -- kernel 5: the grouped MoE product on the tensor cores -------------------


def test_grouped_tile_lies_inside_one_group():
    """For every S the grouped rule admits, BM divides C: no tile straddles
    two groups (two experts)."""
    seen = set()
    for e_num in (4, 8, 64, 128):
        for s in list(range(32, 600)) + [1024, 2048, 4096, 8192]:
            c_rows, g_blocks, grouped = Q.moe_dims(s, e_num)
            if not grouped:
                continue
            plan = Q.moe_grouped_plan(s, e_num, 4096, 4096, 16, "q8")
            assert plan.path == "tc" and c_rows >= 32
            assert c_rows % plan.rows == 0
            assert plan.grid[1] * plan.rows == g_blocks * c_rows
            seen.add((plan.rows, c_rows))
    assert {r for r, _ in seen} >= {16, 32, 64}


def test_grouped_plan_layout_rule():
    """Ragged N, unaligned stacks and q4 groups other than 32 keep the
    CUDA-core grouped kernel, which sets its own tile and grid (K
    unsplit)."""
    for n, aligned, group, fmt in ((200, True, 16, "q8"),
                                   (4096, False, 16, "q8"),
                                   (4096, True, 64, "q4")):
        plan = Q.moe_grouped_plan(256, 8, 4096, n, group, fmt,
                                  aligned=aligned)
        assert plan.path == "cuda cores" and plan.splits == 1
        assert plan.grid is None and plan.op_type() == "f32"
        with pytest.raises(ValueError):
            Q.moe_grouped_plan(256, 8, 4096, n, group, fmt, aligned=aligned,
                               path="tc")
    with pytest.raises(ValueError):  # below the grouped rule
        Q.moe_grouped_plan(16, 8, 4096, 4096, 16, "q8")
    with pytest.raises(ValueError):  # a tile taller than C = 32
        Q.moe_grouped_plan(32, 4, 4096, 4096, 16, "q8", tile_rows=64)


def routing(kind: str, s: int, e_num: int) -> np.ndarray:
    """uniform: slot s on expert s % E; skewed: expert 2 takes every other
    slot, expert 1 none; one: every slot on expert 1."""
    if kind == "uniform":
        return (np.arange(s) % e_num).astype(np.int32)
    if kind == "one":
        return np.ones(s, np.int32)
    rng = np.random.default_rng(s)
    idx = np.where(np.arange(s) % 2 == 0, 2, rng.integers(0, e_num, size=s))
    idx[idx == 1] = 3
    return idx.astype(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "skewed", "one"])
@pytest.mark.parametrize("s", [32, 64, 257, 1000])
def test_padding_tiles_are_those_whose_first_id_is_s(s, kind):
    """A group's valid rows come first: a tile is padding only exactly when
    its first slot id is S, and at most ceil(S/BM) + E tiles hold a slot
    (the split of K aims at those)."""
    e_num = 8
    c_rows, g_blocks, grouped = Q.moe_dims(s, e_num)
    assert grouped
    _, rows, _ = Q.moe_group_plan(torch.from_numpy(routing(kind, s, e_num)),
                                  e_num, c_rows, g_blocks)
    for bm in (16, 32, 64):
        if c_rows % bm:
            continue
        tiles = rows.reshape(-1, bm)
        padding = (tiles == s).all(dim=1)
        assert torch.equal(padding, tiles[:, 0] == s)
        live = int((~padding).sum())
        assert live <= -(-s // bm) + e_num
        # inside a tile the valid rows come first, too
        valid = (tiles < s).int()
        assert torch.equal(valid, torch.sort(valid, dim=1,
                                             descending=True).values)


def both_stacks(t, e_num, n, k, seed):
    rng = np.random.default_rng(seed)
    raws = [quantize(rng.standard_normal((n, k)).astype(np.float32) * 0.1, t)
            for _ in range(e_num)]
    jr = [jrepack(r, t, (n, k)) for r in raws]
    tr = [repack(r, t, (n, k)) for r in raws]
    has_mins = jr[0].mins is not None

    def stack(rs, put):
        return [put(np.stack([getattr(r, key) for r in rs]))
                if key != "mins" or has_mins else None
                for key in ("packed", "scales", "mins")]

    js = JStack(*stack(jr, jnp.asarray), jr[0].fmt, jr[0].group, k, n)
    ts = QuantExpertStack(*stack(tr, torch.from_numpy), tr[0].fmt,
                          tr[0].group, k, n)
    return js, ts


def expert_linear(stack, e: int) -> QuantLinear:
    """Expert e of a port stack as a QuantLinear (views, no copy)."""
    return QuantLinear(stack.packed[e], stack.scales[e],
                       stack.mins[e] if stack.mins is not None else None,
                       None, stack.fmt, stack.group, stack.k, stack.n,
                       "expert")


def gathered_model(x: torch.Tensor, stack, idx: torch.Tensor, splits: int,
                   up=None, act: str | None = None) -> torch.Tensor:
    """Kernel 5's tensor-core path in torch (with ``up`` and ``act``, kernel
    6's): BM-row tiles of the blocked [G*C] layout; a tile whose first id is
    S is skipped; else its expert is eg[row0 // C], its rows are gathered
    from x (the padding id reads zeros), the tile's product is
    sliced_product (kernel 6: over each stack, then act(gate) * up after the
    slice sum), and only its valid rows are written; read back through the
    plan's inverse map."""
    s, k = x.shape
    e_num, n = stack.packed.shape[0], stack.n
    c_rows, g_blocks, _ = Q.moe_dims(s, e_num)
    plan = Q.moe_grouped_plan(s, e_num, k, n, stack.group, stack.fmt,
                              glu=up is not None)
    bm = plan.rows
    eg, rows, flat = Q.moe_group_plan(idx, e_num, c_rows, g_blocks)
    rows = rows.reshape(-1)
    xz = torch.cat([x, torch.zeros(1, k)])
    out = torch.full((g_blocks * c_rows, n), float("nan"))
    for row0 in range(0, g_blocks * c_rows, bm):
        sid = rows[row0:row0 + bm].long()
        if sid[0] == s:
            continue
        assert row0 // c_rows == (row0 + bm - 1) // c_rows
        e = int(eg[row0 // c_rows])
        y = sliced_product(xz[sid], expert_linear(stack, e), splits)
        if up is not None:
            y = Q.glu_combine(y, sliced_product(xz[sid], expert_linear(up, e),
                                                splits), act)
        live = torch.nonzero(sid < s)[:, 0]
        out[row0 + live] = y[live]
    return out[flat]


@pytest.mark.parametrize("kind", ["uniform", "skewed", "one"])
@pytest.mark.parametrize("s", [32, 64, 257])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q2_K,
                               GGMLType.Q8_K], ids=lambda t: t.name)
def test_gathered_row_model_matches_pallas(t, s, kind):
    """The gathered-row tiles against the JAX package's moe_qmatmul in
    interpret mode; every slot's row is written. (The JAX entry declines a
    single group of 256, so Q8_K takes two.)"""
    e_num, k, n = 4, 512 if t == GGMLType.Q8_K else 256, 128
    js, ts = both_stacks(t, e_num, n, k, 60)
    x = np.random.default_rng(61 + s).standard_normal((s, k)).astype(
        np.float32)
    idx = routing(kind, s, e_num)
    want = jmoe_qmatmul(jnp.asarray(x), js, jnp.asarray(idx), interpret=True,
                        precision="highest")
    got = gathered_model(torch.from_numpy(x), ts, torch.from_numpy(idx), 2)
    assert not bool(torch.isnan(got).any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("act", ["silu", "swiglu_oai"])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "one"])
@pytest.mark.parametrize("s", [32, 64, 257])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q2_K],
                         ids=lambda t: t.name)
def test_gathered_glu_model_matches_pallas(t, s, kind, act):
    """Kernel 6's tiles (gathered rows, the gate and the up stack, the GLU
    after the slice sum) against the JAX package's moe_qmatmul_glu in
    interpret mode; every slot's row is written."""
    e_num, k, f = 4, 256, 128
    js, ts = both_stacks(t, e_num, f, k, 64)
    ju, tu = both_stacks(t, e_num, f, k, 65)
    x = np.random.default_rng(66 + s).standard_normal((s, k)).astype(
        np.float32)
    idx = routing(kind, s, e_num)
    want = jmoe_qmatmul_glu(jnp.asarray(x), js, ju, jnp.asarray(idx), act,
                            interpret=True, precision="highest")
    assert want is not None
    got = gathered_model(torch.from_numpy(x), ts, torch.from_numpy(idx), 2,
                         tu, act)
    assert not bool(torch.isnan(got).any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("s", [1, 2, 3, 31])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0,
                               GGMLType.Q2_K, GGMLType.Q8_K],
                         ids=lambda t: t.name)
def test_slot_model_matches_pallas(t, s):
    """Kernel 4's split-K arithmetic, one slot per block row over its own
    expert (idx[s]) at the plan's split of K, against the JAX package's
    slot-major moe_qmatmul in interpret mode."""
    e_num, k, n = 8, 512, 128
    js, ts = both_stacks(t, e_num, n, k, 67)
    x = np.random.default_rng(68 + s).standard_normal((s, k)).astype(
        np.float32)
    idx = np.random.default_rng(69 + s).integers(0, e_num, s).astype(
        np.int32)
    want = jmoe_qmatmul(jnp.asarray(x), js, jnp.asarray(idx), interpret=True,
                        precision="highest")
    plan = Q.moe_slot_plan(s, e_num, k, n, ts.group, ts.fmt)
    assert plan.path == "splitk" and plan.grid[1] == s
    xt = torch.from_numpy(x)
    got = torch.cat([sliced_product(xt[r:r + 1],
                                    expert_linear(ts, int(idx[r])),
                                    plan.splits) for r in range(s)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# (S, E, K, N, group, fmt, splits, grid): Mixtral-8x7B's gate (and up) and
# down expert stacks at decode (top-2: 2 slots per token), and more slots
SLOT_PLANS = [(2, 8, 4096, 14336, 32, "q4", 4, (4, 2, 112)),
              (2, 8, 14336, 4096, 16, "q8", 16, (16, 2, 32)),
              (1, 8, 4096, 14336, 32, "q4", 9, (9, 1, 112)),
              (1, 8, 14336, 4096, 16, "q8", 32, (32, 1, 32)),
              (31, 8, 14336, 4096, 16, "q8", 1, (1, 31, 32)),
              (40, 64, 4096, 14336, 32, "q4", 1, (1, 40, 112))]


@pytest.mark.parametrize("s,e,k,n,group,fmt,splits,grid", SLOT_PLANS)
def test_slot_plan_at_main_path_shapes(s, e, k, n, group, fmt, splits, grid):
    """Kernel 4 on split-K: one slot per block row, K split into the most
    slices whose grid of S x column tiles x splits stays within one wave of
    BLOCKS_PER_SM["splitk"] blocks per SM (at most 32 slices, and slices of
    6 chunks of 16 packed rows at least); the workspace holds every tile's
    slices."""
    plan = Q.moe_slot_plan(s, e, k, n, group, fmt, SMS)
    assert (plan.path, plan.rows, plan.cols, plan.vec) == ("splitk", 1, 128,
                                                           True)
    assert (plan.splits, plan.grid) == (splits, grid)
    wave = Q.BLOCKS_PER_SM["splitk"] * SMS
    tiles = s * grid[2]
    assert tiles * splits <= wave or splits == 1
    assert tiles * (splits + 1) > wave or splits == Q.MAX_SPLITS
    assert plan.scratch_bytes == (4 * tiles * splits * 128
                                  if splits > 1 else 0)
    assert plan == Q.qmatmul_plan(s, k, n, group, fmt, SMS, path="splitk",
                                  splits=splits)
    assert plan.op_type() == "f32"


def test_slot_plan_layouts_and_refusals():
    """Every layout split-K takes: ragged N (byte loads), unaligned stacks,
    q8 groups 16 and 32; forced splits within 1..min(32, groups); refused:
    a grouped slot count, a q4 group of 8, K not a multiple of the group,
    too many splits, more slots than the grid holds."""
    assert not Q.moe_slot_plan(2, 8, 4096, 200, 16, "q8").vec
    assert not Q.moe_slot_plan(2, 8, 4096, 4096, 16, "q8",
                               aligned=False).vec
    assert Q.moe_slot_plan(3, 8, 1024, 256, 32, "q8", splits=32).splits == 32
    for args, kw in (((32, 8, 4096, 4096, 16, "q8"), {}),
                     ((2, 8, 4096, 4096, 8, "q4"), {}),
                     ((2, 8, 4100, 4096, 16, "q8"), {}),
                     ((2, 8, 512, 256, 32, "q4"), dict(splits=17)),
                     ((70000, 100000, 512, 256, 32, "q4"), {})):
        with pytest.raises(ValueError):
            Q.moe_slot_plan(*args, **kw)


# (S, K, F, group, fmt, rows, grid): Mixtral-8x7B's gate|up stacks (K 4096,
# F 14336, q4) over 8 experts; TinyLlama-like widths
GLU_GROUPED_PLANS = [(64, 4096, 14336, 32, "q4", 16, (1, 36, 224)),
                     (256, 4096, 14336, 32, "q4", 32, (1, 72, 224)),
                     (1024, 4096, 14336, 32, "q4", 32, (1, 96, 224)),
                     (256, 2048, 1024, 16, "q8", 32, (1, 72, 16))]


@pytest.mark.parametrize("s,k,f,group,fmt,rows,grid", GLU_GROUPED_PLANS)
def test_glu_grouped_plan_at_main_path_shapes(s, k, f, group, fmt, rows,
                                              grid):
    """Kernel 6 on the tensor cores: kernel 5's row tiles (but at most 32
    rows) and split rule, with 64 output (64 gate + 64 up weight) columns
    per block."""
    plan = Q.moe_glu_grouped_plan(s, 8, k, f, group, fmt, SMS)
    assert (plan.path, plan.rows, plan.grid) == ("tc", rows, grid)
    assert plan.glu and plan.cols == 128 and plan.out_cols == 64
    c_rows, g_blocks, _ = Q.moe_dims(s, 8)
    assert plan.grid[1] * plan.rows == g_blocks * c_rows
    assert plan.grid[2] == -(-f // 64)
    five = Q.moe_grouped_plan(s, 8, k, f, group, fmt, SMS)
    assert min(five.rows, 32) == plan.rows and five.grid[2] == -(-f // 128)
    assert plan.op_type("highest") == "bf16x3"
    assert plan.op_type("default") == "bf16x2"


def test_glu_grouped_plan_layout_rule():
    """Ragged F, unaligned stacks and q4 groups other than 32 keep the
    CUDA-core grouped GLU kernel (its own tile and grid, K unsplit);
    forcing the tensor cores on them raises, as do a slot count below the
    grouped rule and a tile taller than C."""
    for f, aligned, group, fmt in ((200, True, 16, "q8"),
                                   (4096, False, 16, "q8"),
                                   (4096, True, 64, "q4")):
        plan = Q.moe_glu_grouped_plan(256, 8, 4096, f, group, fmt,
                                      aligned=aligned)
        assert plan.path == "cuda cores" and plan.grid is None and plan.glu
        with pytest.raises(ValueError):
            Q.moe_glu_grouped_plan(256, 8, 4096, f, group, fmt,
                                   aligned=aligned, path="tc")
    with pytest.raises(ValueError):
        Q.moe_glu_grouped_plan(16, 8, 4096, 4096, 16, "q8")
    with pytest.raises(ValueError):
        Q.moe_glu_grouped_plan(32, 4, 4096, 4096, 16, "q8", tile_rows=64)
    forced = Q.moe_glu_grouped_plan(256, 8, 4096, 4096, 32, "q4",
                                    tile_rows=16, splits=4)
    assert (forced.rows, forced.splits) == (16, 4)


@pytest.mark.parametrize("s", [32, 257])
def test_moe_grouped_blocked_is_card_only(s):
    """The blocked entry launches kernel 5 or raises: on the CPU it raises,
    and moe_qmatmul, which plans and reads back, runs the plain version."""
    e_num = 4
    _, ts = both_stacks(GGMLType.Q4_K, e_num, 128, 256, 62)
    x = torch.from_numpy(np.random.default_rng(63).standard_normal(
        (s, 256)).astype(np.float32))
    idx = torch.from_numpy(routing("skewed", s, e_num))
    c_rows, g_blocks, _ = Q.moe_dims(s, e_num)
    eg, rows, _ = Q.moe_group_plan(idx, e_num, c_rows, g_blocks)
    before = Q.LAUNCHES["moe_grouped"]
    with pytest.raises(RuntimeError):
        Q.moe_grouped_blocked(x, ts, eg, rows)
    assert torch.equal(Q.moe_qmatmul(x, ts, idx),
                       Q.moe_qmatmul_plain(x, ts, idx))
    assert Q.LAUNCHES["moe_grouped"] == before


# -- the ctypes bindings against the sources' C interfaces --------------------


def _c_params(source: str, fn: str) -> list[str]:
    """The parameter types of ``extern "C" int fn(...)`` in csrc/<source>.cu:
    "ptr" for a pointer, else the type's last word."""
    import pathlib
    import re

    import llama_gguf_tpu_torch

    text = (pathlib.Path(llama_gguf_tpu_torch.__file__).parent / "csrc"
            / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, f"{fn} not declared in csrc/{source}.cu"
    return ["ptr" if "*" in p else p.split()[-2] for p in
            (" ".join(a.split()) for a in m.group(1).split(","))]


def _bindings():
    from llama_gguf_tpu_torch.ops import qmatmul_variants as QV

    out = [(src, fn, args) for src, fns in Q.SIGNATURES.items()
           for fn, args in fns.items()]
    return out + [("qmatmul_variants", fn, args)
                  for fn, args in QV.SIGNATURES.items()]


@pytest.mark.parametrize("source,fn,argtypes", _bindings(),
                         ids=[b[1] for b in _bindings()])
def test_ctypes_bindings_match_the_c_interfaces(source, fn, argtypes):
    """Each launch function's ctypes argtypes (bound at first use on the
    card, where a wrong count or order would pass garbage silently) agree
    with its C declaration: a pointer for each pointer, an int for each
    int."""
    import ctypes

    want = ["ptr" if a is ctypes.c_void_p else "int" for a in argtypes]
    assert _c_params(source, fn) == want
