"""The port's dequant-matmul variant probe (kernel 7) on the CPU.

The JAX script's kernel bodies (scripts/bench_kernel_variants.py) are closures
inside its main() and use TPU memory spaces, so no test can call them. Each
is restated here in jax.numpy at one K tile (tk = K), citing the script's
lines, and each plain version of llama_gguf_tpu_torch/ops/qmatmul_variants.py
(what its wrapper runs for a CPU tensor) is held against that restatement on
the probe's own inputs at B = 8, K = 256, N = 384. The q4 restatements read x
through the script's _arrange_x_q4, which pairs each nibble with the element
the port's group-split layout pairs it with. The CUDA kernels are held
against the plain versions on a card by tests/test_torch_kernels.py and
chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_gguf_tpu.ops.qmatmul import _arrange_x_q4, _repeat_rows

from llama_gguf_tpu_torch.ops import qmatmul_variants as V
from llama_gguf_tpu_torch.ops.linear import QuantLinear
from llama_gguf_tpu_torch.scripts import bench_kernel_variants as P

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, K, N, G = 8, 256, 384, 32
HI = jax.lax.Precision.HIGHEST
DIMS = (((1,), (0,)), ((), ()))
# f32 sums of the same products in another order, relative to max |y|
F32_TOL = 1e-5


def inputs(fmt):
    """The probe's inputs (its generator, its order) as port tensors and as
    JAX arrays."""
    inp = P.make_inputs(fmt, K, N, np.random.default_rng(0), "cpu")
    lin = inp["lin_full"]
    j = dict(x=jnp.asarray(inp["x"].numpy()),
             xi=jnp.asarray(inp["xi8"].numpy()),
             p=jnp.asarray(lin.packed.numpy()),
             s=jnp.asarray(lin.scales.float().numpy()).astype(jnp.bfloat16),
             m=jnp.asarray(lin.mins.float().numpy()).astype(jnp.bfloat16))
    j["xg"] = j["x"].reshape(B, K // G, G).sum(-1).T  # group_sums, :279-280
    return inp, lin, j


def close(got, want, exact=False):
    got, want = got.numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape == (B, N)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=F32_TOL * np.abs(want).max())


def unpack(p):  # unpack_q4 of the script, :151-153
    w32 = p.astype(jnp.int32)
    return w32 & 0x0F, w32 >> 4


# -- the script's bodies at tk = K --------------------------------------------


def j_v2(x, p):  # :282-289
    return jnp.dot(x, p.astype(jnp.float32), precision=HI)


def j_v5(fmt, x, xg, p, s, m):  # :159-188
    mins = jax.lax.dot_general(xg, m.astype(jnp.float32),
                               (((0,), (0,)), ((), ())), precision=HI)
    if fmt == "q8":
        w = p.astype(jnp.float32) * _repeat_rows(s.astype(jnp.float32), G)
        return jnp.dot(x, w, precision=HI) - mins
    lo, hi = unpack(p)
    srep = _repeat_rows(s.astype(jnp.float32), G // 2)
    xa = _arrange_x_q4(x, G, K)
    return (jnp.dot(xa[:, :K // 2], lo.astype(jnp.float32) * srep,
                    precision=HI)
            + jnp.dot(xa[:, K // 2:], hi.astype(jnp.float32) * srep,
                      precision=HI) - mins)


def j_v6(fmt, x, xg, p, s, m):  # :190-218
    mins = jax.lax.dot_general(xg.astype(jnp.bfloat16), m,
                               (((0,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)
    if fmt == "q8":
        w = p.astype(jnp.bfloat16) * _repeat_rows(s, G)
        return jnp.dot(x.astype(jnp.bfloat16), w,
                       preferred_element_type=jnp.float32) - mins
    lo, hi = unpack(p)
    srep = _repeat_rows(s, G // 2)
    xb = _arrange_x_q4(x, G, K).astype(jnp.bfloat16)
    return (jnp.dot(xb[:, :K // 2], lo.astype(jnp.bfloat16) * srep,
                    preferred_element_type=jnp.float32)
            + jnp.dot(xb[:, K // 2:], hi.astype(jnp.bfloat16) * srep,
                      preferred_element_type=jnp.float32) - mins)


def idot(a, b):
    return jax.lax.dot_general(a, b, DIMS, preferred_element_type=jnp.int32)


def j_v7(fmt, xi, p):  # :230-247
    if fmt == "q8":
        return idot(xi, p)
    lo, hi = unpack(p)
    xa = _arrange_x_q4(xi, G, K)
    return (idot(xa[:, :K // 2], lo.astype(jnp.int8))
            + idot(xa[:, K // 2:], hi.astype(jnp.int8)))


def j_v9(xi, p, u):  # :397-410
    w32 = p.astype(jnp.int32)
    urep = _repeat_rows(u.astype(jnp.int32), G // 2)
    lo8 = ((w32 & 0x0F) * urep).astype(jnp.int8)
    hi8 = ((w32 >> 4) * urep).astype(jnp.int8)
    xa = _arrange_x_q4(xi, G, K)
    return idot(xa[:, :K // 2], lo8) + idot(xa[:, K // 2:], hi8)


def j_v10(xi, p):  # :412-427
    lo, hi = unpack(p)
    lo, hi = lo.astype(jnp.int8), hi.astype(jnp.int8)
    xa = _arrange_x_q4(xi, G, K)
    return (idot(xa[:, :K // 2], lo) + idot(xa[:, K // 2:], hi)
            + idot(xa[:, :K // 2], hi) + idot(xa[:, K // 2:], lo))


def j_v8(x, p, s, m):  # panels :325-332, kernel :334-367, v8_one :378-385
    sf32 = np.asarray(s, dtype=np.float32)
    s_col = np.maximum(np.abs(sf32).max(axis=0), 1e-12) / 127.0
    u = jnp.asarray(np.round(sf32 / s_col).astype(np.int8))
    m2 = jnp.asarray((np.asarray(m, np.float32) / s_col).astype(np.float32)
                     ).astype(jnp.bfloat16)
    s8 = jnp.asarray(np.broadcast_to(s_col, (8, N)).astype(np.float32))
    t = jnp.maximum(jnp.max(jnp.abs(x), axis=1) / 127.0, 1e-12)
    xi = jnp.round(x / t[:, None]).astype(jnp.int8)
    xg2 = x.reshape(B, K // G, G).sum(-1).T / t[None, :]
    w32 = p.astype(jnp.int32)
    urep = _repeat_rows(u.astype(jnp.int32), G // 2)
    pl_lo, pl_hi = (w32 & 0x0F) * urep, (w32 >> 4) * urep
    xa = _arrange_x_q4(xi, G, K)
    da = idot(xa[:, :K // 2], (pl_lo & 127).astype(jnp.int8))
    da += idot(xa[:, K // 2:], (pl_hi & 127).astype(jnp.int8))
    db = idot(xa[:, :K // 2], (pl_lo >> 7).astype(jnp.int8))
    db += idot(xa[:, K // 2:], (pl_hi >> 7).astype(jnp.int8))
    acc = da.astype(jnp.float32) + db.astype(jnp.float32) * 128.0
    acc -= jax.lax.dot_general(xg2, m2.astype(jnp.float32),
                               (((0,), (0,)), ((), ())), precision=HI)
    return (acc * s8) * t[:, None]


# -- the port's plain versions against them -----------------------------------


def test_v2_noscale_matches_the_script():
    inp, lin, j = inputs("q8")
    close(V.v2_noscale(inp["x"], lin), j_v2(j["x"], j["p"]))


@pytest.mark.parametrize("fmt", ["q4", "q8"])
def test_v5_minfold_matches_the_script(fmt):
    inp, lin, j = inputs(fmt)
    got = V.v5_minfold(inp["x"], V.group_sums(inp["x"], G), lin)
    close(got, j_v5(fmt, j["x"], j["xg"], j["p"], j["s"], j["m"]))


@pytest.mark.parametrize("fmt", ["q4", "q8"])
def test_v6_bf16_matches_the_script(fmt):
    """w = bf16(q * s), x and xg rounded to bf16, products summed in f32."""
    inp, lin, j = inputs(fmt)
    got = V.v6_bf16(inp["x"], V.group_sums(inp["x"], G), lin)
    close(got, j_v6(fmt, j["x"], j["xg"], j["p"], j["s"], j["m"]))


@pytest.mark.parametrize("fmt", ["q4", "q8"])
def test_v7_int8_matches_the_script(fmt):
    inp, lin, j = inputs(fmt)
    close(V.v7_int8(inp["xi8"], lin), j_v7(fmt, j["xi"], j["p"]), exact=True)


def test_v9_mulcost_matches_the_script():
    """q * u wraps to int8, as the script's astype(int8) does."""
    inp, lin, j = inputs("q4")
    _, u, _ = P.w4a8_panels(lin)
    want = j_v9(j["xi"], j["p"], jnp.asarray(u.numpy()))
    close(V.v9_mulcost(inp["xi8"], lin, u), want, exact=True)
    q = V.weight_ints(lin) * V.repeat_rows(u.to(torch.int32), G)
    assert (q.abs() > 127).any()  # the wrap is exercised


def test_v10_4dot_matches_the_script():
    inp, lin, j = inputs("q4")
    close(V.v10_4dot(inp["xi8"], lin), j_v10(j["xi"], j["p"]), exact=True)


def test_v8_w4a8_matches_the_script():
    """The whole chain: the panels' scale codes, x quantized per row, the
    kernel's part and the row factor t."""
    inp, lin, j = inputs("q4")
    v8 = P.build_variants(inp)["v8_w4a8"]
    close(v8.run(), j_v8(j["x"], j["p"], j["s"], j["m"]))
    close(v8.call(), v8.plain(), exact=True)


def test_v8_library_yardstick_computes_the_same_product():
    """v8's library call (one f32 product over [xq | xg2^T]) computes the
    function its kernel and plain version do."""
    v8 = P.build_variants(inputs("q4")[0])["v8_w4a8"]
    want = v8.plain()
    got = v8.library()
    assert got.shape == want.shape
    assert ((got - want).abs().max() / want.abs().max()).item() < F32_TOL


def test_w4a8_panels_and_row_quantization_match_the_script():
    inp, lin, j = inputs("q4")
    s_col, u, m2 = P.w4a8_panels(lin)
    sf32 = np.asarray(j["s"], np.float32)
    want_s = np.maximum(np.abs(sf32).max(axis=0), 1e-12) / 127.0
    np.testing.assert_array_equal(s_col.numpy(), want_s)
    np.testing.assert_array_equal(u.numpy(),
                                  np.round(sf32 / want_s).astype(np.int8))
    want_m2 = (np.asarray(j["m"], np.float32) / want_s).astype(np.float32)
    np.testing.assert_array_equal(
        m2.float().numpy(),
        np.asarray(jnp.asarray(want_m2).astype(jnp.bfloat16), np.float32))
    t, xi, xg2 = P.quantize_rows(inp["x"])
    jt = jnp.maximum(jnp.max(jnp.abs(j["x"]), axis=1) / 127.0, 1e-12)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(
        xi.numpy(), np.asarray(jnp.round(j["x"] / jt[:, None])
                               .astype(jnp.int8)))
    want_xg2 = np.asarray(j["xg"] / jt[None, :])
    np.testing.assert_allclose(xg2.numpy(), want_xg2, rtol=0,
                               atol=F32_TOL * np.abs(want_xg2).max())


def test_group_sums_and_repeat_rows_match_the_script():
    inp, _, j = inputs("q8")
    np.testing.assert_allclose(V.group_sums(inp["x"], G).numpy(),
                               np.asarray(j["xg"]), rtol=0, atol=F32_TOL)
    s = np.random.default_rng(3).standard_normal((5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        V.repeat_rows(torch.from_numpy(s), 4).numpy(),
        np.asarray(_repeat_rows(jnp.asarray(s), 4)))


def test_inputs_are_the_scripts_draws():
    """make_inputs draws the script's arrays from its generator, in its
    order: packed, scales, mins, x, then xi8."""
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 255, size=(K // 2, N), dtype=np.uint8)
    scales = (rng.normal(size=(K // G, N)) * 0.01).astype(np.float32)
    mins = np.abs(rng.normal(size=(K // G, N)) * 0.01).astype(np.float32)
    x = rng.normal(size=(B, K)).astype(np.float32)
    xi8 = rng.integers(-127, 127, size=(B, K), dtype=np.int8)
    inp, lin, _ = inputs("q4")
    np.testing.assert_array_equal(lin.packed.numpy(), packed)
    np.testing.assert_array_equal(
        lin.scales.float().numpy(),
        np.asarray(jnp.asarray(scales).astype(jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(
        lin.mins.float().numpy(),
        np.asarray(jnp.asarray(mins).astype(jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(inp["x"].numpy(), x)
    np.testing.assert_array_equal(inp["xi8"].numpy(), xi8)


@pytest.mark.parametrize("fmt", ["q4", "q8"])
def test_probe_main_runs_on_the_cpu(fmt, capsys):
    """The probe's entry point at a tiny shape: its gates pass, every
    variant of the format is reported, and no time is claimed."""
    out = P.main([fmt, str(K), str(N), "--device", "cpu"])
    text = capsys.readouterr().out
    tags = ({"v0_full", "v1_nomin", "v5_minfold", "v6_bf16", "v7_int8",
             "floor"} | ({"v8_w4a8", "v9_mulcost", "v10_4dot"}
                         if fmt == "q4" else {"v2_noscale"}))
    assert set(out[f"{fmt} {K}x{N}"]) == tags
    for tag in tags:
        assert f"  {tag:<11} not measured (no card)" in text
    assert "v5_minfold rel-err vs v0" in text
    assert all(m["ms"] is None for m in out[f"{fmt} {K}x{N}"].values())


def test_probe_module_runs_and_refuses_a_missing_card():
    cmd = [sys.executable, "-m",
           "llama_gguf_tpu_torch.scripts.bench_kernel_variants", "q4", "256",
           "128"]
    res = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert "v8_w4a8 rel-err vs v0" in res.stdout
    if not torch.cuda.is_available():
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=240)
        assert res.returncode != 0
        assert "CUDA is not available" in res.stderr


def test_cpu_variants_do_not_count_launches():
    inp, lin, _ = inputs("q4")
    V.reset_launches()
    for v in P.build_variants(inp).values():
        v.run()
    assert set(V.LAUNCHES.values()) == {0}


def test_variant_wrappers_refuse_other_devices():
    lin = QuantLinear(torch.zeros(16, 8, dtype=torch.uint8),
                      torch.zeros(1, 8, dtype=torch.bfloat16), None, None,
                      "q4", 32, 32, 8)
    with pytest.raises(RuntimeError, match="no kernel"):
        V.v7_int8(torch.zeros(1, 32, dtype=torch.int8, device="meta"), lin)
    with pytest.raises(RuntimeError, match="no kernel"):
        V.v5_minfold(torch.zeros(1, 32, device="meta"), None, lin)


@pytest.mark.parametrize("fmt", ["q4", "q8"])
@pytest.mark.parametrize("k, n", P.SHAPES)
def test_variant_plan_fills_the_card_at_the_probe_shapes(fmt, k, n):
    """Both probe shapes launch at least 2 blocks per SM of the H100, and
    the workspace holds every block's partial tile."""
    plan = V.variant_plan(P.B, k, n, P.GROUP, fmt)
    blocks = plan.splits * plan.tiles
    assert blocks >= 2 * V.H100_SMS
    assert plan.path == "tc" and plan.grid == (plan.splits, 1,
                                                n // V.TILE_COLS)
    assert -(-k // plan.splits) <= V.SLICE_MAX_K
    assert plan.scratch_bytes == 4 * blocks * V.TILE_ROWS * V.TILE_COLS


@pytest.mark.parametrize("group", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("fmt", ["q4", "q8"])
@pytest.mark.parametrize("b, k, n", [(1, 1024, 256), (8, 4096, 14336),
                                     (8, 14336, 4096), (17, 2048, 200),
                                     (3, 256, 8192)])
def test_variant_plan_slices_hold_whole_groups(group, fmt, b, k, n):
    """The kernels' cut of K (slice i: units [i * units // splits, (i + 1)
    * units // splits)) gives every block whole groups and whole stages, no
    slice longer than the staged x holds; a ragged N takes byte copies."""
    plan = V.variant_plan(b, k, n, group, fmt)
    unit_k = max(group, V.STAGE_K)
    units = k // unit_k
    bounds = [i * units // plan.splits * unit_k
              for i in range(plan.splits + 1)]
    lengths = np.diff(bounds)
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(s > 0 and s % group == 0 and s % V.STAGE_K == 0
               for s in lengths)
    assert lengths.max() <= V.SLICE_MAX_K
    assert plan.grid == (plan.splits, -(-b // 8), -(-n // 128))
    assert plan.vec == (n % 16 == 0)
    assert plan.scratch_bytes == (0 if plan.splits == 1 else
                                  4 * plan.splits * plan.tiles * 8 * 128)
    assert not V.variant_plan(b, k, n, group, fmt, aligned=False).vec


@pytest.mark.parametrize("fmt, k, group", [("q4", 512, 48), ("q8", 480, 16),
                                           ("q8", 4096, 2048),
                                           ("q5", 512, 32)])
def test_variant_plan_refuses_layouts_the_kernels_do_not_take(fmt, k, group):
    with pytest.raises(ValueError, match="unsupported layout"):
        V.variant_plan(8, k, 256, group, fmt)


@pytest.mark.parametrize("fmt, k, group", [
    ("q4", 512, 48), ("q8", 480, 16), ("q8", 4096, 2048), ("q4", 96, 32),
    ("q4", 512, 16), ("q4", 1024, 1024), ("q8", 256, 256), ("q8", 64, 32)])
def test_weight_check_and_plan_agree_on_the_layout(fmt, k, group):
    """The wrappers' weight check and the plan take the same layouts (one
    function, ``check_layout``, decides)."""
    n = 16
    shape = (k // 2, n) if fmt == "q4" else (k, n)
    lin = QuantLinear(torch.zeros(shape, dtype=torch.uint8 if fmt == "q4"
                                  else torch.int8),
                      torch.zeros(k // group, n, dtype=torch.bfloat16), None,
                      None, fmt, group, k, n, "probe")
    try:
        V.variant_plan(8, k, n, group, fmt)
        planned = True
    except ValueError:
        planned = False
    try:
        V._check_weight(lin, torch.device("cpu"), True, "w")
        checked = True
    except ValueError as e:
        assert "unsupported layout" in str(e)
        checked = False
    assert planned == checked


def test_probe_reckons_v2_and_v5_on_the_tensor_cores():
    """v2 and v5 run three bf16 passes, so their bound is "bf16x3" (kernels
    1-2's tensor-core path); v6 one bf16 pass; the integer variants int8."""
    for fmt in ("q4", "q8"):
        variants = P.build_variants(inputs(fmt)[0])
        want = {"v2_noscale": "bf16x3", "v5_minfold": "bf16x3",
                "v6_bf16": "bf16", "v7_int8": "int8", "v8_w4a8": "int8",
                "v9_mulcost": "int8", "v10_4dot": "int8"}
        for tag, v in variants.items():
            if tag in want:
                assert v.op_type == want[tag], (fmt, tag)
