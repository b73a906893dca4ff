"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.ops import qmatmul_variants as V
from llama_gguf_tpu_torch.ops.linear import QuantExpertStack, QuantLinear
from llama_gguf_tpu_torch.quant.quantize import quantize
from llama_gguf_tpu_torch.quant.repack import repack

# f32 against f32 with another order of summation, relative to max |y|
REL_LIMIT = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make_lin(t, n, k, seed, dev, splits=None):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.1
    rw = repack(quantize(w, t), t, (n, k))
    return QuantLinear(
        torch.from_numpy(rw.packed).to(dev),
        torch.from_numpy(rw.scales).to(dev),
        torch.from_numpy(rw.mins).to(dev) if rw.mins is not None else None,
        None, rw.fmt, rw.group, k, n, t.name, splits=splits)


def make_x(b, k, seed, dev):
    x = np.random.default_rng(seed + 1).standard_normal((b, k))
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def within_bf16(got, want):
    """bf16 outputs of the same f32 sums taken in another order: at most one
    bf16 ulp apart, plus the f32 limit (REL_LIMIT * max |want|)."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    limit = Q.bf16_ulp(w) + REL_LIMIT * w.abs().max()
    return bool(((g - w).abs() <= limit).all())


def to_bf16_panels(lin):
    """The same weight with its scale and min panels rounded to bf16 (as
    ModelLoader(scale_dtype="bfloat16") stores them)."""
    return QuantLinear(lin.packed, lin.scales.to(torch.bfloat16),
                       lin.mins.to(torch.bfloat16)
                       if lin.mins is not None else None, None, lin.fmt,
                       lin.group, lin.k, lin.n, lin.source_type,
                       splits=lin.splits)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 3, 8, 37])
@pytest.mark.parametrize("t,n", [(GGMLType.Q4_K, 256), (GGMLType.Q6_K, 200),
                                 (GGMLType.Q8_0, 131), (GGMLType.Q5_1, 64)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_kernel_matches_plain(cuda, t, n, b):
    """Ragged N (200, 131: byte loads, masked columns) and rows included."""
    lin = make_lin(t, n, 512, 1, cuda)
    x = make_x(b, 512, 1, cuda)
    key = "qmatmul_q4" if lin.fmt == "q4" else "qmatmul_q8"
    before = Q.LAUNCHES[key]
    got = Q.qmatmul(x, lin)
    want = Q.qmatmul_plain(x, lin)
    torch.cuda.synchronize()
    assert Q.LAUNCHES[key] == before + 1
    assert got.shape == (b, n)
    assert rel_err(got, want) < REL_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("act", Q.GLU_ACTS)
@pytest.mark.parametrize("t,f", [(GGMLType.Q4_K, 256), (GGMLType.Q6_K, 96),
                                 (GGMLType.Q8_0, 66)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_glu_kernel_matches_plain(cuda, t, f, act):
    lin = make_lin(t, 2 * f, 512, 2, cuda, splits=(f, f))
    x = make_x(5, 512, 2, cuda)
    before = Q.LAUNCHES["qmatmul_glu"]
    got = Q.qmatmul_glu(x, lin, act)
    want = Q.qmatmul_glu_plain(x, lin, act)
    torch.cuda.synchronize()
    assert Q.LAUNCHES["qmatmul_glu"] == before + 1
    assert rel_err(got, want) < REL_LIMIT


def make_stack(t, e, n, k, seed, dev):
    """An expert stack [E, K, N] of format t, repacked expert by expert."""
    rng = np.random.default_rng(seed)
    rws = [repack(quantize(rng.standard_normal((n, k)).astype(np.float32)
                           * 0.1, t), t, (n, k)) for _ in range(e)]

    def put(key):
        if getattr(rws[0], key) is None:
            return None
        return torch.from_numpy(np.stack([getattr(r, key) for r in rws])).to(dev)

    return QuantExpertStack(put("packed"), put("scales"), put("mins"),
                            rws[0].fmt, rws[0].group, k, n)


def make_idx(s, e, seed, dev):
    """Imbalanced routing: expert 2 takes every other slot, expert 1 none."""
    rng = np.random.default_rng(seed)
    idx = np.where(np.arange(s) % 2 == 0, 2, rng.integers(0, e, size=s))
    idx[idx == 1] = 3
    return torch.from_numpy(idx.astype(np.int32)).to(dev)


# q4 with mins, q8 with mins, q8 without mins; ragged N (200: masked last
# tile; 131: byte loads)
MOE_FORMATS = [(GGMLType.Q4_K, 256), (GGMLType.Q5_1, 200),
               (GGMLType.Q6_K, 131)]


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 45, 256])
@pytest.mark.parametrize("t,n", MOE_FORMATS,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_moe_kernel_matches_plain(cuda, t, n, s):
    """Slot-major below 32 slots, grouped above (a zero-slot expert, S not a
    multiple of C at 45)."""
    stack = make_stack(t, 4, n, 512, 4, cuda)
    x, idx = make_x(s, 512, 4, cuda), make_idx(s, 4, 4, cuda)
    key = "moe_grouped" if s >= Q.MOE_GROUPED_MIN_SLOTS else "moe_slot"
    before = Q.LAUNCHES[key]
    got = Q.moe_qmatmul(x, stack, idx)
    want = Q.moe_qmatmul_plain(x, stack, idx)
    torch.cuda.synchronize()
    assert Q.LAUNCHES[key] == before + 1
    assert got.shape == (s, n)
    assert rel_err(got, want) < REL_LIMIT


@pytest.mark.cuda
def test_moe_slot_kernel_one_expert(cuda):
    stack = make_stack(GGMLType.Q4_K, 8, 256, 512, 5, cuda)
    x = make_x(2, 512, 5, cuda)
    idx = torch.tensor([6, 6], dtype=torch.int32, device=cuda)
    assert rel_err(Q.moe_qmatmul(x, stack, idx),
                   Q.moe_qmatmul_plain(x, stack, idx)) < REL_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "gelu", "swiglu_oai"])
@pytest.mark.parametrize("s", [45, 256])
@pytest.mark.parametrize("t,f", MOE_FORMATS,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_moe_glu_kernel_matches_plain(cuda, t, f, s, act):
    gate = make_stack(t, 4, f, 512, 6, cuda)
    up = make_stack(t, 4, f, 512, 7, cuda)
    x, idx = make_x(s, 512, 6, cuda), make_idx(s, 4, 6, cuda)
    before = Q.LAUNCHES["moe_glu_grouped"]
    got = Q.moe_qmatmul_glu(x, gate, up, idx, act)
    want = Q.moe_qmatmul_glu_plain(x, gate, up, idx, act)
    torch.cuda.synchronize()
    assert Q.LAUNCHES["moe_glu_grouped"] == before + 1
    assert got.shape == (s, f)
    assert rel_err(got, want) < REL_LIMIT


@pytest.mark.cuda
def test_moe_glu_declines_decode_sizes(cuda):
    gate = make_stack(GGMLType.Q4_K, 4, 128, 256, 8, cuda)
    x, idx = make_x(2, 256, 8, cuda), make_idx(2, 4, 8, cuda)
    assert Q.moe_qmatmul_glu(x, gate, gate, idx, "silu") is None


@pytest.mark.cuda
@pytest.mark.parametrize("s", [32, 45, 256, 300])
def test_moe_group_plan_on_card_matches_cpu(cuda, s):
    idx = make_idx(s, 8, 9, "cpu")
    c_rows, g_blocks, _ = Q.moe_dims(s, 8)
    want = Q.moe_group_plan(idx, 8, c_rows, g_blocks)
    got = Q.moe_group_plan(idx.to(cuda), 8, c_rows, g_blocks)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_kernel_refuses_bf16_scales(cuda):
    """The MoE kernels are built for f32 panels only (the loader keeps expert
    stacks in f32); a QuantLinear's panels must agree in type."""
    stack = make_stack(GGMLType.Q4_K, 4, 128, 256, 3, cuda)
    stack.scales = stack.scales.to(torch.bfloat16)
    stack.mins = stack.mins.to(torch.bfloat16)
    x, idx = make_x(2, 256, 3, cuda), make_idx(2, 4, 3, cuda)
    with pytest.raises(ValueError, match="float32 scale panels only"):
        Q.moe_qmatmul(x, stack, idx)
    lin = make_lin(GGMLType.Q4_K, 128, 256, 3, cuda)
    lin.scales = lin.scales.to(torch.bfloat16)
    with pytest.raises(ValueError, match="both be float32 or both"):
        Q.qmatmul(make_x(1, 256, 3, cuda), lin)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("panels", ["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 3, 8, 37])
@pytest.mark.parametrize("t,n", [(GGMLType.Q4_K, 256), (GGMLType.Q6_K, 200),
                                 (GGMLType.Q8_0, 131)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_kernel_panel_and_output_types(cuda, t, n, b, panels, precision):
    """Every instantiated panel x output type of the q4/q8 kernels (ragged N:
    byte loads and masked columns)."""
    lin = make_lin(t, n, 512, 11, cuda)
    if panels == "bf16":
        lin = to_bf16_panels(lin)
    x = make_x(b, 512, 11, cuda)
    got = Q.qmatmul(x, lin, precision)
    want = Q.qmatmul_plain(x, lin, precision)
    torch.cuda.synchronize()
    assert got.shape == (b, n) and got.dtype == Q.out_dtype(precision)
    if precision == "default":
        assert within_bf16(got, want)
    else:
        assert rel_err(got, want) < REL_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("panels", ["f32", "bf16"])
@pytest.mark.parametrize("t,f", [(GGMLType.Q4_K, 256), (GGMLType.Q6_K, 96)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_glu_kernel_panel_and_output_types(cuda, t, f, panels, precision):
    lin = make_lin(t, 2 * f, 512, 12, cuda, splits=(f, f))
    if panels == "bf16":
        lin = to_bf16_panels(lin)
    x = make_x(5, 512, 12, cuda)
    got = Q.qmatmul_glu(x, lin, "silu", precision)
    want = Q.qmatmul_glu_plain(x, lin, "silu", precision)
    torch.cuda.synchronize()
    assert got.dtype == Q.out_dtype(precision)
    if precision == "default":
        assert within_bf16(got, want)
    else:
        assert rel_err(got, want) < REL_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 45])
@pytest.mark.parametrize("t,n", MOE_FORMATS,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_moe_kernels_default_precision(cuda, t, n, s):
    """Kernels 4-6 with bf16 outputs: slot-major at 2 slots, grouped and
    grouped GLU at 45."""
    stack = make_stack(t, 4, n, 512, 13, cuda)
    up = make_stack(t, 4, n, 512, 14, cuda)
    x, idx = make_x(s, 512, 13, cuda), make_idx(s, 4, 13, cuda)
    got = Q.moe_qmatmul(x, stack, idx, "default")
    want = Q.moe_qmatmul_plain(x, stack, idx, "default")
    assert got.shape == (s, n) and within_bf16(got, want)
    glu = Q.moe_qmatmul_glu(x, stack, up, idx, "silu", "default")
    if s >= Q.MOE_GROUPED_MIN_SLOTS:
        want = Q.moe_qmatmul_glu_plain(x, stack, up, idx, "silu", "default")
        assert within_bf16(glu, want)
    else:
        assert glu is None


def make_probe_weight(fmt, k, n, seed, dev, mins=True, group=32):
    """A QuantLinear with random packed bytes and bf16 panels, as the probe
    draws them."""
    rng = np.random.default_rng(seed)
    if fmt == "q8":
        packed = rng.integers(-127, 127, size=(k, n), dtype=np.int8)
    else:
        packed = rng.integers(0, 255, size=(k // 2, n), dtype=np.uint8)
    s = (rng.normal(size=(k // group, n)) * 0.01).astype(np.float32)
    m = np.abs(rng.normal(size=(k // group, n)) * 0.01).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(dev)
    return QuantLinear(put(packed), put(s).to(torch.bfloat16),
                       put(m).to(torch.bfloat16) if mins else None, None,
                       fmt, group, k, n, "probe")


@pytest.mark.cuda
@pytest.mark.parametrize("group", [16, 32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("b", [1, 3, 8, 9, 17])
@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("fmt", ["q4", "q8"])
def test_variant_kernels_match_plain(cuda, fmt, n, b, group):
    """Every variant kernel against its plain version: the integer variants
    exactly, the float ones to f32 summation order; one row tile and
    several (b 9, 17), ragged N (200: byte copies, not cp.async), every
    group the kernels take (16-64: several groups a stage; 128 and up: a
    group over several stages, 256 the Q8_K layout), K cut into several
    slices (at least 4 groups); a second call gives the same bits."""
    from llama_gguf_tpu_torch.scripts.bench_kernel_variants import (
        quantize_rows, w4a8_panels)

    k = max(1024, 4 * group)
    assert V.variant_plan(b, k, n, group, fmt).splits > 1
    lin = make_probe_weight(fmt, k, n, 15, cuda, group=group)
    x = make_x(b, k, 15, cuda)
    xi = torch.from_numpy(np.random.default_rng(16).integers(
        -127, 127, size=(b, k), dtype=np.int8)).to(cuda)
    xg = V.group_sums(x, group)
    V.reset_launches()
    cases = {  # name: (kernel, plain, exact)
        "v5": (lambda: V.v5_minfold(x, xg, lin),
               lambda: V.v5_minfold_plain(x, xg, lin), False),
        "v6": (lambda: V.v6_bf16(x, xg, lin),
               lambda: V.v6_bf16_plain(x, xg, lin), False),
        "v7": (lambda: V.v7_int8(xi, lin),
               lambda: V.v7_int8_plain(xi, lin), True),
    }
    if fmt == "q8":
        cases["v2"] = (lambda: V.v2_noscale(x, lin),
                       lambda: V.v2_noscale_plain(x, lin), False)
    else:
        s_col, u, m2 = w4a8_panels(lin)
        _, xq, xg2 = quantize_rows(x, group)
        cases["v8"] = (lambda: V.v8_w4a8(xq, xg2, lin, u, m2, s_col),
                       lambda: V.v8_w4a8_plain(xq, xg2, lin, u, m2, s_col),
                       False)
        cases["v9"] = (lambda: V.v9_mulcost(xi, lin, u),
                       lambda: V.v9_mulcost_plain(xi, lin, u), True)
        cases["v10"] = (lambda: V.v10_4dot(xi, lin),
                        lambda: V.v10_4dot_plain(xi, lin), True)
    for name, (kern, plain, exact) in cases.items():
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        assert got.shape == (b, n) and got.dtype == torch.float32, name
        assert torch.equal(got, again), name
        if exact:
            assert torch.equal(got, want), name
        else:
            assert rel_err(got, want) < REL_LIMIT, name
    launched = {"q4": {"variant_f32": 1, "variant_bf16": 1,
                       "variant_int8": 3, "variant_w4a8": 1},
                "q8": {"variant_f32": 2, "variant_bf16": 1,
                       "variant_int8": 1, "variant_w4a8": 0}}[fmt]
    assert V.LAUNCHES == {kern: 2 * c for kern, c in launched.items()}


@pytest.mark.cuda
def test_variant_int_kernels_exact_at_extremes(cuda):
    """v7, v9 and v10 at K = 14336 with every nibble 15 and xi = +-127: the
    sums pass 2^24 (v7: 127 * 15 * 14336), so only an exact integer sum,
    converted once, equals the plain version."""
    k, n = 14336, 256
    lin = make_probe_weight("q4", k, n, 18, cuda)
    lin = QuantLinear(torch.full_like(lin.packed, 0xFF), lin.scales,
                      lin.mins, None, "q4", 32, k, n, "probe")
    sign = torch.tensor([1, -1, 1, 1, -1, 1, -1, -1, 1], dtype=torch.int8)
    xi = (127 * sign[:, None]).expand(-1, k).contiguous().to(cuda)
    xi[2, ::3] = -127  # a row of mixed signs
    u = torch.from_numpy(np.random.default_rng(19).integers(
        -127, 127, size=(k // 32, n), dtype=np.int8)).to(cuda)
    assert V.variant_plan(9, k, n, 32, "q4").splits > 1
    for name, kern, plain in (
            ("v7", lambda: V.v7_int8(xi, lin), lambda: V.v7_int8_plain(xi, lin)),
            ("v9", lambda: V.v9_mulcost(xi, lin, u),
             lambda: V.v9_mulcost_plain(xi, lin, u)),
            ("v10", lambda: V.v10_4dot(xi, lin),
             lambda: V.v10_4dot_plain(xi, lin))):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
    assert V.v7_int8_plain(xi, lin)[0, 0].item() == 127 * 15 * k


@pytest.mark.cuda
def test_variant_v5_without_mins(cuda):
    lin = make_probe_weight("q4", 512, 256, 17, cuda, mins=False)
    x = make_x(8, 512, 17, cuda)
    assert rel_err(V.v5_minfold(x, None, lin),
                   V.v5_minfold_plain(x, None, lin)) < REL_LIMIT


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda, tmp_path):
    """A small model through Engine on the card (kernels) and on the CPU
    (plain versions): same greedy tokens."""
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

    path = build_synthetic_gguf(str(tmp_path / "small.gguf"), preset="small",
                                quant=GGMLType.Q4_K)
    gpu = Engine.load(path, EngineConfig(), device="cuda")
    cpu = Engine.load(path, EngineConfig(), device="cpu")
    ids = gpu.tokenizer.encode("hello there")
    Q.reset_launches()
    toks = gpu.greedy_tokens(ids, 12)
    assert Q.LAUNCHES["qmatmul_q4"] > 0 and Q.LAUNCHES["qmatmul_glu"] > 0
    assert toks == cpu.greedy_tokens(ids, 12)


@pytest.mark.cuda
def test_moe_engine_on_card_matches_cpu(cuda, tmp_path):
    """tiny-moe (Q5_1 gate/up, Q6_K down) through Engine on the card: the
    prompt's 256 slots take the grouped kernels, decode the slot-major one;
    same greedy tokens as the CPU. A first call captures the runner's
    graphs (their eager warm-up runs launch the kernels too); the counted
    call replays them."""
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

    path = build_synthetic_gguf(str(tmp_path / "moe.gguf"), preset="tiny-moe",
                                quant=GGMLType.Q4_K)
    gpu = Engine.load(path, EngineConfig(), device="cuda")
    cpu = Engine.load(path, EngineConfig(), device="cpu")
    ids = gpu.tokenizer.encode("The quick brown fox jumps over the lazy dog, "
                               "again and again.")
    gpu.greedy_tokens(ids, 12)
    Q.reset_launches()
    toks = gpu.greedy_tokens(ids, 12)
    assert Q.LAUNCHES["moe_glu_grouped"] == Q.LAUNCHES["moe_grouped"] == 2
    decode_steps = len(toks) - int(gpu.tokenizer.is_eog(toks[-1]))
    assert Q.LAUNCHES["moe_slot"] == 3 * 2 * decode_steps
    assert toks == cpu.greedy_tokens(ids, 12)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", ["gate", "up", "down"])
def test_mixed_stack_moe_layer_launches_kernels(cuda, tmp_path, dense):
    """One expert stack dense, the others quantized: each quantized stack
    still launches its MoE kernel on the card (grouped at 80 slots: the
    fused gate|up GLU when both are quantized), and the dense one none."""
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.models import transformer as T
    from llama_gguf_tpu_torch.ops.linear import dequantize_expert
    from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

    path = build_synthetic_gguf(str(tmp_path / "moe.gguf"), preset="tiny-moe",
                                quant=GGMLType.Q4_K)
    eng = Engine.load(path, EngineConfig(), device="cuda")
    ffn = eng.runner.params["layers"][0]["ffn"]
    ex = dict(ffn["experts"])
    ex[dense] = torch.stack([dequantize_expert(ex[dense], e)
                             for e in range(ex[dense].packed.shape[0])])
    x = make_x(40, eng.runner.cfg.hidden_size, 10, cuda)[None]
    Q.reset_launches()
    got = T.moe_layer(dict(ffn, experts=ex), eng.runner.cfg, x)
    torch.cuda.synchronize()
    want = {"moe_glu_grouped": 1} if dense == "down" else {"moe_grouped": 2}
    assert {k: v for k, v in Q.LAUNCHES.items() if v} == want
    assert rel_err(got, T.moe_layer(ffn, eng.runner.cfg, x)) < REL_LIMIT


# -- kernels 1-2 (csrc/qgemm.cu): both paths, the plan's threshold, splits --

QGEMM_ROWS = [1, 2, 3, 4, 5, 8, 15, 16, 17, 127, 128, 129, 512]


def check_close(got, want, precision):
    assert got.shape == want.shape and got.dtype == Q.out_dtype(precision)
    if precision == "default":
        assert within_bf16(got, want)
    else:
        assert rel_err(got, want) < REL_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("b", QGEMM_ROWS)
@pytest.mark.parametrize("t,n", [(GGMLType.Q4_K, 256), (GGMLType.Q6_K, 208),
                                 (GGMLType.Q8_0, 200)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_qgemm_rows_around_threshold(cuda, t, n, b):
    """The plan's own choice at every row count around TC_MIN_ROWS and the
    tile heights: N = 208 leaves the second 128-column tensor-core tile half
    masked; N = 200 (N % 16 != 0) takes split-K with byte loads."""
    lin = make_lin(t, n, 768, 20, cuda)
    x = make_x(b, 768, 20, cuda)
    plan = Q.qmatmul_plan(b, 768, n, lin.group, lin.fmt)
    assert plan.path == ("tc" if b >= Q.TC_MIN_ROWS and n % 16 == 0
                         else "splitk")
    key = "qmatmul_q4" if lin.fmt == "q4" else "qmatmul_q8"
    before = Q.LAUNCHES[key]
    got = Q.qmatmul(x, lin)
    torch.cuda.synchronize()
    assert Q.LAUNCHES[key] == before + 1
    check_close(got, Q.qmatmul_plain(x, lin), "highest")


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3, 5, 8])
@pytest.mark.parametrize("path,b", [("splitk", 1), ("splitk", 3),
                                    ("tc", 5), ("tc", 40)])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q5_1],
                         ids=lambda v: v.name)
def test_qgemm_forced_splits(cuda, t, path, b, splits):
    """K = 1280 (40 groups of 32, 80 of 16): 3 slices hold unequal group
    counts; the slices' partials are summed through the workspace."""
    lin = make_lin(t, 384, 1280, 21, cuda)
    x = make_x(b, 1280, 21, cuda)
    check_close(Q.qmatmul(x, lin, path=path, splits=splits),
                Q.qmatmul_plain(x, lin), "highest")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("panels", ["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 2, 64])
@pytest.mark.parametrize("t,mins", [(GGMLType.Q4_K, True),
                                    (GGMLType.Q4_K, False),
                                    (GGMLType.Q6_K, False),
                                    (GGMLType.Q8_0, False),
                                    (GGMLType.Q5_1, True)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_qgemm_panel_and_output_types(cuda, t, mins, b, panels, precision):
    """f32 and bf16 panels x f32 and bf16 outputs on both paths; q4 with and
    without its min panel; q8 from Q6_K (group 16), Q8_0 and Q5_1 (32)."""
    lin = make_lin(t, 256, 512, 22, cuda)
    if not mins:
        lin.mins = None
    if panels == "bf16":
        lin = to_bf16_panels(lin)
    x = make_x(b, 512, 22, cuda)
    check_close(Q.qmatmul(x, lin, precision),
                Q.qmatmul_plain(x, lin, precision), precision)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 8, 128])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda v: v.name)
def test_qgemm_bit_identical(cuda, t, b):
    """The split-K partials are summed in a fixed order: two calls, the
    same bits."""
    lin = make_lin(t, 512, 2048, 23, cuda)
    x = make_x(b, 2048, 23, cuda)
    assert Q.qmatmul_plan(b, 2048, 512, lin.group, lin.fmt).splits > 1
    assert torch.equal(Q.qmatmul(x, lin), Q.qmatmul(x, lin))


# -- kernel 3 (the GLU) on csrc/qgemm.cu: both paths, splits, tiles, types --

GLU_ROWS = [1, 2, 3, 4, 5, 6, 7, 8, 16, 128, 512]


def misaligned(lin):
    """The same weight with its packed bytes moved one byte off a 16-byte
    boundary (still contiguous): the plan must take byte loads."""
    buf = torch.empty(lin.packed.numel() + 1, dtype=lin.packed.dtype,
                      device=lin.packed.device)
    packed = buf[1:].view(lin.packed.shape)
    packed.copy_(lin.packed)
    return QuantLinear(packed, lin.scales, lin.mins, None, lin.fmt, lin.group,
                       lin.k, lin.n, lin.source_type, splits=lin.splits)


@pytest.mark.cuda
@pytest.mark.parametrize("b", GLU_ROWS)
@pytest.mark.parametrize("t,f", [(GGMLType.Q4_K, 320), (GGMLType.Q6_K, 192),
                                 (GGMLType.Q8_0, 200)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_glu_rows_around_threshold(cuda, t, f, b):
    """The plan's own path at every row count around TC_MIN_ROWS: F = 320
    leaves the last 64-column GLU tile half masked; F = 200 (F % 16 != 0)
    takes split-K with byte loads at any row count."""
    lin = make_lin(t, 2 * f, 768, 30, cuda, splits=(f, f))
    x = make_x(b, 768, 30, cuda)
    plan = Q.qmatmul_plan(b, 768, f, lin.group, lin.fmt, glu=True)
    assert plan.path == ("tc" if b >= Q.TC_MIN_ROWS and f % 16 == 0
                         else "splitk")
    before = Q.LAUNCHES["qmatmul_glu"]
    got = Q.qmatmul_glu(x, lin, "silu")
    torch.cuda.synchronize()
    assert Q.LAUNCHES["qmatmul_glu"] == before + 1
    check_close(got, Q.qmatmul_glu_plain(x, lin, "silu"), "highest")


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3, 5, 8])
@pytest.mark.parametrize("path,b", [("splitk", 1), ("splitk", 3),
                                    ("tc", 5), ("tc", 40)])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q5_1],
                         ids=lambda v: v.name)
def test_glu_forced_splits(cuda, t, path, b, splits):
    """K = 1280: 3 slices hold unequal group counts; the gate and up
    partials go through the workspace together and meet after the sum."""
    lin = make_lin(t, 2 * 192, 1280, 31, cuda, splits=(192, 192))
    x = make_x(b, 1280, 31, cuda)
    check_close(Q.qmatmul_glu(x, lin, "silu", path=path, splits=splits),
                Q.qmatmul_glu_plain(x, lin, "silu"), "highest")


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rows", [16, 32, 64])
@pytest.mark.parametrize("b", [5, 100, 512])
def test_glu_tile_rows(cuda, b, tile_rows):
    lin = make_lin(GGMLType.Q4_K, 2 * 256, 1024, 32, cuda, splits=(256, 256))
    x = make_x(b, 1024, 32, cuda)
    check_close(Q.qmatmul_glu(x, lin, "gelu", path="tc", tile_rows=tile_rows),
                Q.qmatmul_glu_plain(x, lin, "gelu"), "highest")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 8, 128])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda v: v.name)
def test_glu_bit_identical(cuda, t, b):
    lin = make_lin(t, 2 * 256, 2048, 33, cuda, splits=(256, 256))
    x = make_x(b, 2048, 33, cuda)
    assert Q.qmatmul_plan(b, 2048, 256, lin.group, lin.fmt,
                          glu=True).splits > 1
    assert torch.equal(Q.qmatmul_glu(x, lin, "silu"),
                       Q.qmatmul_glu(x, lin, "silu"))


@pytest.mark.cuda
@pytest.mark.parametrize("act", Q.GLU_ACTS)
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("panels", ["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("t,mins", [(GGMLType.Q4_K, True),
                                    (GGMLType.Q4_K, False),
                                    (GGMLType.Q6_K, False),
                                    (GGMLType.Q5_1, True)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_glu_types_and_activations(cuda, t, mins, b, panels, precision, act):
    """Every panel x output type on both paths, every activation; q4 with
    and without its min panel, q8 from Q6_K (group 16) and Q5_1 (32)."""
    lin = make_lin(t, 2 * 128, 512, 34, cuda, splits=(128, 128))
    if not mins:
        lin.mins = None
    if panels == "bf16":
        lin = to_bf16_panels(lin)
    x = make_x(b, 512, 34, cuda)
    check_close(Q.qmatmul_glu(x, lin, act, precision),
                Q.qmatmul_glu_plain(x, lin, act, precision), precision)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 64])
def test_glu_unaligned_takes_byte_loads(cuda, b):
    lin = misaligned(make_lin(GGMLType.Q4_K, 2 * 256, 512, 35, cuda,
                              splits=(256, 256)))
    x = make_x(b, 512, 35, cuda)
    plan = Q.qmatmul_plan(b, 512, 256, 32, "q4", aligned=False, glu=True)
    assert plan.path == "splitk" and not plan.vec
    check_close(Q.qmatmul_glu(x, lin, "silu"),
                Q.qmatmul_glu_plain(x, lin, "silu"), "highest")


# -- kernel 5 (grouped MoE) on the tensor-core path of csrc/qgemm.cu ---------


def routing(kind, s, e, dev):
    """uniform: slot s on expert s % E; skewed: make_idx (expert 2 every
    other slot, expert 1 none); one: every slot on expert 1."""
    if kind == "uniform":
        idx = torch.arange(s, dtype=torch.int32) % e
    elif kind == "skewed":
        return make_idx(s, e, 40 + s, dev)
    else:
        idx = torch.ones(s, dtype=torch.int32)
    return idx.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "one"])
@pytest.mark.parametrize("s", [32, 64, 256, 257])
@pytest.mark.parametrize("t,n", [(GGMLType.Q4_K, 256), (GGMLType.Q6_K, 128)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_moe_grouped_tensor_cores(cuda, t, n, s, kind, precision):
    stack = make_stack(t, 4, n, 512, 41, cuda)
    x, idx = make_x(s, 512, 41, cuda), routing(kind, s, 4, cuda)
    plan = Q.moe_grouped_plan(s, 4, 512, n, stack.group, stack.fmt)
    assert plan.path == "tc"
    before = Q.LAUNCHES["moe_grouped"]
    got = Q.moe_qmatmul(x, stack, idx, precision)
    torch.cuda.synchronize()
    assert Q.LAUNCHES["moe_grouped"] == before + 1
    check_close(got, Q.moe_qmatmul_plain(x, stack, idx, precision), precision)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("tile_rows", [16, 32, 64])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q5_1],
                         ids=lambda v: v.name)
def test_moe_grouped_forced_tiles_and_splits(cuda, t, tile_rows, splits):
    stack = make_stack(t, 4, 256, 1024, 42, cuda)
    x, idx = make_x(100, 1024, 42, cuda), make_idx(100, 4, 42, cuda)
    c_rows, g_blocks, _ = Q.moe_dims(100, 4)
    eg, rows, flat = Q.moe_group_plan(idx, 4, c_rows, g_blocks)
    got = Q.moe_grouped_blocked(x, stack, eg, rows, path="tc",
                                splits=splits, tile_rows=tile_rows)[flat]
    check_close(got, Q.moe_qmatmul_plain(x, stack, idx), "highest")
    again = Q.moe_grouped_blocked(x, stack, eg, rows, path="tc",
                                  splits=splits, tile_rows=tile_rows)[flat]
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["tc", "cuda cores"])
def test_moe_grouped_bad_expert_writes_nan(cuda, path):
    """An expert id outside [0, E) reads nothing and writes NaN to its
    group's rows; the other groups are untouched by it."""
    stack = make_stack(GGMLType.Q4_K, 4, 256, 512, 43, cuda)
    x, idx = make_x(64, 512, 43, cuda), make_idx(64, 4, 43, cuda)
    c_rows, g_blocks, _ = Q.moe_dims(64, 4)
    eg, rows, flat = Q.moe_group_plan(idx, 4, c_rows, g_blocks)
    bad = eg.clone()
    bad[0] = 4  # group 0 holds expert 0's slots
    got = Q.moe_grouped_blocked(x, stack, bad, rows, path=path,
                                splits=1)[flat]
    in_grp0 = flat < c_rows  # the slots whose rows lie in group 0
    assert bool(in_grp0.any()) and bool(torch.isnan(got[in_grp0]).all())
    want = Q.moe_qmatmul_plain(x, stack, idx)
    assert rel_err(got[~in_grp0], want[~in_grp0]) < REL_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("t,n", MOE_FORMATS,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_moe_grouped_path_follows_layout(cuda, t, n):
    """q4 group 32 and q8 with N % 16 == 0 on the tensor cores; ragged N
    (200, 131) on the CUDA-core grouped kernel; both counted."""
    stack = make_stack(t, 4, n, 512, 44, cuda)
    x, idx = make_x(96, 512, 44, cuda), make_idx(96, 4, 44, cuda)
    plan = Q.moe_grouped_plan(96, 4, 512, n, stack.group, stack.fmt)
    assert plan.path == ("tc" if n % 16 == 0 else "cuda cores")
    before = Q.LAUNCHES["moe_grouped"]
    got = Q.moe_qmatmul(x, stack, idx)
    torch.cuda.synchronize()
    assert Q.LAUNCHES["moe_grouped"] == before + 1
    check_close(got, Q.moe_qmatmul_plain(x, stack, idx), "highest")


# -- kernel 4 (slot-major MoE) on the split-K path of csrc/qgemm.cu ----------

# q4 group 32; q8 group 16 (ragged N: the last tile masked, byte loads);
# q8 group 32 (ragged, byte loads; and N % 16 == 0)
SLOT_FORMATS = [(GGMLType.Q4_K, 256), (GGMLType.Q6_K, 200),
                (GGMLType.Q8_0, 131), (GGMLType.Q5_1, 208)]


def misaligned_stack(stack):
    """The same stack with its packed bytes one byte off a 16-byte
    boundary (still contiguous)."""
    import dataclasses

    buf = torch.empty(stack.packed.numel() + 1, dtype=stack.packed.dtype,
                      device=stack.packed.device)
    packed = buf[1:].view(stack.packed.shape)
    packed.copy_(stack.packed)
    return dataclasses.replace(stack, packed=packed)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("s", [1, 2, 3, 31])
@pytest.mark.parametrize("t,n", SLOT_FORMATS,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_moe_slot_split_k(cuda, t, n, s, precision):
    stack = make_stack(t, 8, n, 512, 50, cuda)
    x, idx = make_x(s, 512, 50, cuda), make_idx(s, 8, 50, cuda)
    plan = Q.moe_slot_plan(s, 8, 512, n, stack.group, stack.fmt)
    assert plan.path == "splitk" and plan.vec == (n % 16 == 0)
    Q.reset_launches()
    got = Q.moe_qmatmul(x, stack, idx, precision)
    torch.cuda.synchronize()
    assert Q.LAUNCHES_BY_PATH == {"moe_slot splitk": 1}
    check_close(got, Q.moe_qmatmul_plain(x, stack, idx, precision), precision)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_moe_slot_one_expert_twice_and_bad_ids(cuda, precision):
    """Expert 6 twice; ids 8 and -1 lie outside [0, 8): their rows read
    nothing and are NaN, and the workspace and counters stay usable (a
    second call gives the same bits)."""
    stack = make_stack(GGMLType.Q4_K, 8, 384, 1024, 51, cuda)
    x = make_x(4, 1024, 51, cuda)
    idx = torch.tensor([6, 8, 6, -1], dtype=torch.int32, device=cuda)
    got = Q.moe_qmatmul(x, stack, idx, precision)
    assert bool(torch.isnan(got[1::2].float()).all())
    ok = torch.tensor([0, 2], device=cuda)
    check_close(got[ok], Q.moe_qmatmul_plain(x[ok], stack, idx[ok],
                                             precision), precision)
    again = Q.moe_qmatmul(x, stack, idx, precision)
    assert torch.equal(got[ok], again[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 5])
def test_moe_slot_unaligned_takes_byte_loads(cuda, s):
    stack = misaligned_stack(make_stack(GGMLType.Q4_K, 4, 256, 512, 52,
                                        cuda))
    x, idx = make_x(s, 512, 52, cuda), make_idx(s, 4, 52, cuda)
    assert not Q.moe_slot_plan(s, 4, 512, 256, 32, "q4", aligned=False).vec
    check_close(Q.moe_qmatmul(x, stack, idx),
                Q.moe_qmatmul_plain(x, stack, idx), "highest")


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 7, 8, 12, 16, 17, 24, 32])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda v: v.name)
def test_moe_slot_forced_splits(cuda, t, splits):
    """Every split count the plan can pick (1..32 slices of whole groups),
    each bit-identical call to call (the fixed-order split sum)."""
    stack = make_stack(t, 4, 256, 1024, 53, cuda)
    x, idx = make_x(3, 1024, 53, cuda), make_idx(3, 4, 53, cuda)
    got = Q.moe_qmatmul(x, stack, idx, splits=splits)
    check_close(got, Q.moe_qmatmul_plain(x, stack, idx), "highest")
    assert torch.equal(got, Q.moe_qmatmul(x, stack, idx, splits=splits))


# -- kernel 6 (grouped GLU MoE) on the tensor-core path of csrc/qgemm.cu -----

# q4 group 32, q8 group 16 and q8 group 32 (F = 320: the last 64-column
# tile half masked)
GLU_GROUPED_FORMATS = [(GGMLType.Q4_K, 256), (GGMLType.Q6_K, 128),
                       (GGMLType.Q8_0, 320)]


def random_top2(s, e, seed, dev):
    """Top-2 routing of s // 2 tokens: two distinct experts per token."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(e)[:2] for _ in range(s // 2)])
    return torch.from_numpy(idx.reshape(-1).astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("kind", ["random", "skewed", "one"])
@pytest.mark.parametrize("s", [64, 256, 1024])
@pytest.mark.parametrize("t,f", GLU_GROUPED_FORMATS,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_moe_glu_grouped_tensor_cores(cuda, t, f, s, kind, precision):
    gate = make_stack(t, 4, f, 512, 54, cuda)
    up = make_stack(t, 4, f, 512, 55, cuda)
    x = make_x(s, 512, 54, cuda)
    idx = (random_top2(s, 4, s, cuda) if kind == "random"
           else routing(kind, s, 4, cuda))
    assert Q.moe_glu_grouped_plan(s, 4, 512, f, gate.group,
                                  gate.fmt).path == "tc"
    Q.reset_launches()
    got = Q.moe_qmatmul_glu(x, gate, up, idx, "silu", precision)
    torch.cuda.synchronize()
    assert Q.LAUNCHES_BY_PATH == {"moe_glu_grouped tc": 1}
    check_close(got, Q.moe_qmatmul_glu_plain(x, gate, up, idx, "silu",
                                             precision), precision)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("act", Q.GLU_ACTS)
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda v: v.name)
def test_moe_glu_grouped_activations(cuda, t, act, precision):
    gate = make_stack(t, 8, 256, 512, 56, cuda)
    up = make_stack(t, 8, 256, 512, 57, cuda)
    x, idx = make_x(256, 512, 56, cuda), random_top2(256, 8, 56, cuda)
    check_close(Q.moe_qmatmul_glu(x, gate, up, idx, act, precision),
                Q.moe_qmatmul_glu_plain(x, gate, up, idx, act, precision),
                precision)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("tile_rows", [16, 32, 64])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q5_1],
                         ids=lambda v: v.name)
def test_moe_glu_grouped_forced_tiles_and_splits(cuda, t, tile_rows, splits):
    gate = make_stack(t, 4, 256, 1024, 58, cuda)
    up = make_stack(t, 4, 256, 1024, 59, cuda)
    x, idx = make_x(100, 1024, 58, cuda), make_idx(100, 4, 58, cuda)
    c_rows, g_blocks, _ = Q.moe_dims(100, 4)
    eg, rows, flat = Q.moe_group_plan(idx, 4, c_rows, g_blocks)

    def run():
        return Q.moe_grouped_blocked(x, gate, eg, rows, up=up, act="gelu",
                                     path="tc", splits=splits,
                                     tile_rows=tile_rows)[flat]

    got = run()
    check_close(got, Q.moe_qmatmul_glu_plain(x, gate, up, idx, "gelu"),
                "highest")
    assert torch.equal(got, run())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["tc", "cuda cores"])
def test_moe_glu_grouped_bad_expert_writes_nan(cuda, path):
    """An expert id outside [0, E) in eg reads nothing and writes NaN to its
    group's rows (all F columns); the other groups are untouched by it."""
    gate = make_stack(GGMLType.Q4_K, 4, 320, 512, 60, cuda)
    up = make_stack(GGMLType.Q4_K, 4, 320, 512, 61, cuda)
    x, idx = make_x(64, 512, 60, cuda), make_idx(64, 4, 60, cuda)
    c_rows, g_blocks, _ = Q.moe_dims(64, 4)
    eg, rows, flat = Q.moe_group_plan(idx, 4, c_rows, g_blocks)
    bad = eg.clone()
    bad[0] = -1  # group 0 holds expert 0's slots
    got = Q.moe_grouped_blocked(x, gate, bad, rows, up=up, act="silu",
                                path=path, splits=1)[flat]
    in_grp0 = flat < c_rows
    assert bool(in_grp0.any()) and bool(torch.isnan(got[in_grp0]).all())
    want = Q.moe_qmatmul_glu_plain(x, gate, up, idx, "silu")
    assert rel_err(got[~in_grp0], want[~in_grp0]) < REL_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case", ["Q4_K", "Q5_1 F=200", "Q6_K F=131",
                                  "unaligned", "q4 group 64"])
def test_moe_glu_grouped_cuda_cores_for_other_layouts(cuda, case, precision):
    """The layouts the plan keeps on the CUDA-core grouped GLU kernel of
    csrc/moe_qmatmul.cu (ragged F, an unaligned stack, q4 groups other than
    32), counted on that path; Q4_K at F = 256 on the tensor cores."""
    import dataclasses

    t, f = {"Q5_1 F=200": (GGMLType.Q5_1, 200),
            "Q6_K F=131": (GGMLType.Q6_K, 131)}.get(case, (GGMLType.Q4_K,
                                                            256))
    gate = make_stack(t, 4, f, 512, 62, cuda)
    up = make_stack(t, 4, f, 512, 63, cuda)
    if case == "unaligned":
        up = misaligned_stack(up)
    if case == "q4 group 64":  # the same levels, two groups' panels merged
        gate, up = (dataclasses.replace(
            st, group=64, scales=st.scales[:, ::2].contiguous(),
            mins=st.mins[:, ::2].contiguous()) for st in (gate, up))
    x, idx = make_x(96, 512, 62, cuda), make_idx(96, 4, 62, cuda)
    want_path = "tc" if case == "Q4_K" else "cuda cores"
    Q.reset_launches()
    got = Q.moe_qmatmul_glu(x, gate, up, idx, "silu", precision)
    torch.cuda.synchronize()
    assert Q.LAUNCHES_BY_PATH == {f"moe_glu_grouped {want_path}": 1}
    check_close(got, Q.moe_qmatmul_glu_plain(x, gate, up, idx, "silu",
                                             precision), precision)


@pytest.mark.cuda
def test_moe_layer_makes_one_dispatch_plan(cuda, tmp_path, monkeypatch):
    """A grouped MoE layer makes moe_group_plan once and its gate|up and
    down kernels share it; a decode step makes none."""
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.models import transformer as T
    from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

    path = build_synthetic_gguf(str(tmp_path / "moe.gguf"), preset="tiny-moe",
                                quant=GGMLType.Q4_K)
    eng = Engine.load(path, EngineConfig(), device="cuda")
    ffn = eng.runner.params["layers"][0]["ffn"]
    calls, make_plan = [], Q.moe_group_plan

    def counted(*args):
        calls.append(args[0].shape[0])
        return make_plan(*args)

    monkeypatch.setattr(T, "moe_group_plan", counted)
    monkeypatch.setattr(Q, "moe_group_plan", counted)
    for tokens, plans in ((40, 1), (1, 0)):
        calls.clear()
        Q.reset_launches()
        x = make_x(tokens, eng.runner.cfg.hidden_size, 64, cuda)[None]
        T.moe_layer(ffn, eng.runner.cfg, x)
        torch.cuda.synchronize()
        assert len(calls) == plans
        want = ({"moe_glu_grouped": 1, "moe_grouped": 1} if plans
                else {"moe_slot": 3})
        assert {k: v for k, v in Q.LAUNCHES.items() if v} == want


# -- the layouts of Q2_K (q4 group 16) and Q8_K (q8 group 256): kernels 1-6 --

NEW_LAYOUTS = [GGMLType.Q2_K, GGMLType.Q8_K]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("panels", ["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 3, 4, 5, 8, 37, 130])
@pytest.mark.parametrize("t", NEW_LAYOUTS, ids=lambda v: v.name)
def test_new_layouts_kernels_1_2(cuda, t, b, panels, precision):
    """Split-K below TC_MIN_ROWS rows, the tensor cores from there, f32 and
    bf16 panels and outputs, counted on the plan's path."""
    lin = make_lin(t, 384, 1024, 30, cuda)
    assert (lin.fmt, lin.group) == {GGMLType.Q2_K: ("q4", 16),
                                    GGMLType.Q8_K: ("q8", 256)}[t]
    if panels == "bf16":
        lin = to_bf16_panels(lin)
    x = make_x(b, 1024, 30, cuda)
    path = "tc" if b >= Q.TC_MIN_ROWS else "splitk"
    assert Q.qmatmul_plan(b, 1024, 384, lin.group, lin.fmt).path == path
    Q.reset_launches()
    got = Q.qmatmul(x, lin, precision)
    torch.cuda.synchronize()
    assert Q.LAUNCHES_BY_PATH == {
        f"{'qmatmul_q4' if lin.fmt == 'q4' else 'qmatmul_q8'} {path}": 1}
    check_close(got, Q.qmatmul_plain(x, lin, precision), precision)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3, 4])
@pytest.mark.parametrize("path,b", [("splitk", 1), ("splitk", 3),
                                    ("tc", 5), ("tc", 40)])
@pytest.mark.parametrize("t", NEW_LAYOUTS, ids=lambda v: v.name)
def test_new_layouts_forced_splits(cuda, t, path, b, splits):
    """K = 1280: 5 groups of 256 (3 slices of unequal group counts on the
    tensor cores, a group's 8 stages never cut) and 80 groups of 16."""
    lin = make_lin(t, 256, 1280, 31, cuda)
    x = make_x(b, 1280, 31, cuda)
    check_close(Q.qmatmul(x, lin, path=path, splits=splits),
                Q.qmatmul_plain(x, lin), "highest")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200, 131])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("t", NEW_LAYOUTS, ids=lambda v: v.name)
def test_new_layouts_ragged_n(cuda, t, b, n):
    """N % 16 != 0: split-K with byte loads at any row count."""
    lin = make_lin(t, n, 512, 32, cuda)
    x = make_x(b, 512, 32, cuda)
    assert Q.qmatmul_plan(b, 512, n, lin.group, lin.fmt).path == "splitk"
    check_close(Q.qmatmul(x, lin), Q.qmatmul_plain(x, lin), "highest")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("panels", ["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 4, 5, 64])
@pytest.mark.parametrize("t", NEW_LAYOUTS, ids=lambda v: v.name)
def test_new_layouts_glu_kernel(cuda, t, b, panels, precision):
    lin = make_lin(t, 2 * 192, 1024, 33, cuda, splits=(192, 192))
    if panels == "bf16":
        lin = to_bf16_panels(lin)
    x = make_x(b, 1024, 33, cuda)
    path = "tc" if b >= Q.TC_MIN_ROWS else "splitk"
    Q.reset_launches()
    got = Q.qmatmul_glu(x, lin, "silu", precision)
    torch.cuda.synchronize()
    assert Q.LAUNCHES_BY_PATH == {f"qmatmul_glu {path}": 1}
    check_close(got, Q.qmatmul_glu_plain(x, lin, "silu", precision),
                precision)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("s", [2, 45, 256])
@pytest.mark.parametrize("t", NEW_LAYOUTS, ids=lambda v: v.name)
def test_new_layouts_moe_kernels(cuda, t, s, precision):
    """Kernel 4 (split-K) at 2 slots; kernels 5 and 6 on the tensor cores at
    45 and 256 (imbalanced routing: a zero-slot expert)."""
    gate = make_stack(t, 4, 256, 1024, 34, cuda)
    up = make_stack(t, 4, 256, 1024, 35, cuda)
    x, idx = make_x(s, 1024, 34, cuda), make_idx(s, 4, 34, cuda)
    Q.reset_launches()
    got = Q.moe_qmatmul(x, gate, idx, precision)
    glu = Q.moe_qmatmul_glu(x, gate, up, idx, "silu", precision)
    torch.cuda.synchronize()
    if s < Q.MOE_GROUPED_MIN_SLOTS:
        assert glu is None
        assert Q.LAUNCHES_BY_PATH == {"moe_slot splitk": 1}
    else:
        assert Q.LAUNCHES_BY_PATH == {"moe_grouped tc": 1,
                                      "moe_glu_grouped tc": 1}
        check_close(glu, Q.moe_qmatmul_glu_plain(x, gate, up, idx, "silu",
                                                 precision), precision)
    check_close(got, Q.moe_qmatmul_plain(x, gate, idx, precision), precision)


@pytest.mark.cuda
@pytest.mark.parametrize("t", NEW_LAYOUTS + [GGMLType.Q4_K],
                         ids=lambda v: v.name)
def test_parity_gates_pass_on_the_card(cuda, t):
    """ops/parity on a model-like tree of the format (a plain and a fused
    gate|up weight, f32 and bf16 panels) and on the MoE kernels, each in
    "highest" and "default" precision."""
    from llama_gguf_tpu_torch.ops import parity

    lin = make_lin(t, 256, 512, 36, cuda)
    glu = make_lin(t, 256, 512, 37, cuda, splits=(128, 128))
    tree = {"layers": [{"w": lin, "gate_up": glu},
                       {"w": to_bf16_panels(lin)}]}
    assert parity.kernel_parity_check(tree, rtol=0, atol=REL_LIMIT) == 3
    assert parity.moe_kernel_parity_check(t, rtol=0, atol=REL_LIMIT) == 6
