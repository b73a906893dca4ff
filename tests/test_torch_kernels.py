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
    lin = make_lin(GGMLType.Q4_K, 128, 256, 3, cuda)
    lin.scales = lin.scales.to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Q.qmatmul(make_x(1, 256, 3, cuda), lin)


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
    same greedy tokens as the CPU."""
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

    path = build_synthetic_gguf(str(tmp_path / "moe.gguf"), preset="tiny-moe",
                                quant=GGMLType.Q4_K)
    gpu = Engine.load(path, EngineConfig(), device="cuda")
    cpu = Engine.load(path, EngineConfig(), device="cpu")
    ids = gpu.tokenizer.encode("The quick brown fox jumps over the lazy dog, "
                               "again and again.")
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
