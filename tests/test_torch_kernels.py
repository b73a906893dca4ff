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
from llama_gguf_tpu_torch.ops.linear import QuantLinear
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
