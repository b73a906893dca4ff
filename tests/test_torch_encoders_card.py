"""The encoder slice on a card: kernels 1-3 at bge-base-en-v1.5's and
flan-t5-base's projection shapes against their plain versions, the graphed
T5 decoder step against the eager one, and a BERT batch against its
sequences alone.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_encoders_card.py
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_kernels import make_lin, make_x, rel_err

from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.utils.synthetic import (build_synthetic_bert,
                                                  build_synthetic_t5)

# f32 sums in another order (kernels); graphed against eager steps: the same
# kernels on the same inputs, another cuBLAS algorithm allowed
REL_LIMIT = 2e-4
# (name, type, K, N) of the products kernels 1-3 run; N of a GLU is 2F
PROJECTIONS = [("bert qkv", GGMLType.Q4_K, 768, 3 * 768),
               ("bert up", GGMLType.Q4_K, 768, 3072),
               ("bert down", GGMLType.Q6_K, 3072, 768),
               ("t5 o", GGMLType.Q4_K, 768, 768),
               ("t5 gate|up", GGMLType.Q4_K, 768, 2 * 2048),
               ("t5 down", GGMLType.Q6_K, 2048, 768),
               ("t5 head", GGMLType.Q6_K, 768, 32128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels and CUDA graphs have no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _weight(t, n, k, glu):
    return make_lin(t, n, k, 7, "cuda", splits=(n // 2, n // 2) if glu
                    else None)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 512, 4096])
@pytest.mark.parametrize("name,t,k,n", PROJECTIONS,
                         ids=[p[0] for p in PROJECTIONS])
def test_kernels_at_encoder_shapes(cuda, name, t, k, n, rows):
    glu = "gate|up" in name
    lin = _weight(t, n, k, glu)
    x = make_x(rows, k, 3, "cuda")
    if glu:
        y = Q.qmatmul_glu(x, lin, "gelu")
        want = Q.qmatmul_glu_plain(x, lin, "gelu")
    else:
        y = Q.qmatmul(x, lin)
        want = Q.qmatmul_plain(x, lin)
    assert rel_err(y, want) <= REL_LIMIT


@pytest.fixture(scope="module")
def t5_engine(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    path = build_synthetic_t5(
        str(tmp_path_factory.mktemp("t5") / "t5.gguf"), gated=True,
        untied=True, hidden=256, ffn=512, heads=4, hd=64,
        quant=GGMLType.Q4_K)
    return Engine.load(path, EngineConfig(weight_mode="quant"),
                       device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_ids", [5, 40])
def test_t5_graphed_steps_equal_eager(cuda, t5_engine, n_ids):
    t5 = t5_engine.t5
    ids = list(np.random.default_rng(n_ids).integers(5, 500, size=n_ids))
    g_l, e_l = [], []
    t5.eager_steps = 0
    got = t5.generate_ids(ids, 24, record=g_l)
    assert t5.eager_steps == 0 and t5.replays
    want = t5.generate_ids(ids, 24, eager=True, record=e_l)
    assert t5.eager_steps == len(e_l)
    assert got == want
    for a, b in zip(g_l, e_l):
        assert np.abs(a - b).max() <= REL_LIMIT * np.abs(b).max()


@pytest.mark.cuda
def test_bert_batch_equals_alone(cuda, tmp_path):
    path = build_synthetic_bert(str(tmp_path / "b.gguf"), vocab=300,
                                hidden=256, layers=2, heads=4, ffn=512,
                                ctx=128, quant=GGMLType.Q4_K)
    enc = Engine.load(path, EngineConfig(weight_mode="quant"),
                      device="cuda").encoder
    rng = np.random.default_rng(0)
    seqs = [rng.integers(5, 300, size=n).tolist() for n in (7, 100, 33)]
    out = enc.encode(seqs)
    for i, ids in enumerate(seqs):
        alone = enc.encode([ids])[0, :len(ids)]
        got = out[i, :len(ids)]
        assert np.abs(got - alone).max() <= 1e-5 * np.abs(alone).max()
