"""The parallel plans on a card: kernels 1-6 at the shapes a tp=2 rank
gives them (TinyLlama-1.1B's and Mixtral-8x7B's shards) against their plain
versions, and a tp=2 mesh of two ranks sharing the card (over gloo) equal
to one rank.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_parallel_card.py
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_kernels import make_lin, make_stack, make_x, rel_err

from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

REL_LIMIT = 2e-4  # f32 sums in another order (tests/test_torch_kernels.py)
# (name, type, K, N) of a tp=2 rank's products; N of a GLU is 2F
SHARDS = [("tinyllama q|k|v", GGMLType.Q4_K, 2048, 1024 + 128 + 128),
          ("tinyllama o_proj", GGMLType.Q4_K, 1024, 2048),
          ("tinyllama gate|up", GGMLType.Q4_K, 2048, 2 * 2816),
          ("tinyllama down", GGMLType.Q6_K, 2816, 2048),
          ("tinyllama head", GGMLType.Q6_K, 2048, 16000),
          ("mixtral q|k|v", GGMLType.Q4_K, 4096, 2048 + 512 + 512),
          ("mixtral o_proj", GGMLType.Q4_K, 2048, 4096)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _weight(t, n, k, glu):
    return make_lin(t, n, k, 5, "cuda", splits=(n // 2, n // 2) if glu
                    else None)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 128])
@pytest.mark.parametrize("name,t,k,n", SHARDS, ids=[s[0] for s in SHARDS])
def test_kernels_1_to_3_at_tp2_shard_shapes(cuda, name, t, k, n, rows):
    glu = name.endswith("gate|up")
    lin = _weight(t, n, k, glu)
    x = make_x(rows, k, 3, cuda)
    if glu:
        got, want = (Q.qmatmul_glu(x, lin, "silu"),
                     Q.qmatmul_glu_plain(x, lin, "silu"))
    else:
        got, want = Q.qmatmul(x, lin), Q.qmatmul_plain(x, lin)
    assert got.shape == (rows, n // 2 if glu else n)
    assert rel_err(got, want) < REL_LIMIT


@functools.lru_cache(maxsize=None)
def _local_experts():
    """A tp=2 rank's 4 of Mixtral-8x7B's 8 experts: gate and up Q4_K 4096
    -> 14336, down Q6_K 14336 -> 4096."""
    return (make_stack(GGMLType.Q4_K, 4, 14336, 4096, 21, "cuda"),
            make_stack(GGMLType.Q4_K, 4, 14336, 4096, 22, "cuda"),
            make_stack(GGMLType.Q6_K, 4, 4096, 14336, 23, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 256])
def test_moe_kernels_on_a_ranks_local_experts(cuda, s):
    """The slots a rank keeps at decode (kernel 4) and at prefill (kernels
    5 and 6), renumbered onto its 4 local experts."""
    gate, up, down = _local_experts()
    idx = torch.from_numpy(np.random.default_rng(s).integers(
        0, 4, size=s).astype(np.int32)).to(cuda)
    x = make_x(s, 4096, 9, cuda)
    act = Q.moe_qmatmul_glu(x, gate, up, idx, "silu")
    if act is None:
        for st in (gate, up):
            assert rel_err(Q.moe_qmatmul(x, st, idx),
                           Q.moe_qmatmul_plain(x, st, idx)) < REL_LIMIT
        act = Q.moe_qmatmul_glu_plain(x, gate, up, idx, "silu")
    else:
        assert rel_err(act, Q.moe_qmatmul_glu_plain(
            x, gate, up, idx, "silu")) < REL_LIMIT
    got = Q.moe_qmatmul(act, down, idx)
    assert got.shape == (s, 4096)
    assert rel_err(got, Q.moe_qmatmul_plain(act, down, idx)) < REL_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_tp2_pair_on_one_card_equals_one_rank(cuda, tmp_path, preset):
    """Two ranks on the one card, over gloo (NCCL refuses two ranks on one
    GPU): greedy tokens equal one rank's, the prefill logits agree within
    the kernels' limit, every rank ran its steps eagerly on cuda:0."""
    path = str(tmp_path / f"{preset}.gguf")
    build_synthetic_gguf(path, preset=preset, quant=GGMLType.Q4_K)
    one = Engine.load(path, EngineConfig(), device="cuda")
    ids = [5, 17, 33, 2, 9, 40, 41, 7]
    want = one.greedy_tokens(ids, 8)
    lw, _, _ = one.runner.prefill(ids, one.runner._make_kv(1))
    eng = Engine.load(path, EngineConfig(mesh_model=2), device="cuda")
    try:
        assert eng.runner.mesh.backend == "gloo"
        assert eng.greedy_tokens(ids, 8) == want
        lg, _, _ = eng.runner.prefill(ids, eng.runner.init_kv(1))
        assert rel_err(lg, lw) < REL_LIMIT
        stats = eng.runner.rank_stats()
    finally:
        eng.close()
    assert [s["device"] for s in stats] == ["cuda:0", "cuda:0"]
    assert all(s["eager_steps"] > 0 for s in stats)
    assert all(sum(s["launches"].values()) > 0 for s in stats)
