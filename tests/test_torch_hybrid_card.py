"""The Qwen3Next hybrid slice on a card: kernels 1-6 at
Qwen3-Next-80B-A3B's shapes against their plain versions, graphed hybrid
steps against eager ones, the captures' warm-ups, and the batched engine's
reused rows.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_hybrid_card.py
"""

import numpy as np
import pytest
import torch

from test_torch_kernels import (make_lin, make_stack, make_x, rel_err,
                                within_bf16)

from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

# f32 sums in another order (kernels); graphed against eager steps: the same
# kernels on the same inputs, another cuBLAS algorithm allowed
REL_LIMIT = 2e-4
# Qwen3-Next-80B-A3B (utils/synthetic.HYBRID_MOE_PRESETS): (name, type, K,
# N) of the projections kernels 1-3 run, N of the GLU being 2F
PROJECTIONS = [("ssm_in", GGMLType.Q4_K, 2048, 8192),
               ("attn_gate z", GGMLType.Q4_K, 2048, 4096),
               ("ssm_out", GGMLType.Q4_K, 4096, 2048),
               ("qkv", GGMLType.Q4_K, 2048, 4096 + 2 * 512),
               ("o_proj", GGMLType.Q4_K, 4096, 2048),
               ("shared down", GGMLType.Q6_K, 512, 2048),
               ("shared gate|up", GGMLType.Q4_K, 2048, 2 * 512)]
EXPERTS, TOPK, HIDDEN, EXPERT_FFN = 16, 10, 2048, 512
GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels and CUDA graphs have no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 128, 512])
@pytest.mark.parametrize("name,t,k,n", PROJECTIONS,
                         ids=[p[0] for p in PROJECTIONS])
def test_projection_kernels_at_qwen3next_shapes(cuda, name, t, k, n, rows):
    glu = name.endswith("gate|up")
    lin = make_lin(t, n, k, 7, cuda, splits=(n // 2, n // 2) if glu else None)
    x = make_x(rows, k, 7, cuda)
    key = "qmatmul_glu" if glu else f"qmatmul_{lin.fmt}"
    before = Q.LAUNCHES[key]
    if glu:
        got, want = (Q.qmatmul_glu(x, lin, "silu"),
                     Q.qmatmul_glu_plain(x, lin, "silu"))
    else:
        got, want = Q.qmatmul(x, lin), Q.qmatmul_plain(x, lin)
    torch.cuda.synchronize()
    assert Q.LAUNCHES[key] == before + 1
    assert got.shape == (rows, n // 2 if glu else n)
    assert rel_err(got, want) < REL_LIMIT


def _routing(tokens, seed, dev):
    """Top-10 of 16 distinct experts per token, token-major slots."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(EXPERTS)[:TOPK] for _ in range(tokens)])
    return torch.from_numpy(idx.reshape(-1).astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("tokens", [1, 96], ids=["decode", "prefill96"])
def test_expert_kernels_at_qwen3next_shapes(cuda, tokens, precision):
    """Gate/up 2048 -> 512 (Q4_K) and down 512 -> 2048 (Q6_K) stacks:
    slot-major at 10 slots, grouped and grouped GLU at 960."""
    gate = make_stack(GGMLType.Q4_K, EXPERTS, EXPERT_FFN, HIDDEN, 8, cuda)
    up = make_stack(GGMLType.Q4_K, EXPERTS, EXPERT_FFN, HIDDEN, 9, cuda)
    down = make_stack(GGMLType.Q6_K, EXPERTS, HIDDEN, EXPERT_FFN, 10, cuda)
    idx = _routing(tokens, 11, cuda)
    s = idx.shape[0]
    x = make_x(s, HIDDEN, 12, cuda)
    grouped = Q.moe_dims(s, EXPERTS)[2]
    assert grouped == (tokens > 1)
    before = dict(Q.LAUNCHES)
    act = Q.moe_qmatmul_glu(x, gate, up, idx, "silu", precision)
    want_act = Q.moe_qmatmul_glu_plain(x, gate, up, idx, "silu", precision)
    pairs = []
    if grouped:
        assert act is not None
        pairs.append((act, want_act))
    else:  # below the grouped rule: the caller's two slot-major products
        assert act is None
        pairs.append((Q.moe_qmatmul(x, gate, idx, precision),
                      Q.moe_qmatmul_plain(x, gate, idx, precision)))
        act = want_act
    pairs.append((Q.moe_qmatmul(act.float(), down, idx, precision),
                  Q.moe_qmatmul_plain(act.float(), down, idx, precision)))
    torch.cuda.synchronize()
    launched = {k: Q.LAUNCHES[k] - before.get(k, 0) for k in Q.LAUNCHES}
    if grouped:
        assert launched["moe_glu_grouped"] == launched["moe_grouped"] == 1
    else:
        assert launched["moe_slot"] == 2
    for got, want in pairs:
        if precision == "default":
            assert within_bf16(got, want)
        else:
            assert rel_err(got, want) < REL_LIMIT


@pytest.fixture
def engine(cuda, tmp_path):
    path = str(tmp_path / "tiny-qwen3next-moe.gguf")
    build_synthetic_gguf(path, preset="tiny-qwen3next-moe",
                         quant=GGMLType.Q4_K)
    return Engine.load(path, EngineConfig(weight_mode="quant", max_batch=2),
                       device="cuda")


def _state(kv):
    return [{k: t.clone() for k, t in s.items()} for s in kv["deltanet"]]


def _same_state(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b)
               for k in ("S", "conv"))


@pytest.mark.cuda
def test_graphed_steps_after_other_traffic_equal_eager(engine):
    """A prompt prefilled on the runner's cache after another sequence's
    prefill (init_kv clears the state), then decode steps whose graph is
    captured while the cache holds the prompt's state: the logits of the
    eager steps on a fresh cache, and the same state."""
    r = engine.runner
    rng = np.random.default_rng(1)
    other, ids = (rng.integers(3, 500, size=n).tolist() for n in (20, 9))
    r.prefill(other, r.init_kv(1))
    eager_kv = r._make_kv(1)
    want, eager_kv, pos = r.prefill(ids, eager_kv)
    got, kv, _ = r.prefill(ids, r.init_kv(1))
    assert (got - want).abs().max() <= REL_LIMIT * want.abs().max()
    captures = r.captures
    tok = int(torch.argmax(want))
    for _ in range(6):
        want, eager_kv = r.decode_one(tok, pos, eager_kv)
        got, kv = r.decode_one(tok, pos, kv)
        assert (got - want).abs().max() <= REL_LIMIT * want.abs().max()
        tok, pos = int(torch.argmax(want)), pos + 1
    assert r.captures == captures + 1  # the decode key, at the first step
    for a, b in zip(kv["deltanet"], eager_kv["deltanet"]):
        for key in ("S", "conv"):
            assert (a[key] - b[key]).abs().max() <= \
                REL_LIMIT * b[key].abs().max()


@pytest.mark.cuda
def test_capture_warm_ups_leave_state_bit_unchanged(engine):
    """Capturing a new step key (its eager warm-up on dummy inputs, then
    the capture) and a new greedy key leaves every row's S and conv as they
    were; the greedy graph's replays then continue the eager steps."""
    r = engine.runner
    kv = r.init_kv(1)
    ids = list(range(3, 40))
    logits, kv, pos = r.prefill(ids, kv)
    before = _state(kv)
    cache = r._graphed(kv)
    r._step_graph(1, 1, 512, False, kv, cache)  # a key no step has used
    r._greedy_io[cache] = (torch.zeros(1, dtype=torch.int32, device="cuda"),
                           torch.zeros(1, dtype=torch.int32, device="cuda"))
    r._greedy_graph(1, 512, kv, cache)
    torch.cuda.synchronize()
    assert _same_state(before, _state(kv))
    first = torch.argmax(logits)[None].to(torch.int32)
    eager_kv = r._make_kv(1)
    r.prefill(ids, eager_kv)
    want, _ = r.greedy_decode(first, [pos], eager_kv, 8)
    got, _ = r.greedy_decode(first, [pos], kv, 8)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_batched_reused_rows_equal_single_stream(engine):
    """B = 2, 5 greedy requests (rows reused), chunk 8: each request's
    tokens equal the single-stream Engine's on the card."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 500, size=n).tolist()
               for n in (5, 19, 3, 11, 7)]
    want = [engine.greedy_tokens(p, 6) for p in prompts]
    be = BatchedEngine(engine.runner, engine.tokenizer, prefill_chunk=8)
    try:
        handles = [be.submit(p, max_tokens=6, sampler=GREEDY)
                   for p in prompts]
        for h in handles:
            h.text(timeout=300)
    finally:
        be.shutdown()
    assert engine.runner.eager_steps == 0
    for w, h in zip(want, handles):
        eog = [i for i, t in enumerate(w) if engine.tokenizer.is_eog(t)]
        assert h.token_ids == w[:eog[0] if eog else len(w)]
