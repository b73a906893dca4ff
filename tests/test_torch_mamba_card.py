"""The Mamba-family slice on a card: kernels 1-3 at Granite-4.0-H-Micro's
shapes against their plain versions, graphed Mamba-family steps against
eager ones (logits and state), the captures' warm-ups, and the batched
engine's reused rows.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_mamba_card.py
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_kernels import make_lin, make_x, rel_err

from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

# f32 sums in another order (kernels); graphed against eager steps: the same
# kernels on the same inputs, another cuBLAS algorithm allowed
REL_LIMIT = 2e-4
# granite-4.0-h-micro-l10 (utils/synthetic.SSM_PRESETS): (name, type, K, N)
# of the products kernels 1-3 run, N of the GLU being 2F
PROJECTIONS = [("ssm_in", GGMLType.Q4_K, 2048, 8512),
               ("ssm_out", GGMLType.Q4_K, 4096, 2048),
               ("qkv", GGMLType.Q4_K, 2048, 2048 + 2 * 512),
               ("o_proj", GGMLType.Q4_K, 2048, 2048),
               ("gate|up", GGMLType.Q4_K, 2048, 2 * 8192),
               ("ffn_down", GGMLType.Q6_K, 8192, 2048),
               ("lm_head", GGMLType.Q6_K, 2048, 100352)]
PRESETS = ["tiny-granitehybrid", "tiny-mamba", "tiny-mamba2", "tiny-lfm2",
           "tiny-jamba", "tiny-falconh1"]
GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)


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
@pytest.mark.parametrize("rows", [1, 8, 128, 512])
@pytest.mark.parametrize("name,t,k,n", PROJECTIONS,
                         ids=[p[0] for p in PROJECTIONS])
def test_projection_kernels_at_granite_shapes(cuda, name, t, k, n, rows):
    glu = name == "gate|up"
    lin = _weight(t, n, k, glu)
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


@pytest.fixture(params=PRESETS)
def engine(request, cuda, tmp_path):
    path = str(tmp_path / f"{request.param}.gguf")
    build_synthetic_gguf(path, preset=request.param, quant=GGMLType.Q4_K)
    return Engine.load(path, EngineConfig(weight_mode="quant", max_batch=2),
                       device="cuda")


def _state(kv):
    return [t.clone() for t in kv["mamba"]["conv"] + kv["mamba"]["ssm"]]


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
    for a, b in zip(_state(kv), _state(eager_kv)):
        if b.numel():
            assert (a - b).abs().max() <= REL_LIMIT * b.abs().max()


@pytest.mark.cuda
def test_capture_warm_ups_leave_state_bit_unchanged(engine):
    """Capturing a new step key (its eager warm-up on dummy inputs, then
    the capture) and a new greedy key leaves every row's Mamba state as it
    was; the greedy graph's replays then continue the eager steps."""
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
    assert all(torch.equal(a, b) for a, b in zip(before, _state(kv)))
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
