"""The DeepSeek-family slice on a card: kernels 1-6 at Moonlight-16B-A3B's
shapes against their plain versions, graphed MLA steps against eager ones,
the context shift under the graphs, and the batched engine's reused rows.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_mla_card.py
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_kernels import make_lin, make_stack, make_x, rel_err

from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.runner import ModelRunner
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

# f32 sums in another order (kernels); graphed against eager steps: the same
# kernels on the same inputs, another cuBLAS algorithm allowed
REL_LIMIT = 2e-4
# moonlight-16b-a3b-l2 (utils/synthetic.MLA_PRESETS): (name, type, K, N) of
# the products kernels 1-3 run, N of a GLU being 2F
PROJECTIONS = [("wq", GGMLType.Q4_K, 2048, 16 * 192),
               ("kv_a", GGMLType.Q4_K, 2048, 512 + 64),
               ("o_proj", GGMLType.Q4_K, 2048, 2048),
               ("gate|up", GGMLType.Q4_K, 2048, 2 * 11264),
               ("shared gate|up", GGMLType.Q4_K, 2048, 2 * 2816),
               ("ffn_down", GGMLType.Q6_K, 11264, 2048),
               ("shared down", GGMLType.Q6_K, 2816, 2048)]
PRESETS = ["tiny-deepseek-v3", "tiny-deepseek-v2-lite", "tiny-moonlight"]
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
@pytest.mark.parametrize("rows", [1, 8, 128])
@pytest.mark.parametrize("name,t,k,n", PROJECTIONS,
                         ids=[p[0] for p in PROJECTIONS])
def test_projection_kernels_at_moonlight_shapes(cuda, name, t, k, n, rows):
    glu = name.endswith("gate|up")
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


@functools.lru_cache(maxsize=None)
def _stacks():
    """8 experts at Moonlight's expert shapes: gate and up Q4_K (q4) 2048
    -> 1408, down Q5_1 (q8: K 1408 is no multiple of 256) 1408 -> 2048."""
    return (make_stack(GGMLType.Q4_K, 8, 1408, 2048, 11, "cuda"),
            make_stack(GGMLType.Q4_K, 8, 1408, 2048, 12, "cuda"),
            make_stack(GGMLType.Q5_1, 8, 2048, 1408, 13, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [6, 768])
def test_moe_kernels_at_moonlight_shapes(cuda, s):
    """A decode step's 6 slots (kernel 4) and a 128-token prefill's 768
    (kernels 5 and 6) on the q4 gate/up and q8 down stacks."""
    gate, up, down = _stacks()
    assert (gate.fmt, down.fmt) == ("q4", "q8")
    idx = torch.from_numpy(np.random.default_rng(s).integers(
        0, 8, size=s).astype(np.int32)).to(cuda)
    x = make_x(s, 2048, 8, cuda)
    act = Q.moe_qmatmul_glu(x, gate, up, idx, "silu")
    if s < Q.MOE_GROUPED_MIN_SLOTS:
        assert act is None  # decode: gate and up run kernel 4 apart
        for st in (gate, up):
            assert rel_err(Q.moe_qmatmul(x, st, idx),
                           Q.moe_qmatmul_plain(x, st, idx)) < REL_LIMIT
        act = Q.moe_qmatmul_glu_plain(x, gate, up, idx, "silu")
    else:
        assert rel_err(act, Q.moe_qmatmul_glu_plain(
            x, gate, up, idx, "silu")) < REL_LIMIT
    got = Q.moe_qmatmul(act, down, idx)
    assert got.shape == (s, 2048)
    assert rel_err(got, Q.moe_qmatmul_plain(act, down, idx)) < REL_LIMIT


@pytest.fixture(params=PRESETS)
def engine(request, cuda, tmp_path):
    path = str(tmp_path / f"{request.param}.gguf")
    build_synthetic_gguf(path, preset=request.param, quant=GGMLType.Q4_K)
    return Engine.load(path, EngineConfig(weight_mode="quant", max_batch=2),
                       device="cuda")


@pytest.mark.cuda
def test_graphed_steps_equal_eager(engine):
    """A prefill and 6 decode steps on the runner's latent cache (graphs)
    against the same steps on a cache it did not make (eager), and the
    latent caches' live positions after them."""
    r = engine.runner
    ids = list(range(3, 40))
    want, eager_kv, pos = r.prefill(ids, r._make_kv(1))
    got, kv, _ = r.prefill(ids, r.init_kv(1))
    assert (got - want).abs().max() <= REL_LIMIT * want.abs().max()
    tok = int(torch.argmax(want))
    for _ in range(6):
        want, eager_kv = r.decode_one(tok, pos, eager_kv)
        got, kv = r.decode_one(tok, pos, kv)
        assert (got - want).abs().max() <= REL_LIMIT * want.abs().max()
        tok, pos = int(torch.argmax(want)), pos + 1
    # the logical cache; the drop slot (index max_seq) takes the padding's
    # and the captures' dummy writes, and no step reads it
    for a, b in zip(kv["k"] + kv["v"], eager_kv["k"] + eager_kv["v"]):
        a, b = a[:, :-1], b[:, :-1]
        assert (a - b).abs().max() <= REL_LIMIT * b.abs().max()


@pytest.mark.cuda
def test_context_shift_under_graphs(engine):
    """Engine.generate past a 64-position window with the context shift:
    the shifts rotate the latents in place, so the captured graphs replay
    on them; the tokens equal the same engine's eager run on a cache of
    its own."""
    base = engine.runner
    runs = []
    for eager in (False, True):
        r = ModelRunner(base.params, base.cfg, max_seq=64, device="cuda")
        eng = Engine(r, engine.tokenizer, EngineConfig(context_shift=True),
                     engine.gguf)
        if eager:  # every step on a cache the runner did not make
            r.init_kv = lambda batch=None, owner=None, r=r: r._make_kv(
                batch or 1)
        text = eng.generate("Hello there", max_tokens=120, sampler=GREEDY)
        assert eng.stats.generated_tokens == 120
        runs.append((text, r.eager_steps))
    assert runs[0][1] == 0 and runs[1][1] > 0
    assert runs[0][0] == runs[1][0]


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
