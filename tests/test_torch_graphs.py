"""The runner's CUDA graphs against its eager steps, on a card.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_graphs.py
"""

import numpy as np
import pytest
import torch

from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.runner import ModelRunner, pick_read_bound
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.models.loader import load_model
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.ops.linear import QuantLinear
from llama_gguf_tpu_torch.quant.quantize import quantize
from llama_gguf_tpu_torch.quant.repack import repack
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

# the eager and the graphed step launch the same kernels on the same
# inputs; the limit allows another cuBLAS algorithm inside the capture
REL_LIMIT = 2e-4
PROMPT = "The quick brown fox jumps over the lazy dog, again and again."


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(params=["tiny", "tiny-moe"])
def engine(request, cuda, tmp_path):
    path = str(tmp_path / f"{request.param}.gguf")
    build_synthetic_gguf(path, preset=request.param, quant=GGMLType.Q4_K)
    params, cfg, gg = load_model(path, device="cuda")
    from llama_gguf_tpu_torch.tokenizer.gguf_tokenizer import Tokenizer

    runner = ModelRunner(params, cfg, max_batch=1, max_seq=1024,
                         device="cuda")
    return Engine(runner, Tokenizer.from_gguf(gg.metadata), EngineConfig(),
                  gg)


def _close(got, want):
    return ((got - want).abs().max() <= REL_LIMIT * want.abs().max()).item()


def _ids(engine, n):
    rng = np.random.default_rng(0)
    return rng.integers(3, engine.runner.cfg.vocab_size, size=n).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 100], ids=["bucket8", "bucket128"])
def test_graphed_step_equals_eager(engine, n):
    """Prefill (a prefill bucket) and decode steps (T = 1): the graphed
    logits against the eager step's on a cache the runner did not make."""
    r = engine.runner
    ids = _ids(engine, n)
    eager_kv = r._make_kv(1)
    want, eager_kv, pos = r.prefill(ids, eager_kv)
    got, kv, pos2 = r.prefill(ids, r.init_kv())
    assert pos == pos2 and kv is r._kv[(1, None)]
    assert _close(got, want)
    tok = int(torch.argmax(want))
    for _ in range(4):
        want, eager_kv = r.decode_one(tok, pos, eager_kv)
        got, kv = r.decode_one(tok, pos, kv)
        assert _close(got, want)
        tok = int(torch.argmax(want))
        pos += 1
    assert (1, 1, 256, False) in r._graphs


@pytest.mark.cuda
def test_graphed_greedy_decode_equals_eager(engine):
    """Across the 256 read bucket: bounds 256, then 512."""
    r = engine.runner
    ids = _ids(engine, 250)
    logits, eager_kv, pos = r.prefill(ids, r._make_kv(1))
    first = torch.argmax(logits)[None].to(torch.int32)
    want, _ = r.greedy_decode(first, [pos], eager_kv, 12)
    _, kv, _ = r.prefill(ids, r.init_kv())
    eager = r.eager_steps
    got, _ = r.greedy_decode(first, [pos], kv, 12)
    assert r.eager_steps == eager
    assert torch.equal(got, want)
    assert ("greedy", 1, 256) in r._graphs and ("greedy", 1, 512) in r._graphs


@pytest.mark.cuda
def test_graphed_tiered_batch_equals_eager(cuda, tmp_path):
    """B = 4, ragged: the (256, 512, 1) tier, graphed against eager."""
    path = str(tmp_path / "tiny.gguf")
    build_synthetic_gguf(path, preset="tiny", quant=GGMLType.Q4_K)
    params, cfg, _ = load_model(path, device="cuda")
    r = ModelRunner(params, cfg, max_batch=4, max_seq=1024, device="cuda")
    rng = np.random.default_rng(1)
    lens = np.asarray([10, 20, 300, 40], np.int32)
    toks = np.zeros((4, 512), np.int32)
    pos = np.full((4, 512), 1024, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)
        pos[i, :n] = np.arange(n)
    outs = []
    for kv in (r._make_kv(4), r.init_kv()):
        logits, kv = r.step(toks, pos, lens, kv, read_bound=512,
                            logit_positions=lens - 1)
        tok0 = torch.argmax(logits[:, 0], -1).to(torch.int32)
        step, kv = r.step(tok0[:, None].cpu(), lens[:, None], lens + 1, kv,
                          read_bound=pick_read_bound(lens + 1, 1024))
        greedy, _ = r.greedy_decode(tok0, lens, kv, 8)
        outs.append((logits, step, greedy))
    assert (4, 1, (256, 512, 1, 1), False) in r._graphs
    for want, got in zip(*outs):
        if want.dtype == torch.int32:
            assert torch.equal(got, want)
        else:
            assert _close(got, want)


def _lin(n, k, seed, dev):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.1
    rw = repack(quantize(w, GGMLType.Q4_K), GGMLType.Q4_K, (n, k))
    return QuantLinear(torch.from_numpy(rw.packed).to(dev),
                       torch.from_numpy(rw.scales).to(dev),
                       torch.from_numpy(rw.mins).to(dev), None, rw.fmt,
                       rw.group, k, n, "Q4_K")


@pytest.mark.cuda
def test_scratch_outlives_a_larger_plan(cuda):
    """Capture a small split-K plan, run a larger one (the workspace grows
    and is replaced), replay the first: it is still right."""
    small, large = _lin(256, 4096, 1, cuda), _lin(8192, 4096, 2, cuda)
    x = torch.randn(1, 4096, device=cuda)
    plan = Q.qmatmul_plan(1, 4096, 256, small.group, "q4", Q._sms(cuda),
                          True)
    big = Q.qmatmul_plan(1, 4096, 8192, large.group, "q4", Q._sms(cuda),
                         True)
    assert plan.splits > 1 and big.scratch_bytes > plan.scratch_bytes
    Q._SCRATCH.clear()
    Q.qmatmul(x, small)  # warm-up: sized for the small plan
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = Q.qmatmul(x, small)
    ws_small = Q._SCRATCH[cuda.index or 0][0]
    Q.qmatmul(x, large)
    assert Q._SCRATCH[cuda.index or 0][0] is not ws_small
    x.copy_(torch.randn(1, 4096, device=cuda))
    g.replay()
    torch.cuda.synchronize()
    assert _close(y, Q.qmatmul_plain(x, small))


@pytest.mark.cuda
def test_scratch_growth_during_capture_raises(cuda):
    lin = _lin(256, 4096, 3, cuda)
    x = torch.randn(1, 4096, device=cuda)
    Q._SCRATCH.clear()
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="not reserved"):
        with torch.cuda.graph(g):
            Q.qmatmul(x, lin)
    Q.qmatmul(x, lin)  # the card is still usable
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_launches_credited_per_replay(engine):
    r = engine.runner
    ids = _ids(engine, 20)
    # the eager step's launches: what one replay must credit
    before = Q.launch_counts()
    logits, kv, pos = r.prefill(ids, r._make_kv(1))
    r.decode_one(5, pos, kv)
    torch.cuda.synchronize()
    eager = Q.launch_counts(since=before)
    # capture both keys, then count three replays of the decode graph
    logits, kv, pos = r.prefill(ids, r.init_kv())
    r.decode_one(5, pos, kv)
    key = (1, 1, 256, False)
    per = r._graphs[key].launches
    assert per[0] and sum(per[0].values()) > 0
    before = Q.launch_counts()
    for i in range(3):
        r.decode_one(5, pos + i, kv)
    assert Q.launch_counts(since=before) == (
        {k: 3 * v for k, v in per[0].items()},
        {k: 3 * v for k, v in per[1].items()})
    prefill = r._graphs[(1, 32, 256, True)].launches
    total = {k: prefill[0].get(k, 0) + per[0].get(k, 0)
             for k in set(prefill[0]) | set(per[0])}
    assert {k: v for k, v in total.items() if v} == eager[0]


@pytest.mark.cuda
def test_foreign_kv_runs_eagerly_and_is_counted(engine):
    r = engine.runner
    ids = _ids(engine, 12)
    n0, keys = r.eager_steps, set(r._graphs)
    logits, kv, pos = r.prefill(ids, r._make_kv(1))
    r.decode_one(int(torch.argmax(logits)), pos, kv)
    r.greedy_decode([1], [pos + 1], kv, 5)
    assert r.eager_steps == n0 + 1 + 1 + 5
    assert set(r._graphs) == keys  # nothing captured
    engine.generate(PROMPT, max_tokens=6,
                    sampler=SamplerConfig(temperature=0.0))
    assert r.eager_steps == n0 + 7  # the engine's own cache: graphs only


@pytest.mark.cuda
def test_generate_twice_same_text(engine):
    greedy = SamplerConfig(temperature=0.0)
    a = engine.generate(PROMPT, max_tokens=12, sampler=greedy)
    b = engine.generate(PROMPT, max_tokens=12, sampler=greedy)
    assert a == b and engine.runner.eager_steps == 0


@pytest.mark.cuda
def test_captured_step_makes_no_host_sync(engine):
    """The eager work that a capture records (the prefill and decode steps
    and a greedy step, on device inputs) under sync debug mode "error": any
    synchronising call raises."""
    r = engine.runner
    kv = r.init_kv()
    dev = r.device
    t = 16
    toks = torch.zeros((1, t), dtype=torch.int32, device=dev)
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None]
    lens = torch.full((1,), t, dtype=torch.int32, device=dev)
    lp = torch.full((1,), t - 1, dtype=torch.int32, device=dev)
    tok = torch.zeros(1, dtype=torch.int32, device=dev)
    p1 = torch.full((1,), t, dtype=torch.int32, device=dev)
    for check in (False, True):  # the first pass builds and sizes
        torch.cuda.synchronize()
        if check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                r._forward(kv, 256, toks, pos, lens, lp)
                r._forward(kv, 256, tok[:, None], p1[:, None], p1 + 1)
                r._decode_body(tok, p1, kv, 256)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
