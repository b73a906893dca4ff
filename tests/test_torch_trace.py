"""The port's spans and step counters (utils/debug.py span, engine/batched.py,
engine/runner.py) on the CPU, over the tiny models of
tests/test_torch_batched.py.

Each scheduler iteration is one ``batched.step`` tree (admit, build, the
runner's inputs / forward / fetch, sample, emit) whose counters match the
arrays the runner was handed; a request's queued, prefill and decode spans
share its request id and tile its life from submit to finish; the ring is
bounded; a span is a record_function region in a profiler trace, and makes
no record_function call with the profiler off."""

import json
import os
import time

import numpy as np
import pytest
import torch

from fixtures import make_tiny_model
from llama_gguf_tpu.gguf.constants import GGMLType

from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils import debug
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
# two prompts longer than the chunk: prefill chunks ride beside decode rows
PROMPTS = ["The quick brown fox", " ".join(f"tok{i}" for i in range(20)),
           "Once upon", "a b c d e f g h i j k l"]
CHILDREN = ["batched.admit", "batched.build", "runner.inputs",
            "runner.forward", "runner.fetch", "batched.sample",
            "batched.emit"]


def _qwen(path):
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                    tokenizer=True, quant=GGMLType.Q8_0)


def _moe(path):
    build_synthetic_gguf(path, preset="tiny-moe", quant=GGMLType.Q4_K,
                         seed=1)


MODELS = {"qwen2": _qwen, "tiny-moe": _moe}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    out = {}
    for name, build in MODELS.items():
        path = str(d / f"{name}.gguf")
        build(path)
        out[name] = Engine.load(path, EngineConfig(weight_mode="quant",
                                                   max_batch=4), device="cpu")
    return out


def _serve(engine, prompts, max_tokens=6, chunk=8, later=()):
    """Serve ``prompts`` at once through a fresh BatchedEngine, then
    ``later`` once each of those has a sampled token, logging the arrays of
    every runner step and what the runner launched. Returns (engine,
    handles, steps' (tokens, positions, runner.last_launch)), the ring
    holding this run's spans alone."""
    r = engine.runner
    be = BatchedEngine(r, engine.tokenizer, max_queue=16,
                       prefill_chunk=chunk)
    step, arrays = r.step, []

    def logged(tokens, positions, *a, **kw):
        out = step(tokens, positions, *a, **kw)
        arrays.append((np.array(tokens), np.array(positions),
                       r.last_launch))
        return out

    debug.clear_spans()
    r.step = logged
    try:
        handles = [be.submit(p, max_tokens=max_tokens, sampler=GREEDY)
                   for p in prompts]
        deadline = time.monotonic() + 240
        while later and not all(h.token_ids or h.done for h in handles):
            assert time.monotonic() < deadline
            time.sleep(0.001)
        handles += [be.submit(p, max_tokens=max_tokens, sampler=GREEDY)
                    for p in later]
        for h in handles:
            h.text(timeout=240)
    finally:
        be.shutdown()
        del r.step
    assert not be._thread.is_alive()
    return be, handles, arrays


@pytest.mark.parametrize("model", list(MODELS))
def test_each_iteration_is_one_step_tree(engines, model):
    be, handles, arrays = _serve(engines[model], PROMPTS)
    spans = debug.spans()
    steps = [s for s in spans if s.name == "batched.step"]
    assert [s.step for s in steps] == list(range(len(arrays)))
    assert all(s.parent == 0 and s.request_id is None for s in steps)
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s.parent, []).append(s)
    for st in steps:
        kids = sorted(by_parent[st.id], key=lambda s: s.start)
        assert [k.name for k in kids] == CHILDREN
        assert all(k.step == k.last_step == st.step for k in kids)
        assert all(st.start <= k.start <= k.end <= st.end for k in kids)
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
        assert not any(k.id in by_parent for k in kids)  # leaves
    # every span of the run is a step, a step's child or a request's
    assert len(spans) == len(steps) * (1 + len(CHILDREN)) + 3 * len(handles)


def _check_counters(be, handles, arrays, max_seq):
    """Each batched.step's counters are the runner's launches and the live
    rows of the arrays it was handed; BatchedStats sums them."""
    steps = sorted((s for s in debug.spans() if s.name == "batched.step"),
                   key=lambda s: s.step)
    launches = [a["prefill_launches"] for _, _, a in arrays]
    launched = [a["rows_launched"] for _, _, a in arrays]
    state = [a["state_rows"] for _, _, a in arrays]
    live = [int((p < max_seq).sum()) for _, p, _ in arrays]
    assert [s.counters["rows_launched"] for s in steps] == launched
    assert [s.counters["prefill_launches"] for s in steps] == launches
    assert [s.counters["state_rows"] for s in steps] == state
    assert [s.counters["rows_real"] for s in steps] == live
    assert sum(launched) == be.stats.rows_launched
    assert sum(launches) == be.stats.prefill_launches
    assert sum(state) == be.stats.state_rows
    assert sum(live) == be.stats.rows_real
    assert all(n <= rows for n, rows in zip(live, launched))
    # a step carries prefill tokens exactly when its bucket is wider than
    # 1, and a launch of them when one of its chunks is
    assert all(s.counters["prefill_rows"] > 0 for s, (t, _, _)
               in zip(steps, arrays) if t.shape[1] > 1)
    assert all(s.counters["prefill_rows"] == 0
               and s.counters["prefill_launches"] == 0
               for s, (t, _, _) in zip(steps, arrays) if t.shape[1] == 1)
    assert all(s.counters["prefill_launches"] > 0 for s, (_, p, _)
               in zip(steps, arrays) if (p[:, 1:] < max_seq).any())
    assert sum(s.counters["prefill_rows"] for s in steps) == \
        be.stats.prefill_tokens == sum(h.prompt_tokens for h in handles)
    assert any(t.shape[1] > 1 for t, _, _ in arrays) and \
        any(t.shape[1] == 1 for t, _, _ in arrays)
    return steps


@pytest.mark.parametrize("model", list(MODELS))
def test_step_counters_match_the_runners_arrays(engines, model):
    be, handles, arrays = _serve(engines[model], PROMPTS)
    _check_counters(be, handles, arrays, engines[model].runner.max_seq)
    # grids one launch holds: the whole b x bt
    assert all(launch == {"prefill_launches": int(t.shape[1] > 1),
                          "rows_launched": t.size, "state_rows": 0}
               for t, _, launch in arrays)


def test_step_counters_read_the_launch_plan(engines):
    """Chunks of 256 beside decode rows at B = 4: the runner launches the
    chunk rows two at a time and the decode step for the rest, and the
    counters read those rows, not the 4 x 256 grid."""
    eng = engines["tiny-moe"]
    rng = np.random.default_rng(5)
    vocab = eng.runner.cfg.vocab_size

    def ids(n):
        return rng.integers(3, vocab, size=n).tolist()

    be, handles, arrays = _serve(eng, [ids(5), ids(9)], max_tokens=12,
                                 chunk=256, later=[ids(150), ids(200)])
    steps = _check_counters(be, handles, arrays, eng.runner.max_seq)
    planned = [(s, t) for s, (t, _, _) in zip(steps, arrays)
               if s.counters["rows_launched"] < t.size]
    assert planned and all(t.shape == (4, 256) for _, t in planned)
    # the two chunk rows in one prefill launch of 2 x 256, and the decode
    # launch's 4 rows
    assert any(s.counters["prefill_launches"] == 1
               and s.counters["rows_launched"] == 2 * 256 + 4
               for s, _ in planned)


def test_request_spans_tile_each_request(engines):
    be, handles, _ = _serve(engines["qwen2"], PROMPTS)
    spans = debug.spans()
    names = ["request.queued", "request.prefill", "request.decode"]
    last = max(s.step for s in spans if s.name == "batched.step")
    for h in handles:
        mine = sorted((s for s in spans if s.request_id == h.request_id),
                      key=lambda s: s.start)
        assert [s.name for s in mine] == names
        assert all(s.parent == 0 for s in mine)
        for a, b in zip(mine, mine[1:]):  # each ends where the next begins
            assert (a.end, a.last_step) == (b.start, b.step)
        assert all(0 <= s.step <= s.last_step <= last for s in mine)
        assert mine[0].step == 0  # all submitted before the first step
        total = sum(s.end - s.start for s in mine)
        assert total == mine[-1].end - mine[0].start
        # on the handle's clock: stamped after it was made, closed after
        # it finished
        assert h.created <= mine[0].start / 1e9
        assert h.finished_at <= mine[-1].end / 1e9
    st = be.stats
    _stats_sum_the_request_spans(st, spans)
    assert st.queue_waits == st.request_prefills == st.request_decodes == \
        len(handles)
    steps = [s for s in spans if s.name == "batched.step"]
    for phase in ("admit", "build", "sample", "emit"):
        assert getattr(st, f"{phase}_time") == pytest.approx(sum(
            s.end - s.start for s in spans
            if s.name == f"batched.{phase}") / 1e9)
    assert 0 < st.runner_time < sum(s.end - s.start for s in steps) / 1e9


def _stats_sum_the_request_spans(stats, spans):
    for name, total, count in (
            ("request.queued", "queue_wait_time", "queue_waits"),
            ("request.prefill", "request_prefill_time", "request_prefills"),
            ("request.decode", "request_decode_time", "request_decodes")):
        mine = [s for s in spans if s.name == name]
        assert getattr(stats, count) == len(mine), name
        assert getattr(stats, total) == pytest.approx(
            sum(s.end - s.start for s in mine) / 1e9), name


def test_an_abort_closes_the_span_it_is_in(engines):
    """Shut down with requests live and queued: each request's spans are
    the first of queued, prefill and decode that it reached, tiling its
    life to the abort, and the stats sum them."""
    engine = engines["qwen2"]
    be = BatchedEngine(engine.runner, engine.tokenizer, max_queue=16,
                       prefill_chunk=8)
    debug.clear_spans()
    handles = [be.submit(p, max_tokens=60, sampler=GREEDY)
               for p in PROMPTS + PROMPTS[:2]]  # two more than the slots
    next(handles[0].stream(timeout=240))  # a token out: decoding begun
    be.shutdown()
    spans = debug.spans()
    names = ["request.queued", "request.prefill", "request.decode"]
    reached = []
    for h in handles:
        assert h.finish_reason in ("aborted", "length", "stop")
        mine = sorted((s for s in spans if s.request_id == h.request_id),
                      key=lambda s: s.start)
        assert [s.name for s in mine] == names[:len(mine)]
        assert all(a.end == b.start for a, b in zip(mine, mine[1:]))
        assert h.finished_at <= mine[-1].end / 1e9
        reached.append(len(mine))
    assert reached[0] == 3 and reached[-1] == 1  # decoding; still queued
    _stats_sum_the_request_spans(be.stats, spans)


def test_handle_timings_are_monotonic(engines):
    _, handles, _ = _serve(engines["qwen2"], PROMPTS[:1])
    h = handles[0]
    assert h.created <= h.first_token_at <= h.finished_at <= time.monotonic()
    t = h.timings
    assert t["total_s"] == round(h.finished_at - h.created, 4)


def test_the_ring_is_bounded():
    debug.clear_spans()
    extra = 10
    for i in range(debug.SPAN_RING + extra):
        debug.record("request.queued", i, i + 1, 0, 0, "r")
    got = debug.spans()
    assert len(got) == debug.SPAN_RING
    assert got[0].start == extra  # the oldest went first
    debug.clear_spans()
    assert debug.spans() == []


def test_spans_nest_and_inherit_the_step():
    debug.clear_spans()
    with debug.span("outer", step=7) as outer:
        with debug.span("inner"):
            pass
        outer.counters = {"rows_real": 1}
        assert debug.current_span() is outer
    assert debug.current_span() is None
    inner, out = debug.spans()
    assert (inner.name, inner.parent, inner.step) == ("inner", outer.id, 7)
    assert (out.parent, out.step, out.counters) == (0, 7, {"rows_real": 1})
    assert out.start <= inner.start <= inner.end <= out.end
    assert outer.seconds == out.seconds == (out.end - out.start) / 1e9


def test_spans_are_record_functions_only_under_the_profiler(
        engines, tmp_path, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _serve(engines["qwen2"], PROMPTS[:2])
    assert calls == []  # the profiler off: no record_function at all
    logdir = str(tmp_path / "prof")
    with debug.profile(logdir):
        _serve(engines["qwen2"], PROMPTS[:2], max_tokens=3)
    assert set(CHILDREN) | {"batched.step"} <= set(calls)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    # the scheduler's thread is traced: its spans are annotations there
    seen = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(CHILDREN) | {"batched.step"} <= seen
