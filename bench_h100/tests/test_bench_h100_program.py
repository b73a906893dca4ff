"""The readers of the program's own spans (h100bench/program.py): a traced
CPU run of each tiny cell against the harness's own reckoning over the same
steps, the clock mapping against the harness's step notes, the idle
attribution reckoned by hand on a built trace, and a program without the
recorder (a port before it) reading nothing."""

import json
import os
import time
from types import SimpleNamespace

import pytest

from conftest import BENCH, tiny
from h100bench import layers, program
from h100bench.bench import run_cell
from h100bench.serve import Spans
from h100bench.trace import Trace

from llama_gguf_tpu_torch.utils import debug
from llama_gguf_tpu_torch.utils.debug import Span

CELLS = [("tiny-mixtral", "tiny-closed"), ("tiny-moonlight", "tiny-closed")]
NEW = ("grid_fill.prefill", "queue_wait_ms.docqa", "sample_ms.batch",
       "emit_ms.batch", "idle_in_sampling.batch", "idle_in_launch.batch")


def _traced_run(cfg, mix, seed, monkeypatch):
    """A traced CPU run with every metric on; (result, its Context)."""
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            m.pop("workloads", None)
    made = []

    class Recorded(layers.Context):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(layers, "Context", Recorded)
    res, _ = run_cell(BENCH, bench, {"name": "tiny", "chips": 1}, tiny(cfg),
                      tiny(mix), seed, 6.0, True, "cpu", time.monotonic())
    return res, made[0]


@pytest.mark.parametrize("cfg,mix", CELLS)
def test_a_traced_run_reads_the_program_spans(cfg, mix, monkeypatch):
    res, ctx = _traced_run(cfg, mix, 2**31 + 19, monkeypatch)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    p = program.of(ctx)
    # every window step is one of the scheduler's steps
    assert ctx.window_steps and all(s.index in p.steps
                                    for s in ctx.window_steps)
    # the grid's fill, reckoned from the harness's Step.rows and bt
    b = tiny(mix)["max_batch"]
    pre = [s for s in ctx.window_steps if s.bt > 1]
    if pre:
        want = 100.0 * sum(n for s in pre for n, _ in s.rows) / \
            sum(b * s.bt for s in pre)
        assert abs(m["grid_fill.prefill"] - want) <= 0.01
    else:  # every prefill step fell in the slice
        assert "grid_fill.prefill" not in m
    # host readings: the window's steps after the slice, less the first
    host = program.host_steps(ctx)
    last = max(s.index for s in ctx.steps if s.traced)
    assert host and all(s.index > last + 1 for s in host)
    assert {s.index for s in ctx.window_steps if s.index > last + 1} == \
        {s.index for s in host}
    # sampling and emission lie inside the scheduler's host time, as the
    # harness reckons it over the same steps
    assert 0 < m["sample_ms.batch"] and 0 < m["emit_ms.batch"]
    assert m["sample_ms.batch"] + m["emit_ms.batch"] <= \
        1e3 * sum(s.host_s for s in host) / len(host)
    # a short window may submit no request outside the slice: then none
    assert 0 <= m.get("queue_wait_ms.docqa", 0.0) < 1e3
    # no device ops on the CPU: no idle reading
    assert "idle_in_sampling.batch" not in m
    assert "idle_in_launch.batch" not in m
    # the program's stamps on the trace's clock: steady offsets, and each
    # step's runner spans inside its note (the whole notes: the profiler's
    # stop cuts the last one short)
    assert p.offsets and p.offset_mad_us() <= 1e3
    notes = {int(n.rsplit(".", 1)[1]): (a, e) for n, a, e in ctx.trace.notes
             if n.startswith("bench.step.")}
    notes = {i: (a, e) for i, (a, e) in notes.items()
             if e - a >= 1e6 * ctx.steps[i].wall_s}
    checked = 0
    for idx, (a, e) in notes.items():
        _, kids = p.steps[idx]
        for name, spans in kids.items():
            if name.startswith("runner."):
                for s in spans:
                    assert a <= p.to_trace(s.start) <= p.to_trace(s.end) \
                        <= e, (idx, name)
                    checked += 1
    assert checked >= 3 * len(notes)


def _span(i, name, a, b, parent=0, step=0):
    return Span(i, name, int(a * 1e9), int(b * 1e9), parent, step, step,
                None, None)


def _built():
    """Two steps 20 ms apart; on the trace's clock a program second t is
    1e6 t - 9e6 µs. Step k's kernels run 0.5-9.5 ms after its runner.step
    begins, so the one gap between ops spans 9.5-20.5 ms."""
    off = -9e6
    steps = Spans(steps=[(10.0 + 0.02 * k, 10.01 + 0.02 * k, 1,
                          ((1, 100),), 1) for k in (0, 1)])
    ops = [("k", 1e6 * (10.0005 + 0.02 * k) + off,
            1e6 * (10.0095 + 0.02 * k) + off) for k in (0, 1)]
    notes = [(f"bench.step.{k}", 1e6 * (10.0 + 0.02 * k) + off,
              1e6 * (10.01 + 0.02 * k) + off) for k in (0, 1)]
    tr = Trace(ops=ops, notes=notes, window_s=0.04)
    ctx = layers.Context(steps, (9.0, 11.0), tr,
                         SimpleNamespace(t0=9.99, t1=10.03), None)
    spans, i = [], 1
    for k in (0, 1):
        d = 0.02 * k
        top = i
        spans.append(_span(i, "batched.step", 9.999 + d, 10.0125 + d,
                           step=k))
        for name, a, b in (("batched.build", 9.9990, 9.9999),
                           ("runner.inputs", 10.0001, 10.0003),
                           ("runner.replay", 10.0003, 10.0006),
                           ("runner.fetch", 10.0006, 10.0098),
                           ("batched.sample", 10.0100, 10.0110),
                           ("batched.emit", 10.0110, 10.0120)):
            i += 1
            spans.append(_span(i, name, a + d, b + d, parent=top, step=k))
        i += 1
    ctx._program = program.Program(ctx, spans)
    return ctx


def test_idle_attribution_by_hand():
    ctx = _built()
    # the gap 1,009,500-1,020,500 µs holds step 0's sample (1,010,000-
    # 1,011,000) and emit (1,011,000-1,012,000): 2 ms of the 40 ms slice;
    # step 1's inputs (1,020,100-1,020,300) and the first 0.2 ms of its
    # replay (1,020,300-1,020,600): 0.4 ms; step 0's fetch overlaps it by
    # 0.3 ms, counted in neither
    assert program.idle_in_pct(ctx, ("batched.sample", "batched.emit")) == \
        pytest.approx(5.0)
    assert program.idle_in_pct(ctx, ("runner.inputs", "runner.replay")) == \
        pytest.approx(1.0)
    assert program.idle_in_pct(ctx, ("runner.fetch",)) == pytest.approx(0.75)
    assert layers.idle_pct(ctx) == pytest.approx(55.0)
    p = ctx._program
    assert p.offset_mad_us() == pytest.approx(0.0, abs=1e-6)
    # both steps matched, the harness's step inside its batched.step
    assert sorted(p.steps) == [0, 1]
    assert set(p.steps[1][1]) == {"batched.build", "runner.inputs",
                                  "runner.replay", "runner.fetch",
                                  "batched.sample", "batched.emit"}


def test_queue_wait_by_hand():
    """Requests queued and admitted within the host steps (those after the
    slice, the first left out) count; one admitted after them, or queued
    before the slice, in it or in the first step after it, does not."""
    steps = Spans(steps=[(10.0 + 0.02 * k, 10.01 + 0.02 * k, 1,
                          ((1, 100),), 1) for k in range(7)])
    ctx = layers.Context(steps, (9.0, 11.0), None,
                         SimpleNamespace(t0=10.019, t1=10.04), None)
    assert [s.index for s in ctx.window_steps] == [0, 3, 4, 5, 6]
    assert [s.index for s in program.host_steps(ctx)] == [4, 5, 6]
    spans = [_span(1 + k, "batched.step", 9.999 + 0.02 * k,
                   10.0125 + 0.02 * k, step=k) for k in range(7)]
    for i, (t, wait) in enumerate(((10.085, 0.0005), (10.11, 0.0015),
                                   (10.132, 0.005), (10.005, 0.0001),
                                   (10.025, 0.0001), (10.065, 0.0001))):
        spans.append(Span(10 + i, "request.queued", int(t * 1e9),
                          int((t + wait) * 1e9), 0, 0, 1, f"r{i}", None))
    ctx._program = program.Program(ctx, spans)
    assert program.queue_wait_ms(ctx) == pytest.approx(1.0, abs=1e-6)


def test_a_stamp_takes_the_nearest_steps_offset():
    ctx = _built()
    p = ctx._program
    p.offsets = [(10.0, -9e6), (10.02, -9e6 + 4.0)]
    assert p.to_trace(int(10.009e9)) == pytest.approx(1_009_000.0)
    assert p.to_trace(int(10.011e9)) == pytest.approx(1_011_004.0)
    assert p.to_trace(int(12.0e9)) == pytest.approx(3_000_004.0)
    assert p.offset_mad_us() == pytest.approx(2.0)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The parent of the recorder: no ``spans`` in utils/debug, or no
    scheduler span in the ring; every new reader returns None."""
    ctx = _built()
    del ctx._program
    monkeypatch.delattr(debug, "spans")
    for name in NEW:
        assert layers.load_reader(BENCH, name).read(ctx) is None, name
    monkeypatch.undo()
    del ctx._program
    debug.clear_spans()
    for name in NEW:
        assert layers.load_reader(BENCH, name).read(ctx) is None, name
