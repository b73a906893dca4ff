"""What the program records of itself, for the per-layer readers: the port's
spans (``llama_gguf_tpu_torch.utils.debug.spans()``), matched to the traced
run's steps and mapped onto the device trace's clock.

The scheduler records one ``batched.step`` span an iteration, whose
children are ``batched.admit``, ``batched.build``, the runner's
``runner.inputs`` / ``runner.replay`` (or ``runner.capture``,
``runner.forward``) / ``runner.fetch``, ``batched.sample`` and
``batched.emit``; a request records ``request.queued``, ``request.prefill``
and ``request.decode``. Stamps are ``time.monotonic_ns()``, the harness's
clock. A harness step (``layers.Step``, the ``runner.step`` call) belongs
to the ``batched.step`` span around its start.

The device trace has its own clock. Each traced step gives one pair: the
start of its note ``bench.step.N`` (µs) and ``ctx.steps[N].t0`` (s); a
program stamp is mapped by the offset of the pair nearest to it, so a slow
drift between the two clocks does not add up over the slice.

Host readings (``host_steps``) use the window's steps after the profiled
slice, the first of them left out. The profiler's start runs on the driving
thread for seconds before the slice (9-16 s on the card's host: the
process's first torch.profiler start) and takes the GIL from the
scheduler's thread again and again: its sampling spans stretch to 100-190
ms and a step's mean by 3-9 ms. The stop's stall (1-2 s) lands in the
slice's last step or the first after it.

A program that records no spans (a port before the recorder) gives none:
``of(ctx)`` is then None and every reader returns None.
"""

from __future__ import annotations

import bisect
import statistics
import sys

CHILDREN = ("batched.admit", "batched.build", "runner.inputs",
            "runner.capture", "runner.replay", "runner.forward",
            "runner.fetch", "batched.sample", "batched.emit")


class Program:
    """The program's spans of one traced run, beside its ``layers.Context``.

    ``steps``: harness step index -> (its ``batched.step`` span, its
    children by name); ``queued``: ``request.queued`` spans; ``offsets``:
    [(step t0 in s, µs to add to 1e6 x a monotonic second)] of the traced
    steps, in time order."""

    def __init__(self, ctx, spans):
        step_spans = sorted((s for s in spans if s.name == "batched.step"),
                            key=lambda s: s.start)
        starts = [s.start for s in step_spans]
        self.steps: dict[int, tuple] = {}
        by_id = {}
        for st in ctx.steps:
            i = bisect.bisect_right(starts, st.t0 * 1e9) - 1
            if i >= 0 and st.t0 * 1e9 <= step_spans[i].end:
                sp = step_spans[i]
                kids: dict[str, list] = {}
                self.steps[st.index] = (sp, kids)
                by_id[sp.id] = kids
        for s in spans:
            kids = by_id.get(s.parent)
            if kids is not None:
                kids.setdefault(s.name, []).append(s)
        self.queued = [s for s in spans if s.name == "request.queued"]
        self.offsets = []
        if ctx.trace is not None:
            for name, a, _ in sorted(ctx.trace.notes, key=lambda n: n[1]):
                if name.startswith("bench.step."):
                    n = int(name.rsplit(".", 1)[1])
                    if n < len(ctx.steps):
                        t0 = ctx.steps[n].t0
                        self.offsets.append((t0, a - 1e6 * t0))
        self._spans = spans

    def window(self, ctx, host: bool = False) -> list[tuple]:
        """(span, children) of the window's steps outside the slice, or with
        ``host`` of ``host_steps(ctx)``."""
        return [self.steps[s.index]
                for s in (host_steps(ctx) if host else ctx.window_steps)
                if s.index in self.steps]

    def to_trace(self, ns: int) -> float:
        """A monotonic_ns stamp on the device trace's clock (µs)."""
        t = ns / 1e9
        i = bisect.bisect_left(self.offsets, (t,))
        _, off = min(self.offsets[max(i - 1, 0): i + 1],
                     key=lambda p: abs(p[0] - t))
        return 1e6 * t + off

    def offset_mad_us(self) -> float | None:
        """Median absolute deviation of the per-step clock offsets, µs."""
        offs = [o for _, o in self.offsets]
        if len(offs) < 2:
            return None
        med = statistics.median(offs)
        return statistics.median(abs(o - med) for o in offs)

    def in_slice(self, names) -> list[tuple[float, float]]:
        """The spans of ``names`` about the slice (within a second of its
        steps), mapped onto the trace's clock (µs)."""
        if not self.offsets:
            return []
        lo = (self.offsets[0][0] - 1.0) * 1e9
        hi = (self.offsets[-1][0] + 1.0) * 1e9
        return sorted((self.to_trace(s.start), self.to_trace(s.end))
                      for s in self._spans
                      if s.name in names and lo <= s.start and s.end <= hi)


def host_steps(ctx) -> list:
    """The window's steps after the profiled slice but the first one (all
    of them in a run without a slice): those the profiler's start and stop
    do not stall."""
    traced = [s.index for s in ctx.steps if s.traced]
    if not traced:
        return ctx.window_steps
    return [s for s in ctx.window_steps if s.index > traced[-1] + 1]


def of(ctx) -> Program | None:
    """The program's spans of this run, read once a run; None when the
    program records none."""
    if hasattr(ctx, "_program"):
        return ctx._program
    ctx._program = None
    try:
        from llama_gguf_tpu_torch.utils.debug import spans
    except ImportError:
        return None
    got = spans()
    if any(s.name == "batched.step" for s in got):
        ctx._program = Program(ctx, got)
        _report(ctx, ctx._program)
    return ctx._program


def overlap_s(spans, gaps) -> float:
    """Seconds in which some span (µs intervals) and some gap overlap; the
    spans do not overlap one another, nor do the gaps."""
    total, j = 0.0, 0
    gaps = sorted(gaps)
    for a, b in sorted(spans):
        while j < len(gaps) and gaps[j][1] <= a:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < b:
            total += min(b, gaps[k][1]) - max(a, gaps[k][0])
            k += 1
    return total / 1e6


# -- what the readers share ---------------------------------------------------

def phase_ms(ctx, name: str) -> float | None:
    """Mean ms a step of ``host_steps`` spends in its ``name`` children."""
    p = of(ctx)
    steps = p.window(ctx, host=True) if p is not None else []
    if not steps:
        return None
    return 1e3 * sum(sum(c.seconds for c in kids.get(name, ()))
                     for _, kids in steps) / len(steps)


def grid_fill_pct(ctx) -> float | None:
    """Tokens of live rows over the rows launched, in the window's steps
    that carry prefill rows, in %."""
    p = of(ctx)
    steps = [sp.counters for sp, _ in (p.window(ctx) if p else [])
             if sp.counters and sp.counters["prefill_rows"] > 0]
    launched = sum(c["rows_launched"] for c in steps)
    if not launched:
        return None
    return 100.0 * sum(c["rows_real"] for c in steps) / launched


def queue_wait_ms(ctx) -> float | None:
    """Mean ms from submit to admission of the requests queued and admitted
    within ``host_steps``."""
    p = of(ctx)
    steps = p.window(ctx, host=True) if p is not None else []
    if not steps:
        return None
    lo, hi = steps[0][0].start, steps[-1][0].end
    waits = [s.seconds for s in p.queued if lo <= s.start and s.end <= hi]
    return 1e3 * sum(waits) / len(waits) if waits else None


def idle_in_pct(ctx, names) -> float | None:
    """The share of the profiled slice in which no device op ran while the
    scheduler's thread was in a span of ``names``, in %."""
    p = of(ctx)
    t = ctx.trace
    if p is None or t is None or t.window_s <= 0.0 or not t.ops or \
            not p.offsets:
        return None
    return 100.0 * overlap_s(p.in_slice(names), t.gaps()) / t.window_s


def _report(ctx, p: Program) -> None:
    """The run's program spans on stderr: ms a step of ``host_steps`` by
    child, what the children cover, the harness's host time over the same
    steps, the clock offsets' spread, idle by span."""
    steps = p.window(ctx, host=True)
    if steps:
        wall = sum(sp.seconds for sp, _ in steps)
        by = {n: sum(sum(c.seconds for c in kids.get(n, ()))
                     for _, kids in steps) for n in CHILDREN}
        parts = ", ".join(f"{n} {1e3 * v / len(steps):.3f}"
                          for n, v in by.items() if v)
        hs = [s.host_s for s in host_steps(ctx) if s.host_s is not None]
        host = (f"{1e3 * sum(hs) / len(hs):.3f}" if hs else "-")
        print(f"[bench_h100] program: {len(steps)} steps after the slice, "
              f"ms a step: batched.step {1e3 * wall / len(steps):.3f} "
              f"({parts}); children cover "
              f"{100 * sum(by.values()) / wall:.2f}%; the harness's host "
              f"time of the same steps {host}", file=sys.stderr, flush=True)
    mad = p.offset_mad_us()
    t = ctx.trace
    if mad is None or t is None or not t.ops:
        return
    gaps = t.gaps()
    idle = {n: overlap_s(p.in_slice((n,)), gaps) for n in CHILDREN}
    in_steps = overlap_s(p.in_slice(("batched.step",)), gaps)
    parts = ", ".join(f"{n} {v:.4f}" for n, v in idle.items() if v)
    print(f"[bench_h100] program clock: {len(p.offsets)} traced steps, "
          f"offsets' MAD {mad:.2f} us; idle s of the slice by span: "
          f"{parts}, batched.step outside them "
          f"{in_steps - sum(idle.values()):.4f}, outside any step "
          f"{sum(b - a for a, b in gaps) / 1e6 - in_steps:.4f}",
          file=sys.stderr, flush=True)
