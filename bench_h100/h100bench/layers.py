"""What the per-layer readers (bench_h100/metrics/<name>.py) read: the
traced run's steps, with their spans and work, and its device trace.

A reader is a module with ``read(ctx) -> float | None``; it returns None
where its cell gives it nothing to read, and the harness then leaves the
metric out. Span readings use the window's steps outside the profiled
slice (the profiler slows the host there); device readings use the slice.
"""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass

from . import kernels


@dataclass
class Step:
    index: int
    t0: float
    t1: float
    bt: int  # the step's T bucket: 1 for a step of decode rows only
    rows: tuple  # (new tokens, first position) of each live row
    head_rows: int
    host_s: float | None = None  # the scheduler's time outside runner.step
    traced: bool = False  # inside the profiled slice

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0


class Context:
    def __init__(self, spans, window: tuple[float, float], trace, profile,
                 work):
        self.work = work
        self.trace = trace
        steps = [Step(i, *s) for i, s in enumerate(spans.steps)]
        if profile is not None:
            for s in steps:
                s.traced = s.t1 >= profile.t0 and s.t0 <= profile.t1
        j = 0
        for a, b in spans.engine:  # one scheduler step holds one runner.step
            while j < len(steps) and steps[j].t0 < a:
                j += 1
            if j < len(steps) and steps[j].t1 <= b:
                steps[j].host_s = (b - a) - steps[j].wall_s
        t0, t1 = window
        self.window_steps = [s for s in steps if s.t0 >= t0 and s.t1 <= t1
                             and not s.traced]
        self.steps = steps
        self._device: dict[int, dict[int, float]] = {}
        if trace is not None:
            self._attribute(trace)

    def _attribute(self, trace) -> None:
        """Device seconds by kernel number (0: any other op) of each step
        whose annotation lies in the trace."""
        notes = sorted((a, b, int(n.rsplit(".", 1)[1]))
                       for n, a, b in trace.notes
                       if n.startswith("bench.step."))
        ops = sorted(trace.ops, key=lambda o: o[1])
        i = 0
        for a, b, idx in notes:
            while i < len(ops) and ops[i][1] < a:
                i += 1
            per = self._device.setdefault(idx, {})
            while i < len(ops) and ops[i][1] <= b:
                k = kernels.kernel_of(ops[i][0]) or 0
                per[k] = per.get(k, 0.0) + (ops[i][2] - ops[i][1]) / 1e6
                i += 1

    def traced_steps(self) -> list[Step]:
        return [self.steps[i] for i in sorted(self._device)
                if i < len(self.steps)]

    def device_s(self, step: Step, kernel_set) -> float:
        per = self._device.get(step.index, {})
        return sum(v for k, v in per.items() if k in kernel_set)


def load_reader(root: str, name: str):
    """bench_h100/metrics/<name>.py as a module."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- helpers the readers share -------------------------------------------------

def mean_ms(xs: list[float]) -> float | None:
    return 1e3 * sum(xs) / len(xs) if xs else None


def roofline_pct(ctx: Context, steps, parts, kernel_set) -> float | None:
    """Share of the bound of ``parts`` of the steps' work in the device
    time of ``kernel_set`` in those steps, in %."""
    from .work import total

    bound = dev = 0.0
    for s in steps:
        d = ctx.device_s(s, kernel_set)
        if d <= 0.0:
            continue
        bound += total(ctx.work.step(s.rows, s.head_rows), parts).bound_s
        dev += d
    return 100.0 * bound / dev if dev > 0.0 else None


def step_mfu_pct(ctx: Context, steps) -> float | None:
    """The bound of the steps' whole work over their wall time, in %."""
    from .work import total

    wall = sum(s.wall_s for s in steps)
    if wall <= 0.0:
        return None
    bound = sum(total(ctx.work.step(s.rows, s.head_rows)).bound_s
                for s in steps)
    return 100.0 * bound / wall


def idle_pct(ctx: Context) -> float | None:
    t = ctx.trace
    if t is None or t.window_s <= 0.0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
