"""The device trace of a traced run: ``torch.profiler`` (CUPTI) over a slice
of the window, reduced to device operations, the harness's own step
annotations, busy time and idle gaps."""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """Device ops [(name, start µs, end µs)] and the harness's host
    annotations [(name, start µs, end µs)], one timebase."""
    ops: list[tuple[str, float, float]] = field(default_factory=list)
    notes: list[tuple[str, float, float]] = field(default_factory=list)
    window_s: float = 0.0

    @property
    def busy_s(self) -> float:
        """Seconds in which some device op ran (the union of their
        intervals)."""
        busy, end = 0.0, float("-inf")
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        """Idle intervals (µs) between device ops, in time order."""
        out, end = [], None
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and a > end:
                out.append((end, a))
            end = b if end is None else max(end, b)
        return out


class Profile:
    """Starts and stops the profiler from the driving thread."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        # the steps' annotations are made on the scheduler's thread
        from torch._C._profiler import _ExperimentalConfig

        self.prof = profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
        self.prof.start()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.stop()

    def read(self) -> Trace:
        """The trace, read from the profiler's chrome export (a file in
        TMPDIR, removed after)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        tr = Trace(window_s=self.t1 - self.t0)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, a = e.get("cat"), float(e["ts"])
            span = (e["name"], a, a + float(e.get("dur", 0.0)))
            if cat in DEVICE_CATS:
                tr.ops.append(span)
            elif cat == "user_annotation" and e["name"].startswith("bench."):
                tr.notes.append(span)
        return tr
