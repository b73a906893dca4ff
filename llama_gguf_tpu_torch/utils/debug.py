"""Tracing and profiling (port of llama_gguf_tpu/utils/debug.py).

  * LLAMA_DEBUG activation tracing: the forward prints the RMS of the
    embedding and of each layer's output, in the JAX package's format
    (models/transformer.forward calls ``trace_activation``). The JAX package
    prints from inside its jitted step with jax.debug.print; a CUDA graph
    cannot print, so with the switch on the runner captures no graph and
    every step runs eagerly (engine/runner.py). Off (the default), nothing
    is traced and nothing is synchronized.
  * spans: ``with span(name):`` times a region of the program, always on.
    On exit it appends one tuple to a bounded ring (the last ``SPAN_RING``
    spans of every thread): its id, name, start and end on
    ``time.monotonic_ns()``, the id of the span that encloses it on the
    same thread, the scheduler's step index at both ends and, for a
    request's spans, the request id and, on a step, counters. ``spans()``
    reads the ring; ``clear_spans()`` empties it. A span costs about a
    microsecond and makes no torch call, unless torch.profiler is on: then
    it also opens ``torch.profiler.record_function(name)``, so every span
    lies on the device trace's clock in any trace. The port's spans:

      - ``batched.step`` (engine/batched.py): one scheduler iteration, with
        the counters ``rows_real`` (tokens of live rows), ``rows_launched``
        (rows the runner launched, padding included), ``prefill_rows``
        (tokens of prefill chunks), ``prefill_launches`` (the runner's
        launches that carried them) and ``state_rows`` (the chunk rows whose
        recurrent state those launches carried by the row map); its
        children ``batched.admit``,
        ``batched.build`` (the step's arrays, the read bound),
        ``batched.sample`` (every row's sampler call and logprobs) and
        ``batched.emit`` (detokenizing, stop strings, the handles' events,
        finishing), and the runner's step between build and sample,
      - ``runner.inputs`` (packing and copying the int32 inputs), then
        ``runner.replay`` (a graph; ``runner.capture`` first at a key's
        first step) or ``runner.forward`` (an eager step), then
        ``runner.fetch`` (the picked rows' logits copied to the host)
        (engine/runner.py),
      - ``request.queued`` (submit to admission), ``request.prefill``
        (admission to the first sampled token) and ``request.decode`` (to
        the finish), each recorded at its end (``record``), and summed
        for the server's /metrics.

  * profiling: ``profile(logdir)`` wraps torch.profiler, every thread
    included, and writes a chrome trace there (the JAX package's wraps
    jax.profiler); the spans of every thread appear in it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import tempfile
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

log = logging.getLogger(__name__)

_DEBUG_ACTIVATIONS: bool | None = None


def debug_activations_enabled() -> bool:
    """True when LLAMA_DEBUG is set (read once)."""
    global _DEBUG_ACTIVATIONS
    if _DEBUG_ACTIVATIONS is None:
        _DEBUG_ACTIVATIONS = bool(os.environ.get("LLAMA_DEBUG"))
    return _DEBUG_ACTIVATIONS


def set_debug_activations(value: bool | None) -> None:
    """Force the switch on or off; None reads LLAMA_DEBUG again."""
    global _DEBUG_ACTIVATIONS
    _DEBUG_ACTIVATIONS = value


def trace_activation(tag: str, layer: int, x) -> None:
    """Print the RMS of an activation, in float32, when tracing is on:
    ``[LLAMA_DEBUG] layer {l:>3} {tag}: rms={r:.6f}``."""
    if not debug_activations_enabled():
        return
    rms = float(torch.sqrt(torch.mean(torch.square(x.float()))))
    print(f"[LLAMA_DEBUG] layer {layer:>3} {tag}: rms={rms:.6f}", flush=True)


@contextlib.contextmanager
def profile(logdir: str | None = None):
    """torch.profiler over the block (every thread of the host, and the
    card when there is one); its chrome trace is written to
    ``logdir``/trace.json (default: a directory under the temporary
    directory). Yields ``logdir``."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "llama_gguf_tpu_torch_profile")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    t0 = time.monotonic()
    # every thread's spans: the scheduler's run on its own thread
    prof = torch_profile(activities=acts, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))
    try:
        with prof:
            yield logdir
    finally:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        log.info("profile trace (%.1fs) written to %s", time.monotonic() - t0,
                 logdir)


# -- spans --------------------------------------------------------------------

SPAN_RING = 2 ** 18  # the last ~29,000 scheduler steps, at 9 spans a step

_ring: collections.deque = collections.deque(maxlen=SPAN_RING)
_local = threading.local()
# bound once: a span is on every step's path
_push = _ring.append
_next_id = itertools.count(1).__next__
_now = time.monotonic_ns


class Span(NamedTuple):
    """One recorded span. Times are ``time.monotonic_ns()``; ``parent`` is
    the enclosing span's id on the same thread (0: none); ``step`` and
    ``last_step`` the scheduler's step index at its start and end (-1:
    outside a step)."""
    id: int
    name: str
    start: int
    end: int
    parent: int
    step: int
    last_step: int
    request_id: str | None
    counters: dict | None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """A timed region, recorded on exit: ``with span("runner.replay"):``.
    ``step``: the scheduler's step index (default: the enclosing span's).
    Set ``counters`` (a dict) inside the block to record them with it;
    ``seconds`` reads the duration after the block."""

    __slots__ = ("name", "step", "counters", "id", "parent", "start", "end",
                 "_stack", "_rf")

    def __init__(self, name: str, step: int | None = None):
        self.name, self.step, self.counters = name, step, None

    def __enter__(self) -> "span":
        stack = self._stack = _stack()
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else 0
        if self.step is None:
            self.step = up.step if up is not None else -1
        self.id = _next_id()
        stack.append(self)
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start = _now()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = _now()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._stack.pop()
        _push((self.id, self.name, self.start, self.end, self.parent,
               self.step, self.step, None, self.counters))
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def current_span() -> span | None:
    """The innermost open span of this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def record(name: str, start: int, end: int, step: int, last_step: int,
           request_id: str) -> None:
    """Record a request's span from stamps kept elsewhere (it has no
    enclosing span)."""
    _push((_next_id(), name, start, end, 0, step, last_step, request_id,
           None))


def spans() -> list[Span]:
    """The ring's spans, oldest first."""
    return [Span._make(t) for t in _ring.copy()]


def clear_spans() -> None:
    _ring.clear()
