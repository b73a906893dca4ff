"""Tracing and profiling (port of llama_gguf_tpu/utils/debug.py).

  * LLAMA_DEBUG activation tracing: the forward prints the RMS of the
    embedding and of each layer's output, in the JAX package's format
    (models/transformer.forward calls ``trace_activation``). The JAX package
    prints from inside its jitted step with jax.debug.print; a CUDA graph
    cannot print, so with the switch on the runner captures no graph and
    every step runs eagerly (engine/runner.py). Off (the default), nothing
    is traced and nothing is synchronized.
  * profiling: ``profile(logdir)`` wraps torch.profiler and writes a chrome
    trace there (the JAX package's wraps jax.profiler); ``annotate(name)``
    names a region in it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time

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
    import torch

    rms = float(torch.sqrt(torch.mean(torch.square(x.float()))))
    print(f"[LLAMA_DEBUG] layer {layer:>3} {tag}: rms={rms:.6f}", flush=True)


@contextlib.contextmanager
def profile(logdir: str | None = None):
    """torch.profiler over the block (the host, and the card when there is
    one); its chrome trace is written to ``logdir``/trace.json (default: a
    directory under the temporary directory). Yields ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "llama_gguf_tpu_torch_profile")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    t0 = time.time()
    prof = torch_profile(activities=acts)
    try:
        with prof:
            yield logdir
    finally:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        log.info("profile trace (%.1fs) written to %s", time.time() - t0,
                 logdir)


@contextlib.contextmanager
def annotate(name: str):
    """A named region in profiler timelines (record_function)."""
    import torch

    with torch.profiler.record_function(name):
        yield
