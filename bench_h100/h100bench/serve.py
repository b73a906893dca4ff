"""The system under test and the measured window.

The engine is wired as the port's server wires it in its serving
configuration: the GGUF loaded in "quant" mode with bf16 scale panels, a
``ModelRunner`` in "default" precision over a bf16 KV cache, an ``Engine``
around it, and a ``BatchedEngine(engine.runner, engine.tokenizer,
max_queue=, prefill_chunk=)``. The window drives ``BatchedEngine.submit``
in this process.

Every request is greedy with the control ids banned through ``logit_bias``
(as ``ignore_eos`` works in other serving benchmarks), so each runs to its
drawn length. Time is the host's monotonic clock: a token is stamped when
the scheduler emits it (a hook on ``RequestHandle._emit``; each token of
this vocabulary is one piece), a request's finish likewise. The loop is
closed: a client resubmits from the finish hook, on the scheduler's thread,
so the next request is queued before the next step and the steps repeat
exactly for a seed.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .traffic import Request, Traffic
from .weights import BANNED


@dataclass
class Rec:
    """One request as the harness saw it."""
    req: Request
    due: float = 0.0  # when it was submitted
    submitted: float | None = None
    refused: bool = False
    request_id: str | None = None
    times: list[float] = field(default_factory=list)
    finished: float | None = None
    reason: str | None = None
    tokens: list[int] = field(default_factory=list)
    handle: Any = None


@dataclass
class Spans:
    """Spans of the traced run: runner.step calls and scheduler steps."""
    steps: list[tuple] = field(default_factory=list)
    engine: list[tuple] = field(default_factory=list)


def load(path: str, spec: dict, device):
    """(engine, batched) in the serving configuration."""
    from llama_gguf_tpu_torch.engine.batched import BatchedEngine
    from llama_gguf_tpu_torch.engine.engine import (Engine, EngineConfig,
                                                    make_runner)
    from llama_gguf_tpu_torch.models.loader import load_model
    from llama_gguf_tpu_torch.tokenizer.gguf_tokenizer import Tokenizer

    config = EngineConfig(max_context_len=spec["max_seq"],
                          max_batch=spec["max_batch"], weight_mode="quant",
                          kv_format="bf16", matmul_precision="default")
    params, cfg, gguf = load_model(path, mode="quant", device=device,
                                   scale_dtype="bfloat16")
    runner = make_runner(params, cfg, config, device)
    engine = Engine(runner, Tokenizer.from_gguf(gguf.metadata), config, gguf)
    batched = BatchedEngine(engine.runner, engine.tokenizer,
                            max_queue=spec["max_queue"],
                            prefill_chunk=spec["prefill_chunk"])
    return engine, batched


def _sleep_until(t: float) -> None:
    delay = t - time.monotonic()
    if delay > 0:
        time.sleep(delay)


class Window:
    """Runs the warm-up and the window over ``batched``."""

    def __init__(self, batched, traffic: Traffic, spec: dict, seconds: float,
                 profile=None, spans: Spans | None = None):
        from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

        self.batched, self.traffic, self.spec = batched, traffic, spec
        self.seconds = seconds
        self.profile, self.spans = profile, spans
        self.sampler = SamplerConfig(temperature=0.0, top_k=0, top_p=1.0,
                                     repetition_penalty=1.0,
                                     logit_bias={t: float("-inf")
                                                 for t in BANNED})
        self.recs: list[Rec] = []
        self.by_id: dict[str, Rec] = {}
        self.emitted: dict[str, list[float]] = {}
        self.resubmit = True
        self.primer_done = threading.Event()
        self.t0 = self.t_end = 0.0
        self.backlog: tuple[int, int] = (0, 0)
        self.window_captures = 0
        self.shutdown_at = float("inf")

    # -- hooks on the scheduler's thread ------------------------------------

    def _on_emit(self, request_id: str) -> None:
        self.emitted.setdefault(request_id, []).append(time.monotonic())

    def _on_finish(self, request_id: str, reason: str) -> None:
        rec = self.by_id.get(request_id)
        now = time.monotonic()
        if rec is None:
            if self.primer_done.is_set():
                return
            self.primer_done.set()  # the primer
            if self.resubmit:
                for _ in range(self.spec["clients"]):
                    self._submit(self.traffic.next(), now)
            return
        rec.finished, rec.reason = now, reason
        if self.resubmit and reason == "length":
            self._submit(self.traffic.next(), time.monotonic())

    def _submit(self, req: Request, due: float) -> Rec:
        rec = Rec(req, due=due)
        rec.submitted = time.monotonic()
        try:
            h = self.batched.submit(req.ids, max_tokens=req.max_tokens,
                                    sampler=self.sampler)
        except RuntimeError:  # the queue is full
            rec.refused = True
        else:
            rec.request_id = h.request_id
            rec.handle = h
            self.by_id[h.request_id] = rec
        self.recs.append(rec)
        return rec

    def install(self):
        """Hook RequestHandle's emit and finish; returns the undo."""
        from llama_gguf_tpu_torch.engine import batched as B

        cls = B.RequestHandle
        emit, finish = cls._emit, cls._finish
        drv = self

        def _emit(self, piece):
            if piece:
                drv._on_emit(self.request_id)
            emit(self, piece)

        def _finish(self, reason):
            finish(self, reason)
            drv._on_finish(self.request_id, reason)

        cls._emit, cls._finish = _emit, _finish

        def undo():
            cls._emit, cls._finish = emit, finish
        return undo

    def wrap_spans(self):
        """Wrap the runner's step and the scheduler's step (the traced run
        only); returns the undo."""
        import torch

        r, b, spans = self.batched.runner, self.batched, self.spans
        step, mixed = r.step, b._mixed_step
        max_seq = r.max_seq

        def traced_step(tokens, positions, lengths, kv, read_bound=None,
                        logit_positions=None, host_rows=None):
            bt = np.shape(tokens)[1]
            with torch.profiler.record_function(
                    f"bench.step.{len(spans.steps)}"):
                t0 = time.monotonic()
                out = step(tokens, positions, lengths, kv,
                           read_bound=read_bound,
                           logit_positions=logit_positions,
                           host_rows=host_rows)
                t1 = time.monotonic()
            pos = np.asarray(positions)
            n = (pos < max_seq).sum(1)
            live = np.nonzero(n)[0]
            rows = tuple(zip(n[live].tolist(), pos[live, 0].tolist()))
            spans.steps.append((t0, t1, bt, rows, len(host_rows or ())))
            return out

        def traced_mixed():
            with torch.profiler.record_function("bench.engine"):
                t0 = time.monotonic()
                did = mixed()
                spans.engine.append((t0, time.monotonic()))
            return did

        r.step, b._mixed_step = traced_step, traced_mixed

        def undo():
            del r.step
            del b._mixed_step
        return undo

    # -- the run -------------------------------------------------------------

    def prime(self) -> None:
        """One request of one token, then, from its finish, the clients'
        first requests."""
        self.batched.submit([3], max_tokens=1, sampler=self.sampler)
        if not self.primer_done.wait(120):
            raise RuntimeError("the primer request did not finish")

    def run(self) -> None:
        spec, batched = self.spec, self.batched
        runner = batched.runner
        self.prime()
        self.t0 = time.monotonic() + spec["warmup_s"]
        self.t_end = self.t0 + self.seconds
        _sleep_until(self.t0)
        caps0 = runner.captures
        self.backlog = (batched.queued_count + batched.active_count, 0)
        if self.profile is not None:  # on this thread: the profiler's own
            first, length = spec["trace_slice"]
            _sleep_until(self.t0 + first * self.seconds)
            self.profile.start()
            time.sleep(length)
            self.profile.stop()
        _sleep_until(self.t_end)
        self.resubmit = False
        self.backlog = (self.backlog[0],
                        batched.queued_count + batched.active_count)
        self.window_captures = runner.captures - caps0
        self._drain()
        self.shutdown_at = time.monotonic()
        batched.shutdown()
        for rec in self.recs:
            if rec.request_id is not None:
                rec.times = self.emitted.get(rec.request_id, [])
                rec.tokens = list(rec.handle.token_ids)
                rec.handle = None

    def _drain(self) -> None:
        """Wait until every request due in the window has its first token
        (or is refused), at most ``drain_s`` past the window."""
        limit = self.t_end + self.spec["drain_s"]
        while time.monotonic() < limit:
            if all(r.refused or r.request_id in self.emitted
                   or r.reason is not None
                   for r in self.recs if self.t0 <= r.due <= self.t_end):
                return
            time.sleep(0.01)
