"""Continuous batching: one batched step over all active sequences (port of
llama_gguf_tpu/engine/batched.py).

  * one KV cache [L, B, S, H, D] with one batch row per in-flight sequence,
    owned by the engine (``runner.init_kv(max_batch, owner=...)``), so no
    single-stream call on the same runner can zero or overwrite its rows,
  * one step over the whole batch per iteration: prefill chunks of
    ``prefill_chunk`` tokens ride beside decode rows, free rows get position
    ``max_seq`` (the cache's drop slot, models/kv.py), and the LM head runs
    on one position per row. On CUDA each step replays the runner's graph
    of (max_batch, T bucket, read bound, gathered logits), or, for a grid
    wider than one launch, its launch plan: the chunk rows by a row map,
    the rest in the decode graph (engine/runner.py ``step``),
  * a hybrid model's recurrent state carried across a row's prefill chunks
    (padding freezes it) and zeroed when a new sequence takes the row,
  * an optional prompt cache (engine/prompt_cache.py): a new row's longest
    cached prefix is restored into the engine's cache in place at admission,
    so only the rest is prefilled, and a fully prefilled prompt is stored,
  * per-sequence host-side samplers (penalties, grammar masks, seeds),
  * queue-depth admission control, FIFO.

The scheduler thread makes every CUDA call of a step through one
``runner.step(..., host_rows=)``, which hands back the picked rows' logits
on the host (engine/runner.py serializes the device's work).

Spans (utils/debug.py): each scheduler iteration that finds a request
queued or live records one ``batched.step`` (its index ``step``; counters
``rows_real``, the tokens of live rows, ``rows_launched``, the rows the
runner launched, padding included, ``prefill_rows``, the tokens of prefill
chunks, ``prefill_launches``, the runner's launches that carried them, and
``state_rows``, the chunk rows whose recurrent state those launches
carried by the runner's row map; none when admission only reaped
cancelled requests and nothing was
launched) whose children are ``batched.admit``, ``batched.build`` (the
step's arrays and read bound), the runner's spans of its step,
``batched.sample`` (every row's sampler call and logprobs) and
``batched.emit`` (detokenizing, stop strings, the handles' events,
finishing and its callbacks). A request records ``request.queued`` (submit
to admission) when admitted, ``request.prefill`` (admission to its first
sampled token) at that token and ``request.decode`` (to its finish) at its
finish, each with its ``request_id`` and the step indices at its ends; an
abort closes the span it is in. ``BatchedStats`` sums the step phases and
the request spans, and the server's /metrics exports the sums.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np

from ..sampling.sampler import Sampler, SamplerConfig
from ..utils.debug import current_span, record, span
from .runner import ModelRunner, bucket_len, pick_read_bound

log = logging.getLogger(__name__)

# a request's spans, in the order it passes them
REQUEST_SPANS = ("request.queued", "request.prefill", "request.decode")


@dataclass
class BatchedStats:
    """Aggregate scheduler counters."""
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    decode_steps: int = 0
    # steps that carried BOTH prefill-chunk rows and decode rows
    mixed_steps: int = 0
    decode_tokens: int = 0
    # tokens sampled in PURE decode steps: the numerator matching
    # decode_time (mixed steps carry prefill compute)
    decode_tokens_pure: int = 0
    prefill_tokens: int = 0
    # seconds of pure decode steps that replayed graphs they had: a step
    # that captured a new key counts in capture_steps/capture_time instead
    decode_time: float = 0.0
    capture_steps: int = 0
    capture_time: float = 0.0
    # token rows of the steps: those of live requests, and those the
    # runner launched, padding included (runner.last_launch); the prefill
    # launches among its launches; the chunk rows whose recurrent state
    # those launches carried by the runner's row map (a hybrid cache's plan)
    rows_real: int = 0
    rows_launched: int = 0
    prefill_launches: int = 0
    state_rows: int = 0
    # the request spans: seconds summed, and how many ended (queued: submit
    # to admission or abort; prefill: to the first sampled token or abort;
    # decode: to the finish)
    queue_wait_time: float = 0.0
    queue_waits: int = 0
    request_prefill_time: float = 0.0
    request_prefills: int = 0
    request_decode_time: float = 0.0
    request_decodes: int = 0
    # seconds of the steps' phases: admission, the step's arrays, the
    # runner's step, sampling, emission
    admit_time: float = 0.0
    build_time: float = 0.0
    runner_time: float = 0.0
    sample_time: float = 0.0
    emit_time: float = 0.0

    @property
    def decode_tps(self) -> float:
        return (self.decode_tokens_pure / self.decode_time
                if self.decode_time else 0.0)


class _StopBuffer:
    """Holds back text that may be a prefix of a stop pattern."""

    def __init__(self, stop: list[str]):
        self.stop = [s for s in (stop or []) if s]
        self.tail = ""

    def push(self, piece: str) -> tuple[str, bool]:
        """Returns (text safe to emit, hit_stop)."""
        if not self.stop:
            return piece, False
        self.tail += piece
        for s in self.stop:
            i = self.tail.find(s)
            if i >= 0:
                out, self.tail = self.tail[:i], ""
                return out, True
        keep = max((len(s) - 1 for s in self.stop
                    if self.tail.endswith(s[: len(s) - 1])), default=0)
        # also hold back shorter prefixes that end the tail
        for s in self.stop:
            for k in range(min(len(s) - 1, len(self.tail)), 0, -1):
                if self.tail.endswith(s[:k]):
                    keep = max(keep, k)
                    break
        if keep:
            out, self.tail = self.tail[:-keep], self.tail[-keep:]
        else:
            out, self.tail = self.tail, ""
        return out, False

    def flush(self) -> str:
        out, self.tail = self.tail, ""
        return out


@dataclass
class _Sequence:
    request_id: str
    handle: "RequestHandle"
    token_ids: list[int]
    max_tokens: int
    sampler: Sampler
    stop: _StopBuffer
    grammar: Any = None
    logprobs: int = -1    # -1 = off; 0 = sampled token only; N = top-N too
    slot: int = -1
    pos: int = 0          # position of the NEXT token to decode
    last_token: int = 0
    generated: int = 0
    decoder: Any = None
    prefilled: int = 0    # prompt tokens already written to the KV cache
    prompt_len: int = 0
    # the request span it is in (an index of REQUEST_SPANS) and its start,
    # (time.monotonic_ns(), step index)
    phase: int = 0
    since: tuple = (0, 0)

    @property
    def decoding(self) -> bool:
        return self.prefilled >= self.prompt_len


class RequestHandle:
    """Consumer side of one request: a thread-safe event stream.

    Events: ("piece", str) | ("done", finish_reason) | ("error", Exception).
    ``token_ids``: the completion's sampled token ids, in order.
    """

    def __init__(self, request_id: str, prompt_tokens: int = 0):
        self.request_id = request_id
        self.prompt_tokens = prompt_tokens
        self.created = time.monotonic()
        self.first_token_at: float | None = None
        self.finished_at: float | None = None
        self._q: queue.Queue = queue.Queue()
        self.finish_reason: str | None = None
        self.completion_tokens = 0
        self.token_ids: list[int] = []
        self._text_parts: list[str] = []
        # per-token logprob records when requested (OpenAI logprobs):
        # {"token": str, "id": int, "logprob": float,
        #  "top_logprobs": [{"token", "id", "logprob"}, ...]}
        self.logprobs: list[dict] = []
        self.cancelled = False

    def cancel(self) -> None:
        """Ask the scheduler to finish this request at its next step (used
        to reap orphaned submissions, e.g. a partially admitted n>1
        batch)."""
        self.cancelled = True

    @property
    def timings(self) -> dict:
        """Per-request latency metrics."""
        now = self.finished_at or time.monotonic()
        # rate over the decode window, floored at 1 ms so a stop string
        # hitting in the first piece can't report absurd throughput
        window = max(now - (self.first_token_at or self.created), 1e-3)
        return {
            "time_to_first_token_s": round(
                (self.first_token_at or now) - self.created, 4),
            "total_s": round(now - self.created, 4),
            "tokens_per_s": round(self.completion_tokens / window, 2),
        }

    # -- producer (scheduler thread) -----------------------------------------

    def _emit(self, piece: str) -> None:
        if piece:
            if self.first_token_at is None:
                self.first_token_at = time.monotonic()
            self._text_parts.append(piece)
            self._q.put(("piece", piece))

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self.finished_at = time.monotonic()
        self._q.put(("done", reason))

    def _fail(self, exc: Exception) -> None:
        self.finish_reason = "error"
        self._q.put(("error", exc))

    # -- consumer -------------------------------------------------------------

    def stream(self, timeout: float | None = None) -> Iterator[str]:
        """Yield text pieces as they are generated (true token streaming)."""
        while True:
            kind, payload = self._q.get(timeout=timeout)
            if kind == "piece":
                yield payload
            elif kind == "error":
                raise payload
            else:
                return

    def text(self, timeout: float | None = None) -> str:
        for _ in self.stream(timeout=timeout):
            pass
        return "".join(self._text_parts)

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


class BatchedEngine:
    """Continuous-batching scheduler over a ModelRunner: one batched step
    per iteration over every live row."""

    def __init__(self, runner: ModelRunner, tokenizer, max_queue: int = 64,
                 default_sampler: SamplerConfig | None = None,
                 prompt_cache=None, prefill_chunk: int = 512):
        """``prefill_chunk``: long prompts are prefilled in chunks of this
        many tokens interleaved with decode steps, so admitting a long
        prompt never stalls in-flight sequences for its whole prefill.
        ``prompt_cache``: an optional engine.prompt_cache.PromptCache.
        With a ring cache (runner.ring_slots), a step's padded length must
        fit the ring's safe length R - window + 1 (models/kv.write_swa), so
        a larger ``prefill_chunk`` raises here, not inside a step."""
        if runner.ring_slots and bucket_len(prefill_chunk) > runner.ring_safe:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} (padded to "
                f"{bucket_len(prefill_chunk)}) exceeds the SWA ring's safe "
                f"length {runner.ring_safe} (ring {runner.ring_slots}, "
                f"window {runner.cfg.sliding_window}); lower it or make the "
                "runner with swa_ring=False")
        self.runner = runner
        self.prompt_cache = prompt_cache
        self.tokenizer = tokenizer
        self.max_queue = max_queue
        self.default_sampler = default_sampler or SamplerConfig()
        self.prefill_chunk = prefill_chunk
        self.stats = BatchedStats()

        self._pending: queue.Queue[_Sequence] = queue.Queue()
        self._pending_count = 0
        self._slots: list[_Sequence | None] = [None] * runner.max_batch
        self._owner = f"batched-{id(self):x}"
        self._kv = runner.init_kv(runner.max_batch, owner=self._owner)
        self._last_rb = None
        self._step = 0  # the next batched.step's index
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="batched-engine")
        self._thread.start()

    # -- public API ------------------------------------------------------------

    def submit(self, prompt: str | list[int], max_tokens: int = 128,
               sampler: SamplerConfig | None = None,
               stop: list[str] | None = None,
               grammar=None, logprobs: int = -1) -> RequestHandle:
        """Enqueue a generation request; returns a streaming handle.

        Raises RuntimeError when the queue is full (admission control) or
        the engine has been shut down."""
        if not self._running:
            raise RuntimeError("the engine is shut down")
        with self._lock:
            active = sum(s is not None for s in self._slots)
            if self._pending_count + active >= self.max_queue:
                self.stats.rejected += 1
                raise RuntimeError("request queue full")
            self._pending_count += 1

        ids = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
               else list(prompt))
        ids = ids[-(self.runner.max_seq - max_tokens - 1):] if \
            len(ids) + max_tokens >= self.runner.max_seq else ids
        handle = RequestHandle(uuid.uuid4().hex[:16], prompt_tokens=len(ids))
        seq = _Sequence(
            request_id=handle.request_id,
            handle=handle,
            token_ids=ids,
            prompt_len=len(ids),
            max_tokens=max_tokens,
            sampler=Sampler(sampler or self.default_sampler),
            stop=_StopBuffer(stop or []),
            grammar=grammar,
            logprobs=logprobs,
            decoder=self.tokenizer.streaming_decoder(),
            since=(time.monotonic_ns(), self._step),
        )
        with self._lock:  # submit runs on many threads
            self.stats.submitted += 1
        self._pending.put(seq)
        self._wake.set()
        return handle

    def generate(self, prompt: str | list[int], **kw) -> str:
        return self.submit(prompt, **kw).text()

    @property
    def active_count(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def queued_count(self) -> int:
        return self._pending_count

    def shutdown(self, wait: bool = True) -> None:
        """Stop the scheduler (live and queued requests finish "aborted")
        and, once it has stopped, hand the cache back to the runner."""
        self._running = False
        self._wake.set()
        if wait:
            self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- scheduler loop ----------------------------------------------------------

    def _loop(self) -> None:
        while self._running:
            if self._pending.empty() and not self.active_count:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                self._iteration()
            except Exception:
                log.exception("batched engine step failed")
                self._abort_all()
        self._abort_all()
        self.runner.release_kv(self._owner)

    def _iteration(self) -> None:
        """One scheduler iteration: admission, then one batched step; the
        span ``batched.step`` and its children."""
        with span("batched.step", step=self._step):
            with span("batched.admit") as sp:
                self._admit()
            self.stats.admit_time += sp.seconds
            self._mixed_step()
        self._step += 1

    def _abort_all(self) -> None:
        for i, seq in enumerate(self._slots):
            if seq is not None:
                seq.handle._finish("aborted")
                self._end_span(seq)
                self._slots[i] = None
        while True:
            try:
                seq = self._pending.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                self._pending_count -= 1
            seq.handle._finish("aborted")
            self._end_span(seq)

    def _end_span(self, seq: _Sequence) -> None:
        """Record the request span ``seq`` is in, from its start to now, and
        add it to the stats' sums; the next span starts here."""
        t0, s0 = seq.since
        t1, s1 = time.monotonic_ns(), self._step
        record(REQUEST_SPANS[seq.phase], t0, t1, s0, s1, seq.request_id)
        st, dt = self.stats, (t1 - t0) / 1e9
        if seq.phase == 0:
            st.queue_wait_time += dt
            st.queue_waits += 1
        elif seq.phase == 1:
            st.request_prefill_time += dt
            st.request_prefills += 1
        else:
            st.request_decode_time += dt
            st.request_decodes += 1
        seq.phase, seq.since = seq.phase + 1, (t1, s1)

    def _admit(self) -> None:
        """Assign queued sequences to free slots (prefill happens in chunks
        via _mixed_step, decode rows riding in the same step). A hybrid
        model's recurrent state in the slot's row is zeroed first, so the
        sequence does not start from the previous one's (the JAX engine
        leaves it: ROADMAP queue 3). Its K/V rows, scales and ring slots
        need no clearing, as in the JAX engine (models/kv.clear_state)."""
        for slot, cur in enumerate(self._slots):
            if cur is not None:
                continue
            try:
                seq = self._pending.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                self._pending_count -= 1
            if seq.handle.cancelled:  # reaped before admission
                seq.handle._finish("aborted")
                self._end_span(seq)
                continue
            self._end_span(seq)  # request.queued
            self.runner.clear_state(self._kv, slot)
            seq.slot = slot
            if self.prompt_cache is not None:
                seq.prefilled = self.runner.restore_prefix(
                    self.prompt_cache, seq.token_ids, self._kv,
                    batch_idx=slot)
            self._slots[slot] = seq

    def _mixed_step(self) -> bool:
        """ONE batched forward carrying every live row: sequences mid-
        prefill contribute their next chunk (at their own prompt offset)
        and decoding sequences their single next token, so a prefill
        admission costs in-flight decodes no extra step."""
        step = current_span()  # batched.step, when the scheduler's
        with span("batched.build") as sp:
            pre = [s for s in self._slots if s is not None and not s.decoding]
            dec = [s for s in self._slots if s is not None and s.decoding]
            if not pre and not dec:
                return False
            chunks = {
                s.slot: s.token_ids[s.prefilled:
                                    s.prefilled + self.prefill_chunk]
                for s in pre
            }
            bt = bucket_len(max(len(c) for c in chunks.values())) if pre \
                else 1
            b = len(self._slots)
            toks = np.zeros((b, bt), np.int32)
            pos = np.full((b, bt), self.runner.max_seq, np.int32)  # dropped
            lengths = np.zeros((b,), np.int32)
            for s in pre:
                c = chunks[s.slot]
                toks[s.slot, : len(c)] = c
                pos[s.slot, : len(c)] = s.prefilled + np.arange(len(c))
                lengths[s.slot] = s.prefilled + len(c)
            for s in dec:
                toks[s.slot, 0] = s.last_token
                pos[s.slot, 0] = s.pos
                lengths[s.slot] = s.pos + 1

            # the LM head runs on ONE column per row (decode rows column 0,
            # prefill rows their chunk end)
            lp = np.zeros((b,), np.int32)
            for s in pre:
                lp[s.slot] = len(chunks[s.slot]) - 1
            # two-tier ragged read; prev= keeps the last pick (a graph key)
            # while it stays within TIER_HYSTERESIS of the modelled optimum
            rb = pick_read_bound(lengths, self.runner.max_seq,
                                 shards=self.runner.tier_shards,
                                 prev=self._last_rb)
            self._last_rb = rb
            done_pre = [s for s in pre
                        if s.prefilled + len(chunks[s.slot]) >= s.prompt_len]
            need = dec + done_pre
            prefill_rows = sum(len(c) for c in chunks.values())
            real = prefill_rows + len(dec)
        self.stats.build_time += sp.seconds
        t0 = time.monotonic()
        captures = self.runner.captures
        # the one copy to the host: [len(need), V]
        picked, self._kv = self.runner.step(
            toks, pos, lengths, self._kv, read_bound=rb,
            logit_positions=lp, host_rows=[s.slot for s in need])
        dt = time.monotonic() - t0
        self.stats.runner_time += dt
        # what the runner launched: its plan's launches, or the whole grid
        # (a stand-in runner that reports nothing)
        launch = self.runner.last_launch or {
            "prefill_launches": int(bt > 1), "rows_launched": b * bt,
            "state_rows": 0}
        self.stats.rows_real += real
        self.stats.rows_launched += launch["rows_launched"]
        self.stats.prefill_launches += launch["prefill_launches"]
        self.stats.state_rows += launch["state_rows"]
        if step is not None:
            step.counters = {"rows_real": real, "prefill_rows": prefill_rows,
                             **launch}
        if self.runner.captures > captures:
            self.stats.capture_steps += 1
            self.stats.capture_time += dt

        if dec:
            # pure decode steps feed decode_tps; mixed steps carry prefill
            # compute too, so their time is tracked separately, and so is a
            # step's that captured a graph
            if pre:
                self.stats.mixed_steps += 1
            elif self.runner.captures == captures:
                self.stats.decode_time += dt
                self.stats.decode_tokens_pure += len(dec)
            self.stats.decode_steps += 1
        for s in dec:
            s.pos += 1
        for s in done_pre:
            s.pos = s.prompt_len
        with span("batched.sample") as sp:
            sampled = [self._sample(s, picked[i])
                       for i, s in enumerate(need)]
        self.stats.sample_time += sp.seconds
        with span("batched.emit") as sp:
            for s in pre:
                n = len(chunks[s.slot])
                s.prefilled += n
                self.stats.prefill_tokens += n
            if self.prompt_cache is not None:
                for s in done_pre:
                    self.runner.store_prefix(
                        self.prompt_cache, s.token_ids[:s.prompt_len],
                        self._kv, batch_idx=s.slot)
            for s, (tok, entry) in zip(need, sampled):
                self._emit_token(s, tok, entry)
        self.stats.emit_time += sp.seconds
        return True

    def _sample(self, seq: _Sequence, logits: np.ndarray):
        """Sample the next token for one sequence: (token, logprob entry or
        None); (None, None) for a cancelled request."""
        if seq.handle.cancelled:
            return None, None
        mask = (seq.grammar.get_token_mask() if seq.grammar is not None
                else None)
        tok = seq.sampler.sample(logits, seq.token_ids, mask=mask)
        if seq.logprobs < 0 or self.tokenizer.is_eog(tok):
            # no logprob entry for the EOG token: OpenAI aligns
            # logprobs.content 1:1 with the returned completion tokens
            return tok, None
        # OpenAI logprobs: log-softmax of RAW logits
        lf = logits.astype(np.float64)
        lse = np.logaddexp.reduce(lf)
        entry = {"token": self.tokenizer.decode([tok]), "id": int(tok),
                 "logprob": float(lf[tok] - lse)}
        k = min(seq.logprobs, lf.size - 1)  # clamp: kth must be in range
        if k > 0:
            top = np.argpartition(-lf, k)[:k]
            top = top[np.argsort(-lf[top])]
            entry["top_logprobs"] = [
                {"token": self.tokenizer.decode([int(t)]),
                 "id": int(t), "logprob": float(lf[t] - lse)}
                for t in top]
        return tok, entry

    def _emit_token(self, seq: _Sequence, tok, entry) -> None:
        """Emit one sequence's sampled token: text, stop strings, finish."""
        if tok is None:
            self._finish(seq, "aborted")
            return
        if seq.phase == 1:  # its first sampled token
            self._end_span(seq)  # request.prefill
        if self.tokenizer.is_eog(tok):
            self._finish(seq, "stop")
            return
        if entry is not None:
            seq.handle.logprobs.append(entry)
        seq.token_ids.append(tok)
        seq.handle.token_ids.append(int(tok))
        seq.last_token = tok
        seq.generated += 1
        seq.handle.completion_tokens = seq.generated
        self.stats.decode_tokens += 1
        piece = seq.decoder.push(tok)
        if seq.grammar is not None:
            seq.grammar.record_token(self.tokenizer.decode([tok]))
        if piece:
            out, hit = seq.stop.push(piece)
            seq.handle._emit(out)
            if hit:
                self._finish(seq, "stop", flush=False)
                return
        if seq.grammar is not None and seq.grammar.is_complete and \
                seq.grammar.state is not None and \
                seq.grammar.machine.exhausted(seq.grammar.state):
            self._finish(seq, "stop")
            return
        if seq.generated >= seq.max_tokens:
            self._finish(seq, "length")
        elif seq.pos >= self.runner.max_seq - 1:
            self._finish(seq, "length")

    def _finish(self, seq: _Sequence, reason: str, flush: bool = True) -> None:
        if flush:
            seq.handle._emit(seq.stop.flush())
        self._slots[seq.slot] = None
        self.stats.completed += 1
        seq.handle._finish(reason)
        self._end_span(seq)
