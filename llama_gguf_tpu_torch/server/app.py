"""OpenAI-compatible HTTP server over the continuous-batching engine (port of
llama_gguf_tpu/server/app.py on the standard library's
``http.server.ThreadingHTTPServer``).

Routes: /health, /metrics (Prometheus text), /props, /v1/models, /v1/queue,
/v1/completions, /v1/chat/completions (SSE streaming, ``n``, ``logprobs``,
``logit_bias``, ``echo``, tools, ``response_format``), /v1/embeddings,
/v1/internal/load_model (hot reload; SIGHUP reloads too) and
/v1/rag/ingest|search|query (with ``rag_db``: a knowledge base on a sqlite
file, embedding with the feature-hashing embedder; 503 without). The JSON
bodies, status codes, error types and SSE frames (``data: {json}\\n\\n``,
then ``data: [DONE]\\n\\n``) are the JAX server's.

Threads: one handler thread per connection does host work only (parse,
tokenize, build grammar tries, write frames); it streams straight from the
request's handle, whose ``stream()`` blocks on a thread-safe queue. The
CUDA calls of the served model (the scheduler's steps, embeddings, the
warm-up) go through the runner, which serializes them and hands back host
arrays (engine/runner.py). A reload loads the new model while the old
scheduler serves on, stops it, then warms up the new engine; requests that
arrive during the warm-up wait for it. The knowledge base generates with
the serving engine and follows it at every reload (the JAX server keeps
the engine it started with); its store serializes the handler threads'
calls (rag/sqlite_store.py).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import signal
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Iterator

import numpy as np

from ..engine.batched import BatchedEngine, RequestHandle
from ..engine.engine import Engine, EngineConfig
from ..engine.prompt_cache import PromptCache
from ..engine.runner import read_bucket
from ..sampling.sampler import SamplerConfig

log = logging.getLogger(__name__)

STREAM_TIMEOUT = 600.0  # seconds a handler waits for its request's events


@dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 8080
    model_path: str | None = None
    max_batch: int = 8
    max_queue: int = 64
    max_tokens_default: int = 512
    weight_mode: str = "quant"
    api_keys: list[str] = field(default_factory=list)
    served_model_name: str | None = None
    rag_db: str | None = None  # sqlite path enabling /v1/rag/* endpoints
    prompt_cache_bytes: int = 0  # > 0: the scheduler's prompt cache budget
    lora: str | None = None  # GGUF LoRA adapter applied at model load
    # capture the first request's graph keys (the 8-token prefill and the
    # decode step) at load time; a failure raises
    warmup: bool = True
    device: str = "cuda"  # "cpu": the plain PyTorch path
    prefill_chunk: int = 512  # prompt tokens per batched step
    max_context_len: int | None = None
    # any of models/kv.FORMATS; Gemma-2/3 keep their sliding-window layers
    # in the ring cache (the server makes no context shift)
    kv_format: str = "f32"
    # mesh axes (EngineConfig.mesh_data / mesh_model): rank 0 serves here
    # and spawns the other ranks (parallel/service.py)
    mesh_data: int = 1
    mesh_model: int = 1


def _refuse_unported(config: ServerConfig) -> None:
    if config.prompt_cache_bytes > 0 and \
            (config.mesh_data, config.mesh_model) != (1, 1):
        raise NotImplementedError(
            "the prompt cache is not supported under a mesh: each rank's "
            "cache holds its own heads and rows (ROADMAP queue 3)")


class ServerState:
    """Model + scheduler, swappable under a lock for hot reload."""

    def __init__(self, config: ServerConfig):
        _refuse_unported(config)
        self.config = config
        self.engine: Engine | None = None
        self.batched: BatchedEngine | None = None
        self.model_name = config.served_model_name or "unloaded"
        self.loaded_at = 0.0
        self.lock = threading.RLock()
        self.kb = None  # /v1/rag/* answers 503 without rag_db
        if config.rag_db:
            from ..rag.knowledge_base import KnowledgeBase
            from ..rag.sqlite_store import SqliteVectorStore

            self.kb = KnowledgeBase(SqliteVectorStore(config.rag_db))
        self.httpd: ThreadingHTTPServer | None = None
        if config.model_path:
            self.load_model(config.model_path)

    def current(self) -> tuple[Engine | None, BatchedEngine | None]:
        """The serving (engine, scheduler); waits while a reload swaps
        them."""
        with self.lock:
            return self.engine, self.batched

    def load_model(self, path: str) -> None:
        """Load ``path`` while the old scheduler goes on serving, stop it
        (what it still holds finishes "aborted"), then warm the new engine
        up and serve it. A failed warm-up raises and leaves no model
        loaded."""
        c = self.config
        if (c.mesh_data, c.mesh_model) != (1, 1):
            # one mesh at a time: its process group and its ranks go first
            self._close_engine()
        engine = Engine.load(path, EngineConfig(
            max_context_len=c.max_context_len, max_batch=c.max_batch,
            weight_mode=c.weight_mode, kv_format=c.kv_format,
            lora=c.lora, mesh_data=c.mesh_data, mesh_model=c.mesh_model),
            device=c.device)
        self.serve_engine(engine, path)

    def _close_engine(self) -> None:
        """Stop the scheduler and close the engine (a mesh's ranks)."""
        with self.lock:
            engine, batched = self.engine, self.batched
            self.engine = self.batched = None
            if self.kb is not None:
                self.kb.engine = None
        if batched is not None:
            batched.shutdown()
        if engine is not None:
            engine.close()

    def serve_engine(self, engine: Engine, path: str) -> None:
        """Serve ``engine``, loaded from ``path``: stop the old scheduler,
        make (and warm up) the new one when the engine has a decoder
        runner, then swap them in."""
        c = self.config
        with self.lock:
            old = self.batched
            self.engine = self.batched = None
            if old is not None:
                old.shutdown()
            batched = None
            # an encoder-only or encoder-decoder model (no decoder runner)
            # serves /v1/embeddings only: no scheduler, no warm-up
            if engine.runner is not None:
                pcache = (PromptCache(max_bytes=c.prompt_cache_bytes)
                          if c.prompt_cache_bytes > 0 else None)
                batched = BatchedEngine(engine.runner, engine.tokenizer,
                                        max_queue=c.max_queue,
                                        prompt_cache=pcache,
                                        prefill_chunk=c.prefill_chunk)
                if c.warmup:
                    try:
                        self._warmup(batched)
                    except BaseException:
                        batched.shutdown()
                        raise
            self.engine, self.batched = engine, batched
            if self.kb is not None:
                # the knowledge base generates with the serving engine
                self.kb.engine = engine
            self.model_name = c.served_model_name or path.rsplit("/", 1)[-1]
            c.model_path = path
            self.loaded_at = time.time()
        log.info("model loaded: %s", self.model_name)

    @staticmethod
    def _warmup(batched: BatchedEngine) -> None:
        """Run (on CUDA: capture) the JAX warm-up's two keys on the
        scheduler's own cache: the 8-token prefill at read bucket 256 with
        gathered logits, and the decode step. Every position is the drop
        slot, so no live row is touched. A failure raises."""
        t0 = time.time()
        runner = batched.runner
        b, drop = runner.max_batch, runner.max_seq
        lengths = np.zeros((b,), np.int32)
        runner.step(np.zeros((b, 8), np.int32),
                    np.full((b, 8), drop, np.int32), lengths, batched._kv,
                    read_bound=read_bucket(2, drop),
                    logit_positions=np.full((b,), 1, np.int32), host_rows=[0])
        runner.step(np.zeros((b, 1), np.int32),
                    np.full((b, 1), drop, np.int32), lengths, batched._kv,
                    read_bound=read_bucket(3, drop), host_rows=[0])
        log.info("warm-up done in %.1fs", time.time() - t0)

    def reload(self) -> None:
        if self.config.model_path:
            self.load_model(self.config.model_path)

    def shutdown(self) -> None:
        """Stop serving: the HTTP server (when run_server hosts it), then
        the scheduler."""
        if self.httpd is not None:
            self.httpd.shutdown()
        engine, batched = self.current()
        if batched is not None:
            batched.shutdown()
        if engine is not None:
            engine.close()  # a mesh's ranks


# ---------------------------------------------------------------------------
# request parsing helpers
# ---------------------------------------------------------------------------


def _sampler_from_request(body: dict) -> SamplerConfig:
    """Raises ValueError on malformed fields (handlers map it to 400)."""
    bias = body.get("logit_bias") or None
    if bias is not None:
        try:
            bias = {int(k): float(v) for k, v in bias.items()}
        except (TypeError, ValueError, AttributeError):
            raise ValueError(
                "logit_bias must map token ids to numeric biases")
    return SamplerConfig(
        logit_bias=bias,
        temperature=float(body.get("temperature", 0.8)),
        top_p=float(body.get("top_p", 0.95)),
        top_k=int(body.get("top_k", 40)),
        min_p=float(body.get("min_p", 0.0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.1)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        seed=body.get("seed"),
    )


def _stop_list(body: dict) -> list[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    return [stop] if isinstance(stop, str) else list(stop)


def _max_tokens(body: dict, default: int) -> int:
    return int(body.get("max_completion_tokens")
               or body.get("max_tokens") or default)


def _logprobs_arg(body: dict) -> int:
    """-1 = off. Chat style: logprobs: bool + top_logprobs: int. Legacy
    completions style: logprobs: int = top-N. Clamped to 20 (the OpenAI
    chat maximum); invalid values are treated as off."""
    lp = body.get("logprobs")
    if lp is None or lp is False:
        return -1
    try:
        if lp is True:
            return min(max(int(body.get("top_logprobs", 0) or 0), 0), 20)
        return min(max(int(lp), 0), 20)
    except (TypeError, ValueError):
        return -1


def _chat_logprobs(handle: RequestHandle) -> dict | None:
    if not handle.logprobs:
        return None
    return {"content": [
        {"token": e["token"], "logprob": e["logprob"],
         "bytes": list(e["token"].encode("utf-8", "replace")),
         "top_logprobs": [
             {"token": t["token"], "logprob": t["logprob"],
              "bytes": list(t["token"].encode("utf-8", "replace"))}
             for t in e.get("top_logprobs", [])]}
        for e in handle.logprobs]}


def _completion_logprobs(handle: RequestHandle,
                         offset_base: int = 0) -> dict | None:
    """``offset_base``: with echo=true the returned text is prompt +
    completion, so text_offset indexes past the prompt."""
    if not handle.logprobs:
        return None
    has_top = any("top_logprobs" in e for e in handle.logprobs)
    offsets, pos = [], offset_base
    for e in handle.logprobs:  # parallel array: start offset of each token
        offsets.append(pos)
        pos += len(e["token"])
    return {
        "tokens": [e["token"] for e in handle.logprobs],
        "token_logprobs": [e["logprob"] for e in handle.logprobs],
        "top_logprobs": [
            {t["token"]: t["logprob"] for t in e.get("top_logprobs", [])}
            for e in handle.logprobs] if has_top else None,
        "text_offset": offsets,
    }


def _sampler_n(body: dict, i: int) -> SamplerConfig:
    """Per-choice sampler for n>1: distinct seeds so choices differ."""
    cfg = _sampler_from_request(body)
    if i and cfg.seed is not None:
        cfg = dataclasses.replace(cfg, seed=cfg.seed + i)
    return cfg


def _timings_sum(handles: list) -> dict:
    """Aggregate per-request timings for n>1: earliest first token, full
    window, total decode throughput across choices."""
    if len(handles) == 1:
        return handles[0].timings
    ts = [h.timings for h in handles]
    return {
        "time_to_first_token_s": min(t["time_to_first_token_s"] for t in ts),
        "total_s": max(t["total_s"] for t in ts),
        "tokens_per_s": round(sum(t["tokens_per_s"] for t in ts), 2),
    }


def _usage_sum(handles: list) -> dict:
    return {
        "prompt_tokens": handles[0].prompt_tokens,
        "completion_tokens": sum(h.completion_tokens for h in handles),
        "total_tokens": handles[0].prompt_tokens
        + sum(h.completion_tokens for h in handles),
    }


def _usage(handle: RequestHandle) -> dict:
    return {
        "prompt_tokens": handle.prompt_tokens,
        "completion_tokens": handle.completion_tokens,
        "total_tokens": handle.prompt_tokens + handle.completion_tokens,
    }


def _tool_call_grammar(tools: list[dict], tool_choice) -> dict | None:
    """Build a JSON schema that constrains output to a valid tool call."""
    if isinstance(tool_choice, dict):
        forced = tool_choice.get("function", {}).get("name")
        tools = [t for t in tools if t["function"]["name"] == forced] or tools
    variants = []
    for t in tools:
        fn = t["function"]
        variants.append({
            "type": "object",
            "properties": {
                "name": {"const": fn["name"]},
                "arguments": fn.get("parameters") or {"type": "object"},
            },
            "required": ["name", "arguments"],
        })
    return {"anyOf": variants} if len(variants) > 1 else variants[0]


def _parse_tool_output(text: str) -> list[dict] | None:
    try:
        d = json.loads(text)
        return [{
            "id": "call_" + uuid.uuid4().hex[:12],
            "type": "function",
            "function": {"name": d["name"],
                         "arguments": json.dumps(d["arguments"])},
        }]
    except Exception:
        return None


def _make_grammar(engine: Engine, schema: dict | None):
    from ..sampling.grammar import json_grammar

    return engine.make_grammar_sampler(json_grammar(schema))


# ---------------------------------------------------------------------------
# replies
# ---------------------------------------------------------------------------


@dataclass
class _Reply:
    status: int
    body: bytes
    content_type: str = "application/json; charset=utf-8"


def _json(obj: Any, status: int = 200) -> _Reply:
    return _Reply(status, json.dumps(obj).encode())


def _err(status: int, message: str,
         etype: str = "invalid_request_error") -> _Reply:
    return _json({"error": {"message": message, "type": etype}}, status)


def _check_auth(state: ServerState, headers) -> bool:
    keys = state.config.api_keys
    if not keys:
        return True
    auth = headers.get("Authorization", "")
    return auth.removeprefix("Bearer ").strip() in keys


class _Request:
    """What a route reads: the headers and the raw body."""

    def __init__(self, headers, raw: bytes):
        self.headers = headers
        self.raw = raw

    def json(self) -> dict:
        """The JSON object of the body; ValueError when it is not one."""
        body = json.loads(self.raw)
        if not isinstance(body, dict):
            raise ValueError("the body is not a JSON object")
        return body


# -- info ---------------------------------------------------------------------


def _health(st: ServerState, req: _Request):
    engine, _ = st.current()
    return _json({"status": "ok" if engine is not None else "no_model",
                  "model": st.model_name})


def _models(st: ServerState, req: _Request):
    _, batched = st.current()
    data = []
    if batched is not None:
        data.append({"id": st.model_name, "object": "model",
                     "created": int(st.loaded_at),
                     "owned_by": "llama_gguf_tpu"})
    return _json({"object": "list", "data": data})


def _queue_status(st: ServerState, req: _Request):
    _, b = st.current()
    return _json({
        "active": b.active_count if b else 0,
        "queued": b.queued_count if b else 0,
        "max_batch": st.config.max_batch,
        "max_queue": st.config.max_queue,
        "stats": {
            "submitted": b.stats.submitted if b else 0,
            "completed": b.stats.completed if b else 0,
            "rejected": b.stats.rejected if b else 0,
            "decode_tokens": b.stats.decode_tokens if b else 0,
        },
    })


def _props(st: ServerState, req: _Request):
    """Model/server properties (llama-server /props analogue); an encoder
    model's config comes from its T5 runner or BERT encoder."""
    engine, batched = st.current()
    cfg = None
    if engine is not None:
        r, t5, enc = engine.runner, engine.t5, engine.encoder
        cfg = (r.cfg if r is not None else t5.cfg if t5 is not None
               else enc.cfg if enc is not None else None)
    return _json({
        "model": st.model_name,
        "arch": cfg.arch if cfg else None,
        "n_ctx": (engine.runner.max_seq
                  if engine is not None and engine.runner
                  else (cfg.max_seq_len if cfg else 0)),
        "n_layers": cfg.num_layers if cfg else 0,
        "n_embd": cfg.hidden_size if cfg else 0,
        "n_vocab": cfg.vocab_size if cfg else 0,
        "max_batch": st.config.max_batch,
        "supports_generation": batched is not None,
        "loaded_at": st.loaded_at,
    })


PHASES = ("admit", "build", "runner", "sample", "emit")  # BatchedStats
# (metric, what it times, BatchedStats' sum and count) of each request span
REQUEST_PHASES = (
    ("queue_wait", "submit to admission", "queue_wait_time", "queue_waits"),
    ("request_prefill", "admission to the first sampled token",
     "request_prefill_time", "request_prefills"),
    ("request_decode", "the first sampled token to the finish",
     "request_decode_time", "request_decodes"))


def _graph_runner(engine):
    """The runner whose CUDA graphs serve ``engine``: the decoder's, or an
    encoder-decoder's T5 runner; None without either."""
    if engine is None:
        return None
    return engine.runner if engine.runner is not None else engine.t5


def _metrics(st: ServerState, req: _Request):
    """Prometheus text exposition (llama-server /metrics analogue)."""
    engine, b = st.current()
    s = b.stats if b else None
    lines = []

    def gauge(name, help_, value, kind="counter"):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")

    gauge("llamagguf_requests_submitted_total",
          "Requests accepted by the scheduler", s.submitted if s else 0)
    gauge("llamagguf_requests_completed_total",
          "Requests finished (any reason)", s.completed if s else 0)
    gauge("llamagguf_requests_rejected_total",
          "Requests rejected by admission control", s.rejected if s else 0)
    gauge("llamagguf_tokens_decoded_total",
          "Tokens sampled across all requests", s.decode_tokens if s else 0)
    gauge("llamagguf_tokens_prefilled_total",
          "Prompt tokens written to the KV cache",
          s.prefill_tokens if s else 0)
    gauge("llamagguf_decode_steps_total",
          "Batched decode steps executed", s.decode_steps if s else 0)
    gauge("llamagguf_mixed_steps_total",
          "Steps carrying both prefill and decode rows",
          s.mixed_steps if s else 0)
    gauge("llamagguf_requests_active", "Requests currently decoding",
          b.active_count if b else 0, "gauge")
    gauge("llamagguf_requests_queued", "Requests waiting for a slot",
          b.queued_count if b else 0, "gauge")
    gauge("llamagguf_decode_tokens_per_second",
          "Pure-decode throughput since start",
          round(s.decode_tps, 3) if s else 0.0, "gauge")
    gauge("llamagguf_model_loaded", "1 when a model is serving",
          int(engine is not None), "gauge")
    # the port's own, after the JAX server's
    gauge("llamagguf_step_rows_real_total",
          "Token rows of live requests in the batched steps",
          s.rows_real if s else 0)
    gauge("llamagguf_step_rows_launched_total",
          "Token rows the batched steps launched, padding included",
          s.rows_launched if s else 0)
    gauge("llamagguf_step_prefill_launches_total",
          "Launches of the batched steps that carried prefill chunks",
          s.prefill_launches if s else 0)
    gauge("llamagguf_step_state_rows_total",
          "Chunk rows whose recurrent state the batched steps' prefill "
          "launches carried by the runner's row map",
          s.state_rows if s else 0)
    # the request spans (engine/batched.py): a sum and a count each
    for name, what, total, count in REQUEST_PHASES:
        gauge(f"llamagguf_{name}_seconds_sum",
              f"Seconds requests spent from {what}",
              round(getattr(s, total), 6) if s else 0.0)
        gauge(f"llamagguf_{name}_seconds_count",
              f"Requests whose time from {what} ended (an abort ends it)",
              getattr(s, count) if s else 0)
    lines.append("# HELP llamagguf_step_phase_seconds_total Seconds of the "
                 "batched steps by phase")
    lines.append("# TYPE llamagguf_step_phase_seconds_total counter")
    for phase in PHASES:
        value = round(getattr(s, f"{phase}_time"), 6) if s else 0.0
        lines.append(f'llamagguf_step_phase_seconds_total{{phase="{phase}"}}'
                     f" {value}")
    r = _graph_runner(engine)
    gauge("llamagguf_graph_captures_total", "CUDA graphs captured",
          r.captures if r else 0)
    gauge("llamagguf_graph_capture_seconds_total",
          "Seconds of CUDA graph warm-up and capture",
          round(r.capture_seconds, 6) if r else 0.0)
    gauge("llamagguf_graph_pool_bytes",
          "Device memory the CUDA graphs' pool reserved",
          r.pool_bytes if r else 0, "gauge")
    return _Reply(200, ("\n".join(lines) + "\n").encode(),
                  "text/plain; charset=utf-8")


# -- generation ---------------------------------------------------------------


def _submit_n(st: ServerState, batched: BatchedEngine, body: dict, prompt,
              stop: list[str], grammars=None):
    """Submit the request's ``n`` choices. Returns (handles, None) or
    (None, an error reply): 400 for malformed sampler fields, 429 when the
    queue is full (partially admitted choices are cancelled)."""
    n = max(int(body.get("n", 1) or 1), 1)
    if n > 1 and body.get("stream"):
        return None, _err(400, "n > 1 is not supported with stream=true")
    handles = []
    try:
        for i in range(n):
            handles.append(batched.submit(
                prompt,
                max_tokens=_max_tokens(body, st.config.max_tokens_default),
                sampler=_sampler_n(body, i), stop=stop,
                grammar=grammars(i) if grammars else None,
                logprobs=_logprobs_arg(body)))
    except ValueError as e:  # malformed sampler fields (logit_bias...)
        for h in handles:
            h.cancel()
        return None, _err(400, str(e))
    except RuntimeError as e:
        for h in handles:  # reap partially admitted n>1 batches
            h.cancel()
        return None, _err(429, str(e), "rate_limit_exceeded")
    return handles, None


def _completions(st: ServerState, req: _Request, engine: Engine,
                 batched: BatchedEngine):
    try:
        body = req.json()
    except ValueError:
        return _err(400, "invalid JSON body")
    prompt = body.get("prompt")
    if prompt is None:
        return _err(400, "missing 'prompt'")
    if isinstance(prompt, list):
        prompt = "".join(prompt) if all(
            isinstance(p, str) for p in prompt) else prompt
    handles, error = _submit_n(st, batched, body, prompt, _stop_list(body))
    if error is not None:
        return error
    handle = handles[0]
    rid = "cmpl-" + uuid.uuid4().hex[:24]
    created = int(time.time())
    if body.get("stream"):
        return _completion_chunks(st, rid, created, handle)
    texts = [h.text(STREAM_TIMEOUT) for h in handles]
    echo_len = 0
    if body.get("echo") and isinstance(prompt, str):
        texts = [prompt + t for t in texts]
        echo_len = len(prompt)
    return _json({
        "id": rid, "object": "text_completion", "created": created,
        "model": st.model_name,
        "choices": [{"index": i, "text": t,
                     "finish_reason": h.finish_reason,
                     "logprobs": _completion_logprobs(h, echo_len)}
                    for i, (t, h) in enumerate(zip(texts, handles))],
        "usage": _usage_sum(handles),
        "timings": _timings_sum(handles),
    })


def _completion_chunks(st, rid, created, handle) -> Iterator[dict]:
    for piece in handle.stream(timeout=STREAM_TIMEOUT):
        yield {
            "id": rid, "object": "text_completion", "created": created,
            "model": st.model_name,
            "choices": [{"index": 0, "text": piece,
                         "finish_reason": None, "logprobs": None}],
        }
    yield {
        "id": rid, "object": "text_completion", "created": created,
        "model": st.model_name,
        # token-level logprobs ride the FINAL chunk (pieces are UTF-8-safe
        # text fragments, not 1:1 with tokens)
        "choices": [{"index": 0, "text": "",
                     "finish_reason": handle.finish_reason,
                     "logprobs": _completion_logprobs(handle)}],
        "usage": _usage(handle),
    }


def _chat_completions(st: ServerState, req: _Request, engine: Engine,
                      batched: BatchedEngine):
    try:
        body = req.json()
    except ValueError:
        return _err(400, "invalid JSON body")
    messages = body.get("messages")
    if not messages:
        return _err(400, "missing 'messages'")

    tools = body.get("tools") or []
    tool_choice = body.get("tool_choice", "auto" if tools else "none")
    response_format = body.get("response_format") or {}
    prompt = engine.chat_template.render(messages, tools=tools or None)

    gram_schema: Any = False  # False = no grammar; None = bare JSON
    forcing_tool = bool(tools) and tool_choice not in ("none", None) and (
        tool_choice == "required" or isinstance(tool_choice, dict))
    if forcing_tool:
        gram_schema = _tool_call_grammar(tools, tool_choice)
    elif response_format.get("type") == "json_object":
        gram_schema = None
    elif response_format.get("type") == "json_schema":
        gram_schema = response_format.get("json_schema", {}).get(
            "schema", {})
    # grammar machines are stateful: each choice gets its own
    grammars = None if gram_schema is False else (
        lambda i: _make_grammar(engine, gram_schema))
    handles, error = _submit_n(
        st, batched, body, prompt,
        _stop_list(body) + list(engine.chat_template.stop), grammars)
    if error is not None:
        return error
    handle = handles[0]
    rid = "chatcmpl-" + uuid.uuid4().hex[:24]
    created = int(time.time())
    if body.get("stream"):
        return _chat_chunks(st, rid, created, handle)

    choices = []
    for i, h in enumerate(handles):
        text = h.text(STREAM_TIMEOUT)
        message: dict[str, Any] = {"role": "assistant", "content": text}
        finish = h.finish_reason
        if forcing_tool:
            calls = _parse_tool_output(text)
            if calls:
                message = {"role": "assistant", "content": None,
                           "tool_calls": calls}
                finish = "tool_calls"
        choices.append({"index": i, "message": message,
                        "finish_reason": finish,
                        "logprobs": _chat_logprobs(h)})
    return _json({
        "id": rid, "object": "chat.completion", "created": created,
        "model": st.model_name,
        "choices": choices,
        "usage": _usage_sum(handles),
        "timings": _timings_sum(handles),
    })


def _chat_chunks(st, rid, created, handle) -> Iterator[dict]:
    yield {
        "id": rid, "object": "chat.completion.chunk", "created": created,
        "model": st.model_name,
        "choices": [{"index": 0, "delta": {"role": "assistant",
                                           "content": ""},
                     "finish_reason": None}],
    }
    for piece in handle.stream(timeout=STREAM_TIMEOUT):
        yield {
            "id": rid, "object": "chat.completion.chunk",
            "created": created, "model": st.model_name,
            "choices": [{"index": 0, "delta": {"content": piece},
                         "finish_reason": None}],
        }
    yield {
        "id": rid, "object": "chat.completion.chunk", "created": created,
        "model": st.model_name,
        # token-level logprobs ride the FINAL chunk (see completions)
        "choices": [{"index": 0, "delta": {},
                     "finish_reason": handle.finish_reason,
                     "logprobs": _chat_logprobs(handle)}],
        "usage": _usage(handle),
    }


def _embeddings(st: ServerState, req: _Request, engine: Engine,
                batched: BatchedEngine):
    try:
        body = req.json()
    except ValueError:
        return _err(400, "invalid JSON body")
    inputs = body.get("input")
    if inputs is None:
        return _err(400, "missing 'input'")
    if isinstance(inputs, str):
        inputs = [inputs]
    data = []
    for i, text in enumerate(inputs):
        try:
            vec = engine.embed(text)
        except NotImplementedError as e:  # a model with no embeddings
            return _err(400, str(e))
        data.append({"object": "embedding", "index": i,
                     "embedding": np.asarray(vec, np.float32).tolist()})
    total = sum(len(engine.tokenizer.encode(t)) for t in inputs)
    return _json({
        "object": "list", "data": data, "model": st.model_name,
        "usage": {"prompt_tokens": total, "total_tokens": total},
    })


# -- admin ----------------------------------------------------------------------


def _load_model(st: ServerState, req: _Request):
    if not _check_auth(st, req.headers):
        return _err(401, "invalid API key", "authentication_error")
    try:
        path = req.json()["model_path"]
    except (ValueError, KeyError):
        return _err(400, "missing 'model_path'")
    try:
        st.load_model(path)
    except Exception as e:
        log.exception("load of %s failed", path)
        return _err(500, f"load failed: {e}", "server_error")
    return _json({"status": "loaded", "model": st.model_name})


def _require_kb(field_name: str):
    """Auth, then 503 without a knowledge base, then the body with its
    required field (else the JAX server's 400) to the route."""
    def wrap(route):
        def wrapped(st: ServerState, req: _Request):
            if not _check_auth(st, req.headers):
                return _err(401, "invalid API key", "authentication_error")
            if st.kb is None:
                return _err(503, "RAG not enabled (set rag_db)",
                            "service_unavailable")
            try:
                body = req.json()
                value = body[field_name]
            except (ValueError, KeyError, TypeError):
                return _err(400, f"missing '{field_name}'")
            return route(st.kb, body, value)
        return wrapped
    return wrap


@_require_kb("text")
def _rag_ingest(kb, body: dict, text):
    n = kb.ingest_text(text, body.get("source", ""), body.get("doc_id"),
                       body.get("chunker"), body.get("metadata"))
    return _json({"chunks": n, "skipped": n == 0})


@_require_kb("query")
def _rag_search(kb, body: dict, query):
    hits = kb.retrieve(query, int(body.get("k", 5)),
                       body.get("search", "hybrid"), body.get("filters"))
    return _json({"results": [
        {"text": h.text, "score": h.score, "source": h.source,
         "doc_id": h.doc_id, "chunk_index": h.chunk_index,
         "metadata": h.metadata} for h in hits]})


@_require_kb("query")
def _rag_query(kb, body: dict, query):
    result = kb.retrieve_and_generate(
        query, int(body.get("k", 5)), body.get("search", "hybrid"),
        body.get("filters"), int(body.get("max_tokens", 256)))
    return _json({
        "answer": result.answer,
        "citations": [{"index": c.index, "source": c.source,
                       "doc_id": c.doc_id, "score": c.score}
                      for c in result.citations]})


def _require_model(route):
    """Auth, then the route on the serving (engine, scheduler), read once
    (a reload may swap them meanwhile)."""
    def wrapped(st: ServerState, req: _Request):
        if not _check_auth(st, req.headers):
            return _err(401, "invalid API key", "authentication_error")
        engine, batched = st.current()
        if engine is None:
            return _err(503, "no model loaded", "service_unavailable")
        return route(st, req, engine, batched)
    return wrapped


def _require_generation(route):
    """``_require_model``, then a 400 for a model without a scheduler (the
    JAX server's bodies, word for word)."""
    def wrapped(st: ServerState, req: _Request, engine: Engine,
                batched: BatchedEngine):
        if batched is None:
            if engine.t5 is not None:
                # encoder-decoder models DO generate, just not through the
                # server's batched scheduler
                return _err(400, "generation for encoder-decoder models"
                                 " is only available via the CLI or the"
                                 " Engine API; this server exposes"
                                 " /v1/embeddings only")
            return _err(400, "this model does not support text "
                             "generation; use /v1/embeddings")
        return route(st, req, engine, batched)
    return _require_model(wrapped)


ROUTES = {
    "GET": {"/health": _health, "/metrics": _metrics, "/props": _props,
            "/v1/models": _models, "/v1/queue": _queue_status},
    "POST": {"/v1/completions": _require_generation(_completions),
             "/v1/chat/completions": _require_generation(_chat_completions),
             "/v1/embeddings": _require_model(_embeddings),
             "/v1/internal/load_model": _load_model,
             "/v1/rag/ingest": _rag_ingest, "/v1/rag/search": _rag_search,
             "/v1/rag/query": _rag_query},
}


class _Handler(BaseHTTPRequestHandler):
    """Dispatches to ROUTES; ``state`` is set on the subclass run_server
    makes."""

    state: ServerState
    server_version = "llama-gguf-tpu-torch"

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def log_message(self, fmt, *args):
        log.debug("%s " + fmt, self.address_string(), *args)

    def _dispatch(self, method: str) -> None:
        path = self.path.split("?", 1)[0]
        route = ROUTES[method].get(path)
        if route is None:
            other = "POST" if method == "GET" else "GET"
            known = path in ROUTES[other]
            self._send(_err(405 if known else 404,
                            f"{method} {path}: "
                            f"{'method not allowed' if known else 'not found'}"))
            return
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        try:
            reply = route(self.state, _Request(self.headers, raw))
        except Exception as e:  # a route's fault: the client gets a 500
            log.exception("%s %s failed", method, path)
            reply = _err(500, f"internal error: {e}", "server_error")
        if isinstance(reply, _Reply):
            self._send(reply)
        else:
            self._send_sse(reply)

    def _send(self, reply: _Reply) -> None:
        self.send_response(reply.status)
        self.send_header("Content-Type", reply.content_type)
        self.send_header("Content-Length", str(len(reply.body)))
        self.end_headers()
        self.wfile.write(reply.body)

    def _send_sse(self, chunks: Iterator[dict]) -> None:
        """Server-sent events: one ``data:`` frame per chunk, then [DONE];
        the connection closes after the last frame."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            for chunk in chunks:
                self.wfile.write(b"data: " + json.dumps(chunk).encode()
                                 + b"\n\n")
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            log.info("client closed the stream")


def run_server(config: ServerConfig,
               state: ServerState | None = None) -> None:
    """Blocking entry point: load the model (unless ``state`` is given),
    then serve until ``state.shutdown()`` or an interrupt. On the main
    thread SIGHUP reloads the model in place; on another thread (a host
    that embeds the server, the tests) there is no signal handler."""
    state = state or ServerState(config)
    handler = type("Handler", (_Handler,), {"state": state})
    httpd = ThreadingHTTPServer((config.host, config.port), handler)
    httpd.daemon_threads = True
    state.httpd = httpd
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGHUP, lambda *_: threading.Thread(
            target=state.reload, daemon=True).start())
    log.info("serving on http://%s:%d", config.host, config.port)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        _, batched = state.current()
        if batched is not None:
            batched.shutdown()
