"""The port's OpenAI-compatible server (server/app.py, on http.server) against
the JAX package's (aiohttp) on the CPU: both serve the same tiny GGUF, each
on its own free localhost port, and get the same requests in the same order.

Compared: status codes, JSON bodies and SSE frames after dropping the keys
that name a request or a time (``id``, ``created``, ``timings``,
``loaded_at``); numbers within 1e-4 (logprobs and embeddings: f32, another
order of summation). The model is the qwen2 tiny model of
tests/test_server.py with Q8_0 weights: the port serves it in "quant" mode
(the q8 kernel's plain version), the JAX server in "dequant" mode (the same
dequantized weights). Also the port's client against both servers, the
two settings that raised until they were ported (RAG's ``rag_db`` and the
LoRA adapter), which now load, and both servers on encoder models (BERT,
T5, t5encoder: embeddings only). The /v1/rag/* routes with a knowledge
base: tests/test_torch_rag_server.py."""

import asyncio
import json
import os
import socket
import threading
import time

import pytest
import requests

from fixtures import make_tiny_model
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.server.app import ServerConfig as JServerConfig
from llama_gguf_tpu.server.app import ServerState as JServerState
from llama_gguf_tpu.server.app import create_app

from llama_gguf_tpu_torch.client import RemoteChatClient, RemoteError
from llama_gguf_tpu_torch.server.app import (ServerConfig, ServerState,
                                             run_server)

TOL = 1e-4
DROP = {"id", "created", "timings", "loaded_at"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_healthy(base: str) -> None:
    for _ in range(100):
        try:
            if requests.get(base + "/health", timeout=2).status_code == 200:
                return
        except requests.ConnectionError:
            time.sleep(0.1)
    raise RuntimeError(f"{base} never became healthy")


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srv") / "tiny.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                    tokenizer=True, quant=GGMLType.Q8_0)
    return path


@pytest.fixture(scope="module")
def servers(model_path):
    """((JAX base URL, state), (port base URL, state))."""
    from aiohttp import web

    jcfg = JServerConfig(model_path=model_path, port=_free_port(),
                         max_batch=2, weight_mode="dequant",
                         max_tokens_default=16)
    jstate = JServerState(jcfg)
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(create_app(jstate))

    async def start():
        await runner.setup()
        await web.TCPSite(runner, jcfg.host, jcfg.port).start()

    jthread = threading.Thread(target=loop.run_forever, daemon=True)
    jthread.start()
    asyncio.run_coroutine_threadsafe(start(), loop).result(timeout=30)

    tcfg = ServerConfig(model_path=model_path, port=_free_port(),
                        max_batch=2, weight_mode="quant",
                        max_tokens_default=16, device="cpu")
    tstate = ServerState(tcfg)
    tthread = threading.Thread(target=run_server, args=(tcfg, tstate),
                               daemon=True)
    tthread.start()
    bases = (f"http://{jcfg.host}:{jcfg.port}",
             f"http://{tcfg.host}:{tcfg.port}")
    for base in bases:
        _wait_healthy(base)
    yield (bases[0], jstate), (bases[1], tstate)
    tstate.shutdown()
    tthread.join(timeout=30)
    assert not tthread.is_alive()
    asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(
        timeout=10)
    loop.call_soon_threadsafe(loop.stop)
    jstate.shutdown()


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in DROP}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _same(a, b, where="body"):
    """Equal, numbers within TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            f"{where}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), \
            f"{where}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert not isinstance(a, bool) and not isinstance(b, bool)
        assert abs(a - b) <= TOL, f"{where}: {a} != {b}"
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _call(base, method, path, body=None, raw=None, headers=None):
    """(status, JSON body, or the SSE frames' payloads for a stream)."""
    r = requests.request(method, base + path, json=body, data=raw,
                         headers=headers or {}, timeout=300, stream=True)
    if r.headers.get("Content-Type", "").startswith("text/event-stream"):
        frames = []
        for line in r.iter_lines():
            if line.startswith(b"data: "):
                payload = line[6:]
                frames.append("[DONE]" if payload == b"[DONE]"
                              else json.loads(payload))
        return r.status_code, frames
    if r.headers.get("Content-Type", "").startswith("text/plain"):
        return r.status_code, r.text
    return r.status_code, r.json()


def _both(servers, method, path, body=None, **kw):
    (jbase, _), (tbase, _) = servers
    want = _call(jbase, method, path, body, **kw)
    got = _call(tbase, method, path, body, **kw)
    return got, want


PROMPT = "The quick brown fox"
MESSAGES = [{"role": "user", "content": "Tell me a story"}]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather for a city",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]
GEN = {"max_tokens": 8, "temperature": 0.0}
REQUESTS = {  # name: (method, path, body)
    "health": ("GET", "/health", None),
    "models": ("GET", "/v1/models", None),
    "props": ("GET", "/props", None),
    "queue": ("GET", "/v1/queue", None),
    "completion": ("POST", "/v1/completions", {"prompt": PROMPT, **GEN}),
    "completion_ids": ("POST", "/v1/completions",
                       {"prompt": [5, 17, 42, 99], **GEN}),
    "completion_echo": ("POST", "/v1/completions",
                        {"prompt": PROMPT, "echo": True, **GEN}),
    "completion_n2": ("POST", "/v1/completions",
                      {"prompt": PROMPT, "n": 2, **GEN}),
    "completion_logit_bias": ("POST", "/v1/completions",
                              {"prompt": PROMPT, "logit_bias": {"70": 8.0},
                               **GEN}),
    "completion_logprobs": ("POST", "/v1/completions",
                            {"prompt": PROMPT, "logprobs": 3, **GEN}),
    "completion_stop": ("POST", "/v1/completions",
                        {"prompt": "word " * 30, "stop": ["LL"], **GEN}),
    "completion_stream": ("POST", "/v1/completions",
                          {"prompt": PROMPT, "stream": True, **GEN}),
    "chat": ("POST", "/v1/chat/completions", {"messages": MESSAGES, **GEN}),
    "chat_stream": ("POST", "/v1/chat/completions",
                    {"messages": MESSAGES, "stream": True, **GEN}),
    "chat_logprobs": ("POST", "/v1/chat/completions",
                      {"messages": MESSAGES, "logprobs": True,
                       "top_logprobs": 2, **GEN}),
    "chat_json_object": ("POST", "/v1/chat/completions",
                         {"messages": MESSAGES, "max_tokens": 24,
                          "temperature": 0.0,
                          "response_format": {"type": "json_object"}}),
    "chat_tool_call": ("POST", "/v1/chat/completions",
                       {"messages": MESSAGES, "tools": TOOLS,
                        "tool_choice": "required", "max_tokens": 40,
                        "temperature": 0.0}),
    "embeddings": ("POST", "/v1/embeddings", {"input": ["hello", "world"]}),
    # errors
    "missing_prompt": ("POST", "/v1/completions", {"max_tokens": 4}),
    "missing_messages": ("POST", "/v1/chat/completions", {"messages": []}),
    "missing_input": ("POST", "/v1/embeddings", {}),
    "bad_logit_bias": ("POST", "/v1/completions",
                       {"prompt": "x", "logit_bias": {"a": "b"}}),
    "n2_stream": ("POST", "/v1/completions",
                  {"prompt": "x", "n": 2, "stream": True}),
    "chat_n2_stream": ("POST", "/v1/chat/completions",
                       {"messages": MESSAGES, "n": 2, "stream": True}),
    "rag_search": ("POST", "/v1/rag/search", {"query": "x"}),
    "rag_ingest": ("POST", "/v1/rag/ingest", {"text": "x"}),
    "load_model_missing_path": ("POST", "/v1/internal/load_model", {}),
    "queue_after": ("GET", "/v1/queue", None),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_route_matches_jax(servers, name):
    method, path, body = REQUESTS[name]
    (got_status, got), (want_status, want) = _both(servers, method, path,
                                                   body)
    assert got_status == want_status, (got, want)
    _same(_strip(got), _strip(want))


def test_bad_json_matches_jax(servers):
    for path in ("/v1/completions", "/v1/chat/completions",
                 "/v1/embeddings"):
        got, want = _both(servers, "POST", path, raw=b"{not json",
                          headers={"Content-Type": "application/json"})
        assert got == want == (400, {"error": {
            "message": "invalid JSON body",
            "type": "invalid_request_error"}})


PORT_METRICS = [  # the port's own, after the JAX server's
    "llamagguf_step_rows_real_total", "llamagguf_step_rows_launched_total",
    "llamagguf_step_prefill_launches_total",
    "llamagguf_step_state_rows_total",
    *(f"llamagguf_{span}_seconds_{part}"
      for span in ("queue_wait", "request_prefill", "request_decode")
      for part in ("sum", "count")),
    *(f'llamagguf_step_phase_seconds_total{{phase="{p}"}}'
      for p in ("admit", "build", "runner", "sample", "emit")),
    "llamagguf_graph_captures_total",
    "llamagguf_graph_capture_seconds_total", "llamagguf_graph_pool_bytes"]


def _metric_lines(text):
    return [line.split(" ", 1) for line in text.splitlines()
            if line and not line.startswith("#")]


def test_metrics_match_jax(servers):
    """The JAX server's keys and comment lines, in its order and with its
    values; then exactly the port's own (PORT_METRICS)."""
    (gs, got), (ws, want) = _both(servers, "GET", "/metrics")
    assert gs == ws == 200
    g, w = dict(_metric_lines(got)), dict(_metric_lines(want))
    assert list(g)[:len(w)] == list(w)
    assert list(g)[len(w):] == PORT_METRICS
    want_comments = [x for x in want.splitlines() if x.startswith("#")]
    assert [x for x in got.splitlines()
            if x.startswith("#")][:len(want_comments)] == want_comments
    # the counters of requests and tokens agree; how many steps carried
    # them depends on when each request reached its scheduler, and the
    # rate is a time
    timing = {"llamagguf_decode_steps_total", "llamagguf_mixed_steps_total",
              "llamagguf_decode_tokens_per_second"}
    for key in w.keys() - timing:
        assert g[key] == w[key], key


def test_metrics_counters_move_with_traffic(servers):
    """A completion moves the port's rows, request-span and phase counters;
    on the CPU no graph is captured."""
    (_, _), (tbase, _) = servers

    def read():
        text = requests.get(tbase + "/metrics", timeout=30).text
        return {k: float(v) for k, v in _metric_lines(text)}

    before = read()
    got = _call(tbase, "POST", "/v1/completions", {"prompt": PROMPT, **GEN})
    assert got[0] == 200
    after = read()
    moved = [k for k in PORT_METRICS if after[k] > before[k]]
    # a model without recurrent state carries none by the row map
    assert moved == [k for k in PORT_METRICS[:-3]
                     if k != "llamagguf_step_state_rows_total"]
    # the rows the runner launched: 8 tokens decoded and a prompt
    # prefilled, padding included; the prompt's prefill in one launch
    rows, launched, launches = (
        after[f"llamagguf_step_{k}_total"]
        - before[f"llamagguf_step_{k}_total"]
        for k in ("rows_real", "rows_launched", "prefill_launches"))
    assert GEN["max_tokens"] <= rows < launched
    assert launches == 1
    for span in ("queue_wait", "request_prefill", "request_decode"):
        key = f"llamagguf_{span}_seconds_count"
        assert after[key] == before[key] + 1, key
    for key in PORT_METRICS[-3:]:
        assert after[key] == before[key] == 0, key


def test_api_keys_match_jax(servers):
    (jbase, jstate), (tbase, tstate) = servers
    for st in (jstate, tstate):
        st.config.api_keys = ["sekrit"]
    try:
        body = {"prompt": PROMPT, **GEN}
        for headers in ({}, {"Authorization": "Bearer wrong"}):
            got, want = _both(servers, "POST", "/v1/completions", body,
                              headers=headers)
            assert got == want
            assert got[0] == 401
        got, want = _both(servers, "POST", "/v1/internal/load_model",
                          {"model_path": "x"})
        assert got == want and got[0] == 401
        got, want = _both(servers, "POST", "/v1/completions", body,
                          headers={"Authorization": "Bearer sekrit"})
        assert got[0] == want[0] == 200
        _same(_strip(got[1]), _strip(want[1]))
    finally:
        for st in (jstate, tstate):
            st.config.api_keys = []


def test_full_queue_matches_jax(servers):
    (_, jstate), (_, tstate) = servers
    for st in (jstate, tstate):
        st.batched.max_queue = 0
    try:
        for path, body in (("/v1/completions", {"prompt": "x", **GEN}),
                           ("/v1/chat/completions",
                            {"messages": MESSAGES, **GEN})):
            got, want = _both(servers, "POST", path, body)
            assert got == want == (429, {"error": {
                "message": "request queue full",
                "type": "rate_limit_exceeded"}})
    finally:
        for st in (jstate, tstate):
            st.batched.max_queue = 64


def test_streamed_text_equals_plain(servers):
    (_, _), (tbase, _) = servers
    body = {"prompt": PROMPT, **GEN}
    _, plain = _call(tbase, "POST", "/v1/completions", body)
    _, frames = _call(tbase, "POST", "/v1/completions",
                      {**body, "stream": True})
    assert frames[-1] == "[DONE]"
    assert "".join(f["choices"][0]["text"] for f in frames[:-1]) == \
        plain["choices"][0]["text"]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_client_against_server(servers, which):
    base = servers[0][0] if which == "jax" else servers[1][0]
    c = RemoteChatClient(base, timeout=300)
    assert c.health() == {"status": "ok", "model": "tiny.gguf"}
    assert c.models() == ["tiny.gguf"]
    assert c.queue_status()["max_batch"] == 2
    text = c.complete(PROMPT, **GEN)
    assert text == requests.post(base + "/v1/completions", json={
        "prompt": PROMPT, **GEN}).json()["choices"][0]["text"]
    assert "".join(c.chat_streaming(MESSAGES, **GEN)) == \
        c.chat(MESSAGES, **GEN)
    vecs = c.embed(["hello", "world"])
    assert len(vecs) == 2 and len(vecs[0]) == 64
    with pytest.raises(RemoteError, match="HTTP 400: missing 'prompt'"):
        c._post("/v1/completions", {})


def test_client_results_agree_across_servers(servers):
    (jbase, _), (tbase, _) = servers
    jc, tc = RemoteChatClient(jbase), RemoteChatClient(tbase)
    assert tc.complete(PROMPT, **GEN) == jc.complete(PROMPT, **GEN)
    assert tc.chat(MESSAGES, **GEN) == jc.chat(MESSAGES, **GEN)
    _same(tc.embed("hello"), jc.embed("hello"))


def test_load_model_matches_jax(servers, model_path):
    """Hot reload of the same GGUF: the same reply, then the same
    completion from the new engines."""
    got, want = _both(servers, "POST", "/v1/internal/load_model",
                      {"model_path": model_path})
    assert got == want == (200, {"status": "loaded", "model": "tiny.gguf"})
    got, want = _both(servers, "POST", "/v1/completions",
                      {"prompt": PROMPT, **GEN})
    assert got[0] == want[0] == 200
    _same(_strip(got[1]), _strip(want[1]))
    got, want = _both(servers, "POST", "/v1/internal/load_model",
                      {"model_path": model_path + ".missing"})
    assert got[0] == want[0] == 500
    assert got[1]["error"]["type"] == want[1]["error"]["type"] == \
        "server_error"


@pytest.mark.parametrize("setting,item", [
    ({"rag_db": "kb.sqlite"}, "13"),
    ({"lora": "adapter.gguf"}, "12"),
])
def test_unported_settings_raise(setting, item, model_path, tmp_path):
    """Both settings raised until ROADMAP items 12 (LoRA) and 13 (RAG)
    ported them; now they load. ``rag_db``: the server opens a knowledge
    base on that sqlite file, with the JAX server's feature-hashing
    embedder, and generates with the model it serves. LoRA: the server
    attaches the adapter to its model, and a greedy chat completion over
    HTTP equals the JAX engine's with the same adapter."""
    if "rag_db" in setting:
        from llama_gguf_tpu_torch.rag import HashEmbedder

        db = str(tmp_path / setting["rag_db"])
        state = ServerState(ServerConfig(device="cpu", rag_db=db))
        assert state.kb.store.path == db and state.kb.engine is None
        assert isinstance(state.kb.embedder, HashEmbedder)
        state = ServerState(ServerConfig(model_path=model_path, device="cpu",
                                         max_batch=2, rag_db=db))
        try:
            assert state.kb.engine is state.engine is not None
            assert os.path.exists(db)
        finally:
            state.shutdown()
        return
    from test_torch_lora import shapes_of, write_lora

    from llama_gguf_tpu.engine.engine import Engine as JEngine
    from llama_gguf_tpu.engine.engine import EngineConfig as JEngineConfig
    from llama_gguf_tpu.sampling.sampler import SamplerConfig

    from llama_gguf_tpu_torch.ops.linear import LoraLinear

    adapter = write_lora(str(tmp_path / setting["lora"]), alpha=32.0,
                         seed=3, layers=2, shapes=shapes_of(64, 128))
    state = ServerState(ServerConfig(
        model_path=model_path, port=_free_port(), max_batch=2,
        device="cpu", max_tokens_default=16, **{"lora": adapter}))
    assert isinstance(state.engine.runner.params["layers"][0]["attn"]["wq"],
                      LoraLinear)
    thread = threading.Thread(target=run_server, args=(state.config, state),
                              daemon=True)
    thread.start()
    base = f"http://{state.config.host}:{state.config.port}"
    _wait_healthy(base)
    messages = [{"role": "user", "content": "tok3 tok4 tok5"}]
    try:
        status, body = _call(base, "POST", "/v1/chat/completions", {
            "messages": messages, "max_tokens": 8, "temperature": 0.0})
    finally:
        state.shutdown()
        thread.join(timeout=30)
    assert status == 200
    jeng = JEngine.load(model_path, JEngineConfig(weight_mode="dequant",
                                                  lora=adapter))
    want = jeng.chat(messages, max_tokens=8,
                     sampler=SamplerConfig(temperature=0.0))
    assert body["choices"][0]["message"]["content"] == want


def test_no_model_answers_503():
    state = ServerState(ServerConfig(device="cpu", port=_free_port()))
    thread = threading.Thread(target=run_server, args=(state.config, state),
                              daemon=True)
    thread.start()
    base = f"http://{state.config.host}:{state.config.port}"
    _wait_healthy(base)
    try:
        assert _call(base, "GET", "/health") == (
            200, {"status": "no_model", "model": "unloaded"})
        assert _call(base, "POST", "/v1/completions", {"prompt": "x"}) == (
            503, {"error": {"message": "no model loaded",
                            "type": "service_unavailable"}})
    finally:
        state.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()


def _encoder_model(tmp_path, kind: str) -> str:
    from test_bert_mamba import build_bert_gguf

    from llama_gguf_tpu.utils.synthetic import build_synthetic_t5

    path = str(tmp_path / f"{kind}.gguf")
    if kind == "bert":
        build_bert_gguf(path)
    else:
        build_synthetic_t5(path, decoder=kind == "t5")
    return path


@pytest.mark.parametrize("kind", ["t5encoder", "t5", "bert"])
def test_serve_encoder_only_model(tmp_path, kind):
    """Embeddings-only serving, against the JAX server on the same model:
    /v1/embeddings equal within 1e-4, the generation routes' 400 bodies
    (the encoder-decoder one for T5) word for word, /props and /v1/models
    for a runner-less engine."""
    from aiohttp import web

    path = _encoder_model(tmp_path, kind)
    jcfg = JServerConfig(model_path=path, port=_free_port(), max_batch=2,
                         weight_mode="dequant", warmup=False)
    jstate = JServerState(jcfg)
    loop = asyncio.new_event_loop()
    jrunner = web.AppRunner(create_app(jstate))

    async def start():
        await jrunner.setup()
        await web.TCPSite(jrunner, jcfg.host, jcfg.port).start()

    jthread = threading.Thread(target=loop.run_forever, daemon=True)
    jthread.start()
    asyncio.run_coroutine_threadsafe(start(), loop).result(timeout=60)
    tcfg = ServerConfig(model_path=path, port=_free_port(), max_batch=2,
                        weight_mode="dequant", device="cpu")
    tstate = ServerState(tcfg)
    assert tstate.batched is None
    tthread = threading.Thread(target=run_server, args=(tcfg, tstate),
                               daemon=True)
    tthread.start()
    servers = ((f"http://{jcfg.host}:{jcfg.port}", jstate),
               (f"http://{tcfg.host}:{tcfg.port}", tstate))
    try:
        for base, _ in servers:
            _wait_healthy(base)
        text = "tok3 tok9 tok17" if kind == "bert" else "hello"
        got, want = _both(servers, "POST", "/v1/embeddings",
                          {"input": [text, text + " tok5"]})
        assert got[0] == want[0] == 200, (got, want)
        _same(_strip(got[1]), _strip(want[1]))
        for route, body in (
                ("/v1/chat/completions",
                 {"messages": [{"role": "user", "content": "hi"}]}),
                ("/v1/completions", {"prompt": "hi"})):
            got, want = _both(servers, "POST", route, body)
            assert got == want and got[0] == 400, (got, want)
            assert "generation" in got[1]["error"]["message"]
            assert ("encoder-decoder" in got[1]["error"]["message"]) == \
                (kind != "bert")
        for route in ("/props", "/v1/models", "/health"):
            got, want = _both(servers, "GET", route)
            assert got[0] == want[0] == 200
            _same(_strip(got[1]), _strip(want[1]), route)
    finally:
        tstate.shutdown()
        tthread.join(timeout=30)
        asyncio.run_coroutine_threadsafe(jrunner.cleanup(), loop).result(
            timeout=10)
        loop.call_soon_threadsafe(loop.stop)
        jstate.shutdown()
    assert not tthread.is_alive()
