"""The port's /v1/rag/ingest, /search and /query (server/app.py with
``rag_db``) against the JAX package's aiohttp app, run in-process as
tests/test_server.py runs it: both serve the same tiny GGUF, each with its
own knowledge base file, and get the same requests in the same order.

Compared: status codes and JSON bodies, exactly (the feature-hashing
embedder and the store's numpy give bit-equal scores); the model's sampled
answer apart, which a server started without a model replaces by the
stitched context (retrieval-only), so there the whole body is compared. The
JAX server's 400, 401 and 503 bodies. Then the two deliberate differences
(ROADMAP queue 3): the port's knowledge base generates with the serving
engine after a hot reload, where the JAX one keeps its first; and a query
runs beside a chat completion and beside ingests on other threads."""

import asyncio
import threading
from pathlib import Path

import pytest
import requests

from fixtures import make_tiny_model
from test_torch_server import _call, _free_port, _wait_healthy

from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.server.app import ServerConfig as JServerConfig
from llama_gguf_tpu.server.app import ServerState as JServerState
from llama_gguf_tpu.server.app import create_app

from llama_gguf_tpu_torch.server.app import (ServerConfig, ServerState,
                                             run_server)

SURVEY_PART = (Path(__file__).resolve().parents[1] / "SURVEY.md").read_text(
)[:6000]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ragsrv") / "tiny.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=512, seed=11,
                    tokenizer=True, quant=GGMLType.Q8_0)
    return path


class Pair:
    """A JAX server and a port server, started alike."""

    def __init__(self, model_path=None, rag_db=None):
        from aiohttp import web

        self.jcfg = JServerConfig(model_path=model_path, port=_free_port(),
                                  max_batch=2, weight_mode="dequant",
                                  max_tokens_default=8,
                                  rag_db=rag_db and rag_db + ".jax")
        self.jstate = JServerState(self.jcfg)
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(create_app(self.jstate))

        async def start():
            await self.runner.setup()
            await web.TCPSite(self.runner, self.jcfg.host,
                              self.jcfg.port).start()

        threading.Thread(target=self.loop.run_forever, daemon=True).start()
        asyncio.run_coroutine_threadsafe(start(), self.loop).result(
            timeout=30)
        self.tcfg = ServerConfig(model_path=model_path, port=_free_port(),
                                 max_batch=2, weight_mode="quant",
                                 max_tokens_default=8, device="cpu",
                                 rag_db=rag_db and rag_db + ".port")
        self.tstate = ServerState(self.tcfg)
        self.thread = threading.Thread(target=run_server,
                                       args=(self.tcfg, self.tstate),
                                       daemon=True)
        self.thread.start()
        self.jbase = f"http://{self.jcfg.host}:{self.jcfg.port}"
        self.tbase = f"http://{self.tcfg.host}:{self.tcfg.port}"
        for base in (self.jbase, self.tbase):
            _wait_healthy(base)

    def both(self, path, body=None, **kw):
        """((port status, body), (JAX status, body)) of one POST."""
        return (_call(self.tbase, "POST", path, body, **kw),
                _call(self.jbase, "POST", path, body, **kw))

    def close(self):
        self.tstate.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(timeout=10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.jstate.shutdown()


@pytest.fixture(scope="module")
def pairs(model_path, tmp_path_factory):
    d = tmp_path_factory.mktemp("kb")
    out = {"model": Pair(model_path, str(d / "model.db")),
           "retrieval": Pair(None, str(d / "retrieval.db")),
           "no_rag": Pair()}
    yield out
    for pair in out.values():
        pair.close()


INGESTS = [
    {"text": SURVEY_PART, "source": "SURVEY.md", "chunker": "markdown"},
    {"text": SURVEY_PART, "source": "SURVEY.md", "chunker": "markdown"},
    {"text": "the moon orbits the earth. " * 6, "source": "astro.txt",
     "metadata": {"topic": "space"}},
    {"text": "def fn():\n    return 42\n" * 10, "doc_id": "code-1",
     "chunker": "sliding"},
    {"text": "cats sleep on mats. dogs chase cats.", "chunker": "sentence",
     "source": "pets.txt", "metadata": {"topic": "pets", "year": 2024}},
]
SEARCHES = [
    {"query": "moon orbit", "k": 2, "search": "keyword"},
    {"query": "graph capture of the decode step", "k": 3,
     "search": "semantic"},
    {"query": "cats and the moon", "k": 4},
    {"query": "cats", "k": 3, "search": "hybrid",
     "filters": {"topic": {"$in": ["pets", "space"]}}},
    {"query": "return", "search": "keyword", "filters": {"year": 2024}},
]
QUERIES = [
    {"query": "what orbits the earth", "k": 1, "max_tokens": 4,
     "search": "keyword"},
    {"query": "kernels", "k": 2, "max_tokens": 4},
]


@pytest.mark.parametrize("which", ["model", "retrieval"])
def test_rag_routes_match_jax(pairs, which):
    pair = pairs[which]
    for body in INGESTS:
        got, want = pair.both("/v1/rag/ingest", body)
        assert got == want and got[0] == 200
    assert want[1] == {"chunks": 1, "skipped": False}
    assert pair.both("/v1/rag/ingest", INGESTS[0])[0][1] == \
        {"chunks": 0, "skipped": True}
    for body in SEARCHES:
        got, want = pair.both("/v1/rag/search", body)
        assert got == want and got[0] == 200
        assert got[1]["results"] or "filters" in body
    for body in QUERIES:
        got, want = pair.both("/v1/rag/query", body)
        assert got[0] == want[0] == 200
        hits = pair.both("/v1/rag/search", {
            k: v for k, v in body.items() if k != "max_tokens"})[0][1]
        assert [(c["source"], c["doc_id"], c["score"])
                for c in got[1]["citations"]] == \
            [(h["source"], h["doc_id"], h["score"]) for h in hits["results"]]
        if which == "retrieval":  # no model: the stitched context
            assert got == want and got[1]["answer"].startswith("[1] ")
        else:
            assert got[1]["citations"] == want[1]["citations"]
            assert isinstance(got[1]["answer"], str)


@pytest.mark.parametrize("path,body,raw", [
    ("/v1/rag/ingest", {}, None),
    ("/v1/rag/ingest", {"source": "x"}, None),
    ("/v1/rag/search", {}, None),
    ("/v1/rag/query", {"k": 2}, None),
    ("/v1/rag/search", None, b"{not json"),
    ("/v1/rag/ingest", None, b"[1, 2]"),
])
@pytest.mark.parametrize("which", ["model", "no_rag"])
def test_rag_errors_match_jax(pairs, which, path, body, raw):
    """400 for a missing field or a bad body with a knowledge base, 503
    without one: the JAX server's status and body."""
    headers = {"Content-Type": "application/json"} if raw else None
    got, want = pairs[which].both(path, body, raw=raw, headers=headers)
    assert got == want
    assert got[0] == (400 if which == "model" else 503)


@pytest.mark.parametrize("path", ["/v1/rag/ingest", "/v1/rag/search",
                                  "/v1/rag/query"])
def test_rag_api_keys_match_jax(pairs, path):
    pair = pairs["retrieval"]
    for st in (pair.jstate, pair.tstate):
        st.config.api_keys = ["sekrit"]
    try:
        body = {"text": "keyed text", "query": "keyed", "source": "k.txt"}
        got, want = pair.both(path, body)
        assert got == want and got[0] == 401
        got, want = pair.both(path, body, headers={
            "Authorization": "Bearer sekrit"})
        assert got == want and got[0] == 200
    finally:
        for st in (pair.jstate, pair.tstate):
            st.config.api_keys = []


def test_reload_moves_the_knowledge_base_engine(model_path, tmp_path):
    """JAX pins the knowledge base to the engine its server started with (a
    server started without a model stays retrieval-only); the port's
    follows every reload, and a query after it generates with the new
    engine."""
    jst = JServerState(JServerConfig(model_path=model_path,
                                     weight_mode="dequant", warmup=False,
                                     rag_db=str(tmp_path / "j.db")))
    first = jst.engine
    assert jst.kb.engine is first
    jst.load_model(model_path)
    assert jst.engine is not first and jst.kb.engine is first
    jempty = JServerState(JServerConfig(rag_db=str(tmp_path / "je.db"),
                                        weight_mode="dequant",
                                        warmup=False))
    jempty.load_model(model_path)
    assert jempty.engine is not None and jempty.kb.engine is None
    jst.shutdown()
    jempty.shutdown()

    cfg = ServerConfig(port=_free_port(), device="cpu", max_batch=2,
                       rag_db=str(tmp_path / "t.db"), warmup=False)
    st = ServerState(cfg)
    assert st.kb.engine is None
    thread = threading.Thread(target=run_server, args=(cfg, st), daemon=True)
    thread.start()
    base = f"http://{cfg.host}:{cfg.port}"
    try:
        _wait_healthy(base)
        assert requests.post(base + "/v1/rag/ingest", json={
            "text": "the moon orbits the earth."}).status_code == 200
        for _ in range(2):
            r = requests.post(base + "/v1/internal/load_model",
                              json={"model_path": model_path})
            assert r.status_code == 200
            assert st.kb.engine is st.engine is not None
        calls = []
        real = st.engine.generate

        def generate(prompt, **kw):
            calls.append(prompt)
            return real(prompt, **kw)

        st.engine.generate = generate
        r = requests.post(base + "/v1/rag/query", json={
            "query": "moon", "k": 1, "max_tokens": 3})
        assert r.status_code == 200 and len(calls) == 1
        assert "[1] the moon orbits the earth." in calls[0]
    finally:
        st.shutdown()
        thread.join(timeout=30)


def test_query_beside_chat_and_ingests(pairs):
    """On the port's handler threads: a /v1/rag/query and a chat completion
    at once both finish; ingests that rewrite one document beside searches
    of it give whole documents (its two chunks or none)."""
    base = pairs["model"].tbase
    results = {}

    def post(name, path, body):
        results[name] = requests.post(base + path, json=body, timeout=300)

    threads = [threading.Thread(target=post, args=a) for a in (
        ("query", "/v1/rag/query", {"query": "moon", "k": 2,
                                    "max_tokens": 12}),
        ("chat", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 12, "temperature": 0.0}))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert results["query"].status_code == 200
    assert results["query"].json()["citations"]
    assert results["chat"].status_code == 200

    text = "alpha beta gamma. " * 40  # two chunks of the recursive splitter
    errors, seen = [], []

    def ingest(i):
        r = requests.post(base + "/v1/rag/ingest", json={
            "text": text + str(i), "doc_id": "rewritten"})
        if r.status_code != 200:
            errors.append(r.text)

    def search():
        for _ in range(10):
            r = requests.post(base + "/v1/rag/search", json={
                "query": "alpha beta", "k": 10, "search": "keyword"})
            if r.status_code != 200:
                errors.append(r.text)
                continue
            seen.append(sum(h["doc_id"] == "rewritten"
                            for h in r.json()["results"]))

    threads = [threading.Thread(target=ingest, args=(i,)) for i in range(6)]
    threads += [threading.Thread(target=search) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors
    assert set(seen) <= {0, 2} and 2 in seen
