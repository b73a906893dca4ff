"""HTTP client for a llama-gguf-tpu (or any OpenAI-compatible) server (port
of llama_gguf_tpu/client.py on the standard library's ``urllib.request``).

``chat_streaming`` reads the server's SSE frames line by line and yields the
content deltas as they arrive.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Iterator


class RemoteError(RuntimeError):
    pass


class RemoteChatClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8080",
                 api_key: str | None = None, model: str | None = None,
                 timeout: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.model = model
        self.timeout = timeout

    # -- info -------------------------------------------------------------------

    def health(self) -> dict:
        return self._get("/health")

    def models(self) -> list[str]:
        return [m["id"] for m in self._get("/v1/models")["data"]]

    def queue_status(self) -> dict:
        return self._get("/v1/queue")

    # -- chat -------------------------------------------------------------------

    def chat(self, messages: list[dict], **opts) -> str:
        body = {"messages": messages, "model": self.model, **opts}
        d = self._post("/v1/chat/completions", body)
        msg = d["choices"][0]["message"]
        return msg.get("content") or ""

    def chat_streaming(self, messages: list[dict], **opts) -> Iterator[str]:
        body = {"messages": messages, "model": self.model, "stream": True,
                **opts}
        for chunk in self._post_sse("/v1/chat/completions", body):
            delta = chunk["choices"][0].get("delta", {})
            piece = delta.get("content")
            if piece:
                yield piece

    def complete(self, prompt: str, **opts) -> str:
        d = self._post("/v1/completions", {"prompt": prompt,
                                           "model": self.model, **opts})
        return d["choices"][0]["text"]

    def embed(self, texts: str | list[str]) -> list[list[float]]:
        d = self._post("/v1/embeddings", {"input": texts,
                                          "model": self.model})
        return [e["embedding"] for e in d["data"]]

    # -- transport ----------------------------------------------------------------

    def _request(self, path: str, body: dict | None = None):
        headers = {}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(self.base_url + path, data=data,
                                     headers=headers,
                                     method="GET" if body is None else "POST")
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            raw = e.read()
            e.close()
            try:
                msg = json.loads(raw)["error"]["message"]
            except (ValueError, KeyError, TypeError):
                msg = raw[:200].decode("utf-8", "replace")
            raise RemoteError(f"HTTP {e.code}: {msg}") from None

    def _get(self, path: str) -> dict:
        with self._request(path) as r:
            return json.loads(r.read())

    def _post(self, path: str, body: dict) -> dict:
        with self._request(path, body) as r:
            return json.loads(r.read())

    def _post_sse(self, path: str, body: dict) -> Iterator[dict]:
        with self._request(path, body) as r:
            for line in r:
                line = line.rstrip(b"\r\n")
                if not line.startswith(b"data: "):
                    continue
                payload = line[6:]
                if payload == b"[DONE]":
                    return
                yield json.loads(payload)
