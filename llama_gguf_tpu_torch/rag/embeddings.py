"""Embedding generators for RAG (port of llama_gguf_tpu/rag/embeddings.py).

  * EngineEmbedder — wraps the port's Engine (a decoder's pooled hidden
    states or a BERT-family encoder) loaded from a GGUF path onto
    ``device`` (default CUDA; it raises when CUDA is asked for and absent)
  * HashEmbedder — deterministic feature-hashing bag-of-ngrams embedding:
    no model needed; the JAX package's vectors bit for bit
"""

from __future__ import annotations

import hashlib
import math

import numpy as np


class HashEmbedder:
    """Feature-hashed char-ngram embedding (deterministic, model-free)."""

    def __init__(self, dim: int = 256, ngram: tuple[int, int] = (3, 5)):
        self.dim = dim
        self.ngram = ngram

    def embed(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, np.float32)
        t = f" {text.lower()} "
        for n in range(self.ngram[0], self.ngram[1] + 1):
            for i in range(max(len(t) - n + 1, 0)):
                g = t[i: i + n]
                h = int.from_bytes(
                    hashlib.blake2b(g.encode(), digest_size=8).digest(),
                    "little")
                sign = 1.0 if (h >> 63) & 1 else -1.0
                v[h % self.dim] += sign / math.sqrt(n)
        norm = np.linalg.norm(v)
        return v / norm if norm > 0 else v

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        return np.stack([self.embed(t) for t in texts])


class EngineEmbedder:
    """Embeds through a loaded Engine (lazy model load from path)."""

    def __init__(self, model_path: str | None = None, engine=None,
                 pooling: str = "mean", device="cuda"):
        if engine is None and model_path is None:
            raise ValueError("need model_path or engine")
        self._engine = engine
        self._path = model_path
        self.pooling = pooling
        self.device = device

    @property
    def engine(self):
        if self._engine is None:
            from ..engine.engine import Engine, EngineConfig

            self._engine = Engine.load(self._path, EngineConfig(),
                                       device=self.device)
        return self._engine

    @property
    def dim(self) -> int:
        e = self.engine
        cfg = e.encoder.cfg if e.encoder is not None else e.runner.cfg
        return cfg.hidden_size

    def embed(self, text: str) -> np.ndarray:
        return np.asarray(self.engine.embed(text, pooling=self.pooling))

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        return np.stack([self.embed(t) for t in texts])


def make_embedder(model_path: str | None = None, engine=None,
                  dim: int = 256, device="cuda"):
    if engine is not None or model_path:
        return EngineEmbedder(model_path, engine, device=device)
    return HashEmbedder(dim)
