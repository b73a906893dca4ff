"""Embedding extraction with pooling, and similarity helpers (port of
llama_gguf_tpu/models/embeddings.py, decoder models).

``extract_hidden_states`` is the runner's ``hidden_states``: the port's
forward up to the final norm, eagerly, on a one-row cache the runner keeps
for it (``init_kv(1, owner="embed")``), so it never touches a cache a
request is using, and under the runner's own lock, so it can run beside a
serving scheduler (engine/runner.py). Its quantized products run kernels
1-3 at T rows.
"""

from __future__ import annotations

import numpy as np

EMBED_OWNER = "embed"


def extract_hidden_states(runner, token_ids: list[int]) -> np.ndarray:
    """Run the model and return final-norm hidden states [T, H]."""
    return runner.hidden_states(token_ids, owner=EMBED_OWNER)


def pool(hidden: np.ndarray, pooling: str = "mean") -> np.ndarray:
    if pooling == "mean":
        return hidden.mean(axis=0)
    if pooling == "last":
        return hidden[-1]
    if pooling == "first":  # CLS
        return hidden[0]
    if pooling == "max":
        return hidden.max(axis=0)
    raise ValueError(f"unknown pooling {pooling}")


def extract_embedding(runner, token_ids: list[int], pooling: str = "mean",
                      normalize: bool = True) -> np.ndarray:
    h = extract_hidden_states(runner, token_ids)
    v = pool(h, pooling)
    if normalize:
        n = np.linalg.norm(v)
        if n > 0:
            v = v / n
    return v


# -- similarity utilities ----------------------------------------------------


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def dot_similarity(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.dot(a, b))


def euclidean_distance(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b))


def find_nearest(query: np.ndarray, corpus: np.ndarray, k: int = 5,
                 metric: str = "cosine") -> list[tuple[int, float]]:
    """Top-k nearest rows of corpus [N, D] to query [D]."""
    if metric == "cosine":
        qn = query / (np.linalg.norm(query) + 1e-12)
        cn = corpus / (np.linalg.norm(corpus, axis=1, keepdims=True) + 1e-12)
        scores = cn @ qn
        order = np.argsort(scores)[::-1][:k]
        return [(int(i), float(scores[i])) for i in order]
    if metric == "dot":
        scores = corpus @ query
        order = np.argsort(scores)[::-1][:k]
        return [(int(i), float(scores[i])) for i in order]
    if metric == "euclidean":
        d = np.linalg.norm(corpus - query[None, :], axis=1)
        order = np.argsort(d)[:k]
        return [(int(i), float(d[i])) for i in order]
    raise ValueError(f"unknown metric {metric}")
