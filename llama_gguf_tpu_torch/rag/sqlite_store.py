"""SQLite vector store: semantic (HNSW), keyword (FTS5) and hybrid-RRF search
(port of llama_gguf_tpu/rag/sqlite_store.py: the same schema, so a database
file either package writes is read by the other).

Embeddings are float32 blobs; the HNSW index is persisted in a side table
and rebuilt from every row at the first search after a change. Keyword
search uses FTS5 when the sqlite build has it, else LIKE term counting.
Metadata filters: equality, $gte/$gt/$lte/$lt/$ne and $in.

One difference from the JAX store: every public method holds the store's
lock. The connection is shared by threads (``check_same_thread=False``),
and without the lock a search on one thread reads another thread's
document half written (its old chunks deleted, part of the new ones
inserted) or commits it half way.
"""

from __future__ import annotations

import functools
import hashlib
import json
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterable

import numpy as np

from .hnsw import HNSWIndex

_SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
    doc_id TEXT PRIMARY KEY,
    source TEXT,
    content_hash TEXT,
    created_at REAL,
    metadata TEXT
);
CREATE TABLE IF NOT EXISTS chunks (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    doc_id TEXT REFERENCES documents(doc_id) ON DELETE CASCADE,
    chunk_index INTEGER,
    text TEXT NOT NULL,
    embedding BLOB,
    metadata TEXT
);
CREATE INDEX IF NOT EXISTS idx_chunks_doc ON chunks(doc_id);
CREATE TABLE IF NOT EXISTS ann_index (
    name TEXT PRIMARY KEY,
    data BLOB,
    row_count INTEGER
);
"""


@dataclass
class SearchHit:
    chunk_id: int
    doc_id: str
    text: str
    score: float
    source: str = ""
    chunk_index: int = 0
    metadata: dict[str, Any] = field(default_factory=dict)


def _filter_to_sql(filters: dict[str, Any] | None) -> tuple[str, list]:
    """Metadata filter DSL -> SQL over json_extract (parity: store.rs filter
    DSL). Supported: equality, $gte/$gt/$lte/$lt/$ne, $in."""
    if not filters:
        return "", []
    clauses, params = [], []
    ops = {"$gte": ">=", "$gt": ">", "$lte": "<=", "$lt": "<", "$ne": "!="}
    for key, value in filters.items():
        path = f"$.{key}"
        if isinstance(value, dict):
            for op, v in value.items():
                if op == "$in":
                    ph = ",".join("?" * len(v))
                    clauses.append(
                        f"json_extract(c.metadata, '{path}') IN ({ph})")
                    params.extend(v)
                elif op in ops:
                    clauses.append(
                        f"json_extract(c.metadata, '{path}') {ops[op]} ?")
                    params.append(v)
                else:
                    raise ValueError(f"unknown filter op {op!r}")
        else:
            clauses.append(f"json_extract(c.metadata, '{path}') = ?")
            params.append(value)
    return " AND " + " AND ".join(clauses), params


def _locked(method):
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return wrapped


class SqliteVectorStore:
    def __init__(self, path: str = ":memory:", dim: int | None = None):
        self._lock = threading.RLock()
        self.path = path
        self.db = sqlite3.connect(path, check_same_thread=False)
        self.db.execute("PRAGMA journal_mode=WAL")
        self.db.executescript(_SCHEMA)
        self._fts = self._init_fts()
        self.dim = dim
        self._index: HNSWIndex | None = None
        self._index_dirty = True

    def _init_fts(self) -> bool:
        try:
            self.db.execute(
                "CREATE VIRTUAL TABLE IF NOT EXISTS chunks_fts USING fts5("
                "text, content=chunks, content_rowid=id)")
            return True
        except sqlite3.OperationalError:
            return False

    # -- ingestion -------------------------------------------------------------

    @staticmethod
    def content_hash(text: str) -> str:
        return hashlib.sha256(text.encode()).hexdigest()

    @_locked
    def has_document(self, doc_id: str, content_hash: str | None = None) -> bool:
        row = self.db.execute(
            "SELECT content_hash FROM documents WHERE doc_id=?",
            (doc_id,)).fetchone()
        if row is None:
            return False
        return content_hash is None or row[0] == content_hash

    @_locked
    def add_document(self, doc_id: str, source: str,
                     chunks: Iterable[tuple[str, np.ndarray, dict]],
                     content_hash: str | None = None,
                     metadata: dict | None = None) -> int:
        """Insert/replace a document and its (text, embedding, metadata)
        chunks. Returns the number of chunks stored."""
        self.delete_document(doc_id)
        self.db.execute(
            "INSERT INTO documents(doc_id, source, content_hash, created_at,"
            " metadata) VALUES (?,?,?,?,?)",
            (doc_id, source, content_hash, time.time(),
             json.dumps(metadata or {})))
        n = 0
        for i, (text, emb, meta) in enumerate(chunks):
            emb = np.asarray(emb, np.float32)
            if self.dim is None:
                self.dim = emb.shape[0]
            cur = self.db.execute(
                "INSERT INTO chunks(doc_id, chunk_index, text, embedding,"
                " metadata) VALUES (?,?,?,?,?)",
                (doc_id, i, text, emb.tobytes(), json.dumps(meta or {})))
            if self._fts:
                self.db.execute(
                    "INSERT INTO chunks_fts(rowid, text) VALUES (?,?)",
                    (cur.lastrowid, text))
            n += 1
        self.db.commit()
        self._index_dirty = True
        return n

    @_locked
    def list_documents(self) -> list[tuple[str, str, str | None]]:
        """All (doc_id, source, content_hash) rows — lets the store act as
        the incremental-sync tracker (rag/sync.py) with no side-car state."""
        return [tuple(r) for r in self.db.execute(
            "SELECT doc_id, source, content_hash FROM documents")]

    @_locked
    def delete_document(self, doc_id: str) -> None:
        ids = [r[0] for r in self.db.execute(
            "SELECT id FROM chunks WHERE doc_id=?", (doc_id,))]
        if self._fts and ids:
            self.db.executemany("DELETE FROM chunks_fts WHERE rowid=?",
                                [(i,) for i in ids])
        self.db.execute("DELETE FROM chunks WHERE doc_id=?", (doc_id,))
        self.db.execute("DELETE FROM documents WHERE doc_id=?", (doc_id,))
        self.db.commit()
        if ids:
            self._index_dirty = True

    # -- ANN index ---------------------------------------------------------------

    @_locked
    def _ensure_index(self) -> HNSWIndex | None:
        if not self._index_dirty and self._index is not None:
            return self._index
        rows = self.db.execute(
            "SELECT id, embedding FROM chunks WHERE embedding IS NOT NULL"
        ).fetchall()
        if not rows:
            self._index = None
            self._index_dirty = False
            return None
        dim = len(rows[0][1]) // 4
        idx = HNSWIndex(dim)
        for cid, blob in rows:
            idx.add(cid, np.frombuffer(blob, np.float32))
        self._index = idx
        self._index_dirty = False
        self.db.execute(
            "INSERT OR REPLACE INTO ann_index(name, data, row_count)"
            " VALUES ('hnsw', ?, ?)", (idx.to_bytes(), len(rows)))
        self.db.commit()
        return idx

    # -- search -------------------------------------------------------------------

    def _hydrate(self, scored: list[tuple[int, float]],
                 filters: dict | None) -> list[SearchHit]:
        if not scored:
            return []
        where, params = _filter_to_sql(filters)
        ph = ",".join("?" * len(scored))
        rows = self.db.execute(
            f"SELECT c.id, c.doc_id, c.text, c.chunk_index, c.metadata,"
            f" d.source FROM chunks c JOIN documents d USING(doc_id)"
            f" WHERE c.id IN ({ph}){where}",
            [cid for cid, _ in scored] + params).fetchall()
        by_id = {r[0]: r for r in rows}
        out = []
        for cid, score in scored:
            r = by_id.get(cid)
            if r is None:
                continue
            out.append(SearchHit(
                chunk_id=r[0], doc_id=r[1], text=r[2], chunk_index=r[3],
                metadata=json.loads(r[4] or "{}"), source=r[5] or "",
                score=score))
        return out

    @_locked
    def semantic_search(self, embedding: np.ndarray, k: int = 5,
                        filters: dict | None = None) -> list[SearchHit]:
        idx = self._ensure_index()
        if idx is None:
            return []
        # over-fetch when filtering, filter drops non-matching
        fetch = k * 4 if filters else k
        scored = [(cid, sim) for cid, sim in idx.search(embedding, fetch)]
        return self._hydrate(scored, filters)[:k]

    @_locked
    def keyword_search(self, query: str, k: int = 5,
                       filters: dict | None = None) -> list[SearchHit]:
        if self._fts:
            try:
                terms = " OR ".join(
                    t for t in "".join(
                        ch if ch.isalnum() else " " for ch in query
                    ).split())
                rows = self.db.execute(
                    "SELECT rowid, bm25(chunks_fts) FROM chunks_fts WHERE "
                    "chunks_fts MATCH ? ORDER BY bm25(chunks_fts) LIMIT ?",
                    (terms, k * 4 if filters else k)).fetchall()
                scored = [(r[0], -float(r[1])) for r in rows]  # bm25: lower=better
                return self._hydrate(scored, filters)[:k]
            except sqlite3.OperationalError:
                pass
        # LIKE fallback: term-count scoring
        terms = [t.lower() for t in query.split() if t]
        rows = self.db.execute("SELECT id, lower(text) FROM chunks").fetchall()
        scored = []
        for cid, text in rows:
            score = sum(text.count(t) for t in terms)
            if score > 0:
                scored.append((cid, float(score)))
        scored.sort(key=lambda x: -x[1])
        return self._hydrate(scored[: k * 4 if filters else k], filters)[:k]

    @_locked
    def hybrid_search(self, query: str, embedding: np.ndarray, k: int = 5,
                      filters: dict | None = None,
                      rrf_k: int = 60) -> list[SearchHit]:
        """Reciprocal-rank fusion of semantic + keyword results
        (parity: store.rs hybrid-RRF)."""
        sem = self.semantic_search(embedding, k * 2, filters)
        kw = self.keyword_search(query, k * 2, filters)
        scores: dict[int, float] = {}
        hits: dict[int, SearchHit] = {}
        for results in (sem, kw):
            for rank, hit in enumerate(results):
                scores[hit.chunk_id] = scores.get(hit.chunk_id, 0.0) + \
                    1.0 / (rrf_k + rank + 1)
                hits[hit.chunk_id] = hit
        order = sorted(scores, key=lambda c: -scores[c])[:k]
        out = []
        for cid in order:
            h = hits[cid]
            h.score = scores[cid]
            out.append(h)
        return out

    # -- stats ---------------------------------------------------------------------

    @_locked
    def stats(self) -> dict:
        docs = self.db.execute("SELECT COUNT(*) FROM documents").fetchone()[0]
        chunks = self.db.execute("SELECT COUNT(*) FROM chunks").fetchone()[0]
        return {"documents": docs, "chunks": chunks, "dim": self.dim,
                "fts": self._fts}

    @_locked
    def close(self) -> None:
        self.db.close()
