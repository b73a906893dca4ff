"""PostgreSQL/pgvector store (optional; requires psycopg2) — port of
llama_gguf_tpu/rag/pgvector_store.py, the same SQL.

pgvector with HNSW or IVFFlat indexes, semantic, keyword and hybrid-RRF
search and the metadata filter DSL; the API mirrors SqliteVectorStore so
KnowledgeBase works over either. Gated at construction, never at import:
without psycopg2 it raises the JAX package's RuntimeError.
"""

from __future__ import annotations

import json
import time
from typing import Any, Iterable

import numpy as np

from .sqlite_store import SearchHit, _filter_to_sql


def _vec_literal(v: np.ndarray) -> str:
    return "[" + ",".join(f"{x:.7g}" for x in np.asarray(v, np.float32)) + "]"


class PgVectorStore:
    def __init__(self, dsn: str, table_prefix: str = "rag",
                 dim: int = 256, index: str = "hnsw"):
        try:
            import psycopg2  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "PgVectorStore requires psycopg2 (pip install psycopg2-binary);"
                " use SqliteVectorStore in this environment") from e
        import psycopg2

        self.conn = psycopg2.connect(dsn)
        self.prefix = table_prefix
        self.dim = dim
        with self.conn.cursor() as cur:
            cur.execute("CREATE EXTENSION IF NOT EXISTS vector")
            cur.execute(f"""
                CREATE TABLE IF NOT EXISTS {self.prefix}_documents (
                    doc_id TEXT PRIMARY KEY,
                    source TEXT,
                    content_hash TEXT,
                    created_at DOUBLE PRECISION,
                    metadata JSONB
                )""")
            cur.execute(f"""
                CREATE TABLE IF NOT EXISTS {self.prefix}_chunks (
                    id BIGSERIAL PRIMARY KEY,
                    doc_id TEXT REFERENCES {self.prefix}_documents(doc_id)
                        ON DELETE CASCADE,
                    chunk_index INTEGER,
                    text TEXT NOT NULL,
                    embedding vector({dim}),
                    metadata JSONB
                )""")
            method = ("USING hnsw (embedding vector_cosine_ops)"
                      if index == "hnsw"
                      else "USING ivfflat (embedding vector_cosine_ops)")
            cur.execute(
                f"CREATE INDEX IF NOT EXISTS {self.prefix}_chunks_ann "
                f"ON {self.prefix}_chunks {method}")
            cur.execute(
                f"CREATE INDEX IF NOT EXISTS {self.prefix}_chunks_fts ON "
                f"{self.prefix}_chunks USING gin"
                f"(to_tsvector('english', text))")
        self.conn.commit()

    # -- ingestion (mirrors SqliteVectorStore) -----------------------------------

    @staticmethod
    def content_hash(text: str) -> str:
        from .sqlite_store import SqliteVectorStore

        return SqliteVectorStore.content_hash(text)

    def has_document(self, doc_id: str, content_hash: str | None = None) -> bool:
        with self.conn.cursor() as cur:
            cur.execute(
                f"SELECT content_hash FROM {self.prefix}_documents"
                f" WHERE doc_id=%s", (doc_id,))
            row = cur.fetchone()
        return row is not None and (content_hash is None
                                    or row[0] == content_hash)

    def add_document(self, doc_id: str, source: str,
                     chunks: Iterable[tuple[str, np.ndarray, dict]],
                     content_hash: str | None = None,
                     metadata: dict | None = None) -> int:
        self.delete_document(doc_id)
        n = 0
        with self.conn.cursor() as cur:
            cur.execute(
                f"INSERT INTO {self.prefix}_documents VALUES"
                f" (%s,%s,%s,%s,%s)",
                (doc_id, source, content_hash, time.time(),
                 json.dumps(metadata or {})))
            for i, (text, emb, meta) in enumerate(chunks):
                cur.execute(
                    f"INSERT INTO {self.prefix}_chunks"
                    f" (doc_id, chunk_index, text, embedding, metadata)"
                    f" VALUES (%s,%s,%s,%s::vector,%s)",
                    (doc_id, i, text, _vec_literal(emb),
                     json.dumps(meta or {})))
                n += 1
        self.conn.commit()
        return n

    def delete_document(self, doc_id: str) -> None:
        with self.conn.cursor() as cur:
            cur.execute(f"DELETE FROM {self.prefix}_documents WHERE doc_id=%s",
                        (doc_id,))
        self.conn.commit()

    # -- search -------------------------------------------------------------------

    def _pg_filter(self, filters: dict | None) -> tuple[str, list]:
        sql, params = _filter_to_sql(filters)
        return sql.replace("json_extract(c.metadata, '$.", "c.metadata->>'") \
                  .replace("')", "'"), params

    def semantic_search(self, embedding: np.ndarray, k: int = 5,
                        filters: dict | None = None) -> list[SearchHit]:
        where, params = self._pg_filter(filters)
        with self.conn.cursor() as cur:
            cur.execute(
                f"SELECT c.id, c.doc_id, c.text, c.chunk_index, c.metadata,"
                f" d.source, 1 - (c.embedding <=> %s::vector) AS sim"
                f" FROM {self.prefix}_chunks c"
                f" JOIN {self.prefix}_documents d USING(doc_id)"
                f" WHERE TRUE{where} ORDER BY c.embedding <=> %s::vector"
                f" LIMIT %s",
                [_vec_literal(embedding)] + params
                + [_vec_literal(embedding), k])
            rows = cur.fetchall()
        return [SearchHit(chunk_id=r[0], doc_id=r[1], text=r[2],
                          chunk_index=r[3],
                          metadata=r[4] if isinstance(r[4], dict)
                          else json.loads(r[4] or "{}"),
                          source=r[5] or "", score=float(r[6]))
                for r in rows]

    def keyword_search(self, query: str, k: int = 5,
                       filters: dict | None = None) -> list[SearchHit]:
        where, params = self._pg_filter(filters)
        with self.conn.cursor() as cur:
            cur.execute(
                f"SELECT c.id, c.doc_id, c.text, c.chunk_index, c.metadata,"
                f" d.source, ts_rank(to_tsvector('english', c.text),"
                f" plainto_tsquery('english', %s)) AS rank"
                f" FROM {self.prefix}_chunks c"
                f" JOIN {self.prefix}_documents d USING(doc_id)"
                f" WHERE to_tsvector('english', c.text) @@"
                f" plainto_tsquery('english', %s){where}"
                f" ORDER BY rank DESC LIMIT %s",
                [query, query] + params + [k])
            rows = cur.fetchall()
        return [SearchHit(chunk_id=r[0], doc_id=r[1], text=r[2],
                          chunk_index=r[3],
                          metadata=r[4] if isinstance(r[4], dict)
                          else json.loads(r[4] or "{}"),
                          source=r[5] or "", score=float(r[6]))
                for r in rows]

    def hybrid_search(self, query: str, embedding: np.ndarray, k: int = 5,
                      filters: dict | None = None,
                      rrf_k: int = 60) -> list[SearchHit]:
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

    def stats(self) -> dict:
        with self.conn.cursor() as cur:
            cur.execute(f"SELECT COUNT(*) FROM {self.prefix}_documents")
            docs = cur.fetchone()[0]
            cur.execute(f"SELECT COUNT(*) FROM {self.prefix}_chunks")
            chunks = cur.fetchone()[0]
        return {"documents": docs, "chunks": chunks, "dim": self.dim}

    def close(self) -> None:
        self.conn.close()
