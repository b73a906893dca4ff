"""KnowledgeBase: ingest -> retrieve -> retrieve-and-generate with citations
(port of llama_gguf_tpu/rag/knowledge_base.py: the same chunking, rows,
prompt template and citations).

Incremental: content-hash change detection per document and directory sync
(sync.py); chunks carry their modality tag (multimodal.py). The embedder's
model loads onto ``device`` (default CUDA); generation runs on ``engine``,
the port's Engine, whose runner serializes its device calls.
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Any

import numpy as np

from .chunking import chunk_text, get_chunker
from .embeddings import HashEmbedder, make_embedder
from .sqlite_store import SearchHit, SqliteVectorStore


class ContentKind(str, Enum):
    """Typed content (parity: rag/multimodal.rs)."""
    TEXT = "text"
    MARKDOWN = "markdown"
    CODE = "code"
    IMAGE = "image"
    AUDIO = "audio"

    @classmethod
    def from_path(cls, path: str) -> "ContentKind":
        ext = Path(path).suffix.lower()
        if ext in (".md", ".markdown"):
            return cls.MARKDOWN
        if ext in (".py", ".rs", ".c", ".cc", ".cpp", ".js", ".ts", ".go",
                   ".java", ".sh", ".toml", ".yaml", ".json"):
            return cls.CODE
        if ext in (".png", ".jpg", ".jpeg", ".gif", ".webp"):
            return cls.IMAGE
        if ext in (".wav", ".mp3", ".flac", ".ogg"):
            return cls.AUDIO
        return cls.TEXT


@dataclass
class Citation:
    index: int
    source: str
    doc_id: str
    chunk_index: int
    score: float


@dataclass
class RetrieveAndGenerateResult:
    answer: str
    citations: list[Citation]
    hits: list[SearchHit]


@dataclass
class KnowledgeBaseStats:
    documents: int = 0
    chunks: int = 0
    ingested: int = 0
    skipped_unchanged: int = 0
    queries: int = 0


class KnowledgeBase:
    def __init__(self, store: SqliteVectorStore,
                 embedder=None, embed_model_path: str | None = None,
                 chunker: str = "recursive", chunk_size: int = 512,
                 chunk_overlap: int = 64, engine=None, device="cuda"):
        self.store = store
        self.embedder = embedder or make_embedder(embed_model_path,
                                                  device=device)
        self.default_chunker = chunker
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.engine = engine  # generation engine for retrieve_and_generate
        self.stats = KnowledgeBaseStats()

    # -- ingestion ---------------------------------------------------------------

    def ingest_text(self, text: str, source: str = "",
                    doc_id: str | None = None, chunker: str | None = None,
                    metadata: dict | None = None) -> int:
        """Chunk + embed + store one document. Incremental: unchanged
        content (same hash) is skipped (parity: rag/sync.rs)."""
        doc_id = doc_id or (source or uuid.uuid4().hex)
        h = self.store.content_hash(text)
        if self.store.has_document(doc_id, h):
            self.stats.skipped_unchanged += 1
            return 0
        ck = get_chunker(chunker or self.default_chunker, self.chunk_size,
                         self.chunk_overlap)
        chunks = chunk_text(text, ck)
        from .multimodal import ContentExtractor

        rows = []
        for c in chunks:
            emb = self.embedder.embed(c.text)
            meta = dict(metadata or {})
            meta.update(c.metadata)
            # per-chunk modality tag (parity: multimodal.rs ContentType) —
            # retrieval can filter on it ({"content_type": "code"})
            meta.setdefault(
                "content_type",
                ContentExtractor.detect_content_type(c.text).value)
            rows.append((c.text, emb, meta))
        n = self.store.add_document(doc_id, source or doc_id, rows,
                                    content_hash=h, metadata=metadata)
        self.stats.ingested += n
        st = self.store.stats()
        self.stats.documents = st["documents"]
        self.stats.chunks = st["chunks"]
        return n

    def ingest_path(self, path: str, chunker: str | None = None,
                    metadata: dict | None = None) -> int:
        """Ingest a file or directory tree of text/markdown/code files."""
        p = Path(path)
        if p.is_dir():
            total = 0
            for f in sorted(p.rglob("*")):
                if f.is_file() and ContentKind.from_path(str(f)) in (
                        ContentKind.TEXT, ContentKind.MARKDOWN,
                        ContentKind.CODE):
                    total += self.ingest_path(str(f), chunker, metadata)
            return total
        kind = ContentKind.from_path(str(p))
        if kind in (ContentKind.IMAGE, ContentKind.AUDIO):
            return 0  # non-text modalities recorded but not embedded
        text = p.read_text(errors="replace")
        ck = chunker or ("markdown" if kind == ContentKind.MARKDOWN
                         else self.default_chunker)
        meta = dict(metadata or {})
        meta["content_kind"] = kind.value
        return self.ingest_text(text, source=str(p), doc_id=str(p),
                                chunker=ck, metadata=meta)

    def delete(self, doc_id: str) -> None:
        self.store.delete_document(doc_id)

    def sync_directory(self, path: str, pattern: str | None = None,
                       recursive: bool = True,
                       chunker: str | None = None):
        """Incrementally re-index a directory (parity: rag/sync.rs sync
        flow): new files are ingested, modified files re-chunk ONLY
        themselves (add_document replaces), deleted files drop their
        chunks, unchanged files are no-ops. The store itself is the
        tracker — document rows carry content hashes. Returns SyncResult."""
        from .sync import SyncResult, collect_files

        result = SyncResult()
        seen: set[str] = set()
        for f in collect_files(path, pattern, recursive):
            uri = str(f)
            if ContentKind.from_path(uri) in (ContentKind.IMAGE,
                                              ContentKind.AUDIO):
                continue
            seen.add(uri)
            try:
                text = f.read_text(errors="replace")
            except OSError as e:
                result.errors.append((uri, str(e)))
                continue
            h = self.store.content_hash(text)
            if self.store.has_document(uri, h):
                result.unchanged += 1
                self.stats.skipped_unchanged += 1
                continue
            existed = self.store.has_document(uri)
            # ingest the text we already read (a second read could race a
            # concurrent writer and record a hash for different content)
            kind = ContentKind.from_path(uri)
            ck = chunker or ("markdown" if kind == ContentKind.MARKDOWN
                             else self.default_chunker)
            self.ingest_text(text, source=uri, doc_id=uri, chunker=ck,
                             metadata={"content_kind": kind.value})
            if existed:
                result.updated += 1
            else:
                result.added += 1
        # tracked documents under this root that vanished from disk
        root = str(Path(path).resolve())
        for doc_id, source, _ in self.store.list_documents():
            if doc_id in seen:
                continue
            try:
                inside = str(Path(doc_id).resolve()).startswith(root + os.sep)
            except OSError:
                inside = False
            if inside and not os.path.exists(doc_id):
                self.store.delete_document(doc_id)
                result.deleted += 1
        st = self.store.stats()
        self.stats.documents = st["documents"]
        self.stats.chunks = st["chunks"]
        return result

    # -- retrieval ----------------------------------------------------------------

    def retrieve(self, query: str, k: int = 5, search: str = "hybrid",
                 filters: dict | None = None) -> list[SearchHit]:
        self.stats.queries += 1
        if search == "keyword":
            return self.store.keyword_search(query, k, filters)
        emb = self.embedder.embed(query)
        if search == "semantic":
            return self.store.semantic_search(emb, k, filters)
        return self.store.hybrid_search(query, emb, k, filters)

    # -- generation ------------------------------------------------------------------

    PROMPT_TEMPLATE = (
        "Answer the question using ONLY the numbered context passages. "
        "Cite passages inline as [N].\n\n{context}\nQuestion: {question}\n"
        "Answer:"
    )

    def retrieve_and_generate(self, query: str, k: int = 5,
                              search: str = "hybrid",
                              filters: dict | None = None,
                              max_tokens: int = 256,
                              sampler=None) -> RetrieveAndGenerateResult:
        """RAG answer with citations (parity: knowledge_base.rs:406+)."""
        hits = self.retrieve(query, k, search, filters)
        citations = [
            Citation(index=i + 1, source=h.source, doc_id=h.doc_id,
                     chunk_index=h.chunk_index, score=h.score)
            for i, h in enumerate(hits)
        ]
        context = "".join(
            f"[{i + 1}] {h.text}\n" for i, h in enumerate(hits)
        )
        prompt = self.PROMPT_TEMPLATE.format(context=context, question=query)
        if self.engine is None:
            # retrieval-only mode: answer is the stitched context
            answer = "\n".join(f"[{c.index}] {h.text}"
                               for c, h in zip(citations, hits))
        else:
            answer = self.engine.generate(prompt, max_tokens=max_tokens,
                                          sampler=sampler)
        return RetrieveAndGenerateResult(answer=answer, citations=citations,
                                         hits=hits)
