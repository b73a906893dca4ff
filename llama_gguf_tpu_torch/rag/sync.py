"""Incremental re-indexing for RAG document sources (port of
llama_gguf_tpu/rag/sync.py, the same code and state-file format).

Tracks per-source content hashes, detects new, modified, deleted and
unchanged files in a directory, and re-indexes only what changed. Two
tracking modes:

- ``DocumentTracker``: a standalone JSON-state tracker (the state file
  survives across processes, independent of any store).
- ``KnowledgeBase.sync_directory`` (knowledge_base.py) uses the vector
  store itself as the tracker (document rows carry content hashes), so no
  side-car state file can drift from the indexed data.
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator


def content_hash(text: str) -> str:
    """Deterministic content hash (hex). The reference uses Rust's
    DefaultHasher; any stable hash serves — sha1 truncated to 16 hex chars
    keeps the same shape as the reference's {:016x}."""
    return hashlib.sha1(text.encode("utf-8", "replace")).hexdigest()[:16]


@dataclass
class TrackedDocument:
    source_uri: str
    content_hash: str
    chunk_ids: list = field(default_factory=list)
    last_indexed: float = 0.0
    file_size: int | None = None


@dataclass
class SourceChange:
    """One detected change. kind: new | modified | deleted | unchanged."""
    kind: str
    uri: str
    content: str | None = None
    old_chunk_ids: list = field(default_factory=list)


@dataclass
class SyncResult:
    added: int = 0
    updated: int = 0
    deleted: int = 0
    unchanged: int = 0
    errors: list = field(default_factory=list)  # (uri, message)

    @property
    def changed(self) -> int:
        return self.added + self.updated + self.deleted


def collect_files(root: str | Path, pattern: str | None = None,
                  recursive: bool = True) -> Iterator[Path]:
    root = Path(root)
    it = root.rglob("*") if recursive else root.glob("*")
    for p in sorted(it):
        if p.is_file() and (pattern is None or fnmatch.fnmatch(p.name, pattern)):
            yield p


class DocumentTracker:
    """Per-source content-hash tracker with optional JSON state file."""

    def __init__(self, state_path: str | None = None):
        self.state_path = state_path
        self.entries: dict[str, TrackedDocument] = {}

    # -- persistence ---------------------------------------------------------

    def load(self) -> None:
        if not self.state_path or not os.path.exists(self.state_path):
            return
        with open(self.state_path) as f:
            data = json.load(f)
        self.entries = {
            uri: TrackedDocument(**doc) for uri, doc in
            data.get("entries", {}).items()
        }

    def save(self) -> None:
        if not self.state_path:
            return
        data = {"entries": {uri: vars(doc)
                            for uri, doc in self.entries.items()}}
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2)
        os.replace(tmp, self.state_path)

    # -- change detection ----------------------------------------------------

    def detect_file_change(self, path: str | Path,
                           content: str | None = None) -> SourceChange:
        uri = str(path)
        if content is None:
            try:
                content = Path(path).read_text(errors="replace")
            except OSError as e:
                return SourceChange("error", uri, content=str(e))
        h = content_hash(content)
        doc = self.entries.get(uri)
        if doc is None:
            return SourceChange("new", uri, content=content)
        if doc.content_hash == h:
            return SourceChange("unchanged", uri)
        return SourceChange("modified", uri, content=content,
                            old_chunk_ids=list(doc.chunk_ids))

    def detect_changes(self, directory: str | Path,
                       pattern: str | None = None,
                       recursive: bool = True) -> list[SourceChange]:
        """Scan a directory; returns new/modified/unchanged changes for
        present files plus deleted entries for tracked-but-missing ones."""
        changes = []
        seen = set()
        for p in collect_files(directory, pattern, recursive):
            uri = str(p)
            seen.add(uri)
            changes.append(self.detect_file_change(p))
        for uri, doc in self.entries.items():
            if uri not in seen:
                changes.append(SourceChange(
                    "deleted", uri, old_chunk_ids=list(doc.chunk_ids)))
        return changes

    # -- bookkeeping ---------------------------------------------------------

    def record_indexed(self, uri: str, chash: str,
                       chunk_ids: list | None = None) -> None:
        self.entries[uri] = TrackedDocument(
            source_uri=uri, content_hash=chash,
            chunk_ids=list(chunk_ids or []), last_indexed=time.time())

    def record_deleted(self, uri: str) -> None:
        self.entries.pop(uri, None)

    def get(self, uri: str) -> TrackedDocument | None:
        return self.entries.get(uri)

    def tracked_sources(self) -> list[str]:
        return list(self.entries)

    def __len__(self) -> int:
        return len(self.entries)
