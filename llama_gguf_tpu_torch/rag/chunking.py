"""Document chunkers for RAG ingestion (port of llama_gguf_tpu/rag/chunking.py,
the same code: every splitter gives the JAX package's chunks, text for text
and metadata for metadata).

The recursive character splitter with its default separators, the
header-aware markdown splitter with heading-path metadata, the sliding
window snapped to word boundaries, sentence packing and paragraph
splitting. Sizes count characters.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Chunk:
    text: str
    index: int = 0
    metadata: dict[str, Any] = field(default_factory=dict)


DEFAULT_SEPARATORS = ["\n\n", "\n", ". ", " ", ""]


class RecursiveCharacterSplitter:
    """Split on the coarsest separator that yields chunks under the limit,
    recursing into finer separators (chunking.rs:74-253)."""

    def __init__(self, chunk_size: int = 512, chunk_overlap: int = 64,
                 separators: list[str] | None = None,
                 strip_whitespace: bool = True):
        if chunk_overlap >= chunk_size:
            raise ValueError("overlap must be smaller than chunk size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = separators or list(DEFAULT_SEPARATORS)
        self.strip_whitespace = strip_whitespace

    def split(self, text: str) -> list[str]:
        pieces = self._split(text, 0)
        merged = self._merge(pieces)
        if self.strip_whitespace:
            merged = [m.strip() for m in merged]
        return [m for m in merged if m]

    def _split(self, text: str, depth: int) -> list[str]:
        if len(text) <= self.chunk_size:
            return [text]
        if depth >= len(self.separators):
            return [text[i: i + self.chunk_size]
                    for i in range(0, len(text), self.chunk_size)]
        sep = self.separators[depth]
        if sep == "":
            return [text[i: i + self.chunk_size]
                    for i in range(0, len(text), self.chunk_size)]
        parts = text.split(sep)
        out: list[str] = []
        for i, p in enumerate(parts):
            keep = p + (sep if i < len(parts) - 1 else "")
            if len(keep) > self.chunk_size:
                out.extend(self._split(keep, depth + 1))
            else:
                out.append(keep)
        return out

    def _merge(self, pieces: list[str]) -> list[str]:
        """Greedily merge adjacent pieces up to chunk_size, carrying an
        overlap tail into the next chunk."""
        chunks: list[str] = []
        cur = ""
        for p in pieces:
            if cur and len(cur) + len(p) > self.chunk_size:
                chunks.append(cur)
                cur = cur[-self.chunk_overlap:] if self.chunk_overlap else ""
            cur += p
        if cur:
            chunks.append(cur)
        return chunks


class MarkdownSplitter:
    """Header-aware markdown chunking; each chunk carries its heading path
    in metadata (chunking.rs:254-464)."""

    def __init__(self, max_chunk_size: int = 1024, overlap: int = 0,
                 include_headers: bool = True):
        self.max_chunk_size = max_chunk_size
        self.overlap = overlap
        self.include_headers = include_headers

    def split(self, text: str) -> list[Chunk]:
        sections: list[tuple[list[str], list[str]]] = []  # (path, lines)
        path: list[str] = []
        lines: list[str] = []
        in_code = False
        for line in text.splitlines():
            if line.lstrip().startswith("```"):
                in_code = not in_code
                lines.append(line)
                continue
            m = None if in_code else re.match(r"^(#{1,6})\s+(.*)$", line)
            if m:
                if lines and any(l.strip() for l in lines):
                    sections.append((list(path), lines))
                level = len(m.group(1))
                path = path[: level - 1] + [m.group(2).strip()]
                lines = []
            else:
                lines.append(line)
        if lines and any(l.strip() for l in lines):
            sections.append((list(path), lines))

        out: list[Chunk] = []
        splitter = RecursiveCharacterSplitter(self.max_chunk_size,
                                              self.overlap or 0)
        idx = 0
        for hpath, body_lines in sections:
            body = "\n".join(body_lines).strip()
            if not body:
                continue
            header = " > ".join(hpath)
            prefix = f"{header}\n\n" if (header and self.include_headers) else ""
            for piece in splitter.split(body):
                out.append(Chunk(
                    text=prefix + piece,
                    index=idx,
                    metadata={"headers": list(hpath)} if hpath else {},
                ))
                idx += 1
        return out


class SlidingWindowSplitter:
    """Fixed window with overlap, optionally snapped to word boundaries
    (chunking.rs:465-563)."""

    def __init__(self, window_size: int = 512, overlap: int = 128,
                 respect_word_boundaries: bool = True):
        if overlap >= window_size:
            raise ValueError("overlap must be smaller than window")
        self.window_size = window_size
        self.overlap = overlap
        self.respect_word_boundaries = respect_word_boundaries

    def split(self, text: str) -> list[str]:
        step = self.window_size - self.overlap
        out = []
        i = 0
        n = len(text)
        while i < n:
            j = min(i + self.window_size, n)
            if self.respect_word_boundaries and j < n:
                k = text.rfind(" ", i, j)
                if k > i:
                    j = k
            piece = text[i:j].strip()
            if piece:
                out.append(piece)
            if j >= n:
                break
            i = max(i + step, j - self.overlap)
        return out


_SENT_RE = re.compile(r"(?<=[.!?])\s+")


class SentenceSplitter:
    """Pack whole sentences into chunks up to max_chunk_size."""

    def __init__(self, max_chunk_size: int = 512):
        self.max_chunk_size = max_chunk_size

    def split(self, text: str) -> list[str]:
        sentences = [s.strip() for s in _SENT_RE.split(text) if s.strip()]
        out: list[str] = []
        cur = ""
        for s in sentences:
            if cur and len(cur) + 1 + len(s) > self.max_chunk_size:
                out.append(cur)
                cur = s
            else:
                cur = f"{cur} {s}".strip()
        if cur:
            out.append(cur)
        return out


class ParagraphSplitter:
    """One chunk per paragraph, long paragraphs split recursively."""

    def __init__(self, max_chunk_size: int = 1024):
        self.max_chunk_size = max_chunk_size

    def split(self, text: str) -> list[str]:
        out: list[str] = []
        inner = RecursiveCharacterSplitter(self.max_chunk_size, 0)
        for para in re.split(r"\n\s*\n", text):
            para = para.strip()
            if not para:
                continue
            if len(para) > self.max_chunk_size:
                out.extend(inner.split(para))
            else:
                out.append(para)
        return out


def get_chunker(name: str, chunk_size: int = 512, overlap: int = 64):
    """Factory by name (CLI / KnowledgeBaseConfig)."""
    name = name.lower()
    if name == "recursive":
        return RecursiveCharacterSplitter(chunk_size, overlap)
    if name == "markdown":
        return MarkdownSplitter(chunk_size, overlap)
    if name == "sliding":
        return SlidingWindowSplitter(chunk_size, overlap)
    if name == "sentence":
        return SentenceSplitter(chunk_size)
    if name == "paragraph":
        return ParagraphSplitter(chunk_size)
    raise ValueError(f"unknown chunker {name!r}")


def chunk_text(text: str, chunker) -> list[Chunk]:
    """Normalize any splitter's output to a list of Chunk."""
    pieces = chunker.split(text)
    out = []
    for i, p in enumerate(pieces):
        if isinstance(p, Chunk):
            p.index = i
            out.append(p)
        else:
            out.append(Chunk(text=p, index=i))
    return out
