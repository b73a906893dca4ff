from .chunking import (
    Chunk,
    MarkdownSplitter,
    ParagraphSplitter,
    RecursiveCharacterSplitter,
    SentenceSplitter,
    SlidingWindowSplitter,
    chunk_text,
    get_chunker,
)
from .embeddings import EngineEmbedder, HashEmbedder, make_embedder
from .hnsw import HNSWIndex
from .knowledge_base import (
    Citation,
    ContentKind,
    KnowledgeBase,
    KnowledgeBaseStats,
    RetrieveAndGenerateResult,
)
from .sqlite_store import SearchHit, SqliteVectorStore

__all__ = [
    "Chunk", "Citation", "ContentKind", "EngineEmbedder", "HNSWIndex",
    "HashEmbedder", "KnowledgeBase", "KnowledgeBaseStats",
    "MarkdownSplitter", "ParagraphSplitter", "RecursiveCharacterSplitter",
    "RetrieveAndGenerateResult", "SearchHit", "SentenceSplitter",
    "SlidingWindowSplitter", "SqliteVectorStore", "chunk_text", "get_chunker",
    "make_embedder",
]
