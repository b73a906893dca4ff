"""RAG subcommand dispatch, wired from the main CLI (port of
llama_gguf_tpu/rag/cli.py: the same printed lines).

Defaults come from the [rag] config section; CLI flags override. The
backend is sqlite unless [rag].backend = "pgvector" (+ dsn). An embedding
model (``--model``) loads onto ``--device`` (default CUDA)."""

from __future__ import annotations


def _make_store(cfg, db: str):
    if cfg.backend == "pgvector":
        from .pgvector_store import PgVectorStore

        return PgVectorStore(cfg.dsn or db)
    from .sqlite_store import SqliteVectorStore

    return SqliteVectorStore(db)


def run_rag_command(args) -> int:
    from ..config import Config
    from .knowledge_base import KnowledgeBase

    cfg = Config.load(getattr(args, "config", None)).rag
    store = _make_store(cfg, args.db or cfg.db)
    kb = KnowledgeBase(store, embed_model_path=args.model or cfg.embed_model,
                       chunker=getattr(args, "chunker", None) or cfg.chunker,
                       chunk_size=cfg.chunk_size,
                       chunk_overlap=cfg.chunk_overlap,
                       device=args.device)
    if args.rag_command == "ingest":
        total = 0
        for path in args.paths:
            n = kb.ingest_path(path)
            print(f"{path}: {n} chunks")
            total += n
        print(f"ingested {total} chunks into {args.db or cfg.db}")
        return 0
    k = args.k or cfg.top_k
    search = getattr(args, "search", None) or cfg.search
    if args.rag_command == "search":
        for hit in kb.retrieve(args.query, k=k, search=search):
            print(f"[{hit.score:.3f}] {hit.source}: {hit.text[:100]!r}")
        return 0
    if args.rag_command == "ask":
        result = kb.retrieve_and_generate(args.query, k=k, search=search)
        print(result.answer)
        for c in result.citations:
            print(f"  [{c.index}] {c.source}")
        return 0
    return 2
