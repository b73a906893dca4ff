"""The port's RAG package (llama_gguf_tpu_torch/rag/) against the JAX
package's (llama_gguf_tpu/rag/) on the CPU: the same inputs, from a seed or
from the repo's own files, through both.

Compared: the five chunkers' chunks (text, index and metadata), multimodal
extraction and type detection, HNSW bytes (``to_bytes``), each package's
``from_bytes`` of the other's bytes and their hits, the sqlite store's
semantic, keyword (FTS5 and the LIKE fallback), hybrid and filtered searches
(ids equal, scores bit-equal: the same numpy), a database file written by
one package and read by the other, ingest, ``sync_directory`` and
``DocumentTracker`` (results and state files), pgvector's SQL through a fake
``psycopg2``, ``EngineEmbedder`` on tiny BERT and decoder GGUFs (1e-5),
``retrieve_and_generate`` greedy on a tiny decoder (the same prompt and
answer) and the CLI's ``rag`` lines. Also the cases of tests/test_rag.py on
the port, and the store's lock: threads that share a store read no
document half written."""

import json
import os
import shutil
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from fixtures import make_tiny_model
from test_bert_mamba import build_bert_gguf

import llama_gguf_tpu.rag as J
from llama_gguf_tpu import cli as jcli
from llama_gguf_tpu.rag import multimodal as JM
from llama_gguf_tpu.rag import sync as JSYNC

import llama_gguf_tpu_torch.rag as T
from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.rag import multimodal as TM
from llama_gguf_tpu_torch.rag import sync as TSYNC

ROOT = Path(__file__).resolve().parents[1]
SURVEY = (ROOT / "SURVEY.md").read_text()
CODE = (ROOT / "llama_gguf_tpu" / "engine" / "engine.py").read_text()
EMB_TOL = 1e-5


def chunks_of(mod, text, name, size, overlap):
    return [(c.text, c.index, c.metadata) for c in
            mod.chunk_text(text, mod.get_chunker(name, size, overlap))]


# -- chunkers ------------------------------------------------------------------

@pytest.mark.parametrize("size,overlap", [(512, 64), (200, 0)])
@pytest.mark.parametrize("source", ["survey", "code"])
@pytest.mark.parametrize("name", ["recursive", "markdown", "sliding",
                                  "sentence", "paragraph"])
def test_chunkers_match_jax(name, source, size, overlap):
    text = SURVEY if source == "survey" else CODE
    got = chunks_of(T, text, name, size, overlap)
    assert got == chunks_of(J, text, name, size, overlap)
    assert len(got) > 3


def _splitter_cases():
    md = ("# Title\nintro text\n\n## Section A\ncontent a\n\n"
          "## Section B\ncontent b here\n\n```\n# not a header\n```\nafter")
    return {
        "recursive_size": lambda m: m.RecursiveCharacterSplitter(
            chunk_size=100, chunk_overlap=10).split(
                "para one.\n\n" + ("word " * 300) + "\n\nlast para."),
        "recursive_overlap": lambda m: m.RecursiveCharacterSplitter(
            chunk_size=50, chunk_overlap=20).split("abcdefghij " * 20),
        "recursive_separators": lambda m: m.RecursiveCharacterSplitter(
            30, 5, separators=[";", ""], strip_whitespace=False).split(
                "alpha;beta;" * 12 + "x" * 70),
        "markdown": lambda m: [(c.text, c.metadata) for c in
                               m.MarkdownSplitter(max_chunk_size=200)
                               .split(md)],
        "markdown_no_headers": lambda m: [
            (c.text, c.metadata) for c in m.MarkdownSplitter(
                40, 8, include_headers=False).split(md * 3)],
        "sliding": lambda m: m.SlidingWindowSplitter(
            window_size=20, overlap=5).split(
                "the quick brown fox jumps over the lazy dog again"),
        "sliding_chars": lambda m: m.SlidingWindowSplitter(
            16, 4, respect_word_boundaries=False).split(SURVEY[:300]),
        "sentence": lambda m: m.SentenceSplitter(max_chunk_size=11).split(
            "One. Two! Three? Four."),
        "paragraph": lambda m: m.ParagraphSplitter().split(
            "a\n\nb\n\n\nc"),
        "paragraph_long": lambda m: m.ParagraphSplitter(64).split(
            SURVEY[:2000]),
    }


@pytest.mark.parametrize("case", list(_splitter_cases()))
def test_splitter_cases_match_jax(case):
    fn = _splitter_cases()[case]
    got = fn(T)
    assert got == fn(J) and got


@pytest.mark.parametrize("call", [
    lambda m: m.RecursiveCharacterSplitter(chunk_size=10, chunk_overlap=10),
    lambda m: m.SlidingWindowSplitter(10, 10),
    lambda m: m.get_chunker("nope"),
], ids=["recursive", "sliding", "unknown"])
def test_splitter_errors_match_jax(call):
    with pytest.raises(ValueError) as got:
        call(T)
    with pytest.raises(ValueError) as want:
        call(J)
    assert str(got.value) == str(want.value)


# -- tests/test_rag.py's chunker cases on the port --------------------------------

def test_port_recursive_splitter_respects_size():
    text = "para one.\n\n" + ("word " * 300) + "\n\nlast para."
    chunks = T.RecursiveCharacterSplitter(100, 10).split(text)
    assert all(len(c) <= 100 for c in chunks)
    joined = " ".join(chunks)
    assert "para one." in joined and "last para." in joined


def test_port_markdown_and_sentence_splitters():
    md = ("# Title\nintro text\n\n## Section A\ncontent a\n\n"
          "```\n# not a header\n```\nafter")
    chunks = T.MarkdownSplitter(max_chunk_size=200).split(md)
    paths = [c.metadata.get("headers", []) for c in chunks]
    assert ["Title"] in paths and ["Title", "Section A"] in paths
    assert "# not a header" in " ".join(c.text for c in chunks)
    assert T.SentenceSplitter(max_chunk_size=11).split(
        "One. Two! Three? Four.") == ["One. Two!", "Three?", "Four."]
    assert T.ParagraphSplitter().split("a\n\nb\n\n\nc") == ["a", "b", "c"]


# -- multimodal -------------------------------------------------------------------

MD = ("Intro text here.\n\n"
      "```python\ndef hello():\n    print('world')\n```\n"
      "Some middle prose.\n"
      "| a | b |\n|---|---|\n| 1 | 2 |\n"
      "![diagram](img/d.png)\n"
      "Closing words. ![broken](no-close\n![alt only] and ```unclosed")


def _elements(doc):
    return [(e.content_type.value, e.text, e.source_uri, e.metadata)
            for e in doc.elements], doc.source_uri, doc.raw_text


@pytest.mark.parametrize("fmt", ["markdown", "csv", "plain"])
@pytest.mark.parametrize("text", ["md", "survey", "table"])
def test_multimodal_extract_matches_jax(text, fmt):
    src = {"md": MD, "survey": SURVEY,
           "table": "| a | b |\n|---|---|\n| 1 | 2 |"}[text]

    def run(m):
        ex = m.ContentExtractor(m.ExtractionConfig(
            table_format=m.TableFormat(fmt)))
        return (_elements(ex.extract_markdown(src, "doc.md")),
                _elements(ex.extract_plain(src)),
                [e.text for e in ex.extract_markdown(src).by_type(
                    m.ContentType.TABLE)])

    got = run(TM)
    assert got == run(JM)
    assert got[0][0]


def test_multimodal_switches_match_jax():
    def run(m):
        ex = m.ContentExtractor(m.ExtractionConfig(
            extract_tables=False, extract_code_blocks=False,
            extract_image_refs=False))
        return _elements(ex.extract_markdown(MD))

    assert run(TM) == run(JM)


@pytest.mark.parametrize("text", [
    "plain words", "| a | b |\n| 1 | 2 |", "```\ncode\n```", "![x](y.png)",
    "words and\n```\ncode\n```", "", "| a | b |\nprose ![i](j)", MD])
def test_detect_content_type_matches_jax(text):
    got = TM.ContentExtractor.detect_content_type(text)
    assert got.value == JM.ContentExtractor.detect_content_type(text).value


# -- HNSW ---------------------------------------------------------------------------

HNSW_CASES = {
    # name: (dim, n, index kwargs, string ids)
    "brute-40": (16, 40, {}, False),
    "graph-300-m8": (32, 300, dict(m=8, ef_construction=64), False),
    "graph-100-m4-str": (16, 100, dict(m=4), True),
    "dot-200": (24, 200, dict(metric="dot", seed=3), False),
}


def _hnsw_pair(case):
    dim, n, kw, str_ids = HNSW_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    data = rng.normal(size=(n, dim)).astype(np.float32)
    queries = rng.normal(size=(8, dim)).astype(np.float32)
    out = []
    for mod in (J, T):
        idx = mod.HNSWIndex(dim, **kw)
        for i in range(n):
            idx.add(f"id{i}" if str_ids else i, data[i])
        out.append(idx)
    return out, queries


@pytest.mark.parametrize("case", list(HNSW_CASES))
def test_hnsw_bytes_and_hits_match_jax(case):
    (jidx, tidx), queries = _hnsw_pair(case)
    blob = tidx.to_bytes()
    assert blob == jidx.to_bytes()
    # each package reads the other's bytes; hits and similarities equal
    crossed = (J.HNSWIndex.from_bytes(blob),
               T.HNSWIndex.from_bytes(jidx.to_bytes()))
    for q in queries:
        want = jidx.search(q, 5)
        assert tidx.search(q, 5) == want
        assert tidx.search(q, 7, ef=20) == jidx.search(q, 7, ef=20)
        for idx in crossed:
            assert idx.search(q, 5) == want
    assert T.HNSWIndex(4).search(queries[0][:4]) == []


def test_port_hnsw_recall_vs_bruteforce():
    rng = np.random.default_rng(0)
    dim, n = 32, 500
    data = rng.normal(size=(n, dim)).astype(np.float32)
    idx = T.HNSWIndex(dim, m=8, ef_construction=64)
    for i in range(n):
        idx.add(i, data[i])
    norm = data / np.linalg.norm(data, axis=1, keepdims=True)
    hits = 0
    for _ in range(20):
        q = rng.normal(size=dim).astype(np.float32)
        true_top = set(np.argsort(-(norm @ (q / np.linalg.norm(q))))[:10])
        hits += len(true_top & {i for i, _ in idx.search(q, 10, ef=80)})
    assert hits / 200 >= 0.9


# -- the sqlite store ---------------------------------------------------------------

DOCS = {
    "doc1": ("the cat sat on the mat", {"topic": "animals", "year": 2020}),
    "doc2": ("quantum computing uses qubits", {"topic": "physics",
                                               "year": 2023}),
    "doc3": ("cats and dogs are pets", {"topic": "animals", "year": 2021}),
    "doc4": ("the mat of a quantum cat", {"topic": "physics", "year": 2019}),
}


def fill(mod, store, emb):
    for doc_id, (text, meta) in DOCS.items():
        store.add_document(doc_id, f"{doc_id}.txt",
                           [(text, emb.embed(text), meta),
                            (text.upper() + " again", emb.embed(text[::-1]),
                             dict(meta, part=2))],
                           content_hash=store.content_hash(text))
    return store


@pytest.fixture
def stores():
    out = []
    for mod in (J, T):
        emb = mod.HashEmbedder(dim=64)
        out.append((fill(mod, mod.SqliteVectorStore(":memory:"), emb), emb))
    return out


def hits_of(hits):
    return [(h.chunk_id, h.doc_id, h.text, h.score, h.source, h.chunk_index,
             h.metadata) for h in hits]


SEARCHES = {
    "semantic": lambda s, e: s.semantic_search(e.embed("kitten on a mat"), 3),
    "semantic_all": lambda s, e: s.semantic_search(e.embed("cats"), 20),
    "keyword": lambda s, e: s.keyword_search("qubits computing", 2),
    "keyword_or": lambda s, e: s.keyword_search("cat, mat! quantum?", 5),
    "keyword_none": lambda s, e: s.keyword_search("zebra", 5),
    "hybrid": lambda s, e: s.hybrid_search("cat mat", e.embed("cat mat"), 3),
    "hybrid_rrf10": lambda s, e: s.hybrid_search(
        "quantum", e.embed("physics"), 4, rrf_k=10),
    "filter_eq": lambda s, e: s.semantic_search(
        e.embed("animals"), 3, filters={"topic": "animals"}),
    "filter_gte": lambda s, e: s.semantic_search(
        e.embed("animals"), 3, filters={"year": {"$gte": 2021}}),
    "filter_in": lambda s, e: s.semantic_search(
        e.embed("animals"), 3, filters={"topic": {"$in": ["physics"]}}),
    "filter_ne_lt": lambda s, e: s.keyword_search(
        "cat mat", 5, filters={"topic": {"$ne": "physics"},
                               "year": {"$lt": 2021}}),
    "filter_hybrid": lambda s, e: s.hybrid_search(
        "cat", e.embed("cat"), 3, filters={"part": 2}),
}


@pytest.mark.parametrize("fts", [True, False], ids=["fts5", "like"])
@pytest.mark.parametrize("name", list(SEARCHES))
def test_store_searches_match_jax(stores, name, fts):
    (js, je), (ts, te) = stores
    if not fts:  # the LIKE fallback, as where sqlite lacks FTS5
        js._fts = ts._fts = False
    got, want = SEARCHES[name](ts, te), SEARCHES[name](js, je)
    assert hits_of(got) == hits_of(want)
    # LIKE counts whole query words, punctuation included
    if name != "keyword_none" and (fts or name != "keyword_or"):
        assert got


def test_store_filter_errors_and_delete_match_jax(stores):
    (js, je), (ts, te) = stores
    for s in (js, ts):
        with pytest.raises(ValueError, match="unknown filter op"):
            s.semantic_search(je.embed("x"), 2, filters={"a": {"$xx": 1}})
        s.delete_document("doc1")
    assert ts.stats() == js.stats()
    assert ts.list_documents() == js.list_documents()
    q = te.embed("cat on the mat")
    assert hits_of(ts.semantic_search(q, 3)) == \
        hits_of(js.semantic_search(q, 3))
    assert all(h.doc_id != "doc1" for h in ts.semantic_search(q, 3))
    assert ts.has_document("doc2") and not ts.has_document("doc1")
    assert not ts.has_document("doc2", "stale")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_database_file_read_across_packages(tmp_path, writer):
    """A file written by one package, then read by each: the same rows,
    documents, searches and persisted index."""
    path = str(tmp_path / "kb.db")
    mod = J if writer == "jax" else T
    kb = mod.KnowledgeBase(mod.SqliteVectorStore(path),
                           embedder=mod.HashEmbedder(128))
    kb.ingest_text(SURVEY[:6000], source="SURVEY.md", chunker="markdown")
    kb.ingest_text(CODE[:8000], source="engine.py",
                   metadata={"lang": "python"})
    assert kb.retrieve("graph capture", 3, "semantic")  # writes ann_index
    kb.store.close()
    (js, je), (ts, te) = [(m.SqliteVectorStore(path), m.HashEmbedder(128))
                          for m in (J, T)]
    assert ts.stats() == js.stats() and ts.stats()["chunks"] > 10
    assert ts.list_documents() == js.list_documents()
    for name in ("semantic", "keyword", "hybrid"):
        got = T.KnowledgeBase(ts, embedder=te).retrieve("sampler temperature",
                                                         4, name)
        want = J.KnowledgeBase(js, embedder=je).retrieve("sampler temperature",
                                                         4, name)
        assert hits_of(got) == hits_of(want) and got
    blob = ts.db.execute("SELECT data FROM ann_index").fetchone()[0]
    assert blob == js.db.execute("SELECT data FROM ann_index").fetchone()[0]
    q = te.embed("kv cache")
    assert T.HNSWIndex.from_bytes(blob).search(q, 5) == \
        J.HNSWIndex.from_bytes(blob).search(q, 5) == ts._index.search(q, 5)


def test_store_lock_keeps_documents_whole():
    """The port's store holds its lock in every public method: while two
    threads rewrite a document of 50 chunks, four reader threads (more
    threads than this test's cores need, the switch interval shortened)
    see all of its chunks or none, and no call fails. The JAX store, which
    has no lock, lets a reader see a part and calls fail on the shared
    connection (printed, not asserted: it depends on timing)."""
    def torn_reads(mod):
        store = mod.SqliteVectorStore(":memory:")
        rows = [(f"chunk {i} alpha", np.ones(8, np.float32), {})
                for i in range(50)]
        seen, errors, done = [], [], threading.Event()

        def read():
            while not done.is_set():
                try:
                    n = store.stats()["chunks"]
                    store.keyword_search("alpha", 3)
                except Exception as e:  # the JAX store's shared cursor
                    errors.append(repr(e))
                    continue
                if n not in (0, 50):
                    seen.append(n)

        def write():
            for j in range(60):
                try:
                    store.add_document("doc", "doc", rows,
                                       content_hash=str(j))
                except Exception as e:
                    errors.append(repr(e))

        readers = [threading.Thread(target=read) for _ in range(4)]
        writers = [threading.Thread(target=write) for _ in range(2)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in readers + writers:
                t.start()
            for t in writers:
                t.join(timeout=120)
        finally:
            done.set()
            for t in readers:
                t.join(timeout=120)
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in readers + writers)
        return len(seen), errors, store.stats()["chunks"]

    assert torn_reads(T) == (0, [], 50)
    torn, errors, _ = torn_reads(J)
    print(f"the JAX store: {torn} torn reads, {len(errors)} failed calls")


# -- the knowledge base -------------------------------------------------------------

def kb_pair(**kw):
    return [mod.KnowledgeBase(mod.SqliteVectorStore(":memory:"),
                              embedder=mod.HashEmbedder(64), **kw)
            for mod in (J, T)]


def test_kb_ingest_retrieve_citations_match_jax():
    text = ("The eiffel tower is in paris. " * 4 +
            "\n\nMount fuji is the tallest mountain in japan. " * 4)
    jkb, tkb = kb_pair(chunk_size=120, chunk_overlap=20)
    assert tkb.ingest_text(text, source="facts.txt") == \
        jkb.ingest_text(text, source="facts.txt") >= 2
    for search in ("semantic", "keyword", "hybrid"):
        assert hits_of(tkb.retrieve("tallest mountain in japan", 2, search)) \
            == hits_of(jkb.retrieve("tallest mountain in japan", 2, search))
    got = tkb.retrieve_and_generate("where is the eiffel tower", k=2)
    want = jkb.retrieve_and_generate("where is the eiffel tower", k=2)
    assert got.answer == want.answer and "eiffel" in got.answer.lower()
    assert [vars(c) for c in got.citations] == \
        [vars(c) for c in want.citations]
    assert got.citations[0].index == 1
    assert vars(tkb.stats) == vars(jkb.stats)
    assert T.KnowledgeBase.PROMPT_TEMPLATE == J.KnowledgeBase.PROMPT_TEMPLATE


def test_kb_incremental_and_directory_ingest_match_jax(tmp_path):
    (tmp_path / "a.md").write_text("# Doc\nmarkdown body text here")
    (tmp_path / "b.py").write_text("def fn():\n    return 42")
    (tmp_path / "c.png").write_bytes(b"\x89PNG fake")
    (tmp_path / "d.txt").write_text("plain notes about widgets")
    jkb, tkb = kb_pair()
    assert tkb.ingest_path(str(tmp_path)) == jkb.ingest_path(str(tmp_path))
    assert tkb.ingest_path(str(tmp_path)) == 0
    assert tkb.ingest_path(str(tmp_path / "c.png")) == 0
    jkb.ingest_path(str(tmp_path))
    (tmp_path / "d.txt").write_text("version two about gadgets")
    assert tkb.ingest_path(str(tmp_path / "d.txt")) == \
        jkb.ingest_path(str(tmp_path / "d.txt")) > 0
    for q in ("markdown body", "gadgets", "widgets"):
        assert hits_of(tkb.retrieve(q, 3, "keyword")) == \
            hits_of(jkb.retrieve(q, 3, "keyword"))
    assert tkb.retrieve("markdown body", 1, "keyword")[0].metadata[
        "content_kind"] == "markdown"
    jkb.retrieve("markdown body", 1, "keyword")
    assert vars(tkb.stats) == vars(jkb.stats)
    tkb.delete(str(tmp_path / "b.py"))
    jkb.delete(str(tmp_path / "b.py"))
    assert tkb.store.list_documents() == jkb.store.list_documents()
    assert [T.ContentKind.from_path(p).value for p in
            ("x.md", "y.RS", "z.png", "w.ogg", "v")] == \
        [J.ContentKind.from_path(p).value for p in
         ("x.md", "y.RS", "z.png", "w.ogg", "v")]


def test_chunk_content_type_tagging_matches_jax():
    jkb, tkb = kb_pair(chunk_size=64, chunk_overlap=0)
    for kb in (jkb, tkb):
        kb.ingest_text("```\nfrobnicate_the_widget()\n```", source="code.md",
                       doc_id="code.md")
        kb.ingest_text("just ordinary prose about widgets", source="t.txt",
                       doc_id="t.txt")
    f = {"content_type": "code"}
    got = tkb.retrieve("widget", k=5, search="keyword", filters=f)
    assert hits_of(got) == hits_of(jkb.retrieve("widget", 5, "keyword", f))
    assert got and all(h.metadata["content_type"] == "code" for h in got)


def test_sync_directory_matches_jax(tmp_path):
    docs = tmp_path / "docs"
    (docs / "sub").mkdir(parents=True)
    (docs / "a.txt").write_text("alpha document about apples")
    (docs / "b.txt").write_text("beta document about bananas")
    (docs / "sub" / "e.md").write_text("# E\nepsilon notes")
    (docs / "f.png").write_bytes(b"png")
    jkb, tkb = kb_pair()

    def both(**kw):
        got, want = (kb.sync_directory(str(docs), **kw) for kb in (tkb, jkb))
        assert vars(got) == vars(want)
        assert tkb.store.list_documents() == jkb.store.list_documents()
        return (got.added, got.updated, got.deleted, got.unchanged)

    assert both() == (3, 0, 0, 0)
    assert both() == (0, 0, 0, 3)
    (docs / "a.txt").write_text("alpha document about apricots now")
    (docs / "c.txt").write_text("gamma document about cherries")
    (docs / "b.txt").unlink()
    assert both() == (1, 1, 1, 1)
    assert both(pattern="*.txt", recursive=False) == (0, 0, 0, 2)
    assert both(chunker="sentence") == (0, 0, 0, 3)
    for q in ("bananas", "apricots"):
        assert hits_of(tkb.retrieve(q, 5, "keyword")) == \
            hits_of(jkb.retrieve(q, 5, "keyword"))
    assert vars(tkb.stats) == vars(jkb.stats)
    assert [str(p) for p in TSYNC.collect_files(docs, "*.md")] == \
        [str(p) for p in JSYNC.collect_files(docs, "*.md")]


def _state(path):
    data = json.loads(Path(path).read_text())
    for doc in data["entries"].values():
        doc["last_indexed"] = 0.0
    return data


def test_document_tracker_state_files_match_jax(tmp_path):
    docs = tmp_path / "src"
    docs.mkdir()
    (docs / "x.md").write_text("hello world")
    (docs / "y.txt").write_text("second file")
    states = {}
    for name, mod in (("jax", JSYNC), ("port", TSYNC)):
        tr = mod.DocumentTracker(state_path=str(tmp_path / f"{name}.json"))
        changes = tr.detect_changes(docs)
        assert [c.kind for c in changes] == ["new", "new"]
        for i, c in enumerate(changes):
            tr.record_indexed(c.uri, mod.content_hash(c.content), [i, i + 1])
        tr.save()
        states[name] = str(tmp_path / f"{name}.json")
    assert _state(states["port"]) == _state(states["jax"])
    assert TSYNC.content_hash("héllo") == JSYNC.content_hash("héllo")
    (docs / "x.md").write_text("hello world changed")
    (docs / "y.txt").unlink()
    (docs / "z.txt").write_text("new one")
    # each package's tracker reads the other's state file
    for mod, state in ((TSYNC, states["jax"]), (JSYNC, states["port"]),
                       (TSYNC, states["port"])):
        tr = mod.DocumentTracker(state_path=state)
        tr.load()
        assert len(tr) == 2
        got = [(c.kind, Path(c.uri).name, c.old_chunk_ids)
               for c in tr.detect_changes(docs)]
        assert got == [("modified", "x.md", [0, 1]), ("new", "z.txt", []),
                       ("deleted", "y.txt", [1, 2])]
        tr.record_deleted(str(docs / "y.txt"))
        assert tr.tracked_sources() == [str(docs / "x.md")]
    miss = TSYNC.DocumentTracker().detect_file_change(docs / "nope")
    assert miss.kind == "error" and miss.kind == JSYNC.DocumentTracker() \
        .detect_file_change(docs / "nope").kind
    assert vars(TSYNC.SyncResult(added=2, deleted=1)) == \
        vars(JSYNC.SyncResult(added=2, deleted=1))
    assert TSYNC.SyncResult(added=2, deleted=1).changed == 3


# -- pgvector ------------------------------------------------------------------------

def test_pgvector_gate_matches_jax(monkeypatch):
    from llama_gguf_tpu.rag.pgvector_store import PgVectorStore as JPg

    from llama_gguf_tpu_torch.rag.pgvector_store import PgVectorStore

    monkeypatch.setitem(sys.modules, "psycopg2", None)
    with pytest.raises(RuntimeError, match="psycopg2") as got:
        PgVectorStore("postgres://nope")
    with pytest.raises(RuntimeError) as want:
        JPg("postgres://nope")
    assert str(got.value) == str(want.value)


def fake_psycopg2(log: list):
    """A psycopg2 stand-in that records every (sql, params) and answers
    with fixed rows."""
    rows = [(1, "d1", "text one", 0, {"a": 1}, "src1", 0.9),
            (2, "d2", "text two", 1, '{"b": 2}', None, 0.5)]

    class Cursor:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def execute(self, sql, params=None):
            log.append((" ".join(sql.split()), params))

        def fetchone(self):
            return ("h1",) if "content_hash" in log[-1][0] else (3,)

        def fetchall(self):
            return list(rows)

    class Conn:
        def __init__(self, dsn):
            log.append(("connect", dsn))

        def cursor(self):
            return Cursor()

        def commit(self):
            log.append(("commit", None))

        def close(self):
            log.append(("close", None))

    return types.SimpleNamespace(connect=Conn)


@pytest.mark.parametrize("index", ["hnsw", "ivfflat"])
def test_pgvector_sql_matches_jax(monkeypatch, index):
    from llama_gguf_tpu.rag.pgvector_store import PgVectorStore as JPg

    from llama_gguf_tpu_torch.rag.pgvector_store import PgVectorStore

    rng = np.random.default_rng(5)
    emb = rng.normal(size=8).astype(np.float32)
    results = []
    for cls in (JPg, PgVectorStore):
        log = []
        monkeypatch.setitem(sys.modules, "psycopg2", fake_psycopg2(log))
        s = cls("postgres://db", table_prefix="kb", dim=8, index=index)
        out = [s.has_document("d1"), s.has_document("d1", "h2"),
               s.add_document("d1", "src", [("t", emb, {"m": 1}),
                                            ("u", emb * 2, None)],
                              content_hash="h1", metadata={"x": 1}),
               hits_of(s.semantic_search(emb, 2, {"topic": "a",
                                                  "year": {"$gte": 3}})),
               hits_of(s.keyword_search("cats dogs", 2,
                                        {"k": {"$in": [1, 2]}})),
               hits_of(s.hybrid_search("cats", emb, 2)), s.stats(),
               s.content_hash("abc")]
        s.delete_document("d1")
        s.close()
        results.append((out, [(sql, p) for sql, p in log
                              if not isinstance(p, tuple)
                              or not any(isinstance(x, float) and x > 1e9
                                         for x in p)]))
    assert results[1] == results[0]
    assert any("USING " + index in sql for sql, _ in results[1][1])


# -- embedders ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def embed_models(tmp_path_factory):
    d = tmp_path_factory.mktemp("embed")
    bert = str(d / "bert.gguf")
    build_bert_gguf(bert)
    dec = str(d / "dec.gguf")
    make_tiny_model(dec, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=512, seed=11,
                    tokenizer=True)
    return {"bert": bert, "decoder": dec}


TEXTS = {"bert": ["tok7 tok12 tok40 tok3 tok9", "tok1 tok2", "tok5 " * 20],
         "decoder": ["hello world", "the moon orbits the earth", "a" * 40]}


@pytest.mark.parametrize("pooling", ["mean", "last"])
@pytest.mark.parametrize("kind", ["bert", "decoder"])
def test_engine_embedder_matches_jax(embed_models, kind, pooling):
    path = embed_models[kind]
    got = T.EngineEmbedder(path, pooling=pooling, device="cpu")
    want = J.EngineEmbedder(path, pooling=pooling)
    assert got.dim == want.dim
    vg, vw = got.embed_batch(TEXTS[kind]), want.embed_batch(TEXTS[kind])
    assert vg.shape == vw.shape == (3, got.dim)
    np.testing.assert_allclose(vg, vw, rtol=0, atol=EMB_TOL)
    np.testing.assert_allclose(np.linalg.norm(vg, axis=1), 1, atol=1e-5)
    # a KB built on the port's engine ingests and retrieves as JAX's
    jkb = J.KnowledgeBase(J.SqliteVectorStore(":memory:"), embedder=want,
                          chunk_size=40, chunk_overlap=8)
    tkb = T.KnowledgeBase(T.SqliteVectorStore(":memory:"), embedder=got,
                          chunk_size=40, chunk_overlap=8)
    text = " ".join(TEXTS[kind] * 3)
    assert tkb.ingest_text(text, "t") == jkb.ingest_text(text, "t")
    g, w = tkb.retrieve(TEXTS[kind][0], 3, "semantic"), \
        jkb.retrieve(TEXTS[kind][0], 3, "semantic")
    assert [h.text for h in g] == [h.text for h in w]
    np.testing.assert_allclose([h.score for h in g], [h.score for h in w],
                               atol=1e-5)


def test_embedder_device_and_errors(embed_models, tmp_path):
    """``device`` defaults to CUDA and reaches Engine.load (absent CUDA
    raises at the first embed); make_embedder and KnowledgeBase pass it on;
    a T5 engine's ``dim`` raises as JAX's does."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.EngineEmbedder(embed_models["bert"]).embed("tok1")
        kb = T.KnowledgeBase(T.SqliteVectorStore(":memory:"),
                             embed_model_path=embed_models["bert"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            kb.ingest_text("tok1 tok2")
    kb = T.KnowledgeBase(T.SqliteVectorStore(":memory:"),
                         embed_model_path=embed_models["bert"], device="cpu")
    assert kb.embedder.device == "cpu" and kb.ingest_text("tok1 tok2") == 1
    assert isinstance(T.make_embedder(), T.HashEmbedder)
    with pytest.raises(ValueError, match="need model_path or engine"):
        T.EngineEmbedder()
    from llama_gguf_tpu.utils.synthetic import build_synthetic_t5

    t5 = build_synthetic_t5(str(tmp_path / "t5.gguf"))
    errors = []
    for emb in (T.EngineEmbedder(t5, device="cpu"), J.EngineEmbedder(t5)):
        with pytest.raises(AttributeError) as e:
            emb.dim
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("text", ["", "Hello, World!", SURVEY[:3000]])
@pytest.mark.parametrize("dim", [64, 256])
def test_hash_embedder_bit_equal(text, dim):
    got = T.HashEmbedder(dim).embed(text)
    assert got.dtype == np.float32
    assert np.array_equal(got, J.HashEmbedder(dim).embed(text))


def test_retrieve_and_generate_matches_jax(embed_models):
    """Greedy, dequant mode, a tiny decoder: both packages build the same
    prompt from the same hits and generate the same answer. The logit bias
    bans EOS and the bytes above 0x7f (token ids 131-258), whose text the
    decoder withholds, so the answer is not empty."""
    from llama_gguf_tpu.engine.engine import Engine as JEngine
    from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
    from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler

    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

    path = embed_models["decoder"]
    engines = (JEngine.load(path, JConfig(weight_mode="dequant")),
               Engine.load(path, EngineConfig(weight_mode="dequant"),
                           device="cpu"))
    bias = {i: -100.0 for i in range(131, 259)}
    bias[engines[1].tokenizer.eos_id] = -100.0
    prompts = []
    out = []
    for mod, eng, sampler in zip((J, T), engines,
                                 (JSampler(temperature=0.0, logit_bias=bias),
                                  SamplerConfig(temperature=0.0,
                                                logit_bias=bias))):
        real = eng.generate

        def generate(prompt, real=real, **kw):
            prompts.append(prompt)
            return real(prompt, **kw)

        eng.generate = generate
        kb = mod.KnowledgeBase(mod.SqliteVectorStore(":memory:"),
                               embedder=mod.HashEmbedder(64), engine=eng)
        kb.ingest_text("the moon orbits the earth. " * 3, source="astro")
        kb.ingest_text("cats sleep on warm mats.", source="pets")
        out.append(kb.retrieve_and_generate("what orbits the earth", k=1,
                                            search="keyword", max_tokens=8,
                                            sampler=sampler))
    assert prompts[0] == prompts[1] and "[1] the moon" in prompts[0]
    assert out[1].answer == out[0].answer and out[1].answer
    assert [vars(c) for c in out[1].citations] == \
        [vars(c) for c in out[0].citations]


# -- the CLI --------------------------------------------------------------------------

def run_both(capsys, argv, port_extra=(), swap=None):
    """(port stdout, JAX stdout) of ``rag`` argv; ``swap`` maps a path in
    argv to the JAX run's own (its database)."""
    assert cli.main(["rag"] + argv + list(port_extra)) == 0
    got = capsys.readouterr().out
    jargv = [swap.get(a, a) if swap else a for a in argv]
    assert jcli.main(["rag"] + jargv) == 0
    want = capsys.readouterr().out
    for a, b in (swap or {}).items():
        want = want.replace(b, a)
    return got, want


@pytest.fixture
def corpus(tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    shutil.copy(ROOT / "SURVEY.md", d / "SURVEY.md")
    (d / "engine.py").write_text(CODE[:6000])
    (d / "notes.txt").write_text("tok3 tok9 tok40 notes about tok12")
    (d / "pic.png").write_bytes(b"png")
    return d


@pytest.mark.parametrize("model", ["hash", "bert"])
def test_rag_cli_lines_match_jax(tmp_path, corpus, capsys, embed_models,
                                 model):
    db, jdb = str(tmp_path / "kb.db"), str(tmp_path / "jkb.db")
    extra = ["--model", embed_models["bert"]] if model == "bert" else []
    port_extra = ["--device", "cpu"] if model == "bert" else []
    swap = {db: jdb}
    got, want = run_both(capsys, ["ingest", "--db", db, str(corpus)] + extra,
                         port_extra, swap)
    assert got == want and got.endswith(f"into {db}\n")
    got, want = run_both(capsys, ["ingest", "--db", db, "--chunker",
                                  "sentence", str(corpus / "notes.txt"),
                                  str(corpus / "pic.png")] + extra,
                         port_extra, swap)
    assert got == want
    for search in ("semantic", "keyword", "hybrid"):
        got, want = run_both(capsys, ["search", "tok12 notes", "--db", db,
                                      "-k", "3", "--search", search] + extra,
                             port_extra, swap)
        assert got == want and got.count("\n") >= 1
    got, want = run_both(capsys, ["ask", "what are the notes", "--db", db]
                         + extra, port_extra, swap)
    assert got == want and "  [1] " in got


def test_rag_cli_config_section_matches_jax(tmp_path, corpus, capsys,
                                            monkeypatch):
    """[rag]'s db, chunker, sizes, top_k and search are the defaults."""
    for var in list(os.environ):
        if var.startswith("LLAMA_GGUF_"):
            monkeypatch.delenv(var)
    outs = []
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        db = str(tmp_path / f"{name}.db")
        conf = tmp_path / f"{name}.toml"
        conf.write_text(f'[rag]\ndb = "{db}"\nchunker = "paragraph"\n'
                        'chunk_size = 300\nchunk_overlap = 20\ntop_k = 2\n'
                        'search = "keyword"\n')
        for argv in (["ingest", str(corpus)], ["search", "cache"],
                     ["ask", "kernel"]):
            assert main(["rag"] + argv + ["--config", str(conf)]) == 0
        outs.append(capsys.readouterr().out.replace(db, "DB"))
    assert outs[0] == outs[1] and outs[0].count("\n  [") == 2


def test_rag_parser_matches_jax():
    """The port's rag flags are JAX's plus --device."""
    def flags(parser):
        sub = parser._subparsers._group_actions[0].choices["rag"]
        rag = sub._subparsers._group_actions[0].choices
        return {name: sorted(o for a in p._actions for o in a.option_strings)
                for name, p in rag.items()}

    got, want = flags(cli.build_parser()), flags(jcli.build_parser())
    assert got.keys() == want.keys() == {"ingest", "search", "ask"}
    for name in got:
        assert got[name] == sorted(want[name] + ["--device"])
