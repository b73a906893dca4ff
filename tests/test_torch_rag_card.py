"""RAG on a card: ``EngineEmbedder`` on a tiny BERT GGUF (quant mode, kernels
1 and 2) against the same embedder on the CPU (the kernels' plain
versions), and a knowledge base round trip whose embedder and generator run
on the card.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_rag_card.py
"""

import numpy as np
import pytest
import torch

from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.rag import (EngineEmbedder, KnowledgeBase,
                                      SqliteVectorStore)
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import (build_synthetic_bert,
                                                  build_synthetic_gguf)

TEXTS = ["the quick brown fox jumps over the lazy dog",
         "embedding search query: a passage about a model",
         ("the lazy dog " * 30).strip()]
CARD_VS_CPU = 1e-4  # f32 sums in another order (the kernels)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    return build_synthetic_bert(
        str(tmp_path_factory.mktemp("ragcard") / "bert-q4k.gguf"),
        vocab=300, hidden=256, layers=2, heads=4, ffn=512, ctx=128,
        quant=GGMLType.Q4_K, wordpiece=True)


@pytest.mark.cuda
def test_engine_embedder_on_the_card(cuda, bert):
    card = EngineEmbedder(bert)  # CUDA by default
    cpu = EngineEmbedder(bert, device="cpu")
    assert card.dim == cpu.dim == 256
    Q.reset_launches()
    got = card.embed_batch(TEXTS)
    assert Q.LAUNCHES.get("qmatmul_q4", 0) > 0
    want = cpu.embed_batch(TEXTS)
    assert got.shape == want.shape == (3, 256)
    err = float(np.abs(got - want).max())
    assert err <= CARD_VS_CPU, err
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1, atol=1e-5)


@pytest.mark.cuda
def test_knowledge_base_round_trip_on_the_card(cuda, bert, tmp_path):
    decoder = build_synthetic_gguf(str(tmp_path / "tiny.gguf"),
                                   preset="small", quant=GGMLType.Q4_K)
    engine = Engine.load(decoder, EngineConfig(weight_mode="quant"))
    kb = KnowledgeBase(SqliteVectorStore(str(tmp_path / "kb.db")),
                       embed_model_path=bert, chunk_size=80,
                       chunk_overlap=10, engine=engine)
    assert kb.embedder.device == "cuda"
    n = kb.ingest_text(" ".join(TEXTS * 4), source="texts")
    assert n == kb.store.stats()["chunks"] > 1
    query = "a passage about the lazy dog"
    q = kb.embedder.embed(query)
    for hit in kb.retrieve(query, k=3, search="semantic"):
        blob = kb.store.db.execute("SELECT embedding FROM chunks WHERE id=?",
                                   (hit.chunk_id,)).fetchone()[0]
        stored = np.frombuffer(blob, np.float32)
        assert abs(hit.score - float(stored @ q)) <= 1e-5
    greedy = SamplerConfig(temperature=0.0)
    result = kb.retrieve_and_generate(query, k=2, search="hybrid",
                                      max_tokens=8, sampler=greedy)
    context = "".join(f"[{i + 1}] {h.text}\n"
                      for i, h in enumerate(result.hits))
    prompt = kb.PROMPT_TEMPLATE.format(context=context, question=query)
    assert result.answer == engine.generate(prompt, max_tokens=8,
                                            sampler=greedy)
    assert [c.index for c in result.citations] == [1, 2]
