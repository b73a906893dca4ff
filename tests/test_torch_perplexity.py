"""The port's perplexity (engine/perplexity.py) against the JAX package's on
the CPU: the same windows (non-overlapping, the trailing one kept from 2
tokens, the chunk capped at max_seq) and the same NLL within 1e-5 relative
(f32 logits, another order of summation), in "quant" mode (the plain
versions of the port's kernels; the JAX products at these widths) and in
"dequant" mode, on the qwen2 tiny model (Q8_0) and the tiny-moe preset
(Q4_K)."""

import numpy as np
import pytest

from fixtures import make_tiny_model
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.engine.perplexity import perplexity as jperplexity
from llama_gguf_tpu.gguf.constants import GGMLType

from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.perplexity import PPL_OWNER, perplexity
from llama_gguf_tpu_torch.engine.runner import bucket_len
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

REL = 1e-5


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ppl")
    qwen = str(d / "qwen2.gguf")
    make_tiny_model(qwen, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                    tokenizer=True, quant=GGMLType.Q8_0)
    moe = str(d / "moe.gguf")
    build_synthetic_gguf(moe, preset="tiny-moe", quant=GGMLType.Q4_K, seed=1)
    return {"qwen2": qwen, "tiny-moe": moe}


def ids_for(n: int, vocab: int, seed: int = 0) -> list[int]:
    return np.random.default_rng(seed).integers(3, vocab, size=n).tolist()


@pytest.mark.parametrize("mode", ["quant", "dequant"])
@pytest.mark.parametrize("model", ["qwen2", "tiny-moe"])
@pytest.mark.parametrize("n,chunk", [(70, 32), (100, 512), (65, 32)],
                         ids=["trailing-6", "chunk-over-max-seq",
                              "trailing-1-dropped"])
def test_perplexity_matches_jax(paths, model, mode, n, chunk):
    teng = Engine.load(paths[model], EngineConfig(weight_mode=mode),
                       device="cpu")
    jeng = JEngine.load(paths[model], JConfig(weight_mode=mode))
    ids = ids_for(n, teng.runner.cfg.vocab_size)
    seen = []
    got = perplexity(teng.runner, ids, chunk=chunk,
                     progress=lambda *a: seen.append(a))
    want = jperplexity(jeng.runner, ids, chunk=chunk)
    assert got.count == want.count
    assert len(got.per_chunk_ppl) == len(want.per_chunk_ppl) == len(seen)
    np.testing.assert_allclose(got.nll_sum, want.nll_sum, rtol=REL)
    np.testing.assert_allclose(got.per_chunk_ppl, want.per_chunk_ppl,
                               rtol=REL)
    np.testing.assert_allclose(got.ppl, want.ppl, rtol=REL)
    assert seen[-1][:2] == (len(seen), len(seen))


def test_windows_pad_to_buckets_on_a_cache_of_their_own(paths):
    """Each window runs one step at its prefill bucket (the trailing one
    padded with dropped positions) on the runner's "perplexity" cache: the
    unowned cache a request uses is not touched."""
    eng = Engine.load(paths["qwen2"], EngineConfig(), device="cpu")
    r = eng.runner
    request = r.init_kv(1)
    request["k"][0].fill_(7.0)
    shapes = []
    step = r.step

    def spy(tokens, positions, lengths, kv, **kw):
        shapes.append((np.shape(tokens), int(np.max(positions)),
                       int(lengths[0]), kv is r._kv[(1, PPL_OWNER)]))
        return step(tokens, positions, lengths, kv, **kw)

    r.step = spy
    try:
        perplexity(r, ids_for(90, 288), chunk=64)
    finally:
        del r.step
    assert shapes == [((1, 64), 63, 64, True),
                      ((1, bucket_len(26)), r.max_seq, 26, True)]
    assert bool((request["k"][0] == 7.0).all())


def test_too_few_tokens_raise(paths):
    eng = Engine.load(paths["qwen2"], EngineConfig(), device="cpu")
    for ids in ([], [5]):
        with pytest.raises(ValueError, match="at least 2 tokens"):
            perplexity(eng.runner, ids)
