"""The port's prompt cache (engine/prompt_cache.py) against the JAX
package's on the CPU: the same hits, misses, evictions and restored values
on the same call sequence; session files written by either package load in
the other with equal bytes (f32 and bf16 KV); Engine, BatchedEngine and the
server with a prompt cache give the tokens they give without one and count
their hits; a hybrid model stores nothing.

Models: the qwen2 tiny model of the JAX engine tests (F32, ctx 96), the port
in "quant" mode and the JAX engine in "dequant" mode, greedy; tokens equal.
Restored values are exact copies (f32 and bf16 bits)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fixtures import make_tiny_model
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.engine.prompt_cache import PromptCache as JPromptCache
from llama_gguf_tpu.models import kv as JKV
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler

from llama_gguf_tpu_torch.convert import kv_from_numpy, kv_to_numpy
from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.prompt_cache import PromptCache
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.models import kv as KV
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.server.app import ServerConfig, ServerState
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
JGREEDY = JSampler(temperature=0.0, repetition_penalty=1.0)
PROMPT = "the quick brown fox jumps over"


def caches(fmt: str = "f32", layers: int = 2, batch: int = 2,
           seq: int = 16, seed: int = 0):
    """A JAX cache with every position written from seeded values, and the
    port's copy of it."""
    rng = np.random.default_rng(seed)
    jkv = JKV.init_cache(layers, batch, seq, 1, 4, fmt=fmt)
    pos = jnp.asarray(np.tile(np.arange(seq, dtype=np.int32), (batch, 1)))
    for i in range(layers):
        k, v = (jnp.asarray(rng.normal(size=(batch, seq, 1, 4)).astype(
            np.float32)) for _ in range(2))
        jkv = JKV.write(jkv, i, k, v, pos)
    return jkv, kv_from_numpy({key: [np.asarray(a) for a in jkv[key]]
                               for key in ("k", "v")})


def same_cache(tkv, jkv, fmt: str) -> None:
    got = kv_to_numpy(tkv)
    for key in ("k", "v"):
        for a, b in zip(got[key], jkv[key]):
            b = np.asarray(b)
            np.testing.assert_array_equal(
                a, b.view(np.uint16) if fmt == "bf16" else b)


def stats(cache) -> tuple:
    s = cache.stats
    return (s.hits, s.misses, s.evictions, s.stored, cache.entry_count,
            cache.memory_bytes)


@pytest.mark.parametrize("fmt", ["f32", "bf16"])
def test_call_sequence_matches_jax(fmt):
    """put, restore (prefix, miss, full match = len - 1, row 1), LRU
    eviction under a byte budget and clear: the same stats, shared lengths
    and restored caches, written in place into the port's buffers."""
    jsrc, tsrc = caches(fmt, seed=1)
    jdst, tdst = caches(fmt, seed=2)
    bufs = [t.data_ptr() for t in tdst["k"] + tdst["v"]]
    entry = 2 * 2 * 8 * 4 * (4 if fmt == "f32" else 2)  # 8 tokens, k and v
    mine = PromptCache(max_bytes=2 * entry, min_prefix=2)
    ref = JPromptCache(max_bytes=2 * entry, min_prefix=2)
    first = list(range(1, 9))
    calls = [("put", first, 0), ("put", [5, 6], 1), ("put", [1], 0),
             ("restore", first + [9, 10], 1), ("restore", [9, 9, 9], 0),
             ("restore", first, 0), ("put", list(range(20, 28)), 1),
             ("put", list(range(30, 38)), 0), ("restore", first, 1),
             ("restore", [5, 6, 7], 0), ("restore", [30, 31], 1)]
    for op, toks, row in calls:
        if op == "put":
            mine.put(toks, tsrc, batch_idx=row)
            ref.put(toks, jsrc, batch_idx=row)
        else:
            out, n = mine.restore(toks, tdst, batch_idx=row)
            jdst, jn = ref.restore(toks, jdst, batch_idx=row)
            assert out is tdst and n == jn
            same_cache(tdst, jdst, fmt)
        assert stats(mine) == stats(ref), (op, toks)
    assert mine.stats.evictions == 2 and mine.stats.hits == 2
    assert [t.data_ptr() for t in tdst["k"] + tdst["v"]] == bufs
    mine.clear()
    ref.clear()
    assert stats(mine) == stats(ref)


def test_hybrid_cache_is_bypassed():
    _, tkv = caches()
    tkv["deltanet"] = [{"S": torch.zeros(2, 1), "conv": torch.zeros(2, 1)}]
    cache = PromptCache(min_prefix=1)
    cache.put([1, 2, 3], tkv)
    assert cache.entry_count == 0
    assert cache.restore([1, 2, 3, 4], tkv)[1] == 0
    assert (cache.stats.hits, cache.stats.misses) == (0, 0)


@pytest.mark.parametrize("fmt", ["f32", "bf16"])
def test_session_files_cross_load_with_equal_bytes(fmt, tmp_path):
    """A file saved by either package loads into the other: the same
    entries, hits and bytes (bf16 as the same 16 bits)."""
    jsrc, tsrc = caches(fmt, seed=3)
    mine, ref = PromptCache(min_prefix=2), JPromptCache(min_prefix=2)
    for toks, row in (([1, 2, 3, 4], 0), ([7, 8, 9], 1)):
        mine.put(toks, tsrc, batch_idx=row)
        ref.put(toks, jsrc, batch_idx=row)
    mine.restore([1, 2, 3, 4, 5], tsrc)
    ref.restore([1, 2, 3, 4, 5], jsrc)

    def entries(cache):
        return {key: (e.hits, {name: a.view(np.uint8).tobytes()
                               for name, a in e.arrays.items()})
                for key, e in cache._entries.items()}

    want = entries(ref)
    assert entries(mine) == want
    for saver, loader_cls in ((mine, JPromptCache), (ref, PromptCache),
                              (mine, PromptCache)):
        path = str(tmp_path / "session.bin")  # exactly this name
        assert saver.save(path) == 2
        loaded = loader_cls(min_prefix=2)
        assert loaded.load(path) == 2
        assert entries(loaded) == want
        if loader_cls is PromptCache:
            assert set(loaded._entries[(1, 2, 3, 4)].dtypes.values()) == {
                "float32" if fmt == "f32" else "bfloat16"}


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pc") / "tiny.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                    tokenizer=True)
    return path


@pytest.mark.parametrize("fmt", ["f32", "bf16"])
def test_engine_session_file_matches_jax(model_path, tmp_path, fmt):
    """The JAX engine tests' session-file runs: a first engine generates
    and saves; a second loads the file, hits and gives the same text. Each
    package's file then loads into the other's engine with the same text
    and a hit; the port's restore prefills only the prompt's last token."""
    jsess, tsess = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    j1 = JEngine.load(model_path, JConfig(
        weight_mode="dequant", kv_format=fmt, prompt_cache_file=jsess))
    t1 = Engine.load(model_path, EngineConfig(
        kv_format=fmt, prompt_cache_file=tsess), device="cpu")
    want = j1.generate(PROMPT, max_tokens=8, sampler=JGREEDY)
    assert t1.generate(PROMPT, max_tokens=8, sampler=GREEDY) == want
    assert j1.save_prompt_cache() == t1.save_prompt_cache() == 1
    for jfile, tfile in ((jsess, tsess), (tsess, jsess)):
        j2 = JEngine.load(model_path, JConfig(
            weight_mode="dequant", kv_format=fmt, prompt_cache_file=jfile))
        t2 = Engine.load(model_path, EngineConfig(
            kv_format=fmt, prompt_cache_file=tfile), device="cpu")
        lens = []
        prefill = t2.runner.prefill
        t2.runner.prefill = lambda ids, *a, **kw: (
            lens.append(len(ids)), prefill(ids, *a, **kw))[1]
        assert j2.generate(PROMPT, max_tokens=8, sampler=JGREEDY) == want
        assert t2.generate(PROMPT, max_tokens=8, sampler=GREEDY) == want
        assert j2.prompt_cache.stats.hits == t2.prompt_cache.stats.hits == 1
        assert lens == [1]


def test_engine_prompt_cache_tokens_and_prefix(model_path):
    """A prompt, then the prompt and more: the second hits, prefills only
    the new tokens at their positions, and generates what an uncached
    engine (and the JAX engine with its cache) generates."""
    cached = Engine.load(model_path, EngineConfig(prompt_cache=True),
                         device="cpu")
    plain = Engine(cached.runner, cached.tokenizer, EngineConfig(),
                   cached.gguf)
    jeng = JEngine.load(model_path, JConfig(weight_mode="dequant",
                                            prompt_cache=True))
    longer = PROMPT + " the lazy dog"
    n_first = len(cached.tokenizer.encode(PROMPT))
    n_longer = len(cached.tokenizer.encode(longer))
    for prompt in (PROMPT, longer):
        got = cached.generate(prompt, max_tokens=10, sampler=GREEDY)
        assert got == plain.generate(prompt, max_tokens=10, sampler=GREEDY)
        assert got == jeng.generate(prompt, max_tokens=10, sampler=JGREEDY)
    assert cached.stats.prompt_tokens == n_longer
    s, js = cached.prompt_cache.stats, jeng.prompt_cache.stats
    assert (s.hits, s.misses, s.stored) == (js.hits, js.misses, js.stored) \
        == (1, 1, 2)
    assert cached.prompt_cache.longest_prefix(
        cached.tokenizer.encode(longer)).tokens == tuple(
            cached.tokenizer.encode(longer))
    assert n_longer > n_first


def test_batched_engine_with_prompt_cache(model_path):
    """Four requests sharing a prefix, B = 2 (rows reused): the same tokens
    as without the cache, and the later requests restore the prefix."""
    eng = Engine.load(model_path, EngineConfig(max_batch=2), device="cpu")
    prefix = " ".join(f"tok{i}" for i in range(10, 16))
    prompts = [prefix] + [f"{prefix} tok{i}" for i in (40, 41, 42)]

    def run(cache):
        be = BatchedEngine(eng.runner, eng.tokenizer, prompt_cache=cache)
        try:
            out = []
            for p in prompts:  # one at a time: each sees the last one's put
                h = be.submit(p, max_tokens=6, sampler=GREEDY)
                h.text(timeout=120)
                out.append(h.token_ids)
            return out
        finally:
            be.shutdown()

    cache = PromptCache()
    assert run(cache) == run(None)
    assert cache.stats.hits == 3 and cache.stats.stored == 4


def test_server_prompt_cache_bytes(model_path):
    """``prompt_cache_bytes > 0`` gives the scheduler a PromptCache of that
    budget (the JAX server's); completions are the same with it."""
    state = ServerState(ServerConfig(model_path=model_path, device="cpu",
                                     max_batch=2, warmup=False,
                                     prompt_cache_bytes=1 << 20))
    try:
        _, batched = state.current()
        cache = batched.prompt_cache
        assert isinstance(cache, PromptCache) and cache.max_bytes == 1 << 20
        texts = [batched.generate(PROMPT, max_tokens=6, sampler=GREEDY)
                 for _ in range(2)]
    finally:
        state.shutdown()
    eng = Engine.load(model_path, EngineConfig(), device="cpu")
    assert texts == [eng.generate(PROMPT, max_tokens=6, sampler=GREEDY)] * 2
    assert cache.stats.hits == 1


def test_hybrid_model_stores_no_entry(tmp_path):
    path = str(tmp_path / "hybrid.gguf")
    build_synthetic_gguf(path, preset="tiny-qwen3next", quant=GGMLType.F32)
    eng = Engine.load(path, EngineConfig(prompt_cache=True, max_batch=2),
                      device="cpu")
    for _ in range(2):
        eng.generate(PROMPT, max_tokens=4, sampler=GREEDY)
    cache = PromptCache()
    be = BatchedEngine(eng.runner, eng.tokenizer, prompt_cache=cache)
    try:
        be.generate(PROMPT, max_tokens=4, sampler=GREEDY)
    finally:
        be.shutdown()
    for c in (eng.prompt_cache, cache):
        assert c.entry_count == 0 and c.stats.hits == 0
    assert "deltanet" in eng.runner.init_kv(1)
    KV.zero_(eng.runner.init_kv(1))
