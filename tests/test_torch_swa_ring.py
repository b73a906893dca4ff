"""The port's sliding-window ring cache (models/kv.py write_swa / read_swa,
the runner's ring_slots and chunked prefill, the batched engine's chunk
guard) against the JAX package on the CPU, and against the port's own full
cache.

Model: the JAX ring tests' tiny gemma2 (tests/test_kv_variants.py
_swa_model: 2 layers, layer 0 sliding with window 16, layer 1 full, ctx
2048), F32, dequant mode in both packages. Runners take swa_ring_extra=128
(a ring of 256 slots: the window rounded up to 128, plus 128; 241 safe
prefill tokens, so prefill chunks are 128).
Tolerances: the JAX package asserts its ring bit-equal to its full cache;
the port's ring reads the same values in another slot order, so its
logits are within 1e-6 of its full cache's (prefill of a 300-token prompt
in chunks: 2e-5, JAX's own bound there), within 1e-5 of max |logit| of the
JAX package's, and greedy tokens are equal."""

import numpy as np
import pytest
import torch

from fixtures import make_tiny_model
from llama_gguf_tpu.engine.runner import ModelRunner as JRunner
from llama_gguf_tpu.models import kv as JKV
from llama_gguf_tpu.models.loader import load_model as j_load_model

from llama_gguf_tpu_torch.convert import kv_from_numpy, kv_to_numpy
from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.runner import ModelRunner
from llama_gguf_tpu_torch.models import kv as KV
from llama_gguf_tpu_torch.models.loader import load_model
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

torch.set_num_threads(1)

PROMPT = [int(t) for t in np.random.default_rng(0).integers(0, 64, 40)]
LONG = [int(t) for t in np.random.default_rng(1).integers(0, 64, 300)]
GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
REL = 1e-5


def close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{err:.3g} > {rel} of max"


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("swa") / "swa.gguf")
    make_tiny_model(
        path, arch="gemma2", vocab=64, hidden=32, layers=2, heads=4,
        kv_heads=2, ffn=64, ctx=2048, attention_bias=False, seed=3,
        extra_metadata={"gemma2.attention.sliding_window": 16})
    return path


@pytest.fixture(scope="module")
def models(path):
    return j_load_model(path, mode="dequant"), \
        load_model(path, mode="dequant", device="cpu")


def runner(models, ring: bool, jax: bool = False, fmt: str = "f32",
           max_batch: int = 1):
    (jp, jcfg, _), (tp, tcfg, _) = models
    kw = dict(max_batch=max_batch, max_seq=2048, swa_ring=ring,
              swa_ring_extra=128, kv_format=fmt)
    if jax:
        return JRunner(jp, jcfg, **kw)
    return ModelRunner(tp, tcfg, device="cpu", **kw)


def prefill_and_greedy(r, prompt=PROMPT, steps=24):
    kv = r.init_kv(1)
    logits, kv, pos = r.prefill(prompt, kv)
    logits = np.asarray(logits)
    toks, kv = r.greedy_decode(np.asarray([int(np.argmax(logits))]),
                               np.asarray([pos]), kv, steps=steps)
    return logits, np.asarray(toks), kv


def test_ring_layout_matches_jax(models):
    """The same ring geometry in both packages: one full layer of 2048
    positions, one ring of 256 slots; the port's buffers carry a drop slot
    each, swa_pos starts at -1; memory_bytes equal: the full cache's K/V
    for 2048 + 256 of its 4096 layer-positions, plus 256 int32 slot
    positions."""
    jr, tr = runner(models, True, jax=True), runner(models, True)
    assert tr.ring_slots == jr.ring_slots == 256
    assert tr.ring_chunk == 128
    jkv, tkv = jr.init_kv(1), tr.init_kv(1)
    assert set(tkv) == set(jkv) == {"k", "v", "k_swa", "v_swa", "swa_pos"}
    assert tkv["k"][0].shape[1] == 2049 and tkv["k_swa"][0].shape[1] == 257
    assert torch.all(tkv["swa_pos"][0] == -1)
    assert KV.cache_shape(tkv) == JKV.cache_shape(jkv)
    assert KV.memory_bytes(tkv) == JKV.memory_bytes(jkv)
    full = KV.memory_bytes(runner(models, False).init_kv(1))
    assert full == JKV.memory_bytes(runner(models, False, jax=True).init_kv(1))
    assert KV.memory_bytes(tkv) == full * (2048 + 256) // 4096 + 256 * 4


@pytest.mark.parametrize("fmt,ring", [("f32", True), ("bf16", True),
                                      ("f8_e4m3", True), ("f8_e5m2", True),
                                      ("i8", False), ("tq3", False),
                                      ("qjl", False)])
def test_ring_formats_as_in_jax(models, fmt, ring):
    """Only the scale-free formats take the ring (ring_format_ok), in both
    packages; the others keep the full cache."""
    jr, tr = runner(models, True, jax=True, fmt=fmt), \
        runner(models, True, fmt=fmt)
    assert KV.ring_format_ok(fmt) == JKV.ring_format_ok(fmt) == ring
    assert (tr.ring_slots > 0) == (jr.ring_slots > 0) == ring
    assert ("k_swa" in tr.init_kv(1)) == ring


def test_swa_ring_matches_full_cache(models):
    """JAX's test_swa_ring_matches_full_cache on the port and across the
    packages: prefill past the window and 24 greedy steps, ring against
    full cache and the port's ring against the JAX ring."""
    outs = {}
    for ring in (False, True):
        outs[ring] = prefill_and_greedy(runner(models, ring))[:2]
    close(outs[True][0], outs[False][0], 1e-6)
    np.testing.assert_array_equal(outs[True][1], outs[False][1])
    jl, jt, _ = prefill_and_greedy(runner(models, True, jax=True))
    close(outs[True][0], jl, REL)
    np.testing.assert_array_equal(outs[True][1], jt)


def test_swa_ring_long_prompt_chunks(models):
    """JAX's test_swa_ring_long_prompt_chunks: a 300-token prompt (over the
    ring's 241 safe tokens) prefills in chunks of 128 and matches the full
    cache and the JAX ring."""
    r = runner(models, True)
    calls = []
    step = r.step
    r.step = lambda toks, *a, **kw: (calls.append(np.shape(toks)[1]),
                                     step(toks, *a, **kw))[1]
    got, _, _ = r.prefill(LONG, r.init_kv(1))
    assert calls == [128, 128, 64]  # 128, 128 and 44 tokens padded
    plain = runner(models, False)
    full, _, _ = plain.prefill(LONG, plain.init_kv(1))
    close(got.numpy(), full.numpy(), 2e-5)
    jr = runner(models, True, jax=True)
    jl, _, _ = jr.prefill(LONG, jr.init_kv(1))
    close(got.numpy(), np.asarray(jl), REL)


def test_ring_cache_contents_match_jax(models):
    """After the same prefill and greedy steps, the port's ring buffers and
    slot positions equal the JAX package's (kv_to_numpy drops the drop
    slots): positions exactly, K/V within 1e-5 of max |value|;
    kv_from_numpy of the JAX cache gives the port's layout back."""
    _, _, tkv = prefill_and_greedy(runner(models, True))
    _, _, jkv = prefill_and_greedy(runner(models, True, jax=True))
    got = kv_to_numpy(tkv)
    for key in jkv:
        for a, b in zip(got[key], jkv[key]):
            if key == "swa_pos":
                np.testing.assert_array_equal(a, np.asarray(b))
            else:
                close(a, np.asarray(b), REL)
    back = kv_from_numpy({k: [np.asarray(a) for a in v]
                          for k, v in jkv.items()})
    for key in tkv:
        for a, b in zip(back[key], tkv[key]):
            assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.all(back["swa_pos"][0][:, -1] == -1)


def test_write_swa_guard_and_drop_slot():
    """write_swa refuses a step longer than R - window + 1 (ValueError, as
    JAX raises at trace time); padding positions (>= max_seq) land in slot
    R, which read_swa never returns; slot j holds position p with p % R ==
    j."""
    kv = KV.init_cache(2, 1, 64, 1, 4, device="cpu", swa_layers=(True, False),
                       ring_slots=12)
    k = torch.ones(1, 6, 1, 4)
    with pytest.raises(ValueError, match="too large for SWA ring"):
        KV.write_swa(kv, 0, k, k, torch.arange(6)[None].int(), window=8)
    pos = torch.tensor([[10, 11, 12, 13, 64, 99]], dtype=torch.int32)
    KV.write_swa(kv, 0, k[:, :6] * pos[..., None, None], k, pos, window=7)
    keys, _, key_pos = KV.read_swa(kv, 0)
    assert key_pos.shape == (1, 12) and keys.shape == (1, 12, 1, 4)
    assert key_pos[0].tolist() == [12, 13] + [-1] * 8 + [10, 11]
    assert keys[0, 0, 0, 0] == 12 and keys[0, 11, 0, 0] == 11
    assert kv["swa_pos"][0][0, 12] == 99  # the drop slot took the padding


def test_zero_resets_ring_positions(models):
    """init_kv zeroes the runner's cache at every request: swa_pos goes
    back to -1 (not 0), so a second request equals the first."""
    r = runner(models, True)
    first = prefill_and_greedy(r)[:2]
    kv = r.init_kv(1)
    assert torch.all(kv["swa_pos"][0] == -1)
    assert all(torch.all(t == 0) for t in kv["k_swa"] + kv["k"])
    second = prefill_and_greedy(r)[:2]
    np.testing.assert_array_equal(first[0], second[0])
    np.testing.assert_array_equal(first[1], second[1])


def test_context_shift_refuses_the_ring(models, path):
    """shift_left raises on a ring cache (JAX's message); an Engine with
    the context shift on takes the full cache instead."""
    r = runner(models, True)
    with pytest.raises(ValueError, match="context shift"):
        r.shift_left(r.init_kv(1), 4)
    eng = Engine.load(path, EngineConfig(weight_mode="dequant",
                                         context_shift=True,
                                         max_context_len=256), device="cpu")
    assert eng.runner.ring_slots == 0
    assert "k_swa" not in eng.runner.init_kv(1)


def test_batched_chunk_guard_at_construction(models):
    """A prefill chunk whose padded length passes the ring's safe length
    (241) raises when the engine is made, not inside a step; 128 runs."""
    r = runner(models, True, max_batch=2)
    with pytest.raises(ValueError, match="safe length 241"):
        BatchedEngine(r, None, prefill_chunk=200)
    BatchedEngine(r, None, prefill_chunk=128).shutdown()


def test_batched_ring_rows_reused(models, path):
    """A B = 2 BatchedEngine on the ring, chunk 64, six requests (rows
    reused, their ring slots left as the JAX engine leaves them): every
    completion equals single-stream greedy on the port's full cache."""
    eng = Engine.load(path, EngineConfig(weight_mode="dequant"), device="cpu")
    r = runner(models, True, max_batch=2)
    prompts = [LONG[:200], PROMPT, LONG[50:90], PROMPT[:5], LONG[:150],
               PROMPT[10:]]
    with BatchedEngine(r, eng.tokenizer, prefill_chunk=64) as be:
        handles = [be.submit(p, max_tokens=20, sampler=GREEDY)
                   for p in prompts]
        for h in handles:
            h.text(timeout=120)
    full = runner(models, False)
    for p, h in zip(prompts, handles):
        kv = full.init_kv(1)
        logits, kv, pos = full.prefill(p, kv)
        first = int(torch.argmax(logits))
        toks, _ = full.greedy_decode(np.asarray([first]), np.asarray([pos]),
                                     kv, steps=19)
        want = [first] + toks[0].tolist()
        assert h.token_ids == want[:len(h.token_ids)]


def test_stale_ring_slots_are_masked(models):
    """A reused row: a 300-token sequence wraps row 0's ring, then a new
    6-token sequence prefills into the same row without clearing it. Its
    stale slots hold positions above the new queries, so the causal mask
    hides them: the logits equal a fresh cache's, bit for bit."""
    r = runner(models, True)
    kv = r.init_kv(1)
    r.prefill(LONG, kv)
    stale = kv["swa_pos"][0][0, :256].clone()
    assert stale.min() == 44 and stale.max() == 299
    got, kv, pos = r.prefill(PROMPT[:6], kv)
    assert torch.all(kv["swa_pos"][0][0, 6:256] == stale[6:])
    want, _, _ = r.prefill(PROMPT[:6], runner(models, True).init_kv(1))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for _ in range(4):
        tok = int(torch.argmax(got))
        got, kv = r.decode_one(tok, pos, kv)
        pos += 1
    assert torch.all(kv["swa_pos"][0][0, 10:256] == stale[10:])
