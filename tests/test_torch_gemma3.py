"""Gemma-3 through the port against the JAX package on the CPU: the pattern
of 5 sliding-window layers to 1 global, per-head QK RMSNorm, the sandwich
norms (the GGUF stores Gemma's +1), the local layers' RoPE base 1e4 and the
global layers' linearly scaled base, tied embeddings, with and without the
SWA ring cache.

Fixture: the port's tiny-gemma3 preset (6 layers, window 16, head_dim 64,
context 2048), F32; both packages load the same file in dequant mode, f32
KV. The default Engine keeps the local layers in a ring of 1152 slots (the
window rounded up to 128, plus 1024); with the context shift on, both
packages keep the full cache. Prompts are longer than the window.
Tolerance: prefill and decode logits within 1e-5 of max |logit| (the same
f32 operations, matmuls reassociated); greedy tokens equal."""

import numpy as np
import pytest
import torch

from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.engine.runner import ModelRunner as JRunner
from llama_gguf_tpu.models.loader import load_model as j_load_model

from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.runner import ModelRunner
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.models.loader import load_model
from llama_gguf_tpu_torch.utils.synthetic import (GEMMA3_PRESETS,
                                                  build_synthetic_gguf)

torch.set_num_threads(1)

REL = 1e-5
PROMPT = [int(t) for t in np.random.default_rng(5).integers(3, 512, 40)]
DECODE = 24  # decode steps: from position 40 to 63, past the window


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max diff {err:.3g} > {rel} * {scale:.3g}"


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return build_synthetic_gguf(
        str(tmp_path_factory.mktemp("g3") / "tiny-gemma3.gguf"),
        preset="tiny-gemma3", quant=GGMLType.F32)


def run_both(jr, tr, prompt=PROMPT, steps=DECODE):
    """Prefill ``prompt`` and decode ``steps`` greedy tokens (the JAX
    runner's choice fed to both) on a JAX and a port runner; yields each
    step's (JAX logits, port logits)."""
    jkv, tkv = jr.init_kv(1), tr.init_kv(1)
    jl, jkv, pos = jr.prefill(prompt, jkv)
    tl, tkv, tpos = tr.prefill(prompt, tkv)
    assert pos == tpos
    yield np.asarray(jl), tl.numpy()
    for _ in range(steps):
        tok = int(np.argmax(np.asarray(jl)))
        jl, jkv = jr.decode_one(tok, pos, jkv)
        tl, tkv = tr.decode_one(tok, pos, tkv)
        pos += 1
        yield np.asarray(jl), tl.numpy()


def test_config_matches_jax(path):
    """Both packages read the same Gemma-3 config from the file: pattern 6,
    window 16, the global base 1e6 with linear x8, the local base 1e4
    unscaled, the default scale, sqrt(hidden) embedding scale."""
    _, jcfg, _ = j_load_model(path, mode="dequant")
    _, tcfg, _ = load_model(path, mode="dequant", device="cpu")
    assert (tcfg.swa_pattern, tcfg.sliding_window) == (6, 16)
    assert [tcfg.layer_is_swa(i) for i in range(6)] == [True] * 5 + [False]
    for i in range(6):
        jr, tr = jcfg.layer_rope(i), tcfg.layer_rope(i)
        assert (tr.freq_base, tr.freq_scale, tr.scaling_type.value) == \
            (jr.freq_base, jr.freq_scale, jr.scaling_type.value)
    assert tcfg.layer_rope(0).freq_base == 1e4
    assert (tcfg.layer_rope(5).freq_base, tcfg.layer_rope(5).freq_scale) \
        == (1e6, 0.125)
    assert (tcfg.attention_scale, tcfg.embedding_scale) == \
        (jcfg.attention_scale, jcfg.embedding_scale) == (0.0, 16.0)


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "full"])
def test_prefill_and_decode_logits_match_jax(path, ring):
    """Prefill past the window and 24 decode steps: the port's logits equal
    the JAX package's within 1e-5 of max |logit| at every step, ring
    against ring (144 + 128 slots) and full cache against full cache."""
    jp, jcfg, _ = j_load_model(path, mode="dequant")
    tp, tcfg, _ = load_model(path, mode="dequant", device="cpu")
    kw = dict(max_batch=1, max_seq=2048, swa_ring=ring, swa_ring_extra=128)
    jr, tr = JRunner(jp, jcfg, **kw), ModelRunner(tp, tcfg, device="cpu",
                                                  **kw)
    assert tr.ring_slots == jr.ring_slots == (256 if ring else 0)
    assert ("k_swa" in tr.init_kv(1)) == ring
    for jl, tl in run_both(jr, tr):
        close(tl, jl)


@pytest.mark.parametrize("context_shift", [False, True],
                         ids=["ring", "full"])
def test_engine_greedy_matches_jax(path, context_shift):
    """Engine.load in both packages (the default ring of 1152 slots, or the
    full cache with the context shift on): the same greedy tokens, and the
    prefill logits within 1e-5."""
    cfg = dict(weight_mode="dequant", context_shift=context_shift)
    je = JEngine.load(path, JConfig(**cfg))
    te = Engine.load(path, EngineConfig(**cfg), device="cpu")
    ring = 0 if context_shift else 1152
    assert te.runner.ring_slots == je.runner.ring_slots == ring
    assert ("k_swa" in te.runner.init_kv(1)) == (not context_shift)
    assert te.greedy_tokens(PROMPT, 16) == je.greedy_tokens(PROMPT, 16)
    jl, _, _ = je.runner.prefill(PROMPT, je.runner.init_kv(1))
    tl, _, _ = te.runner.prefill(PROMPT, te.runner.init_kv(1))
    close(tl.numpy(), np.asarray(jl))


def test_ring_equals_full_cache(path):
    """The port's ring against its own full cache: the same logits through
    prefill and decode past the window (JAX asserts its two bit-equal;
    here the same operations on another slot order, within 1e-6)."""
    tp, tcfg, _ = load_model(path, mode="dequant", device="cpu")
    runners = [ModelRunner(tp, tcfg, max_batch=1, max_seq=2048,
                           swa_ring=ring, swa_ring_extra=128, device="cpu")
               for ring in (True, False)]
    for a, b in run_both(*runners):
        close(a, b, 1e-6)


def test_preset_is_the_published_config():
    """gemma-3-4b-l6 at google/gemma-3-4b-it's text_config widths, cut to
    one period of 6 layers; every K-quant width a multiple of 256."""
    c = GEMMA3_PRESETS["gemma-3-4b-l6"]
    assert (c["vocab"], c["hidden"], c["heads"], c["kv_heads"],
            c["head_dim"], c["ffn"]) == (262208, 2560, 8, 4, 256, 10240)
    assert (c["window"], c["rope_base"], c["rope_linear"], c["ctx"]) == \
        (1024, 1e6, 8.0, 131072)
    assert c["layers"] == 6
    for width in (c["hidden"], c["heads"] * c["head_dim"], c["ffn"]):
        assert width % 256 == 0
