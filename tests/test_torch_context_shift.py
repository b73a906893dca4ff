"""The port's context shift against the JAX package on the CPU:
ops/rope.rerotate_keys, models/kv.shift_left and Engine.generate past the
window with ``context_shift`` (and ChatEngine with it on).

Tolerances: rerotate_keys within 1e-6 (NEOX, NORMAL, partial, YaRN and
linear scaling; the same f32 arithmetic); shift_left's logical caches
within 1e-6 in f32 and bit-equal in bf16 (one rounding of the same f32
values); generated tokens equal (greedy)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fixtures import make_tiny_model
from llama_gguf_tpu.engine.engine import ChatEngine as JChatEngine
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.models import config as JC
from llama_gguf_tpu.models import kv as JKV
from llama_gguf_tpu.ops import rope as JR
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler

from llama_gguf_tpu_torch.convert import kv_from_numpy, kv_to_numpy
from llama_gguf_tpu_torch.engine.engine import ChatEngine, Engine, EngineConfig
from llama_gguf_tpu_torch.models import config as TC
from llama_gguf_tpu_torch.models import kv as KV
from llama_gguf_tpu_torch.ops import rope as TR
from llama_gguf_tpu_torch.sampling.sampler import Sampler, SamplerConfig

GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
JGREEDY = JSampler(temperature=0.0, repetition_penalty=1.0)
PROMPT = "tok1 tok2 tok3"

# (id, RopeConfig fields): n_dims < head_dim (16) is partial RoPE
ROPES = [
    ("neox", dict(n_dims=16, rope_type="NEOX")),
    ("normal", dict(n_dims=16, rope_type="NORMAL")),
    ("partial", dict(n_dims=8, rope_type="NEOX")),
    ("partial-at-end", dict(n_dims=8, rope_type="NEOX",
                            partial_at_end=True)),
    ("partial-normal", dict(n_dims=8, rope_type="NORMAL")),
    ("linear", dict(n_dims=16, rope_type="NEOX", scaling_type="LINEAR",
                    freq_scale=0.25)),
    ("yarn", dict(n_dims=16, rope_type="NEOX", scaling_type="YARN",
                  freq_scale=0.25, yarn_ext_factor=1.0,
                  yarn_attn_factor=1.1, original_max_position_embeddings=64)),
]


def rope_pair(fields: dict):
    """The same RopeConfig in each package."""
    out = []
    for mod in (JC, TC):
        kw = dict(fields, freq_base=10000.0)
        kw["rope_type"] = mod.RopeType[kw["rope_type"]]
        if "scaling_type" in kw:
            kw["scaling_type"] = mod.RopeScalingType[kw["scaling_type"]]
        out.append(mod.RopeConfig(**kw))
    return out


def model_pair(**kw):
    """The same ModelConfig in each package (2 heads of 16)."""
    out = []
    for mod in (JC, TC):
        fields = dict(kw)
        if "rope" in fields:
            fields["rope"] = rope_pair(fields["rope"])[mod is TC]
        out.append(mod.ModelConfig(
            arch="llama", vocab_size=8, hidden_size=32, num_layers=3,
            num_heads=2, num_kv_heads=2, intermediate_size=32,
            max_seq_len=12, **fields))
    return out


@pytest.mark.parametrize("delta", [-3, 5])
@pytest.mark.parametrize("name,fields", ROPES, ids=[r[0] for r in ROPES])
def test_rerotate_keys_matches_jax(name, fields, delta):
    jcfg, tcfg = rope_pair(fields)
    k = np.random.default_rng(0).normal(size=(2, 5, 2, 16)).astype(np.float32)
    want = np.asarray(JR.rerotate_keys(jnp.asarray(k), delta, jcfg))
    got = TR.rerotate_keys(torch.from_numpy(k), delta, tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def filled_caches(fmt: str, layers: int = 3, batch: int = 2, seq: int = 12,
                  seed: int = 1):
    """A JAX cache with every position of every row written from seeded
    values, and the port's copy of it (kv_from_numpy)."""
    rng = np.random.default_rng(seed)
    jkv = JKV.init_cache(layers, batch, seq, 2, 16, fmt=fmt)
    pos = jnp.asarray(np.tile(np.arange(seq, dtype=np.int32), (batch, 1)))
    for i in range(layers):
        k, v = (jnp.asarray(rng.normal(size=(batch, seq, 2, 16)).astype(
            np.float32)) for _ in range(2))
        jkv = JKV.write(jkv, i, k, v, pos)
    return jkv, kv_from_numpy({key: [np.asarray(a) for a in jkv[key]]
                               for key in ("k", "v")})


def assert_same_logical(tkv, jkv, fmt: str) -> None:
    got = kv_to_numpy(tkv)
    for key in ("k", "v"):
        for a, b in zip(got[key], jkv[key]):
            b = np.asarray(b)
            if fmt == "bf16":
                np.testing.assert_array_equal(a, b.view(np.uint16))
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch_idx", [None, 1], ids=["all", "row1"])
@pytest.mark.parametrize("fmt", ["f32", "bf16"])
def test_shift_left_matches_jax_per_layer(fmt, batch_idx):
    """Per-layer RoPE from the model config (layer 1 NoPE: every 2nd
    layer), one row or all: the port's logical cache equals the JAX
    package's after the shift, wrap-around included; every buffer is the
    same tensor as before and the drop slot is untouched."""
    jcfg, tcfg = model_pair(rope=dict(n_dims=16, rope_type="NEOX"),
                            nope_layer_interval=2)
    assert tcfg.layer_rope(1) is None and tcfg.layer_rope(2) is not None
    jkv, tkv = filled_caches(fmt)
    bufs = [t.data_ptr() for t in tkv["k"] + tkv["v"]]
    drops = [t[:, -1].clone() for t in tkv["k"] + tkv["v"]]
    jkv = JKV.shift_left(jkv, 4, batch_idx=batch_idx, model_cfg=jcfg)
    out = KV.shift_left(tkv, 4, batch_idx=batch_idx, model_cfg=tcfg)
    assert out is tkv
    assert [t.data_ptr() for t in tkv["k"] + tkv["v"]] == bufs
    for t, d in zip(tkv["k"] + tkv["v"], drops):
        assert torch.equal(t[:, -1], d)
    assert_same_logical(tkv, jkv, fmt)


def test_shift_left_dual_base_swa_layers():
    """gemma3-style local layers re-rotate at their own base
    (rope_freq_base_swa), global ones at the model's."""
    jcfg, tcfg = model_pair(
        rope=dict(n_dims=16, rope_type="NEOX", scaling_type="LINEAR",
                  freq_scale=0.5),
        sliding_window=4, swa_pattern=3, rope_freq_base_swa=500.0)
    assert tcfg.layer_rope(0).freq_base == 500.0
    assert tcfg.layer_rope(2).freq_base == 10000.0
    jkv, tkv = filled_caches("f32")
    jkv = JKV.shift_left(jkv, 3, model_cfg=jcfg)
    KV.shift_left(tkv, 3, model_cfg=tcfg)
    assert_same_logical(tkv, jkv, "f32")


@pytest.mark.parametrize("fields", [ROPES[1][1], ROPES[3][1]],
                         ids=["normal", "partial-at-end"])
def test_shift_left_one_rope_for_every_layer(fields):
    """``rope_cfg`` alone (no model config) rotates every layer alike."""
    jrope, trope = rope_pair(fields)
    jkv, tkv = filled_caches("f32", batch=1, seed=2)
    jkv = JKV.shift_left(jkv, 5, rope_cfg=jrope)
    KV.shift_left(tkv, 5, rope_cfg=trope)
    assert_same_logical(tkv, jkv, "f32")


def test_shift_left_leaves_recurrent_state_and_refuses_mla():
    """Recurrent state is left alone; an MLA latent cache (rank 12, rope 4:
    keys of 16) is shifted now, as the JAX package shifts it (only the
    trailing rope dims rotate); a ring cache raises, as in the JAX
    package."""
    _, tcfg = model_pair(rope=dict(n_dims=16, rope_type="NEOX"))
    _, tkv = filled_caches("f32")
    state = {"S": torch.randn(2, 3, 4), "conv": torch.randn(2, 3)}
    tkv["deltanet"] = [{k: v.clone() for k, v in state.items()}]
    KV.shift_left(tkv, 2, model_cfg=tcfg)
    assert all(torch.equal(tkv["deltanet"][0][k], state[k]) for k in state)
    jmla, mla = model_pair(rope=dict(n_dims=4, rope_type="NORMAL"),
                           kv_lora_rank=12)
    jkv, tkv = filled_caches("f32", seed=4)
    jkv = JKV.shift_left(jkv, 2, model_cfg=jmla)
    KV.shift_left(tkv, 2, model_cfg=mla)
    assert_same_logical(tkv, jkv, "f32")
    ring = KV.init_cache(3, 1, 12, 2, 16, device="cpu",
                         swa_layers=(True, True, False), ring_slots=8)
    with pytest.raises(ValueError, match="context shift"):
        KV.shift_left(ring, 2, model_cfg=tcfg)


@pytest.fixture(scope="module")
def shift_model(tmp_path_factory):
    """The JAX engine test's context-shift model (qwen2, ctx 256)."""
    path = str(tmp_path_factory.mktemp("cs") / "tiny.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=256, seed=11,
                    tokenizer=True)
    return path


def jax_shift_tokens(jeng, ids: list[int], steps: int) -> list[int]:
    """The JAX Engine's greedy loop with its context shift on the whole
    prompt: its runner's prefill, then a decode_one per token, shifting the
    cache by max_seq // 4 (JKV.shift_left with the model's config) when the
    window is full, as its generate_streaming does after cutting the
    prompt."""
    r = jeng.runner
    logits, kv, pos = r.prefill(ids, r.init_kv())
    out = []
    for _ in range(steps):
        tok = int(np.argmax(np.asarray(logits)))
        if jeng.tokenizer.is_eog(tok):
            break
        out.append(tok)
        if pos >= r.max_seq - 1:
            n = max(r.max_seq // 4, 1)
            kv = JKV.shift_left(kv, n, model_cfg=r.cfg)
            pos -= n
        logits, kv = r.decode_one(tok, pos, kv)
        pos += 1
    return out


def recorded_tokens(engine, prompt: str, max_tokens: int) -> list[int]:
    """Engine.generate's greedy tokens, as its sampler picks them (the
    text of random weights is mostly partial UTF-8, held back)."""
    sampler, picked = Sampler(GREEDY), []
    sample = sampler.sample

    def record(*args, **kw):
        picked.append(sample(*args, **kw))
        return picked[-1]

    sampler.sample = record
    engine.generate(prompt, max_tokens=max_tokens, sampler=sampler)
    return picked[:engine.stats.generated_tokens]


@pytest.mark.parametrize("mode", ["quant", "dequant"])
def test_generate_past_the_window_matches_jax(shift_model, mode):
    """A 64-token window, 150 greedy tokens from the whole prompt: the
    cache shifts by 16 several times; the tokens equal the JAX runner's
    and shift_left's in the JAX Engine's loop, and the runner's cache is
    the one it made (shifted in place)."""
    teng = Engine.load(shift_model, EngineConfig(
        weight_mode=mode, max_context_len=64, context_shift=True),
        device="cpu")
    jeng = JEngine.load(shift_model, JConfig(
        weight_mode="dequant", max_context_len=64, context_shift=True))
    ids = teng.tokenizer.encode(PROMPT)
    kv = teng.runner.init_kv(1)
    got = recorded_tokens(teng, PROMPT, 150)
    want = jax_shift_tokens(jeng, ids, 150)
    assert teng.stats.prompt_tokens == len(ids) == 22
    assert teng.stats.generated_tokens == len(want) == 150
    assert got == want
    assert teng.runner.init_kv(1) is kv
    # without the shift it stops at the window
    plain = Engine(teng.runner, teng.tokenizer,
                   EngineConfig(weight_mode=mode), teng.gguf)
    plain.generate(PROMPT, max_tokens=150, sampler=GREEDY)
    assert plain.stats.generated_tokens <= 64


def test_prompt_cut_with_context_shift(shift_model):
    """The JAX Engine cuts the prompt to max_seq - max_tokens - 1 tokens
    with the shift on too: for 150 tokens in a 64-token window that
    empties it (its own test of the shift runs so). The port keeps the
    prompt's last max_seq - 1 tokens there, and without the shift cuts as
    JAX does while JAX's cut keeps a token (and to one token beyond)."""
    jeng = JEngine.load(shift_model, JConfig(
        weight_mode="dequant", max_context_len=64, context_shift=True))
    jeng.generate(PROMPT, max_tokens=150, sampler=JGREEDY)
    assert jeng.stats.prompt_tokens == 0
    teng = Engine.load(shift_model, EngineConfig(
        max_context_len=64, context_shift=True), device="cpu")
    ids = list(range(3, 103))
    assert teng._fit_prompt(ids, 150) == ids[-63:]
    teng.config.context_shift = False
    assert teng._fit_prompt(ids, 150) == ids[-1:]
    assert teng._fit_prompt(ids, 20) == ids[-43:]
    assert teng._fit_prompt(ids[:40], 20) == ids[:40]


def test_chat_engine_with_context_shift_matches_jax(shift_model):
    """ChatEngine with ``context_shift`` on runs as the JAX one (which has
    no refusal): the same replies and history, the prompts within the
    256-token window."""
    teng = Engine.load(shift_model, EngineConfig(context_shift=True),
                       device="cpu")
    jeng = JEngine.load(shift_model, JConfig(weight_mode="dequant",
                                             context_shift=True))
    mine = ChatEngine(teng, system_prompt="Be brief.")
    ref = JChatEngine(jeng, system_prompt="Be brief.")
    for turn in ("Hello", "And then?"):
        assert mine.send(turn, max_tokens=40, sampler=GREEDY) == \
            ref.send(turn, max_tokens=40, sampler=JGREEDY)
    assert mine.messages == ref.messages
