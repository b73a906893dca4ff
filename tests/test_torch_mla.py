"""The port's DeepSeek-family slice (models/transformer.mla_attention, the
DeepSeek-V3 routing of route_choice/route, the MLA latent cache through the
runner, the context shift, the prompt cache and the batched engine,
models/moe_stats.py) against the JAX package on the CPU.

Fixtures: the port's tiny-deepseek-v3 (low-rank q, sigmoid routing with
the bias and a group limit), tiny-deepseek-v2-lite (dense wq, softmax
routing without renormalisation, routed scale 16) and tiny-moonlight (dense
wq, sigmoid with the bias, top-6 of 16), each F32 and at the Q4_K_M mix
(Q4_K attention projections, gate/up and expert gate/up; Q6_K down, table
and head). The JAX package loads the same files. In quant mode it runs its
Pallas kernels in interpret mode and the port its kernels' plain versions.
Tolerances: a layer alone, cache included, within 1e-5 of max |value| (f32,
the same operations, matmuls reassociated); routing ids equal and weights
within 1e-6 before the routed scale; logits within 1e-3 of max |logit|; greedy tokens equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_gguf_tpu.engine import runner as jrunner
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.models import kv as JKV
from llama_gguf_tpu.models import transformer as JT
from llama_gguf_tpu.models.embeddings import \
    extract_hidden_states as j_hidden_states
from llama_gguf_tpu.models.moe_stats import MoeStats as JMoeStats
from llama_gguf_tpu.models.moe_stats import \
    route_and_record as j_route_and_record
from llama_gguf_tpu.ops import linear as JL
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.convert import (kv_from_numpy, kv_to_numpy,
                                          params_from_numpy)
from llama_gguf_tpu_torch.engine import runner as trunner
from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.models import kv as KV
from llama_gguf_tpu_torch.models import transformer as T
from llama_gguf_tpu_torch.models.moe_stats import MoeStats, route_and_record
from llama_gguf_tpu_torch.ops import linear as TL
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import (MLA_PRESETS,
                                                  build_synthetic_gguf)

torch.set_num_threads(1)

REL = 1e-5  # a layer alone, cache included: of max |value|
LOGIT_REL = 1e-3  # logits: of max |logit|
ROUTE_ATOL = 1e-6  # routing weights
MARGIN = 1e-4  # the smallest routing margin the chosen inputs must have
IDS = [44, 12, 310, 2, 77, 66, 5, 9, 100, 31, 400, 17]
PRESETS = ["tiny-deepseek-v3", "tiny-deepseek-v2-lite", "tiny-moonlight"]
QUANTS = {"f32": GGMLType.F32, "q4k": GGMLType.Q4_K}
GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
JGREEDY = JSampler(temperature=0.0, repetition_penalty=1.0)


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max diff {err:.3g} > {rel} * {scale:.3g}"


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mla")
    return {(name, q): build_synthetic_gguf(str(d / f"{name}-{q}.gguf"),
                                            preset=name, quant=QUANTS[q])
            for name in PRESETS for q in QUANTS}


@pytest.fixture(scope="module")
def engines(paths):
    """(name, quant, mode) -> (JAX Engine, port Engine on the CPU)."""
    cache = {}

    def get(name, quant="f32", mode="dequant"):
        key = (name, quant, mode)
        if key not in cache:
            path = paths[name, quant]
            cache[key] = (JEngine.load(path, JConfig(weight_mode=mode)),
                          Engine.load(path, EngineConfig(weight_mode=mode),
                                      device="cpu"))
        return cache[key]
    return get


def _logits(eng, ids, kv=None):
    r = eng.runner
    logits, _, _ = r.prefill(ids, r.init_kv() if kv is None else kv)
    return logits.numpy() if torch.is_tensor(logits) else np.asarray(logits)


def _jax_tokens(jr, logits, kv, pos, steps):
    """Greedy tokens from a JAX runner's state, one decode_one a token."""
    out = []
    for _ in range(steps):
        tok = int(np.argmax(np.asarray(logits)))
        out.append(tok)
        logits, kv = jr.decode_one(tok, pos, kv)
        pos += 1
    return out


# -- the model ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dequant", "quant"])
@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("name", PRESETS)
def test_prefill_logits_and_greedy_tokens_match_jax(engines, name, quant,
                                                    mode):
    je, te = engines(name, quant, mode)
    close(_logits(te, IDS), _logits(je, IDS), LOGIT_REL)
    assert te.greedy_tokens(IDS, 10) == je.greedy_tokens(IDS, 10)


def test_fixture_layouts(engines):
    """The Q4_K_M mix reaches the kernels: low-rank q, kv_a and o_proj q4
    (no fused QKV), the up-projections dense [nh, nope, rank] and [nh, v,
    rank], the leading dense layer's gate|up fused, the experts' gate and up
    q4 and down q8, the shared experts' gate|up fused; the router bias
    loaded where the routing is sigmoid."""
    for name in PRESETS:
        _, te = engines(name, "q4k", "quant")
        c, p = MLA_PRESETS[name], te.runner.params
        attn = p["layers"][0]["attn"]
        q_keys = ("q_a", "q_b") if c["q_lora"] else ("wq",)
        for key in q_keys + ("kv_a", "wo"):
            assert isinstance(attn[key], TL.QuantLinear) and \
                attn[key].fmt == "q4", (name, key)
        assert "wqkv" not in attn and "wk" not in attn
        assert attn["kv_a"].n == c["kv_lora"] + c["rope"]
        assert tuple(attn["w_uk"].shape) == (c["heads"], c["nope"],
                                             c["kv_lora"])
        assert tuple(attn["w_uv"].shape) == (c["heads"], c["v"], c["kv_lora"])
        assert attn["w_uk"].dtype == torch.float32
        assert p["layers"][0]["ffn"]["gate_up"].fmt == "q4"
        assert "router" not in p["layers"][0]["ffn"]  # leading dense layer
        ffn = p["layers"][1]["ffn"]
        ex = ffn["experts"]
        assert (ex["gate"].fmt, ex["up"].fmt, ex["down"].fmt) == \
            ("q4", "q4", "q8")
        assert ffn["shared"]["gate_up"].splits == \
            (c["shared"] * c["expert_ffn"],) * 2
        assert ("router_bias" in ffn) == (c["gating"] == 2)
        cfg = te.runner.cfg
        assert (cfg.head_dim, cfg.rope.n_dims, cfg.kv_lora_rank,
                cfg.value_length) == (c["nope"] + c["rope"], c["rope"],
                                      c["kv_lora"], c["v"])
        assert (cfg.expert_gating_func, cfg.expert_weights_norm,
                cfg.expert_group_count, cfg.expert_group_used_count) == (
            c["gating"], c["norm"], *c["groups"])
        assert cfg.expert_weights_scale == pytest.approx(c["scale"])


def test_moonlight_preset_is_the_published_config():
    """moonlight-16b-a3b-l2 at moonshotai/Moonlight-16B-A3B's config.json
    widths, cut to 2 of 27 layers (the leading dense layer and one MoE
    layer); its wq, kv_a, o_proj and the experts' shapes."""
    c = MLA_PRESETS["moonlight-16b-a3b-l2"]
    assert (c["vocab"], c["hidden"], c["heads"], c["q_lora"], c["kv_lora"],
            c["nope"], c["rope"], c["v"]) == (163840, 2048, 16, 0, 512,
                                              128, 64, 128)
    assert (c["layers"], c["dense"], c["ffn"]) == (2, 1, 11264)
    assert (c["experts"], c["topk"], c["expert_ffn"], c["shared"]) == \
        (64, 6, 1408, 2)
    assert (c["gating"], c["scale"], c["norm"], c["groups"]) == \
        (2, 2.446, True, (1, 1))
    assert (c["rope_base"], c["eps"], c["ctx"]) == (50000.0, 1e-5, 8192)
    # wq 2048 -> 16 x 192, kv_a 2048 -> 576, o_proj 16 x 128 -> 2048
    assert c["heads"] * (c["nope"] + c["rope"]) == 3072
    assert c["kv_lora"] + c["rope"] == 576
    assert c["heads"] * c["v"] == 2048
    # the experts' down has K 1408, no multiple of 256: Q5_1 (q8) in the
    # Q4_K_M mix, as _quant_put writes it
    assert c["expert_ffn"] % 256 != 0 and c["expert_ffn"] % 32 == 0


def test_cache_is_the_latent(engines):
    """The runner's cache is the latent: one KV head, K rank + rope wide, V
    rank wide, the JAX package's shapes plus the drop slot."""
    je, te = engines("tiny-deepseek-v3")
    cfg = te.runner.cfg
    assert (cfg.cache_kv_heads, cfg.cache_k_dim, cfg.cache_v_dim) == (
        1, 64 + 32, 64)
    tkv, jkv = te.runner._make_kv(3), je.runner.init_kv(3)
    for key in ("k", "v"):
        assert [tuple(a.shape) for a in tkv[key]] == [
            (b, s + 1, h, d) for b, s, h, d in
            (tuple(a.shape) for a in jkv[key])]
    assert tuple(tkv["k"][0].shape) == (3, te.runner.max_seq + 1, 1, 96)
    assert tuple(tkv["v"][0].shape) == (3, te.runner.max_seq + 1, 1, 64)


# -- each part alone ------------------------------------------------------------


def _random_cache(je, b, rng):
    """A JAX cache of ``b`` rows filled with random latents, and the same
    cache in the port (kv_from_numpy)."""
    np_kv = jax.tree_util.tree_map(np.asarray, je.runner.init_kv(b))
    np_kv = {key: tuple((rng.standard_normal(a.shape) * 0.5).astype(
        np.float32) for a in np_kv[key]) for key in ("k", "v")}
    return jax.tree_util.tree_map(jnp.asarray, np_kv), \
        kv_from_numpy(np_kv, "cpu")


@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("name", PRESETS)
def test_mla_attention_matches_jax(engines, name, quant):
    """Layer 0's attention alone on a random cache: two rows, one ragged
    (two padding tokens), at a read bound and over the whole cache; the
    output and the written latent cache within REL."""
    je, te = engines(name, quant, "quant")
    rng = np.random.default_rng(3)
    t = 6
    positions = np.stack([np.arange(t), 9 + np.arange(t)]).astype(np.int32)
    lengths = np.array([t, 9 + 4], np.int32)
    for bound in (None, 32):
        jkv, tkv = _random_cache(je, 2, rng)
        x = rng.standard_normal((2, t, te.runner.cfg.hidden_size)).astype(
            np.float32)
        jout, jkv = JT.attention(
            je.runner.params["layers"][0]["attn"], je.runner.cfg,
            jnp.asarray(x), jnp.asarray(positions), jkv, 0,
            jnp.asarray(lengths), bound)
        with torch.no_grad():
            tout, out = T.attention(
                te.runner.params["layers"][0]["attn"], te.runner.cfg,
                torch.from_numpy(x), torch.from_numpy(positions), tkv, 0,
                torch.from_numpy(lengths), bound)
        assert out is tkv
        close(tout.numpy(), np.asarray(jout))
        got = kv_to_numpy(tkv)
        for key in ("k", "v"):
            close(got[key][0], jkv[key][0])


def _j_route(jffn, jcfg, xf):
    """The JAX moe_layer's routing (llama_gguf_tpu/models/transformer.py,
    the softmax-before-top-k and DeepSeek-V3 branches), restated on its
    own router: (weights, ids)."""
    logits = JL.apply(jffn["router"], xf).astype(jnp.float32)
    k = jcfg.num_experts_per_token
    if jcfg.expert_gating_func == 2:
        scores = jax.nn.sigmoid(logits)
        choice = scores
        if "router_bias" in jffn:
            choice = choice + jffn["router_bias"].astype(jnp.float32)
        ng, tg = jcfg.expert_group_count, jcfg.expert_group_used_count
        if ng > 1 and tg > 0:
            e = choice.shape[-1]
            grp = choice.reshape(-1, ng, e // ng)
            g2, _ = jax.lax.top_k(grp, 2)
            gscore = g2.sum(-1)
            _, gi = jax.lax.top_k(gscore, tg)
            gmask = jnp.zeros_like(gscore).at[
                jnp.arange(gscore.shape[0])[:, None], gi].set(1.0)
            choice = jnp.where(gmask[:, :, None] > 0, grp,
                               -jnp.inf).reshape(-1, e)
        _, topi = jax.lax.top_k(choice, k)
        topv = jnp.take_along_axis(scores, topi, axis=-1)
        if jcfg.expert_weights_norm:
            topv = topv / (topv.sum(-1, keepdims=True) + 1e-20)
        return topv * jcfg.expert_weights_scale, topi
    probs = jax.nn.softmax(logits, axis=-1)
    topv, topi = jax.lax.top_k(probs, k)
    if jcfg.expert_weights_norm:
        topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    if jcfg.expert_weights_scale != 1.0:
        topv = topv * jcfg.expert_weights_scale
    return topv, topi


def route_margins(ffn, cfg, xf):
    """The smallest k-th vs (k+1)-th choice margin over the rows of xf, and
    with a group limit the smallest tg-th vs (tg+1)-th group score margin
    (1.0 without one)."""
    _, choice = T.route_choice(ffn, cfg, xf)
    k = cfg.num_experts_per_token
    top = torch.topk(choice, k + 1, dim=-1).values
    gap = top[:, k - 1] - top[:, k]
    if cfg.expert_gating_func != 2 or cfg.expert_group_count <= 1:
        return gap.min().item(), 1.0
    scores = T.route_choice(ffn, dataclasses.replace(
        cfg, expert_group_count=0), xf)[1]
    ng, tg = cfg.expert_group_count, cfg.expert_group_used_count
    gs = torch.topk(scores.reshape(len(xf), ng, -1), 2, dim=-1).values.sum(-1)
    g = torch.topk(gs, tg + 1, dim=-1).values
    return gap.min().item(), (g[:, tg - 1] - g[:, tg]).min().item()


# (preset, ModelConfig changes): the sigmoid branch with the bias, the group
# limit, norm on and off, the scale; the softmax branch with and without
# renormalisation and scale
ROUTES = [
    ("tiny-deepseek-v3", {}),
    ("tiny-deepseek-v3", dict(expert_weights_norm=False)),
    ("tiny-deepseek-v3", dict(expert_group_count=1)),
    ("tiny-deepseek-v3", dict(expert_weights_scale=1.0)),
    ("tiny-moonlight", {}),
    ("tiny-deepseek-v2-lite", {}),
    ("tiny-deepseek-v2-lite", dict(expert_weights_norm=True)),
]


@pytest.mark.parametrize("name,change", ROUTES,
                         ids=[f"{n}-{'-'.join(c) or 'as-built'}"
                              for n, c in ROUTES])
def test_route_matches_jax(engines, name, change):
    """route on 64 random rows against the JAX routing on the same router:
    ids equal, weights within 1e-6 (times the routed scale); every row's k-th vs (k+1)-th choice
    (and tg-th vs (tg+1)-th group) margin above 1e-4, so an order of
    summation could not flip them."""
    je, te = engines(name, "q4k", "quant")
    jcfg = dataclasses.replace(je.runner.cfg, **change)
    tcfg = dataclasses.replace(te.runner.cfg, **change)
    jffn = je.runner.params["layers"][1]["ffn"]
    tffn = te.runner.params["layers"][1]["ffn"]
    xf = np.random.default_rng(11).standard_normal(
        (64, tcfg.hidden_size)).astype(np.float32)
    jv, ji = _j_route(jffn, jcfg, jnp.asarray(xf))
    with torch.no_grad():
        tv, ti = T.route(tffn, tcfg, torch.from_numpy(xf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # 1e-6 of the weights before the routed scale (f32 holds a weight of
    # 8 to 1e-6 absolute only)
    np.testing.assert_allclose(
        tv.numpy(), np.asarray(jv), rtol=0,
        atol=ROUTE_ATOL * max(1.0, tcfg.expert_weights_scale))
    assert min(route_margins(tffn, tcfg, torch.from_numpy(xf))) > MARGIN


def test_route_bias_and_groups_change_the_choice(engines):
    """On these inputs the bias and the group limit each change some
    choices (so the match above covers them), and the weights stay the
    raw sigmoid scores at the chosen experts, renormalised and scaled."""
    _, te = engines("tiny-deepseek-v3")
    cfg, ffn = te.runner.cfg, te.runner.params["layers"][1]["ffn"]
    xf = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (64, cfg.hidden_size)).astype(np.float32))
    _, ids = T.route(ffn, cfg, xf)
    no_bias = {k: v for k, v in ffn.items() if k != "router_bias"}
    no_groups = dataclasses.replace(cfg, expert_group_count=1)
    for ffn_, cfg_ in ((no_bias, cfg), (ffn, no_groups)):
        assert not torch.equal(T.route(ffn_, cfg_, xf)[1], ids)
    w, ids = T.route(ffn, cfg, xf)
    scores = torch.sigmoid(TL.apply(ffn["router"], xf))
    want = torch.gather(scores, 1, ids)
    want = want / (want.sum(-1, keepdim=True) + 1e-20) * 2.5
    torch.testing.assert_close(w, want, rtol=0, atol=ROUTE_ATOL)
    # the chosen experts lie in two groups of two
    assert ((ids // 2)[:, :, None] == (ids // 2)[:, None, :]).any(-1).all()


@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("name", PRESETS)
def test_moe_layer_matches_jax(engines, name, quant):
    """Layer 1's routed and shared experts on 12 random rows, against the
    JAX moe_layer (its own routing code), within REL."""
    je, te = engines(name, quant, "quant")
    x = np.random.default_rng(5).standard_normal(
        (1, 12, te.runner.cfg.hidden_size)).astype(np.float32)
    want = JT.moe_layer(je.runner.params["layers"][1]["ffn"], je.runner.cfg,
                        jnp.asarray(x))
    with torch.no_grad():
        got = T.moe_layer(te.runner.params["layers"][1]["ffn"],
                          te.runner.cfg, torch.from_numpy(x))
    close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", PRESETS)
def test_routing_has_a_margin(engines, name, monkeypatch):
    """Every live routing decision of the prompt's prefill and 10 greedy
    steps (quant mode): the k-th vs (k+1)-th choice margin, and the group
    margin of tiny-deepseek-v3, exceed 1e-4, so a flip from reassociated
    sums would show here and not as a token mismatch."""
    _, te = engines(name, "q4k", "quant")
    seen = []
    route = T.route

    def record(ffn, cfg, xf):
        seen.append(route_margins(ffn, cfg, xf[:len(IDS)]))
        return route(ffn, cfg, xf)

    monkeypatch.setattr(T, "route", record)
    te.greedy_tokens(IDS, 10)
    assert len(seen) == 2 * 11  # 2 MoE layers x (prefill + 10 steps)
    assert min(min(m) for m in seen) > MARGIN


@pytest.mark.parametrize("case", ["sparsemixer", "input_scaled",
                                  "expert_bias"])
def test_other_routings_still_raise(engines, paths, case):
    """PhiMoE's sparsemixer, llama4's input-scaled experts and gpt-oss's
    per-expert biases are ported (the name is the test's from before: they
    raised until the load-path and routing slice), here on
    tiny-deepseek-v3's MoE layer (sigmoid routing with the bias and 2 of 4
    groups). Sparsemixer (which reads neither the bias nor the groups) and
    input-scaled experts: route's ids equal the JAX moe_layer's choice, and
    moe_layer within 1e-5 of max |value| of the JAX one. An expert bias
    (exp_probs_b standing in as ffn_up_exps.bias): loaded as the JAX loader
    loads it."""
    from llama_gguf_tpu.gguf.reader import GGUFFile as JGGUFFile
    from llama_gguf_tpu.models.loader import ModelLoader as JLoader
    from llama_gguf_tpu_torch.gguf.reader import GGUFFile
    from llama_gguf_tpu_torch.models.loader import ModelLoader

    je, te = engines("tiny-deepseek-v3")
    cfg, ffn = te.runner.cfg, te.runner.params["layers"][1]["ffn"]
    if case == "expert_bias":
        path = paths["tiny-deepseek-v3", "f32"]
        gguf, jgguf = GGUFFile.open(path), JGGUFFile.open(path)
        for g in (gguf, jgguf):
            g.tensors["blk.1.ffn_up_exps.bias"] = \
                g.tensors["blk.1.exp_probs_b.bias"]
        loader = ModelLoader(gguf, mode="dequant", device="cpu")
        jloader = JLoader(jgguf, mode="dequant")
        got = loader.load_layer(1, loader.config)["ffn"]["experts"]
        want = jloader.load_layer(1, jloader.config)["ffn"]["experts"]
        assert "up_bias" in got and "gate_bias" not in got
        np.testing.assert_array_equal(got["up_bias"].numpy(),
                                      np.asarray(want["up_bias"]))
        return
    change = (dict(expert_gating_func=3, router_jitter_eps=0.01)
              if case == "sparsemixer" else dict(moe_weight_before_ffn=True))
    tcfg = dataclasses.replace(cfg, **change)
    jcfg = dataclasses.replace(je.runner.cfg, **change)
    jffn = je.runner.params["layers"][1]["ffn"]
    x = np.random.default_rng(5).standard_normal(
        (1, 12, cfg.hidden_size)).astype(np.float32)
    with torch.no_grad():
        _, topi = T.route(ffn, tcfg, torch.from_numpy(x[0]))
        got = T.moe_layer(ffn, tcfg, torch.from_numpy(x)).numpy()
    assert topi.shape == (12, 2 if case == "sparsemixer"
                          else cfg.num_experts_per_token)
    close(got, np.asarray(JT.moe_layer(jffn, jcfg, jnp.asarray(x))))


def test_moe_stats_match_jax(engines):
    """MoeStats over the port's routing ids of a prefill (tiny-moonlight,
    top-6 of 16) equal the JAX package's on the same ids; route_and_record
    alike."""
    _, te = engines("tiny-moonlight")
    cfg, ffn = te.runner.cfg, te.runner.params["layers"][1]["ffn"]
    xf = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (40, cfg.hidden_size)).astype(np.float32))
    _, topi = T.route(ffn, cfg, xf)
    mine, ref = MoeStats(cfg.num_experts), JMoeStats(cfg.num_experts)
    mine.record(topi)
    ref.record(topi.numpy())
    assert mine.histogram == ref.histogram
    assert mine.tokens_routed == ref.tokens_routed == 40 * 6
    assert mine.load_balance_factor == ref.load_balance_factor > 1.0
    logits = np.random.default_rng(3).normal(size=(50, 16)).astype(
        np.float32)
    mine.reset()
    ref.reset()
    np.testing.assert_array_equal(route_and_record(logits, 6, mine),
                                  j_route_and_record(logits, 6, ref))
    assert mine.histogram == ref.histogram
    mine.reset()
    assert mine.load_balance_factor == 1.0 and mine.tokens_routed == 0


# -- the latent cache through the runner and the engines --------------------


@pytest.mark.parametrize("name", PRESETS)
def test_prefill_then_decode_equals_token_by_token(engines, name):
    """A prefill of the prompt then 3 decode steps, against the same 15
    tokens fed one at a time, and against a prefill in two chunks: the
    same logits, in both packages."""
    for eng in engines(name):
        r = eng.runner
        ids = IDS + [7, 8, 9]
        logits, kv, pos = r.prefill(IDS, r.init_kv())
        for tok in ids[len(IDS):]:
            logits, kv = r.decode_one(tok, pos, kv)
            pos += 1
        want = np.asarray(logits)
        logits, kv, pos = r.prefill(ids[:1], r.init_kv())
        for tok in ids[1:]:
            logits, kv = r.decode_one(tok, pos, kv)
            pos += 1
        close(np.asarray(logits), want, LOGIT_REL)
        _, kv, pos = r.prefill(ids[:5], r.init_kv())
        close(np.asarray(r.prefill(ids[5:], kv, start_pos=pos)[0]), want,
              LOGIT_REL)


RAGGED = [10, 20, 300, 40]  # the rows' prompt lengths: one past bucket 256


@pytest.mark.parametrize("name", ["tiny-deepseek-v3", "tiny-moonlight"])
def test_tiered_decode_matches_jax_and_single_bound(engines, name):
    """Four ragged rows prefilled in one step on runners of 1024
    positions, then a decode step on the two-tier bound pick_read_bound
    gives (256, 512, 1): the JAX runner's logits, and the single bound
    512's."""
    je, te = engines(name, "q4k", "quant")
    jr = jrunner.ModelRunner(je.runner.params, je.runner.cfg, max_batch=4,
                             max_seq=1024)
    tr = trunner.ModelRunner(te.runner.params, te.runner.cfg, max_batch=4,
                             max_seq=1024, device="cpu")
    rng = np.random.default_rng(0)
    t = max(RAGGED)
    toks = np.zeros((4, t), np.int32)
    pos = np.full((4, t), 1024, np.int32)
    for i, n in enumerate(RAGGED):
        toks[i, :n] = rng.integers(3, 500, size=n)
        pos[i, :n] = np.arange(n)
    lens = np.asarray(RAGGED, np.int32)
    jl, jkv = jr.step(jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(lens),
                      jr.init_kv(), read_bound=512, logit_positions=lens - 1)
    tl, tkv = tr.step(toks, pos, lens, tr.init_kv(), read_bound=512,
                      logit_positions=lens - 1)
    close(tl.numpy(), np.asarray(jl), LOGIT_REL)
    nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    tier = trunner.pick_read_bound(lens + 1, 1024)
    assert tier == (256, 512, 1)
    args = (nxt[:, None], lens[:, None], lens + 1)
    want = np.asarray(jr.step(*(jnp.asarray(a) for a in args), jkv,
                              read_bound=tier)[0])
    got = tr.step(*args, tkv, read_bound=tier)[0].numpy()
    single = tr.step(*args, tkv, read_bound=512)[0].numpy()
    close(got, want, LOGIT_REL)
    close(got, single, LOGIT_REL)


@pytest.mark.parametrize("batch_idx", [None, 1], ids=["all", "row1"])
@pytest.mark.parametrize("fmt", ["f32", "bf16"])
def test_shift_left_matches_jax_on_the_latent_cache(engines, fmt, batch_idx):
    """A two-row latent cache after prefills, carried from the JAX runner,
    shifted by 5 in each package: the logical caches equal JAX's (f32
    within 1e-6, bf16 bit for bit), in place. Only K's trailing rope dims
    rotate: c_kv, in K and in V, only slides; rotating the whole key (or
    none of it) would miss JAX's by far."""
    je, te = engines("tiny-deepseek-v3")
    jcfg, tcfg = je.runner.cfg, te.runner.cfg
    jr = jrunner.ModelRunner(je.runner.params, jcfg, max_batch=2,
                             kv_format=fmt)
    jkv = jr.init_kv(2)
    for row, ids in enumerate((IDS, IDS[::-1] * 2)):
        _, jkv, _ = jr.prefill(ids, jkv, batch_idx=row)
    np_kv = jax.tree_util.tree_map(np.asarray, jkv)
    tkv = kv_from_numpy(np_kv, "cpu")
    bufs = [t.data_ptr() for t in tkv["k"] + tkv["v"]]
    before = {key: [a.copy() for a in arrays]  # kv_to_numpy's are views
              for key, arrays in kv_to_numpy(tkv).items()}
    jkv = JKV.shift_left(jkv, 5, batch_idx=batch_idx, model_cfg=jcfg)
    assert KV.shift_left(tkv, 5, batch_idx=batch_idx, model_cfg=tcfg) is tkv
    assert [t.data_ptr() for t in tkv["k"] + tkv["v"]] == bufs
    got = kv_to_numpy(tkv)
    rows = slice(None) if batch_idx is None else slice(1, 2)
    rank = tcfg.kv_lora_rank
    for key in ("k", "v"):
        for i, (a, b) in enumerate(zip(got[key], jkv[key])):
            b = np.asarray(b)
            if fmt == "bf16":
                np.testing.assert_array_equal(a, b.view(np.uint16))
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            # c_kv slides bit for bit; the untouched row is untouched
            rolled = np.roll(before[key][i][rows], -5, axis=1)
            width = rank if key == "k" else None
            np.testing.assert_array_equal(a[rows][..., :width],
                                          rolled[..., :width])
            if batch_idx is not None:
                np.testing.assert_array_equal(a[0], before[key][i][0])
    if fmt == "f32":  # the whole key rotated, or none of it
        for wrong in (dataclasses.replace(tcfg, kv_lora_rank=0), None):
            k = kv_from_numpy(np_kv, "cpu")
            KV.shift_left(k, 5, batch_idx=batch_idx, model_cfg=wrong)
            err = np.abs(kv_to_numpy(k)["k"][0] - np.asarray(jkv["k"][0]))
            assert err.max() > 1e-2


def test_context_shift_generate_matches_jax(engines):
    """Engine.generate with the context shift on a 48-position window,
    past it twice: the JAX engine's greedy tokens (its runner's steps and
    shift_left with the model's config)."""
    je, te = engines("tiny-moonlight", "q4k", "quant")
    r = trunner.ModelRunner(te.runner.params, te.runner.cfg, max_seq=48,
                            device="cpu")
    eng = Engine(r, te.tokenizer, EngineConfig(context_shift=True), te.gguf)
    shifts = []
    shift = r.shift_left
    r.shift_left = lambda kv, n, batch_idx=None: (shifts.append(n),
                                                  shift(kv, n, batch_idx))
    picks = []
    ids = IDS[:8]
    # the port's steps and shifts, as Engine.generate runs them
    logits, kv, pos = r.prefill(ids, r.init_kv())
    jr = jrunner.ModelRunner(je.runner.params, je.runner.cfg, max_seq=48)
    jl, jkv, jpos = jr.prefill(ids, jr.init_kv())
    for _ in range(100):
        tok = int(torch.argmax(logits))
        assert tok == int(np.argmax(np.asarray(jl)))
        picks.append(tok)
        if pos >= r.max_seq - 1:
            n = r.max_seq // 4
            r.shift_left(kv, n)
            jkv = JKV.shift_left(jkv, n, model_cfg=jr.cfg)
            pos, jpos = pos - n, jpos - n
        logits, kv = r.decode_one(tok, pos, kv)
        jl, jkv = jr.decode_one(tok, jpos, jkv)
        pos, jpos = pos + 1, jpos + 1
    assert len(shifts) >= 2
    close(kv_to_numpy(kv)["k"][1], np.asarray(jkv["k"][1]), LOGIT_REL)
    # and Engine.generate itself runs past the window
    eng.generate("Hello there", max_tokens=100, sampler=GREEDY)
    assert eng.stats.generated_tokens == 100 and len(shifts) >= 4


@pytest.mark.parametrize("fmt", ["f32", "bf16"])
def test_prompt_cache_hit_equals_miss_and_session_file_matches_jax(
        engines, paths, tmp_path, fmt):
    """The same latent prefix (a JAX runner's prefill carried across) put
    in each package's PromptCache saves to byte-equal session files of the
    latent's shapes. Engines with a session file: the port's text equals
    the JAX engine's, and each package's file loads into the other's
    engine, which hits and gives the same text, the port prefilling only
    the prompt's last token."""
    from llama_gguf_tpu.engine.prompt_cache import PromptCache as JCache
    from llama_gguf_tpu_torch.engine.prompt_cache import PromptCache

    je, _ = engines("tiny-deepseek-v3")
    jr = jrunner.ModelRunner(je.runner.params, je.runner.cfg,
                             kv_format=fmt)
    _, jkv, _ = jr.prefill(IDS, jr.init_kv())
    tkv = kv_from_numpy(jax.tree_util.tree_map(np.asarray, jkv), "cpu")
    files = []
    for cache, kv in ((JCache(min_prefix=2), jkv),
                      (PromptCache(min_prefix=2), tkv)):
        cache.put(IDS, kv)
        files.append(str(tmp_path / f"{len(files)}.npz"))
        assert cache.save(files[-1]) == 1
    with np.load(files[0]) as a, np.load(files[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].tobytes() == b[key].tobytes(), key
    entry = next(iter(cache._entries.values()))
    assert entry.arrays["k"].shape == (3, len(IDS), 1, 96)
    assert entry.arrays["v"].shape == (3, len(IDS), 1, 64)

    path = paths["tiny-deepseek-v3", "f32"]
    prompt = "The quick brown fox jumps"
    jsess, tsess = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j1 = JEngine.load(path, JConfig(weight_mode="dequant", kv_format=fmt,
                                    prompt_cache_file=jsess))
    t1 = Engine.load(path, EngineConfig(weight_mode="dequant", kv_format=fmt,
                                        prompt_cache_file=tsess),
                     device="cpu")
    want = j1.generate(prompt, max_tokens=8, sampler=JGREEDY)
    assert t1.generate(prompt, max_tokens=8, sampler=GREEDY) == want
    assert j1.save_prompt_cache() == t1.save_prompt_cache() == 1
    for jfile, tfile in ((jsess, tsess), (tsess, jsess)):
        j2 = JEngine.load(path, JConfig(weight_mode="dequant", kv_format=fmt,
                                        prompt_cache_file=jfile))
        t2 = Engine.load(path, EngineConfig(
            weight_mode="dequant", kv_format=fmt, prompt_cache_file=tfile),
            device="cpu")
        lens = []
        prefill = t2.runner.prefill
        t2.runner.prefill = lambda ids, *a, **kw: (
            lens.append(len(ids)), prefill(ids, *a, **kw))[1]
        assert j2.generate(prompt, max_tokens=8, sampler=JGREEDY) == want
        assert t2.generate(prompt, max_tokens=8, sampler=GREEDY) == want
        assert j2.prompt_cache.stats.hits == t2.prompt_cache.stats.hits == 1
        assert lens == [1]


def test_prompt_cache_hit_logits_equal_a_miss(engines):
    """A prefix stored from one prefill and restored into the runner's own
    cache: the extension's prefill runs only the new tokens, its logits
    equal an uncached prefill's within 1e-3 of max |logit|, and the next
    greedy tokens alike."""
    from llama_gguf_tpu_torch.engine.prompt_cache import PromptCache

    _, te = engines("tiny-moonlight", "q4k", "quant")
    r, cache = te.runner, PromptCache(min_prefix=2)
    first, more = IDS, IDS + [7, 8, 9, 10]
    store = r._make_kv(1)
    r.prefill(first, store)
    r.store_prefix(cache, first, store)
    kv = r.init_kv()
    n = r.restore_prefix(cache, more, kv)
    assert n == len(first) and cache.stats.hits == 1
    got, kv, pos = r.prefill(more[n:], kv, start_pos=n)
    want, wkv, wpos = r.prefill(more, r._make_kv(1))
    close(got.numpy(), want.numpy(), LOGIT_REL)
    toks = []
    for lg, c, p in ((got, kv, pos), (want, wkv, wpos)):
        out = []
        for _ in range(6):
            t = int(torch.argmax(lg))
            out.append(t)
            lg, c = r.decode_one(t, p, c)
            p += 1
        toks.append(out)
    assert toks[0] == toks[1]


@pytest.mark.parametrize("name", ["tiny-deepseek-v3", "tiny-moonlight"])
def test_batched_engine_reused_rows_match_jax_single_stream(paths, engines,
                                                            name):
    """B = 2, 5 requests (rows reused), chunk 8 (two prompts longer than a
    chunk): each request's greedy tokens equal the JAX single-stream
    Engine's."""
    je, _ = engines(name, "q4k", "quant")
    teng = Engine.load(paths[name, "q4k"],
                       EngineConfig(weight_mode="quant", max_batch=2),
                       device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 500, size=n).tolist()
               for n in (5, 19, 3, 11, 7)]
    be = BatchedEngine(teng.runner, teng.tokenizer, prefill_chunk=8)
    try:
        handles = [be.submit(p, max_tokens=6, sampler=GREEDY)
                   for p in prompts]
        for h in handles:
            h.text(timeout=120)
    finally:
        be.shutdown()
    assert be.stats.completed == 5 and be.stats.mixed_steps > 0
    for p, h in zip(prompts, handles):
        want = je.greedy_tokens(p, 6)
        eog = [i for i, t in enumerate(want) if je.tokenizer.is_eog(t)]
        assert h.token_ids == want[:eog[0] if eog else len(want)]


@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("name", PRESETS)
def test_embed_matches_jax(engines, name, quant):
    """runner.hidden_states (Engine.embed's) equals the JAX
    extract_hidden_states within 1e-5, through MLA and the MoE layers."""
    je, te = engines(name, quant, "quant")
    close(te.runner.hidden_states(IDS, owner="embed"),
          np.asarray(j_hidden_states(je.runner, IDS)))
    v = te.embed("hello world")
    assert v.shape == (te.runner.cfg.hidden_size,)
    assert np.isfinite(v).all()


@pytest.mark.parametrize("name", PRESETS)
def test_bf16_kv_runs_and_matches_jax(engines, name):
    """A bf16 latent cache: the port's prefill logits equal the JAX
    package's bf16 runner's within 1e-3 of max |logit|, and its greedy
    tokens alike."""
    je, te = engines(name)
    jr = jrunner.ModelRunner(je.runner.params, je.runner.cfg,
                             kv_format="bf16")
    tr = trunner.ModelRunner(te.runner.params, te.runner.cfg,
                             kv_format="bf16", device="cpu")
    kv = tr.init_kv()
    assert kv["k"][0].dtype == torch.bfloat16
    jl, jkv, jpos = jr.prefill(IDS, jr.init_kv())
    tl, tkv, tpos = tr.prefill(IDS, kv)
    close(tl.numpy(), np.asarray(jl), LOGIT_REL)
    want = _jax_tokens(jr, jl, jkv, jpos, 8)
    got = []
    for _ in range(8):
        tok = int(torch.argmax(tl))
        got.append(tok)
        tl, tkv = tr.decode_one(tok, tpos, tkv)
        tpos += 1
    assert got == want


# -- carrying params and caches across, the CLI ----------------------------------


def test_params_from_numpy_carries_mla_and_the_bias(engines):
    """The JAX package's params (q_a/q_a_norm/q_b, kv_a, kv_a_norm, w_uk,
    w_uv, router_bias) carried across give the port's logits within 1e-5."""
    je, te = engines("tiny-deepseek-v3", "q4k", "quant")
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, je.runner.params), "cpu")
    attn = params["layers"][0]["attn"]
    assert {"q_a", "q_a_norm", "q_b", "kv_a", "kv_a_norm", "w_uk", "w_uv",
            "wo"} <= set(attn)
    assert torch.equal(attn["w_uk"],
                       te.runner.params["layers"][0]["attn"]["w_uk"])
    assert torch.equal(params["layers"][1]["ffn"]["router_bias"],
                       te.runner.params["layers"][1]["ffn"]["router_bias"])
    r = te.runner
    toks = torch.tensor([IDS], dtype=torch.int32)
    pos = torch.arange(len(IDS), dtype=torch.int32)[None]
    lens = torch.tensor([len(IDS)], dtype=torch.int32)
    outs = []
    for p in (params, r.params):
        with torch.no_grad():
            logits, _ = T.forward(p, r.cfg, toks, pos, r._make_kv(1), lens)
        outs.append(logits.numpy())
    close(outs[0], outs[1])


def test_kv_from_numpy_carries_the_latent_cache(engines):
    """A JAX latent cache after a prefill carried across: 8 decode steps
    give the JAX package's tokens."""
    je, te = engines("tiny-deepseek-v2-lite")
    logits, jkv, pos = je.runner.prefill(IDS, je.runner.init_kv())
    tkv = kv_from_numpy(jax.tree_util.tree_map(np.asarray, jkv), "cpu")
    assert tuple(tkv["k"][0].shape[2:]) == (1, 96)
    want = _jax_tokens(je.runner, logits, jkv, pos, 8)
    got, tok, p = [], int(np.argmax(np.asarray(logits))), pos
    for _ in range(8):
        got.append(tok)
        step, tkv = te.runner.decode_one(tok, p, tkv)
        tok, p = int(torch.argmax(step)), p + 1
    assert got == want


def test_generate_and_cli_run_and_bench(engines, paths, capsys):
    """Engine.generate's text equals the JAX engine's; greedy_decode gives
    greedy_tokens' tokens; the CLI's run and bench on the GGUF."""
    je, te = engines("tiny-moonlight", "q4k", "quant")
    prompt = "The quick brown fox"
    assert te.generate(prompt, max_tokens=8, sampler=GREEDY) == \
        je.generate(prompt, max_tokens=8, sampler=JGREEDY)
    r = te.runner
    want = te.greedy_tokens(IDS, 9)
    logits, kv, pos = r.prefill(IDS, r.init_kv())
    first = torch.argmax(logits)[None].to(torch.int32)
    got, _ = r.greedy_decode(first, [pos], kv, 8)
    assert [int(first)] + got[0].tolist() == want
    out = cli.bench(te, prompt_tokens=8, gen_tokens=4)
    assert out["gen_tokens"] == 4 and out["decode_tps"] > 0
    rc = cli.main(["run", paths["tiny-deepseek-v3", "q4k"], "-p", prompt,
                   "-n", "4", "--temperature", "0", "--no-stream",
                   "--device", "cpu"])
    assert rc == 0 and capsys.readouterr().out.strip() != ""
