"""MoE routing beyond softmax-top-k in the port (models/transformer.route,
moe_layer; models/loader.py's expert biases) against the JAX package on
the CPU.

The layer alone, on seeded inputs and seeded f32 weights (a dense router,
dense expert stacks, the biases) under tiny-moe's config: PhiMoE's
sparsemixer, llama4's input-scaled experts, each gpt-oss expert bias alone
and all three (with its clamped SwiGLU), and the top-k-then-softmax branch
(``router_softmax_before_topk`` False in the params dict): the port's
moe_layer within 1e-5 of max |y| of the JAX one, and the port's route ids
equal to the JAX package's choice. The biased experts also quantized, at a
decode step's slots and at a prefill's, where the port runs gate and up on
kernels 4-5 (their plain versions here) and never the grouped GLU.

End to end, the port's tiny-gpt-oss, tiny-phimoe and tiny-llama4
(utils/synthetic.ROUTING_PRESETS, Q4_K_M) against the JAX Engine on the
same GGUF: prefill logits within 1e-5 of max |logit| in dequant mode and
1e-3 in quant mode (the JAX package's quant path dequantizes in XLA, the
port's kernels' plain versions reassociate), greedy tokens equal up to the
first step whose top-2 logit margin is under 1e-4 of max |logit|."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.gguf.reader import GGUFFile as JGGUFFile
from llama_gguf_tpu.models import config as jconfig
from llama_gguf_tpu.models import transformer as JT
from llama_gguf_tpu.ops import linear as JL
from llama_gguf_tpu.quant.repack import repack as jrepack

from llama_gguf_tpu_torch.convert import params_from_numpy
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.gguf.reader import GGUFFile
from llama_gguf_tpu_torch.models import config as tconfig
from llama_gguf_tpu_torch.models import transformer as T
from llama_gguf_tpu_torch.ops import linear as TL
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.quant.quantize import quantize
from llama_gguf_tpu_torch.quant.repack import repack
from llama_gguf_tpu_torch.utils.synthetic import (ROUTING_PRESETS,
                                                  build_synthetic_gguf)

torch.set_num_threads(1)

REL = 1e-5  # the layer alone, and dequant logits: of max |value|
QUANT_REL = 1e-3  # quant logits: of max |logit|
NEAR = 1e-4  # a top-2 logit margin under this (of max |logit|) is a tie
E, H, F = 8, 128, 256  # experts; tiny-moe's hidden; the experts' width
IDS = [44, 12, 310, 2, 77, 66, 5, 9, 100, 31, 400, 17, 250, 3, 91, 180]
PRESETS = ["tiny-gpt-oss", "tiny-phimoe", "tiny-llama4"]
CASES = {
    "sparsemixer": dict(cfg=dict(expert_gating_func=3,
                                 router_jitter_eps=0.01)),
    "input_scaled": dict(cfg=dict(expert_gating_func=2,
                                  moe_weight_before_ffn=True,
                                  expert_weights_norm=False)),
    "gate_bias": dict(biases=("gate",)),
    "up_bias": dict(biases=("up",)),
    "down_bias": dict(biases=("down",)),
    "all_biases": dict(biases=("gate", "up", "down")),
    "topk_softmax": dict(ffn=dict(router_softmax_before_topk=False)),
}


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0 and err <= rel * scale, \
        f"max diff {err:.3g} > {rel} * {scale:.3g}"


@pytest.fixture(scope="module")
def moe_cfgs(tmp_path_factory):
    """tiny-moe's config in both packages, with E experts of width F."""
    path = build_synthetic_gguf(
        str(tmp_path_factory.mktemp("routing") / "tiny-moe.gguf"),
        preset="tiny-moe", quant=GGMLType.F32)
    tg, jg = GGUFFile.open(path), JGGUFFile.open(path)
    change = dict(num_experts=E, expert_intermediate_size=F)
    return (dataclasses.replace(tconfig.parse_config(tg.metadata, tg.tensors),
                                **change),
            dataclasses.replace(jconfig.parse_config(jg.metadata, jg.tensors),
                                **change))


def seeded_ffn(biases=(), quant=None, seed=0):
    """(port ffn, JAX ffn) with the same seeded f32 router, expert stacks
    ([E, in, out], or ``quant``-quantized QuantExpertStacks, each package
    repacking the same bytes) and the named expert biases."""
    rng = np.random.default_rng(seed)
    router = rng.standard_normal((H, E)).astype(np.float32) * 0.3
    stacks = {"gate": (H, F), "up": (H, F), "down": (F, H)}
    t_ex, j_ex = {}, {}
    for key, (k_in, n_out) in stacks.items():
        w = rng.standard_normal((E, n_out, k_in)).astype(np.float32) * 0.1
        if quant is None:
            dense = np.ascontiguousarray(w.transpose(0, 2, 1))
            t_ex[key], j_ex[key] = torch.from_numpy(dense), jnp.asarray(dense)
            continue
        raws = [quantize(w[e], quant) for e in range(E)]
        tr = [repack(r, quant, (n_out, k_in)) for r in raws]
        jr = [jrepack(r, quant, (n_out, k_in)) for r in raws]
        t_ex[key] = TL.QuantExpertStack(
            *(torch.from_numpy(np.stack([getattr(r, f) for r in tr]))
              if getattr(tr[0], f) is not None else None
              for f in ("packed", "scales", "mins")),
            fmt=tr[0].fmt, group=tr[0].group, k=k_in, n=n_out)
        j_ex[key] = JL.QuantExpertStack(
            *(jnp.asarray(np.stack([getattr(r, f) for r in jr]))
              if getattr(jr[0], f) is not None else None
              for f in ("packed", "scales", "mins")),
            fmt=jr[0].fmt, group=jr[0].group, k=k_in, n=n_out)
    for key in biases:
        b = rng.standard_normal((E, stacks[key][1])).astype(np.float32) * 0.5
        t_ex[f"{key}_bias"] = torch.from_numpy(b)
        j_ex[f"{key}_bias"] = jnp.asarray(b)
    tffn = {"router": TL.DenseLinear(torch.from_numpy(router)),
            "experts": t_ex}
    jffn = {"router": JL.DenseLinear(jnp.asarray(router)), "experts": j_ex}
    return tffn, jffn


def configs(moe_cfgs, case):
    tcfg, jcfg = moe_cfgs
    change = dict(CASES[case].get("cfg", {}), num_experts_per_token=2)
    tcfg = dataclasses.replace(tcfg, **change)
    jcfg = dataclasses.replace(jcfg, **change)
    if CASES[case].get("biases"):  # gpt-oss's clamped SwiGLU
        tcfg = dataclasses.replace(
            tcfg, hidden_act=tconfig.Activation.SWIGLU_OAI)
        jcfg = dataclasses.replace(
            jcfg, hidden_act=jconfig.Activation.SWIGLU_OAI)
    return tcfg, jcfg


def jax_choice(jffn, jcfg, x):
    """The experts the JAX moe_layer picks, restated from its branches."""
    logits = np.asarray(JL.apply(jffn["router"], jnp.asarray(x)))
    if jcfg.expert_gating_func == 3:
        first = logits.argmax(-1)
        rest = logits.copy()
        rest[np.arange(len(x)), first] = -np.inf
        return np.stack([first, rest.argmax(-1)], -1)
    return np.asarray(jax.lax.top_k(jnp.asarray(logits),
                                    jcfg.num_experts_per_token)[1])


@pytest.mark.parametrize("case", list(CASES))
def test_moe_layer_matches_jax(moe_cfgs, case):
    tcfg, jcfg = configs(moe_cfgs, case)
    tffn, jffn = seeded_ffn(CASES[case].get("biases", ()))
    tffn.update(CASES[case].get("ffn", {}))
    jffn.update(CASES[case].get("ffn", {}))
    x = np.random.default_rng(1).standard_normal((2, 12, H)).astype(
        np.float32)
    with torch.no_grad():
        topv, topi = T.route(tffn, tcfg, torch.from_numpy(x[0]))
        got = T.moe_layer(tffn, tcfg, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(topi.numpy(), jax_choice(jffn, jcfg, x[0]))
    if case == "topk_softmax":  # weights sum to 1, unrenormalised
        np.testing.assert_allclose(topv.sum(-1).numpy(), 1.0, rtol=1e-6)
    close(got, JT.moe_layer(jffn, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("tokens", [1, 40])
def test_biased_quant_experts_skip_the_grouped_glu(moe_cfgs, tokens,
                                                   monkeypatch):
    """gpt-oss's path on quantized experts: at a decode step's 2 slots
    (kernel 4) and a prefill's 80 (kernel 5) gate and up run alone with
    their biases; the grouped GLU never runs; within 1e-5 of max |y| of
    the JAX moe_layer on the same repacked bytes."""
    tcfg, jcfg = configs(moe_cfgs, "all_biases")
    tffn, jffn = seeded_ffn(("gate", "up", "down"), quant=GGMLType.Q8_0)

    def refuse(*args, **kwargs):
        raise AssertionError("the grouped GLU ran on biased experts")

    monkeypatch.setattr(T, "moe_qmatmul_glu", refuse)
    x = np.random.default_rng(2).standard_normal((1, tokens, H)).astype(
        np.float32)
    assert Q.moe_dims(tokens * 2, E)[2] == (tokens > 1)
    with torch.no_grad():
        got = T.moe_layer(tffn, tcfg, torch.from_numpy(x)).numpy()
    close(got, JT.moe_layer(jffn, jcfg, jnp.asarray(x)))


def test_sparsemixer_takes_the_first_maximum(moe_cfgs):
    """Experts 2 and 5 tie exactly on every token (the router's columns are
    equal): the first pick is 2, the second 5, as jnp.argmax picks, and the
    layer matches the JAX one."""
    tcfg, jcfg = configs(moe_cfgs, "sparsemixer")
    tffn, jffn = seeded_ffn()
    w = tffn["router"].weight.clone()
    w[:, 5] = w[:, 2] = w[:, 2].abs() + 1.0  # the largest logit, twice
    tffn["router"] = TL.DenseLinear(w)
    jffn["router"] = JL.DenseLinear(jnp.asarray(w.numpy()))
    x = np.abs(np.random.default_rng(3).standard_normal((1, 6, H))).astype(
        np.float32)
    with torch.no_grad():
        topv, topi = T.route(tffn, tcfg, torch.from_numpy(x[0]))
        got = T.moe_layer(tffn, tcfg, torch.from_numpy(x)).numpy()
    assert (topi[:, 0] == 2).all() and (topi[:, 1] == 5).all()
    np.testing.assert_array_equal(topi.numpy(), jax_choice(jffn, jcfg, x[0]))
    close(got, JT.moe_layer(jffn, jcfg, jnp.asarray(x)))


# -- the tiny presets end to end ---------------------------------------------


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("routing_presets")
    return {name: build_synthetic_gguf(str(d / f"{name}.gguf"), preset=name)
            for name in PRESETS}


@pytest.fixture(scope="module")
def engines(paths):
    cache = {}

    def get(name, mode):
        if (name, mode) not in cache:
            cache[name, mode] = (
                JEngine.load(paths[name], JConfig(weight_mode=mode)),
                Engine.load(paths[name], EngineConfig(weight_mode=mode),
                            device="cpu"))
        return cache[name, mode]
    return get


def _logits(eng, ids):
    r = eng.runner
    logits, _, _ = r.prefill(ids, r.init_kv())
    return logits.numpy() if torch.is_tensor(logits) else np.asarray(logits)


def jax_margins(je, ids, steps):
    """The JAX runner's top-2 logit margin over max |logit| at each greedy
    step (the prefill's, then each decode_one's)."""
    r = je.runner
    logits, kv, pos = r.prefill(ids, r.init_kv())
    out = []
    for _ in range(steps):
        lg = np.asarray(logits)
        top2 = np.sort(lg)[-2:]
        out.append(float((top2[1] - top2[0]) / np.abs(lg).max()))
        logits, kv = r.decode_one(int(lg.argmax()), pos, kv)
        pos += 1
    return out


@pytest.mark.parametrize("mode", ["dequant", "quant"])
@pytest.mark.parametrize("name", PRESETS)
def test_tiny_presets_match_jax_engine(engines, name, mode):
    je, te = engines(name, mode)
    close(_logits(te, IDS), _logits(je, IDS),
          REL if mode == "dequant" else QUANT_REL)
    steps = 12
    got, want = te.greedy_tokens(IDS, steps), je.greedy_tokens(IDS, steps)
    if got != want:
        first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        tie = next((i for i, m in enumerate(jax_margins(je, IDS, steps))
                    if m < NEAR), None)
        assert tie is not None and first >= tie, (got, want)


def test_tiny_presets_load_their_routing(engines):
    """What each preset exercises: gpt-oss's biases (router, q/k/v/o,
    experts), sinks and window on even layers; PhiMoE's sparsemixer with
    jitter 0.01 and LayerNorm biases; llama4's MoE on odd layers with a
    fused shared gate|up, sigmoid input scaling, chunked attention on layers
    0-2 and NoPE on layer 3; expert gate/up q4 and down q8 in quant mode."""
    _, oss = engines("tiny-gpt-oss", "quant")
    cfg, layers = oss.runner.cfg, oss.runner.params["layers"]
    ex = layers[0]["ffn"]["experts"]
    assert {"gate_bias", "up_bias", "down_bias"} <= set(ex)
    assert tuple(ex["gate_bias"].shape) == (8, 256)
    assert layers[0]["ffn"]["router"].bias is not None
    assert "sinks" in layers[0]["attn"] and oss.runner.swa_layers == (
        True, False)
    assert (ex["gate"].fmt, ex["up"].fmt, ex["down"].fmt) == ("q4", "q4",
                                                               "q8")
    assert cfg.num_experts_per_token == ROUTING_PRESETS[
        "tiny-gpt-oss"]["topk"]
    _, phi = engines("tiny-phimoe", "quant")
    assert phi.runner.cfg.expert_gating_func == 3
    assert phi.runner.cfg.router_jitter_eps == 0.01
    assert "bias" in phi.runner.params["layers"][0]["attn_norm"]
    _, l4 = engines("tiny-llama4", "quant")
    cfg, layers = l4.runner.cfg, l4.runner.params["layers"]
    assert cfg.moe_weight_before_ffn and cfg.expert_gating_func == 2
    assert ["router" in lay["ffn"] for lay in layers] == [False, True] * 2
    assert "gate_up" in layers[1]["ffn"]["shared"]
    assert [cfg.layer_is_swa(i) for i in range(4)] == [True] * 3 + [False]
    assert [cfg.layer_rope(i) is None for i in range(4)] == [False] * 3 + [
        True]


def test_params_from_numpy_carries_expert_biases(engines):
    """The JAX package's tiny-gpt-oss params, carried across, hold the
    expert biases (and the router's) of the port's own load."""
    je, te = engines("tiny-gpt-oss", "quant")
    tree = jax.tree_util.tree_map(np.asarray, je.runner.params)
    got = params_from_numpy(tree, "cpu")["layers"]
    for layer, want in zip(got, te.runner.params["layers"]):
        for key in ("gate_bias", "up_bias", "down_bias"):
            assert torch.equal(layer["ffn"]["experts"][key],
                               want["ffn"]["experts"][key])
        assert torch.equal(layer["ffn"]["router"].bias,
                           want["ffn"]["router"].bias)
