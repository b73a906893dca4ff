"""The PyTorch port's sparse-MoE slice against the JAX package on the CPU: the
MoE dequant-matmuls (the plain versions the wrappers take on the CPU) against
the Pallas kernels in interpret mode, the grouped dispatch plan, routing and
the MoE layer. The model-level comparisons (logits, greedy tokens, text,
params_from_numpy, the CLI) run the MoE variants of tests/test_torch_model.py.
The CUDA kernels themselves are held against the plain versions on a card by
tests/test_torch_kernels.py and chip_smoke.py."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.models import transformer as jtransformer
from llama_gguf_tpu.ops import qmatmul as JQ
from llama_gguf_tpu.ops.linear import QuantExpertStack as JStack
from llama_gguf_tpu.ops.linear import apply as japply
from llama_gguf_tpu.quant.quantize import quantize
from llama_gguf_tpu.quant.repack import repack as jrepack
from llama_gguf_tpu.utils.synthetic import build_synthetic_gguf as jbuild

from llama_gguf_tpu_torch.convert import params_from_numpy
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.models import transformer as T
from llama_gguf_tpu_torch.models.loader import ModelLoader
from llama_gguf_tpu_torch.gguf.reader import GGUFFile
from llama_gguf_tpu_torch.ops import linear as TL
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.ops.linear import QuantExpertStack, dequantize_expert
from llama_gguf_tpu_torch.quant.repack import repack
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf as tbuild

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 against f32, the products reassociated (as tests/test_qmatmul.py)
TOL = dict(rtol=2e-5, atol=2e-5)
E, K, N = 4, 256, 128
FORMATS = [GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K]
PROMPT = "The quick brown fox jumps over the lazy dog, again and again."


def make_stacks(t, n=N, seed=17):
    """The same E random experts as a JAX QuantExpertStack and a port one
    (each package repacks the same GGUF bytes with its own repack)."""
    rng = np.random.default_rng(seed)
    raws = [quantize(rng.standard_normal((n, K)).astype(np.float32) * 0.1, t)
            for _ in range(E)]
    jr = [jrepack(r, t, (n, K)) for r in raws]
    tr = [repack(r, t, (n, K)) for r in raws]
    has_mins = jr[0].mins is not None
    js = JStack(jnp.asarray(np.stack([r.packed for r in jr])),
                jnp.asarray(np.stack([r.scales for r in jr])),
                jnp.asarray(np.stack([r.mins for r in jr])) if has_mins
                else None, jr[0].fmt, jr[0].group, K, n)
    ts = QuantExpertStack(torch.from_numpy(np.stack([r.packed for r in tr])),
                          torch.from_numpy(np.stack([r.scales for r in tr])),
                          torch.from_numpy(np.stack([r.mins for r in tr]))
                          if has_mins else None, tr[0].fmt, tr[0].group, K, n)
    return js, ts


def make_idx(s, e=E, seed=1):
    """S = 6: a fixed routing; larger S: imbalanced, expert 2 takes every
    other slot and expert 1 none (as tests/test_qmatmul.py)."""
    if s == 6:
        return np.array([0, 3, 1, 1, 2, 0], np.int32)
    rng = np.random.default_rng(seed)
    idx = np.where(np.arange(s) % 2 == 0, 2, rng.integers(0, e, size=s))
    idx[idx == 1] = 3
    return idx.astype(np.int32)


def make_x(s, k=K, seed=2):
    return np.random.default_rng(seed).standard_normal((s, k)).astype(
        np.float32)


@pytest.mark.parametrize("s", [6, 45])
@pytest.mark.parametrize("t", FORMATS, ids=lambda t: t.name)
def test_moe_qmatmul_matches_pallas(t, s):
    """Slot-major (S = 6) and grouped (S = 45: not a multiple of C, an
    expert with no slots)."""
    js, ts = make_stacks(t)
    x, idx = make_x(s), make_idx(s)
    want = np.asarray(JQ.moe_qmatmul(jnp.asarray(x), js, jnp.asarray(idx),
                                     interpret=True, precision="highest"))
    got = Q.moe_qmatmul(torch.from_numpy(x), ts, torch.from_numpy(idx))
    assert got.shape == (s, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t,act", [(GGMLType.Q4_K, "silu"),
                                   (GGMLType.Q8_0, "silu"),
                                   (GGMLType.Q6_K, "silu"),
                                   (GGMLType.Q4_K, "gelu"),
                                   (GGMLType.Q8_0, "swiglu_oai")],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_moe_qmatmul_glu_matches_pallas(t, act):
    """Grouped gate/up with the GLU epilogue over two distinct stacks."""
    (jg, tg), (ju, tu) = make_stacks(t, seed=17), make_stacks(t, seed=18)
    x, idx = make_x(45), make_idx(45)
    want = JQ.moe_qmatmul_glu(jnp.asarray(x), jg, ju, jnp.asarray(idx), act,
                              interpret=True, precision="highest")
    assert want is not None
    got = Q.moe_qmatmul_glu(torch.from_numpy(x), tg, tu,
                            torch.from_numpy(idx), act)
    assert got.shape == (45, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [2, 6])
def test_moe_qmatmul_glu_declines_like_jax(s):
    """Below the grouped rule, and for an unknown activation, both packages
    return None and the caller takes the two slot-major calls."""
    (jg, tg), (ju, tu) = make_stacks(GGMLType.Q4_K), make_stacks(
        GGMLType.Q4_K, seed=18)
    x, idx = make_x(s), make_idx(6)[:s]
    for act in ("silu", "tanh"):
        assert JQ.moe_qmatmul_glu(jnp.asarray(x), jg, ju, jnp.asarray(idx),
                                  act, interpret=True) is None
        assert Q.moe_qmatmul_glu(torch.from_numpy(x), tg, tu,
                                 torch.from_numpy(idx), act) is None
    x, idx = make_x(45), make_idx(45)
    assert Q.moe_qmatmul_glu(torch.from_numpy(x), tg, tu,
                             torch.from_numpy(idx), "tanh") is None


@pytest.mark.parametrize("s", [6, 45])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda t: t.name)
def test_moe_qmatmul_ragged_n(t, s):
    """N = 192, which the JAX entry declines (None): held against the einsum
    of JAX's gather_dequant."""
    js, ts = make_stacks(t, n=192)
    x, idx = make_x(s), make_idx(s)
    assert JQ.moe_qmatmul(jnp.asarray(x), js, jnp.asarray(idx),
                          interpret=True) is None
    want = np.einsum("sk,skn->sn", x,
                     np.asarray(js.gather_dequant(jnp.asarray(idx))))
    got = Q.moe_qmatmul(torch.from_numpy(x), ts, torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t", FORMATS, ids=lambda t: t.name)
def test_dequantize_expert_matches_gather_dequant(t):
    js, ts = make_stacks(t)
    for e in range(E):
        np.testing.assert_array_equal(
            dequantize_expert(ts, e).numpy(),
            np.asarray(js.gather_dequant(jnp.asarray(e))))


@pytest.mark.parametrize("e_num", [4, 8])
@pytest.mark.parametrize("s", [32, 45, 256, 300])
def test_moe_group_plan_matches_jax(s, e_num):
    idx = make_idx(s, e_num, seed=s)
    c_rows, g_blocks, grouped = Q.moe_dims(s, e_num)
    assert grouped
    want = JQ._moe_group_plan(jnp.asarray(idx), e_num, c_rows, g_blocks)
    got = Q.moe_group_plan(torch.from_numpy(idx), e_num, c_rows, g_blocks)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_moe_dims_follow_the_jax_rule():
    for s in (1, 2, 31, 32, 45, 256, 300, 4096):
        for e_num in (4, 8, 128):
            c_rows, g_blocks, grouped = Q.moe_dims(s, e_num)
            assert c_rows == min(JQ.MOE_GROUP_ROWS,
                                 max(8, 1 << (s - 1).bit_length()))
            assert g_blocks == -(-s // c_rows) + e_num
            assert grouped == (s >= JQ.MOE_GROUPED_MIN_SLOTS
                               and g_blocks < s)
    assert (Q.MOE_GROUPED_MIN_SLOTS, Q.MOE_GROUP_ROWS) == (
        JQ.MOE_GROUPED_MIN_SLOTS, JQ.MOE_GROUP_ROWS)


def test_cpu_moe_path_does_not_count_launches():
    _, ts = make_stacks(GGMLType.Q4_K)
    Q.reset_launches()
    for s in (6, 45):
        Q.moe_qmatmul(torch.from_numpy(make_x(s)), ts,
                      torch.from_numpy(make_idx(s)))
    Q.moe_qmatmul_glu(torch.from_numpy(make_x(45)), ts, ts,
                      torch.from_numpy(make_idx(45)), "silu")
    assert set(Q.LAUNCHES.values()) == {0}


# -- the MoE layer ------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_moe(tmp_path_factory):
    """tiny-moe (Q5_1 gate/up, Q6_K down) from both packages. Seed 1: at
    seed 0 one token of PROMPT lies 8.8e-5 from a routing tie, under the
    margin test_routing_matches_jax_with_a_margin asks for."""
    path = str(tmp_path_factory.mktemp("moe") / "tiny-moe.gguf")
    tbuild(path, preset="tiny-moe", quant=GGMLType.Q4_K, seed=1)
    jeng = JEngine.load(path, JConfig(weight_mode="quant"))
    teng = Engine.load(path, EngineConfig(weight_mode="quant"), device="cpu")
    return path, jeng, teng


def test_synthetic_moe_builder_matches_jax(tmp_path):
    """The port's builder writes the JAX builder's tiny-moe byte for byte."""
    a, b = str(tmp_path / "jax.gguf"), str(tmp_path / "torch.gguf")
    jbuild(a, preset="tiny-moe", quant=GGMLType.Q4_K, seed=5)
    tbuild(b, preset="tiny-moe", quant=GGMLType.Q4_K, seed=5)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("tokens", [1, 40])
def test_moe_layer_matches_jax(tiny_moe, tokens):
    """Layer 0's MoE FFN on the same input: decode-sized (2 slots,
    slot-major) and prefill-sized (80 slots, grouped) dispatch."""
    _, jeng, teng = tiny_moe
    h = teng.runner.cfg.hidden_size
    x = np.random.default_rng(tokens).standard_normal(
        (1, tokens, h)).astype(np.float32)
    want = jtransformer.moe_layer(jeng.runner.params["layers"][0]["ffn"],
                                  jeng.runner.cfg, jnp.asarray(x))
    got = T.moe_layer(teng.runner.params["layers"][0]["ffn"], teng.runner.cfg,
                      torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dequant_moe_layer_loops_over_dense_experts(tiny_moe):
    path, _, teng = tiny_moe
    deq = Engine.load(path, EngineConfig(weight_mode="dequant"), device="cpu")
    ffn = deq.runner.params["layers"][0]["ffn"]
    e, k, n = ffn["experts"]["gate"].shape
    assert ffn["experts"]["gate"].dtype == torch.float32
    assert (e, k, n) == (4, 128, 256)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 40, 128)).astype(np.float32))
    np.testing.assert_allclose(
        T.moe_layer(ffn, deq.runner.cfg, x).numpy(),
        T.moe_layer(teng.runner.params["layers"][0]["ffn"], teng.runner.cfg,
                    x).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dense", ["gate", "up", "down"])
def test_mixed_stack_layer_sends_quantized_stacks_to_the_kernels(
        tiny_moe, monkeypatch, dense):
    """One stack dense (as the loader leaves an expert tensor it cannot keep
    quantized), the others quantized: each quantized stack still goes
    through the MoE kernel wrappers, and only the dense one loops over its
    experts; the values match the all-quantized layer."""
    _, _, teng = tiny_moe
    ffn = teng.runner.params["layers"][0]["ffn"]
    ex = dict(ffn["experts"])
    ex[dense] = torch.stack([dequantize_expert(ex[dense], e)
                             for e in range(ex[dense].packed.shape[0])])
    mixed = dict(ffn, experts=ex)
    calls = []  # (wrapper, the experts keys of the stacks it was given)

    def spy(fn, name):
        def wrapped(*args, **kw):  # kw: the layer's shared plan
            calls.append((name, {key for key in ex
                                 if any(a is ex[key] for a in args)}))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(T, "moe_qmatmul", spy(Q.moe_qmatmul, "moe_qmatmul"))
    monkeypatch.setattr(T, "moe_qmatmul_glu",
                        spy(Q.moe_qmatmul_glu, "moe_qmatmul_glu"))
    monkeypatch.setattr(T, "expert_matmul",
                        spy(Q.expert_matmul, "expert_matmul"))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 40, teng.runner.cfg.hidden_size)).astype(np.float32))
    got = T.moe_layer(mixed, teng.runner.cfg, x)
    assert [keys for n, keys in calls if n == "expert_matmul"] == [{dense}]
    assert set().union(*(keys for n, keys in calls if n != "expert_matmul")
                       ) == {"gate", "up", "down"} - {dense}
    if dense == "down":  # gate and up quantized: the fused grouped GLU
        assert calls[0] == ("moe_qmatmul_glu", {"gate", "up"})
    np.testing.assert_allclose(
        got.numpy(), T.moe_layer(ffn, teng.runner.cfg, x).numpy(),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("tokens,plans", [(40, 1), (1, 0)])
def test_moe_layer_shares_one_dispatch_plan(tiny_moe, monkeypatch, tokens,
                                            plans):
    """A layer whose slots take the grouped kernels makes moe_group_plan
    once and hands the same plan to its gate|up and down products; it
    equals the plan each entry makes alone from the layer's routing. At a
    decode step's 2 slots no plan is made."""
    _, _, teng = tiny_moe
    ffn, cfg = teng.runner.params["layers"][0]["ffn"], teng.runner.cfg
    made, given, routed = [], [], []
    make_plan, route = T.moe_group_plan, T.route

    def counted(*args):
        made.append(make_plan(*args))
        return made[-1]

    def spy(fn):
        def wrapped(*args, plan=None, **kw):
            given.append(plan)
            return fn(*args, plan=plan, **kw)
        return wrapped

    def recorded(*args):
        routed.append(route(*args))
        return routed[-1]

    monkeypatch.setattr(T, "moe_group_plan", counted)
    monkeypatch.setattr(T, "route", recorded)
    monkeypatch.setattr(T, "moe_qmatmul", spy(Q.moe_qmatmul))
    monkeypatch.setattr(T, "moe_qmatmul_glu", spy(Q.moe_qmatmul_glu))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, tokens, cfg.hidden_size)).astype(np.float32))
    T.moe_layer(ffn, cfg, x)
    assert len(made) == plans
    # grouped: the gate|up GLU and down; else the GLU declines, and gate, up
    # and down go one by one
    assert len(given) == (2 if plans else 4)
    assert all(p is (made[0] if plans else None) for p in given)
    if plans:
        idx = routed[0][1].reshape(-1).to(torch.int32)
        c_rows, g_blocks, grouped = Q.moe_dims(idx.shape[0], cfg.num_experts)
        assert grouped
        for got, want in zip(made[0], make_plan(idx, cfg.num_experts, c_rows,
                                                g_blocks)):
            assert torch.equal(got, want)


def test_routing_matches_jax_with_a_margin(tiny_moe, monkeypatch):
    """Every live routing decision of a prefill and 16 greedy steps: the
    port's top-k ids equal the JAX package's on the same router input, the
    two packages' router probabilities agree to 1e-6, and the smallest top-2
    vs third probability margin exceeds 1e-4, so a flip from reassociated
    sums would show here and not as a logit mismatch."""
    _, jeng, teng = tiny_moe
    seen = []
    route = T.route

    def record(ffn, cfg, xf):
        topv, topi = route(ffn, cfg, xf)
        seen.append((ffn, xf.clone(), topi.clone()))
        return topv, topi

    monkeypatch.setattr(T, "route", record)
    ids = teng.tokenizer.encode(PROMPT)
    teng.greedy_tokens(ids, 16)
    assert len(seen) == 2 * 17  # 2 layers x (prefill + 16 decode steps)
    layers = teng.runner.params["layers"]
    margin = 1.0
    for ffn, xf, topi in seen:
        # the prompt's rows; the prefill bucket's padding rows feed nothing
        xf, topi = xf[:len(ids)], topi[:len(ids)]
        li = next(i for i, lay in enumerate(layers) if lay["ffn"] is ffn)
        jrouter = jeng.runner.params["layers"][li]["ffn"]["router"]
        jprobs = jax.nn.softmax(japply(jrouter, jnp.asarray(xf.numpy())),
                                axis=-1)
        _, jtopi = jax.lax.top_k(jprobs, 2)
        np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
        probs = torch.softmax(TL.apply(ffn["router"], xf), -1)
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                                   rtol=0, atol=1e-6)
        p = torch.sort(probs, descending=True).values
        margin = min(margin, (p[:, 1] - p[:, 2]).min().item())
    assert margin > 1e-4


@pytest.mark.parametrize("case", ["sigmoid", "sparsemixer", "input_scaled"])
def test_unported_routings_raise(tiny_moe, case):
    """Every routing of the JAX moe_layer is ported (the name is the test's
    from before: the last two raised until the load-path and routing slice).
    PhiMoE's sparsemixer (gating 3, router_jitter_eps 0.01) and llama4's
    input-scaled experts on tiny-moe's quantized layer 0, at 16 tokens
    (32 slots: kernel 4 per slot): the port's moe_layer within 1e-5 of max
    |value| of the JAX one (Pallas in interpret mode). DeepSeek-V3's
    sigmoid routing: on tiny-moe's router with a seeded bias and 2 groups
    of 2, the port's route gives the JAX moe_layer's experts and weights
    (its output within 1e-5 of max |value|)."""
    _, jeng, teng = tiny_moe
    cfg = teng.runner.cfg
    ffn = teng.runner.params["layers"][0]["ffn"]
    if case != "sigmoid":
        change = ({"sparsemixer": dict(expert_gating_func=3,
                                       router_jitter_eps=0.01),
                   "input_scaled": dict(moe_weight_before_ffn=True)}[case])
        x = np.random.default_rng(4).standard_normal(
            (1, 16, cfg.hidden_size)).astype(np.float32)
        with torch.no_grad():
            got = T.moe_layer(ffn, dataclasses.replace(cfg, **change),
                              torch.from_numpy(x)).numpy()
        want = np.asarray(jtransformer.moe_layer(
            jeng.runner.params["layers"][0]["ffn"],
            dataclasses.replace(jeng.runner.cfg, **change), jnp.asarray(x)))
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        return
    bias = np.random.default_rng(2).standard_normal(4).astype(
        np.float32) * 0.05
    change = dict(expert_gating_func=2, expert_group_count=2,
                  expert_group_used_count=1, expert_weights_scale=2.5)
    tcfg = dataclasses.replace(cfg, **change)
    jcfg = dataclasses.replace(jeng.runner.cfg, **change)
    tffn = dict(ffn, router_bias=torch.from_numpy(bias))
    jffn = dict(jeng.runner.params["layers"][0]["ffn"],
                router_bias=jnp.asarray(bias))
    x = np.random.default_rng(3).standard_normal(
        (1, 16, cfg.hidden_size)).astype(np.float32)
    with torch.no_grad():
        topv, topi = T.route(tffn, tcfg, torch.from_numpy(x[0]))
        got = T.moe_layer(tffn, tcfg, torch.from_numpy(x)).numpy()
    want = np.asarray(jtransformer.moe_layer(jffn, jcfg, jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # both experts of a token lie in its one kept group of two
    assert ((topi[:, 0] // 2) == (topi[:, 1] // 2)).all()
    np.testing.assert_allclose(topv.sum(-1).numpy(), 2.5, rtol=1e-6)


# shared experts (ffn_*_shexp) load since the Qwen3Next slice
# (tests/test_torch_hybrid.py), DeepSeek-V3's routing bias since the
# DeepSeek slice (tests/test_torch_mla.py)
@pytest.mark.parametrize("extra", ["ffn_down_exps.bias", "exp_probs_b.bias",
                                   "ffn_gate_exps.bias"])
def test_unported_moe_tensors_raise(tiny_moe, extra):
    """Every MoE tensor the JAX loader reads loads (the name is the test's
    from before: the expert biases raised until the load-path and routing
    slice). A tensor of the GGUF stands in under the extra name: the
    router's choice bias (exp_probs_b) and gpt-oss's per-expert biases
    (experts["down_bias"], ["gate_bias"]) equal it, as in the JAX
    loader."""
    from llama_gguf_tpu.gguf.reader import GGUFFile as JGGUFFile
    from llama_gguf_tpu.models.loader import ModelLoader as JLoader

    path, _, _ = tiny_moe
    name = f"blk.0.{extra}"
    gguf, jgguf = GGUFFile.open(path), JGGUFFile.open(path)
    gguf.tensors[name] = gguf.tensors["blk.0.ffn_norm.weight"]
    jgguf.tensors[name] = jgguf.tensors["blk.0.ffn_norm.weight"]
    loader = ModelLoader(gguf, mode="quant", device="cpu")
    jloader = JLoader(jgguf, mode="quant")
    ffn = loader.load_layer(0, loader.config)["ffn"]
    jffn = jloader.load_layer(0, jloader.config)["ffn"]
    if extra == "exp_probs_b.bias":  # loads as the router's choice bias
        got, want = ffn["router_bias"], jffn["router_bias"]
    else:
        key = extra.split("_")[1] + "_bias"
        got, want = ffn["experts"][key], jffn["experts"][key]
    np.testing.assert_array_equal(got.numpy(),
                                  loader.dense("blk.0.ffn_norm.weight"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_params_from_numpy_converts_expert_stacks(tiny_moe):
    _, jeng, teng = tiny_moe
    tree = jax.tree_util.tree_map(np.asarray, jeng.runner.params)
    ex = params_from_numpy(tree, "cpu")["layers"][1]["ffn"]["experts"]
    for key in ("gate", "up", "down"):
        got, want = ex[key], teng.runner.params["layers"][1]["ffn"][
            "experts"][key]
        assert isinstance(got, QuantExpertStack)
        assert (got.fmt, got.group, got.k, got.n) == (
            want.fmt, want.group, want.k, want.n)
        assert torch.equal(got.packed, want.packed)
        assert torch.equal(got.scales, want.scales)
        assert (got.mins is None) == (want.mins is None)


def test_module_cli_runs_the_moe_model(tiny_moe):
    """python -m llama_gguf_tpu_torch run on the MoE GGUF prints the JAX
    package's greedy text."""
    path, jeng, _ = tiny_moe
    from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler

    res = subprocess.run(
        [sys.executable, "-m", "llama_gguf_tpu_torch", "run", path, "-p",
         PROMPT, "-n", "6", "-t", "0", "--device", "cpu", "--no-stream"],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    want = jeng.generate(PROMPT, max_tokens=6,
                         sampler=JSampler(temperature=0.0))
    assert res.stdout == want + "\n"
