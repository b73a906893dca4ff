"""The port's Mamba-family slice (models/mamba.py, Falcon-H1's parallel
hybrid, the "mamba" state in the runner and the batched engine) against the
JAX package on the CPU.

Fixtures, each F32 and at a Q4_K/Q6_K mix: the Mamba-1 GGUF of
tests/test_bert_mamba.py (``build_mamba_gguf`` at hidden 256, its mix made
with the port's requantize: Q4_K matrices, Q6_K table and head, F16 where a
row does not divide 256), the JAX package's tiny-falconh1 (its Q4_K falls
back to Q5_1 at hidden 128, with a Q8_0 table and head) and the port's
tiny-mamba (the JAX-free Mamba-1 model the card runs), tiny-mamba2,
tiny-lfm2, tiny-jamba and tiny-granitehybrid (hidden 256: Q4_K
projections, Q6_K down, table and head). In quant mode the JAX package runs
its Pallas kernels in interpret mode and the port its kernels' plain
versions. Tolerances: a layer alone, state included, within 1e-5 of max
|value| (f32, the same operations in the same order, matmuls reassociated);
logits within 1e-3 of max |logit| (f32 through up to four layers); greedy
tokens equal."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_bert_mamba import build_mamba_gguf

from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.models import kv as JKV
from llama_gguf_tpu.models import mamba as JM
from llama_gguf_tpu.models import transformer as JT
from llama_gguf_tpu.models.embeddings import \
    extract_hidden_states as j_hidden_states
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler
from llama_gguf_tpu.utils.synthetic import build_synthetic_gguf as jbuild

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.convert import (kv_from_numpy, kv_to_numpy,
                                          params_from_numpy)
from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.prompt_cache import PromptCache
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.gguf.requantize import (QuantizeOptions,
                                                  quantize_model)
from llama_gguf_tpu_torch.models import kv as KV
from llama_gguf_tpu_torch.models import mamba as M
from llama_gguf_tpu_torch.models import transformer as T
from llama_gguf_tpu_torch.ops import linear as TL
from llama_gguf_tpu_torch.ops.norms import apply_norm
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.server import app
from llama_gguf_tpu_torch.utils.synthetic import (SSM_PRESETS,
                                                  build_synthetic_gguf)

torch.set_num_threads(1)

REL = 1e-5  # a layer alone, state included: of max |value|
LOGIT_REL = 1e-3  # logits: of max |logit|
IDS = [44, 12, 310, 2, 77, 66, 5, 9, 100, 31, 400, 17]
FIXTURES = {  # name: (preset or None for build_mamba_gguf, layer kinds)
    "mamba1": (None, ("mamba",) * 2),
    "mamba1-preset": ("tiny-mamba", ("mamba",) * 2),
    "mamba2": ("tiny-mamba2", ("mamba2",) * 2),
    "falconh1": ("tiny-falconh1", ("hybrid_par",) * 2),
    "lfm2": ("tiny-lfm2", ("shortconv", "attn") * 2),
    "jamba": ("tiny-jamba", ("attn", "mamba") * 2),
    "granite": ("tiny-granitehybrid", ("mamba2", "mamba2", "attn", "mamba2")),
}
QUANTS = {"f32": GGMLType.F32, "q4k": GGMLType.Q4_K}
GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max diff {err:.3g} > {rel} * {scale:.3g}"


def _build(d, name: str, quant: str) -> str:
    preset = FIXTURES[name][0]
    path = str(d / f"{name}-{quant}.gguf")
    if preset is not None:
        return build_synthetic_gguf(path, preset=preset, quant=QUANTS[quant])
    f32 = str(d / f"{name}-f32.gguf")
    build_mamba_gguf(f32, vocab=512, hidden=256, d_inner=512, d_state=16,
                     dt_rank=16, ctx=256)
    if quant != "f32":
        quantize_model(f32, path, QuantizeOptions(
            target=GGMLType.Q4_K, embed_type=GGMLType.Q6_K))
    return path


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mamba")
    return {(name, q): _build(d, name, q) for name in FIXTURES
            for q in QUANTS}


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


# -- the model ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dequant", "quant"])
@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("name", list(FIXTURES))
def test_prefill_logits_and_greedy_tokens_match_jax(engines, name, quant,
                                                    mode):
    je, te = engines(name, quant, mode)
    assert te.runner.cfg.layer_kinds == je.runner.cfg.layer_kinds \
        == FIXTURES[name][1]
    close(_logits(te, IDS), _logits(je, IDS), LOGIT_REL)
    assert te.greedy_tokens(IDS, 10) == je.greedy_tokens(IDS, 10)


def test_fixture_layouts(engines):
    """The mixes reach the kernels: Q4_K (q4) projections of every mixer,
    Q6_K (q8) down and tied head; Jamba's ssm_dt (K = 16) stays dense."""
    _, te = engines("granite", "q4k", "quant")
    p = te.runner.params
    for key in ("ssm_in", "ssm_out"):
        assert isinstance(p["layers"][0][key], TL.QuantLinear)
        assert p["layers"][0][key].fmt == "q4"
    assert p["layers"][2]["attn"]["wqkv"].fmt == "q4"
    assert p["layers"][0]["ffn"]["gate_up"].fmt == "q4"
    assert p["layers"][0]["ffn"]["down"].fmt == "q8"
    assert p["output"].source_type == "Q6_K" and te.runner.cfg.tie_word_embeddings
    _, te = engines("jamba", "q4k", "quant")
    lay = te.runner.params["layers"][1]
    assert isinstance(lay["ssm_x"], TL.QuantLinear)
    assert isinstance(lay["ssm_dt"], TL.DenseLinear)
    assert isinstance(lay["ffn"]["experts"]["gate"], TL.QuantExpertStack)
    _, te = engines("mamba1", "q4k", "quant")
    assert te.runner.params["layers"][0]["ssm_in"].fmt == "q4"
    assert te.runner.params["output"].source_type == "Q6_K"


def test_granite_config_and_multipliers(engines):
    """Granite's four multipliers (logit_scale a divisor), NoPE attention
    and Mamba-2 widths parse alike in both packages."""
    je, te = engines("granite")
    for cfg in (te.runner.cfg, je.runner.cfg):
        assert (cfg.embedding_scale, cfg.logit_scale, cfg.residual_scale,
                cfg.attention_scale) == pytest.approx((12.0, 1 / 8, 0.22,
                                                       0.015625))
        assert cfg.rope.n_dims == 0 and cfg.layer_rope(2) is None
        assert (cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_n_group,
                cfg.ssm_dt_rank) == (512, 16, 1, 8)


def test_granite_micro_preset_is_the_published_config():
    """granite-4.0-h-micro-l10 at ibm-granite/granite-4.0-h-micro's widths,
    cut to one period of layer_types (attention at index 5 of 10)."""
    c = SSM_PRESETS["granite-4.0-h-micro-l10"]
    assert (c["arch"], c["vocab"], c["hidden"], c["heads"], c["kv_heads"],
            c["hidden"] // c["heads"], c["ffn"]) == (
        "granitehybrid", 100352, 2048, 32, 8, 64, 8192)
    assert c["kinds"] == "22222a2222"
    assert (c["di"], c["ds"], c["ng"], c["nh"], c["conv"]) == (
        4096, 128, 1, 64, 4)
    assert c["granite"] == (12.0, 8.0, 0.22, 0.015625) and c["tie"]
    # ssm_in: [z | x B C | dt] = 2 d_inner + 2 groups d_state + heads
    assert 2 * c["di"] + 2 * c["ng"] * c["ds"] + c["nh"] == 8512


def test_falconh1_preset_bytes_match_jax(tmp_path):
    for q in (GGMLType.F32, GGMLType.Q4_K):
        a = jbuild(str(tmp_path / f"j{q.name}.gguf"), preset="tiny-falconh1",
                   quant=q)
        b = build_synthetic_gguf(str(tmp_path / f"t{q.name}.gguf"),
                                 preset="tiny-falconh1", quant=q)
        assert open(a, "rb").read() == open(b, "rb").read()


def test_lfm2_final_norm_is_token_embd_norm(engines):
    """LFM2's final norm lives in token_embd_norm (no output_norm): the
    port takes it as the final norm, as the JAX package does, and applies
    no embedding norm; applied as an embedding norm it moves the logits
    far beyond the tolerance."""
    je, te = engines("lfm2")
    p = te.runner.params
    assert "embed_norm" not in p
    assert np.array_equal(p["final_norm"]["weight"].numpy(), np.asarray(
        je.runner.params["final_norm"]["weight"]))
    want = _logits(je, IDS)
    close(_logits(te, IDS), want, LOGIT_REL)
    wrong = dict(p, embed_norm=p["final_norm"],
                 final_norm={"weight": torch.ones_like(
                     p["final_norm"]["weight"])})
    r = te.runner
    toks = torch.tensor([IDS], dtype=torch.int32)
    pos = torch.arange(len(IDS), dtype=torch.int32)[None]
    with torch.no_grad():
        logits, _ = T.forward(wrong, r.cfg, toks, pos, r._make_kv(1),
                              torch.tensor([len(IDS)], dtype=torch.int32))
    err = np.abs(logits[0, -1].numpy() - want).max()
    assert err > 10 * LOGIT_REL * np.abs(want).max()


def test_jamba_routing_has_a_margin(engines, monkeypatch):
    """Every live routing decision of tiny-jamba's prefill and 10 greedy
    steps: the smallest top-2 vs third router probability margin exceeds
    1e-4, so a flip from reassociated sums would show here and not as a
    token mismatch."""
    _, te = engines("jamba", "q4k", "quant")
    seen = []
    route = T.route

    def record(ffn, cfg, xf):
        topv, topi = route(ffn, cfg, xf)
        seen.append(torch.softmax(TL.apply(ffn["router"], xf), -1))
        return topv, topi

    monkeypatch.setattr(T, "route", record)
    te.greedy_tokens(IDS, 10)
    assert len(seen) == 2 * 11  # 2 MoE layers x (prefill + 10 steps)
    margin = min((torch.sort(p[:len(IDS)], descending=True).values[:, 1]
                  - torch.sort(p[:len(IDS)], descending=True).values[:, 2]
                  ).min().item() for p in seen)
    assert margin > 1e-4


# -- each layer kind alone ------------------------------------------------------


def _random_caches(je, b: int, rng):
    """A JAX runner cache of ``b`` rows with random Mamba state, and the
    same cache carried across to the port (kv_from_numpy)."""
    np_kv = jax.tree_util.tree_map(np.asarray, je.runner.init_kv(b))
    np_kv["mamba"] = {key: tuple(
        (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        for a in np_kv["mamba"][key]) for key in ("conv", "ssm")}
    return jax.tree_util.tree_map(jnp.asarray, np_kv), \
        kv_from_numpy(np_kv, "cpu")


def _j_layer(kind):
    return {"mamba": JM.mamba_layer, "mamba2": JM.mamba2_layer,
            "shortconv": JM.shortconv_layer,
            "hybrid_par": JT.parallel_hybrid_layer}[kind]


def _both_layers(engines, name, li, rng, positions, lengths, quant="f32",
                 mode="dequant"):
    """Layer ``li`` of both packages on the same x, positions, lengths and
    random state. Returns (JAX x, JAX cache, port x, port cache, the port
    cache's state before)."""
    je, te = engines(name, quant, mode)
    cfg = te.runner.cfg
    b, t = positions.shape
    x = rng.standard_normal((b, t, cfg.hidden_size)).astype(np.float32)
    jkv, tkv = _random_caches(je, b, rng)
    before = {key: [a.clone() for a in tkv["mamba"][key]]
              for key in ("conv", "ssm")}
    ptrs = [a.data_ptr() for a in tkv["mamba"]["conv"] + tkv["mamba"]["ssm"]]
    jx, jkv = _j_layer(cfg.layer_kinds[li])(
        je.runner.params["layers"][li], je.runner.cfg, jnp.asarray(x),
        jnp.asarray(positions), jkv, li, jnp.asarray(lengths))
    with torch.no_grad():
        tx, out = T.layer_forward(
            te.runner.params["layers"][li], cfg, torch.from_numpy(x),
            torch.from_numpy(positions), tkv, li, torch.from_numpy(lengths))
    assert out is tkv
    assert [a.data_ptr() for a in
            tkv["mamba"]["conv"] + tkv["mamba"]["ssm"]] == ptrs  # in place
    return np.asarray(jx), jkv, tx.numpy(), tkv, before


LAYERS = [("mamba1", 0), ("jamba", 1), ("mamba2", 0), ("granite", 1),
          ("falconh1", 0), ("lfm2", 0)]


@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("name,li", LAYERS,
                         ids=[f"{n}-{i}" for n, i in LAYERS])
def test_layer_matches_jax(engines, name, li, quant):
    """One block on a random carried state, one row ragged (two padding
    tokens): x, the conv window and the ssm state within REL (and the K/V
    a parallel hybrid writes)."""
    rng = np.random.default_rng(3)
    t = 6
    positions = np.stack([np.arange(t), 9 + np.arange(t)]).astype(np.int32)
    lengths = np.array([t, 9 + 4], np.int32)
    jx, jkv, tx, tkv, _ = _both_layers(engines, name, li, rng, positions,
                                       lengths, quant, "quant")
    close(tx, jx)
    for key in ("conv", "ssm"):
        if tkv["mamba"][key][li].numel():
            close(tkv["mamba"][key][li].numpy(), jkv["mamba"][key][li])
    if name == "falconh1":
        got = kv_to_numpy(tkv)
        for key in ("k", "v"):
            close(got[key][li], jkv[key][li])


@pytest.mark.parametrize("name,li", LAYERS,
                         ids=[f"{n}-{i}" for n, i in LAYERS])
def test_padding_leaves_state_bit_unchanged(engines, name, li):
    """An all-padding row (positions >= lengths) leaves its conv window and
    ssm state bit for bit as they were, in both packages; a row whose last
    tokens are padding ends where the same row without them ends (within
    REL: the CPU's vectorised exp may round a lane another way at another
    length)."""
    rng = np.random.default_rng(5)
    positions = np.stack([np.arange(4), 100 + np.arange(4)]).astype(np.int32)
    lengths = np.array([4, 0], np.int32)
    _, jkv, _, tkv, before = _both_layers(engines, name, li, rng, positions,
                                          lengths)
    for key in ("conv", "ssm"):
        if not before[key][li].numel():
            continue
        b0 = before[key][li].numpy()
        for got in (np.asarray(jkv["mamba"][key][li]),
                    tkv["mamba"][key][li].numpy()):
            assert np.array_equal(got[1], b0[1])
            assert not np.array_equal(got[0], b0[0])
    _, te = engines(name)
    r = te.runner
    layer, cfg = r.params["layers"][li], r.cfg
    x = torch.from_numpy(rng.standard_normal((1, 5, cfg.hidden_size))
                         .astype(np.float32))
    ends = []
    for t, length in ((5, 3), (3, 3)):
        kv = r._make_kv(1)
        for a in kv["mamba"]["conv"] + kv["mamba"]["ssm"]:
            a.copy_(torch.from_numpy(np.random.default_rng(9).standard_normal(
                tuple(a.shape)).astype(np.float32)))
        with torch.no_grad():
            T.layer_forward(layer, cfg, x[:, :t],
                            torch.arange(t, dtype=torch.int32)[None], kv, li,
                            torch.tensor([length], dtype=torch.int32))
        ends.append(kv["mamba"])
    for key in ("conv", "ssm"):
        if ends[1][key][li].numel():
            close(ends[0][key][li].numpy(), ends[1][key][li].numpy())


def test_scans_match_the_reference_order():
    """selective_scan and ssd_scan against a plain token loop of the JAX
    formulas, with padding tokens in the middle of the window frozen."""
    rng = np.random.default_rng(7)
    b, t, di, ds, nh, hd = 2, 5, 6, 4, 3, 2
    valid = torch.tensor([[1, 1, 0, 1, 0], [0, 0, 0, 0, 0]], dtype=torch.bool)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    dt, xs, bt, ct = r(b, t, di).abs(), r(b, t, di), r(b, t, ds), r(b, t, ds)
    a, s0 = -r(di, ds).abs(), r(b, di, ds)
    y, s = M.selective_scan(dt, xs, bt, ct, a, valid, s0)
    st = s0
    for i in range(t):
        v = valid[:, i, None, None].float()
        dec = torch.exp(dt[:, i, :, None] * a) * v + (1 - v)
        st = dec * st + (dt[:, i] * xs[:, i])[..., None] * bt[:, i, None] * v
        close(y[:, i].numpy(), torch.einsum("bdn,bn->bd", st, ct[:, i]))
    assert torch.equal(s[1], s0[1])
    close(s.numpy(), st.numpy())
    decay, dtx = r(b, t, nh).abs(), r(b, t, nh, hd)
    bh, ch, s0 = r(b, t, nh, ds), r(b, t, nh, ds), r(b, nh, hd, ds)
    y, s = M.ssd_scan(decay, dtx, bh, ch, s0)
    st = s0
    for i in range(t):
        st = decay[:, i, :, None, None] * st + dtx[:, i, ..., None] * \
            bh[:, i, :, None, :]
        close(y[:, i].numpy(), torch.einsum("bnhs,bns->bnh", st, ch[:, i]))
    close(s.numpy(), st.numpy())


# -- recurrent state through prefill, decode, the runner and the engine --------


@pytest.mark.parametrize("name", list(FIXTURES))
def test_prefill_then_decode_equals_token_by_token(engines, name):
    """A prefill of the prompt then 3 decode steps, against the same 15
    tokens fed one at a time from an empty cache, and against a prefill in
    two chunks: the same logits, in both packages."""
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


def test_init_kv_zeroes_state_in_place(engines):
    """init_kv hands back the same tensors, K/V and Mamba state zeroed in
    place (a graph captured on them stays bound)."""
    _, te = engines("granite")
    r = te.runner
    kv = r.init_kv(2, owner="t")
    r.prefill(IDS, kv, batch_idx=1)
    m = kv["mamba"]
    assert m["ssm"][0][1].abs().sum() > 0 and m["conv"][0][1].abs().sum() > 0
    assert not m["ssm"][0][0].any()
    assert m["ssm"][0].shape == (2, 8, 64, 16)
    assert m["conv"][0].shape == (2, 3, 512 + 2 * 16)
    tensors = m["conv"] + m["ssm"] + [kv["k"][2]]
    again = r.init_kv(2, owner="t")
    assert again is kv
    assert again["mamba"]["conv"] + again["mamba"]["ssm"] + [
        again["k"][2]] == tensors
    assert not any(t.any() for t in tensors)
    r.release_kv("t")


@pytest.mark.parametrize("name", ["mamba1", "lfm2"])
def test_state_shapes_match_jax(engines, name):
    je, te = engines(name)
    jst = je.runner.init_kv(3)["mamba"]
    tst = te.runner._make_kv(3)["mamba"]
    for key in ("conv", "ssm"):
        assert [tuple(a.shape) for a in tst[key]] == \
            [tuple(a.shape) for a in jst[key]]


def test_capture_warm_ups_leave_state_unchanged(engines):
    """The eager warm-ups a capture runs (a step on dummy inputs in the drop
    slot with lengths 0; a greedy step with warm=True) leave every row's
    Mamba state as it was."""
    _, te = engines("falconh1", "q4k", "quant")
    r = te.runner
    kv = r._make_kv(2)
    r.prefill(IDS, kv, batch_idx=0)
    before = [t.clone() for t in kv["mamba"]["conv"] + kv["mamba"]["ssm"]]
    drop = torch.full((2, 1), r.max_seq, dtype=torch.int32)
    zeros = torch.zeros(2, dtype=torch.int32)
    with torch.no_grad():
        r._forward(kv, 256, torch.zeros((2, 1), dtype=torch.int32), drop,
                   zeros)
        r._decode_body(zeros.clone(), drop[:, 0].clone(), kv, 256, warm=True)
    for b, a in zip(before, kv["mamba"]["conv"] + kv["mamba"]["ssm"]):
        assert torch.equal(a, b)


def test_reused_row_starts_from_no_state(engines):
    """The JAX runner prefilling a prompt on a row that held another
    sequence starts from that sequence's Mamba state (its logits move by
    more than 1e-3 of max |logit|), while the port's clear_state gives the
    fresh row's logits."""
    je, te = engines("mamba2")
    ids, other = IDS[:6], [7, 8, 9, 10, 11, 12, 13, 14]
    fresh = _logits(je, ids)
    _, jkv, _ = je.runner.prefill(other, je.runner.init_kv())
    stale = np.asarray(je.runner.prefill(ids, jkv)[0])
    assert np.abs(stale - fresh).max() > 1e-3 * np.abs(fresh).max()
    r = te.runner
    kv = r._make_kv(1)
    r.prefill(other, kv)
    r.clear_state(kv, 0)
    assert not any(t.any() for t in kv["mamba"]["conv"] + kv["mamba"]["ssm"])
    close(r.prefill(ids, kv)[0].numpy(), fresh, LOGIT_REL)


@pytest.mark.parametrize("name", ["granite", "falconh1", "lfm2", "jamba"])
def test_batched_engine_reused_rows_match_jax_single_stream(paths, engines,
                                                            name):
    """B = 2, 5 requests (so rows are reused), chunk 8 (two prompts longer
    than a chunk): each request's greedy tokens equal the JAX single-stream
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


def test_prompt_cache_stays_empty(paths):
    """Mamba-family models bypass the prompt cache, in the Engine and in
    the batched engine."""
    eng = Engine.load(paths["granite", "f32"],
                      EngineConfig(prompt_cache=True, max_batch=2),
                      device="cpu")
    for _ in range(2):
        eng.generate("Hello there, world", max_tokens=3, sampler=GREEDY)
    cache = PromptCache(min_prefix=2)
    be = BatchedEngine(eng.runner, eng.tokenizer, prompt_cache=cache)
    try:
        be.generate("Hello there, world", max_tokens=3, sampler=GREEDY)
    finally:
        be.shutdown()
    for c in (eng.prompt_cache, cache):
        assert c.entry_count == 0 and c.stats.hits == 0
    assert "mamba" in eng.runner.init_kv(1)


def test_context_shift_leaves_state_and_matches_jax(engines):
    """Falcon-H1 (RoPE attention beside the mixer): after a prefill, a
    shift by 4 re-rotates the keys as JAX's shift_left does, leaves the
    Mamba state bit-unchanged (JAX leaves it too), and the next 6 greedy
    tokens equal JAX's."""
    je, te = engines("falconh1")
    n = 4
    logits, jkv, pos = je.runner.prefill(IDS, je.runner.init_kv())
    tkv = te.runner.init_kv()
    te.runner.prefill(IDS, tkv)
    state = [t.clone() for t in tkv["mamba"]["conv"] + tkv["mamba"]["ssm"]]
    jkv = JKV.shift_left(jkv, n, model_cfg=je.runner.cfg)
    te.runner.shift_left(tkv, n)
    for a, b in zip(tkv["mamba"]["conv"] + tkv["mamba"]["ssm"], state):
        assert torch.equal(a, b)
    got = kv_to_numpy(tkv)
    for key in ("k", "v"):
        for a, b in zip(got[key], jkv[key]):
            close(a, b)
    for key in ("conv", "ssm"):
        for a, b in zip(got["mamba"][key], jkv["mamba"][key]):
            close(a, b)
    toks = []
    for r, kv in ((je.runner, jkv), (te.runner, tkv)):
        tok, p, out = int(np.argmax(np.asarray(logits))), pos - n, []
        for _ in range(6):
            step, kv = r.decode_one(tok, p, kv)
            tok, p = int(np.argmax(np.asarray(step))), p + 1
            out.append(tok)
        toks.append(out)
    assert toks[0] == toks[1]


def test_kv_helpers_cover_mamba_state():
    kv = KV.init_cache(2, 3, 8, 1, 4, device="cpu")
    kv["mamba"] = {"conv": [torch.ones(3, 2, 5), torch.ones(3, 0, 0)],
                   "ssm": [torch.ones(3, 2, 2, 2), torch.ones(3, 1, 1)]}
    KV.clear_state(kv, 1)
    for t in kv["mamba"]["conv"][:1] + kv["mamba"]["ssm"]:
        assert not t[1].any() and t[[0, 2]].all()
    KV.zero_(kv)
    assert not any(t.any() for t in kv["mamba"]["ssm"])


# -- carrying params and caches across ------------------------------------------


def test_params_from_numpy_same_logits(engines):
    je, te = engines("jamba", "q4k", "quant")
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, je.runner.params), "cpu")
    r = te.runner
    toks = torch.tensor([IDS], dtype=torch.int32)
    pos = torch.arange(len(IDS), dtype=torch.int32)[None]
    lens = torch.tensor([len(IDS)], dtype=torch.int32)
    outs = []
    for p in (params, r.params):
        with torch.no_grad():
            logits, _ = T.forward(p, r.cfg, toks, pos, r._make_kv(1), lens)
        outs.append(logits.numpy())
    close(outs[0], outs[1], 1e-5)


@pytest.mark.parametrize("name", ["granite", "lfm2"])
def test_kv_from_numpy_carries_jax_state(engines, name):
    """A JAX cache after a prefill (K/V and Mamba state) carried across: 8
    decode steps give the JAX package's tokens."""
    je, te = engines(name)
    logits, jkv, pos = je.runner.prefill(IDS, je.runner.init_kv())
    tkv = kv_from_numpy(jax.tree_util.tree_map(np.asarray, jkv), "cpu")
    assert len(tkv["mamba"]["ssm"]) == len(FIXTURES[name][1])
    want, got = [], []
    for kv, r, out in ((jkv, je.runner, want), (tkv, te.runner, got)):
        tok, p = int(np.argmax(np.asarray(logits))), pos
        for _ in range(8):
            out.append(tok)
            step, kv = r.decode_one(tok, p, kv)
            tok, p = int(np.argmax(np.asarray(step))), p + 1
    assert got == want


# -- embeddings: refused where the reference has no values ----------------------


def test_jax_embeddings_run_no_mixer_and_the_port_refuses(engines, paths,
                                                          capsys):
    """The JAX extract_hidden_states sends every non-DeltaNet layer through
    transformer_layer: on Mamba-1 it raises KeyError, on Falcon-H1 it
    returns the states of attention and FFN alone (the port's
    transformer_layer loop, within 1e-5), far from the forward's. The port
    refuses both in Engine.embed, /v1/embeddings (400) and the CLI's
    embed (exit 1)."""
    je, te = engines("mamba1")
    with pytest.raises(KeyError):
        j_hidden_states(je.runner, IDS)
    with pytest.raises(NotImplementedError, match="mamba"):
        te.embed("hello")
    je, te = engines("falconh1")
    want = np.asarray(j_hidden_states(je.runner, IDS))
    r, cfg = te.runner, te.runner.cfg
    toks = torch.tensor([IDS], dtype=torch.int32)
    pos = torch.arange(len(IDS), dtype=torch.int32)[None]
    lens = torch.tensor([len(IDS)], dtype=torch.int32)
    hidden = {}
    with torch.no_grad():
        for mixer in (False, True):
            kv, x = r._make_kv(1), T.embed(r.params, cfg, toks)
            for i, layer in enumerate(r.params["layers"]):
                fn = T.layer_forward if mixer else T.transformer_layer
                x, kv = fn(layer, cfg, x, pos, kv, i, lens)
            hidden[mixer] = apply_norm(x, r.params["final_norm"],
                                       cfg.norm_eps)[0].numpy()
    close(hidden[False], want)
    assert np.abs(hidden[True] - want).max() > 1e-3 * np.abs(want).max()
    with pytest.raises(NotImplementedError, match="hybrid_par"):
        te.embed("hello")
    reply = app._embeddings(None, app._Request(
        {}, json.dumps({"input": "hello"}).encode()), te, None)
    assert reply.status == 400
    assert "hybrid_par" in json.loads(reply.body)["error"]["message"]
    rc = cli.main(["embed", paths["lfm2", "f32"], "-p", "hi",
                   "--device", "cpu"])
    assert rc == 1 and "shortconv" in capsys.readouterr().err


def test_generate_and_bench_run_on_granite(engines):
    """Engine.generate and the CLI's bench on a Mamba-2 hybrid: greedy text
    equals the JAX engine's, greedy_decode gives greedy_tokens' tokens."""
    je, te = engines("granite", "q4k", "quant")
    prompt = "The quick brown fox"
    assert te.generate(prompt, max_tokens=8, sampler=GREEDY) == \
        je.generate(prompt, max_tokens=8, sampler=JSampler(
            temperature=0.0, repetition_penalty=1.0))
    r = te.runner
    want = te.greedy_tokens(IDS, 9)
    logits, kv, pos = r.prefill(IDS, r.init_kv())
    first = torch.argmax(logits)[None].to(torch.int32)
    got, _ = r.greedy_decode(first, [pos], kv, 8)
    assert [int(first)] + got[0].tolist() == want
    out = cli.bench(te, prompt_tokens=8, gen_tokens=4)
    assert out["gen_tokens"] == 4 and out["decode_tps"] > 0
