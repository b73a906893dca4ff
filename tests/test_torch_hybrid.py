"""The port's Qwen3Next hybrid slice (models/deltanet.py, shared experts,
recurrent state in the runner and the batched engine) against the JAX
package on the CPU.

Models: the JAX builder's tiny-qwen3next (F32, and Q4_K, whose hidden 128
falls back to Q5_1, so quant mode runs the q8 kernel's plain version) and
the port's tiny-qwen3next-moe (Q4_K gate/up experts and shared gate/up,
Q6_K down, Q6_K table and head: kernels 1-6's plain versions), which the
JAX package loads too; quant mode of the JAX package runs its Pallas
kernels in interpret mode. Tolerances: the delta rule and the DeltaNet
layer within 1e-5 of max |value| (f32, the same operations in the same
order, matmuls reassociated); logits within 1e-3 of max |logit| (f32
through four layers); greedy tokens equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_bert_mamba import build_mamba_gguf

from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.gguf.reader import GGUFFile as JGGUFFile
from llama_gguf_tpu.models import deltanet as JD
from llama_gguf_tpu.models import transformer as JT
from llama_gguf_tpu.models.loader import ModelLoader as JLoader
from llama_gguf_tpu.utils.synthetic import build_synthetic_gguf as jbuild

from llama_gguf_tpu_torch.convert import kv_from_numpy, params_from_numpy
from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.gguf.reader import GGUFFile
from llama_gguf_tpu_torch.gguf.writer import GGUFWriter
from llama_gguf_tpu_torch.models import deltanet as D
from llama_gguf_tpu_torch.models import kv as KV
from llama_gguf_tpu_torch.models import transformer as T
from llama_gguf_tpu_torch.models.loader import ModelLoader
from llama_gguf_tpu_torch.ops.linear import DenseLinear, QuantLinear
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.server.app import ServerConfig, ServerState
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

torch.set_num_threads(1)

REL = 1e-5  # delta rule / DeltaNet layer: of max |value|
LOGIT_REL = 1e-3  # logits: of max |logit|
IDS = [44, 12, 310, 2, 77, 66, 5, 9, 100, 31, 400, 17]
MODELS = {  # name: (preset, quant)
    "qwen3next-f32": ("tiny-qwen3next", GGMLType.F32),
    "qwen3next-q4k": ("tiny-qwen3next", GGMLType.Q4_K),
    "qwen3next-moe": ("tiny-qwen3next-moe", GGMLType.Q4_K),
}
GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max diff {err:.3g} > {rel} * {scale:.3g}"


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("hybrid")
    return {name: build_synthetic_gguf(str(d / f"{name}.gguf"), preset=p,
                                       quant=q)
            for name, (p, q) in MODELS.items()}


@pytest.fixture(scope="module")
def engines(paths):
    """(name, mode) -> (JAX Engine, port Engine on the CPU)."""
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
    logits, _, _ = eng.runner.prefill(ids, eng.runner.init_kv())
    return logits.numpy() if torch.is_tensor(logits) else np.asarray(logits)


# -- the delta rule and the layer ---------------------------------------------


def _scan_inputs(rng, b, t, hk, hv, dk, dv):
    q = rng.standard_normal((b, t, hk, dk)).astype(np.float32)
    k = rng.standard_normal((b, t, hk, dk)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.standard_normal((b, t, hv, dv)).astype(np.float32)
    beta = rng.uniform(0, 1, (b, t, hv)).astype(np.float32)
    gate = -rng.uniform(0, 2, (b, t, hv)).astype(np.float32)
    return q, k, v, beta, gate


@pytest.mark.parametrize("t", [1, 3, 8])
def test_delta_rule_scan_matches_jax(t):
    """Hv = 2 Hk, two calls in a row carrying the state: outputs and state
    within REL of JAX's lax.scan."""
    rng = np.random.default_rng(t)
    b, hk, hv, dk, dv = 2, 2, 4, 8, 6
    js = ts = rng.standard_normal((b, hv, dk, dv)).astype(np.float32)
    ts = torch.from_numpy(ts)
    for _ in range(2):
        ins = _scan_inputs(rng, b, t, hk, hv, dk, dv)
        jout, js = JD.delta_rule_scan(*(jnp.asarray(a) for a in ins),
                                      jnp.asarray(js))
        tout, ts_new = D.delta_rule_scan(
            *(torch.from_numpy(a) for a in ins), ts)
        assert ts_new is not ts  # the state passed in is not written
        ts = ts_new
        close(tout.numpy(), jout)
        close(ts.numpy(), js)


def _layer_state(rng, cfg, b):
    hv, dk, dv, ksz, ch = D.state_dims(cfg)
    return (rng.standard_normal((b, hv, dk, dv)).astype(np.float32) * 0.1,
            rng.standard_normal((b, ksz - 1, ch)).astype(np.float32) * 0.1)


def _both_layers(engines, name, rng, positions, lengths):
    """Layer 0 (DeltaNet) of both packages on the same x, positions,
    lengths and random state. Returns ((jax x, S, conv), (port x, S, conv),
    the state in)."""
    je, te = engines(name, "dequant")
    cfg, jcfg = te.runner.cfg, je.runner.cfg
    b, t = positions.shape
    x = rng.standard_normal((b, t, cfg.hidden_size)).astype(np.float32)
    s0, c0 = _layer_state(rng, cfg, b)
    jkv = {"deltanet": (
        {"S": jnp.asarray(s0), "conv": jnp.asarray(c0)},)}
    jx, jkv = JD.deltanet_layer(
        je.runner.params["layers"][0], jcfg, jnp.asarray(x),
        jnp.asarray(positions), jkv, 0, jnp.asarray(lengths))
    tkv = {"deltanet": [{"S": torch.from_numpy(s0.copy()),
                         "conv": torch.from_numpy(c0.copy())}]}
    st = tkv["deltanet"][0]
    s_ptr = st["S"].data_ptr()
    with torch.no_grad():
        tx, tkv = D.deltanet_layer(
            te.runner.params["layers"][0], cfg, torch.from_numpy(x),
            torch.from_numpy(positions), tkv, 0, torch.from_numpy(lengths))
    assert tkv["deltanet"][0]["S"].data_ptr() == s_ptr  # in place
    j = jkv["deltanet"][0]
    return ((np.asarray(jx), np.asarray(j["S"]), np.asarray(j["conv"])),
            (tx.numpy(), st["S"].numpy(), st["conv"].numpy()), (s0, c0))


@pytest.mark.parametrize("name", ["qwen3next-f32", "qwen3next-moe"])
def test_deltanet_layer_matches_jax(engines, name):
    """The whole block (conv ring, delta rule, gated output, FFN half) on a
    random carried state, one row ragged: x, S and conv within REL."""
    rng = np.random.default_rng(3)
    t = 6
    positions = np.stack([np.arange(t), 9 + np.arange(t)]).astype(np.int32)
    lengths = np.array([t, 9 + 4], np.int32)  # row 1: 2 padding tokens
    (jx, js, jc), (tx, ts, tc), _ = _both_layers(engines, name, rng,
                                                 positions, lengths)
    close(tx, jx)
    close(ts, js)
    close(tc, jc)


def test_padding_leaves_state_bit_unchanged(engines):
    """An all-padding row (positions >= lengths) leaves S and conv bit for
    bit as they were, in both packages; a row whose last tokens are padding
    ends where the same row without them ends."""
    rng = np.random.default_rng(5)
    positions = np.stack([np.arange(4), 100 + np.arange(4)]).astype(np.int32)
    lengths = np.array([4, 0], np.int32)
    (_, js, jc), (_, ts, tc), (s0, c0) = _both_layers(
        engines, "qwen3next-f32", rng, positions, lengths)
    for s, c in ((js, jc), (ts, tc)):
        assert np.array_equal(s[1], s0[1]) and np.array_equal(c[1], c0[1])
        assert not np.array_equal(s[0], s0[0])
    _, te = engines("qwen3next-f32", "dequant")
    layer, cfg = te.runner.params["layers"][0], te.runner.cfg
    x = torch.from_numpy(rng.standard_normal((1, 5, cfg.hidden_size))
                         .astype(np.float32))
    ends = []
    for t, length in ((5, 3), (3, 3)):
        s, c = _layer_state(np.random.default_rng(9), cfg, 1)
        kv = {"deltanet": [{"S": torch.from_numpy(s),
                            "conv": torch.from_numpy(c)}]}
        pos = torch.arange(t, dtype=torch.int32)[None]
        with torch.no_grad():
            D.deltanet_layer(layer, cfg, x[:, :t], pos, kv, 0,
                             torch.tensor([length], dtype=torch.int32))
        ends.append(kv["deltanet"][0])
    for key in ("S", "conv"):
        assert torch.equal(ends[0][key], ends[1][key])


# -- the model ----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dequant", "quant"])
@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_logits_and_greedy_tokens_match_jax(engines, name, mode):
    je, te = engines(name, mode)
    assert te.runner.cfg.layer_kinds == ("deltanet",) * 3 + ("attn",)
    want, got = _logits(je, IDS), _logits(te, IDS)
    close(got, want, LOGIT_REL)
    assert te.greedy_tokens(IDS, 12) == je.greedy_tokens(IDS, 12)


def test_moe_preset_layout(engines):
    """The shared expert's gate|up loads fused (the GLU kernel runs it)
    with its sigmoid gate dense; routed experts top-2 of 8, renormalised."""
    _, te = engines("qwen3next-moe", "quant")
    cfg = te.runner.cfg
    assert (cfg.num_experts, cfg.num_experts_per_token,
            cfg.expert_weights_norm) == (8, 2, True)
    ffn = te.runner.params["layers"][0]["ffn"]
    sh = ffn["shared"]
    assert isinstance(sh["gate_up"], QuantLinear) and sh["gate_up"].fmt == "q4"
    assert sh["gate_up"].splits == (256, 256)
    assert isinstance(sh["down"], QuantLinear) and sh["down"].fmt == "q8"
    assert isinstance(ffn["shared_gate"], DenseLinear)
    assert ffn["shared_gate"].weight.shape == (cfg.hidden_size, 1)
    assert te.runner.params["output"].source_type == "Q6_K"


@pytest.mark.parametrize("mode", ["dequant", "quant"])
def test_moe_layer_with_shared_expert_matches_jax(engines, mode):
    """moe_layer on layer 0's FFN: routed sum plus the gated shared expert
    (the port's fused GLU, the JAX package's two products)."""
    je, te = engines("qwen3next-moe", mode)
    x = np.random.default_rng(2).standard_normal(
        (2, 5, te.runner.cfg.hidden_size)).astype(np.float32)
    want = JT.moe_layer(je.runner.params["layers"][0]["ffn"], je.runner.cfg,
                        jnp.asarray(x))
    with torch.no_grad():
        got = T.moe_layer(te.runner.params["layers"][0]["ffn"],
                          te.runner.cfg, torch.from_numpy(x))
    close(got.numpy(), want, LOGIT_REL)


@pytest.mark.parametrize("name", ["qwen3next-f32", "qwen3next-moe"])
def test_chunked_prefill_equals_whole(engines, name):
    """Prefill in two chunks (start_pos) gives the whole prefill's logits,
    in both packages: the state carries from chunk to chunk."""
    for eng in engines(name, "dequant"):
        r = eng.runner
        whole = np.asarray(r.prefill(IDS, r.init_kv())[0])
        logits, kv, pos = r.prefill(IDS[:5], r.init_kv())
        part = np.asarray(r.prefill(IDS[5:], kv, start_pos=pos)[0])
        close(part, whole, LOGIT_REL)


def _split_ba(src: str, dst: str) -> None:
    """``src`` rewritten with each ssm_ba as separate ssm_beta and
    ssm_alpha (rows [b(r) | a(r)] per k-head taken apart), the Qwen3.5
    form."""
    g = GGUFFile.open(src)
    hk = g.metadata["qwen3next.ssm.group_count"]
    w = GGUFWriter()
    for key, value in g.metadata.items():
        if key != "general.alignment":
            w.add_metadata(key, value)
    for name, info in g.tensors.items():
        if name.endswith(".ssm_ba.weight"):
            ba = np.frombuffer(g.tensor_bytes(name), np.float32).reshape(
                info.np_shape)
            rep = ba.shape[0] // (2 * hk)
            grouped = ba.reshape(hk, 2 * rep, -1)
            stem = name[:-len(".ssm_ba.weight")]
            w.add_tensor_np(f"{stem}.ssm_beta.weight",
                            np.ascontiguousarray(
                                grouped[:, :rep].reshape(hk * rep, -1)))
            w.add_tensor_np(f"{stem}.ssm_alpha.weight",
                            np.ascontiguousarray(
                                grouped[:, rep:].reshape(hk * rep, -1)))
        else:
            w.add_tensor_raw(name, tuple(reversed(info.np_shape)),
                             info.ggml_type, g.tensor_bytes(name))
    w.write_to_path(dst)


def test_separate_beta_alpha_form(paths, engines, tmp_path):
    """A hand-written GGUF with ssm_beta/ssm_alpha: both packages load it,
    agree, and give the combined form's logits."""
    path = str(tmp_path / "beta_alpha.gguf")
    _split_ba(paths["qwen3next-f32"], path)
    je = JEngine.load(path, JConfig(weight_mode="dequant"))
    te = Engine.load(path, EngineConfig(weight_mode="dequant"), device="cpu")
    dn = te.runner.params["layers"][0]["deltanet"]
    assert "ba_proj" not in dn and {"beta_proj", "alpha_proj"} <= set(dn)
    got = _logits(te, IDS)
    close(got, _logits(je, IDS), LOGIT_REL)
    close(got, _logits(engines("qwen3next-f32", "dequant")[1], IDS),
          LOGIT_REL)
    assert te.greedy_tokens(IDS, 8) == je.greedy_tokens(IDS, 8)


def test_params_from_numpy_same_logits(engines):
    je, te = engines("qwen3next-moe", "quant")
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


@pytest.mark.parametrize("name", ["qwen3next-f32", "qwen3next-moe"])
def test_kv_from_numpy_carries_jax_state(engines, name):
    """A JAX cache after a prefill (K/V and DeltaNet state) carried across:
    8 decode steps give the JAX package's tokens."""
    je, te = engines(name, "dequant")
    jkv = je.runner.init_kv()
    logits, jkv, pos = je.runner.prefill(IDS, jkv)
    tkv = kv_from_numpy(jax.tree_util.tree_map(np.asarray, jkv), "cpu")
    assert len(tkv["deltanet"]) == 4
    assert tkv["deltanet"][0]["S"].shape == (1, 4, 32, 32)
    want, got = [], []
    for kv, r, out in ((jkv, je.runner, want), (tkv, te.runner, got)):
        tok, p = int(np.argmax(np.asarray(logits))), pos
        for _ in range(8):
            out.append(tok)
            step, kv = r.decode_one(tok, p, kv)
            tok, p = int(np.argmax(np.asarray(step))), p + 1
    assert got == want


def _j_layer_kinds(path):
    return tuple(JLoader(JGGUFFile.open(path), mode="dequant").layer_kind(i)
                 for i in range(2))


def test_layer_kind_matches_jax_and_unported_kinds_raise(paths, tmp_path):
    """Layer kinds by tensor presence equal the JAX loader's, and every
    recurrent kind now loads (DeltaNet, Falcon-H1's parallel hybrid,
    Mamba-1; Mamba-2 by tensor presence); an MLA layer is an attention
    kind and loads."""
    falcon = jbuild(str(tmp_path / "falconh1.gguf"), preset="tiny-falconh1",
                    quant=GGMLType.F32)
    mamba = str(tmp_path / "mamba.gguf")
    build_mamba_gguf(mamba)
    for path, want, key in (
            (paths["qwen3next-f32"], ("deltanet", "deltanet"), "deltanet"),
            (falcon, ("hybrid_par", "hybrid_par"), "mamba"),
            (mamba, ("mamba", "mamba"), "ssm_x")):
        loader = ModelLoader(GGUFFile.open(path), mode="dequant",
                             device="cpu")
        got = tuple(loader.layer_kind(i) for i in range(2))
        assert got == _j_layer_kinds(path) == want
        assert key in loader.load_layer(0, loader.config)
    # Mamba-2 and LFM2's short conv, by tensor presence
    kinds = []
    g_port = GGUFFile.open(mamba)
    for g in (g_port, JGGUFFile.open(mamba)):
        del g.tensors["blk.0.ssm_x.weight"]
        del g.tensors["blk.1.ssm_in.weight"]
        g.tensors["blk.1.shortconv.in_proj.weight"] = g.tensors.pop(
            "blk.1.ssm_a")
        loader = (JLoader(g, mode="dequant") if isinstance(g, JGGUFFile)
                  else ModelLoader(g, mode="dequant", device="cpu"))
        kinds.append([loader.layer_kind(i) for i in range(2)])
    assert kinds[0] == kinds[1] == ["mamba2", "shortconv"]
    port = ModelLoader(g_port, mode="dequant", device="cpu")
    layer = port.load_layer(0, port.config)
    assert "ssm_in" in layer and "ssm_x" not in layer
    # an MLA attention layer (DeepSeek's attn_kv_a_mqa) is an attention
    # kind, and loads now (tests/test_torch_mla.py)
    dsv3 = build_synthetic_gguf(str(tmp_path / "dsv3.gguf"),
                                preset="tiny-deepseek-v3", quant=GGMLType.F32)
    port = ModelLoader(GGUFFile.open(dsv3), mode="dequant", device="cpu")
    assert port.layer_kind(0) == JLoader(
        JGGUFFile.open(dsv3), mode="dequant").layer_kind(0) == "attn"
    assert "kv_a" in port.load_layer(0, port.config)["attn"]


# -- recurrent state in the runner, the batched engine and the server ---------


def test_init_kv_zeroes_state_in_place(engines):
    """init_kv hands back the same tensors, K/V and recurrent state zeroed
    in place (a graph captured on them stays bound)."""
    _, te = engines("qwen3next-f32", "dequant")
    r = te.runner
    kv = r.init_kv(2, owner="t")
    r.prefill(IDS, kv, batch_idx=1)
    st = kv["deltanet"][0]
    assert st["S"][1].abs().sum() > 0 and st["conv"][1].abs().sum() > 0
    assert st["S"].shape == (2, 4, 32, 32) and st["conv"].shape == (2, 3, 256)
    tensors = [st["S"], st["conv"], kv["k"][3]]
    again = r.init_kv(2, owner="t")
    assert again is kv
    assert [again["deltanet"][0]["S"], again["deltanet"][0]["conv"],
            again["k"][3]] == tensors
    for s in again["deltanet"]:
        assert not s["S"].any() and not s["conv"].any()
    assert not any(t.any() for t in again["k"] + again["v"])
    r.release_kv("t")


def test_capture_warm_ups_leave_state_unchanged(engines):
    """The eager warm-ups a capture runs (a step on dummy inputs in the drop
    slot with lengths 0; a greedy step with warm=True) leave every row's
    recurrent state as it was."""
    _, te = engines("qwen3next-moe", "quant")
    r = te.runner
    kv = r._make_kv(2)
    r.prefill(IDS, kv, batch_idx=0)
    before = [{k: t.clone() for k, t in s.items()} for s in kv["deltanet"]]
    drop = torch.full((2, 1), r.max_seq, dtype=torch.int32)
    zeros = torch.zeros(2, dtype=torch.int32)
    with torch.no_grad():
        r._forward(kv, 256, torch.zeros((2, 1), dtype=torch.int32), drop,
                   zeros)
        r._decode_body(zeros.clone(), drop[:, 0].clone(), kv, 256, warm=True)
    for b, s in zip(before, kv["deltanet"]):
        assert torch.equal(b["S"], s["S"]) and torch.equal(b["conv"],
                                                           s["conv"])


def test_reused_row_starts_from_no_state(engines):
    """The JAX fault the port does not copy: the JAX runner prefilling a
    prompt on a row that held another sequence starts from that sequence's
    state (its logits move by more than 1e-3 of max |logit|), while the
    port's clear_state gives the fresh row's logits."""
    je, te = engines("qwen3next-f32", "dequant")
    ids, other = IDS[:6], [7, 8, 9, 10, 11, 12, 13, 14]
    fresh = _logits(je, ids)
    _, jkv, _ = je.runner.prefill(other, je.runner.init_kv())
    stale = np.asarray(je.runner.prefill(ids, jkv)[0])
    assert np.abs(stale - fresh).max() > 1e-3 * np.abs(fresh).max()
    r = te.runner
    kv = r._make_kv(1)
    r.prefill(other, kv)
    r.clear_state(kv, 0)
    close(r.prefill(ids, kv)[0].numpy(), fresh, LOGIT_REL)


@pytest.mark.parametrize("name", ["qwen3next-f32", "qwen3next-moe"])
def test_batched_engine_reused_rows_match_jax_single_stream(paths, engines,
                                                            name):
    """B = 2, 5 requests (so rows are reused), chunk 8 (two prompts longer
    than a chunk): each request's greedy tokens equal the JAX single-stream
    Engine's."""
    je, _ = engines(name, "dequant")
    teng = Engine.load(paths[name], EngineConfig(weight_mode="quant",
                                                 max_batch=2), device="cpu")
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


def test_server_warmup_leaves_state_at_zero(paths):
    state = ServerState(ServerConfig(model_path=paths["qwen3next-moe"],
                                     device="cpu", max_batch=2))
    try:
        _, batched = state.current()
        for s in batched._kv["deltanet"]:
            assert not s["S"].any() and not s["conv"].any()
        h = batched.submit(IDS, max_tokens=3, sampler=GREEDY)
        h.text(timeout=60)
        assert h.finish_reason in ("stop", "length") and h.token_ids
    finally:
        state.shutdown()


def test_builder_matches_jax(tmp_path):
    for q in (GGMLType.F32, GGMLType.Q4_K):
        a = jbuild(str(tmp_path / f"j{q.name}.gguf"), preset="tiny-qwen3next",
                   quant=q)
        b = build_synthetic_gguf(str(tmp_path / f"t{q.name}.gguf"),
                                 preset="tiny-qwen3next", quant=q)
        assert open(a, "rb").read() == open(b, "rb").read()


def test_kv_helpers():
    """zero_ and clear_state on a cache with and without DeltaNet state."""
    kv = KV.init_cache(2, 3, 8, 1, 4, device="cpu")
    kv["k"][0].fill_(1.0)
    KV.clear_state(kv, 0)  # no state: nothing to clear
    assert kv["k"][0].all()
    kv["deltanet"] = [{"S": torch.ones(3, 2, 2, 2),
                       "conv": torch.ones(3, 1, 4)}]
    KV.clear_state(kv, 1)
    st = kv["deltanet"][0]
    assert not st["S"][1].any() and st["S"][[0, 2]].all()
    assert not st["conv"][1].any() and st["conv"][[0, 2]].all()
    KV.zero_(kv)
    assert not kv["k"][0].any() and not st["S"].any()


def test_greedy_decode_and_bench_run_on_hybrid(engines):
    """greedy_decode (the bench's loop) gives greedy_tokens' tokens, and
    the CLI's bench runs on a hybrid model."""
    from llama_gguf_tpu_torch.cli import bench

    _, te = engines("qwen3next-moe", "quant")
    r = te.runner
    want = te.greedy_tokens(IDS, 9)
    logits, kv, pos = r.prefill(IDS, r.init_kv())
    first = torch.argmax(logits)[None].to(torch.int32)
    got, _ = r.greedy_decode(first, [pos], kv, 8)
    assert [int(first)] + got[0].tolist() == want
    out = bench(te, prompt_tokens=8, gen_tokens=4)
    assert out["gen_tokens"] == 4 and out["decode_tps"] > 0
