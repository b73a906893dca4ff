"""The port's parallel plans (parallel/sharding.py, engine/runner.MeshRunner,
parallel/service.py) against the JAX package on the CPU.

Every mesh here is real: ``Engine.load`` with mesh axes makes this process
rank 0 and spawns the other ranks as processes, which meet over gloo
through a file store and load their own shards. The configurations mirror
tests/test_sharding.py: dense TP (tp=2, tp=4), DP x TP (2 x 2), MoE expert
parallel (tp=4) and EP x DP on tiny-moe, the Qwen3Next (also with routed
and shared experts) and Falcon-H1 hybrids, the quantized path (the
kernels' plain versions), the Engine, a
LoRA adapter on a sharded base, the tiered ragged batch over data shards
and the continuous-batching engine. Each is held against the JAX
single-device runner or engine: logits within rtol = atol = 2e-5 (the JAX
mesh tests' limit), tokens equal. The deliberate differences of ROADMAP
queue 3 have their tests at the end.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import make_tiny_model
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JEngineConfig
from llama_gguf_tpu.engine.runner import ModelRunner as JRunner
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.models.loader import load_model as jload
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSamplerConfig

from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.runner import pick_read_bound
from llama_gguf_tpu_torch.models.loader import load_model as tload
from llama_gguf_tpu_torch.ops.linear import (QuantLinear, RowParallelLinear,
                                             apply, dequantize_weight,
                                             unfuse_linear)
from llama_gguf_tpu_torch.parallel import multihost
from llama_gguf_tpu_torch.parallel import sharding as S
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
B, T, MAX_SEQ = 2, 8, 64
IDS = [5, 17, 33, 2, 9, 40, 41, 7]


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    """(preset, quant name) -> a synthetic GGUF (the port's builder: the
    JAX builder's bytes for its presets), built once."""
    d = tmp_path_factory.mktemp("parallel")
    made = {}

    def get(preset: str, quant: str) -> str:
        if (preset, quant) not in made:
            path = str(d / f"{preset}-{quant}.gguf")
            build_synthetic_gguf(path, preset=preset, quant=GGMLType[quant])
            made[preset, quant] = path
        return made[preset, quant]

    return get


def _inputs(vocab: int):
    """A B x T prefill and one decode step (tests/test_sharding.py's
    _mesh_parity), from seed 0."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=(B, T)).astype(np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    lengths = np.full((B,), T, np.int32)
    tok2 = rng.integers(0, vocab, size=(B, 1)).astype(np.int32)
    return ((tokens, positions, lengths),
            (tok2, np.full((B, 1), T, np.int32), np.full((B,), T + 1,
                                                         np.int32)))


def _jax_steps(path: str, mode: str):
    params, cfg, _ = jload(path, mode=mode)
    runner = JRunner(params, cfg, max_batch=B, max_seq=MAX_SEQ)
    kv = runner.init_kv()
    out = []
    for args in _inputs(cfg.vocab_size):
        logits, kv = runner.step(*(jnp.asarray(a) for a in args), kv)
        out.append(np.asarray(logits))
    return out


def _port_steps(runner):
    kv = runner.init_kv(B)
    out = []
    for args in _inputs(runner.cfg.vocab_size):
        logits, kv = runner.step(*args, kv)
        out.append(logits.numpy())
    return out


def _mesh_engine(path, mode="dequant", data=1, model=2, **kw):
    return Engine.load(path, EngineConfig(
        weight_mode=mode, max_batch=B, max_context_len=MAX_SEQ,
        mesh_data=data, mesh_model=model, **kw), device="cpu")


CASES = [
    ("tiny", "F32", 1, 2),
    ("tiny", "F32", 1, 4),
    ("tiny", "F32", 2, 2),
    ("tiny-moe", "F32", 1, 4),
    ("tiny-moe", "F32", 2, 2),
    ("tiny-qwen3next", "F32", 2, 2),
    ("tiny-falconh1", "F32", 2, 2),
    ("tiny", "Q4_K", 1, 2),
    ("tiny-moe", "Q4_K", 2, 2),
    ("tiny-qwen3next-moe", "Q4_K", 1, 2),  # a shared expert, split
]


@pytest.mark.parametrize("preset,quant,data,model", CASES,
                         ids=[f"{p}-{q}-dp{d}-tp{m}" for p, q, d, m in CASES])
def test_mesh_steps_match_jax(gguf, preset, quant, data, model):
    """A prefill and a decode step over the mesh equal the JAX
    single-device runner's; the greedy tokens equal one device's; every
    rank reports its place and its collectives."""
    path = gguf(preset, quant)
    mode = "dequant" if quant == "F32" else "quant"
    want = _jax_steps(path, mode)
    eng = _mesh_engine(path, mode, data, model)
    try:
        got = _port_steps(eng.runner)
        tokens = eng.greedy_tokens(IDS, 6)
        stats = eng.runner.rank_stats()
        assert eng.runner.tier_shards == data
        assert not eng.runner.graphs_ok  # gloo: eager steps
    finally:
        eng.close()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    single = Engine.load(path, EngineConfig(weight_mode=mode,
                                            max_context_len=MAX_SEQ),
                         device="cpu")
    assert tokens == single.greedy_tokens(IDS, 6)
    assert [(s["rank"], s["data_index"], s["model_index"], s["backend"])
            for s in stats] == [(r, r // model, r % model, "gloo")
                                for r in range(data * model)]
    assert all(s["collectives"]["model"]["calls"] > 0 for s in stats)
    if data > 1:  # the B = 2 logits are gathered over the data axis
        assert all(s["collectives"]["data"]["calls"] > 0 for s in stats)


def test_engine_mesh_matches_jax(tmp_path):
    """Engine over a (2, 2) mesh: greedy tokens equal the JAX engine's
    (tests/test_sharding.py::test_engine_mesh_matches_single_device's
    model); the streaming path runs; sampled generation with a seed equals
    one device's."""
    path = str(tmp_path / "mesh.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                    tokenizer=True)
    jeng = JEngine.load(path, JEngineConfig(weight_mode="dequant"))
    ids = jeng.tokenizer.encode("tok1 tok2 tok3")
    want = jeng.greedy_tokens(ids, 8)
    single = Engine.load(path, EngineConfig(weight_mode="dequant"),
                         device="cpu")
    sampler = SamplerConfig(temperature=0.8, seed=5)
    eng = Engine.load(path, EngineConfig(weight_mode="dequant", mesh_data=2,
                                         mesh_model=2), device="cpu")
    try:
        assert eng.runner.mesh.shape == {"data": 2, "model": 2}
        assert eng.greedy_tokens(ids, 8) == want
        assert isinstance(eng.generate("tok4", max_tokens=4), str)
        assert eng.generate("tok4 tok5", max_tokens=6, sampler=sampler) == \
            single.generate("tok4 tok5", max_tokens=6, sampler=sampler)
    finally:
        eng.close()


def test_lora_on_sharded_base_matches_jax(tmp_path):
    """An adapter on every projection of a tp=2 model: each rank cuts A
    and B along its base's split, the low-rank term of a row-parallel
    product is summed with it once; logits of a prefill and 7 decode steps
    equal the JAX engine's with the same adapter."""
    from test_torch_lora import logits_of, shapes_of, write_lora

    path = str(tmp_path / "tiny.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=160, seed=11,
                    tokenizer=True)
    adapter = write_lora(str(tmp_path / "a.gguf"), alpha=32.0, seed=3,
                         layers=2, shapes=shapes_of(64, 128))
    jeng = JEngine.load(path, JEngineConfig(weight_mode="dequant",
                                            lora=adapter))
    want, want_toks = logits_of(jeng.runner)
    eng = Engine.load(path, EngineConfig(weight_mode="dequant", lora=adapter,
                                         mesh_model=2), device="cpu")
    try:
        layer = eng.runner.params["layers"][0]
        assert isinstance(layer["attn"]["wo"], RowParallelLinear)
        assert layer["attn"]["wq"].b.shape == (4, 32)  # half the columns
        assert layer["attn"]["wo"].base.a.shape == (32, 4)  # half the rows
        got, toks = logits_of(eng.runner)
    finally:
        eng.close()
    np.testing.assert_allclose(got, want, **TOL)
    assert toks == want_toks


def test_tiered_ragged_batch_over_data_shards_matches_jax(tmp_path):
    """tests/test_sharding.py's tiered ragged decode over a (2, 2) mesh:
    one long straggler in data shard 0; each rank selects the tier over
    its own rows (cap per shard) and the tokens equal the JAX
    single-device tiered decode's."""
    ctx = 1024
    path = str(tmp_path / "tier.gguf")
    make_tiny_model(path, arch="qwen2", vocab=97, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=ctx, seed=17)
    rng = np.random.default_rng(0)
    b, steps = 8, 8
    lens = [20, 30, 600, 40, 25, 35, 45, 50]
    prompts = [rng.integers(0, 97, size=n).tolist() for n in lens]
    end = [n + steps for n in lens]
    assert isinstance(pick_read_bound(end, ctx, shards=2), tuple)

    def decode(runner, to_tokens):
        kv = runner.init_kv(b)
        first = []
        for i, ids in enumerate(prompts):
            lg, kv, _ = runner.prefill(ids, kv, batch_idx=i)
            first.append(int(np.argmax(np.asarray(lg))))
        toks, _ = runner.greedy_decode(to_tokens(first), to_tokens(lens),
                                       kv, steps=steps)
        return np.asarray(toks)

    params, cfg, _ = jload(path, mode="dequant")
    want = decode(JRunner(params, cfg, max_batch=b, max_seq=ctx),
                  lambda a: jnp.asarray(a, jnp.int32))
    eng = Engine.load(path, EngineConfig(weight_mode="dequant", max_batch=b,
                                         mesh_data=2, mesh_model=2),
                      device="cpu")
    try:
        assert eng.runner.tier_shards == 2
        got = decode(eng.runner, lambda a: np.asarray(a, np.int32))
    finally:
        eng.close()
    np.testing.assert_array_equal(got, want)


def test_batched_engine_over_mesh_matches_one_device(gguf):
    """The continuous-batching engine over a (2, 2) mesh: four ragged
    greedy requests at once give the tokens of the same engine on one
    device."""
    path = gguf("tiny", "Q4_K")
    greedy = SamplerConfig(temperature=0.0)
    prompts = [[5, 9], [7] * 12, [3, 4, 5, 6, 7], [11] * 30]

    def run(engine):
        be = BatchedEngine(engine.runner, engine.tokenizer, max_queue=8)
        try:
            handles = [be.submit(p, max_tokens=6, sampler=greedy)
                       for p in prompts]
            for h in handles:
                h.text(timeout=300)
            return [h.token_ids for h in handles]
        finally:
            be.shutdown()

    want = run(Engine.load(path, EngineConfig(max_batch=4), device="cpu"))
    eng = Engine.load(path, EngineConfig(max_batch=4, mesh_data=2,
                                         mesh_model=2), device="cpu")
    try:
        assert run(eng) == want
    finally:
        eng.close()


def test_mesh_step_keeps_the_whole_grid(gguf):
    """A step wider than one launch of the runner's launch plan runs over
    its whole grid on a mesh, its rows split over the data axis: one
    launch, equal to the grid's forward on one device."""
    from llama_gguf_tpu_torch.engine.runner import launch_rows
    from llama_gguf_tpu_torch.models.transformer import forward

    path = gguf("tiny", "F32")
    b, t, max_seq = 2, 512, 1024
    assert launch_rows(t) < b
    rng = np.random.default_rng(2)
    toks = rng.integers(3, 500, size=(b, t)).astype(np.int32)
    pos = np.full((b, t), max_seq, np.int32)
    pos[0, :300], pos[1, 0] = np.arange(300), 5
    lens, lp = np.asarray([300, 6], np.int32), np.asarray([299, 0], np.int32)
    eng = Engine.load(path, EngineConfig(
        weight_mode="dequant", max_batch=b, max_context_len=max_seq,
        mesh_data=2, mesh_model=1), device="cpu")
    try:
        r = eng.runner
        got, _ = r.step(toks, pos, lens, r.init_kv(b), read_bound=512,
                        logit_positions=lp)
        assert r.last_launch == {"prefill_launches": 1,
                                 "rows_launched": b * t, "state_rows": 0}
    finally:
        eng.close()
    one = Engine.load(path, EngineConfig(
        weight_mode="dequant", max_batch=b, max_context_len=max_seq),
        device="cpu").runner
    with torch.no_grad():
        want, _ = forward(one.params, one.cfg, torch.from_numpy(toks),
                          torch.from_numpy(pos), one.init_kv(),
                          torch.from_numpy(lens), read_bound=512,
                          logit_positions=torch.from_numpy(lp),
                          precision=one.matmul_precision)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_server_over_mesh_matches_jax(tmp_path):
    """``serve --tp 2 --dp 2``: the server's ServerState over a (2, 2)
    mesh (its warm-up and scheduler on MeshRunner) answers a greedy chat
    completion as the JAX engine chats; shutdown stops the ranks. The
    prompt cache is refused over a mesh."""
    import threading

    from test_torch_server import _call, _free_port, _wait_healthy

    from llama_gguf_tpu_torch.server.app import (ServerConfig, ServerState,
                                                 run_server)

    path = str(tmp_path / "srv.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                    tokenizer=True, quant=GGMLType.Q8_0)
    with pytest.raises(NotImplementedError, match="prompt cache"):
        ServerState(ServerConfig(model_path=path, device="cpu", mesh_model=2,
                                 prompt_cache_bytes=1 << 20))
    state = ServerState(ServerConfig(
        model_path=path, port=_free_port(), max_batch=2, device="cpu",
        mesh_data=2, mesh_model=2))
    followers = state.engine.runner.followers
    thread = threading.Thread(target=run_server, args=(state.config, state),
                              daemon=True)
    thread.start()
    base = f"http://{state.config.host}:{state.config.port}"
    messages = [{"role": "user", "content": "tok3 tok4 tok5"}]
    try:
        _wait_healthy(base)
        status, body = _call(base, "POST", "/v1/chat/completions", {
            "messages": messages, "max_tokens": 8, "temperature": 0.0})
    finally:
        state.shutdown()
        thread.join(timeout=30)
    assert status == 200
    assert followers.closed and all(p.poll() is not None
                                    for p in followers.procs)
    jeng = JEngine.load(path, JEngineConfig(weight_mode="dequant"))
    want = jeng.chat(messages, max_tokens=8,
                     sampler=JSamplerConfig(temperature=0.0))
    assert body["choices"][0]["message"]["content"] == want


# -- the deliberate differences (ROADMAP queue 3) -----------------------------

def _fake_mesh(model: int, index: int) -> S.Mesh:
    """A mesh as rank ``index`` of ``model`` sees it, for the plan alone
    (no process group: nothing here runs a collective)."""
    return S.Mesh(1, model, index, torch.device("cpu"), "gloo",
                  S.Axis("model", None, model, index, "gloo"),
                  S.Axis("data", None, 1, 0, "gloo"), None)


def test_rank_refuses_qkv_and_gate_up(gguf):
    """The JAX plan unfuses q|k|v and gate|up; the port cuts q, k and v by
    heads and gate and up by columns, then re-fuses each rank's pieces, so
    each rank keeps the fused products (kernels 1 and 3): their values are
    the whole model's columns of that rank."""
    params, cfg, _ = tload(gguf("tiny", "Q4_K"), device="cpu")
    layer = params["layers"][0]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, cfg.hidden_size)).astype(np.float32))
    q, k, v = (apply(w, x) for w in unfuse_linear(
        layer["attn"]["wqkv"], list(layer["attn"]["wqkv"].splits)))
    gate, up = (apply(w, x) for w in unfuse_linear(
        layer["ffn"]["gate_up"], list(layer["ffn"]["gate_up"].splits)))
    hd, tp = cfg.head_dim, 2
    for m in range(tp):
        local = S.shard_params(params, cfg, _fake_mesh(tp, m))["layers"][0]
        qkv = local["attn"]["wqkv"]
        nq, nk = cfg.num_heads // tp * hd, cfg.num_kv_heads // tp * hd
        assert qkv.splits == (nq, nk, nk)
        y = apply(qkv, x)
        for part, full in zip((y[:, :nq], y[:, nq:nq + nk], y[:, nq + nk:]),
                              (q, k, v)):
            w = part.shape[1]
            np.testing.assert_allclose(part, full[:, m * w:(m + 1) * w],
                                       rtol=1e-6, atol=1e-6)
        gu = local["ffn"]["gate_up"]
        f = gate.shape[1] // tp
        assert gu.splits == (f, f)
        y = apply(gu, x)
        np.testing.assert_allclose(y[:, :f], gate[:, m * f:(m + 1) * f],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(y[:, f:], up[:, m * f:(m + 1) * f],
                                   rtol=1e-6, atol=1e-6)
        assert local["attn"]["heads"] == (cfg.num_heads // tp,
                                          cfg.num_kv_heads // tp,
                                          m * cfg.num_heads // tp,
                                          cfg.num_heads)


def test_row_split_off_a_group_boundary_is_replicated():
    """A row-parallel split is cut at scale-group boundaries only, where
    the JAX plan splits any K the mesh divides: q4 with groups of 32
    splits K = 128 over 2 or 4 ranks (whole groups; each shard's
    dequantized rows are the whole weight's), not over 8 (16 rows, half a
    group), nor K = 96 over 2 (48 rows); such a block runs replicated."""
    rng = np.random.default_rng(2)
    k, n, g = 128, 48, 32
    lin = QuantLinear(
        torch.from_numpy(rng.integers(0, 256, (k // 2, n), np.uint8)),
        torch.from_numpy(rng.random((k // g, n)).astype(np.float32)),
        torch.from_numpy(rng.random((k // g, n)).astype(np.float32)),
        None, "q4", g, k, n)
    assert S.row_split_ok(lin, 2) and S.row_split_ok(lin, 4)
    assert not S.row_split_ok(lin, 8)  # 16 rows: half a group
    assert not S.row_split_ok(dataclass_k(lin, 96), 2)  # 48 rows
    full = dequantize_weight(lin)
    for tp in (2, 4):
        rows = k // tp
        for m in range(tp):
            part, bias = S._rows(lin, m * rows, (m + 1) * rows)
            assert part.k == rows and bias is None
            np.testing.assert_array_equal(dequantize_weight(part),
                                          full[m * rows:(m + 1) * rows])


def dataclass_k(lin, k):
    """``lin`` claiming ``k`` input rows (only its shape is read)."""
    import dataclasses

    return dataclasses.replace(lin, k=k)


def test_attention_with_indivisible_kv_heads_runs_replicated(gguf):
    """tiny at tp=4: its 2 KV heads do not divide by 4, so attention runs
    replicated (no local heads, the cache keeps every KV head), while the
    FFN's down splits into 64-row shards; test_mesh_steps_match_jax holds
    the values of this mesh against JAX's."""
    params, cfg, _ = tload(gguf("tiny", "Q4_K"), device="cpu")
    local = S.shard_params(params, cfg, _fake_mesh(4, 1))["layers"][0]
    assert "heads" not in local["attn"]  # replicated attention
    assert local["attn"]["wqkv"] is params["layers"][0]["attn"]["wqkv"]
    assert isinstance(local["ffn"]["down"], RowParallelLinear)
    assert S.local_kv_heads(S.shard_params(params, cfg, _fake_mesh(4, 1)),
                            cfg) == cfg.num_kv_heads


def test_backend_by_placement(monkeypatch):
    """The backend follows placement and is never switched on failure:
    the CPU takes gloo; ranks with a card each take NCCL; ranks sharing a
    card take gloo (NCCL refuses two ranks on one GPU); CUDA asked for and
    absent raises."""
    assert multihost.placement(3, 4, "cpu") == (torch.device("cpu"), "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.placement(0, 2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert multihost.placement(1, 2, "cuda") == (torch.device("cuda", 1),
                                                 "nccl")
    assert multihost.placement(3, 4, "cuda") == (torch.device("cuda", 1),
                                                 "gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.placement(1, 2, None) == (torch.device("cuda", 0),
                                               "gloo")


def test_refusals_over_a_mesh(gguf, tmp_path):
    """What the JAX plan fails at, the port refuses with a
    NotImplementedError that says so: multi-head latent attention (the
    JAX shard_params has no wk/wv to split and raises KeyError). And what
    the port's one process per rank cannot mirror: the prompt cache, the
    speculative decoders, a LoRA attached after load."""
    from llama_gguf_tpu.parallel.sharding import make_mesh as jmesh
    from llama_gguf_tpu.parallel.sharding import shard_params as jshard

    from llama_gguf_tpu_torch.engine.speculative import SpeculativeDecoder
    from llama_gguf_tpu_torch.models import lora as tlora
    from llama_gguf_tpu_torch.utils.synthetic import \
        build_synthetic_gguf as tbuild

    mla = str(tmp_path / "mla.gguf")
    tbuild(mla, preset="tiny-deepseek-v3", quant=GGMLType.F32)
    jparams, _, _ = jload(mla, mode="dequant")
    with pytest.raises(KeyError):
        jshard(jparams, jmesh(n_model=2, n_data=1))
    with pytest.raises(NotImplementedError, match="latent attention"):
        _mesh_engine(mla)
    path = gguf("tiny", "F32")
    with pytest.raises(NotImplementedError, match="prompt cache"):
        _mesh_engine(path, prompt_cache=True)
    eng = _mesh_engine(path)
    try:
        with pytest.raises(NotImplementedError, match="over a mesh"):
            SpeculativeDecoder.self_speculative(eng.runner, exit_layer=1)
        with pytest.raises(NotImplementedError, match="mesh"):
            tlora.remove_lora(eng.runner.params, runner=eng.runner)
        with pytest.raises(NotImplementedError, match="prompt cache"):
            eng.runner.restore_prefix(None, [1], eng.runner.init_kv(1))
        # the mesh still serves after the refusals
        assert len(eng.greedy_tokens(IDS, 3)) == 3
    finally:
        eng.close()
