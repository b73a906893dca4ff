"""The port's runner against the JAX package's, on the CPU: the two-tier
ragged read bound (pick_read_bound, the tuple read bound of forward,
tiered attention and kv.read's row gather), ragged greedy_decode, the
runner-owned KV cache and the CLI's bench."""

import copy
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from llama_gguf_tpu.cli import main as jmain
from llama_gguf_tpu.engine import runner as jrunner
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.models import kv as JKV
from llama_gguf_tpu.models.loader import load_model as jload
from llama_gguf_tpu.utils.synthetic import build_synthetic_gguf

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.engine import runner as trunner
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.models import kv as TKV
from llama_gguf_tpu_torch.models.loader import load_model as tload
from llama_gguf_tpu_torch.models.transformer import forward
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import (
    build_synthetic_gguf as tbuild)

torch.set_num_threads(1)

MAX_SEQ = 1024
# f32 through two layers with a reassociated product (tests/test_torch_model)
LOGIT_ATOL = 1e-3
RAGGED = [10, 20, 300, 40]  # prompt lengths of the four rows


# -- pick_read_bound ---------------------------------------------------------

@pytest.mark.parametrize("lengths,max_seq,prev", [
    ([10, 20, 300, 40], 1024, None),      # (256, 512, 1)
    ([10, 20, 300, 700], 1024, None),     # two long rows
    ([5] * 31 + [2000], 2048, None),      # one straggler among 32
    ([300, 300, 300, 300], 2048, None),   # uniform: one bucket
    ([0, 0, 0, 1500], 2048, None),        # empty slots
    ([1], 2048, None),
    ([5000, 10], 4096, None),             # past the cache end
    ([10, 20, 300, 40], 1024, 512),       # previous single bound kept
    ([10, 20, 300, 40], 1024, 2048),      # previous bound too large
    ([10, 20, 260, 40], 1024, (256, 1024, 2)),  # previous tier kept
    ([10, 20, 300, 900], 1024, (256, 512, 1)),  # previous tier now wrong
])
def test_pick_read_bound_cases(lengths, max_seq, prev):
    for shards in (1, 2, 4):
        assert trunner.pick_read_bound(lengths, max_seq, shards, prev) == \
            jrunner.pick_read_bound(lengths, max_seq, shards, prev)


def test_pick_read_bound_tiers_the_ragged_batch():
    assert trunner.pick_read_bound([11, 21, 301, 41], 1024) == (256, 512, 1)
    assert (trunner.TIER_CAP_MAX, trunner.TIER_GAIN,
            trunner.TIER_HYSTERESIS) == (jrunner.TIER_CAP_MAX,
                                         jrunner.TIER_GAIN,
                                         jrunner.TIER_HYSTERESIS)


_prev = st.one_of(
    st.none(), st.sampled_from([256, 512, 1024, 2048, 4096]),
    st.tuples(st.sampled_from([256, 512, 1024]),
              st.sampled_from([512, 1024, 2048, 4096]),
              st.sampled_from([1, 2, 4, 8])))


@settings(max_examples=300, deadline=None)
@given(lengths=st.lists(st.integers(0, 4096), min_size=1, max_size=32),
       max_seq=st.sampled_from([2048, 4096]), prev=_prev,
       shards=st.sampled_from([1, 2]))
def test_pick_read_bound_property(lengths, max_seq, prev, shards):
    got = trunner.pick_read_bound(lengths, max_seq, shards, prev)
    assert got == jrunner.pick_read_bound(lengths, max_seq, shards, prev)
    if isinstance(got, tuple):  # a tier covers every row
        lo, hi, cap = got
        assert min(max(lengths), max_seq) <= hi and lo < hi
        assert sum(n > lo for n in lengths) <= cap * max(shards, 1)


# -- the tuple read bound ----------------------------------------------------

@pytest.fixture(scope="module", params=["tiny", "tiny-moe"])
def models(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rb") / f"{request.param}.gguf")
    build_synthetic_gguf(path, preset=request.param, quant=GGMLType.Q4_K)
    jp, jcfg, _ = jload(path)
    tp, tcfg, _ = tload(path, device="cpu")
    jr = jrunner.ModelRunner(jp, jcfg, max_batch=4, max_seq=MAX_SEQ)
    tr = trunner.ModelRunner(tp, tcfg, max_batch=4, max_seq=MAX_SEQ,
                             device="cpu")
    return path, jr, tr


def _ragged_prefill(runner, kv, vocab):
    """Prefill the four rows of RAGGED (random tokens from seed 0) in one
    step; returns (last-token argmax per row, kv)."""
    rng = np.random.default_rng(0)
    t = max(RAGGED)
    toks = np.zeros((4, t), np.int32)
    pos = np.full((4, t), MAX_SEQ, np.int32)
    for i, n in enumerate(RAGGED):
        toks[i, :n] = rng.integers(0, vocab, size=n)
        pos[i, :n] = np.arange(n)
    lens = np.asarray(RAGGED, np.int32)
    lp = lens - 1
    if isinstance(runner, trunner.ModelRunner):
        logits, kv = runner.step(toks, pos, lens, kv, read_bound=512,
                                 logit_positions=lp)
        logits = logits.numpy()
    else:
        logits, kv = runner.step(jnp.asarray(toks), jnp.asarray(pos),
                                 jnp.asarray(lens), kv, read_bound=512,
                                 logit_positions=lp)
        logits = np.asarray(logits)
    return logits[:, 0].argmax(-1).astype(np.int32), kv


def _decode_step(runner, kv, toks, read_bound):
    lens = np.asarray(RAGGED, np.int32)
    args = (toks[:, None], lens[:, None], lens + 1)
    if isinstance(runner, trunner.ModelRunner):
        return runner.step(*args, kv, read_bound=read_bound)[0].numpy()
    return np.asarray(runner.step(*(jnp.asarray(a) for a in args), kv,
                                  read_bound=read_bound)[0])


def test_tiered_forward_matches_jax_and_single_bound(models):
    _, jr, tr = models
    vocab = tr.cfg.vocab_size
    jtok, jkv = _ragged_prefill(jr, jr.init_kv(), vocab)
    ttok, tkv = _ragged_prefill(tr, tr.init_kv(), vocab)
    assert (jtok == ttok).all()
    tier = trunner.pick_read_bound(np.asarray(RAGGED) + 1, MAX_SEQ)
    assert tier == (256, 512, 1)
    want = _decode_step(jr, jkv, jtok, tier)
    got = _decode_step(tr, tkv, jtok, tier)
    single = _decode_step(tr, tkv, jtok, 512)
    assert got.shape == want.shape == (4, 1, vocab)
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL * scale)
    np.testing.assert_allclose(got, single, rtol=0, atol=LOGIT_ATOL * scale)


def test_tier_over_shards_raises(models):
    """The tier grouped per data shard, read_bound (lo, hi, cap, shards),
    which the port's forward once refused, against the JAX forward: rows
    0-1 and 2-3 each select their own cap rows (row 2 takes the hi
    bucket), and the logits equal the single-bound step's."""
    from llama_gguf_tpu.models.transformer import forward as jforward

    _, jr, tr = models
    vocab = tr.cfg.vocab_size
    jtok, jkv = _ragged_prefill(jr, jr.init_kv(), vocab)
    ttok, tkv = _ragged_prefill(tr, tr.init_kv(), vocab)
    assert (jtok == ttok).all()
    lens = np.asarray(RAGGED, np.int32)
    bound = (256, 512, 1, 2)  # one row of each pair may pass 256
    args = (jtok[:, None], lens[:, None], lens + 1)
    want, _ = jforward(jr.params, jr.cfg, *(jnp.asarray(a) for a in args[:2]),
                       jkv, jnp.asarray(args[2]), read_bound=bound)
    got, _ = forward(tr.params, tr.cfg,
                     *(torch.from_numpy(a) for a in args[:2]), tkv,
                     torch.from_numpy(args[2]), read_bound=bound)
    single = _decode_step(tr, tkv, jtok, 512)
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_ATOL * scale)
    np.testing.assert_allclose(got.numpy(), single, rtol=0,
                               atol=LOGIT_ATOL * scale)


@pytest.mark.parametrize("rows", [[2, 0, 3], [[1, 2], [0, 2]]],
                         ids=["global", "grouped"])
def test_kv_read_rows_matches_jax(rows):
    """kv.read(rows=): [C] global or [G, C] group-local rows, the padding
    index (B/G, or B) clamped as the JAX gather clamps it."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((1, 4, 64, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 4, 64, 2, 8)).astype(np.float32)
    jkv = {"k": [jnp.asarray(k[0])], "v": [jnp.asarray(v[0])]}
    # the port's buffers carry the drop slot at index max_seq
    pad = np.zeros((4, 1, 2, 8), np.float32)
    tkv = {"k": [torch.from_numpy(np.concatenate([k[0], pad], 1))],
           "v": [torch.from_numpy(np.concatenate([v[0], pad], 1))]}
    idx = np.asarray(rows + ([4] if np.ndim(rows) == 1 else []), np.int32)
    want = JKV.read(jkv, 0, bound=32, rows=jnp.asarray(idx))
    got = TKV.read(tkv, 0, bound=32, rows=torch.from_numpy(idx))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_greedy_decode_ragged_matches_jax(models):
    """B = 4 with ragged positions across the 256 read bucket: segments at
    bounds 256, then the (256, 512, 1) tier."""
    _, jr, tr = models
    vocab = tr.cfg.vocab_size
    jtok, jkv = _ragged_prefill(jr, jr.init_kv(), vocab)
    _, tkv = _ragged_prefill(tr, tr.init_kv(), vocab)
    pos0 = np.asarray(RAGGED, np.int32)
    pos0[2] = 250  # the long row crosses 256 after six steps
    steps = 12
    bounds, done = [], 0
    for chunk, _ in trunner.ModelRunner.plan_segments(250, steps, MAX_SEQ):
        bounds.append(trunner.pick_read_bound(pos0 + done + chunk, MAX_SEQ))
        done += chunk
    assert 256 in bounds and (256, 512, 1) in bounds
    want, _ = jr.greedy_decode(jnp.asarray(jtok), jnp.asarray(pos0), jkv,
                               steps)
    got, _ = tr.greedy_decode(torch.from_numpy(jtok), pos0, tkv, steps)
    assert got.shape == (4, steps) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the runner's own cache ----------------------------------------------------

def test_init_kv_is_the_runners_cache(models):
    _, _, tr = models
    kv = tr.init_kv()
    ids = [5, 6, 7, 8, 9]
    tr.prefill(ids, kv)
    assert any(bool(t.any()) for t in kv["k"])
    again = tr.init_kv()
    assert again is kv
    assert all(a is b for a, b in zip(again["k"] + again["v"],
                                      kv["k"] + kv["v"]))
    assert not any(bool(t.any()) for t in again["k"] + again["v"])
    assert tr.init_kv(2) is not kv and tr.init_kv(2) is tr.init_kv(2)
    assert tr.eager_steps == 0  # counted on CUDA only


def test_generate_twice_same_tokens(models):
    path, _, _ = models
    eng = Engine.load(path, EngineConfig(), device="cpu")
    greedy = SamplerConfig(temperature=0.0)
    first = eng.generate("Once upon a time", max_tokens=10, sampler=greedy)
    ids = eng.tokenizer.encode("Once upon a time")
    toks = eng.greedy_tokens(ids, 10)
    assert eng.generate("Once upon a time", max_tokens=10,
                        sampler=greedy) == first
    assert eng.greedy_tokens(ids, 10) == toks


def test_launch_counts_credit():
    before = Q.launch_counts()
    Q.LAUNCHES["qmatmul_q4"] += 3
    Q.LAUNCHES_BY_PATH["qmatmul_q4 splitk"] = \
        Q.LAUNCHES_BY_PATH.get("qmatmul_q4 splitk", 0) + 3
    diff = Q.launch_counts(since=before)
    assert diff == ({"qmatmul_q4": 3}, {"qmatmul_q4 splitk": 3})
    Q.credit(diff, -1)
    assert Q.launch_counts(since=before) == ({}, {})
    Q.credit(diff, 2)
    assert Q.launch_counts(since=before) == ({"qmatmul_q4": 6},
                                             {"qmatmul_q4 splitk": 6})
    Q.credit(diff, -2)


# -- the CLI's bench -----------------------------------------------------------

def test_cli_bench_json_keys(models, capsys):
    path, _, _ = models
    assert cli.main(["bench", path, "--json", "--device", "cpu",
                     "--prompt-tokens", "8", "--gen-tokens", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert jmain(["bench", path, "--prompt-tokens", "8", "--gen-tokens", "4",
                  "--json"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert (got["prompt_tokens"], got["gen_tokens"]) == (8, 4)
    assert got["prefill_tps"] > 0 and got["decode_tps"] > 0


def test_cli_bench_defaults():
    """Unset flags take the config's values (flag > env > TOML > default):
    the default [bench] section's 32 and 64."""
    from llama_gguf_tpu_torch.config import Config

    args = cli.build_parser().parse_args(["bench", "m.gguf", "--batch", "2",
                                          "--profile"])
    bench = Config().bench
    assert (cli._pick(args, "prompt_tokens", bench.prompt_tokens),
            cli._pick(args, "gen_tokens", bench.gen_tokens),
            args.device) == (32, 64, "cuda")
    assert args.batch == 2 and args.profile


# -- the launch plan ---------------------------------------------------------

def _fill(kv, seed):
    """Random values in every K/V row of ``kv``, so attention reads
    context."""
    gen = torch.Generator().manual_seed(seed)
    for key in ("k", "v"):
        for t in kv[key]:
            t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
    return kv


@pytest.fixture(scope="module", params=["tiny", "tiny-moonlight"],
                ids=["gqa", "mla"])
def plan_runner(request, tmp_path_factory):
    """A B = 4 runner of 1024 positions over a GQA (qwen2) or an MLA
    (deepseek2) model."""
    path = str(tmp_path_factory.mktemp("plan") / f"{request.param}.gguf")
    tbuild(path, preset=request.param, quant=GGMLType.Q4_K)
    tp, tcfg, _ = tload(path, device="cpu")
    return trunner.ModelRunner(tp, tcfg, max_batch=4, max_seq=MAX_SEQ,
                               device="cpu")


# each row: ("chunk", start, n) a prefill chunk, ("one", pos) a chunk of one
# token, ("decode", pos), or None (a free row); then the T bucket, the read
# bound (None: pick_read_bound's) and the launches expected: (prefill
# launches, rows launched), as ``launched`` gives runner.last_launch
PLANS = {
    "one_chunk": ([("chunk", 0, 200), ("decode", 300), None,
                   ("decode", 40)], 256, 512, (1, 2 * 256 + 4)),
    "several_launches": ([("chunk", 0, 500), ("chunk", 100, 300),
                          ("decode", 20), ("chunk", 600, 64)], 512, 1024,
                         (3, 3 * 512 + 4)),
    "tier": ([("chunk", 300, 200), ("decode", 10), ("chunk", 0, 256),
              ("decode", 20)], 256, None, (1, 2 * 256 + 4)),
    "one_token_chunk": ([("chunk", 0, 200), ("one", 50), ("decode", 30),
                         None], 256, 512, (1, 2 * 256 + 4)),
    "all_padding": ([None] * 4, 512, 512, (0, 4)),
}


def launched(prefill_launches, rows_launched, state_rows=0):
    """runner.last_launch of a step that launched these."""
    return {"prefill_launches": prefill_launches,
            "rows_launched": rows_launched, "state_rows": state_rows}


def _plan_inputs(rows, bt, vocab):
    rng = np.random.default_rng(7)
    b = len(rows)
    toks = rng.integers(3, vocab, size=(b, bt)).astype(np.int32)
    pos = np.full((b, bt), MAX_SEQ, np.int32)
    lens = np.zeros((b,), np.int32)
    lp = np.zeros((b,), np.int32)
    for i, row in enumerate(rows):
        if row is None:
            continue
        if row[0] == "chunk":
            _, start, n = row
            pos[i, :n] = start + np.arange(n)
            lens[i], lp[i] = start + n, n - 1
        else:
            pos[i, 0] = row[1]
            lens[i] = row[1] + 1
    return toks, pos, lens, lp


@pytest.mark.parametrize("case", list(PLANS))
def test_planned_step_matches_the_full_grid(plan_runner, case):
    """A step wider than one launch runs as its plan: the picked rows'
    logits and the rows it writes equal the whole grid's forward, and
    every other row of the cache is left bit for bit."""
    r = plan_runner
    rows, bt, rb, launches = PLANS[case]
    toks, pos, lens, lp = _plan_inputs(rows, bt, r.cfg.vocab_size)
    if rb is None:
        rb = trunner.pick_read_bound(lens, MAX_SEQ)
        assert isinstance(rb, tuple)
    assert trunner.launch_rows(bt) < len(rows)
    kv = _fill(r.init_kv(), 11)
    before = {key: [t.clone() for t in kv[key]] for key in ("k", "v")}
    ref = {key: [t.clone() for t in kv[key]] for key in ("k", "v")}
    with torch.no_grad():
        want, _ = forward(r.params, r.cfg, torch.from_numpy(toks),
                          torch.from_numpy(pos), ref, torch.from_numpy(lens),
                          read_bound=rb, logit_positions=torch.from_numpy(lp),
                          precision=r.matmul_precision)
    live = [i for i, row in enumerate(rows) if row is not None]
    picked = live or [0]
    got, kv = r.step(toks, pos, lens, kv, read_bound=rb, logit_positions=lp,
                     host_rows=picked)
    assert r.last_launch == launched(*launches)
    want = want[picked, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_ATOL * np.abs(want).max())
    for key in ("k", "v"):
        for t, w, b0 in zip(kv[key], ref[key], before[key]):
            for i in range(len(rows)):
                g = t[i, :MAX_SEQ]
                if i in live:
                    np.testing.assert_allclose(
                        g.numpy(), w[i, :MAX_SEQ].numpy(), rtol=0,
                        atol=1e-5 * float(w[i, :MAX_SEQ].abs().max()))
                else:
                    assert torch.equal(g, b0[i, :MAX_SEQ])


def test_small_grids_run_whole(plan_runner):
    """A grid one launch holds (G >= B), or a step without gathered
    logits, is one launch, as before the plan."""
    r = plan_runner
    toks, pos, lens, lp = _plan_inputs(
        [("chunk", 0, 100), ("decode", 7), None, ("chunk", 5, 60)], 128,
        r.cfg.vocab_size)
    assert trunner.launch_rows(128) == 4
    r.step(toks, pos, lens, r.init_kv(), read_bound=256, logit_positions=lp)
    assert r.last_launch == launched(1, 4 * 128)
    toks, pos, lens, _ = _plan_inputs(
        [("chunk", 0, 200), ("decode", 7), None, None], 256,
        r.cfg.vocab_size)
    r.step(toks, pos, lens, r.init_kv(), read_bound=256)
    assert r.last_launch == launched(1, 4 * 256)
    r.step(toks[:, :1], pos[:, :1], lens, r.init_kv(), read_bound=256)
    assert r.last_launch == launched(0, 4)


@pytest.mark.parametrize("preset,kw", [
    ("tiny-qwen3next", {}),  # DeltaNet layers' recurrent state
    ("tiny-gemma3", {"swa_ring_extra": 256}),  # the sliding-window ring
], ids=["hybrid", "swa_ring"])
def test_caches_the_row_map_skips_run_whole(tmp_path, preset, kw):
    """A cache the row map does not cover keeps the whole grid: the step
    is one launch and equals the forward over the grid, bit for bit."""
    path = str(tmp_path / f"{preset}.gguf")
    tbuild(path, preset=preset, quant=GGMLType.Q4_K)
    tp, tcfg, _ = tload(path, device="cpu")
    r = trunner.ModelRunner(tp, tcfg, max_batch=4, max_seq=MAX_SEQ,
                            device="cpu", **kw)
    kv = r.init_kv()
    assert ("k_swa" in kv) == (preset == "tiny-gemma3")
    toks, pos, lens, lp = _plan_inputs(
        [("chunk", 0, 200), ("decode", 3), None, ("chunk", 0, 150)], 256,
        r.cfg.vocab_size)
    assert trunner.launch_rows(256) < 4
    ref = copy.deepcopy(kv)
    with torch.no_grad():
        want, _ = forward(r.params, r.cfg, torch.from_numpy(toks),
                          torch.from_numpy(pos), ref, torch.from_numpy(lens),
                          read_bound=512, logit_positions=torch.from_numpy(lp),
                          precision=r.matmul_precision)
    got, kv = r.step(toks, pos, lens, kv, read_bound=512, logit_positions=lp)
    assert r.last_launch == launched(1, 4 * 256)
    assert torch.equal(got, want)
    for key in TKV.POSITIONAL:
        for x, y in zip(kv.get(key, ()), ref.get(key, ())):
            assert torch.equal(x, y)
    for x, y in zip(TKV._state_tensors(kv), TKV._state_tensors(ref)):
        assert torch.equal(x, y)


# one step of each storage format at its largest value: a launch's f32
# products differ from the grid's in their last bits (another row count),
# so a stored value may round one step the other way
STORE_STEP = {"bf16": 2.0 ** -8, "i8": 1 / 127, "f8_e4m3": 2.0 ** -3,
              "f8_e5m2": 2.0 ** -2}


@pytest.mark.parametrize("fmt", list(STORE_STEP))
def test_planned_step_in_each_plain_format(tmp_path, fmt):
    """The launch plan on every cache format its row map covers: over a
    context the grid's forward wrote, three chunk rows in launches of one
    and a decode row give the grid's logits, and its cache to within one
    step of the format."""
    path = str(tmp_path / "tiny.gguf")
    tbuild(path, preset="tiny", quant=GGMLType.Q4_K)
    tp, tcfg, _ = tload(path, device="cpu")
    r = trunner.ModelRunner(tp, tcfg, max_batch=4, max_seq=MAX_SEQ,
                            kv_format=fmt, device="cpu")
    kv = r.init_kv()
    rng = np.random.default_rng(9)
    ctx = rng.integers(3, r.cfg.vocab_size, size=(4, 512)).astype(np.int32)
    with torch.no_grad():
        forward(r.params, r.cfg, torch.from_numpy(ctx),
                torch.arange(512, dtype=torch.int32).expand(4, 512), kv,
                torch.full((4,), 512, dtype=torch.int32), read_bound=512,
                precision=r.matmul_precision)
    rows = [("chunk", 512, 300), ("decode", 512), ("chunk", 400, 112),
            ("chunk", 512, 5)]
    toks, pos, lens, lp = _plan_inputs(rows, 512, r.cfg.vocab_size)
    ref = copy.deepcopy(kv)
    with torch.no_grad():
        want, _ = forward(r.params, r.cfg, torch.from_numpy(toks),
                          torch.from_numpy(pos), ref, torch.from_numpy(lens),
                          read_bound=1024,
                          logit_positions=torch.from_numpy(lp),
                          precision=r.matmul_precision)
    got, kv = r.step(toks, pos, lens, kv, read_bound=1024,
                     logit_positions=lp, host_rows=[0, 1, 2, 3])
    assert r.last_launch == launched(3, 3 * 512 + 4)
    want = want[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_ATOL * np.abs(want).max())
    for layer in range(len(kv["k"])):
        for a, b in zip(TKV.read(kv, layer, bound=MAX_SEQ),
                        TKV.read(ref, layer, bound=MAX_SEQ)):
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0,
                atol=STORE_STEP[fmt] * float(b.abs().max()))
