"""The port's runner against the JAX package's, on the CPU: the two-tier
ragged read bound (pick_read_bound, the tuple read bound of forward,
tiered attention and kv.read's row gather), ragged greedy_decode, the
runner-owned KV cache and the CLI's bench."""

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
