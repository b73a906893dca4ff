"""The continuous-batching engine on a card: its graphed steps against the
same engine on its plain path, and graph keys reused across steps.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_batched_card.py
"""

import threading
import time

import numpy as np
import pytest
import torch

from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.runner import ModelRunner, launch_rows
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
NEAR_TIE = 1e-3  # top-2 logprob margin: the two paths may part there
B = 8


@pytest.fixture
def engine(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    path = str(tmp_path / "tiny.gguf")
    build_synthetic_gguf(path, preset="tiny", quant=GGMLType.Q4_K)
    return Engine.load(path, EngineConfig(weight_mode="quant", max_batch=B),
                       device="cuda")


def _prompts(engine, n):
    rng = np.random.default_rng(0)
    vocab = engine.runner.cfg.vocab_size
    return [rng.integers(3, vocab, size=int(k)).tolist()
            for k in np.linspace(4, 60, n)]


def _serve(engine, prompts, eager: bool):
    be = BatchedEngine(engine.runner, engine.tokenizer, max_queue=32,
                       prefill_chunk=16)
    if eager:  # a cache the runner did not make: every step eager
        be._kv = engine.runner._make_kv(engine.runner.max_batch)
    try:
        hs = [be.submit(p, max_tokens=12, sampler=GREEDY, logprobs=2)
              for p in prompts]
        for h in hs:
            h.text(timeout=300)
    finally:
        be.shutdown()
    return hs, be.stats


@pytest.mark.cuda
def test_batched_graphs_equal_the_plain_path(engine):
    """B = 8 with more requests than rows: the graphed steps give the eager
    steps' tokens up to each request's first near tie, and logprobs within
    1e-3."""
    r = engine.runner
    prompts = _prompts(engine, 10)
    eager0 = r.eager_steps
    want, _ = _serve(engine, prompts, eager=True)
    steps = r.eager_steps - eager0
    assert steps > 0
    got, stats = _serve(engine, prompts, eager=False)
    assert r.eager_steps == eager0 + steps  # no graphed step ran eagerly
    assert stats.mixed_steps > 0
    _same_until_tie(got, want)


def _same_until_tie(got, want):
    """Each request's tokens equal up to its first near tie, and logprobs
    within NEAR_TIE."""
    for g, w in zip(got, want):
        tie = next((i for i, e in enumerate(w.logprobs)
                    if e["top_logprobs"][0]["logprob"]
                    - e["top_logprobs"][1]["logprob"] < NEAR_TIE), None)
        n = len(w.token_ids) if tie is None else tie
        assert g.token_ids[:n] == w.token_ids[:n]
        for a, b in zip(g.logprobs[:n], w.logprobs[:n]):
            assert abs(a["logprob"] - b["logprob"]) <= NEAR_TIE


@pytest.mark.cuda
def test_captures_beside_another_threads_cuda_work(engine, tmp_path):
    """A batched engine captures its graph keys while another thread loads
    a model onto the card and runs CUDA work of its own (allocations,
    matmuls, copies to the host), as a hot reload's load does beside a
    serving scheduler. The captures run in the "thread_local" error mode,
    so none fails and the other thread's work does not either: every
    request finishes, the steps all replay graphs, and the tokens equal a
    quiet run's up to the first near tie. Two kinds of work the other
    thread must not do during a capture, and neither a load nor the
    serving path does: a device-wide synchronize (it ends the capture) and
    a draw from the default CUDA generator (bound to the capture while it
    runs, so the draw raises)."""
    r = engine.runner
    prompts = _prompts(engine, 8)
    want, _ = _serve(engine, prompts, eager=False)
    stop, errors, rounds = threading.Event(), [], [0]

    def hammer():
        try:
            while not stop.is_set():
                other = Engine.load(str(tmp_path / "tiny.gguf"),
                                    EngineConfig(weight_mode="quant"),
                                    device="cuda")
                rounds[0] += 1
                x = torch.linspace(-1, 1, 256 * 256, device="cuda")
                x = x.reshape(256, 256)
                for _ in range(8):
                    x = torch.tanh(x @ x) + x.roll(1, 0)
                    float(x.sum().cpu())
                    rounds[0] += 1
                del other
        except Exception as e:  # asserted below
            errors.append(e)

    th = threading.Thread(target=hammer)
    th.start()
    try:
        while not rounds[0] and not errors:
            time.sleep(0.01)
        n0, captures0, eager0 = rounds[0], r.captures, r.eager_steps
        got, stats = _serve(engine, prompts, eager=False)
        n1 = rounds[0]
    finally:
        stop.set()
        th.join(timeout=120)
    assert not errors and not th.is_alive()
    assert n1 > n0  # the other thread worked while the captures ran
    assert r.captures > captures0 and r.eager_steps == eager0
    assert all(h.finish_reason in ("stop", "length") for h in got)
    _same_until_tie(got, want)


@pytest.mark.cuda
def test_batched_graph_keys_are_reused(engine):
    """Every step replays a graph keyed (B, T bucket, read bound, gathered
    logits, owner): far fewer keys than steps, the decode keys replayed
    again by a second burst, and no step eager."""
    r = engine.runner
    prompts = _prompts(engine, 8)
    be = BatchedEngine(r, engine.tokenizer, max_queue=32, prefill_chunk=16)
    try:
        for h in [be.submit(p, max_tokens=12, sampler=GREEDY)
                  for p in prompts]:
            h.text(timeout=300)
        mine = [k for k in r._graphs if k[-1] == be._owner]
        assert mine and all(k[0] == B for k in mine)
        steps = sum(r.replays.get(k, 0) for k in mine)
        assert steps > 2 * len(mine)
        decode = {k: r.replays[k] for k in mine if k[1] == 1}
        for h in [be.submit(p, max_tokens=12, sampler=GREEDY)
                  for p in prompts]:
            h.text(timeout=300)
        assert decode and all(r.replays[k] > n for k, n in decode.items())
        assert r.eager_steps == 0
    finally:
        be.shutdown()
    # the engine's graphs and cache go back to the runner with it
    assert not [k for k in r._graphs if k[-1] == be._owner]


@pytest.mark.cuda
def test_a_plan_captured_on_padding_serves_live_chunk_rows(engine):
    """Keys wider than one launch (B = 8, T = 256: prefill launches of G = 2
    rows beside the decode graph) captured once on all-padding inputs, as a
    warm-up captures them, then stepped with live chunk rows: no capture
    more, the eager plan's logits and cache rows on an equal cache, and
    release_kv drops the plans' graphs. The second key's decode graph is
    captured after the prefill graph it shares with the first (a tier's hi
    is the first key's bound), so the pool may hold that graph's scratch
    where the decode graph keeps its output."""
    r = ModelRunner(engine.runner.params, engine.runner.cfg, max_batch=B,
                    max_seq=1024, device="cuda")
    bt, drop, owner, tier = 256, 1024, "plan-card", (256, 512, 1)
    assert launch_rows(bt) < B
    kv = r.init_kv(B, owner=owner)
    for rb in (512, tier):
        r.step(np.zeros((B, bt), np.int32), np.full((B, bt), drop, np.int32),
               np.zeros((B,), np.int32), kv, read_bound=rb,
               logit_positions=np.zeros((B,), np.int32), host_rows=[0])
    assert {(B, bt, 512, "rows", owner), (B, 1, 512, False, owner),
            (B, 1, (256, 512, 1, 1), False, owner)} <= set(r._graphs)
    captures = r.captures
    ekv = r._make_kv(B)  # not the runner's: the eager plan
    rng = np.random.default_rng(4)
    vocab = r.cfg.vocab_size
    # (read bound, row -> (start, tokens) of a chunk); every other row
    # decodes at 40 + row
    for rb, chunks in ((512, {0: (0, 200)}),  # one chunk row
                       (512, {1: (0, 180), 2: (10, 100), 4: (0, 256),
                              5: (50, 2), 7: (0, 90)}),  # three launches
                       (tier, {3: (300, 150), 6: (60, 1)})):  # one token
        gen = torch.Generator(device="cuda").manual_seed(len(chunks))
        for key in ("k", "v"):
            for a, b in zip(kv[key], ekv[key]):
                a.copy_(torch.randn(a.shape, generator=gen, device="cuda")
                        .to(a.dtype) * 0.5)
                b.copy_(a)
        toks = rng.integers(3, vocab, size=(B, bt)).astype(np.int32)
        pos = np.full((B, bt), drop, np.int32)
        lens, lp = np.zeros((B,), np.int32), np.zeros((B,), np.int32)
        for i in range(B):
            start, n = chunks.get(i, (40 + i, 1))
            pos[i, :n] = start + np.arange(n)
            lens[i], lp[i] = start + n, n - 1 if i in chunks else 0
        rows = list(range(B))
        got, _ = r.step(toks, pos, lens, kv, read_bound=rb,
                        logit_positions=lp, host_rows=rows)
        want, _ = r.step(toks, pos, lens, ekv, read_bound=rb,
                         logit_positions=lp, host_rows=rows)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        for key in ("k", "v"):
            for a, b in zip(kv[key], ekv[key]):
                a, b = a[:, :drop].float(), b[:, :drop].float()
                assert ((a - b).abs().max() <= 1e-4 * b.abs().max()).item()
    assert r.captures == captures and r.eager_steps == 3
    r.release_kv(owner)
    assert not [k for k in r._graphs if k[-1] == owner]
