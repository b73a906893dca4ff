"""The port's continuous-batching engine (engine/batched.py) against the JAX
package's on the CPU, where the port's quantized products run their plain
versions.

Models: the qwen2 tiny model of tests/test_batched.py (Q8_0 weights, so the
port's "quant" mode runs the q8 kernel's plain version; the JAX engine runs
"dequant", the same dequantized f32 weights) and tiny-moe (Q4_K; kernels
4-6's plain versions). Tolerances: greedy tokens equal, with every step's
top-2 logit margin above 1e-4 so the comparison is not decided by a
reassociated sum; logprobs within 1e-4 (f32 logits, another order of
summation)."""

import threading
import time

import numpy as np
import pytest

from fixtures import make_tiny_model
from llama_gguf_tpu.engine.batched import BatchedEngine as JBatched
from llama_gguf_tpu.engine.batched import _StopBuffer as JStopBuffer
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler

from llama_gguf_tpu_torch.engine.batched import BatchedEngine, _StopBuffer
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
JGREEDY = JSampler(temperature=0.0, repetition_penalty=1.0)
PROMPTS = ["The quick brown fox", "other thread", "Once upon",
           " ".join(f"tok{i}" for i in range(20))]
NEW = 10
MARGIN = 1e-4
LOGPROB_TOL = 1e-4


def _qwen(path):
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=96, seed=11,
                    tokenizer=True, quant=GGMLType.Q8_0)


def _moe(path):
    build_synthetic_gguf(path, preset="tiny-moe", quant=GGMLType.Q4_K,
                         seed=1)


MODELS = {"qwen2": _qwen, "tiny-moe": _moe}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("batched")
    out = {}
    for name, build in MODELS.items():
        out[name] = str(d / f"{name}.gguf")
        build(out[name])
    return out


@pytest.fixture(scope="module")
def port(paths):
    """name -> the port's Engine (cpu, quant, max_batch 4)."""
    return {name: Engine.load(p, EngineConfig(weight_mode="quant",
                                              max_batch=4), device="cpu")
            for name, p in paths.items()}


@pytest.fixture(scope="module")
def runs(paths, port):
    """name -> (port handles, JAX handles, port single-stream texts) for
    PROMPTS, greedy with logprobs=2, all submitted at once."""
    out = {}
    for name, path in paths.items():
        teng = port[name]
        be = BatchedEngine(teng.runner, teng.tokenizer, max_queue=16)
        jeng = JEngine.load(path, JConfig(weight_mode="dequant", max_batch=4))
        jbe = JBatched(jeng.runner, jeng.tokenizer, max_queue=16)
        try:
            th = [be.submit(p, max_tokens=NEW, sampler=GREEDY, logprobs=2)
                  for p in PROMPTS]
            jh = [jbe.submit(p, max_tokens=NEW, sampler=JGREEDY, logprobs=2)
                  for p in PROMPTS]
            for h in th + jh:
                h.text(timeout=300)
        finally:
            be.shutdown()
            jbe.shutdown()
        single = [teng.generate(p, max_tokens=NEW, sampler=GREEDY)
                  for p in PROMPTS]
        out[name] = (th, jh, single)
    return out


@pytest.mark.parametrize("model", list(MODELS))
def test_greedy_tokens_match_jax_with_a_margin(runs, model):
    th, jh, _ = runs[model]
    for t, j in zip(th, jh):
        assert t.finish_reason == j.finish_reason
        assert t.token_ids == [e["id"] for e in j.logprobs]
        assert "".join(t._text_parts) == "".join(j._text_parts)
        for e in t.logprobs:
            top = e["top_logprobs"]
            # log-softmax keeps logit differences: the top-2 logit margin
            assert top[0]["logprob"] - top[1]["logprob"] > MARGIN


@pytest.mark.parametrize("model", list(MODELS))
def test_batched_matches_single_stream(runs, model):
    th, _, single = runs[model]
    assert ["".join(h._text_parts) for h in th] == single


@pytest.mark.parametrize("model", list(MODELS))
def test_logprobs_match_jax(runs, model):
    th, jh, _ = runs[model]
    for t, j in zip(th, jh):
        assert len(t.logprobs) == len(j.logprobs)
        for a, b in zip(t.logprobs, j.logprobs):
            assert (a["token"], a["id"]) == (b["token"], b["id"])
            assert abs(a["logprob"] - b["logprob"]) <= LOGPROB_TOL
            assert [x["id"] for x in a["top_logprobs"]] == \
                [x["id"] for x in b["top_logprobs"]]
            np.testing.assert_allclose(
                [x["logprob"] for x in a["top_logprobs"]],
                [x["logprob"] for x in b["top_logprobs"]],
                rtol=0, atol=LOGPROB_TOL)


@pytest.fixture(scope="module")
def batched(port):
    teng = port["qwen2"]
    be = BatchedEngine(teng.runner, teng.tokenizer, max_queue=16)
    yield be
    be.shutdown()


def test_streaming_pieces_join_to_text(batched):
    h = batched.submit("Stream me", max_tokens=8, sampler=GREEDY)
    pieces = list(h.stream(timeout=120))
    assert h.done and h.finish_reason in ("stop", "length")
    assert "".join(pieces) == "".join(h._text_parts)
    assert h.completion_tokens == len(h.token_ids) <= 8


def test_more_requests_than_slots(batched):
    handles = [batched.submit(f"req {i}", max_tokens=6, sampler=GREEDY)
               for i in range(9)]  # > 4 slots: forces queue + slot reuse
    outs = [h.text(timeout=240) for h in handles]
    assert all(h.finish_reason in ("stop", "length") for h in handles)
    assert len(outs) == 9
    again = batched.submit("req 0", max_tokens=6,
                           sampler=GREEDY).text(timeout=120)
    assert again == outs[0]


def test_stop_pattern(batched):
    ref = batched.submit(PROMPTS[3], max_tokens=12,
                         sampler=GREEDY).text(timeout=120)
    assert len(ref) > 4
    stop = ref[2:5]
    h = batched.submit(PROMPTS[3], max_tokens=12, sampler=GREEDY,
                       stop=[stop])
    out = h.text(timeout=120)
    assert stop not in out
    assert out == ref[: ref.index(stop)]
    assert h.finish_reason == "stop"


def test_admission_control(paths):
    eng = Engine.load(paths["qwen2"], EngineConfig(weight_mode="quant"),
                      device="cpu")
    be = BatchedEngine(eng.runner, eng.tokenizer, max_queue=2)
    try:
        h1 = be.submit("a", max_tokens=64, sampler=GREEDY)
        h2 = be.submit("b", max_tokens=64, sampler=GREEDY)
        with pytest.raises(RuntimeError, match="queue full"):
            for _ in range(8):
                be.submit("c", max_tokens=64, sampler=GREEDY)
        h1.text(timeout=240)
        h2.text(timeout=240)
        assert be.stats.rejected >= 1
    finally:
        be.shutdown()


def test_mixed_steps_match_single_stream(port):
    """prefill_chunk=8: a long prompt's chunks ride beside a decoding row
    (mixed_steps > 0), and both outputs equal the single-stream ones. Each
    step is slowed a little, so the first row still decodes when the long
    prompt arrives."""
    teng = port["qwen2"]
    be = BatchedEngine(teng.runner, teng.tokenizer, max_queue=8,
                       prefill_chunk=8)
    step = be._mixed_step

    def slowed():
        time.sleep(0.02)
        return step()

    be._mixed_step = slowed
    long_prompt = "word " * 30
    try:
        h_a = be.submit(PROMPTS[3], max_tokens=24, sampler=GREEDY)
        deadline = time.time() + 60
        while be.stats.decode_steps < 1 and time.time() < deadline:
            time.sleep(0.002)
        h_b = be.submit(long_prompt, max_tokens=8, sampler=GREEDY)
        out_a, out_b = h_a.text(timeout=120), h_b.text(timeout=120)
    finally:
        be.shutdown()
    assert be.stats.mixed_steps > 0, vars(be.stats)
    assert out_a == teng.generate(PROMPTS[3], max_tokens=24,
                                  sampler=GREEDY)
    assert out_b == teng.generate(long_prompt, max_tokens=8, sampler=GREEDY)


def test_single_stream_generate_leaves_batched_rows(port):
    """Engine.generate on the runner a live BatchedEngine uses, between its
    steps and from another thread, changes none of the batched outputs:
    the batched engine owns its cache (runner.init_kv(owner=))."""
    teng = port["qwen2"]
    prompts = PROMPTS[:3]

    def run(interfere):
        be = BatchedEngine(teng.runner, teng.tokenizer, max_queue=8)
        step, calls = be._mixed_step, []

        def hooked():
            did = step()
            if did and interfere:
                calls.append(teng.generate("interloper", max_tokens=4,
                                           sampler=GREEDY))
            return did

        be._mixed_step = hooked
        try:
            hs = [be.submit(p, max_tokens=NEW, sampler=GREEDY)
                  for p in prompts]
            stop = threading.Event()
            other = []

            def hammer():
                while not stop.is_set():
                    other.append(teng.generate("other thread",
                                               max_tokens=3, sampler=GREEDY))

            th = threading.Thread(target=hammer)
            if interfere:
                th.start()
            outs = [h.text(timeout=240) for h in hs]
            stop.set()
            if interfere:
                th.join(timeout=60)
                assert not th.is_alive()
        finally:
            be.shutdown()
        return outs, calls, other

    want, _, _ = run(False)
    got, calls, other = run(True)
    assert calls and other
    assert got == want
    # the single-stream calls were not disturbed either
    assert len(set(calls)) == 1 and len(set(other)) == 1


def test_runner_caches_have_owners(port):
    r = port["qwen2"].runner
    mine = r.init_kv(2, owner="test-owner")
    mine["k"][0].fill_(1.0)
    shared = r.init_kv(2)
    assert shared is not mine and float(mine["k"][0].abs().max()) == 1.0
    assert r.init_kv(2, owner="test-owner") is mine  # zeroed in place
    assert float(mine["k"][0].abs().max()) == 0.0
    r.release_kv("test-owner")
    assert (2, "test-owner") not in r._kv and r.tier_shards == 1


def test_step_host_rows_are_the_logits_rows(port):
    """``step(..., host_rows=)`` hands back the picked rows' last logits
    column on the host, equal to the same rows of the device result;
    ``prefill``/``decode_one(host=True)`` the same for one row."""
    r = port["qwen2"].runner
    rng = np.random.default_rng(3)
    toks = rng.integers(3, 200, size=(4, 8)).astype(np.int32)
    pos = np.tile(np.arange(8, dtype=np.int32), (4, 1))
    lens = np.full((4,), 8, np.int32)
    lp = np.array([7, 3, 5, 0], np.int32)
    want, _ = r.step(toks, pos, lens, r._make_kv(4), read_bound=256,
                     logit_positions=lp)
    got, _ = r.step(toks, pos, lens, r._make_kv(4), read_bound=256,
                    logit_positions=lp, host_rows=[2, 0])
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want[[2, 0], 0].numpy())
    empty, _ = r.step(toks, pos, lens, r._make_kv(4), read_bound=256,
                      logit_positions=lp, host_rows=[])
    assert empty.shape == (0, want.shape[-1])
    ids = toks[0].tolist()
    dev, kv, n = r.prefill(ids, r._make_kv(1))
    host, kv2, n2 = r.prefill(ids, r._make_kv(1), host=True)
    np.testing.assert_array_equal(host, dev.numpy())
    assert n == n2 == len(ids)
    dev, _ = r.decode_one(5, n, kv)
    host, _ = r.decode_one(5, n, kv2, host=True)
    np.testing.assert_array_equal(host, dev.numpy())


def test_capture_steps_are_left_out_of_the_decode_rate(port):
    """A step that captured a graph key (here: the runner's capture count
    bumped on every third step) is counted in capture_steps/capture_time
    and not in decode_time or decode_tokens_pure."""
    teng = port["qwen2"]
    r = teng.runner
    be = BatchedEngine(r, teng.tokenizer, max_queue=8)
    step, log = r.step, []

    def capturing(*a, **kw):
        out = step(*a, **kw)
        # the step's T, and its live rows (positions short of the drop slot)
        log.append((np.shape(a[0])[1],
                    int((np.asarray(a[1])[:, 0] < r.max_seq).sum())))
        if len(log) % 3 == 0:
            r.captures += 1
        return out

    r.step = capturing
    try:
        hs = [be.submit(p, max_tokens=NEW, sampler=GREEDY)
              for p in PROMPTS[:2]]
        for h in hs:
            h.text(timeout=120)
    finally:
        be.shutdown()
        del r.step
    st = be.stats
    pure = [i for i, (t, _) in enumerate(log) if t == 1]  # none prefilling
    kept = [i for i in pure if (i + 1) % 3]
    assert len(kept) < len(pure) and st.capture_steps == len(log) // 3
    assert st.capture_time > 0
    assert st.decode_tokens_pure == sum(log[i][1] for i in kept)
    assert st.decode_tps > 0


STOP_CASES = [
    (["END"], ["hello E", "N", "D tail"]),
    (["xyz"], ["abc", "xy", "q"]),
    (["<|im_end|>", "\nUser:"], ["Hi <|im", "_en", "d|> rest"]),
    (["ab", "abc"], ["xa", "b", "c"]),
    ([], ["free", " text"]),
    (["\nUser:"], ["one\n", "Us", "er: two"]),
    (["aaa"], ["a", "a", "b", "aaa"]),
]


@pytest.mark.parametrize("stop,pieces", STOP_CASES,
                         ids=[f"case{i}" for i in range(len(STOP_CASES))])
def test_stop_buffer_matches_jax(stop, pieces):
    mine, ref = _StopBuffer(stop), JStopBuffer(stop)
    for piece in pieces:
        assert mine.push(piece) == ref.push(piece)
    assert mine.flush() == ref.flush()


def test_submit_after_shutdown_raises(port):
    teng = port["qwen2"]
    be = BatchedEngine(teng.runner, teng.tokenizer)
    be.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        be.submit("x", max_tokens=2, sampler=GREEDY)


def test_concurrent_submits_keep_the_queue_count(port):
    """16 threads submit 4 requests each with a tiny switch interval: every
    request finishes and the pending count returns to 0 (a lost update of
    the shared count would leave it off)."""
    import sys

    teng = port["qwen2"]
    be = BatchedEngine(teng.runner, teng.tokenizer, max_queue=1000)
    handles, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def submitter(k):
            try:
                for i in range(4):
                    handles.append(be.submit(f"t{k} {i}", max_tokens=2,
                                             sampler=GREEDY))
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads) and not errors
        for h in handles:
            h.text(timeout=240)
    finally:
        sys.setswitchinterval(old)
        be.shutdown()
    assert len(handles) == 64 == be.stats.submitted == be.stats.completed
    assert be.queued_count == 0 and be.active_count == 0
    assert all(h.finish_reason in ("stop", "length") for h in handles)
