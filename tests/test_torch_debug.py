"""The port's utils/debug.py against the JAX package's on the CPU.

LLAMA_DEBUG: the JAX test_llama_debug_tracing (tests/test_multihost.py) on
the port, and the port's lines against JAX's for the same tiny model and
prompt: the same lines, in JAX's format, with each RMS within 1e-5
relative (f32, another order of summation; JAX's prints may come in any
order). The switch makes a CUDA runner run every step eagerly, which is
checked here on a runner that only believes it is on CUDA (its _graphed
decision makes no CUDA call). profile() and bench --profile write a chrome
trace, in which a span is a record_function region (the spans themselves:
tests/test_torch_trace.py)."""

import json
import os
import re

import pytest
import torch

from fixtures import make_tiny_model
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JEngineConfig
from llama_gguf_tpu.utils import debug as jdebug

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.utils import debug

torch.set_num_threads(1)

LINE = re.compile(r"^\[LLAMA_DEBUG\] layer +(-?\d+) (\w+): rms=(\d+\.\d{6})$")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dbg") / "dbg.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=2,
                    heads=4, kv_heads=2, ffn=128, ctx=64, seed=1,
                    tokenizer=True)
    return path


@pytest.fixture
def tracing():
    debug.set_debug_activations(True)
    jdebug.set_debug_activations(True)
    yield
    debug.set_debug_activations(None)
    jdebug.set_debug_activations(None)


def traced(out: str) -> list[tuple[str, int, str, float]]:
    """(the line without its value, layer, tag, rms) of each debug line."""
    rows = []
    for line in out.splitlines():
        m = LINE.match(line)
        if m:
            rows.append((line[:line.index("rms=")], int(m.group(1)),
                         m.group(2), float(m.group(3))))
    return rows


def test_llama_debug_tracing(path, capfd, tracing):
    eng = Engine.load(path, EngineConfig(weight_mode="dequant"), device="cpu")
    eng.greedy_tokens([1, 2, 3], 1)
    out = capfd.readouterr().out
    assert "[LLAMA_DEBUG]" in out and "rms=" in out
    assert "embed" in out and "layer   1 out" in out
    rows = [(l, t) for _, l, t, _ in traced(out)]
    assert rows and rows == [(-1, "embed"), (0, "out"), (1, "out")] * (
        len(rows) // 3)  # each forward: the embedding and both layers


def test_lines_match_jax(path, capfd, tracing):
    import jax

    eng = Engine.load(path, EngineConfig(weight_mode="dequant"), device="cpu")
    eng.greedy_tokens([1, 2, 3, 4, 5], 3)  # a prefill and two decode steps
    got = traced(capfd.readouterr().out)
    jeng = JEngine.load(path, JEngineConfig(weight_mode="dequant"))
    jeng.greedy_tokens([1, 2, 3, 4, 5], 3)
    jax.effects_barrier()
    want = traced(capfd.readouterr().out)
    assert len(got) == len(want) >= 9  # three forwards or more
    assert sorted(g[0] for g in got) == sorted(w[0] for w in want)
    for key in {(l, t) for _, l, t, _ in want}:
        g = sorted(r for _, l, t, r in got if (l, t) == key)
        w = sorted(r for _, l, t, r in want if (l, t) == key)
        for a, b in zip(g, w):
            assert a == pytest.approx(b, rel=1e-5, abs=2e-6), key


def test_switch_off_prints_nothing(path, capfd):
    debug.set_debug_activations(False)
    try:
        eng = Engine.load(path, EngineConfig(weight_mode="dequant"),
                          device="cpu")
        eng.greedy_tokens([1, 2, 3], 2)
        assert "[LLAMA_DEBUG]" not in capfd.readouterr().out
    finally:
        debug.set_debug_activations(None)


def test_switch_reads_the_environment(monkeypatch):
    debug.set_debug_activations(None)
    monkeypatch.setenv("LLAMA_DEBUG", "1")
    assert debug.debug_activations_enabled()
    monkeypatch.delenv("LLAMA_DEBUG")
    assert debug.debug_activations_enabled()  # read once
    debug.set_debug_activations(None)
    assert not debug.debug_activations_enabled()
    debug.set_debug_activations(None)


def test_switch_runs_cuda_steps_eagerly(path, caplog):
    """On CUDA a step on the runner's own cache replays a graph unless
    LLAMA_DEBUG is on: then it runs eagerly, counts in eager_steps, and the
    runner says why once."""
    eng = Engine.load(path, EngineConfig(weight_mode="dequant"), device="cpu")
    r = eng.runner
    kv = r.init_kv()
    r.device = torch.device("cuda")  # _graphed only reads the type
    try:
        debug.set_debug_activations(False)
        assert r._graphed(kv) == (1, None) and r.eager_steps == 0
        debug.set_debug_activations(True)
        assert r._graphed(kv) is None and r._graphed(kv, 3) is None
        assert r.eager_steps == 4
        assert caplog.text.count("LLAMA_DEBUG is set") == 1
    finally:
        r.device = torch.device("cpu")
        debug.set_debug_activations(None)


def test_profile_writes_a_trace(path, tmp_path):
    logdir = str(tmp_path / "prof")
    with debug.profile(logdir) as d:
        with debug.span("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert d == logdir
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul" for e in events)
    bench_dir = str(tmp_path / "bench")
    assert cli.main(["bench", path, "--profile", bench_dir, "--json",
                     "--prompt-tokens", "8", "--gen-tokens", "4",
                     "--device", "cpu"]) == 0
    assert os.path.getsize(os.path.join(bench_dir, "trace.json")) > 0
