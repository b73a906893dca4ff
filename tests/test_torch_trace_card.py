"""The port's spans on a card: a ``utils/debug.profile`` trace of
BatchedEngine traffic holds the scheduler's and the runner's spans beside
the kernels, and graphed steps record a capture at a key's first step and
replays after it.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_trace_card.py
"""

import json
import os

import numpy as np
import pytest
import torch

from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils import debug
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
SPANS = {"batched.step", "batched.admit", "batched.build", "batched.sample",
         "batched.emit", "runner.inputs", "runner.replay", "runner.fetch"}


@pytest.fixture
def engine(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    path = str(tmp_path / "tiny.gguf")
    build_synthetic_gguf(path, preset="tiny", quant=GGMLType.Q4_K)
    return Engine.load(path, EngineConfig(weight_mode="quant", max_batch=4),
                       device="cuda")


def _serve(be, engine, n=6, max_tokens=8):
    rng = np.random.default_rng(0)
    vocab = engine.runner.cfg.vocab_size
    hs = [be.submit(rng.integers(3, vocab, size=int(k)).tolist(),
                    max_tokens=max_tokens, sampler=GREEDY)
          for k in np.linspace(4, 40, n)]
    for h in hs:
        h.text(timeout=300)
    return hs


@pytest.mark.cuda
def test_a_profile_shows_the_spans_beside_the_kernels(engine, tmp_path):
    be = BatchedEngine(engine.runner, engine.tokenizer, max_queue=32,
                       prefill_chunk=16)
    logdir = str(tmp_path / "prof")
    try:
        _serve(be, engine)  # the graphs' captures
        with debug.profile(logdir):
            _serve(be, engine)
    finally:
        be.shutdown()
    with open(os.path.join(logdir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {e["name"] for e in notes}
    assert SPANS <= names and not any(n.startswith("bench.") for n in names)
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in notes
                   if e["name"] == "batched.step")
    # the kernels run inside the scheduler's steps, on the same clock
    inside = sum(any(a <= k["ts"] <= b for a, b in steps) for k in kernels)
    print(f"profile: {len(notes)} spans ({len(steps)} batched.step), "
          f"{len(kernels)} kernels, {inside} of them inside a batched.step")
    assert kernels and inside >= 0.9 * len(kernels)


@pytest.mark.cuda
def test_graphed_steps_record_capture_then_replay(engine):
    r = engine.runner
    be = BatchedEngine(r, engine.tokenizer, max_queue=32, prefill_chunk=16)
    captures0, seconds0 = r.captures, r.capture_seconds
    debug.clear_spans()
    try:
        _serve(be, engine)
    finally:
        be.shutdown()
    spans = debug.spans()
    steps = {s.id for s in spans if s.name == "batched.step"}
    mine = [s for s in spans if s.parent in steps]
    captured = [s for s in mine if s.name == "runner.capture"]
    assert len(captured) == r.captures - captures0 > 0
    assert sum(s.name == "runner.replay" for s in mine) == len(steps)
    assert not any(s.name == "runner.forward" for s in mine)
    assert r.capture_seconds - seconds0 == pytest.approx(
        sum(s.seconds for s in captured), rel=0.05)
