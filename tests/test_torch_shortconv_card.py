"""The row-mapped short-conv kernel (csrc/shortconv.cu) on a card: against
its plain version (ops/shortconv.causal_conv_plain) on random windows and
row maps whose spare places repeat their launch's first row, the windows
included; and LFM2's graphed launch plan in the batched engine against the
single-stream engine.

Skipped on machines without CUDA (the kernel has no CPU mode). This file
imports only the port, torch and numpy:

    python -m pytest --noconftest -q tests/test_torch_shortconv_card.py
"""

import numpy as np
import pytest
import torch

from llama_gguf_tpu_torch.engine import runner as trunner
from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.ops import shortconv as SC
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(g, t, c, b, taps, real, bias, seed, dev):
    """Inputs of ``g`` rows, the first ``real`` of them real with distinct
    cache rows, the rest spare places repeating row 0's cache row with no
    valid token (a launch's padding)."""
    gen = torch.Generator().manual_seed(seed)
    state = torch.randn(b, taps - 1, c, generator=gen)
    w = torch.randn(taps, c, generator=gen)
    bb = torch.randn(c, generator=gen) if bias else None
    rows = torch.randperm(b, generator=gen)[:real]
    rows = torch.cat([rows, rows[:1].expand(g - real)]).int()
    n_valid = torch.randint(1, t + 1, (g,), generator=gen).int()
    n_valid[real:] = 0
    x = torch.randn(g, t, c, generator=gen)
    x[torch.arange(t)[None, :] >= n_valid[:, None]] = 0.0
    return [a.to(dev) if a is not None else None
            for a in (x, state, w, bb, n_valid, rows)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,t,c,b,real", [
    (1, 512, 2048, 48, 1),     # LFM2-24B-A2B's prefill launch
    (2, 256, 2048, 48, 1),     # a launch of two rows, one a spare place
    (4, 37, 300, 6, 3),        # ragged T and C, one spare place
    (8, 64, 8192 + 256, 8, 5)])  # a Mamba-2 conv width
@pytest.mark.parametrize("taps,bias", [(3, False), (4, True)])
def test_kernel_equals_plain_with_a_row_map(cuda, g, t, c, b, real, taps,
                                            bias):
    """Outputs of the real rows and every window bit for bit; the spare
    places write nothing; one launch counted."""
    x, state, w, bb, n_valid, rows = _case(g, t, c, b, taps, real, bias,
                                           g * t + c, cuda)
    want_state = state.clone()
    want = SC.causal_conv_plain(x, want_state, w, bb, n_valid, rows)
    before = Q.LAUNCHES["short_conv"]
    got_state = state.clone()
    got = SC.causal_conv(x, got_state, w, bb, n_valid, rows)
    torch.cuda.synchronize()
    assert Q.LAUNCHES["short_conv"] == before + 1
    assert torch.equal(got[:real], want[:real])
    assert torch.equal(got_state, want_state)
    untouched = sorted(set(range(b)) - set(rows.tolist()))
    assert torch.equal(got_state[untouched], state[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [3, 4])
def test_kernel_equals_plain_on_the_decode_grid(cuda, taps):
    """The identity map at T = 1 over 48 rows, a third of them empty: every
    output and window bit for bit, the empty rows' windows unchanged."""
    b, c = 48, 2048
    x, state, w, _, n_valid, _ = _case(b, 1, c, b, taps, b, False, taps,
                                       cuda)
    n_valid[::3] = 0
    x[::3] = 0.0
    want_state = state.clone()
    want = SC.causal_conv_plain(x, want_state, w, None, n_valid)
    got_state = state.clone()
    got = SC.causal_conv(x, got_state, w, None, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_state, want_state)
    assert torch.equal(got_state[::3], state[::3])


@pytest.mark.cuda
def test_graphed_plan_on_lfm2_equals_single_stream(cuda, tmp_path):
    """tiny-lfm2 at B = 8 with chunks of 128 (G = 4 < B): the mixed steps
    replay the plan's graphs, the chunk rows' conv windows by the row map,
    and every request's tokens equal the single-stream engine's."""
    path = str(tmp_path / "tiny-lfm2.gguf")
    build_synthetic_gguf(path, preset="tiny-lfm2", quant=GGMLType.Q4_K)
    eng = Engine.load(path, EngineConfig(weight_mode="quant", max_batch=8),
                      device="cuda")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 500, size=n).tolist()
               for n in (200, 20, 170, 9, 150, 140, 60)]
    want = [eng.greedy_tokens(p, 5) for p in prompts]
    assert trunner.launch_rows(128) < 8
    be = BatchedEngine(eng.runner, eng.tokenizer, prefill_chunk=128)
    try:
        handles = [be.submit(p, max_tokens=5, sampler=GREEDY)
                   for p in prompts]
        for h in handles:
            h.text(timeout=300)
    finally:
        be.shutdown()
    assert eng.runner.eager_steps == 0
    assert be.stats.state_rows > 0
    for w, h in zip(want, handles):
        eog = [i for i, t in enumerate(w) if eng.tokenizer.is_eog(t)]
        assert h.token_ids == w[:eog[0] if eog else len(w)]
