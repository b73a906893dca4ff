"""Perplexity, the prompt cache and the context shift on a card: each on
the runner's CUDA graphs (no eager step) and on the kernels, quant against
dequant mode; and the CLI's ``perplexity --json`` there.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_item6_card.py
"""

import json

import numpy as np
import pytest
import torch

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.perplexity import perplexity
from llama_gguf_tpu_torch.engine.prompt_cache import PromptCache
from llama_gguf_tpu_torch.engine.runner import ModelRunner
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
TEXT = "The quick brown fox jumps over the lazy dog. " * 2  # 128 tokens


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels and CUDA graphs have no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def model(cuda, tmp_path_factory):
    """The "small" preset at Q4_K (kernels 1-3; ctx 512)."""
    path = str(tmp_path_factory.getbasetemp() / "item6-small-q4k.gguf")
    return build_synthetic_gguf(path, preset="small", quant=GGMLType.Q4_K)


@pytest.fixture
def engines(model):
    return [Engine.load(model, EngineConfig(weight_mode=mode),
                        device="cuda") for mode in ("quant", "dequant")]


@pytest.mark.cuda
def test_perplexity_on_graphs_quant_against_dequant(engines):
    """Three windows (the last a padded 100-token one) twice: the second
    pass replays every step, launches kernels 1-3 once each per step, and
    quant's NLL is within 2e-3 x max |logit| of dequant's."""
    quant, deq = engines
    ids = np.random.default_rng(0).integers(
        3, quant.runner.cfg.vocab_size, size=2 * 256 + 100).tolist()
    res = {}
    for label, eng in (("quant", quant), ("dequant", deq)):
        perplexity(eng.runner, ids, chunk=256)
        eng.runner.eager_steps = 0
        before = Q.launch_counts()
        res[label] = perplexity(eng.runner, ids, chunk=256)
        torch.cuda.synchronize()
        launched = Q.launch_counts(since=before)[0]
        assert eng.runner.eager_steps == 0
        if label == "quant":
            assert set(launched) == {"qmatmul_q4", "qmatmul_q8",
                                     "qmatmul_glu"}
            assert all(n % 3 == 0 for n in launched.values())
        else:
            assert not launched
    assert res["quant"].count == res["dequant"].count == 255 + 255 + 99
    r = deq.runner
    logits, _ = r.step([ids[:256]], [list(range(256))], [256],
                       r._make_kv(1), read_bound=256)
    limit = 2e-3 * logits.abs().max().item()
    assert abs(res["quant"].nll - res["dequant"].nll) <= limit


@pytest.mark.cuda
def test_prompt_cache_restores_on_graphs(engines):
    """A prompt, then the prompt and more: the second prefills only the new
    tokens, on graphs, with the uncached run's logits and tokens."""
    quant, _ = engines
    r = quant.runner
    eng = Engine(r, quant.tokenizer, EngineConfig(prompt_cache=True),
                 quant.gguf)
    plain = Engine(r, quant.tokenizer, EngineConfig(), quant.gguf)
    longer = TEXT + " And then?"
    for _ in range(2):  # the first pass captures
        eng.prompt_cache = PromptCache()
        r.eager_steps = 0
        a = eng.generate(TEXT, max_tokens=8, sampler=GREEDY)
        b = eng.generate(longer, max_tokens=8, sampler=GREEDY)
        assert r.eager_steps == 0
    assert eng.prompt_cache.stats.hits == 1
    assert a == plain.generate(TEXT, max_tokens=8, sampler=GREEDY)
    assert b == plain.generate(longer, max_tokens=8, sampler=GREEDY)
    kv = r.init_kv(1)
    ids = quant.tokenizer.encode(longer)
    shared = r.restore_prefix(eng.prompt_cache, ids, kv)
    assert shared == len(ids) - 1
    got = r.prefill(ids[shared:], kv, start_pos=shared, host=True)[0]
    want = r.prefill(ids, r.init_kv(1), host=True)[0]
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    assert r.eager_steps == 0


@pytest.mark.cuda
def test_batched_engines_one_after_another(engines):
    """Two BatchedEngines in turn on one runner of their own, the second
    with a prompt cache: the first's shutdown drops every graph of the
    runner's pool, and the second captures into a new one; the later
    requests hit."""
    quant, _ = engines
    r = ModelRunner(quant.runner.params, quant.runner.cfg, max_batch=4,
                    device="cuda")
    prompts = [TEXT] + [f"{TEXT} {w}" for w in ("Why?", "No.", "Then?")]
    runs = []
    for cache in (None, PromptCache()):
        be = BatchedEngine(r, quant.tokenizer, prompt_cache=cache)
        try:
            first = be.submit(prompts[0], max_tokens=8, sampler=GREEDY)
            first.text(timeout=300)
            rest = [be.submit(p, max_tokens=8, sampler=GREEDY)
                    for p in prompts[1:]]
            for h in rest:
                h.text(timeout=300)
        finally:
            be.shutdown()
        assert all(h.finish_reason in ("stop", "length")
                   for h in [first] + rest)
        runs.append([h.token_ids for h in [first] + rest])
    # the first request restores nothing: the same steps, the same tokens
    assert runs[0][0] == runs[1][0] and cache.stats.hits == 3
    assert r.eager_steps == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_format", ["f32", "bf16"])
def test_context_shift_on_graphs(engines, kv_format):
    """A 128-token window, 300 greedy tokens: every step replays a graph,
    before and after the shifts; quant tokens equal dequant's up to the
    first step whose top-2 margin is under 1e-3 x max |logit|."""
    picks = {}
    for eng in engines:
        r = ModelRunner(eng.runner.params, eng.runner.cfg, max_seq=128,
                        kv_format=kv_format, device=eng.runner.device)
        shifter = Engine(r, eng.tokenizer, EngineConfig(context_shift=True),
                         eng.gguf)
        shifts = []
        shift = r.shift_left
        r.shift_left = lambda kv, n, batch_idx=None: (
            shifts.append(n), shift(kv, n, batch_idx))
        sampler = _Recorder()
        shifter.generate(TEXT[:40], max_tokens=300, sampler=sampler)
        assert r.eager_steps == 0 and len(shifts) >= 2
        picks[eng.config.weight_mode] = sampler
    got, want = picks["quant"], picks["dequant"]
    ties = [i for i, m in enumerate(want.margins) if m < 1e-3]
    first = next((i for i, (x, y) in enumerate(zip(got.picks, want.picks))
                  if x != y), None)
    assert first is None or (ties and first >= ties[0])


class _Recorder:
    """A greedy sampler that records its picks and top-2 margins."""

    def __init__(self):
        self.picks, self.margins = [], []

    def sample(self, logits, history=None, mask=None):
        top2 = np.partition(logits, -2)[-2:]
        self.margins.append(float((top2[1] - top2[0]) /
                                  np.abs(logits).max()))
        self.picks.append(int(np.argmax(logits)))
        return self.picks[-1]


@pytest.mark.cuda
def test_cli_perplexity_json(model, tmp_path, capsys):
    f = tmp_path / "text.txt"
    f.write_text(TEXT * 8)
    out = {}
    for mode in ("quant", "dequant"):
        assert cli.main(["perplexity", model, "-f", str(f), "--chunk", "128",
                         "--weight-mode", mode, "--json"]) == 0
        out[mode] = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
    assert out["quant"]["tokens"] == out["dequant"]["tokens"] > 0
    assert np.isfinite(out["quant"]["ppl"]) and out["quant"]["ppl"] > 1
    # a coarse bound: the gate of 2e-3 x max |logit| is the test above
    assert abs(out["quant"]["nll"] - out["dequant"]["nll"]) < 1e-2
