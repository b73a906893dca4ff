"""The port's speculative decoding (engine/speculative.py) against the JAX
package's on the CPU.

Models: the JAX speculative tests' tiny qwen2 (tests/fixtures.make_tiny_model:
4 layers, vocab 288, seed 11) with a 1-layer draft of another seed, and the
JAX package's tiny-moe preset; F32, dequant mode in both packages. Each greedy
decoder (the target as its own draft, the early-exit self-draft, the other
draft model, prompt lookup) gives exactly JAX's tokens and JAX's
SpeculativeStats, and exactly the port's plain greedy tokens, on prompts
whose top-2 logit margin stays above 1e-4 at every plain greedy step (the
test checks that first). Sampled speculative decoding draws JAX's tokens
for the same seed. The port's tiny-gemma3 on a 256-slot ring, over a prompt
longer than the ring, equals plain greedy. Models with recurrent state are
refused, beside the JAX run whose self-draft parts from plain greedy.
"""

import numpy as np
import pytest
import torch

from fixtures import make_tiny_model
from llama_gguf_tpu import cli as jcli
from llama_gguf_tpu.engine import speculative as jspec
from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JEngineConfig
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSamplerConfig
from llama_gguf_tpu.utils.synthetic import build_synthetic_gguf

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.engine import speculative as tspec
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.runner import ModelRunner
from llama_gguf_tpu_torch.models.loader import load_model
from llama_gguf_tpu_torch.sampling.sampler import (Sampler, SamplerConfig)
from llama_gguf_tpu_torch.utils.synthetic import \
    build_synthetic_gguf as t_build

torch.set_num_threads(1)

MARGIN = 1e-4  # the least top-2 logit margin of a plain greedy step
PROMPTS = {"dense": [5, 17, 33, 2, 9, 40, 41, 7, 5, 17, 33],
           "moe": [3, 9, 27, 81, 243, 200, 9, 27, 4, 12]}
REPEAT = [7, 8, 9, 21, 7, 8, 9, 21, 7, 8]  # n-grams for prompt lookup


def _models(path):
    return (JEngine.load(path, JEngineConfig(weight_mode="dequant")),
            Engine.load(path, EngineConfig(weight_mode="dequant"),
                        device="cpu"))


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
    path, dpath = str(d / "tiny.gguf"), str(d / "draft.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=4,
                    heads=4, kv_heads=2, ffn=128, ctx=160, seed=11,
                    tokenizer=True)
    make_tiny_model(dpath, arch="qwen2", vocab=288, hidden=32, layers=1,
                    heads=2, kv_heads=1, ffn=64, ctx=160, seed=77,
                    tokenizer=True)
    return _models(path), _models(dpath)


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spec_moe") / "moe.gguf")
    build_synthetic_gguf(path, preset="tiny-moe", quant=GGMLType.F32)
    return _models(path), None


def plain_margins(runner, ids, steps):
    """The port's plain greedy tokens and each step's top-2 logit margin."""
    toks, margins = [], []
    logits, kv, pos = runner.prefill(ids, runner.init_kv(), host=True)
    for i in range(steps):
        top2 = np.partition(logits, -2)[-2:]
        margins.append(float(top2[1] - top2[0]))
        toks.append(int(np.argmax(logits)))
        if i + 1 < steps:
            logits, kv = runner.decode_one(toks[-1], pos, kv, host=True)
            pos += 1
    return toks, margins


def decoders(mod, pair, mode):
    """(JAX decoder, port decoder) of ``mode`` over the models of
    ``pair``."""
    (jt, tt), draft = pair
    if mode == "same":
        return (mod[0].SpeculativeDecoder(jt.runner, jt.runner, num_draft=4),
                mod[1].SpeculativeDecoder(tt.runner, tt.runner, num_draft=4))
    if mode == "self":
        return tuple(m.SpeculativeDecoder.self_speculative(
            e.runner, exit_layer=1, num_draft=3) for m, e in zip(mod, (jt, tt)))
    if mode == "draft":
        jd, td = draft
        return (mod[0].SpeculativeDecoder(jt.runner, jd.runner, num_draft=3),
                mod[1].SpeculativeDecoder(tt.runner, td.runner, num_draft=3))
    return tuple(m.PromptLookupDecoder(e.runner, num_draft=6)
                 for m, e in zip(mod, (jt, tt)))


def stats(s):
    return (s.rounds, s.drafted, s.accepted, s.bonus)


@pytest.mark.parametrize("model,mode", [
    ("dense", "same"), ("dense", "self"), ("dense", "draft"),
    ("dense", "lookup"), ("moe", "same"), ("moe", "self"),
    ("moe", "lookup")])
def test_greedy_decoders_match_jax(request, model, mode):
    pair = request.getfixturevalue(model)
    tt = pair[0][1]
    ids = REPEAT if mode == "lookup" else PROMPTS[model]
    n = 20
    plain, margins = plain_margins(tt.runner, ids, n)
    assert min(margins) > MARGIN, "the prompt has a near tie"
    jd, td = decoders((jspec, tspec), pair, mode)
    want = jd.generate_greedy(ids, n)
    got = td.generate_greedy(ids, n)
    assert got == want == plain
    assert stats(td.stats) == stats(jd.stats)
    assert td.stats.rounds > 0
    if mode == "same":
        assert td.stats.acceptance_rate == 1.0
    if (model, mode) == ("moe", "self"):  # rounds that accept, then reject
        assert 0 < td.stats.accepted < td.stats.drafted
    if mode == "lookup":
        assert td.stats.accepted > 0  # the n-grams were found
        assert td.stats.accepted + td.stats.bonus == len(got) - 1
    if mode != "lookup":
        assert td.generate_plain_greedy(ids, n) == plain


@pytest.mark.parametrize("model,mode,seed", [
    ("dense", "same", 0), ("dense", "self", 1), ("dense", "draft", 2),
    ("moe", "self", 3)])
def test_sampled_matches_jax(request, model, mode, seed):
    """The same seed draws the same tokens: the rng's draws come in JAX's
    order, and the probabilities agree to f32 rounding."""
    pair = request.getfixturevalue(model)
    jd, td = decoders((jspec, tspec), pair, mode)
    kw = dict(temperature=0.9, top_k=0, top_p=1.0, repetition_penalty=1.0)
    ids = PROMPTS[model]
    want = jd.generate_sampled(ids, 16, JSamplerConfig(**kw), seed=seed)
    got = td.generate_sampled(ids, 16, SamplerConfig(**kw), seed=seed)
    assert got == want
    assert stats(td.stats) == stats(jd.stats)
    if mode == "same":  # pt == pd: every draft is accepted
        assert td.stats.acceptance_rate == 1.0


def test_sampled_distribution_matches_direct(dense):
    """The JAX test on the port: the first sampled token's empirical
    distribution over 150 seeds is within 0.22 in total variation of the
    target's own (sampling noise at N = 150 over <= 8 tokens is ~0.09)."""
    tt = dense[0][1]
    ids = PROMPTS["dense"]
    cfg = SamplerConfig(temperature=1.0, top_k=8, top_p=1.0,
                        repetition_penalty=1.0)
    logits, _, _ = tt.runner.prefill(ids, tt.runner.init_kv(), host=True)
    probs = Sampler(cfg).probs(logits, ids)
    dec = tspec.SpeculativeDecoder(
        tt.runner, tspec.make_self_draft(tt.runner, 1), num_draft=3)
    counts = np.zeros(probs.shape[0], np.int64)
    trials = 150
    for s in range(trials):
        counts[dec.generate_sampled(ids, 1, cfg, seed=s)[0]] += 1
    tvd = 0.5 * np.abs(counts / trials - probs).sum()
    assert tvd < 0.22, tvd


@pytest.mark.parametrize("seed", range(6))
def test_propose_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jd = jspec.PromptLookupDecoder.__new__(jspec.PromptLookupDecoder)
    td = tspec.PromptLookupDecoder.__new__(tspec.PromptLookupDecoder)
    for _ in range(40):
        jd.max_ngram = td.max_ngram = int(rng.integers(1, 5))
        hist = rng.integers(0, 6, int(rng.integers(0, 40))).tolist()
        k = int(rng.integers(0, 10))
        assert td._propose(hist, k) == jd._propose(hist, k)
    td.max_ngram = 3
    assert td._propose([1, 7, 8, 9, 10, 2, 7, 8], 4) == [9, 10, 2, 7]
    assert td._propose([5, 1, 5, 6, 5], 2) == [6, 5]
    assert td._propose([1, 2, 3], 4) == [] == td._propose([4], 4)


def test_self_draft_aliases_the_weights(dense):
    runner = dense[0][1].runner
    draft = tspec.make_self_draft(runner, 2)
    assert draft.cfg.num_layers == 2 and len(draft.params["layers"]) == 2
    assert draft.params["layers"][0] is runner.params["layers"][0]
    assert draft.params["embed"].data_ptr() == runner.params["embed"].data_ptr()
    wt = runner.params["layers"][1]["attn"]
    wd = draft.params["layers"][1]["attn"]
    for key in wt:
        for a, b in ((wt[key], wd[key]),):
            ta = getattr(a, "weight", a)
            tb = getattr(b, "weight", b)
            if torch.is_tensor(ta):
                assert ta.data_ptr() == tb.data_ptr()
    assert draft is not runner and draft.cfg.max_seq_len == \
        runner.cfg.max_seq_len and draft.max_seq == runner.max_seq


def test_ring_model_equals_plain_greedy(tmp_path):
    """tiny-gemma3 (5 of 6 layers sliding, window 16) on a ring of 256
    slots, prompted past the ring: the ring rolls back by length, so every
    decoder equals plain greedy."""
    path = str(tmp_path / "g3.gguf")
    t_build(path, preset="tiny-gemma3", quant=GGMLType.F32)
    params, cfg, _ = load_model(path, mode="dequant", device="cpu")
    runner = ModelRunner(params, cfg, max_seq=2048, device="cpu",
                         swa_ring_extra=128)
    assert runner.ring_slots == 256
    ids = [int(t) for t in np.random.default_rng(5).integers(0, 512, 300)]
    ids += ids[-12:]  # an n-gram to look up
    n = 16
    plain, margins = plain_margins(runner, ids, n)
    assert min(margins) > MARGIN
    decs = [tspec.SpeculativeDecoder(runner, runner, num_draft=4),
            tspec.SpeculativeDecoder.self_speculative(runner, exit_layer=2),
            tspec.PromptLookupDecoder(runner, num_draft=6)]
    assert decs[1].draft.ring_slots == 256
    for dec in decs:
        assert dec.generate_greedy(ids, n) == plain
    assert decs[0].stats.acceptance_rate == 1.0


RECURRENT = {"tiny-qwen3next": "deltanet", "tiny-mamba2": "mamba2"}
JAX_DEFECT = [5, 17, 33, 2, 9, 40, 41, 7, 5, 17, 33]


@pytest.mark.parametrize("preset", sorted(RECURRENT))
def test_recurrent_models_refused(tmp_path, preset):
    """Rejected drafts advance a recurrent state that nothing rolls back, so
    the port refuses these models; the JAX self-draft on tiny-qwen3next
    (exit 2 of 4 layers) parts from plain greedy at token 5."""
    path = str(tmp_path / f"{preset}.gguf")
    t_build(path, preset=preset, quant=GGMLType.F32)
    tt = Engine.load(path, EngineConfig(weight_mode="dequant"), device="cpu")
    r = tt.runner
    for make in (lambda: tspec.SpeculativeDecoder(r, r),
                 lambda: tspec.SpeculativeDecoder.self_speculative(r, 2),
                 lambda: tspec.PromptLookupDecoder(r)):
        with pytest.raises(NotImplementedError,
                           match=f"{RECURRENT[preset]}.*ROADMAP queue 3"):
            make()
    assert cli.main(["run", path, "--self-speculative", "2", "-p", "hi",
                     "-n", "4", "-t", "0", "--device", "cpu"]) == 1
    if preset == "tiny-qwen3next":
        jt = JEngine.load(path, JEngineConfig(weight_mode="dequant"))
        dec = jspec.SpeculativeDecoder.self_speculative(jt.runner, 2, 4)
        plain = dec.generate_plain_greedy(JAX_DEFECT, 24)
        spec = dec.generate_greedy(JAX_DEFECT, 24)
        first = next(i for i, (a, b) in enumerate(zip(spec, plain))
                     if a != b)
        assert first == 4, (spec, plain)  # the fifth token


def test_decoder_without_a_runner_refused(dense):
    r = dense[0][1].runner
    for make in (lambda: tspec.SpeculativeDecoder(None, r),
                 lambda: tspec.SpeculativeDecoder(r, None),
                 lambda: tspec.PromptLookupDecoder(None)):
        with pytest.raises(NotImplementedError, match="encoder"):
            make()


@pytest.mark.parametrize("flags", [
    ["--self-speculative", "1", "-t", "0"],
    ["--prompt-lookup", "6", "-t", "0"],
    ["--self-speculative", "2", "--num-draft", "3", "-t", "0.8",
     "--seed", "4", "--top-k", "0", "--top-p", "1.0",
     "--repeat-penalty", "1.0"],
])
def test_cli_run_matches_jax(tmp_path, capsys, flags):
    path = str(tmp_path / "tiny.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=4,
                    heads=4, kv_heads=2, ffn=128, ctx=160, seed=11,
                    tokenizer=True)
    argv = ["run", path, "-p", "tok7 tok8 tok9 tok7 tok8 tok9 tok7",
            "-n", "12", "--weight-mode", "dequant"] + flags
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert jcli.main(argv) == 0
    want = capsys.readouterr()
    assert got.out == want.out
    assert "[speculative:" in got.err and "tok/round]" in got.err


def test_cli_run_with_a_draft_model(dense, tmp_path, capsys):
    path = str(tmp_path / "t.gguf")
    dpath = str(tmp_path / "d.gguf")
    make_tiny_model(path, arch="qwen2", vocab=288, hidden=64, layers=4,
                    heads=4, kv_heads=2, ffn=128, ctx=160, seed=11,
                    tokenizer=True)
    make_tiny_model(dpath, arch="qwen2", vocab=288, hidden=32, layers=1,
                    heads=2, kv_heads=1, ffn=64, ctx=160, seed=77,
                    tokenizer=True)
    argv = ["run", path, "--draft", dpath, "-p", "tok1 tok2", "-n", "10",
            "-t", "0", "--weight-mode", "dequant"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert got == capsys.readouterr().out
    # sampled prompt lookup keeps JAX's warning and decodes greedily
    assert cli.main(["run", path, "--prompt-lookup", "4", "-p", "tok1",
                     "-n", "4", "-t", "0.7", "--device", "cpu"]) == 0
    assert "greedy-only" in capsys.readouterr().err
