"""LFM2-MoE on the port's normal path, and the row map over a short-conv
cache, on the CPU.

  * the port against bench_h100/reference/lfm2moe.py (the benchmark's plain
    float32 reference) at a tiny lfm2moe size: chunked prefill, then
    decode, through the runner's cache, against the reference's one pass;
  * the reference's conv and attention blocks against HF
    ``Lfm2ForCausalLM`` (dense FFN, every layer dense) at a tiny size;
  * the plain row-mapped conv (ops/shortconv.causal_conv_plain) against a
    row-by-row conv, with a launch's spare places repeating its first row;
  * the runner's launch plan on a short-conv cache against the whole grid's
    forward, a prefill launch padded with a repeat of its first row among
    it, and the BatchedEngine's tokens over the plan against single-stream
    greedy decoding, with the ``state_rows`` counter.

The reference imports nothing of the port; it is loaded from the benchmark's
directory as the benchmark loads it.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from llama_gguf_tpu_torch.engine import runner as trunner
from llama_gguf_tpu_torch.engine.batched import BatchedEngine
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig, \
    make_runner
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.models.loader import load_model
from llama_gguf_tpu_torch.models.transformer import forward
from llama_gguf_tpu_torch.ops import shortconv as SC
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_h100")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from h100bench import ggml, weights  # noqa: E402
from h100bench.check import reference_model  # noqa: E402
from reference import lfm2moe  # noqa: E402

GREEDY = SamplerConfig(temperature=0.0, repetition_penalty=1.0)
# float32 on both sides, sums in another order (the port's products and its
# cached attention against the reference's one pass): ~1e-6 of the logits'
# largest value; the float8 control sits 1e5 times above it, so a product
# computed one precision step lower would not pass
REF_TOL = 2e-5
MAX_SEQ = 512


def _tiny_cfg():
    with open(os.path.join(BENCH, "tests", "tiny", "tiny-lfm2moe.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    cfg = _tiny_cfg()
    md, tensors = weights.make(cfg, lfm2moe, 7, "cpu")
    path = str(tmp_path_factory.mktemp("lfm2moe") / "tiny.gguf")
    ggml.write_gguf(path, md, tensors)
    return cfg, path, tensors


@pytest.mark.parametrize("mode", ["dequant", "quant"])
def test_chunked_prefill_then_decode_matches_the_reference(tiny_gguf, mode):
    """The prompt in chunks of 32 (the last one padded), then single-token
    decode steps, on one row of a 2-row cache, against the reference's
    logits at every position; the loader reads the per-layer
    head_count_kv, the sigmoid gating and NEOX RoPE of lfm2moe."""
    cfg, path, tensors = tiny_gguf
    params, mcfg, _ = load_model(path, mode=mode, device="cpu")
    assert mcfg.layer_kinds == ("shortconv",) * 2 + ("attn",) + \
        ("shortconv",) * 3
    assert (mcfg.num_kv_heads, mcfg.expert_gating_func) == (2, 2)
    assert mcfg.rope.rope_type.value == "neox"
    runner = make_runner(params, mcfg, EngineConfig(
        max_context_len=MAX_SEQ, max_batch=2), "cpu")
    kv = runner.init_kv(2)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, cfg["vocab_size"], 80).tolist()
    prompt, chunk = 70, 32
    got = []
    for s in range(0, prompt, chunk):
        n = min(chunk, prompt - s)
        toks = np.zeros((2, chunk), np.int32)
        pos = np.full((2, chunk), MAX_SEQ, np.int32)
        toks[1, :n], pos[1, :n] = ids[s:s + n], np.arange(s, s + n)
        lens = np.array([0, s + n], np.int32)
        out, kv = runner.step(toks, pos, lens, kv)
        got.append(out[1, :n].float())
    for p in range(prompt, len(ids)):
        out, kv = runner.step(np.array([[0], [ids[p]]], np.int32),
                              np.array([[MAX_SEQ], [p]], np.int32),
                              np.array([0, p + 1], np.int32), kv)
        got.append(out[1, :1].float())
    got = torch.cat(got)
    model = reference_model(cfg, tensors, "cpu")
    ref = model.logits(ids, 0)
    scale = float(ref.abs().max())
    assert scale > 0.1
    assert float((got - ref).abs().max()) <= REF_TOL * scale
    ctl = model.logits(ids, 0, fp8=True)
    assert float((ctl - ref).abs().max()) > 100 * REF_TOL * scale


def test_reference_blocks_match_hf_lfm2(tmp_path):
    """The reference's conv and attention blocks (every layer's FFN dense)
    against HF's Lfm2ForCausalLM, with weights large enough that the
    attention scores, and so RoPE, move the logits well above the
    tolerance."""
    from transformers import Lfm2Config, Lfm2ForCausalLM

    kinds = ["conv", "conv", "full_attention", "conv"]
    hf_cfg = Lfm2Config(
        vocab_size=96, hidden_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=96,
        layer_types=kinds, conv_L_cache=3, conv_bias=False,
        rope_theta=10000.0, norm_eps=1e-5, max_position_embeddings=128,
        tie_word_embeddings=False, pad_token_id=0, bos_token_id=1,
        eos_token_id=2)
    torch.manual_seed(11)
    model = Lfm2ForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(1.0 + 0.1 * torch.randn_like(p))
            else:
                p.copy_(0.15 * torch.randn_like(p))
    sd = {k: v.float() for k, v in model.state_dict().items()}
    w = {"token_embd.weight": sd["model.embed_tokens.weight"],
         "token_embd_norm.weight": sd["model.embedding_norm.weight"],
         "output.weight": sd["lm_head.weight"]}
    for i, kind in enumerate(kinds):
        p, h = f"blk.{i}", f"model.layers.{i}"
        w[f"{p}.attn_norm.weight"] = sd[f"{h}.operator_norm.weight"]
        w[f"{p}.ffn_norm.weight"] = sd[f"{h}.ffn_norm.weight"]
        for ours, theirs in (("ffn_gate", "w1"), ("ffn_up", "w3"),
                             ("ffn_down", "w2")):
            w[f"{p}.{ours}.weight"] = sd[f"{h}.feed_forward.{theirs}.weight"]
        if kind == "conv":
            for part in ("in_proj", "out_proj"):
                w[f"{p}.shortconv.{part}.weight"] = \
                    sd[f"{h}.conv.{part}.weight"]
            w[f"{p}.shortconv.conv.weight"] = sd[f"{h}.conv.conv.weight"][:, 0]
            continue
        for ours, theirs in (("attn_q", "q_proj"), ("attn_k", "k_proj"),
                             ("attn_v", "v_proj"),
                             ("attn_output", "out_proj"),
                             ("attn_q_norm", "q_layernorm"),
                             ("attn_k_norm", "k_layernorm")):
            w[f"{p}.{ours}.weight"] = sd[f"{h}.self_attn.{theirs}.weight"]
    cfg = {"hidden_size": 64, "num_attention_heads": 4,
           "num_key_value_heads": 2, "norm_eps": 1e-5,
           "rope_parameters": {"rope_theta": 10000.0},
           "layer_types": kinds, "num_hidden_layers": 4,
           "num_dense_layers": 4}
    ids = np.random.default_rng(5).integers(0, 96, 40).tolist()
    with torch.no_grad():
        want = model(torch.tensor([ids])).logits[0]
        unroped = model(torch.tensor([ids]), position_ids=torch.zeros(
            1, len(ids), dtype=torch.long)).logits[0]
        got = lfm2moe.Model(cfg, w).logits(ids, 0)
    scale = float(want.abs().max())
    # f32 both, other orders of summation: ~1e-6 of the largest logit
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((unroped - want).abs().max()) > 1e3 * 1e-5 * scale


def _conv_by_row(x, state, w, bias, n_valid, rows):
    """The conv one input row at a time, each real row's window written
    after every row has read its own."""
    out, writes = [], []
    t = x.shape[1]
    for g in range(x.shape[0]):
        r = int(rows[g])
        seq = torch.cat([state[r], x[g]], 0)
        o = seq[0:t] * w[0]
        for k in range(1, w.shape[0]):
            o = o + seq[k:k + t] * w[k]
        out.append(o if bias is None else o + bias)
        n = int(n_valid[g])
        if n > 0:
            writes.append((r, seq[n:n + state.shape[1]].clone()))
    for r, win in writes:
        state[r] = win
    return torch.stack(out)


@pytest.mark.parametrize("taps,bias", [(3, False), (4, True)])
def test_row_mapped_conv_by_row(taps, bias):
    """Three real rows and a spare place repeating the first (no valid
    token): outputs and windows equal the row-by-row conv bit for bit, the
    shared cache row takes the real row's window, and the rows no input
    row maps to keep theirs."""
    gen = torch.Generator().manual_seed(taps)
    b, c, t = 6, 40, 9
    state = torch.randn(b, taps - 1, c, generator=gen)
    w = torch.randn(taps, c, generator=gen)
    bb = torch.randn(c, generator=gen) if bias else None
    rows = torch.tensor([4, 1, 2, 4], dtype=torch.int32)
    n_valid = torch.tensor([9, 1, 5, 0], dtype=torch.int32)
    x = torch.randn(4, t, c, generator=gen)
    x[torch.arange(t)[None, :] >= n_valid[:, None]] = 0.0
    want_state = state.clone()
    want = _conv_by_row(x, want_state, w, bb, n_valid, rows)
    got_state = state.clone()
    got = SC.causal_conv(x, got_state, w, bb, n_valid, rows)
    assert torch.equal(got, want)
    assert torch.equal(got_state, want_state)
    assert not torch.equal(got_state[4], state[4])
    for r in (0, 3, 5):
        assert torch.equal(got_state[r], state[r])
    # the identity map: a row with no valid token keeps its window
    ident = state.clone()
    SC.causal_conv(torch.zeros(b, 1, c), ident, w, bb,
                   torch.tensor([1, 0, 1, 0, 0, 1], dtype=torch.int32))
    assert all(torch.equal(ident[r], state[r]) for r in (1, 3, 4))
    assert not torch.equal(ident[0], state[0])


@pytest.fixture(scope="module")
def lfm2_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lfm2") / "tiny-lfm2.gguf")
    build_synthetic_gguf(path, preset="tiny-lfm2", quant=GGMLType.Q4_K)
    return path


def _rows_inputs(rows, bt, vocab):
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


def test_planned_step_on_a_short_conv_cache(lfm2_path):
    """B = 5 at T = 256 (G = 2): chunk rows 0, 2 and 3 go in two prefill
    launches, the second padded with a repeat of row 3; row 1 rides the
    decode launch, row 4 is empty. The picked rows' logits and every live
    row's conv window equal the whole grid's forward; the repeated row's
    window is the real row's new one, the empty row's is bit-unchanged,
    and state_rows counts the three chunk rows."""
    params, cfg, _ = load_model(lfm2_path, device="cpu")
    r = trunner.ModelRunner(params, cfg, max_batch=5, max_seq=MAX_SEQ,
                            device="cpu")
    kv = r.init_kv()
    gen = torch.Generator().manual_seed(2)
    for key in ("k", "v"):
        for t in kv[key]:
            t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
    for t in kv["mamba"]["conv"]:
        t.copy_(torch.randn(t.shape, generator=gen))
    rows = [("chunk", 0, 200), ("decode", 30), ("chunk", 20, 150),
            ("chunk", 100, 90), None]
    toks, pos, lens, lp = _rows_inputs(rows, 256, cfg.vocab_size)
    assert trunner.launch_rows(256) == 2
    before = [t.clone() for t in kv["mamba"]["conv"]]
    ref = copy.deepcopy(kv)
    with torch.no_grad():
        want, _ = forward(r.params, r.cfg, torch.from_numpy(toks),
                          torch.from_numpy(pos), ref, torch.from_numpy(lens),
                          read_bound=512, logit_positions=torch.from_numpy(lp),
                          precision=r.matmul_precision)
    picked = [0, 1, 2, 3]
    got, kv = r.step(toks, pos, lens, kv, read_bound=512, logit_positions=lp,
                     host_rows=picked)
    assert r.last_launch == {"prefill_launches": 2,
                             "rows_launched": 2 * 2 * 256 + 5,
                             "state_rows": 3}
    want = want[picked, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * np.abs(want).max())
    convs = [i for i, k in enumerate(cfg.layer_kinds) if k == "shortconv"]
    for i in convs:
        t, w, b0 = kv["mamba"]["conv"][i], ref["mamba"]["conv"][i], before[i]
        # the windows are B*x products of another row count: f32 rounding
        np.testing.assert_allclose(t[:4].numpy(), w[:4].numpy(), rtol=0,
                                   atol=1e-5 * float(w[:4].abs().max()))
        assert not torch.equal(t[3], b0[3])
        assert torch.equal(t[4], b0[4])


def test_batched_engine_over_the_plan_equals_single_stream(lfm2_path):
    """B = 8 and chunks of 128 (G = 4): prompts of up to 200 tokens
    prefill through the plan beside decode rows. Each request's tokens
    equal the single-stream engine's greedy tokens, and state_rows counts
    the chunk rows of the planned steps."""
    eng = Engine.load(lfm2_path, EngineConfig(
        weight_mode="quant", max_batch=8), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 500, size=n).tolist()
               for n in (200, 20, 170, 9, 150, 140, 60)]
    want = [eng.greedy_tokens(p, 5) for p in prompts]
    r = eng.runner
    step, seen = r.step, []

    def logged(tokens, positions, *a, **kw):
        out = step(tokens, positions, *a, **kw)
        seen.append((np.array(positions), r.last_launch))
        return out

    be = BatchedEngine(r, eng.tokenizer, prefill_chunk=128)
    r.step = logged
    try:
        handles = [be.submit(p, max_tokens=5, sampler=GREEDY)
                   for p in prompts]
        for h in handles:
            h.text(timeout=300)
    finally:
        be.shutdown()
        del r.step
    for w, h in zip(want, handles):
        eog = [i for i, t in enumerate(w) if eng.tokenizer.is_eog(t)]
        assert h.token_ids == w[:eog[0] if eog else len(w)]
    chunk_rows = sum(int((p[:, 1:] < r.max_seq).any(1).sum())
                     for p, _ in seen
                     if trunner.launch_rows(p.shape[1]) < p.shape[0])
    assert chunk_rows > 0
    assert be.stats.state_rows == sum(a["state_rows"] for _, a in seen) \
        == chunk_rows
