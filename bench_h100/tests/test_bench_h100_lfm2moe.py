"""The lfm2moe family (reference/lfm2moe.py) and its cell's readers: the
GGUF layout, the attention and short-conv reckoning by hand, the reference
against the port's plain path, and tiny CPU runs of a hybrid cell whose
mixed steps take the runner's plan (tests/tiny/tiny-lfm2moe.json under
tests/tiny/tiny-multiturn.json: 8 rows, chunks of 128, so G = 4 < 8), sound
and traced, and on the card the control at the cell's own size."""

import json
import os
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, tiny
from h100bench import ggml, layers, weights
from h100bench.bench import run_cell
from h100bench.work import ModelWork, total

from reference import lfm2moe

NEW = ("mixed_step_ms.lfm2", "grid_fill.lfm2", "shortconv_roofline.lfm2",
       "moe_roofline.lfm2", "step_mfu.lfm2")


def _cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_layout_of_the_cell():
    """40 -> 12 layers: dense 0-1, MoE 2-11, attention at 2, 6 and 10; the
    per-layer head_count_kv; every tensor's format by the Q4_K_M mix."""
    cfg = _cfg("lfm2-24b-a2b-l12")
    md, specs = lfm2moe.layout(cfg)
    assert md["general.architecture"] == "lfm2moe"
    assert md["lfm2moe.attention.head_count_kv"].tolist() == \
        [0, 0, 8, 0, 0, 0, 8, 0, 0, 0, 8, 0]
    by = {name: (shape, fmt, init) for name, shape, fmt, init in specs}
    assert by["blk.0.ffn_gate.weight"] == ((11776, 2048), ggml.Q4_K, "quant")
    assert by["blk.1.ffn_down.weight"] == ((2048, 11776), ggml.Q6_K, "quant")
    assert "blk.2.ffn_gate.weight" not in by
    assert by["blk.2.ffn_gate_exps.weight"] == ((64, 1536, 2048), ggml.Q4_K,
                                                "quant")
    assert by["blk.11.ffn_down_exps.weight"] == ((64, 2048, 1536), ggml.Q6_K,
                                                 "quant")
    assert by["blk.5.exp_probs_b.bias"] == ((64,), 0, "bias")
    assert by["blk.6.attn_q.weight"] == ((2048, 2048), ggml.Q4_K, "quant")
    assert by["blk.6.attn_k.weight"] == ((512, 2048), ggml.Q4_K, "quant")
    assert by["blk.6.attn_k_norm.weight"] == ((64,), 0, "norm")
    assert by["blk.7.shortconv.in_proj.weight"] == ((6144, 2048), ggml.Q4_K,
                                                    "quant")
    assert by["blk.7.shortconv.conv.weight"] == ((2048, 3), 0, "norm")
    assert by["output.weight"] == ((65536, 2048), ggml.Q6_K, "quant")
    assert sum(n.endswith("shortconv.conv.weight") for n in by) == 9
    assert sum(n.endswith("attn_q.weight") for n in by) == 3
    # about 4.4 GB of GGUF: 10 MoE layers at ~0.39 GB and the rest
    nbytes = sum(ggml.block_bytes(ggml.pick_format(fmt, shape[-1]),
                                  int(np.prod(shape))) if init == "quant"
                 else 4 * int(np.prod(shape))
                 for shape, fmt, init in by.values())
    assert 4.2e9 < nbytes < 4.6e9


def test_work_reckoned_by_hand():
    cfg = _cfg("lfm2-24b-a2b-l12")
    w = ModelWork(cfg, lfm2moe)
    # a decode step of 48 rows, each one token after 999 cached ones
    parts = w.step([(1, 999)] * 48, 48)
    assert parts["experts"].flops == 2 * 48 * 4 * 3 * 2048 * 1536 * 10
    # attention: three layers, 32 heads of 64 over 8 KV heads
    assert parts["attention"].flops == 3 * 2 * 48 * 1000 * 32 * 2 * 64
    assert parts["attention"].nbytes == \
        3 * (48 * 1000 * 2 * 8 * 64 * 2 + 48 * 2 * 32 * 64 * 2)
    # the short conv: nine conv layers, 3 taps over 2048 channels
    f, b = lfm2moe.shortconv_work(cfg, [(1, 999)] * 48)
    assert f == 9 * 2 * 3 * 48 * 2048
    assert b == 9 * (2 * 48 * 2048 * 4 + 2 * 48 * 2 * 2048 * 4 + 3 * 2048 * 4)
    # a 512-token chunk and an empty row: one real row's window
    f, b = lfm2moe.shortconv_work(cfg, [(512, 0), (0, 0)])
    assert b == 9 * (2 * 512 * 2048 * 4 + 2 * 2 * 2048 * 4 + 3 * 2048 * 4)
    assert total(parts).binds == "bytes"


def test_reference_equals_the_ports_plain_path(tmp_path):
    from h100bench.check import reference_model
    from llama_gguf_tpu_torch.engine.engine import EngineConfig, make_runner
    from llama_gguf_tpu_torch.models.loader import load_model

    cfg = tiny("tiny-lfm2moe")
    md, tensors = weights.make(cfg, lfm2moe, 5, "cpu")
    path = str(tmp_path / "m.gguf")
    ggml.write_gguf(path, md, tensors)
    params, mcfg, _ = load_model(path, mode="quant", device="cpu")
    runner = make_runner(params, mcfg, EngineConfig(max_context_len=256),
                         "cpu")
    ids = np.random.default_rng(1).integers(3, cfg["vocab_size"], 70)
    t = len(ids)
    got, _ = runner.step(ids[None].astype(np.int32),
                         np.arange(t, dtype=np.int32)[None],
                         np.array([t], np.int32), runner.init_kv(1))
    ref = reference_model(cfg, tensors, "cpu").logits(ids.tolist(), 0)
    scale = float(ref.abs().max())
    assert float((got[0].float() - ref).abs().max()) <= 2e-5 * scale
    assert scale > 0.1


def _run(seed, trace=False, control=False, device="cpu", seconds=4.0):
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            m.pop("workloads", None)
    made = []

    class Recorded(layers.Context):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    orig, layers.Context = layers.Context, Recorded
    try:
        res, compared = run_cell(BENCH, bench, {"name": "tiny", "chips": 1},
                                 tiny("tiny-lfm2moe"),
                                 tiny("tiny-multiturn"), seed, seconds,
                                 trace, device, time.monotonic(),
                                 control=control)
    finally:
        layers.Context = orig
    return res, compared, made


def test_a_sound_hybrid_run_is_correct():
    res, compared, _ = _run(2**31 + 23)
    assert res["correct"], compared
    assert res["attempted"] > 0


def test_a_traced_hybrid_run_reads_its_metrics(capfd):
    """The planned mixed steps carry the chunk rows' conv windows:
    grid_fill.lfm2 above the whole grid's share, and state_rows equal to
    the planned steps' chunk rows. On the CPU no kernel runs, so the
    roofline share reads nothing."""
    res, compared, made = _run(2**31 + 29, trace=True, seconds=6.0)
    assert res["correct"], compared
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert {"mixed_step_ms.lfm2", "grid_fill.lfm2", "step_mfu.lfm2"} <= set(m)
    assert "shortconv_roofline.lfm2" not in m
    ctx = made[0]
    pre = [s for s in ctx.window_steps if s.bt > 1]
    grid = 100.0 * sum(n for s in pre for n, _ in s.rows) / \
        sum(8 * s.bt for s in pre)
    assert m["grid_fill.lfm2"] > grid
    line = [x for x in capfd.readouterr().err.splitlines()
            if "state_rows" in x]
    assert line, "the reader reports the counter"
    words = line[-1].split()
    carried, chunk = int(words[2]), int(words[4])
    assert carried == chunk > 0


def test_the_short_conv_reader_by_hand():
    """Two traced steps, the kernel's ops inside their notes (and one
    outside any): the bound of each step's work over the kernel's time."""
    from types import SimpleNamespace

    from h100bench.trace import Trace

    cfg = tiny("tiny-lfm2moe")
    steps = [layers.Step(0, 0.0, 1.0, 1, ((1, 10), (1, 20)), 2),
             layers.Step(1, 1.0, 2.0, 128, ((128, 0),), 1)]
    tr = Trace(ops=[("void short_conv_kernel<3>(x)", 10.0, 14.0),
                    ("void qgemm_tc<0>(x)", 15.0, 30.0),
                    ("void short_conv_kernel<3>(x)", 110.0, 130.0),
                    ("void short_conv_kernel<3>(x)", 300.0, 400.0)],
               notes=[("bench.step.0", 0.0, 100.0),
                      ("bench.step.1", 100.0, 200.0)], window_s=1.0)
    ctx = SimpleNamespace(trace=tr, steps=steps,
                          work=ModelWork(cfg, lfm2moe))
    reader = layers.load_reader(BENCH, "shortconv_roofline.lfm2")
    from h100bench.work import Work

    bound = sum(Work(*lfm2moe.shortconv_work(cfg, s.rows)).bound_s
                for s in steps)
    assert reader.read(ctx) == pytest.approx(100.0 * bound / 24e-6)
    ctx.work = ModelWork(tiny("tiny-mixtral"),
                         __import__("reference.mixtral").mixtral)
    assert reader.read(ctx) is None


@pytest.mark.cuda
def test_the_hybrid_control_is_not_correct_on_the_card(cuda_card):
    """The float8 reference in the program's place at the cell's own size
    and load reads over the cell's limit."""
    from h100bench.bench import cell_files

    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, cfg, spec = cell_files(BENCH, bench,
                                 "lfm2-24b-a2b-l12.multiturn-c48")
    res, compared = run_cell(BENCH, bench, cell, cfg, spec, 4243, 15.0,
                             False, "cuda", time.monotonic(), control=True)
    got = {n: (v, lim) for n, v, lim in compared}
    assert got["mean_gap"][0] > got["mean_gap"][1], compared
    assert res["correct"] is False
    torch.cuda.empty_cache()
