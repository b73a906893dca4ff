"""Whole runs: a sound run is correct, a run whose timed path is broken
underneath is not, a window that captures a graph voids the run, and (on
the card, at the cells' own sizes) the float8 control reads not correct.

The CPU tests skip run.py's look for a card and call ``run_cell`` on the
CPU (the port's plain path) with tiny configurations and mixes under
tests/tiny/, whose limit (mean gap 0.005) sits above the tiny sound runs'
readings (at most 0.0015 over 24 seeds) with room. At tiny widths the
router's near ties are common, so the float8 control's readings there
(0.0009-0.004) overlap the sound ones: the control is held at the cells'
own sizes, on the card (``test_the_control_is_not_correct_on_the_card``);
here it is only shown to be what ``correct`` judges. A four-chip fault
(the exchange between chips left out) has no cell here: every cell runs on
one card.
"""

import json
import os
import time

import numpy as np
import pytest

from conftest import BENCH, tiny
from h100bench.bench import WindowCaptured, run_cell

CELLS = [("tiny-mixtral", "tiny-closed"), ("tiny-moonlight", "tiny-closed")]


def _bench():
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = {"name": "tiny", "chips": 1}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            m.pop("workloads", None)
    return bench, cell


def _run(cfg, mix, seed, trace=False, control=False, fault=None,
         device="cpu", seconds=3.0):
    bench, cell = _bench()
    c = tiny(cfg) if isinstance(cfg, str) else cfg
    return run_cell(BENCH, bench, cell, c, tiny(mix), seed, seconds,
                    trace, device, time.monotonic(), control=control,
                    fault=fault)


@pytest.mark.parametrize("cfg,mix", CELLS)
def test_a_sound_run_is_correct(cfg, mix):
    res, compared = _run(cfg, mix, 2**31 + 11)
    assert res["correct"], compared
    assert [n for n, *_ in compared] == ["mean_gap"]
    assert all(v <= lim for _, v, lim in compared)
    assert list(res)[-1] == "check"
    m = res["metrics"]
    assert set(m) == {"output_tps", "ttft_p95_ms", "itl_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in m.values())
    assert res["attempted"] > 0 and res["failed"] <= res["attempted"]


def _kv_tensors(obj):
    import torch

    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _kv_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _kv_tensors(v)


def _state_unchanged(batched):
    """Every step returns the cache as it found it."""
    r = batched.runner
    step = r.step

    def broken(tokens, positions, lengths, kv, **kw):
        saved = [t.clone() for t in _kv_tensors(kv)]
        out = step(tokens, positions, lengths, kv, **kw)
        for t, s in zip(_kv_tensors(kv), saved):
            t.copy_(s)
        return out
    r.step = broken
    return lambda: r.__dict__.pop("step", None)


def _half_batch(batched):
    """The upper half of the batch rows is left out of every step."""
    r = batched.runner
    step = r.step

    def broken(tokens, positions, lengths, kv, **kw):
        b = np.shape(tokens)[0]
        positions = np.array(positions)
        positions[b // 2:] = r.max_seq
        return step(tokens, positions, lengths, kv, **kw)
    r.step = broken
    return lambda: r.__dict__.pop("step", None)


def _token_altered(batched):
    """Every third step, the first row's token is another than the
    logits put first."""
    r = batched.runner
    step = r.step
    calls = [0]

    def broken(tokens, positions, lengths, kv, **kw):
        out, kv = step(tokens, positions, lengths, kv, **kw)
        calls[0] += 1
        if kw.get("host_rows") and calls[0] % 3 == 0:
            out = out.copy()
            out[0, (int(out[0].argmax()) + 7) % out.shape[1]] = 1e9
        return out, kv
    r.step = broken
    return lambda: r.__dict__.pop("step", None)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered])
@pytest.mark.parametrize("cfg,mix", CELLS)
def test_a_broken_path_is_not_correct(cfg, mix, fault):
    # a window long enough that the compared sample spans the rows a fault
    # breaks even on a loaded host
    res, compared = _run(cfg, mix, 77, fault=fault, seconds=6.0)
    assert not res["correct"], compared


@pytest.mark.parametrize("cfg,mix", CELLS)
def test_the_control_is_what_correct_judges(cfg, mix):
    """With the control on, its own picks stand in the program's place and
    ``correct`` follows their reading: under a limit of 0 it is false."""
    c = tiny(cfg)
    c["check"] = dict.fromkeys(c["check"], 0.0)
    res, compared = _run(c, mix, 2**31 + 13, control=True)
    assert [n for n, *_ in compared] == ["mean_gap"]
    assert compared[0][1] > 0.0
    assert not res["correct"]
    assert res["check"]["mean_gap"]["value"] == compared[0][1]


def _captures_in_window(batched):
    """Every step of the window counts as a capture."""
    r = batched.runner
    step = r.step

    def capturing(*a, **kw):
        r.captures += 1
        return step(*a, **kw)
    r.step = capturing
    return lambda: r.__dict__.pop("step", None)


def test_a_capture_in_the_window_voids_the_run():
    with pytest.raises(WindowCaptured):
        _run("tiny-mixtral", "tiny-closed", 3, fault=_captures_in_window)


@pytest.mark.parametrize("cfg,mix", CELLS)
def test_the_dry_run_meets_every_key_of_the_window(cfg, mix, monkeypatch):
    """The keys the program's scheduler asks of the real runner in the
    primer, the warm-up and the window are all among the dry run's, met
    in the same order."""
    from h100bench import warm

    found, asked = [], []
    dry_keys = warm.dry_keys

    def recording_dry_keys(batched, *a):
        keys = dry_keys(batched, *a)
        found.extend(keys)
        r = batched.runner
        step = r.step

        def step_asked(tokens, positions, lengths, kv, read_bound=None,
                       **kw):
            asked.append((np.shape(tokens)[1], read_bound))
            return step(tokens, positions, lengths, kv,
                        read_bound=read_bound, **kw)
        r.step = step_asked
        return keys

    monkeypatch.setattr(warm, "dry_keys", recording_dry_keys)
    res, compared = _run(cfg, mix, 2**31 + 17)
    assert res["correct"], compared
    window = list(dict.fromkeys(asked[len(found):]))  # after the captures
    assert window and set(window) <= set(found)
    assert window == found[:len(window)]


def test_a_traced_run_reads_its_span_metrics():
    res, _ = _run("tiny-mixtral", "tiny-closed", 5, trace=True, seconds=6.0)
    m = res["metrics"]
    assert res["correct"]
    assert {"engine_host_ms.batch", "decode_step_ms.batch",
            "step_mfu.decode"} <= set(m)
    assert "output_tps" not in m
    assert 0 < m["step_mfu.decode"]["value"] < 100
    assert res["device"]["window_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mixtral-8x7b-l2.chat-c32",
                                      "moonlight-16b-a3b-l5.docqa-c16"])
def test_the_control_is_not_correct_on_the_card(workload, cuda_card):
    """The float8 reference in the program's place, at the cell's own size
    and load, reads over the cell's limit: the run reads not correct."""
    from h100bench.bench import cell_files

    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, cfg, spec = cell_files(BENCH, bench, workload)
    res, compared = run_cell(BENCH, bench, cell, cfg, spec, 4242, 15.0,
                             False, "cuda", time.monotonic(), control=True)
    got = {n: (v, lim) for n, v, lim in compared}
    assert got["mean_gap"][0] > got["mean_gap"][1], compared
    assert res["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,mix", CELLS)
def test_a_tiny_cell_on_the_card(cfg, mix, cuda_card):
    """The card's path: graphs captured before the window, the trace read,
    every roofline share under 100%."""
    res, compared = _run(cfg, mix, 9, trace=True, device="cuda",
                         seconds=3.0)
    assert res["correct"], compared
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["busy_s"] > 0
    assert res["breakdown"]["device_ops"]
    for name, v in res["metrics"].items():
        if name.startswith(("moe_roofline", "qmatmul_roofline", "step_mfu")):
            assert 0 < v["value"] <= 100, (name, v)
