"""One run of one cell: set-up, the window, the metrics and the check."""

from __future__ import annotations

import bisect
import gc
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from . import check, endtoend, ggml, layers, serve, warm, weights
from .kernels import label
from .trace import Profile
from .traffic import Traffic
from .work import ModelWork, total

END_TO_END = {
    "output_tps": endtoend.output_tps,
    "ttft_p95_ms": endtoend.ttft_p95_ms,
    "itl_p95_ms": endtoend.itl_p95_ms,
}


class WindowCaptured(RuntimeError):
    """A graph was captured inside the measured window: the run is void."""


def log(msg: str) -> None:
    print(f"[bench_h100] {msg}", file=sys.stderr, flush=True)


def cell_files(root: str, bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of workload ``name``."""
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    top = os.path.dirname(root)
    with open(os.path.join(top, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "traffic", f"{cell['traffic']}.json")) as f:
        spec = json.load(f)
    return cell, cfg, spec


def cell_metrics(bench: dict, cell: dict, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics this cell
    reports."""
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def breakdown(trace, top: int = 10) -> dict:
    """The device ops that took most time, and the idle gaps by what the
    host was doing (the harness's annotations around each gap's middle)."""
    by = {}
    for name, a, b in trace.ops:
        key = label(name)
        by[key] = by.get(key, 0.0) + (b - a) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    steps = sorted((a, b) for n, a, b in trace.notes
                   if n.startswith("bench.step."))
    eng = sorted((a, b) for n, a, b in trace.notes if n == "bench.engine")

    def inside(spans, t):
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]

    names = ("runner.step: inputs, replay launch, logit copy",
             "scheduler: admit, build, sample, emit",
             "scheduler waiting for a request")
    totals = dict.fromkeys(names, 0.0)
    longest = []
    for a, b in trace.gaps():
        m = (a + b) / 2
        n = names[0] if inside(steps, m) else names[1] if inside(eng, m) \
            else names[2]
        totals[n] += (b - a) / 1e6
        longest.append(((b - a) / 1e6, n))
    gaps = [[n, s] for n, s in totals.items() if s > 0]
    gaps += [[f"longest gap: {n}", s]
             for s, n in sorted(longest, reverse=True)[:top - len(gaps)]]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}


def run_cell(root: str, bench: dict, cell: dict, cfg: dict, spec: dict,
             seed: int, seconds: float, trace: bool, device: str,
             t_start: float, control: bool = False, fault=None
             ) -> tuple[dict, list]:
    """Run ``cell`` (its configuration ``cfg``, its traffic ``spec``) once.
    Returns (the result line's object, the compared numbers as (name,
    value, limit)). ``fault`` (tests only) is called on the BatchedEngine
    before the window, to break its path; it returns an undo or None."""
    family = importlib.import_module(f"reference.{cfg['family']}")
    dev = torch.device(device)
    t = time.monotonic()
    md, tensors = weights.make(cfg, family, seed, dev)
    fd, path = tempfile.mkstemp(suffix=".gguf")
    os.close(fd)
    try:
        nbytes = ggml.write_gguf(path, md, tensors)
        log(f"weights {weights.weight_bytes(tensors)} B, GGUF {nbytes} B in "
            f"{time.monotonic() - t:.2f} s")
        t = time.monotonic()
        engine, batched = serve.load(path, spec, dev)
        log(f"load {time.monotonic() - t:.2f} s")
        result, compared = _serve(root, bench, cell, cfg, spec, family,
                                  tensors, engine, batched, seed, seconds,
                                  trace, dev, t_start, control, fault)
    finally:
        os.unlink(path)
    return result, compared


def _serve(root, bench, cell, cfg, spec, family, tensors, engine, batched,
           seed, seconds, trace, dev, t_start, control, fault):
    vocab = cfg["vocab_size"]
    runner = batched.runner
    t = time.monotonic()
    keys = warm.dry_keys(batched, spec, seed, vocab)
    t_dry = time.monotonic()
    warm.capture(batched, keys)
    log(f"dry run: {len(keys)} graph keys in {t_dry - t:.2f} s; captured "
        f"in {time.monotonic() - t_dry:.2f} s ({runner.captures} captures)")
    profile = Profile() if trace else None
    spans = serve.Spans() if trace else None
    drv = serve.Window(batched, Traffic(spec, seed, vocab), spec, seconds,
                       profile, spans)
    undo = [drv.install()]
    if trace:
        undo.append(drv.wrap_spans())
    if fault is not None:
        undo.append(fault(batched))
    try:
        drv.run()
    finally:
        for u in reversed(undo):
            if u is not None:
                u()
    t0, t1 = drv.t0, drv.t_end
    setup_s = t0 - t_start
    recs = drv.recs
    st = batched.stats
    pure = st.decode_steps - st.mixed_steps
    log(f"setup_s {setup_s:.3f}; window {t1 - t0:.3f} s; captures in the "
        f"window {drv.window_captures} (of {runner.captures}); backlog "
        f"{drv.backlog[0]} -> {drv.backlog[1]}; engine: {pure} pure-decode "
        f"steps at {1e3 * st.decode_time / max(pure, 1):.3f} ms "
        f"(runner.step), {st.mixed_steps} mixed, {st.prefill_tokens} "
        f"prefill tokens, {st.completed} completed")
    if drv.window_captures:
        raise WindowCaptured(
            f"{drv.window_captures} CUDA graph captures inside the window: "
            f"the dry run of {spec['horizon_steps']} steps missed a key the "
            f"window used (a window of more steps needs a longer horizon)")
    due = endtoend.due_in_window(recs, t0, t1)
    failed = endtoend.failed(recs, t0, t1)
    ttfts = [endtoend.ttft_ms(r) for r in due]
    log("ttft ms p50/p90/p95/p99/max " + " / ".join(
        f"{endtoend.quantile(ttfts, q):.1f}" for q in (.5, .9, .95, .99, 1.)))
    aborted = [r for r in recs if r.reason in ("error", "aborted")
               and r.finished is not None and r.finished < drv.shutdown_at]
    cuda = dev.type == "cuda"
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell["chips"],
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
              if cuda else 0}
    metrics = {}
    if not trace:
        for m in cell_metrics(bench, cell, "end_to_end"):
            if m["name"] == "setup_s":
                v = setup_s
            else:
                v = END_TO_END[m["name"]](recs, t0, t1)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    extra = {}
    if trace:
        work = ModelWork(cfg, family)
        tr = profile.read() if profile.prof is not None else None
        ctx = layers.Context(spans, (t0, t1), tr, profile, work)
        for kind, sel in (("decode", lambda s: s.bt == 1),
                          ("prefill", lambda s: s.bt > 1)):
            ws = [s for s in ctx.window_steps if sel(s)]
            hs = [s.host_s for s in ws if s.host_s is not None]
            if ws:
                w = total(work.step(ws[0].rows, ws[0].head_rows))
                log(f"window {kind} steps {len(ws)}: wall "
                    f"{1e3 * sum(s.wall_s for s in ws) / len(ws):.3f} ms, "
                    f"host {1e3 * sum(hs) / max(len(hs), 1):.3f} ms, rows "
                    f"{sum(len(s.rows) for s in ws) / len(ws):.1f}; the "
                    f"first's bound {1e3 * w.bound_s:.4f} ms by {w.binds}")
        if tr is not None:
            log(f"trace: {len(tr.ops)} device ops, {len(tr.notes)} notes, "
                f"{len(ctx.traced_steps())} steps attributed, busy "
                f"{tr.busy_s:.4f} of {tr.window_s:.4f} s")
        for m in cell_metrics(bench, cell, "per_layer"):
            v = layers.load_reader(root, m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None:
            device["busy_s"] = tr.busy_s
            device["window_s"] = tr.window_s
            extra["breakdown"] = breakdown(tr)
    if cuda:
        log(f"card {power_limit()}; peaks 989 TFLOP/s bf16, 3.35 TB/s")
    # the check: the program's state freed first, then the reference
    sampled = check.sample(recs, drv.traffic.check_rng,
                           spec["check"]["min_tokens"],
                           spec["check"]["max_requests"])
    drv.batched = batched = engine = runner = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.monotonic()
    model = check.reference_model(cfg, tensors, dev)
    limits = cfg["check"]
    # the control: the float8 reference's own picks judged in the program's
    # place, by the same numbers and limits
    got = check.readings(check.gaps(model, sampled, control=control))
    compared = [(n, v, float(limits[n])) for n, v in got.items()
                if n in limits]
    served = sum(len(r.tokens) for r in sampled)
    log(f"reference over {len(sampled)} requests, {served} served tokens, "
        f"in {time.monotonic() - t:.2f} s{' (the control judged)' * control}"
        f"; widest gap {got['widest_gap']!r}, worst request's mean gap "
        f"{got['worst_request_gap']!r} (reported only)")
    short = [r for r in sampled if len(r.tokens) != r.req.max_tokens]
    within = all(v <= lim for _, v, lim in compared)
    correct = (bool(sampled) and within and not short
               and not aborted and failed == sum(r.refused for r in due))
    result = {"correct": correct, "attempted": len(due), "failed": failed,
              "metrics": metrics, "device": device, **extra,
              "check": {n: {"value": v, "limit": lim}
                        for n, v, lim in compared}}
    return result, compared
