#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Device: requires CUDA; prints the card's name and power limit; builds the
   CUDA kernels from llama_gguf_tpu_torch/csrc/ with nvcc (sm_90a).
2. Model: builds the synthetic TinyLlama-1.1B at the Q4_K_M mix (full width
   and depth: 22 layers, hidden 2048, ffn 5632, vocab 32000; random weights
   from a seed), cached under .cache/chip_smoke/, and loads it with
   Engine.load on CUDA in "quant" mode (kernels) and in "dequant" mode
   (dense f32 torch.matmul).
3. Kernels: each kernel's wrapper on the card, on the loaded model's own
   weights (the main path's shapes) at 1, 8 and 512 rows, against its plain
   PyTorch version (limit: max |y - y_plain| <= 2e-4 * max |y_plain|; f32
   with another order of summation). Times, L2 flushed before every launch:
   the kernel, its plain version, and torch.matmul on the pre-dequantized
   f32 weight (a yardstick the port never calls); plus the least time the
   card could take for the same work (bytes over the memory rate, f32
   operations over the CUDA-core peak).
4. Main path: launch counters set to 0, then Engine.generate (about 100
   prompt tokens, 32 new tokens, greedy); each kernel must have launched
   exactly its per-step count (q4 44, GLU 22, q8 23) times the steps run.
   Tokens and text must equal the dequant-mode engine's and the prefill
   logits must agree within 1e-3.
5. Where the time goes: torch.profiler over 16 decode steps (wall and
   device time per step, the device's idle share, device time by kernel).

Prints, on lines before the last: the card's name and power limit, the
prefill and decode rates, {"decode_profile": {...}} and one JSON object
{"kernels": [...]}. The last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# 96 tokens with the synthetic byte-fallback tokenizer (a space costs 3)
PROMPT = "The quick brown fox jumps over the lazy dog while five wizards jump."
NEW_TOKENS = 32
PER_STEP = {"qmatmul_q4": 44, "qmatmul_glu": 22, "qmatmul_q8": 23}
REL_LIMIT = 2e-4
ROWS = (1, 8, 512)

# The card's memory rate and f32 CUDA-core peak (NVIDIA data sheets), by name
CARD_RATES = (  # (name fragment, bytes/s, f32 FLOP/s)
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),  # SXM5, HBM3
)

KERNELS = {
    "qmatmul_q4": dict(
        replaces="llama_gguf_tpu/ops/qmatmul.py:309 (_qmatmul_call with "
                 "_q4_kernel:138)"),
    "qmatmul_q8": dict(
        replaces="llama_gguf_tpu/ops/qmatmul.py:309 (_qmatmul_call with "
                 "_q8_kernel:164)"),
    "qmatmul_glu": dict(
        replaces="llama_gguf_tpu/ops/qmatmul.py:500 (_qmatmul_glu_call with "
                 "_glu_kernel:198)"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_rates(name: str) -> tuple[float, float]:
    for frag, bw, flops in CARD_RATES:
        if frag in name:
            return bw, flops
    raise SystemExit(f"chip_smoke: FAILED: no memory rate known for {name!r}")


def profile_decode(engine, ids, steps: int = 16) -> dict:
    """torch.profiler over ``steps`` single-token decode steps after a
    prefill: wall time per step, device time per step (sum of kernel
    times), the device's idle share, and device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r = engine.runner
    logits, kv, pos = r.prefill(ids, r.init_kv())
    tok = int(torch.argmax(logits))
    logits, kv = r.decode_one(tok, pos, kv)  # warm-up step
    pos += 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = int(torch.argmax(logits))
            logits, kv = r.decode_one(tok, pos, kv)
            pos += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        key = "qmatmul_kernel" if "qmatmul_kernel" in e.key else e.key[:60]
        by_kernel[key] = by_kernel.get(key, 0.0) + us / 1e3 / steps
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv_: -kv_[1])[:10]
    return dict(
        steps=steps, wall_ms_per_step=wall_ms / steps,
        device_ms_per_step=device_ms if device_ms > 0 else "not measured",
        device_idle_share=(1.0 - device_ms * steps / wall_ms
                           if device_ms > 0 else "not measured"),
        kernels_launched_per_step=sum(
            e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / steps,
        device_ms_per_step_by_kernel=dict(top))


def main() -> int:
    import torch

    # -- 1. device ------------------------------------------------------------
    check(torch.cuda.is_available(), "CUDA is not available")
    sys.path.insert(0, ROOT)
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.gguf.constants import GGMLType
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.ops.linear import dequantize_weight
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
    from llama_gguf_tpu_torch.utils import cuda_build
    from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    bw, f32_peak = card_rates(kind)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.build_all(["qmatmul"])
    log(f"kernels built in {time.perf_counter() - t0:.1f}s "
        f"(nvcc: {cuda_build.BUILD_SECONDS})")

    # -- 2. model -------------------------------------------------------------
    path = os.path.join(ROOT, ".cache", "chip_smoke",
                        f"tinyllama-1.1b-q4k-s{SEED}.gguf")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        tmp = path + f".{os.getpid()}.tmp"
        build_synthetic_gguf(tmp, preset="tinyllama-1.1b", quant=GGMLType.Q4_K,
                             seed=SEED)
        os.replace(tmp, path)
        log(f"built {path} in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    quant = Engine.load(path, EngineConfig(weight_mode="quant"), device="cuda")
    log(f"quant engine loaded in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    deq = Engine.load(path, EngineConfig(weight_mode="dequant"), device="cuda")
    log(f"dequant engine loaded in {time.perf_counter() - t0:.1f}s")
    cfg = quant.runner.cfg
    check((cfg.num_layers, cfg.hidden_size, cfg.vocab_size) ==
          (22, 2048, 32000), f"unexpected model shape {cfg}")

    # -- 3. kernels against their plain versions -------------------------------
    layer = quant.runner.params["layers"][0]
    projections = [  # (kernel, projection, weight)
        ("qmatmul_q4", "qkv", layer["attn"]["wqkv"]),
        ("qmatmul_q4", "o_proj", layer["attn"]["wo"]),
        ("qmatmul_glu", "gate|up", layer["ffn"]["gate_up"]),
        ("qmatmul_q8", "ffn_down", layer["ffn"]["down"]),
        ("qmatmul_q8", "lm_head", quant.runner.params["output"]),
    ]
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def time_ms(fn, iters=10):
        for _ in range(2):
            fn()
        times = []
        for _ in range(iters):
            flush_buf.zero_()  # evict the 50 MB L2: decode reads weights cold
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return sorted(times)[len(times) // 2]  # median

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    measurements = []
    for name, proj, lin in projections:
        glu = name == "qmatmul_glu"
        check(lin.fmt == ("q8" if name == "qmatmul_q8" else "q4"),
              f"{proj}: unexpected layout {lin.fmt}")
        w_deq = dequantize_weight(lin)  # library yardstick's f32 weight
        w_bytes = sum(t.numel() * t.element_size()
                      for t in (lin.packed, lin.scales, lin.mins)
                      if t is not None)
        n_out = lin.splits[0] if glu else lin.n
        for rows in ROWS:
            x = torch.randn(rows, lin.k, device="cuda", generator=gen)
            if glu:
                def kern(): return Q.qmatmul_glu(x, lin, "silu")
                def plain(): return Q.qmatmul_glu_plain(x, lin, "silu")
            else:
                def kern(): return Q.qmatmul(x, lin)
                def plain(): return Q.qmatmul_plain(x, lin)
            y, y_plain = kern(), plain()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y).all()), f"{name} {proj}: non-finite")
            abs_err = (y - y_plain).abs().max().item()
            rel_err = abs_err / y_plain.abs().max().item()
            check(rel_err <= REL_LIMIT,
                  f"{name} {proj} rows={rows}: rel err {rel_err:.3g}")
            nbytes = w_bytes + 4 * rows * (lin.k + n_out)
            ops = 2 * rows * lin.k * lin.n
            t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_peak * 1e3
            measurements.append(dict(
                name=name, projection=proj, rows=rows, k=lin.k, n=lin.n,
                max_abs_err=abs_err, max_rel_err=rel_err,
                ms=time_ms(kern), plain_ms=time_ms(plain),
                library_ms=time_ms(lambda: torch.matmul(x, w_deq)),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops))
            log(f"{name:12s} {proj:8s} rows={rows:3d} rel_err={rel_err:.2e} "
                f"ms={measurements[-1]['ms']:.4f} "
                f"bound_ms={measurements[-1]['bound_ms']:.4f}")
        del w_deq
    del flush_buf

    # -- 4. the main path, counted --------------------------------------------
    greedy = SamplerConfig(temperature=0.0)
    ids = quant.tokenizer.encode(PROMPT)
    check(90 <= len(ids) <= 128, f"prompt is {len(ids)} tokens")
    quant.generate(PROMPT, max_tokens=2, sampler=greedy)  # warm-up, uncounted
    torch.cuda.synchronize()
    Q.reset_launches()
    text = quant.generate(PROMPT, max_tokens=NEW_TOKENS, sampler=greedy)
    torch.cuda.synchronize()
    launches = dict(Q.LAUNCHES)
    stats = quant.stats
    steps = 1 + stats.generated_tokens  # the prefill + one decode per token
    for name, per in PER_STEP.items():
        check(launches[name] == per * steps,
              f"{name}: {launches[name]} launches, expected {per} x {steps}")
    check(stats.generated_tokens >= 1, "nothing generated")
    print(f"main path: prefill {stats.prompt_tokens} tok @ "
          f"{stats.prefill_tps:.1f} tok/s, decode {stats.generated_tokens} "
          f"tok @ {stats.decode_tps:.1f} tok/s, launches {launches} over "
          f"{steps} steps | {card}", flush=True)

    want_text = deq.generate(PROMPT, max_tokens=NEW_TOKENS, sampler=greedy)
    check(text == want_text, f"quant text {text!r} != dequant {want_text!r}")
    toks = quant.greedy_tokens(ids, NEW_TOKENS)
    check(toks == deq.greedy_tokens(ids, NEW_TOKENS),
          "greedy tokens differ between quant and dequant modes")
    logits = [e.runner.prefill(ids, e.runner.init_kv())[0]
              for e in (quant, deq)]
    check(tuple(logits[0].shape) == (32000,), "logits shape")
    check(bool(torch.isfinite(logits[0]).all()), "non-finite logits")
    diff = (logits[0] - logits[1]).abs().max().item()
    check(diff <= 1e-3, f"prefill logits differ by {diff}")
    log(f"quant == dequant: {len(toks)} tokens, logits max diff {diff:.2e}")

    # -- 5. where the decode step's time goes ---------------------------------
    print(json.dumps({"decode_profile": profile_decode(quant, ids)}),
          flush=True)

    kernels = []
    for name, meta in KERNELS.items():
        mine = [m for m in measurements if m["name"] == name]
        head = mine[0]  # the first projection at one row (decode)
        kernels.append(dict(
            name=name, route="cuda",
            source="llama_gguf_tpu_torch/csrc/qmatmul.cu",
            replaces=meta["replaces"], launches=launches[name],
            launches_per_step=PER_STEP[name],
            max_abs_err=max(m["max_abs_err"] for m in mine),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            at=f"{head['projection']} rows={head['rows']}",
            measurements=mine))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
