"""Time the port's dequant-matmul kernels on a CUDA card (random weights of
the main paths' shapes; nothing is read from a GGUF).

    python llama_gguf_tpu_torch/scripts/bench_qmatmul.py paths [--moe-only] [--out F]
    python llama_gguf_tpu_torch/scripts/bench_qmatmul.py retime [--root DIR] [--out F]
    python llama_gguf_tpu_torch/scripts/bench_qmatmul.py attribute [--root DIR] [--out F]
    python llama_gguf_tpu_torch/scripts/bench_qmatmul.py decode --gguf G [--moe-gguf M] [--moe-only] [--root DIR] [--out F]
    python llama_gguf_tpu_torch/scripts/bench_qmatmul.py compare F1 F2 ...
    python llama_gguf_tpu_torch/scripts/bench_qmatmul.py outputs [--root DIR] --out F.pt
    python llama_gguf_tpu_torch/scripts/bench_qmatmul.py same F1.pt F2.pt

``paths``: kernels 1-3 (ops/qmatmul.qmatmul, qmatmul_glu) on each of their
two paths forced through ``path=``, at TinyLlama-1.1B's, Mixtral-8x7B's and
the probe's shapes (the GLU at TinyLlama's gate|up and the probe's
Llama-3-8B width) and 1-16, 32, 64, 128 and 512 rows (split-K to 128);
each result held against the plain version (f32: 2e-4 * max |y|), then
timed beside torch.matmul on the dequantized f32 weight; at 1 row the
split-K path at 1-32 slices, from 32 rows the tensor cores' tile heights
(and at 128 rows 1-16 slices). Then kernel 5 (ops/qmatmul.
moe_grouped_blocked) at Mixtral-8x7B's down (Q6_K-like q8, group 16) and
gate (q4) expert stacks, and kernel 6 (the same entry with ``up``) at its
gate|up stacks, at 64, 256 and 1024 top-2 slots: the tensor-core path at
each tile height and 1-4 slices, and the CUDA-core grouped kernels; and
kernel 4 (ops/qmatmul.moe_qmatmul, split-K) at Mixtral's gate and down
stacks at 1 and 2 slots, at 1-32 slices of K. ``--moe-only``: these MoE
sweeps alone.
Prints the timer's floor (a 1-element fill), one JSON line per case and,
per shape, the first row count from which the tensor cores are at least
as fast as split-K (the threshold TC_MIN_ROWS rests on).

``retime``: kernels 1-6 at the shapes of chip_smoke.py phases 3 and 6 (and
the probe's v0; the grouped kernel also at a skewed routing, and on the q4
gate stack), through the entries every version of the port has
(``qmatmul``, ``qmatmul_glu``, ``moe_qmatmul``, ``moe_qmatmul_glu``), with
``--root`` naming the checkout whose ``llama_gguf_tpu_torch`` is imported:
so one command can time an export of an earlier commit (its own kernels,
with this commit's utils/timing.py copied in) and this one, in turns.
``compare`` prints each case's time from several such files side by side.

``attribute``: where a 1-row launch of kernels 1-2 spends its device time,
by torch.profiler (kernel durations only: no host time, no launch gap; L2
flushed before each launch; the mean of 20): an empty kernel
(``torch.cuda._sleep(0)``); TinyLlama's qkv, o_proj and ffn_down at 1 row
through the default plan and, where the package has ``qmatmul_plan``, at
forced splits of K; and a q4 weight of K = 32 and 256 (1 and 8 groups;
2560 columns) at 1 and 8 splits, which isolates the split sum: at K = 256
each thread loads one chunk of 16 packed rows either way, and 8 splits add
the workspace sum. With ``--root`` naming an earlier checkout it times that
checkout's kernels at the default calls.

``decode``: ``Engine.generate`` on a GGUF (``--gguf``; chip_smoke.py's
TinyLlama-1.1B Q4_K_M), 32 greedy tokens after chip_smoke's prompt, three
times each in the f32 configuration (f32 panels, "highest", f32 KV) and the
serving one (bf16 panels, "default", bf16 KV): decode and prefill tok/s
(host clock around synchronized work); and the host's cost of one
``qmatmul`` call (2,000 back-to-back 1-row calls on the qkv weight, wall
time over the count, the device then far from busy). With ``--moe-gguf``
(chip_smoke.py's mixtral-8x7b-l2) also that model in the f32
configuration, three generates: its prefill runs the grouped kernels
(``--moe-only``: that model alone). Run it for two checkouts in turns
(``--root``) to compare them end to end.

``outputs``: kernels 4 and 6 (the slot-major and the grouped GLU MoE
kernels) at Mixtral-8x7B's stacks (kernel 4 on gate and down at 2 slots,
kernel 6 on gate|up at 256), top-2 routing, in "highest" and "default",
their outputs saved with torch.save; ``same`` says for each whether two
such files hold the same bits (an earlier checkout's kernels against this
one's, through ``--root``) and, where they differ, by how much: the
largest difference relative to max |y|, and the share of elements that
differ.

Times: utils/timing.Timer (L2 flushed, a device-side sleep before the first
event, median of 10). Card name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# (label, fmt, group, K, N)
TINYLLAMA = [("TinyLlama qkv", "q4", 32, 2048, 2560),
             ("TinyLlama o_proj", "q4", 32, 2048, 2048),
             ("TinyLlama ffn_down", "q8", 16, 5632, 2048),
             ("TinyLlama lm_head", "q8", 16, 2048, 32000)]
MIXTRAL = [("Mixtral qkv", "q4", 32, 4096, 6144),
           ("Mixtral o_proj", "q4", 32, 4096, 4096),
           ("Mixtral lm_head", "q8", 16, 4096, 32000)]
PROBE = [("probe 4096x14336", "q4", 32, 4096, 14336),
         ("probe 14336x4096", "q4", 32, 14336, 4096)]
# (label, fmt, group, K, F): the GLU's fused gate|up weights [K, 2F]
GLU = [("TinyLlama gate|up", "q4", 32, 2048, 5632),
       ("probe gate|up 4096x2x14336", "q4", 32, 4096, 14336)]
# (label, fmt, group, K, N): Mixtral-8x7B's expert stacks (8 experts)
GROUPED = [("Mixtral down", "q8", 16, 14336, 4096),
           ("Mixtral gate", "q4", 32, 4096, 14336)]
PATH_ROWS = list(range(1, 17)) + [32, 64, 128, 512]
SPLITK_MAX_ROWS = 128  # split-K re-reads W per row: not timed beyond


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def weight(fmt, group, k, n, gen, panels="f32", mins=True, experts=None):
    """Random packed bytes and panels of a q4/q8 weight (q8 levels in
    -32..31, as Q6_K's) on the card: a QuantLinear, or a QuantExpertStack of
    ``experts`` experts."""
    import torch
    from llama_gguf_tpu_torch.ops.linear import QuantExpertStack, QuantLinear

    lead = (experts,) if experts else ()
    rows = k // 2 if fmt == "q4" else k
    if fmt == "q4":
        packed = torch.randint(0, 256, (*lead, rows, n), generator=gen,
                               device="cuda", dtype=torch.uint8)
    else:
        packed = torch.randint(-32, 32, (*lead, rows, n), generator=gen,
                               device="cuda", dtype=torch.int8)
    dt = torch.bfloat16 if panels == "bf16" else torch.float32
    s = (torch.randn((*lead, k // group, n), generator=gen, device="cuda")
         * 0.01).to(dt)
    m = ((torch.randn((*lead, k // group, n), generator=gen, device="cuda")
          * 0.01).abs().to(dt) if mins else None)
    if experts:
        return QuantExpertStack(packed, s, m, fmt, group, k, n)
    return QuantLinear(packed, s, m, None, fmt, group, k, n, "random")


def paths(timer, out, moe_only=False):
    import torch
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    one = torch.zeros(1, device="cuda")
    floor = dict(case="timer floor: a 1-element fill", ms=timer.ms(
        lambda: one.fill_(1.0)))
    print(json.dumps(floor), flush=True)
    results, first_tc = [floor], {}

    def emit(r):
        results.append(r)
        print(json.dumps(r), flush=True)

    products = ([(label, fmt, group, k, n, False)
                 for label, fmt, group, k, n in TINYLLAMA + MIXTRAL + PROBE]
                + [(label, fmt, group, k, f, True)
                   for label, fmt, group, k, f in GLU]) if not moe_only else []
    for label, fmt, group, k, n, glu in products:
        lin = weight(fmt, group, k, 2 * n if glu else n, gen)
        if glu:
            lin.splits = (n, n)
        w = Q.dequantize_weight(lin)

        def kern(x, **kw):
            if glu:
                return Q.qmatmul_glu(x, lin, "silu", **kw)
            return Q.qmatmul(x, lin, **kw)

        for b in PATH_ROWS:
            x = torch.randn(b, k, generator=gen, device="cuda")
            want = (Q.qmatmul_glu_plain(x, lin, "silu") if glu
                    else Q.qmatmul_plain(x, lin))
            ms = {"library": timer.ms(lambda: torch.matmul(x, w))}
            for path in ("splitk", "tc")[b > SPLITK_MAX_ROWS:]:
                plan = Q.qmatmul_plan(b, k, n, group, fmt, path=path, glu=glu)
                got = kern(x, path=path)
                torch.cuda.synchronize()
                err = ((got - want).abs().max() / want.abs().max()).item()
                if not err <= 2e-4:
                    raise SystemExit(f"{label} rows={b} {path}: rel err {err}")
                ms[path] = timer.ms(lambda: kern(x, path=path))
                emit(dict(case=label, rows=b, path=path, splits=plan.splits,
                          grid=plan.grid, ms=ms[path],
                          library_ms=ms["library"], rel_err=err))
            if b == 1:  # the split of K at decode
                for splits in (1, 2, 4, 8, 12, 16, 24, 32):
                    if splits > k // group:
                        continue
                    emit(dict(case=label, rows=b, path="splitk sweep",
                              splits=splits, ms=timer.ms(
                                  lambda: kern(x, path="splitk",
                                               splits=splits))))
            if b >= 32:  # the tensor-core tile's height and split of K
                for tile_rows in (16, 32, 64):
                    for splits in ((None, 1, 2, 4, 8, 16) if b == 128
                                   else (None,)):
                        if splits and splits > k // Q.TC_STAGE // 8:
                            continue
                        kw = dict(path="tc", tile_rows=tile_rows,
                                  splits=splits)
                        plan = Q.qmatmul_plan(b, k, n, group, fmt, glu=glu,
                                              **kw)
                        emit(dict(case=label, rows=b, path="tc sweep",
                                  tile_rows=tile_rows, splits=plan.splits,
                                  planned=splits is None, ms=timer.ms(
                                      lambda: kern(x, **kw))))
            if ms["tc"] <= ms.get("splitk", ms["tc"]) and label not in first_tc:
                first_tc[label] = b
        del w, lin
    grouped(timer, gen, emit)
    slot(timer, gen, emit)
    summary = {"tc_at_least_as_fast_from_rows": first_tc}
    print(json.dumps(summary), flush=True)
    _dump(out, results + [summary])


def top2(s, gen):
    """Top-2 routing of s // 2 tokens over 8 experts: two distinct experts
    per token, uniformly at random."""
    import torch

    return torch.stack([torch.randperm(8, generator=gen, device="cuda")[:2]
                        for _ in range(s // 2)]).reshape(-1).to(torch.int32)


def grouped(timer, gen, emit):
    """Kernel 5's paths, tile heights and splits at Mixtral's stacks."""
    import torch
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    for label, fmt, group, k, n in GROUPED + [("Mixtral gate|up", "q4", 32,
                                               4096, 14336)]:
        stack = weight(fmt, group, k, n, gen, experts=8, mins=fmt == "q4")
        glu = {}
        if "gate|up" in label:  # kernel 6 over the gate and an up stack
            glu = dict(up=weight(fmt, group, k, n, gen, experts=8),
                       act="silu")
        for s in (64, 256, 1024):
            x = torch.randn(s, k, generator=gen, device="cuda")
            idx = top2(s, gen)
            c_rows, g_blocks, _ = Q.moe_dims(s, 8)
            eg, rows, flat = Q.moe_group_plan(idx, 8, c_rows, g_blocks)
            want = (Q.moe_qmatmul_glu_plain(x, stack, glu["up"], idx, "silu")
                    if glu else Q.moe_qmatmul_plain(x, stack, idx))
            default = Q.moe_grouped_plan(s, 8, k, n, group, fmt,
                                         glu=bool(glu))
            runs = [dict(path="cuda cores")] + [
                dict(path="tc", tile_rows=tr, splits=sp)
                for tr in (16, 32, 64) if c_rows % tr == 0
                for sp in (None, 1, 2, 4)]
            for kw in runs:
                plan = Q.moe_grouped_plan(s, 8, k, n, group, fmt,
                                          glu=bool(glu), **kw)

                def fn():
                    return Q.moe_grouped_blocked(x, stack, eg, rows, **glu,
                                                 **kw)

                got = fn()[flat]
                torch.cuda.synchronize()
                err = ((got - want).abs().max() / want.abs().max()).item()
                if not err <= 2e-4:
                    raise SystemExit(f"{label} S={s} {kw}: rel err {err}")
                emit(dict(case=f"{label} S={s}", slots=s, path=plan.path,
                          tile_rows=plan.rows, splits=plan.splits,
                          planned=plan == default, ms=timer.ms(fn),
                          rel_err=err))
        del stack, glu


def slot(timer, gen, emit):
    """Kernel 4's split of K at Mixtral's gate and down stacks, 1 and 2
    slots (top-2 decode: 2)."""
    import torch
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    for label, fmt, group, k, n in GROUPED:
        stack = weight(fmt, group, k, n, gen, experts=8, mins=fmt == "q4")
        for s in (1, 2):
            x = torch.randn(s, k, generator=gen, device="cuda")
            idx = top2(2, gen)[:s]
            want = Q.moe_qmatmul_plain(x, stack, idx)
            planned = Q.moe_slot_plan(s, 8, k, n, group, fmt).splits
            for splits in sorted({1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 17, 20, 24,
                                  32, planned}):
                got = Q.moe_qmatmul(x, stack, idx, splits=splits)
                torch.cuda.synchronize()
                err = ((got - want).abs().max() / want.abs().max()).item()
                if not err <= 2e-4:
                    raise SystemExit(f"{label} S={s} splits={splits}: rel "
                                     f"err {err}")
                emit(dict(case=f"moe_slot {label} S={s}", slots=s,
                          path="splitk sweep", splits=splits,
                          planned=splits == planned, rel_err=err,
                          ms=timer.ms(lambda: Q.moe_qmatmul(
                              x, stack, idx, splits=splits))))
        del stack


def retime(timer, out):
    import torch
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []

    def run(case, fn):
        fn()
        torch.cuda.synchronize()
        r = dict(case=case, ms=timer.ms(fn))
        results.append(r)
        print(json.dumps(r), flush=True)

    modes = (("f32", "highest"), ("bf16", "default"))
    for label, fmt, group, k, n in TINYLLAMA[:2] + [
            ("TinyLlama gate|up", "q4", 32, 2048, 2 * 5632)] + TINYLLAMA[2:]:
        for panels, prec in modes:
            lin = weight(fmt, group, k, n, gen, panels)
            if "gate|up" in label:
                lin.splits = (n // 2, n // 2)
            for b in (1, 8, 128, 512):
                x = torch.randn(b, k, generator=gen, device="cuda")
                if lin.splits:
                    fn = (lambda x=x, lin=lin, prec=prec:
                          Q.qmatmul_glu(x, lin, "silu", prec))
                else:
                    fn = lambda x=x, lin=lin, prec=prec: Q.qmatmul(x, lin, prec)
                run(f"{label} {panels} panels {prec} rows={b}", fn)
            del lin
    for label, fmt, group, k, n in MIXTRAL:
        lin = weight(fmt, group, k, n, gen)
        for b in (1, 128):
            x = torch.randn(b, k, generator=gen, device="cuda")
            run(f"{label} f32 panels highest rows={b}",
                lambda x=x, lin=lin: Q.qmatmul(x, lin, "highest"))
        del lin
    for label, fmt, group, k, n in PROBE:
        lin = weight(fmt, group, k, n, gen, "bf16")
        x = torch.randn(8, k, generator=gen, device="cuda")
        run(f"{label} v0 bf16 panels default rows=8",
            lambda x=x, lin=lin: Q.qmatmul(x, lin, "default"))
        del lin
    # Mixtral's expert stacks (8 experts, f32 panels) and top-2 routings
    gate = weight("q4", 32, 4096, 14336, gen, experts=8)
    up = weight("q4", 32, 4096, 14336, gen, experts=8)
    down = weight("q8", 16, 14336, 4096, gen, experts=8, mins=False)
    for s in (2, 256):
        idx = top2(s, gen)
        xg = torch.randn(s, 4096, generator=gen, device="cuda")
        xd = torch.randn(s, 14336, generator=gen, device="cuda")
        for prec in ("highest", "default"):
            if s == 2:
                run(f"moe_slot gate S=2 {prec}",
                    lambda: Q.moe_qmatmul(xg, gate, idx, prec))
            else:
                run(f"moe_glu_grouped gate|up S=256 {prec}",
                    lambda: Q.moe_qmatmul_glu(xg, gate, up, idx, "silu", prec))
            run(f"moe_{'slot' if s == 2 else 'grouped'} down S={s} {prec}",
                lambda: Q.moe_qmatmul(xd, down, idx, prec))
        if s == 256:  # kernel 5 on the q4 gate stack, and skewed routing
            run("moe_grouped gate (q4) S=256 highest",
                lambda: Q.moe_qmatmul(xg, gate, idx, "highest"))
            skew = idx.clone()
            skew[0::2] = 0  # expert 0 takes half of the slots
            run("moe_grouped down S=256 skewed highest",
                lambda: Q.moe_qmatmul(xd, down, skew, "highest"))
    _dump(out, results)


def _device_us(fn, flush, iters=20, skip=("reduce_kernel",)):
    """The mean device time of ``fn``'s kernels per call in us, by
    torch.profiler; ``flush`` runs before each call and its kernels (names
    containing a ``skip`` part) are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or any(k in e.key for k in skip):
            continue
        us = getattr(e, "self_device_time_total", None)
        total += us if us is not None else getattr(e, "self_cuda_time_total", 0)
    return total / iters


def attribute(timer, out):
    import torch
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = timer.flush_buf.sum
    has_plan = hasattr(Q, "qmatmul_plan")
    results = []

    def run(case, fn, **kw):
        r = dict(case=case, device_us=_device_us(fn, flush), **kw)
        results.append(r)
        print(json.dumps(r), flush=True)

    run("empty kernel (torch.cuda._sleep(0))", lambda: torch.cuda._sleep(0))
    for label, fmt, group, k, n in TINYLLAMA[:3]:
        lin = weight(fmt, group, k, n, gen)
        x = torch.randn(1, k, generator=gen, device="cuda")
        planned = (Q.qmatmul_plan(1, k, n, group, fmt).splits if has_plan
                   else None)
        run(f"{label} rows=1 default", lambda: Q.qmatmul(x, lin),
            splits=planned)
        if has_plan:
            for splits in (1, 2, 4, 8, 16, 32):
                if splits != planned and splits <= k // group:
                    run(f"{label} rows=1 splits={splits}",
                        lambda: Q.qmatmul(x, lin, path="splitk",
                                          splits=splits), splits=splits)
    if has_plan:  # the split sum alone
        for k in (32, 256):
            lin = weight("q4", 32, k, 2560, gen)
            x = torch.randn(1, k, generator=gen, device="cuda")
            for splits in (1, 8)[:k // 32]:
                run(f"q4 K={k} N=2560 rows=1 splits={splits}",
                    lambda: Q.qmatmul(x, lin, path="splitk", splits=splits),
                    splits=splits)
    _dump(out, results)


def decode(gguf, out, moe_gguf=None, moe_only=False):
    import torch
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.engine.runner import ModelRunner
    from llama_gguf_tpu_torch.models.loader import load_model
    from llama_gguf_tpu_torch.ops import qmatmul as Q
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
    from llama_gguf_tpu_torch.tokenizer.gguf_tokenizer import Tokenizer

    prompt = ("The quick brown fox jumps over the lazy dog while five "
              "wizards jump.")  # chip_smoke.PROMPT
    greedy = SamplerConfig(temperature=0.0)
    results = []
    for cfg_name in ("f32", "serving")[2 * moe_only:]:
        if cfg_name == "f32":
            engine = Engine.load(gguf, EngineConfig(), device="cuda")
        else:
            params, cfg, gg = load_model(gguf, device="cuda",
                                         scale_dtype="bfloat16")
            engine = Engine(ModelRunner(params, cfg, matmul_precision="default",
                                        kv_format="bf16", device="cuda"),
                            Tokenizer.from_gguf(gg.metadata),
                            EngineConfig(matmul_precision="default",
                                         kv_format="bf16"), gg)
        engine.generate(prompt, max_tokens=2, sampler=greedy)  # warm-up
        for rep in range(3):
            engine.generate(prompt, max_tokens=32, sampler=greedy)
            st = engine.stats
            r = dict(case=f"{cfg_name} decode", rep=rep,
                     decode_tps=st.decode_tps, prefill_tps=st.prefill_tps,
                     tokens=st.generated_tokens)
            results.append(r)
            print(json.dumps(r), flush=True)
        if cfg_name == "f32":
            wqkv = engine.runner.params["layers"][0]["attn"]["wqkv"]
            x = torch.randn(1, wqkv.k, device="cuda")
            for _ in range(10):
                Q.qmatmul(x, wqkv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                Q.qmatmul(x, wqkv)
            torch.cuda.synchronize()
            r = dict(case="qmatmul host us per call, qkv rows=1",
                     us=(time.perf_counter() - t0) / 2000 * 1e6)
            results.append(r)
            print(json.dumps(r), flush=True)
        del engine
        torch.cuda.empty_cache()
    if moe_gguf:
        engine = Engine.load(moe_gguf, EngineConfig(), device="cuda")
        engine.generate(prompt, max_tokens=2, sampler=greedy)  # warm-up
        for rep in range(3):
            engine.generate(prompt, max_tokens=32, sampler=greedy)
            st = engine.stats
            r = dict(case="Mixtral-8x7B-l2 f32", rep=rep,
                     decode_tps=st.decode_tps, prefill_tps=st.prefill_tps,
                     tokens=st.generated_tokens)
            results.append(r)
            print(json.dumps(r), flush=True)
        del engine
        torch.cuda.empty_cache()
    _dump(out, results)


def outputs(out):
    import torch
    from llama_gguf_tpu_torch.ops import qmatmul as Q

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gate = weight("q4", 32, 4096, 14336, gen, experts=8)
    up = weight("q4", 32, 4096, 14336, gen, experts=8)
    down = weight("q8", 16, 14336, 4096, gen, experts=8, mins=False)
    saved = {}
    for s in (2, 256):
        idx = top2(s, gen)
        x = torch.randn(s, 4096, generator=gen, device="cuda")
        xd = torch.randn(s, 14336, generator=gen, device="cuda")
        for prec in ("highest", "default"):
            if s == 2:
                saved[f"moe_slot gate S=2 {prec}"] = Q.moe_qmatmul(
                    x, gate, idx, prec)
                saved[f"moe_slot down S=2 {prec}"] = Q.moe_qmatmul(
                    xd, down, idx, prec)
            else:
                saved[f"moe_glu_grouped gate|up S=256 {prec}"] = \
                    Q.moe_qmatmul_glu(x, gate, up, idx, "silu", prec)
    torch.cuda.synchronize()
    for key, t in saved.items():
        print(json.dumps(dict(case=key, finite=bool(torch.isfinite(t).all()),
                              shape=list(t.shape))), flush=True)
    if out:
        torch.save({k: v.cpu() for k, v in saved.items()}, out)


def same(files):
    import torch

    a, b = (torch.load(f) for f in files)
    for key in a:
        if key not in b:
            print(f"{key}: only in {files[0]}")
            continue
        if torch.equal(a[key], b[key]):
            print(f"{key}: bit-identical")
            continue
        x, y = a[key].float(), b[key].float()
        print(f"{key}: DIFFERENT, max |a - b| / max |a| = "
              f"{((x - y).abs().max() / x.abs().max()).item():.3g}, "
              f"{(x != y).float().mean().item():.3f} of the elements differ")


def compare(files):
    runs = []
    for f in files:
        with open(f) as fh:
            runs.append({r["case"]: r["ms"] for r in json.load(fh)["results"]
                         if "case" in r})
    print("case | " + " | ".join(os.path.basename(f) for f in files))
    for case in runs[0]:
        print(f"{case} | " + " | ".join(
            f"{r[case]:.4f}" if case in r else "-" for r in runs))


def _dump(out, results):
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump({"card": card(), "results": results}, fh, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=("paths", "retime", "attribute", "decode",
                                    "compare", "outputs", "same"))
    ap.add_argument("files", nargs="*")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="checkout whose llama_gguf_tpu_torch is imported")
    ap.add_argument("--out", default=None)
    ap.add_argument("--gguf", default=None, help="the model of ``decode``")
    ap.add_argument("--moe-gguf", default=None,
                    help="an MoE model ``decode`` also runs")
    ap.add_argument("--moe-only", action="store_true",
                    help="paths: the MoE kernels' sweeps alone; decode: the "
                         "MoE model alone")
    args = ap.parse_args(argv)
    if args.cmd in ("compare", "same"):
        (compare if args.cmd == "compare" else same)(args.files)
        return 0
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_qmatmul: needs a CUDA card")
    from llama_gguf_tpu_torch.utils import cuda_build
    from llama_gguf_tpu_torch.utils.timing import Timer

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    print(f"package: {os.path.abspath(args.root)}", flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all(["qgemm", "moe_qmatmul"])
    print(f"built in {time.perf_counter() - t0:.1f}s "
          f"{cuda_build.BUILD_SECONDS}", flush=True)
    if args.cmd == "decode":
        if not (args.gguf or args.moe_only and args.moe_gguf):
            raise SystemExit("bench_qmatmul decode: needs --gguf")
        decode(args.gguf, args.out, args.moe_gguf, args.moe_only)
    elif args.cmd == "outputs":
        outputs(args.out)
    elif args.cmd == "paths":
        paths(Timer(), args.out, args.moe_only)
    else:
        timer = Timer()
        dict(retime=retime, attribute=attribute)[args.cmd](timer, args.out)
    print(f"done in {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
