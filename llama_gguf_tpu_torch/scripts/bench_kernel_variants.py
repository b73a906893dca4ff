"""Isolate where the fused dequant-matmul kernel's time goes on the card
(port of scripts/bench_kernel_variants.py).

Each variant changes one piece of the q4/q8 dequant chain, on Llama-3-8B FFN
decode shapes (B = 8 rows; K x N = 4096 x 14336 and 14336 x 4096; group 32;
bf16 scale and min panels):

  v0_full     the production kernel (ops.qmatmul.qmatmul, mins, "default"
              precision: bf16 output)
  v1_nomin    mins dropped
  v2_noscale  (q8) scales dropped too: y = x @ q
  v5_minfold  y = x @ (s*q) - xg^T @ m in f32, xg the per-group sums of x
  v6_bf16     v5 with bf16 dequant: w = bf16(q * s), x and xg in bf16
  v7_int8     int8 x times the int8 (q8) or nibble (q4) weights, i32 sums
  v8_w4a8     (q4) the w4a8 chain: per-column scale S = max|s| / 127, int8
              scale codes u = round(s / S), mins m / S in bf16, x quantized
              per row to int8 (t = max|x| / 127)
  v9_mulcost  (q4) v7 plus the u multiply, wrapped to int8 (wrong numbers by
              design: it measures the multiply's cost)
  v10_4dot    (q4) v7 with four int8 products per packed byte
  floor       torch ops: an XOR and a sum over the same packed bytes and
              panels

The kernels of v2 and v5-v10 are in csrc/qmatmul_variants.cu
(ops/qmatmul_variants.py), all on the tensor cores: v2 and v5 three bf16
passes (their bound is reckoned as "bf16x3", as kernels 1-2's tensor-core
path), v6 one, the integer variants s8 products. Gates, as in the JAX script: v5 must equal v0 (to
v0's bf16 rounding plus f32 summation order); the relative errors of v6 and
v8 against v0 are printed. Times: CUDA events around one launch at a time,
each after a write that evicts L2 (utils/timing.Timer), the variants
interleaved over ROUNDS rounds, the median taken. Per variant: us, GB/s over
the bytes it must move (each input once, each output once), the share of its
byte bound (those bytes over the memory rate), and its bound (the larger of
the byte bound and its operations over the card's peak for their type).

    python -m llama_gguf_tpu_torch.scripts.bench_kernel_variants [q8|q4] [K N]
        [--device cuda|cpu]

On the CPU the variants run their plain versions and no time is measured.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops import qmatmul as Q
from ..ops import qmatmul_variants as V
from ..ops.linear import QuantLinear, dequantize_weight
from ..utils.timing import Timer, bound_ms, card_peaks, median

B = 8
GROUP = 32
SHAPES = ((4096, 14336), (14336, 4096))
ROUNDS = 5
PER_ROUND = 4  # launches of each variant per round
F32_REL = 2e-4  # f32 sums in another order, relative to max |y|


@dataclass
class Variant:
    """One variant at one shape. ``run``: what the probe times and gates (v8:
    the whole chain, x quantized by torch ops, as the JAX script timed it);
    ``call``: the wrapper alone on fixed inputs, ``plain`` its plain version,
    ``library`` one torch call computing the same function (a yardstick the
    port never calls), or None; ``kernel``: the launch counter ``call``
    moves; ``nbytes``/``ops``/``op_type``: the work of ``call``; ``exact``:
    integers written as float32, so the kernel equals its plain version."""

    run: Callable[[], torch.Tensor]
    call: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    library: Callable[[], torch.Tensor] | None
    kernel: str
    nbytes: int
    ops: int
    op_type: str
    exact: bool = False


def make_inputs(fmt: str, k: int, n: int, rng: np.random.Generator,
                device) -> dict:
    """The JAX script's inputs, drawn in its order from its generator:
    packed, scales, mins, x (:90-102), then xi8 (:227-228)."""
    if fmt == "q8":
        packed = rng.integers(-127, 127, size=(k, n), dtype=np.int8)
    else:
        packed = rng.integers(0, 255, size=(k // 2, n), dtype=np.uint8)
    scales = (rng.normal(size=(k // GROUP, n)) * 0.01).astype(np.float32)
    mins = np.abs(rng.normal(size=(k // GROUP, n)) * 0.01).astype(np.float32)
    x = rng.normal(size=(B, k)).astype(np.float32)
    xi8 = rng.integers(-127, 127, size=(B, k), dtype=np.int8)

    def put(a):
        return torch.from_numpy(a).to(device)

    s, m = put(scales).to(torch.bfloat16), put(mins).to(torch.bfloat16)
    pk = put(packed)
    return dict(
        fmt=fmt, k=k, n=n, x=put(x), xi8=put(xi8),
        lin_full=QuantLinear(pk, s, m, None, fmt, GROUP, k, n, "bench"),
        lin_nomin=QuantLinear(pk, s, None, None, fmt, GROUP, k, n, "bench"))


def w4a8_panels(lin: QuantLinear):
    """(s_col [N] f32, u [K/G, N] int8, m2 [K/G, N] bf16) from the bf16
    panels, as the JAX script makes them (:325-332)."""
    sf = lin.scales.float()
    s_col = torch.clamp(sf.abs().amax(dim=0), min=1e-12) / 127.0
    u = torch.round(sf / s_col).to(torch.int8)
    m2 = (lin.mins.float() / s_col).to(torch.bfloat16)
    return s_col, u, m2


def quantize_rows(x: torch.Tensor, group: int = GROUP):
    """(t [B], xi [B, K] int8, xg2 [K/G, B]): x quantized per row as in the
    JAX script's v8_one (:378-385)."""
    t = torch.clamp(x.abs().amax(dim=1) / 127.0, min=1e-12)
    xi = torch.round(x / t[:, None]).to(torch.int8)
    return t, xi, V.group_sums(x, group) / t[None, :]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def build_variants(inp: dict) -> dict:
    """The probe's variants at one shape, in its order."""
    fmt, k, n = inp["fmt"], inp["k"], inp["n"]
    x, xi = inp["x"], inp["xi8"]
    full, nomin = inp["lin_full"], inp["lin_nomin"]
    xg = V.group_sums(x, GROUP)
    y32, ybf = 4 * B * n, 2 * B * n  # output bytes: f32, bf16
    fma = 2 * B * k * n
    # the library yardsticks' weights, made f32 (v6: bf16) beforehand
    w_full = dequantize_weight(full)
    q = V.weight_ints(full)
    qf = q.float()
    panels = (full.scales, full.mins)

    out: dict[str, Variant] = {}
    # kernels 1-2's path, with the bf16 output of "default"
    v0_ops = Q.qmatmul_plan(B, k, n, GROUP, fmt).op_type("default")
    for tag, lin, w in (("v0_full", full, w_full),
                        ("v1_nomin", nomin, dequantize_weight(nomin))):
        out[tag] = Variant(
            run=lambda lin=lin: Q.qmatmul(x, lin, "default"),
            call=lambda lin=lin: Q.qmatmul(x, lin, "default"),
            plain=lambda lin=lin: Q.qmatmul_plain(x, lin, "default"),
            library=lambda w=w: torch.matmul(x, w),
            kernel=f"qmatmul_{fmt}",
            nbytes=_nbytes(lin.packed, lin.scales, lin.mins, x) + ybf,
            ops=fma, op_type=v0_ops)
    if fmt == "q8":
        out["v2_noscale"] = Variant(
            run=lambda: V.v2_noscale(x, full),
            call=lambda: V.v2_noscale(x, full),
            plain=lambda: V.v2_noscale_plain(x, full),
            library=lambda: torch.matmul(x, qf),
            kernel="variant_f32", nbytes=_nbytes(full.packed, x) + y32,
            ops=fma, op_type="bf16x3")
    out["v5_minfold"] = Variant(
        run=lambda: V.v5_minfold(x, V.group_sums(x, GROUP), full),
        call=lambda: V.v5_minfold(x, xg, full),
        plain=lambda: V.v5_minfold_plain(x, xg, full),
        library=lambda: torch.matmul(x, w_full),
        kernel="variant_f32",
        nbytes=_nbytes(full.packed, *panels, x, xg) + y32, ops=fma,
        op_type="bf16x3")
    w6 = w_full.to(torch.bfloat16)
    out["v6_bf16"] = Variant(
        run=lambda: V.v6_bf16(x, V.group_sums(x, GROUP), full),
        call=lambda: V.v6_bf16(x, xg, full),
        plain=lambda: V.v6_bf16_plain(x, xg, full),
        library=lambda: torch.matmul(x.to(torch.bfloat16), w6),
        kernel="variant_bf16",
        nbytes=_nbytes(full.packed, *panels, x, xg) + y32, ops=fma,
        op_type="bf16")
    out["v7_int8"] = Variant(
        run=lambda: V.v7_int8(xi, full), call=lambda: V.v7_int8(xi, full),
        plain=lambda: V.v7_int8_plain(xi, full),
        library=lambda: torch.matmul(xi.float(), qf),
        kernel="variant_int8", nbytes=_nbytes(full.packed, xi) + y32,
        ops=fma, op_type="int8", exact=True)
    if fmt == "q4":
        s_col, u, m2 = w4a8_panels(full)
        t, xq, xg2 = quantize_rows(x)

        def v8_chain():
            tt, xqq, xgg = quantize_rows(x)
            return V.v8_w4a8(xqq, xgg, full, u, m2, s_col) * tt[:, None]

        # v8's function of (xq, xg2) as one product: [xq | xg2^T] @
        # [q * u; -m2] * s_col, both operands made f32 beforehand
        x8 = torch.cat([xq.float(), xg2.t().float()], dim=1)
        w8 = torch.cat([(q * V.repeat_rows(u.to(torch.int32), GROUP)).float(),
                        -m2.float()]) * s_col
        out["v8_w4a8"] = Variant(
            run=v8_chain, call=lambda: V.v8_w4a8(xq, xg2, full, u, m2, s_col),
            plain=lambda: V.v8_w4a8_plain(xq, xg2, full, u, m2, s_col),
            library=lambda: torch.matmul(x8, w8), kernel="variant_w4a8",
            nbytes=_nbytes(full.packed, u, m2, s_col, xq, xg2) + y32,
            ops=fma, op_type="int8")
        w9 = V._wrap8(q * V.repeat_rows(u.to(torch.int32), GROUP)).float()
        out["v9_mulcost"] = Variant(
            run=lambda: V.v9_mulcost(xi, full, u),
            call=lambda: V.v9_mulcost(xi, full, u),
            plain=lambda: V.v9_mulcost_plain(xi, full, u),
            library=lambda: torch.matmul(xi.float(), w9),
            kernel="variant_int8", nbytes=_nbytes(full.packed, u, xi) + y32,
            ops=fma, op_type="int8", exact=True)
        x_lo, x_hi, lo, hi = V._q4_halves(xi.to(torch.int32), full)
        xs10, w10 = (x_lo + x_hi).float(), (lo + hi).float()
        out["v10_4dot"] = Variant(
            run=lambda: V.v10_4dot(xi, full),
            call=lambda: V.v10_4dot(xi, full),
            plain=lambda: V.v10_4dot_plain(xi, full),
            library=lambda: torch.matmul(xs10, w10),
            kernel="variant_int8", nbytes=_nbytes(full.packed, xi) + y32,
            ops=2 * fma, op_type="int8", exact=True)
    return out


def floor_fn(inp: dict) -> Callable[[], torch.Tensor]:
    """An XOR and a sum over the packed bytes and the panels (:469-486)."""
    lin = inp["lin_full"]
    p = lin.packed.view(torch.uint8)

    def run():
        seed = 3
        return ((p ^ seed).sum(dtype=torch.int32).float()
                + lin.scales.float().sum() * seed
                + lin.mins.float().sum() * seed)
    return run


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-9)).item()


def gates(variants: dict) -> dict[str, float]:
    """The JAX script's gates (:500-507): v5 equals v0 to v0's bf16
    rounding plus f32 summation order (raises otherwise); the relative
    errors of v5, v6 and v8 against v0."""
    want = variants["v0_full"].run()
    got = {tag: variants[tag].run() for tag in ("v5_minfold", "v6_bf16",
                                                "v8_w4a8") if tag in variants}
    errs = {tag: rel_err(y, want) for tag, y in got.items()}
    limit = Q.bf16_ulp(want) + F32_REL * want.float().abs().max()
    excess = ((got["v5_minfold"] - want.float()).abs() - limit).max().item()
    if excess > 0:
        raise SystemExit(f"bench_kernel_variants: v5_minfold differs from "
                         f"v0_full by {excess:.3g} beyond the limit")
    return errs


def time_interleaved(fns: dict, timer: Timer, rounds: int = ROUNDS,
                     per_round: int = PER_ROUND) -> dict[str, dict]:
    """Each function's median time (ms) and spread over ``rounds`` rounds in
    which every function runs ``per_round`` single timed launches in turn."""
    for fn in fns.values():
        fn()
        fn()
    times = {tag: [] for tag in fns}
    for _ in range(rounds):
        for tag, fn in fns.items():
            times[tag] += [timer.once(fn) for _ in range(per_round)]
    out = {}
    for tag, ts in times.items():
        med = median(ts)
        out[tag] = dict(ms=med, spread=(max(ts) - min(ts)) / med)
    return out


def probe_shape(fmt: str, k: int, n: int, rng, device, timer: Timer | None,
                peaks: dict | None) -> dict:
    """Gates and (on a card) times of every variant at one shape; prints a
    line per variant. Returns {tag: {...}}."""
    inp = make_inputs(fmt, k, n, rng, device)
    variants = build_variants(inp)
    lin = inp["lin_full"]
    panel_bytes = _nbytes(lin.packed, lin.scales, lin.mins)
    print(f"K={k:6d} N={n:6d} ({panel_bytes / 1e6:6.2f} MB packed + bf16 "
          f"panels)", flush=True)
    errs = gates(variants)
    for tag, err in errs.items():
        print(f"  {tag} rel-err vs v0: {err:.5f}", flush=True)
    fns = {tag: v.run for tag, v in variants.items()}
    fns["floor"] = floor_fn(inp)
    work = {tag: (v.nbytes, v.ops, v.op_type) for tag, v in variants.items()}
    work["floor"] = (panel_bytes, 0, "f32")
    timed = (time_interleaved(fns, timer) if timer is not None else
             {tag: dict(ms=None, spread=None) for tag in fns})
    out = {}
    for tag, (nbytes, ops, op_type) in work.items():
        m = dict(timed[tag], nbytes=nbytes, ops=ops, op_type=op_type,
                 rel_err_vs_v0=errs.get(tag))
        if peaks is not None:
            m["bound_ms"], m["bound_by"] = bound_ms(nbytes, ops, op_type,
                                                    peaks)
        out[tag] = m
        if m["ms"] is None:
            print(f"  {tag:<11} not measured (no card)", flush=True)
            continue
        byte_ms = nbytes / peaks["bytes"] * 1e3
        print(f"  {tag:<11} {m['ms'] * 1e3:8.2f} us "
              f"{nbytes / m['ms'] / 1e6:7.1f} GB/s "
              f"{100 * byte_ms / m['ms']:5.1f}% of its byte bound "
              f"({byte_ms * 1e3:.2f} us); bound {m['bound_ms'] * 1e3:.2f} us "
              f"({m['bound_by']})  spread {m['spread']:.0%}", flush=True)
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m llama_gguf_tpu_torch.scripts.bench_kernel_variants",
        description="Time dequant-matmul variants at decode shapes.")
    ap.add_argument("fmt", nargs="?", default="q8", choices=("q8", "q4"))
    ap.add_argument("shape", nargs="*", type=int, metavar="K N")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.shape and len(args.shape) != 2:
        ap.error("give K and N, or neither")
    shapes = [tuple(args.shape)] if args.shape else list(SHAPES)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not "
                           "available; pass --device cpu for the plain "
                           "versions")
    timer = peaks = None
    name = "cpu"
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        timer = Timer()
        name = torch.cuda.get_device_name(device)
        peaks = card_peaks(name)
    rng = np.random.default_rng(0)
    print(f"device={name} fmt={args.fmt} B={B} group={GROUP} "
          f"rounds={ROUNDS}x{PER_ROUND}", flush=True)
    return {f"{args.fmt} {k}x{n}": probe_shape(args.fmt, k, n, rng, device,
                                               timer, peaks)
            for k, n in shapes}


if __name__ == "__main__":
    main(sys.argv[1:])
