"""Dequant-matmul variants of the decode-shape probe: wrappers over the CUDA
kernels of csrc/qmatmul_variants.cu and their plain PyTorch versions (port of
the Pallas bodies of scripts/bench_kernel_variants.py).

Each variant changes one piece of the q4/q8 dequant chain of
``ops.qmatmul.qmatmul`` (the probe's v0_full, with bf16 panels in "default"
precision), so that its time on the card says what that piece costs:

  * ``v2_noscale(x, lin)``          y = x @ q (q8; no scales, no mins)
  * ``v5_minfold(x, xg, lin)``      y = x @ (s*q) - xg^T @ m, in f32
  * ``v6_bf16(x, xg, lin)``         v5 with w = bf16(q * s) and x, xg
                                    rounded to bf16, products summed in f32
  * ``v7_int8(xi, lin)``            y = xi @ q, int8 x, i32 sums
  * ``v9_mulcost(xi, lin, u)``      y = xi @ wrap8(q * u) (q4; wrong by
                                    design: it measures the multiply's cost)
  * ``v10_4dot(xi, lin)``           y = sum (x_j + x_{j+h}) (lo_j + hi_j)
                                    (q4; four int8 products per byte)
  * ``v8_w4a8(xi, xg2, lin, u, m2, s_col)``  the w4a8 chain (q4):
                                    s_col * [sum_g u * (xi @ q)_g - xg2^T @ m2]

Kernels (counted in ``LAUNCHES``): "variant_f32" (v2, v5), "variant_bf16"
(v6), "variant_int8" (v7, v9, v10), "variant_w4a8" (v8), all on the tensor
cores (bf16 or s8 ``mma.sync``), one launch a call, K cut into slices as
``variant_plan`` says (the partials summed in slice order inside the launch,
through the per-device workspace of ``ops.qmatmul._scratch``). ``lin`` is a
``QuantLinear`` with bf16 panels (the probe's); ``xg`` and ``xg2`` are
per-group sums of x, [K/group, B] (``group_sums``), computed outside the
kernels as the probe computed them outside its Pallas calls. Each nibble
meets its own element of x. As in ops/qmatmul.py, a wrapper runs the plain
version only for a CPU tensor; for a CUDA tensor it launches the kernel or
raises, also on a layout the kernels do not take (``check_layout``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .linear import QuantLinear, unpack_q4
from .qmatmul import H100_SMS, QmatmulPlan, _scratch, _sms

LAUNCHES = {"variant_f32": 0, "variant_bf16": 0, "variant_int8": 0,
            "variant_w4a8": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "variant_f32_launch": [_P] * 8 + [_I] * 8 + [_P],
    "variant_bf16_launch": [_P] * 8 + [_I] * 7 + [_P],
    "variant_int8_launch": [_P] * 6 + [_I] * 8 + [_P],
    "variant_w4a8_launch": [_P] * 9 + [_I] * 6 + [_P],
}
INT8_MODES = {"v7": 0, "v9": 1, "v10": 2}

# The kernels' tiles (csrc/qmatmul_variants.cu): a block owns TILE_ROWS rows
# x TILE_COLS weight columns x one K slice of whole units of max(group,
# STAGE_K) elements, no slice longer than SLICE_MAX_K (the block stages the
# slice's group sums whole).
TILE_ROWS = 8
TILE_COLS = 128
STAGE_K = 64
SLICE_MAX_K = 1024
MIN_SLICE_K = 256      # shorter slices only where SLICE_MAX_K forces them
BLOCKS_PER_SM = 3      # the grid the split of K aims for


def check_layout(fmt: str, k: int, group: int) -> None:
    """Raises ValueError on a weight layout the kernels do not take: q4 or
    q8 with a group of 16 to SLICE_MAX_K that is a power of two, k a
    multiple of max(group, STAGE_K) (csrc/qmatmul_variants.cu's header says
    why)."""
    if fmt not in ("q4", "q8") or group < 16 or group > SLICE_MAX_K \
            or group & (group - 1) or k <= 0 or k % max(group, STAGE_K):
        raise ValueError(f"unsupported layout fmt={fmt} k={k} group={group} "
                         f"(groups: powers of two 16..{SLICE_MAX_K}; k a "
                         f"multiple of max(group, {STAGE_K}))")


@functools.lru_cache(maxsize=256)
def variant_plan(b: int, k: int, n: int, group: int, fmt: str,
                 sms: int = H100_SMS, aligned: bool = True) -> QmatmulPlan:
    """The launch of a variant kernel for x [b, k] @ W [k, n]: a
    tensor-core plan of TILE_ROWS x TILE_COLS tiles, its grid (splits, row
    tiles, column tiles), K cut into slices of whole units of max(group,
    STAGE_K) elements (whole scale groups, as the kernel cuts them) until
    the grid holds BLOCKS_PER_SM blocks per SM, no slice shorter than
    MIN_SLICE_K unless SLICE_MAX_K forces it, none longer than SLICE_MAX_K.
    With splits > 1 the partials are float32, or int32 for the integer
    variants: 4 bytes each, as ``scratch_bytes`` counts them. Raises
    ValueError on a layout ``check_layout`` refuses."""
    check_layout(fmt, k, group)
    if n <= 0 or b < 1:
        raise ValueError(f"variant_plan: empty product {b} x {k} x {n}")
    unit_k = max(group, STAGE_K)
    units = k // unit_k
    fewest = -(-units // (SLICE_MAX_K // unit_k))
    row_tiles, col_tiles = -(-b // TILE_ROWS), -(-n // TILE_COLS)
    want = -(-BLOCKS_PER_SM * sms // (row_tiles * col_tiles))
    splits = min(units, max(fewest, min(want, k // max(MIN_SLICE_K, unit_k))))
    if row_tiles > 65535 or col_tiles > 65535:
        raise ValueError(f"variant_plan: {b} x {n} exceeds the grid")
    return QmatmulPlan("tc", TILE_ROWS, TILE_COLS, splits,
                       (splits, row_tiles, col_tiles),
                       aligned and n % 16 == 0)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def group_sums(x: torch.Tensor, group: int) -> torch.Tensor:
    """Per-group sums of x [B, K] -> [K/group, B] float32 (the probe's
    transposed xg)."""
    b, k = x.shape
    return x.float().reshape(b, k // group, group).sum(-1).t().contiguous()


def repeat_rows(s: torch.Tensor, rep: int) -> torch.Tensor:
    """Each row of s [G, N] repeated ``rep`` times -> [G*rep, N]."""
    return s.repeat_interleave(rep, dim=0)


# -- plain versions -----------------------------------------------------------


def weight_ints(lin: QuantLinear) -> torch.Tensor:
    """The integer weights q [K, N] (q4: the nibbles 0..15, q8: the int8
    values) as int32."""
    q = unpack_q4(lin) if lin.fmt == "q4" else lin.packed
    return q.to(torch.int32)


def _srep(panel: torch.Tensor, group: int) -> torch.Tensor:
    return repeat_rows(panel.float(), group)


def v2_noscale_plain(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    return torch.matmul(x.float(), weight_ints(lin).float())


def v5_minfold_plain(x: torch.Tensor, xg: torch.Tensor | None,
                     lin: QuantLinear) -> torch.Tensor:
    y = torch.matmul(x.float(),
                     weight_ints(lin).float() * _srep(lin.scales, lin.group))
    if lin.mins is not None:
        y = y - torch.matmul(xg.t(), lin.mins.float())
    return y


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def v6_bf16_plain(x: torch.Tensor, xg: torch.Tensor | None,
                  lin: QuantLinear) -> torch.Tensor:
    w = _bf16(weight_ints(lin).float() * _srep(lin.scales, lin.group))
    y = torch.matmul(_bf16(x), w)
    if lin.mins is not None:
        y = y - torch.matmul(_bf16(xg).t(), lin.mins.float())
    return y


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An integer product summed exactly (float64 holds every sum here) and
    written as float32, as the kernels write their i32 sums."""
    return torch.matmul(a.double(), b.double()).float()


def _wrap8(v: torch.Tensor) -> torch.Tensor:
    """v modulo 256 as a signed byte (the int8 cast of a wider integer)."""
    v = v & 0xFF
    return torch.where(v >= 128, v - 256, v)


def _q4_halves(xi: torch.Tensor, lin: QuantLinear):
    """(x_lo, x_hi, lo, hi): the elements of x that meet the low and the
    high nibble of each packed row, and the nibbles, for the group-split q4
    layout (packed row r = g * h + j holds elements g*group + j and
    g*group + h + j)."""
    b, k = xi.shape
    h = lin.group // 2
    x3 = xi.reshape(b, k // lin.group, lin.group)
    x_lo = x3[:, :, :h].reshape(b, k // 2)
    x_hi = x3[:, :, h:].reshape(b, k // 2)
    p = lin.packed.to(torch.int32)
    return x_lo, x_hi, p & 0x0F, p >> 4


def v7_int8_plain(xi: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    return _int_matmul(xi, weight_ints(lin))


def v9_mulcost_plain(xi: torch.Tensor, lin: QuantLinear,
                     u: torch.Tensor) -> torch.Tensor:
    q = weight_ints(lin) * repeat_rows(u.to(torch.int32), lin.group)
    return _int_matmul(xi, _wrap8(q))


def v10_4dot_plain(xi: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    x_lo, x_hi, lo, hi = _q4_halves(xi.to(torch.int32), lin)
    return _int_matmul(x_lo + x_hi, lo + hi)


def v8_w4a8_plain(xi: torch.Tensor, xg2: torch.Tensor, lin: QuantLinear,
                  u: torch.Tensor, m2: torch.Tensor,
                  s_col: torch.Tensor) -> torch.Tensor:
    qu = weight_ints(lin) * repeat_rows(u.to(torch.int32), lin.group)
    inner = torch.matmul(xi.double(), qu.double()) - torch.matmul(
        xg2.double().t(), m2.double())
    return inner.float() * s_col


# -- kernel launches ----------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load

    return load("qmatmul_variants", SIGNATURES)


def _cuda(x: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (the caller runs the plain version); True for
    a CUDA one; raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    return True


def _need(t: torch.Tensor | None, dtype: torch.dtype, shape: tuple,
          device: torch.device, what: str) -> None:
    if t is None:
        raise ValueError(f"{what} is required")
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _check_weight(lin: QuantLinear, device: torch.device, panels: bool,
                  what: str) -> None:
    """The packed weight (and, with ``panels``, its bf16 panels)."""
    try:
        check_layout(lin.fmt, lin.k, lin.group)
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None
    packed = ((torch.uint8, (lin.k // 2, lin.n)) if lin.fmt == "q4"
              else (torch.int8, (lin.k, lin.n)))
    _need(lin.packed, *packed, device, f"{what} packed")
    if panels:
        panel = (lin.k // lin.group, lin.n)
        _need(lin.scales, torch.bfloat16, panel, device, f"{what} scales")
        if lin.mins is not None:
            _need(lin.mins, torch.bfloat16, panel, device, f"{what} mins")


def _plan(x: torch.Tensor, lin: QuantLinear, what: str,
          *tensors: torch.Tensor | None) -> QmatmulPlan:
    """The call's plan: x (f32 or int8 rows) must be 16-byte aligned; the
    packed data and ``tensors`` (panels) decide the 16-byte copies."""
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 16-byte aligned")
    aligned = all(t.data_ptr() % 16 == 0 for t in (lin.packed, *tensors)
                  if t is not None)
    try:
        return variant_plan(x.shape[0], lin.k, lin.n, lin.group, lin.fmt,
                            _sms(x.device), aligned)
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None


def _launch(fn: str, kernel: str, x: torch.Tensor, plan: QmatmulPlan,
            *args) -> None:
    """One launch of ``fn``; ``args`` up to the workspace, then the plan's
    workspace, counters, shape, the kernel's own ints, splits, vec and the
    stream."""
    *ptrs, ints = args
    ws, counters = _scratch(x.device, plan)
    rc = getattr(_lib(), fn)(*ptrs, ws, counters, *ints, plan.splits,
                             int(plan.vec), _stream(x))
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    LAUNCHES[kernel] += 1


def _ptr(t: torch.Tensor | None) -> int | None:
    return t.data_ptr() if t is not None else None


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _float_variant(x, xg, lin, what: str) -> torch.Tensor:
    """v2_noscale and v5_minfold (kernel variant_f32) or v6_bf16
    (variant_bf16)."""
    b = x.shape[0]
    panels = what != "v2_noscale"
    _need(x, torch.float32, (b, lin.k), x.device, f"{what} x")
    _check_weight(lin, x.device, panels, what)
    with_mins = panels and lin.mins is not None
    if with_mins:
        _need(xg, torch.float32, (lin.k // lin.group, b), x.device,
              f"{what} xg")
    y = torch.empty((b, lin.n), dtype=torch.float32, device=x.device)
    if b == 0:
        return y
    scales = lin.scales if panels else None
    mins = lin.mins if with_mins else None
    kernel = "variant_bf16" if what == "v6_bf16" else "variant_f32"
    plan = _plan(x, lin, what, scales, mins)
    ptrs = (x.data_ptr(), _ptr(xg if with_mins else None),
            lin.packed.data_ptr(), _ptr(scales), _ptr(mins), y.data_ptr())
    shape = (b, lin.k, lin.n, lin.group, 0 if lin.fmt == "q4" else 1)
    if kernel == "variant_bf16":
        _launch("variant_bf16_launch", kernel, x, plan, *ptrs, shape)
    else:
        _launch("variant_f32_launch", kernel, x, plan, *ptrs,
                (*shape, int(what == "v5_minfold")))
    return y


def v2_noscale(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    if not _cuda(x, "v2_noscale"):
        return v2_noscale_plain(x, lin)
    return _float_variant(x, None, lin, "v2_noscale")


def v5_minfold(x: torch.Tensor, xg: torch.Tensor | None,
               lin: QuantLinear) -> torch.Tensor:
    if not _cuda(x, "v5_minfold"):
        return v5_minfold_plain(x, xg, lin)
    return _float_variant(x, xg, lin, "v5_minfold")


def v6_bf16(x: torch.Tensor, xg: torch.Tensor | None,
            lin: QuantLinear) -> torch.Tensor:
    if not _cuda(x, "v6_bf16"):
        return v6_bf16_plain(x, xg, lin)
    return _float_variant(x, xg, lin, "v6_bf16")


def _int8_variant(xi, lin, u, mode: str) -> torch.Tensor:
    b = xi.shape[0]
    what = {"v7": "v7_int8", "v9": "v9_mulcost", "v10": "v10_4dot"}[mode]
    _need(xi, torch.int8, (b, lin.k), xi.device, f"{what} xi")
    _check_weight(lin, xi.device, False, what)
    if mode != "v7" and lin.fmt != "q4":
        raise ValueError(f"{what}: q4 only, as in the probe")
    if mode == "v9":
        _need(u, torch.int8, (lin.k // lin.group, lin.n), xi.device,
              f"{what} u")
    y = torch.empty((b, lin.n), dtype=torch.float32, device=xi.device)
    if b == 0:
        return y
    uu = u if mode == "v9" else None
    plan = _plan(xi, lin, what, uu)
    _launch("variant_int8_launch", "variant_int8", xi, plan, xi.data_ptr(),
            lin.packed.data_ptr(), _ptr(uu), y.data_ptr(),
            (b, lin.k, lin.n, lin.group, 0 if lin.fmt == "q4" else 1,
             INT8_MODES[mode]))
    return y


def v7_int8(xi: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    if not _cuda(xi, "v7_int8"):
        return v7_int8_plain(xi, lin)
    return _int8_variant(xi, lin, None, "v7")


def v9_mulcost(xi: torch.Tensor, lin: QuantLinear,
               u: torch.Tensor) -> torch.Tensor:
    if not _cuda(xi, "v9_mulcost"):
        return v9_mulcost_plain(xi, lin, u)
    return _int8_variant(xi, lin, u, "v9")


def v10_4dot(xi: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    if not _cuda(xi, "v10_4dot"):
        return v10_4dot_plain(xi, lin)
    return _int8_variant(xi, lin, None, "v10")


def v8_w4a8(xi: torch.Tensor, xg2: torch.Tensor, lin: QuantLinear,
            u: torch.Tensor, m2: torch.Tensor,
            s_col: torch.Tensor) -> torch.Tensor:
    """The w4a8 kernel's part of v8: s_col * [sum_g u_g (xi @ q)_g - xg2^T @
    m2]; the caller multiplies row b by its t_b."""
    if not _cuda(xi, "v8_w4a8"):
        return v8_w4a8_plain(xi, xg2, lin, u, m2, s_col)
    what = "v8_w4a8"
    b = xi.shape[0]
    panel = (lin.k // lin.group, lin.n)
    _need(xi, torch.int8, (b, lin.k), xi.device, f"{what} xi")
    if lin.fmt != "q4":
        raise ValueError(f"{what}: q4 only")
    _check_weight(lin, xi.device, False, what)
    _need(xg2, torch.float32, (lin.k // lin.group, b), xi.device,
          f"{what} xg2")
    _need(u, torch.int8, panel, xi.device, f"{what} u")
    _need(m2, torch.bfloat16, panel, xi.device, f"{what} m2")
    _need(s_col, torch.float32, (lin.n,), xi.device, f"{what} s_col")
    y = torch.empty((b, lin.n), dtype=torch.float32, device=xi.device)
    if b == 0:
        return y
    plan = _plan(xi, lin, what, u, m2)
    _launch("variant_w4a8_launch", "variant_w4a8", xi, plan, xi.data_ptr(),
            xg2.data_ptr(), lin.packed.data_ptr(), u.data_ptr(),
            m2.data_ptr(), s_col.data_ptr(), y.data_ptr(),
            (b, lin.k, lin.n, lin.group))
    return y
