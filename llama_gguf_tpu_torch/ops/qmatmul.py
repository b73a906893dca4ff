"""Fused dequant-matmul: wrappers over the CUDA kernels of csrc/qgemm.cu and
csrc/moe_qmatmul.cu and their plain PyTorch versions (port of
llama_gguf_tpu/ops/qmatmul.py).

  * ``qmatmul(x, lin)``          — y = x @ W for a q4 or q8 QuantLinear
                                    (kernels "qmatmul_q4" and "qmatmul_q8" of
                                    csrc/qgemm.cu, replacing _qmatmul_call's
                                    _q4_kernel and _q8_kernel; the path, tile
                                    and split of K come from
                                    ``qmatmul_plan``);
  * ``qmatmul_glu(x, lin, act)`` — act(x @ W_gate) * (x @ W_up) over a fused
                                    [gate | up] QuantLinear (kernel
                                    "qmatmul_glu" of csrc/qgemm.cu, replacing
                                    _qmatmul_glu_call's _glu_kernel; planned
                                    by ``qmatmul_plan(..., glu=True)``);
  * ``moe_qmatmul(x_rows, stack, idx)`` — y[s] = x[s] @ W[idx[s]] for routed
                                    MoE slots over a QuantExpertStack:
                                    slot-major (kernel "moe_slot", replacing
                                    _moe_qmatmul_call: the split-K path of
                                    csrc/qgemm.cu with an expert per row;
                                    ``moe_slot_plan``) at decode-sized S,
                                    else grouped by expert (kernel
                                    "moe_grouped", replacing
                                    _moe_qmatmul_grouped_call: the
                                    tensor-core path of csrc/qgemm.cu, or
                                    the CUDA-core kernel of
                                    csrc/moe_qmatmul.cu for the layouts it
                                    does not take; ``moe_grouped_plan``);
  * ``moe_qmatmul_glu(x_rows, gate, up, idx, act)`` — the grouped gate/up
                                    product with the GLU epilogue (kernel
                                    "moe_glu_grouped", replacing
                                    _moe_glu_grouped_call: the same two
                                    paths; ``moe_glu_grouped_plan``).

A wrapper runs the plain version only when ``x`` lies on the CPU. For a CUDA
tensor it launches the kernel or raises; there is no fallback. ``LAUNCHES``
counts kernel launches, one per launch, so a run can show that its main path
went through the kernels; ``LAUNCHES_BY_PATH`` counts the same launches by
kernel and path ("moe_slot splitk", "moe_glu_grouped tc", ...). What bounds
each kernel on the card and how its design meets that is written at the top
of each CUDA source.

CUDA graphs (engine/runner.py). A wrapper called while a stream is captured
records its launch instead of making it, so the counters it bumps then are
taken back by the capturer (``launch_counts``, ``credit``) and credited again
at every replay. The split-K workspace and tile counters (``_scratch``) are
never freed once handed out: a captured graph keeps their addresses. They
must be large enough before a capture starts (the runner's eager warm-up
run grows them); growing them during a capture raises, as does building a
kernel library then.

Precision (``precision`` of each entry): "highest" or None gives float32
outputs; "default" gives bfloat16 outputs, the f32 sums rounded once (the
JAX package's ``_out_dtype``). The JAX entries resolve None from the ambient
``jax.default_matmul_precision``; the port has no ambient setting, so its
runner passes its ``matmul_precision`` down explicitly. Scale and min panels
are float32 or bfloat16 (``ModelLoader(scale_dtype=)``); the MoE kernels take
float32 panels only, as the loader keeps expert stacks.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .linear import (QuantExpertStack, QuantLinear, dequantize_expert,
                     dequantize_weight)

GLU_ACTS = ("silu", "gelu", "relu", "relu2", "swiglu_oai")

LAUNCHES = {"qmatmul_q4": 0, "qmatmul_q8": 0, "qmatmul_glu": 0,
            "moe_slot": 0, "moe_grouped": 0, "moe_glu_grouped": 0,
            # csrc/shortconv.cu (ops/shortconv.py), counted here so that a
            # graph's replays credit it with the others
            "short_conv": 0}
LAUNCHES_BY_PATH: dict[str, int] = {}

# Slot-major MoE kernel below this many slots; grouped above, when its
# ceil(S/C) + E expert sweeps undercut the slot-major kernel's S sweeps (the
# JAX package's rule: it counts expert sweeps, not TPU tiles).
MOE_GROUPED_MIN_SLOTS = 32
MOE_GROUP_ROWS = 256  # C: rows per single-expert block


PRECISIONS = (None, "highest", "default")

# Kernels 1-3 (csrc/qgemm.cu): the tensor-core path from this many rows on,
# the split-K CUDA-core path below (see qmatmul_plan). From 5 rows the tensor
# cores were at least as fast as split-K at 7 of 9 main-path shapes
# (scripts/bench_qmatmul.py paths, H100 80GB HBM3, 700 W).
TC_MIN_ROWS = 5
TC_COLS = 128          # columns per tensor-core block (4 warps x 32)
TC_STAGE = 32          # K elements per tensor-core stage (2, 1 or 1/8 group)
SPLITK_COLS = 128      # columns per split-K block (8 threads x 16)
MAX_SPLITS = 32        # K slices per output tile
# The grid the split of K aims for, in blocks per SM: 64-thread split-K
# blocks (8 fit an SM); 128-thread tensor-core blocks (2-3 fit), at most 2
# per SM for 32- and 64-row tiles up to 128 rows, where longer slices won
# the sweep of scripts/bench_qmatmul.py (H100 80GB HBM3, 700 W).
BLOCKS_PER_SM = {"splitk": 8, "tc": 4, "tc prefill": 2}
H100_SMS = 132


@dataclass(frozen=True)
class QmatmulPlan:
    """How one q4/q8 product is launched: ``path`` "tc" (tensor cores) or
    "splitk" (CUDA cores, one row per block); a block owns ``rows`` x
    ``cols`` columns of the weight (``out_cols`` of the output: half of
    them for the GLU, whose block reads 64 gate columns and their 64 up
    columns) and one of ``splits`` K slices of whole ``slice_units``; ``grid``
    is (splits, row tiles, column tiles); ``vec``: 16-byte loads (N % 16
    == 0 and aligned tensors). With splits > 1 each block writes its f32
    partial tile to a workspace of ``scratch_bytes`` and the last block of
    a tile (one int counter per tile) adds them in slice order. The grouped
    MoE products' "cuda cores" path (csrc/moe_qmatmul.cu) sets its own
    tile and grid: rows and cols 0, grid None, one slice."""
    path: str
    rows: int
    cols: int
    splits: int
    grid: tuple[int, int, int] | None
    vec: bool
    glu: bool = False

    @property
    def out_cols(self) -> int:
        return self.cols // 2 if self.glu else self.cols

    @property
    def tiles(self) -> int:
        return self.grid[1] * self.grid[2]

    @property
    def scratch_bytes(self) -> int:
        return (4 * self.tiles * self.splits * self.rows * self.cols
                if self.splits > 1 else 0)

    @property
    def tile(self) -> int:
        """The kernel's tile argument: 16-row tiles (tc) or rows (splitk)."""
        return self.rows // 16 if self.path == "tc" else self.rows

    def op_type(self, precision: str | None = None) -> str:
        """The operations' type for utils/timing.bound_ms: bf16 tensor-core
        passes, three for an f32 output and two for the bf16 output of
        "default" (the kernel drops x's third part there); or f32 on the
        CUDA cores (split-K, whose bound is the bytes at decode sizes)."""
        if self.path != "tc":
            return "f32"
        return "bf16x2" if out_dtype(precision) == torch.bfloat16 else "bf16x3"


def _layout(k: int, n: int, group: int, fmt: str, aligned: bool
            ) -> tuple[bool, bool]:
    """(vec, tc_ok) of a q4/q8 weight of k rows and n output columns: the
    16-byte loads need n % 16 == 0 and aligned tensors; the tensor cores
    those, whole 32-element stages and q4 group 16 (Q2_K) or 32, or q8
    group 16, 32 or 256 (Q8_K, no min panels). Raises on what no
    kernel takes: q4 groups other than 16 and multiples of 32, q8 groups
    not a multiple of 16, k not a multiple of the split-K slice unit."""
    if fmt not in ("q4", "q8") or (group % 16 if fmt == "q8" else
                                   group != 16 and group % 32) \
            or k % group or k % _unit_k(group, fmt):
        raise ValueError(f"qmatmul_plan: fmt={fmt} k={k} group={group}")
    vec = aligned and n % 16 == 0
    return vec, (vec and k % TC_STAGE == 0
                 and group in ((16, 32) if fmt == "q4" else (16, 32, 256)))


def _unit_k(group: int, fmt: str) -> int:
    """K elements per unit of a split-K slice (csrc/qgemm.cu sk_unit_rows
    packed rows): a whole group of 16 or 32 packed rows, two groups of 8
    (q4 group 16), or 32 rows of a longer group (q8 group 256)."""
    per_row = 2 if fmt == "q4" else 1
    return per_row * min(max(group // per_row, 16), 32)


def slice_units(k: int, group: int, fmt: str, path: str) -> int:
    """The units a K slice is made of, as the kernels cut K: split-K's of
    ``_unit_k`` elements; the tensor cores' 32-element stages, or whole
    groups where a group spans several stages."""
    if path == "splitk":
        return k // _unit_k(group, fmt)
    return k // max(group, TC_STAGE)


def _check_splits(splits: int, k: int, group: int, fmt: str,
                  path: str) -> None:
    units = slice_units(k, group, fmt, path)
    if not 1 <= splits <= min(MAX_SPLITS, units):
        raise ValueError(f"qmatmul_plan: {splits} splits of {units} units")


@functools.lru_cache(maxsize=1024)
def qmatmul_plan(b: int, k: int, n: int, group: int, fmt: str,
                 sms: int = H100_SMS, aligned: bool = True,
                 path: str | None = None, splits: int | None = None,
                 tile_rows: int | None = None, glu: bool = False
                 ) -> QmatmulPlan:
    """The launch of kernels 1-3 for x [b, k] @ W [k, n]; with ``glu``
    (kernel 3) n is the output width F of the fused [k, 2F] gate|up weight,
    and a block's 128 weight columns are 64 gate columns and their 64 up
    columns (the grid has ceil(F / 64) column tiles; above 64 rows its
    tiles are 64 rows high only where that grid still holds
    BLOCKS_PER_SM["tc prefill"] blocks per SM: at TinyLlama's 128-row
    prefill 32-row tiles took 0.126 ms against 0.149, bench_qmatmul paths,
    H100 80GB HBM3, 700 W). Tensor cores from
    TC_MIN_ROWS rows on, where the layout allows them (``_layout``: q4
    group 16 or 32, q8 group 16, 32 or 256, 16-byte loads);
    BM = 16 rows x 128 columns up to 16 rows, 32 up to 64 rows or below
    4096 columns, else 64. Below, the split-K kernel: one row x 128 columns.
    Either way K is cut into up to MAX_SPLITS slices of whole
    ``slice_units`` (whole 32-element stages or groups on the tensor
    cores, 8 stages per slice at least, for the cp.async ring; split-K: 6
    chunks of 16 packed rows at least, the GLU 8) until the grid holds
    BLOCKS_PER_SM blocks per SM: rounded up, or down for the tensor cores'
    32- and 64-row tiles up to 128 rows. ``path``, ``splits`` and
    ``tile_rows`` (tc: 16, 32 or 64) override the choice (measurements and
    tests); a path the layout does not allow raises.
    Cached: decode asks for the same few plans at every step."""
    if b < 1:
        raise ValueError(f"qmatmul_plan: b={b}")
    vec, tc_ok = _layout(k, n, group, fmt, aligned)
    if path is None:
        path = "tc" if tc_ok and b >= TC_MIN_ROWS else "splitk"
    if path == "tc" and tc_ok:
        cols, slices_max = TC_COLS, k // TC_STAGE // 8
        if glu:  # 64-row tiles only where their grid still fills the card
            fill = (-(-b // 64) * -(-n // (cols // 2))
                    >= BLOCKS_PER_SM["tc prefill"] * sms)
            rows = tile_rows or (16 if b <= 16 else 64 if b > 64 and fill
                                 else 32)
        else:
            rows = tile_rows or (16 if b <= 16 else 32 if b <= 64 or n < 4096
                                 else 64)
        if rows not in (16, 32, 64):
            raise ValueError(f"qmatmul_plan: tile_rows={rows}")
    elif path == "splitk":
        cols, rows = SPLITK_COLS, 1
        # chunks of 16 packed rows per slice: at least 6; the GLU's at
        # least 8, one per thread along K (at TinyLlama's gate|up 8 slices
        # took 0.0171-0.0174 ms, 10 took 0.0186-0.0190, bench_qmatmul
        # paths, two calls, H100 80GB HBM3, 700 W)
        slices_max = max(1, k // (32 if fmt == "q4" else 16) // (8 if glu
                                                                 else 6))
    else:
        raise ValueError(f"qmatmul_plan: no {path!r} path for fmt={fmt} "
                         f"group={group} n={n} aligned={aligned}")
    row_tiles, col_tiles = -(-b // rows), -(-n // (cols // 2 if glu else cols))
    if splits is None:
        tiles = row_tiles * col_tiles
        if path == "tc" and rows >= 32 and b <= 128:
            want = BLOCKS_PER_SM["tc prefill"] * sms // tiles
        else:
            want = -(-BLOCKS_PER_SM[path] * sms // tiles)
        splits = max(1, min(MAX_SPLITS, slices_max, want))
    _check_splits(splits, k, group, fmt, path)
    if row_tiles > 65535 or col_tiles > 65535:
        raise ValueError(f"qmatmul_plan: {b} x {n} exceeds the grid")
    return QmatmulPlan(path, rows, cols, splits, (splits, row_tiles, col_tiles),
                       vec, glu)


@functools.lru_cache(maxsize=256)
def moe_grouped_plan(s_slots: int, e_num: int, k: int, n: int, group: int,
                     fmt: str, sms: int = H100_SMS, aligned: bool = True,
                     path: str | None = None, splits: int | None = None,
                     tile_rows: int | None = None,
                     glu: bool = False) -> QmatmulPlan:
    """The launch of kernel 5 (with ``glu``: kernel 6, n the output width F
    of each of the gate and up stacks) for S slots over E experts, where the
    grouped rule of ``moe_dims`` holds (G groups of C rows). "tc": the
    tensor-core path of csrc/qgemm.cu with gathered rows, where the layout
    allows it (as for ``qmatmul_plan``); a block owns BM rows of the [G*C]
    blocked layout x 128 weight columns (kernel 6: 64 gate and their 64 up
    columns, ceil(F/64) column tiles) x one K slice. BM (16, 32 or 64)
    follows qmatmul_plan's rule at the mean slots per expert, at most C;
    both are powers of two and C >= 32 here, so BM divides C and no tile
    straddles two groups. Only the tiles that hold a slot work (at most
    ceil(S/BM) + E: each expert's last tile may be part padding); the rest
    exit at once, so the split of K aims the live tiles at
    BLOCKS_PER_SM["tc prefill"] blocks per SM. Other layouts: "cuda cores",
    the grouped kernels of csrc/moe_qmatmul.cu, which set their own tile,
    grid and loads (K unsplit). ``path``, ``splits`` and ``tile_rows``
    override the choice."""
    c_rows, g_blocks, grouped = moe_dims(s_slots, e_num)
    if not grouped:
        raise ValueError(f"moe_grouped_plan: S={s_slots} over E={e_num} is "
                         "not grouped")
    vec, tc_ok = _layout(k, n, group, fmt, aligned)
    if path is None:
        path = "tc" if tc_ok else "cuda cores"
    b = g_blocks * c_rows
    if path == "cuda cores":
        return QmatmulPlan(path, 0, 0, 1, None, False, glu)
    if path != "tc" or not tc_ok:
        raise ValueError(f"moe_grouped_plan: no {path!r} path for fmt={fmt} "
                         f"group={group} n={n} aligned={aligned}")
    per_expert = -(-s_slots // e_num)
    # kernel 6 keeps 32-row tiles above 64 slots per expert: at Mixtral's
    # gate|up and 1024 slots they took 4.42 ms against 4.69 for 64 rows
    # (bench_qmatmul paths, H100 80GB HBM3, 700 W)
    rows = tile_rows or min(c_rows, 16 if per_expert <= 16 else 32
                            if per_expert <= 64 or n < 4096 or glu else 64)
    if rows not in (16, 32, 64) or c_rows % rows:
        raise ValueError(f"moe_grouped_plan: tile_rows={rows} for C={c_rows}")
    row_tiles, col_tiles = b // rows, -(-n // (TC_COLS // 2 if glu
                                               else TC_COLS))
    if splits is None:
        live = min(row_tiles, -(-s_slots // rows) + e_num)
        want = BLOCKS_PER_SM["tc prefill"] * sms // (live * col_tiles)
        splits = max(1, min(MAX_SPLITS, k // TC_STAGE // 8, want))
    _check_splits(splits, k, group, fmt, path)
    if row_tiles > 65535 or col_tiles > 65535:
        raise ValueError(f"moe_grouped_plan: {b} x {n} exceeds the grid")
    return QmatmulPlan(path, rows, TC_COLS, splits,
                       (splits, row_tiles, col_tiles), vec, glu)


def moe_glu_grouped_plan(s_slots: int, e_num: int, k: int, f: int,
                         group: int, fmt: str, sms: int = H100_SMS,
                         aligned: bool = True, path: str | None = None,
                         splits: int | None = None,
                         tile_rows: int | None = None) -> QmatmulPlan:
    """The launch of kernel 6 over gate and up stacks of output width F:
    ``moe_grouped_plan(..., glu=True)``."""
    return moe_grouped_plan(s_slots, e_num, k, f, group, fmt, sms, aligned,
                            path, splits, tile_rows, True)


@functools.lru_cache(maxsize=256)
def moe_slot_plan(s_slots: int, e_num: int, k: int, n: int, group: int,
                  fmt: str, sms: int = H100_SMS, aligned: bool = True,
                  splits: int | None = None) -> QmatmulPlan:
    """The launch of kernel 4 for S slots over E experts, where ``moe_dims``
    says slot-major: the split-K path of csrc/qgemm.cu with an expert per
    row, a block owning one slot x 128 columns x one K slice (at least 6
    chunks of 16 packed rows, as ``qmatmul_plan``'s split-K). K is split
    into as many slices as keep the grid of S x column tiles x splits
    within one wave of BLOCKS_PER_SM["splitk"] blocks per SM: rounded down,
    where kernels 1-2 round up. At Mixtral's 2 slots the rounded-up 5
    slices (1,120 blocks over 1,056 resident) took 0.0606 ms on the gate
    stack against 0.0453 for 4; on the down stack 17 slices 0.0689 against
    0.0571 for 16 (bench_qmatmul paths, H100 80GB HBM3, 700 W). Every
    layout ``qmatmul_plan`` takes: K % group == 0, q4 group 16 or a
    multiple of 32, q8 group 16 or a multiple, ragged N masked, byte loads
    where a tensor is not 16-byte aligned. ``splits`` overrides the
    choice."""
    if moe_dims(s_slots, e_num)[2]:
        raise ValueError(f"moe_slot_plan: S={s_slots} over E={e_num} is "
                         "grouped")
    if s_slots > 65535:
        raise ValueError(f"moe_slot_plan: {s_slots} slots exceed the grid")
    if splits is None:
        slices_max = max(1, k // (32 if fmt == "q4" else 16) // 6)
        one_wave = BLOCKS_PER_SM["splitk"] * sms // (s_slots
                                                     * -(-n // SPLITK_COLS))
        splits = max(1, min(MAX_SPLITS, slices_max, one_wave))
    return qmatmul_plan(s_slots, k, n, group, fmt, sms, aligned, "splitk",
                        splits)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    LAUNCHES_BY_PATH.clear()


def launch_counts(since: tuple[dict, dict] | None = None
                  ) -> tuple[dict, dict]:
    """A copy of (LAUNCHES, LAUNCHES_BY_PATH); with ``since`` (an earlier
    copy), the launches counted after it, nonzero entries only."""
    now = (dict(LAUNCHES), dict(LAUNCHES_BY_PATH))
    if since is None:
        return now
    return tuple({k: v - was.get(k, 0) for k, v in cur.items()
                  if v != was.get(k, 0)} for cur, was in zip(now, since))


def credit(counts: tuple[dict, dict], times: int = 1) -> None:
    """Add ``times`` x the launches of ``counts`` (a ``launch_counts``
    difference) to the counters: a graph replay makes the launches its
    capture recorded."""
    for key, n in counts[0].items():
        LAUNCHES[key] += times * n
    for key, n in counts[1].items():
        LAUNCHES_BY_PATH[key] = LAUNCHES_BY_PATH.get(key, 0) + times * n


def _count(name: str, plan: QmatmulPlan) -> None:
    """One launch of kernel ``name`` on ``plan``'s path."""
    LAUNCHES[name] += 1
    key = f"{name} {plan.path}"
    LAUNCHES_BY_PATH[key] = LAUNCHES_BY_PATH.get(key, 0) + 1


def out_dtype(precision: str | None) -> torch.dtype:
    """The kernels' output type: bfloat16 in "default" precision, float32
    otherwise (mirrors _out_dtype of the JAX package)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown matmul precision {precision!r}")
    return torch.bfloat16 if precision == "default" else torch.float32


def bf16_ulp(y: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each |y| (2^(e-8) for |y| = m 2^e, 0.5 <= m < 1):
    the most that rounding an f32 sum to a "default"-precision output, or
    summing in another order before rounding, moves it."""
    _, e = torch.frexp(y.float())
    return torch.ldexp(torch.ones_like(y, dtype=torch.float32), e - 8)


# -- plain versions -----------------------------------------------------------


def glu_combine(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    """The gated-activation epilogue, f32 in/out (mirrors _glu_combine)."""
    if act == "swiglu_oai":  # gpt-oss clamped SwiGLU
        g = torch.clamp(g, max=7.0)
        u = torch.clamp(u, -7.0, 7.0)
        return (g * torch.sigmoid(1.702 * g)) * (u + 1.0)
    if act == "gelu":  # tanh approximation (ggml_gelu)
        c = 0.7978845608028654  # sqrt(2/pi)
        return 0.5 * g * (1.0 + torch.tanh(c * (g + 0.044715 * g * g * g))) * u
    if act == "relu":
        return torch.relu(g) * u
    if act == "relu2":
        return torch.square(torch.relu(g)) * u
    return g * torch.sigmoid(g) * u  # silu


def qmatmul_plain(x: torch.Tensor, lin: QuantLinear,
                  precision: str | None = None) -> torch.Tensor:
    """Plain version of the q4/q8 kernels: dequantize W, then x @ W in f32,
    rounded to the output type once."""
    return torch.matmul(x.float(), dequantize_weight(lin)).to(
        out_dtype(precision))


def qmatmul_glu_plain(x: torch.Tensor, lin: QuantLinear, act: str,
                      precision: str | None = None) -> torch.Tensor:
    """Plain version of the GLU kernel."""
    f = lin.splits[0]
    y = qmatmul_plain(x, lin)
    return glu_combine(y[:, :f], y[:, f:], act).to(out_dtype(precision))


def expert_matmul(x_rows: torch.Tensor, stack,
                  idx: torch.Tensor) -> torch.Tensor:
    """y[s] = x_rows[s] @ W[idx[s]] in f32, one expert at a time: each
    expert's weight (a dense [E, K, N] stack's slice, or a QuantExpertStack's
    expert dequantized by ``dequantize_expert``) meets only the rows routed to
    it, so no weight is materialised per slot."""
    quant = isinstance(stack, QuantExpertStack)
    n = stack.n if quant else stack.shape[-1]
    x = x_rows.float()
    y = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    if not quant and x.device.type == "cuda":
        # a dense stack on the card (dequant mode): every row through every
        # expert, kept where routed. No row count reaches the host, so a
        # CUDA graph can capture the step.
        for e in range(stack.shape[0]):
            y = torch.where((idx == e)[:, None],
                            torch.matmul(x, stack[e].float()), y)
        return y
    for e in range(stack.shape[0]):
        sel = torch.nonzero(idx == e)[:, 0]
        if sel.numel():
            w = dequantize_expert(stack, e) if quant else stack[e].float()
            y[sel] = torch.matmul(x[sel], w)
    return y


def moe_qmatmul_plain(x_rows: torch.Tensor, stack: QuantExpertStack,
                      idx: torch.Tensor,
                      precision: str | None = None) -> torch.Tensor:
    """Plain version of the slot-major and grouped MoE kernels."""
    return expert_matmul(x_rows, stack, idx).to(out_dtype(precision))


def moe_qmatmul_glu_plain(x_rows: torch.Tensor, gate: QuantExpertStack,
                          up: QuantExpertStack, idx: torch.Tensor, act: str,
                          precision: str | None = None) -> torch.Tensor:
    """Plain version of the grouped GLU MoE kernel."""
    return glu_combine(expert_matmul(x_rows, gate, idx),
                       expert_matmul(x_rows, up, idx), act).to(
                           out_dtype(precision))


def moe_dims(s_slots: int, e_num: int) -> tuple[int, int, bool]:
    """(C rows per group, G groups, grouped?) for S slots over E experts:
    C = min(256, pow2 >= S, >= 8), G = ceil(S/C) + E, and the grouped kernels
    run when S >= 32 and G < S (the JAX package's moe_qmatmul rule)."""
    c_rows = min(MOE_GROUP_ROWS, max(8, 1 << (s_slots - 1).bit_length()))
    g_blocks = -(-s_slots // c_rows) + e_num
    return c_rows, g_blocks, (s_slots >= MOE_GROUPED_MIN_SLOTS
                              and g_blocks < s_slots)


def moe_group_plan(idx: torch.Tensor, e_num: int, c_rows: int,
                   g_blocks: int):
    """Static-shape dispatch plan of the grouped MoE kernels (port of
    _moe_group_plan): sort slots by expert, cut each expert's run into C-row
    blocks (the last one of each expert padded), and build the inverse map.
    Exact routing; imbalance is absorbed by the E spare blocks in G. Runs on
    the device with no host synchronisation. Returns int32 (eg [G] expert of
    each block, dummy blocks on expert 0; rows [G, C] slot ids with S as the
    padding sentinel; flat [S] index of each slot's row in the [G*C] blocked
    output)."""
    s = idx.shape[0]
    dev = idx.device
    idx = idx.long()
    order = torch.argsort(idx, stable=True)
    # bincount sizes its output from idx.max() on the host; a scatter-add
    # into E counters does not
    counts = torch.zeros(e_num, dtype=torch.long, device=dev).scatter_add_(
        0, idx, torch.ones_like(idx))
    starts = torch.cumsum(counts, 0) - counts
    nb = (counts + c_rows - 1) // c_rows
    bend = torch.cumsum(nb, 0)
    bstart = bend - nb
    gids = torch.arange(g_blocks, device=dev)
    eg = torch.searchsorted(bend, gids, right=True)
    live = eg < e_num
    eg = torch.where(live, eg, 0)
    bi = gids - bstart[eg]
    pos = (starts[eg] + bi * c_rows)[:, None] + torch.arange(c_rows,
                                                             device=dev)
    valid = live[:, None] & (pos < (starts[eg] + counts[eg])[:, None])
    rows = torch.where(valid, order[pos.clamp(0, s - 1)], s)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(s, device=dev))
    off = rank - starts[idx]
    flat = (bstart[idx] + off // c_rows) * c_rows + off % c_rows
    return eg.int(), rows.int(), flat.int()


# -- kernel launches ----------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "qgemm": {"qgemm_launch": [_P] * 12 + [_I] * 15 + [_P]},
    "moe_qmatmul": {
        "moe_grouped_launch": [_P] * 7 + [_I] * 10 + [_P],
        "moe_glu_grouped_launch": [_P] * 10 + [_I] * 11 + [_P],
    },
}


def _lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use (never
    during a CUDA graph capture: the warm-up run before it builds)."""
    from ..utils import cuda_build

    lib = cuda_build.loaded(name)
    if lib is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"csrc/{name}.cu is not built: run the step "
                               "once before capturing it")
        lib = cuda_build.load(name, SIGNATURES[name])
    return lib


def _check(x: torch.Tensor, lin: QuantLinear | QuantExpertStack) -> int:
    """Raise on what the kernels do not take: a QuantLinear's panels, or a
    QuantExpertStack's, which carry a leading expert axis. Returns 1 for
    bfloat16 panels, 0 for float32 ones."""
    lead = ((lin.packed.shape[0],) if isinstance(lin, QuantExpertStack)
            else ())
    sdt = lin.scales.dtype
    if sdt not in (torch.float32, torch.bfloat16) or (
            lin.mins is not None and lin.mins.dtype != sdt):
        raise ValueError(f"scale/min panels must both be float32 or both "
                         f"bfloat16, got {sdt} and "
                         f"{lin.mins.dtype if lin.mins is not None else None}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != lin.k:
        raise ValueError(f"x must be float32 [B, {lin.k}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    tensors = [lin.packed, lin.scales] + ([lin.mins] if lin.mins is not None
                                          else [])
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"weight on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError("weight panels must be contiguous")
    if lin.fmt not in ("q4", "q8") or lin.k % lin.group or lin.group % 16:
        raise ValueError(f"unsupported layout fmt={lin.fmt} k={lin.k} "
                         f"group={lin.group}")
    packed = ((torch.uint8, (*lead, lin.k // 2, lin.n)) if lin.fmt == "q4"
              else (torch.int8, (*lead, lin.k, lin.n)))
    if (lin.packed.dtype, tuple(lin.packed.shape)) != packed:
        raise ValueError(f"packed must be {packed}, got {lin.packed.dtype} "
                         f"{tuple(lin.packed.shape)}")
    panel = (*lead, lin.k // lin.group, lin.n)
    for t in tensors[1:]:
        if tuple(t.shape) != panel:
            raise ValueError(f"scale/min panels must be {panel}, got "
                             f"{tuple(t.shape)}")
    return int(sdt == torch.bfloat16)


def vec_ok(cols: int, *tensors: torch.Tensor | None) -> int:
    """1 when 4-column vector loads are legal: the column count is a
    multiple of 4 and each tensor is aligned to 4 of its elements (16 bytes
    for float32, 8 for bfloat16, 4 for bytes), which keeps every 4-column
    group of a row aligned."""
    return int(cols % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0
        for t in tensors if t is not None))


def _vec_ok(lin: QuantLinear | QuantExpertStack, cols: int,
            out: torch.Tensor) -> int:
    return vec_ok(cols, lin.packed, lin.scales, lin.mins, out)


def _ptr(t: torch.Tensor | None) -> int | None:
    return t.data_ptr() if t is not None else None


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


_SMS: dict[int, int] = {}
_SCRATCH: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
# Every workspace and counter tensor ever handed out: a CUDA graph captured
# on one keeps its address after a larger plan has replaced it in _SCRATCH.
_HANDED_OUT: list[torch.Tensor] = []


def _scratch(dev: torch.device, plan: QmatmulPlan) -> tuple[int, int]:
    """Pointers to the device's split-K workspace and tile counters, grown
    to the plan's need (counters start at 0, and the kernels leave them
    0). One per device, for launches on one stream at a time. A buffer is
    never freed (``_HANDED_OUT``), and growing one while a stream is
    captured raises: the capture would take it from the graph's pool."""
    if plan.splits == 1:
        return 0, 0
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    ws, cnt = _SCRATCH.get(idx, (None, None))
    grow_ws = ws is None or ws.numel() * 4 < plan.scratch_bytes
    grow_cnt = cnt is None or cnt.numel() < plan.tiles
    if (grow_ws or grow_cnt) and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"split-K workspace of {plan.scratch_bytes} bytes and "
            f"{plan.tiles} tile counters not reserved before the capture: "
            "run the step once before capturing it")
    if grow_ws:
        ws = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                         device=dev)
        _HANDED_OUT.append(ws)
    if grow_cnt:
        cnt = torch.zeros(plan.tiles, dtype=torch.int32, device=dev)
        _HANDED_OUT.append(cnt)
    _SCRATCH[idx] = (ws, cnt)
    return ws.data_ptr(), cnt.data_ptr()


def _sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def qmatmul(x: torch.Tensor, lin: QuantLinear,
            precision: str | None = None, *, path: str | None = None,
            splits: int | None = None,
            tile_rows: int | None = None) -> torch.Tensor:
    """x [B, K] float32 @ quantized W [K, N] -> [B, N] float32, or bfloat16
    in "default" precision (bias NOT applied). ``path``, ``splits`` and
    ``tile_rows`` override ``qmatmul_plan``'s choice (for measurements);
    the plan is always made for the call's own shapes and alignment."""
    odt = out_dtype(precision)
    if x.device.type == "cpu":
        return qmatmul_plain(x, lin, precision)
    if x.device.type != "cuda":
        raise RuntimeError(f"qmatmul: no kernel for device {x.device}")
    x = x.contiguous()
    panel_bf16 = _check(x, lin)
    b = x.shape[0]
    y = torch.empty((b, lin.n), dtype=odt, device=x.device)
    if b == 0:
        return y
    plan = qmatmul_plan(b, lin.k, lin.n, lin.group, lin.fmt, _sms(x.device),
                        _aligned(x, lin), path, splits, tile_rows)
    _qgemm(x, lin, y, plan, panel_bf16, "qmatmul")
    _count("qmatmul_q4" if lin.fmt == "q4" else "qmatmul_q8", plan)
    return y


def _aligned(x: torch.Tensor, lin: QuantLinear | QuantExpertStack) -> bool:
    """Every input 16-byte aligned (outputs are fresh allocations, which
    the caching allocator aligns to 512 bytes)."""
    return all(t.data_ptr() % 16 == 0 for t in (
        x, lin.packed, lin.scales, lin.mins) if t is not None)


def _qgemm(x: torch.Tensor, lin: QuantLinear | QuantExpertStack,
           y: torch.Tensor, plan: QmatmulPlan, panel_bf16: int, what: str,
           act: int = -1, rows: torch.Tensor | None = None,
           eg: torch.Tensor | None = None, c_rows: int = 0,
           up: QuantExpertStack | None = None) -> None:
    """One launch of csrc/qgemm.cu into y [B, N] (B, N: y's shape) as
    ``plan`` says: kernels 1-2; the GLU with ``act`` (an index into
    GLU_ACTS); over a stack of E experts (x's S slots): kernel 4 with
    ``eg`` alone (the expert of each row), the grouped products with
    ``rows``, ``eg`` and ``c_rows`` (kernel 5; kernel 6 with ``act`` and
    the ``up`` stack)."""
    ws, counters = _scratch(x.device, plan)
    rc = _lib("qgemm").qgemm_launch(
        x.data_ptr(), lin.packed.data_ptr(), lin.scales.data_ptr(),
        _ptr(lin.mins), _ptr(up.packed if up else None),
        _ptr(up.scales if up else None), _ptr(up.mins if up else None),
        y.data_ptr(), ws, counters, _ptr(rows), _ptr(eg),
        y.shape[0], lin.k, y.shape[1], lin.group,
        0 if lin.fmt == "q4" else 1, panel_bf16,
        int(y.dtype == torch.bfloat16), int(plan.path == "tc"), plan.tile,
        plan.splits, int(plan.vec), act, c_rows, x.shape[0],
        lin.packed.shape[0] if eg is not None else 0, _stream(x))
    _raise_on(rc, what)


def qmatmul_glu(x: torch.Tensor, lin, act: str,
                precision: str | None = None, *, path: str | None = None,
                splits: int | None = None,
                tile_rows: int | None = None) -> torch.Tensor | None:
    """act(x @ W_gate) * (x @ W_up) for a FUSED gate/up QuantLinear (equal
    splits), float32 or, in "default" precision, bfloat16. Returns None where
    the JAX qmatmul_glu does (unknown act, a bias, no equal two-way split):
    the caller then takes the two-step path. ``path``, ``splits`` and
    ``tile_rows`` override ``qmatmul_plan(..., glu=True)`` as for
    ``qmatmul``."""
    if act not in GLU_ACTS or lin.bias is not None:
        return None
    halves = getattr(lin, "splits", None)
    if not halves or len(halves) != 2 or halves[0] != halves[1]:
        return None
    odt = out_dtype(precision)
    if x.device.type == "cpu":
        return qmatmul_glu_plain(x, lin, act, precision)
    if x.device.type != "cuda":
        raise RuntimeError(f"qmatmul_glu: no kernel for device {x.device}")
    x = x.contiguous()
    panel_bf16 = _check(x, lin)
    b, f = x.shape[0], halves[0]
    if 2 * f != lin.n:
        raise ValueError(f"qmatmul_glu: splits {halves} of {lin.n} columns")
    y = torch.empty((b, f), dtype=odt, device=x.device)
    if b == 0:
        return y
    plan = qmatmul_plan(b, lin.k, f, lin.group, lin.fmt, _sms(x.device),
                        _aligned(x, lin), path, splits, tile_rows, True)
    _qgemm(x, lin, y, plan, panel_bf16, "qmatmul_glu", GLU_ACTS.index(act))
    _count("qmatmul_glu", plan)
    return y


def _check_moe(x: torch.Tensor, idx: torch.Tensor | None, stacks) -> None:
    for st in stacks:
        if _check(x, st):  # instantiated for float32 panels only
            raise ValueError("the MoE kernels take float32 scale panels only "
                             "(the loader keeps expert stacks in float32)")
    if idx is None:
        return
    if idx.dtype != torch.int32 or idx.shape != (x.shape[0],) \
            or idx.device != x.device or not idx.is_contiguous():
        raise ValueError(f"idx must be contiguous int32 [{x.shape[0]}] on "
                         f"{x.device}, got {idx.dtype} {tuple(idx.shape)} on "
                         f"{idx.device}")


def _dispatch_plan(plan, idx: torch.Tensor, e_num: int, c_rows: int,
                   g_blocks: int):
    """The grouped products' dispatch plan (eg, rows, flat): ``plan`` as
    given (``moe_layer`` makes one per layer for all of its products, from
    the same routing) after a check of its shapes, or made here."""
    if plan is None:
        return moe_group_plan(idx, e_num, c_rows, g_blocks)
    shapes = ((g_blocks,), (g_blocks, c_rows), (idx.shape[0],))
    if any(tuple(t.shape) != sh or t.dtype != torch.int32
           or t.device != idx.device or not t.is_contiguous()
           for t, sh in zip(plan, shapes)):
        raise ValueError("plan is not a moe_group_plan of this routing: "
                         f"shapes {[tuple(t.shape) for t in plan]}, want "
                         f"{list(shapes)} int32 on {idx.device}")
    return plan


def moe_qmatmul(x_rows: torch.Tensor, stack: QuantExpertStack,
                idx_flat: torch.Tensor, precision: str | None = None, *,
                plan=None, splits: int | None = None) -> torch.Tensor:
    """Routed MoE product: x_rows [S, K] (one input row per expert slot)
    times the quantized weight of expert idx_flat[s] -> [S, N] float32 (or
    bfloat16 in "default" precision). Only the routed experts' packed bytes
    are read, straight from the stack. Decode-sized S runs the slot-major
    kernel (``moe_slot_plan``; ``splits`` overrides its split of K, for
    measurements); larger S sorts the slots by expert (``moe_group_plan``,
    or the ``plan`` a caller made from the same routing) and runs C-row
    single-expert blocks, so each routed expert's weights stream about once
    instead of once per slot. Unlike the JAX entry it never returns None:
    ragged N is computed."""
    odt = out_dtype(precision)
    if x_rows.device.type == "cpu":
        return moe_qmatmul_plain(x_rows, stack, idx_flat, precision)
    if x_rows.device.type != "cuda":
        raise RuntimeError(f"moe_qmatmul: no kernel for device "
                           f"{x_rows.device}")
    x = x_rows.float().contiguous()
    idx = idx_flat.to(torch.int32).contiguous()
    _check_moe(x, idx, (stack,))
    s_slots, n = x.shape[0], stack.n
    e_num = stack.packed.shape[0]
    c_rows, g_blocks, grouped = moe_dims(s_slots, e_num)
    if not grouped:
        y = torch.empty((s_slots, n), dtype=odt, device=x.device)
        if s_slots == 0:
            return y
        splan = moe_slot_plan(s_slots, e_num, stack.k, n, stack.group,
                              stack.fmt, _sms(x.device), _aligned(x, stack),
                              splits)
        _qgemm(x, stack, y, splan, 0, "moe_slot", eg=idx)
        _count("moe_slot", splan)
        return y
    eg, rows, flat = _dispatch_plan(plan, idx, e_num, c_rows, g_blocks)
    return _moe_grouped(x, stack, eg, rows, odt)[flat]


def moe_grouped_blocked(x_rows: torch.Tensor, stack: QuantExpertStack,
                        eg: torch.Tensor, rows: torch.Tensor,
                        precision: str | None = None, *,
                        up: QuantExpertStack | None = None,
                        act: str | None = None, path: str | None = None,
                        splits: int | None = None,
                        tile_rows: int | None = None) -> torch.Tensor:
    """Kernel 5 alone on a dispatch plan given as its arrays, for
    measurements and tests (``moe_qmatmul`` is the entry that plans and
    reads back); with the ``up`` stack and ``act``, kernel 6 (the entry
    ``moe_qmatmul_glu``). ``moe_group_plan``'s eg [G] and rows [G, C] for S
    = x_rows.shape[0] slots over the stack's E experts, where ``moe_dims``
    says grouped. Returns the [G*C, N] blocked output, row g*C + c =
    x_rows[rows[g, c]] @ W[eg[g]] (kernel 6: act(x @ W[eg[g]]) * (x @
    Wup[eg[g]])) for rows[g, c] < S; padding rows are left unwritten, and an
    expert id outside [0, E) gives NaN rows. ``path``, ``splits`` and
    ``tile_rows`` override ``moe_grouped_plan``. CUDA tensors only: the
    plain versions are ``moe_qmatmul_plain`` and ``moe_qmatmul_glu_plain``."""
    if x_rows.device.type != "cuda":
        raise RuntimeError(f"moe_grouped_blocked: no kernel for device "
                           f"{x_rows.device}")
    if (up is None) != (act is None) or (act is not None
                                         and act not in GLU_ACTS):
        raise ValueError(f"moe_grouped_blocked: up and act go together "
                         f"(act {act!r} of {GLU_ACTS})")
    x = x_rows.float().contiguous()
    _check_moe(x, None, (stack,) if up is None else (stack, up))
    if up is not None and not _same_layout(stack, up):
        raise ValueError("moe_grouped_blocked: the gate and up stacks differ "
                         "in layout")
    c_rows, g_blocks, grouped = moe_dims(x.shape[0], stack.packed.shape[0])
    if not grouped or tuple(eg.shape) != (g_blocks,) \
            or tuple(rows.shape) != (g_blocks, c_rows):
        raise ValueError(f"moe_grouped_blocked: eg {tuple(eg.shape)} and rows "
                         f"{tuple(rows.shape)} are not a grouped plan of "
                         f"S={x.shape[0]}")
    for t in (eg, rows):
        if t.dtype != torch.int32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError("eg and rows must be contiguous int32 on "
                             f"{x.device}")
    return _moe_grouped(x, stack, eg, rows, out_dtype(precision), path,
                        splits, tile_rows, up, act)


def _moe_grouped(x: torch.Tensor, stack: QuantExpertStack, eg: torch.Tensor,
                 rows: torch.Tensor, odt: torch.dtype, path: str | None = None,
                 splits: int | None = None, tile_rows: int | None = None,
                 up: QuantExpertStack | None = None,
                 act: str | None = None) -> torch.Tensor:
    """One launch of kernel 5, or with ``up`` and ``act`` of kernel 6, on
    checked tensors (x float32 [S, K] on the card, eg [G] and rows [G, C]
    int32): the [G*C, N] blocked output."""
    s_slots, n, e_num = x.shape[0], stack.n, stack.packed.shape[0]
    g_blocks, c_rows = rows.shape
    name = "moe_grouped" if up is None else "moe_glu_grouped"
    out = _grouped_out(g_blocks, c_rows, n, odt, x.device)
    aligned = _aligned(x, stack) and (up is None or _aligned(x, up))
    plan = moe_grouped_plan(s_slots, e_num, stack.k, n, stack.group,
                            stack.fmt, _sms(x.device), aligned, path, splits,
                            tile_rows, up is not None)
    if plan.path == "tc":
        _qgemm(x, stack, out, plan, 0, name,
               GLU_ACTS.index(act) if up is not None else -1, rows, eg,
               c_rows, up)
    else:
        lib = _lib("moe_qmatmul")
        common = (s_slots, e_num, stack.k, n, c_rows, g_blocks, stack.group,
                  0 if stack.fmt == "q4" else 1)
        if up is None:
            rc = lib.moe_grouped_launch(
                x.data_ptr(), rows.data_ptr(), eg.data_ptr(),
                stack.packed.data_ptr(), stack.scales.data_ptr(),
                _ptr(stack.mins), out.data_ptr(), *common,
                int(odt == torch.bfloat16), _vec_ok(stack, n, out),
                _stream(x))
        else:
            rc = lib.moe_glu_grouped_launch(
                x.data_ptr(), rows.data_ptr(), eg.data_ptr(),
                stack.packed.data_ptr(), stack.scales.data_ptr(),
                _ptr(stack.mins), up.packed.data_ptr(), up.scales.data_ptr(),
                _ptr(up.mins), out.data_ptr(), *common, GLU_ACTS.index(act),
                int(odt == torch.bfloat16),
                min(_vec_ok(stack, n, out), _vec_ok(up, n, out)), _stream(x))
        _raise_on(rc, name)
    _count(name, plan)
    return out


def _grouped_out(g_blocks: int, c_rows: int, n: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The grouped kernels' [G*C, N] blocked output (padding rows are left
    unwritten and never read back)."""
    if g_blocks * c_rows // 8 > 65535:
        raise ValueError(f"grouped MoE: {g_blocks} x {c_rows} rows exceed the "
                         "grid")
    return torch.empty((g_blocks * c_rows, n), dtype=dtype, device=device)


def _same_layout(g_st: QuantExpertStack, u_st: QuantExpertStack) -> bool:
    """Gate and up stacks of one layout: format, group, shapes, experts and
    min panels alike."""
    return (g_st.fmt == u_st.fmt and g_st.group == u_st.group
            and g_st.k == u_st.k and g_st.n == u_st.n
            and g_st.packed.shape[0] == u_st.packed.shape[0]
            and (g_st.mins is None) == (u_st.mins is None))


def moe_qmatmul_glu(x_rows: torch.Tensor, gate_stack: QuantExpertStack,
                    up_stack: QuantExpertStack, idx_flat: torch.Tensor,
                    act: str, precision: str | None = None, *, plan=None
                    ) -> torch.Tensor | None:
    """act(x @ Wg[e]) * (x @ Wu[e]) for routed expert slots in one grouped
    kernel, reading both stacks in one pass -> [S, F] float32 (bfloat16 in
    "default" precision); ``plan``: as for ``moe_qmatmul``. Returns None
    where the JAX entry does: an unknown act, stacks that do not match, or
    an S below the grouped rule (decode keeps the two slot-major calls);
    the caller then takes the two-call path."""
    g_st, u_st = gate_stack, up_stack
    s_slots, k = x_rows.shape
    if act not in GLU_ACTS or g_st.k != k or not _same_layout(g_st, u_st):
        return None
    e_num, f = g_st.packed.shape[0], g_st.n
    c_rows, g_blocks, grouped = moe_dims(s_slots, e_num)
    if not grouped:
        return None
    odt = out_dtype(precision)
    if x_rows.device.type == "cpu":
        return moe_qmatmul_glu_plain(x_rows, g_st, u_st, idx_flat, act,
                                     precision)
    if x_rows.device.type != "cuda":
        raise RuntimeError(f"moe_qmatmul_glu: no kernel for device "
                           f"{x_rows.device}")
    x = x_rows.float().contiguous()
    idx = idx_flat.to(torch.int32).contiguous()
    _check_moe(x, idx, (g_st, u_st))
    eg, rows, flat = _dispatch_plan(plan, idx, e_num, c_rows, g_blocks)
    return _moe_grouped(x, g_st, eg, rows, odt, up=u_st, act=act)[flat]
