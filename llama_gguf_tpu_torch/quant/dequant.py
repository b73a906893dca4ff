"""Numpy-vectorized block dequantization for the GGML formats the port loads.

A trimmed copy of llama_gguf_tpu/quant/dequant.py (the port never imports the
JAX package): F32, F16, BF16, Q8_0, Q5_1, Q4_K and Q6_K, bit-exact with
llama.cpp's dequantize_row_*. Any other type raises NotImplementedError; the
remaining formats are ROADMAP queue 1 work.

All functions take raw block bytes as uint8 [..., n_blocks * type_size] and
return float32 [..., n_blocks * block_size].
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np

from ..gguf.constants import GGMLType, QK_K

F32 = np.float32


def _f16(raw: np.ndarray) -> np.ndarray:
    """View little-endian f16 pairs of bytes as float32."""
    return np.ascontiguousarray(raw).view("<f2").astype(F32)


def _blocks(raw: np.ndarray, type_size: int) -> np.ndarray:
    raw = np.ascontiguousarray(raw).reshape(-1)
    if raw.size % type_size != 0:
        raise ValueError(f"raw size {raw.size} not divisible by block {type_size}")
    return raw.reshape(-1, type_size)


def dequantize_q5_1(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 24)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qh = np.ascontiguousarray(b[:, 4:8]).view("<u4")
    qs = b[:, 8:24]
    i = np.arange(16, dtype=np.uint32)
    lo = (qs & 0x0F).astype(np.uint32) | (((qh >> i) & 1) << 4)
    hi = (qs >> 4).astype(np.uint32) | (((qh >> (i + 16)) & 1) << 4)
    return (np.concatenate([lo, hi], axis=1).astype(F32) * d + m).reshape(-1)


def dequantize_q8_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 34)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].view(np.int8)
    return (qs.astype(F32) * d).reshape(-1)


def _k4_scale_min(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """llama.cpp get_scale_min_k4: 12 bytes -> 8 scales + 8 mins (uint, 6-bit).
    scales: uint8 [nb, 12] -> (sc [nb, 8], mn [nb, 8]) float32."""
    nb = scales.shape[0]
    sc = np.empty((nb, 8), dtype=np.uint8)
    mn = np.empty((nb, 8), dtype=np.uint8)
    j = np.arange(4)
    sc[:, 0:4] = scales[:, j] & 63
    mn[:, 0:4] = scales[:, j + 4] & 63
    sc[:, 4:8] = (scales[:, j + 8] & 0x0F) | ((scales[:, j] >> 6) << 4)
    mn[:, 4:8] = (scales[:, j + 8] >> 4) | ((scales[:, j + 4] >> 6) << 4)
    return sc.astype(F32), mn.astype(F32)


@lru_cache(maxsize=None)
def _q4k_index():
    e = np.arange(QK_K)
    grp = e // 32
    byte_idx = (e // 64) * 32 + e % 32
    nib = ((e % 64) // 32 * 4).astype(np.uint8)
    return byte_idx, nib, grp


def dequantize_q4_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 144)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _k4_scale_min(b[:, 4:16])
    qs = b[:, 16:144]
    byte_idx, nib, grp = _q4k_index()
    q = ((qs[:, byte_idx] >> nib) & 0x0F).astype(F32)
    return ((d * sc[:, grp]) * q - dmin * mn[:, grp]).reshape(-1)


@lru_cache(maxsize=None)
def _q6k_index():
    e = np.arange(QK_K)
    n, rem = e // 128, e % 128
    quarter, l = rem // 32, rem % 32
    ql_idx = n * 64 + l + np.where((quarter % 2) == 1, 32, 0)
    ql_shift = np.where(quarter >= 2, 4, 0).astype(np.uint8)
    qh_idx = n * 32 + l
    qh_shift = (2 * quarter).astype(np.uint8)
    sc_idx = n * 8 + l // 16 + 2 * quarter
    return ql_idx, ql_shift, qh_idx, qh_shift, sc_idx


def dequantize_q6_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 210)
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    scales = b[:, 192:208].view(np.int8)
    d = _f16(b[:, 208:210])
    ql_idx, ql_shift, qh_idx, qh_shift, sc_idx = _q6k_index()
    lo = (ql[:, ql_idx] >> ql_shift) & 0x0F
    hi = (qh[:, qh_idx] >> qh_shift) & 0x03
    q = (lo.astype(np.int32) | (hi.astype(np.int32) << 4)) - 32
    return (d * scales[:, sc_idx].astype(F32) * q.astype(F32)).reshape(-1)


def dequantize_f32(raw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(raw).view("<f4").reshape(-1)


def dequantize_f16(raw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(raw).view("<f2").astype(F32).reshape(-1)


def dequantize_bf16(raw: np.ndarray) -> np.ndarray:
    u16 = np.ascontiguousarray(raw).view("<u2").astype(np.uint32) << 16
    return u16.view(F32).reshape(-1)


_DEQUANT: dict[GGMLType, Callable[[np.ndarray], np.ndarray]] = {
    GGMLType.F32: dequantize_f32,
    GGMLType.F16: dequantize_f16,
    GGMLType.BF16: dequantize_bf16,
    GGMLType.Q5_1: dequantize_q5_1,
    GGMLType.Q8_0: dequantize_q8_0,
    GGMLType.Q4_K: dequantize_q4_k,
    GGMLType.Q6_K: dequantize_q6_k,
}


def dequantize(raw: np.ndarray | memoryview | bytes, ggml_type: GGMLType | int,
               shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Dequantize raw block bytes to float32, optionally reshaped to the
    row-major numpy ``shape``."""
    t = GGMLType(ggml_type)
    if t not in _DEQUANT:
        raise NotImplementedError(
            f"dequantize: {t.name} is not ported yet (ROADMAP queue 1)")
    arr = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    out = _DEQUANT[t](arr)
    if shape is not None:
        out = out.reshape(shape)
    return out
