"""Numpy-vectorized block dequantization for every GGML format.

A copy of llama_gguf_tpu/quant/dequant.py (the port never imports the JAX
package), bit-exact with llama.cpp's dequantize_row_*: the plain dtypes,
Q4_0..Q8_1, the K-quants Q2_K..Q8_K, IQ4_NL/IQ4_XS, and the lattice-grid
formats IQ2_XXS/XS/S and IQ3_XXS/S (quant/iq_quants.py). IQ1_S/IQ1_M decode
to zeros, as in the JAX package. Bulk data (from 64 KiB) of the nine
formats of native.NATIVE_FORMATS goes through the native library, as in the
JAX package: the same values, bit for bit.

All functions take raw block bytes as uint8 [..., n_blocks * type_size] and
return float32 [..., n_blocks * block_size].
"""

from __future__ import annotations

import logging
from functools import lru_cache
from typing import Callable

import numpy as np

from .. import native
from ..gguf.constants import GGMLType, QK_K
from . import iq_quants as IQ

log = logging.getLogger(__name__)

F32 = np.float32
BULK_BYTES = 1 << 16  # from here the native library dequantizes

_IQ1_WARNED = False


def _f16(raw: np.ndarray) -> np.ndarray:
    """View little-endian f16 pairs of bytes as float32."""
    return np.ascontiguousarray(raw).view("<f2").astype(F32)


def _blocks(raw: np.ndarray, type_size: int) -> np.ndarray:
    raw = np.ascontiguousarray(raw).reshape(-1)
    if raw.size % type_size != 0:
        raise ValueError(f"raw size {raw.size} not divisible by block {type_size}")
    return raw.reshape(-1, type_size)


def dequantize_q4_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2])  # [nb, 1]
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    return (np.concatenate([lo, hi], axis=1).astype(F32) * d).reshape(-1)


def dequantize_q4_1(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 20)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:20]
    lo = (qs & 0x0F).astype(F32)
    hi = (qs >> 4).astype(F32)
    return (np.concatenate([lo, hi], axis=1) * d + m).reshape(-1)


def dequantize_q5_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 22)
    d = _f16(b[:, 0:2])
    qh = np.ascontiguousarray(b[:, 2:6]).view("<u4")  # [nb, 1]
    qs = b[:, 6:22]
    i = np.arange(16, dtype=np.uint32)
    lo = ((qs & 0x0F).astype(np.int32) | (((qh >> i) & 1) << 4).astype(np.int32)) - 16
    hi = ((qs >> 4).astype(np.int32) | (((qh >> (i + 16)) & 1) << 4).astype(np.int32)) - 16
    return (np.concatenate([lo, hi], axis=1).astype(F32) * d).reshape(-1)


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


def dequantize_q8_1(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 36)
    d = _f16(b[:, 0:2])
    qs = b[:, 4:36].view(np.int8)
    return (qs.astype(F32) * d).reshape(-1)


# ---------------------------------------------------------------------------
# K-quant 256-element super-blocks
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _q2k_index():
    e = np.arange(QK_K)
    h, j, l = e // 128, (e % 128) // 32, e % 32
    return h * 32 + l, (2 * j).astype(np.uint8), h * 8 + 2 * j + l // 16


def dequantize_q2_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 84)
    scales = b[:, 0:16]
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    byte_idx, shift, sc_idx = _q2k_index()
    q = ((qs[:, byte_idx] >> shift) & 3).astype(F32)
    sc = scales[:, sc_idx]
    dl = d * (sc & 0x0F).astype(F32)
    ml = dmin * (sc >> 4).astype(F32)
    return (dl * q - ml).reshape(-1)


def _q3k_scales(sb: np.ndarray) -> np.ndarray:
    """Decode Q3_K's 12 packed bytes into 16 signed 6-bit scales (llama.cpp
    kmask scheme). sb: uint8 [nb, 12] -> int32 [nb, 16]."""
    nb = sb.shape[0]
    out = np.empty((nb, 16), dtype=np.int32)
    k = np.arange(4)
    out[:, 0:4] = (sb[:, k] & 0x0F) | ((sb[:, 8 + k] & 0x03) << 4)
    out[:, 4:8] = (sb[:, 4 + k] & 0x0F) | (((sb[:, 8 + k] >> 2) & 0x03) << 4)
    out[:, 8:12] = (sb[:, k] >> 4) | (((sb[:, 8 + k] >> 4) & 0x03) << 4)
    out[:, 12:16] = (sb[:, 4 + k] >> 4) | (((sb[:, 8 + k] >> 6) & 0x03) << 4)
    return out - 32


@lru_cache(maxsize=None)
def _q3k_index():
    e = np.arange(QK_K)
    h, j, l = e // 128, (e % 128) // 32, e % 32
    return h * 32 + l, (2 * j).astype(np.uint8), (e % 32), (e // 32).astype(np.uint8), e // 16


def dequantize_q3_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 110)
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    scales16 = _q3k_scales(b[:, 96:108])
    d = _f16(b[:, 108:110])
    byte_idx, shift, hm_idx, hm_bit, grp = _q3k_index()
    lo2 = ((qs[:, byte_idx] >> shift) & 3).astype(np.int32)
    hbit = ((hmask[:, hm_idx] >> hm_bit) & 1).astype(np.int32)
    q = lo2 - 4 * (1 - hbit)
    return (d * scales16[:, grp].astype(F32) * q.astype(F32)).reshape(-1)


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


def dequantize_q5_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 176)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _k4_scale_min(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:176]
    byte_idx, nib, grp = _q4k_index()
    e = np.arange(QK_K)
    hbit = (qh[:, e % 32] >> (e // 32).astype(np.uint8)) & 1
    q = ((qs[:, byte_idx] >> nib) & 0x0F).astype(F32) + 16.0 * hbit.astype(F32)
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


def dequantize_q8_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 292)
    d = np.ascontiguousarray(b[:, 0:4]).view("<f4")
    qs = b[:, 4:260].view(np.int8)
    return (qs.astype(F32) * d).reshape(-1)


# ---------------------------------------------------------------------------
# IQ4 (non-linear 4-bit) formats
# ---------------------------------------------------------------------------

KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=F32,
)


def dequantize_iq4_nl(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:18]
    lo = KVALUES_IQ4NL[qs & 0x0F]
    hi = KVALUES_IQ4NL[qs >> 4]
    return (np.concatenate([lo, hi], axis=1) * d).reshape(-1)


def dequantize_iq4_xs(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 136)
    d = _f16(b[:, 0:2])
    scales_h = np.ascontiguousarray(b[:, 2:4]).view("<u2").astype(np.uint32)  # [nb,1]
    scales_l = b[:, 4:8]
    qs = b[:, 8:136]
    g = np.arange(8)
    ls = ((scales_l[:, g // 2] >> (4 * (g % 2)).astype(np.uint8)) & 0x0F).astype(np.int32) | (
        ((scales_h >> (2 * g)) & 3) << 4
    ).astype(np.int32)
    dl = d * (ls - 32).astype(F32)  # [nb, 8]
    e = np.arange(QK_K)
    grp = e // 32
    byte_idx = 16 * grp + e % 16
    nib = ((e % 32) // 16 * 4).astype(np.uint8)
    q = KVALUES_IQ4NL[(qs[:, byte_idx] >> nib) & 0x0F]
    return (dl[:, grp] * q).reshape(-1)


# ---------------------------------------------------------------------------
# Plain dtypes
# ---------------------------------------------------------------------------


def dequantize_f32(raw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(raw).view("<f4").reshape(-1)


def dequantize_f16(raw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(raw).view("<f2").astype(F32).reshape(-1)


def dequantize_bf16(raw: np.ndarray) -> np.ndarray:
    u16 = np.ascontiguousarray(raw).view("<u2").astype(np.uint32) << 16
    return u16.view(F32).reshape(-1)


def dequantize_f64(raw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(raw).view("<f8").astype(F32).reshape(-1)


_DEQUANT: dict[GGMLType, Callable[[np.ndarray], np.ndarray]] = {
    GGMLType.F32: dequantize_f32,
    GGMLType.F16: dequantize_f16,
    GGMLType.BF16: dequantize_bf16,
    GGMLType.F64: dequantize_f64,
    GGMLType.I8: lambda r: r.view(np.int8).astype(F32).reshape(-1),
    GGMLType.I16: lambda r: np.ascontiguousarray(r).view("<i2").astype(F32).reshape(-1),
    GGMLType.I32: lambda r: np.ascontiguousarray(r).view("<i4").astype(F32).reshape(-1),
    GGMLType.I64: lambda r: np.ascontiguousarray(r).view("<i8").astype(F32).reshape(-1),
    GGMLType.Q4_0: dequantize_q4_0,
    GGMLType.Q4_1: dequantize_q4_1,
    GGMLType.Q5_0: dequantize_q5_0,
    GGMLType.Q5_1: dequantize_q5_1,
    GGMLType.Q8_0: dequantize_q8_0,
    GGMLType.Q8_1: dequantize_q8_1,
    GGMLType.Q2_K: dequantize_q2_k,
    GGMLType.Q3_K: dequantize_q3_k,
    GGMLType.Q4_K: dequantize_q4_k,
    GGMLType.Q5_K: dequantize_q5_k,
    GGMLType.Q6_K: dequantize_q6_k,
    GGMLType.Q8_K: dequantize_q8_k,
    GGMLType.IQ4_NL: dequantize_iq4_nl,
    GGMLType.IQ4_XS: dequantize_iq4_xs,
    # grid formats (lattice codebooks, quant/iq_quants.py); IQ1 decodes to
    # zeros, as in the JAX package (its grid is not vendored)
    GGMLType.IQ2_XXS: IQ.dequantize_iq2_xxs,
    GGMLType.IQ2_XS: IQ.dequantize_iq2_xs,
    GGMLType.IQ2_S: IQ.dequantize_iq2_s,
    GGMLType.IQ3_XXS: IQ.dequantize_iq3_xxs,
    GGMLType.IQ3_S: IQ.dequantize_iq3_s,
    GGMLType.IQ1_S: lambda r: IQ.dequantize_iq1_zeros(r, 50),
    GGMLType.IQ1_M: lambda r: IQ.dequantize_iq1_zeros(r, 56),
}


def dequantize(raw: np.ndarray | memoryview | bytes, ggml_type: GGMLType | int,
               shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Dequantize raw block bytes to float32, optionally reshaped to the
    row-major numpy ``shape``."""
    t = GGMLType(ggml_type)
    if t not in _DEQUANT:
        raise NotImplementedError(f"dequantize: {t.name} not supported")
    if t in (GGMLType.IQ1_S, GGMLType.IQ1_M):
        global _IQ1_WARNED
        if not _IQ1_WARNED:
            _IQ1_WARNED = True
            log.warning(
                "%s tensors decode to ZEROS: the iq1s lattice grid is not "
                "vendored; generation from this file will be garbage. "
                "Re-quantize the source model to IQ2/IQ3/Q2_K.", t.name)
    arr = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    out = None
    if arr.nbytes >= BULK_BYTES and t.name in native.NATIVE_FORMATS:
        out = native.dequantize_native(arr, t.name)
        native.record("dequant", t.name, out is not None)
    if out is None:
        out = _DEQUANT[t](arr)
    if shape is not None:
        out = out.reshape(shape)
    return out
