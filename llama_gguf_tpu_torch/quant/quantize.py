"""Numpy-vectorized block quantization (f32 -> GGML quant blocks).

A copy of llama_gguf_tpu/quant/quantize.py (the port never imports the JAX
package): the same 17 types, byte-identical to its output. Legacy formats
(Q4_0/Q4_1/Q5_0/Q5_1/Q8_0/Q8_1) follow llama.cpp's reference quantizers
(signed-max scaling). K-quants use a direct two-level scale fit (per-group
float scale, then block-level 4/6/8-bit re-quantization of the group scales)
rather than llama.cpp's iterative RMSE search: the blocks are layout-exact
and decode with the same dequantizers. The grid formats (IQ1-IQ3) have no
quantizer in either package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..gguf.constants import GGMLType, QK_K
from .dequant import KVALUES_IQ4NL

F32 = np.float32


def _to_f16_bytes(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype("<f2")).view(np.uint8)


def _groups(x: np.ndarray, block: int) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=F32).reshape(-1)
    if x.size % block != 0:
        raise ValueError(f"size {x.size} not divisible by block {block}")
    return x.reshape(-1, block)


def _inv(d: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(d != 0.0, 1.0 / d, 0.0)
    return out


# ---------------------------------------------------------------------------
# Legacy formats
# ---------------------------------------------------------------------------


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, 32)
    nb = xb.shape[0]
    # llama.cpp: signed max (value of largest magnitude), d = max / -8
    idx = np.argmax(np.abs(xb), axis=1)
    smax = xb[np.arange(nb), idx]
    d = smax / -8.0
    q = np.clip(xb * _inv(d)[:, None] + 8.5, 0.0, 15.0).astype(np.uint8)
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d).reshape(nb, 2)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, 32)
    nb = xb.shape[0]
    mn = np.minimum(xb.min(axis=1), 0.0)
    mx = np.maximum(xb.max(axis=1), 0.0)
    d = (mx - mn) / 15.0
    q = np.clip((xb - mn[:, None]) * _inv(d)[:, None] + 0.5, 0.0, 15.0).astype(np.uint8)
    out = np.empty((nb, 20), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d).reshape(nb, 2)
    out[:, 2:4] = _to_f16_bytes(mn).reshape(nb, 2)
    out[:, 4:20] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, 32)
    nb = xb.shape[0]
    idx = np.argmax(np.abs(xb), axis=1)
    smax = xb[np.arange(nb), idx]
    d = smax / -16.0
    q = np.clip(xb * _inv(d)[:, None] + 16.5, 0.0, 31.0).astype(np.uint8)
    qh = np.zeros((nb, 1), dtype=np.uint32)
    i = np.arange(16, dtype=np.uint32)
    qh |= (((q[:, :16] >> 4) & 1).astype(np.uint32) << i).sum(axis=1, dtype=np.uint64).astype(np.uint32)[:, None]
    qh |= (((q[:, 16:] >> 4) & 1).astype(np.uint32) << (i + 16)).sum(axis=1, dtype=np.uint64).astype(np.uint32)[:, None]
    out = np.empty((nb, 22), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d).reshape(nb, 2)
    out[:, 2:6] = qh.view(np.uint8).reshape(nb, 4)
    out[:, 6:22] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out.reshape(-1)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, 32)
    nb = xb.shape[0]
    mn = np.minimum(xb.min(axis=1), 0.0)
    mx = np.maximum(xb.max(axis=1), 0.0)
    d = (mx - mn) / 31.0
    q = np.clip((xb - mn[:, None]) * _inv(d)[:, None] + 0.5, 0.0, 31.0).astype(np.uint8)
    qh = np.zeros((nb, 1), dtype=np.uint32)
    i = np.arange(16, dtype=np.uint32)
    qh |= (((q[:, :16] >> 4) & 1).astype(np.uint32) << i).sum(axis=1, dtype=np.uint64).astype(np.uint32)[:, None]
    qh |= (((q[:, 16:] >> 4) & 1).astype(np.uint32) << (i + 16)).sum(axis=1, dtype=np.uint64).astype(np.uint32)[:, None]
    out = np.empty((nb, 24), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d).reshape(nb, 2)
    out[:, 2:4] = _to_f16_bytes(mn).reshape(nb, 2)
    out[:, 4:8] = qh.view(np.uint8).reshape(nb, 4)
    out[:, 8:24] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out.reshape(-1)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, 32)
    nb = xb.shape[0]
    amax = np.abs(xb).max(axis=1)
    d = amax / 127.0
    q = np.clip(np.round(xb * _inv(d)[:, None]), -127, 127).astype(np.int8)
    out = np.empty((nb, 34), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d).reshape(nb, 2)
    out[:, 2:34] = q.view(np.uint8)
    return out.reshape(-1)


def quantize_q8_1(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, 32)
    nb = xb.shape[0]
    amax = np.abs(xb).max(axis=1)
    d = amax / 127.0
    q = np.clip(np.round(xb * _inv(d)[:, None]), -127, 127).astype(np.int8)
    s = d * q.astype(F32).sum(axis=1)
    out = np.empty((nb, 36), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d).reshape(nb, 2)
    out[:, 2:4] = _to_f16_bytes(s).reshape(nb, 2)
    out[:, 4:36] = q.view(np.uint8)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# K-quants
# ---------------------------------------------------------------------------


def _fit_affine_groups(xg: np.ndarray, qmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-group affine fit: x ~= scale*q - min, q in [0, qmax], min >= 0."""
    mn = np.minimum(xg.min(axis=-1), 0.0)
    mx = np.maximum(xg.max(axis=-1), 0.0)
    scale = (mx - mn) / qmax
    return scale, -mn


def _pack_k4_scales(sc6: np.ndarray, mn6: np.ndarray) -> np.ndarray:
    """Inverse of get_scale_min_k4: 8 scales + 8 mins (6-bit) -> 12 bytes.
    sc6/mn6: uint8 [nb, 8] -> uint8 [nb, 12]."""
    nb = sc6.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    out[:, 0:4] = (sc6[:, 0:4] & 63) | ((sc6[:, 4:8] >> 4) << 6)
    out[:, 4:8] = (mn6[:, 0:4] & 63) | ((mn6[:, 4:8] >> 4) << 6)
    out[:, 8:12] = (sc6[:, 4:8] & 0x0F) | ((mn6[:, 4:8] & 0x0F) << 4)
    return out


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, QK_K)
    nb = xb.shape[0]
    xg = xb.reshape(nb, 8, 32)
    scale, minv = _fit_affine_groups(xg, 15)  # [nb, 8]
    d = scale.max(axis=1) / 63.0
    dmin = minv.max(axis=1) / 63.0
    sc6 = np.clip(np.round(scale * _inv(d)[:, None]), 0, 63).astype(np.uint8)
    mn6 = np.clip(np.round(minv * _inv(dmin)[:, None]), 0, 63).astype(np.uint8)
    eff_scale = d[:, None] * sc6.astype(F32)
    eff_min = dmin[:, None] * mn6.astype(F32)
    q = np.clip(
        np.round((xg + eff_min[:, :, None]) * _inv(eff_scale)[:, :, None]), 0, 15
    ).astype(np.uint8)  # [nb, 8, 32]
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d).reshape(nb, 2)
    out[:, 2:4] = _to_f16_bytes(dmin).reshape(nb, 2)
    out[:, 4:16] = _pack_k4_scales(sc6, mn6)
    # layout: 4 chunks of 64; low nibbles = group 2c, high nibbles = group 2c+1
    qs = q.reshape(nb, 4, 2, 32)
    out[:, 16:144] = (qs[:, :, 0, :] | (qs[:, :, 1, :] << 4)).reshape(nb, 128)
    return out.reshape(-1)


def quantize_q5_k(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, QK_K)
    nb = xb.shape[0]
    xg = xb.reshape(nb, 8, 32)
    scale, minv = _fit_affine_groups(xg, 31)
    d = scale.max(axis=1) / 63.0
    dmin = minv.max(axis=1) / 63.0
    sc6 = np.clip(np.round(scale * _inv(d)[:, None]), 0, 63).astype(np.uint8)
    mn6 = np.clip(np.round(minv * _inv(dmin)[:, None]), 0, 63).astype(np.uint8)
    eff_scale = d[:, None] * sc6.astype(F32)
    eff_min = dmin[:, None] * mn6.astype(F32)
    q = np.clip(
        np.round((xg + eff_min[:, :, None]) * _inv(eff_scale)[:, :, None]), 0, 31
    ).astype(np.uint8)  # [nb, 8, 32]
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d).reshape(nb, 2)
    out[:, 2:4] = _to_f16_bytes(dmin).reshape(nb, 2)
    out[:, 4:16] = _pack_k4_scales(sc6, mn6)
    # qh bit for element e lives at byte e%32, bit e//32 (group index)
    hi = (q >> 4) & 1  # [nb, 8, 32]
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for g in range(8):
        qh |= (hi[:, g, :] << g).astype(np.uint8)
    out[:, 16:48] = qh
    qs = (q & 0x0F).reshape(nb, 4, 2, 32)
    out[:, 48:176] = (qs[:, :, 0, :] | (qs[:, :, 1, :] << 4)).reshape(nb, 128)
    return out.reshape(-1)


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, QK_K)
    nb = xb.shape[0]
    xg = xb.reshape(nb, 16, 16)
    # per-16 signed scale: q in [-32, 31]
    idx = np.argmax(np.abs(xg), axis=-1)
    smax = np.take_along_axis(xg, idx[:, :, None], axis=-1)[:, :, 0]
    s = smax / -32.0  # [nb, 16]
    d = np.abs(s).max(axis=1) / 127.0
    sc8 = np.clip(np.round(s * _inv(d)[:, None]), -127, 127).astype(np.int8)
    eff = d[:, None] * sc8.astype(F32)
    q = np.clip(np.round(xg * _inv(eff)[:, :, None]), -32, 31).astype(np.int32) + 32
    q = q.astype(np.uint8).reshape(nb, QK_K)
    # map elements into ql/qh per the llama.cpp interleave (see dequant._q6k_index)
    out = np.empty((nb, 210), dtype=np.uint8)
    ql = np.zeros((nb, 128), dtype=np.uint8)
    qh = np.zeros((nb, 64), dtype=np.uint8)
    e = np.arange(QK_K)
    n, rem = e // 128, e % 128
    quarter, l = rem // 32, rem % 32
    ql_idx = n * 64 + l + np.where((quarter % 2) == 1, 32, 0)
    ql_shift = np.where(quarter >= 2, 4, 0)
    qh_idx = n * 32 + l
    qh_shift = 2 * quarter
    lo = (q & 0x0F).astype(np.uint8)
    hi = (q >> 4).astype(np.uint8)
    np.add.at(ql, (np.arange(nb)[:, None], ql_idx[None, :]), (lo.astype(np.uint16) << ql_shift[None, :]).astype(np.uint8))
    np.add.at(qh, (np.arange(nb)[:, None], qh_idx[None, :]), (hi.astype(np.uint16) << qh_shift[None, :]).astype(np.uint8))
    out[:, 0:128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc8.view(np.uint8)
    out[:, 208:210] = _to_f16_bytes(d).reshape(nb, 2)
    return out.reshape(-1)


def quantize_q2_k(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, QK_K)
    nb = xb.shape[0]
    xg = xb.reshape(nb, 16, 16)
    scale, minv = _fit_affine_groups(xg, 3)  # [nb, 16]
    d = scale.max(axis=1) / 15.0
    dmin = minv.max(axis=1) / 15.0
    sc4 = np.clip(np.round(scale * _inv(d)[:, None]), 0, 15).astype(np.uint8)
    mn4 = np.clip(np.round(minv * _inv(dmin)[:, None]), 0, 15).astype(np.uint8)
    eff_scale = d[:, None] * sc4.astype(F32)
    eff_min = dmin[:, None] * mn4.astype(F32)
    q = np.clip(
        np.round((xg + eff_min[:, :, None]) * _inv(eff_scale)[:, :, None]), 0, 3
    ).astype(np.uint8).reshape(nb, QK_K)
    out = np.empty((nb, 84), dtype=np.uint8)
    out[:, 0:16] = sc4 | (mn4 << 4)
    # qs layout: byte h*32+l holds elements at shifts 2j (see dequant._q2k_index)
    qs = np.zeros((nb, 64), dtype=np.uint8)
    e = np.arange(QK_K)
    h, j, l = e // 128, (e % 128) // 32, e % 32
    byte_idx = h * 32 + l
    np.add.at(qs, (np.arange(nb)[:, None], byte_idx[None, :]), (q.astype(np.uint16) << (2 * j)[None, :]).astype(np.uint8))
    out[:, 16:80] = qs
    out[:, 80:82] = _to_f16_bytes(d).reshape(nb, 2)
    out[:, 82:84] = _to_f16_bytes(dmin).reshape(nb, 2)
    return out.reshape(-1)


def _pack_q3k_scales(sc: np.ndarray) -> np.ndarray:
    """Inverse of dequant._q3k_scales: int scales in [-32,31] -> 12 bytes."""
    u = (sc + 32).astype(np.uint8)  # [nb, 16], 6-bit
    nb = u.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    out[:, 0:4] = (u[:, 0:4] & 0x0F) | ((u[:, 8:12] & 0x0F) << 4)
    out[:, 4:8] = (u[:, 4:8] & 0x0F) | ((u[:, 12:16] & 0x0F) << 4)
    out[:, 8:12] = (
        ((u[:, 0:4] >> 4) & 3)
        | (((u[:, 4:8] >> 4) & 3) << 2)
        | (((u[:, 8:12] >> 4) & 3) << 4)
        | (((u[:, 12:16] >> 4) & 3) << 6)
    )
    return out


def quantize_q3_k(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, QK_K)
    nb = xb.shape[0]
    xg = xb.reshape(nb, 16, 16)
    idx = np.argmax(np.abs(xg), axis=-1)
    smax = np.take_along_axis(xg, idx[:, :, None], axis=-1)[:, :, 0]
    s = smax / -4.0  # q in [-4, 3]
    d = np.abs(s).max(axis=1) / 31.0
    sc6 = np.clip(np.round(s * _inv(d)[:, None]), -32, 31).astype(np.int32)
    eff = d[:, None] * sc6.astype(F32)
    q = np.clip(np.round(xg * _inv(eff)[:, :, None]), -4, 3).astype(np.int32) + 4
    q = q.astype(np.uint8).reshape(nb, QK_K)  # 0..7
    out = np.empty((nb, 110), dtype=np.uint8)
    hmask = np.zeros((nb, 32), dtype=np.uint8)
    qs = np.zeros((nb, 64), dtype=np.uint8)
    e = np.arange(QK_K)
    h, j, l = e // 128, (e % 128) // 32, e % 32
    byte_idx = h * 32 + l
    np.add.at(qs, (np.arange(nb)[:, None], byte_idx[None, :]), ((q & 3).astype(np.uint16) << (2 * j)[None, :]).astype(np.uint8))
    hbit = (q >> 2) & 1  # 1 means "no subtraction of 4"
    np.add.at(hmask, (np.arange(nb)[:, None], (e % 32)[None, :]), (hbit.astype(np.uint16) << (e // 32)[None, :]).astype(np.uint8))
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = _pack_q3k_scales(sc6)
    out[:, 108:110] = _to_f16_bytes(d).reshape(nb, 2)
    return out.reshape(-1)


def quantize_q8_k(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, QK_K)
    nb = xb.shape[0]
    amax = np.abs(xb).max(axis=1)
    d = amax / 127.0
    q = np.clip(np.round(xb * _inv(d)[:, None]), -127, 127).astype(np.int8)
    bsums = q.astype(np.int32).reshape(nb, 16, 16).sum(axis=2).astype("<i2")
    out = np.empty((nb, 292), dtype=np.uint8)
    out[:, 0:4] = np.ascontiguousarray(d.astype("<f4")).view(np.uint8).reshape(nb, 4)
    out[:, 4:260] = q.view(np.uint8)
    out[:, 260:292] = bsums.view(np.uint8).reshape(nb, 32)
    return out.reshape(-1)


def quantize_iq4_nl(x: np.ndarray) -> np.ndarray:
    xb = _groups(x, 32)
    nb = xb.shape[0]
    idx = np.argmax(np.abs(xb), axis=1)
    smax = xb[np.arange(nb), idx]
    d = smax / -127.0  # kvalues span ~[-127, 113]
    scaled = xb * _inv(d)[:, None]
    # nearest kvalue index
    q = np.abs(scaled[:, :, None] - KVALUES_IQ4NL[None, None, :]).argmin(axis=2).astype(np.uint8)
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d).reshape(nb, 2)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def quantize_iq4_xs(x: np.ndarray) -> np.ndarray:
    """IQ4_XS: 256-superblocks of 8 groups x 32 elems on the IQ4_NL
    nonlinear kvalue grid, with one f16 super-scale and 6-bit per-group
    scales (ls - 32), packed 4 low bits + 2 high bits.

    Encoder (no imatrix): per-group signed-max scale like iq4_nl, super
    d = max|d_g|/31, ls = round(d_g/d)+32, then nearest-kvalue per elem."""
    xb = _groups(x, QK_K)  # [nb, 256]
    nb = xb.shape[0]
    g = xb.reshape(nb, 8, 32)
    idx = np.argmax(np.abs(g), axis=2)  # [nb, 8]
    smax = np.take_along_axis(g, idx[..., None], axis=2)[..., 0]
    dg = smax / -127.0  # kvalues span ~[-127, 113]
    d = np.abs(dg).max(axis=1) / 31.0  # [nb]
    ls = np.clip(np.rint(dg * _inv(d)[:, None]), -31, 31).astype(np.int32)
    dl = d[:, None] * ls.astype(F32)  # [nb, 8] effective group scales
    # nearest kvalue on the reconstructed value (robust to dl == 0)
    err = np.abs(g[..., None] - dl[..., None, None] * KVALUES_IQ4NL)
    q = err.argmin(axis=3).astype(np.uint8)  # [nb, 8, 32]
    lsu = (ls + 32).astype(np.uint32)  # [nb, 8] in [1, 63]
    out = np.empty((nb, 136), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d.astype(F32)).reshape(nb, 2)
    scales_h = np.zeros(nb, np.uint32)
    for j in range(8):
        scales_h |= ((lsu[:, j] >> 4) & 3) << (2 * j)
    out[:, 2:4] = scales_h.astype("<u2").view(np.uint8).reshape(nb, 2)
    lo = lsu & 0x0F
    out[:, 4:8] = (lo[:, 0::2] | (lo[:, 1::2] << 4)).astype(np.uint8)
    # qs layout: byte 16*grp + e%16 holds elems e and e+16 of the group
    out[:, 8:136] = (q[:, :, :16] | (q[:, :, 16:] << 4)).reshape(nb, 128)
    return out.reshape(-1)


# ---------------------------------------------------------------------------


def quantize_f16(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, F32).astype("<f2")).view(np.uint8).reshape(-1)


def quantize_bf16(x: np.ndarray) -> np.ndarray:
    u32 = np.ascontiguousarray(np.asarray(x, F32)).view(np.uint32)
    # round-to-nearest-even bf16
    rounded = ((u32 + 0x7FFF + ((u32 >> 16) & 1)) >> 16).astype("<u2")
    return rounded.view(np.uint8).reshape(-1)


def quantize_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, "<f4")).view(np.uint8).reshape(-1)


_QUANT: dict[GGMLType, Callable[[np.ndarray], np.ndarray]] = {
    GGMLType.F32: quantize_f32,
    GGMLType.F16: quantize_f16,
    GGMLType.BF16: quantize_bf16,
    GGMLType.Q4_0: quantize_q4_0,
    GGMLType.Q4_1: quantize_q4_1,
    GGMLType.Q5_0: quantize_q5_0,
    GGMLType.Q5_1: quantize_q5_1,
    GGMLType.Q8_0: quantize_q8_0,
    GGMLType.Q8_1: quantize_q8_1,
    GGMLType.Q2_K: quantize_q2_k,
    GGMLType.Q3_K: quantize_q3_k,
    GGMLType.Q4_K: quantize_q4_k,
    GGMLType.Q5_K: quantize_q5_k,
    GGMLType.Q6_K: quantize_q6_k,
    GGMLType.Q8_K: quantize_q8_k,
    GGMLType.IQ4_NL: quantize_iq4_nl,
    GGMLType.IQ4_XS: quantize_iq4_xs,
}


def supported_quant_types() -> set[GGMLType]:
    return set(_QUANT)


def quantize(x: np.ndarray, ggml_type: GGMLType | int) -> np.ndarray:
    """Quantize a float array to raw block bytes (uint8)."""
    t = GGMLType(ggml_type)
    if t not in _QUANT:
        raise NotImplementedError(
            f"quantize: {t.name} is not supported, as in the JAX package "
            "(ROADMAP queue 3)")
    return _QUANT[t](np.asarray(x, dtype=F32))
