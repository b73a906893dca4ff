"""Numpy-vectorized block quantization (f32 -> GGML quant blocks).

A trimmed copy of llama_gguf_tpu/quant/quantize.py (the port never imports
the JAX package) for F32, F16, BF16, Q8_0, Q5_1, Q4_K and Q6_K; enough to
build the synthetic Q4_K_M models of utils/synthetic.py. Q8_0/Q5_1 follow
llama.cpp's reference quantizers; the K-quants use a direct two-level scale
fit whose blocks are layout-exact and decode with the same dequantizers.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..gguf.constants import GGMLType, QK_K

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
    GGMLType.Q5_1: quantize_q5_1,
    GGMLType.Q8_0: quantize_q8_0,
    GGMLType.Q4_K: quantize_q4_k,
    GGMLType.Q6_K: quantize_q6_k,
}


def quantize(x: np.ndarray, ggml_type: GGMLType | int) -> np.ndarray:
    """Quantize a float array to raw block bytes (uint8)."""
    t = GGMLType(ggml_type)
    if t not in _QUANT:
        raise NotImplementedError(
            f"quantize: {t.name} is not ported yet (ROADMAP queue 1)")
    return _QUANT[t](np.asarray(x, dtype=F32))
