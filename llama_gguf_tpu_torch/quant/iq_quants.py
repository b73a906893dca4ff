"""Importance-quant (IQ2/IQ3/IQ1) dequantization.

A copy of llama_gguf_tpu/quant/iq_quants.py (the port never imports the JAX
package). These formats store E8/E4-lattice codebook indices plus packed
sign masks:

  IQ2_XXS (66B/256): f16 d; 32x u16. Per 32 elements, 2 u32 words: 4 bytes of
      8-bit indices into the 256-entry 2-bit grid (8 values each), then
      4x7 bits of sign-table indices + a 4-bit scale:
      value = d*(0.5+scale)*0.25 * grid * sign.
  IQ2_XS  (74B/256): f16 d; 32x u16 (low 9 bits: 512-entry grid index,
      high 7: sign index); 4 bytes of two 4-bit scales each.
  IQ2_S   (82B/256): f16 d; qs[32] grid low byte; qh[8] packs 2 high bits
      per index (1024-entry grid); explicit signs[32]; scales[4].
  IQ3_XXS (98B/256): f16 d; qs[64] 8-bit indices into a 256-entry 3-bit
      grid (4 values each u32); 8x u32 of 4x7-bit signs + 4-bit scale.
  IQ3_S  (110B/256): f16 d; qs[64] + qh[8] high bits (512-entry grid);
      signs[32]; scales[4].
  IQ1_S/IQ1_M: dequantized to ZEROS, as in the JAX package: llama.cpp's
      ``iq1s_grid`` is a 2048-entry codebook from an offline clustering run,
      with no generating algorithm, and is not vendored.

The 7-bit sign table is algorithmic (index bits + odd-parity bit 7) and is
generated here; the lattice grid tables are the vendored format constants of
quant/iq_grid_data.py. The JAX package's override of those tables by an
iq_grids.npz file or LLAMA_GGUF_IQ_GRIDS is not ported (a deliberate
difference, ROADMAP queue 3).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import iq_grid_data

F32 = np.float32
QK_K = 256

GRID_NAMES = {
    "IQ2_XXS": ("kgrid_2bit_256", 256),
    "IQ2_XS": ("kgrid_2bit_512", 512),
    "IQ2_S": ("kgrid_2bit_1024", 1024),
    "IQ3_XXS": ("kgrid_3bit_256", 256),
    "IQ3_S": ("kgrid_3bit_512", 512),
}


@lru_cache(maxsize=None)
def ksigns() -> np.ndarray:
    """128-entry sign table: low 7 bits = index, bit 7 = odd parity
    (so every entry has an odd popcount — ggml's ksigns_iq2xs)."""
    i = np.arange(128, dtype=np.uint8)
    parity = np.zeros(128, np.uint8)
    v = i.copy()
    for _ in range(7):
        parity ^= v & 1
        v >>= 1
    return (i | ((parity ^ 1) << 7)).astype(np.uint8)


def _signs_from_index(idx: np.ndarray, n: int = 8) -> np.ndarray:
    """Expand sign-table bytes into +-1.0 factors [..., n]."""
    table = ksigns()
    bits = table[idx]
    out = np.empty(idx.shape + (n,), F32)
    for j in range(n):
        out[..., j] = np.where((bits >> j) & 1, -1.0, 1.0)
    return out


@lru_cache(maxsize=None)
def _grids() -> dict[str, np.ndarray]:
    return iq_grid_data.load()


def _grid(fmt: str) -> np.ndarray:
    """Grid as int8 [entries, 8] (2-bit grids) or [entries, 4] (3-bit)."""
    name, entries = GRID_NAMES[fmt]
    raw = _grids()[name]
    if raw.dtype == np.uint64:
        g = raw.view(np.uint8).reshape(entries, 8)
    else:
        g = raw.view(np.uint8).reshape(entries, 4)
    return g.astype(np.int8)


def _f16(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view("<f2").astype(F32)


def _blocks(raw, size):
    arr = np.frombuffer(raw, np.uint8) if not isinstance(raw, np.ndarray) else raw
    return arr.reshape(-1, size)


def dequantize_iq2_xxs(raw) -> np.ndarray:
    g = _grid("IQ2_XXS").astype(F32)
    b = _blocks(raw, 66)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])  # [nb, 1]
    q16 = np.ascontiguousarray(b[:, 2:66]).view("<u2").reshape(nb, 8, 4)
    aux8 = np.ascontiguousarray(q16[:, :, :2]).view(np.uint8)  # [nb,8,4] idx
    aux32 = (q16[:, :, 2].astype(np.uint32)
             | (q16[:, :, 3].astype(np.uint32) << 16))  # [nb,8]
    scale = (0.5 + (aux32 >> 28).astype(F32)) * 0.25  # [nb,8]
    vals = g[aux8]  # [nb, 8, 4, 8]
    sidx = np.stack([(aux32 >> (7 * j)) & 127 for j in range(4)], -1)
    signs = _signs_from_index(sidx.astype(np.uint8))  # [nb,8,4,8]
    out = d[:, :, None, None] * scale[:, :, None, None] * vals * signs
    return out.reshape(-1).astype(F32)


def _half_scales(sc: np.ndarray) -> np.ndarray:
    """scales u8 [nb, 8] -> [nb, 32]: per 32-group byte ib32, the low nibble
    scales index slots l<2 (elements 0..15) and the high nibble slots l>=2
    (elements 16..31) — iq_quants.rs:153-163."""
    nb = sc.shape[0]
    lo = (sc & 0xF).astype(F32)
    hi = (sc >> 4).astype(F32)
    # per group: [lo, lo, hi, hi] over the four 8-element index slots
    return np.stack([lo, lo, hi, hi], axis=-1).reshape(nb, 32)


def dequantize_iq2_xs(raw) -> np.ndarray:
    g = _grid("IQ2_XS").astype(F32)
    b = _blocks(raw, 74)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])
    q16 = np.ascontiguousarray(b[:, 2:66]).view("<u2").reshape(nb, 32)
    db = d * (0.5 + _half_scales(b[:, 66:74])) * 0.25  # [nb, 32] per slot
    vals = g[q16 & 511]  # [nb, 32, 8]
    signs = _signs_from_index((q16 >> 9).astype(np.uint8))  # [nb,32,8]
    out = db[:, :, None] * vals * signs
    return out.reshape(-1).astype(F32)


def dequantize_iq2_s(raw) -> np.ndarray:
    g = _grid("IQ2_S").astype(F32)
    b = _blocks(raw, 82)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34]       # [nb, 32] grid low byte (first half of qs[64])
    signs = b[:, 34:66]   # [nb, 32] explicit sign bytes (second half)
    qh = b[:, 66:74]      # [nb, 8] 2 high bits per index slot, 4 slots/byte
    db = d * (0.5 + _half_scales(b[:, 74:82])) * 0.25  # [nb, 32]
    shift = (np.arange(32) % 4 * 2).astype(np.uint8)
    hi = (qh[:, np.arange(32) // 4] >> shift) & 3
    idx = qs.astype(np.uint16) | (hi.astype(np.uint16) << 8)
    vals = g[idx]  # [nb, 32, 8]
    sgn = np.empty((nb, 32, 8), F32)
    for j in range(8):
        sgn[:, :, j] = np.where((signs >> j) & 1, -1.0, 1.0)
    out = db[:, :, None] * vals * sgn
    return out.reshape(-1).astype(F32)


def dequantize_iq3_xxs(raw) -> np.ndarray:
    g = _grid("IQ3_XXS").astype(F32)
    b = _blocks(raw, 98)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])
    qs = b[:, 2:66]  # [nb, 64] 8-bit grid indices, 4 values each
    aux32 = np.ascontiguousarray(b[:, 66:98]).view("<u4").reshape(nb, 8)
    scale = (0.5 + (aux32 >> 28).astype(F32)) * 0.5  # [nb, 8]
    vals = g[qs].reshape(nb, 8, 8, 4)  # 8 groups x 8 idx x 4 vals
    sidx = np.stack([(aux32 >> (7 * j)) & 127 for j in range(4)], -1)
    signs = _signs_from_index(sidx.astype(np.uint8))  # [nb,8,4,8]
    signs = signs.reshape(nb, 8, 32).reshape(nb, 8, 8, 4)
    out = d[:, :, None, None] * scale[:, :, None, None] * vals * signs
    return out.reshape(-1).astype(F32)


def dequantize_iq3_s(raw) -> np.ndarray:
    g = _grid("IQ3_S").astype(F32)
    b = _blocks(raw, 110)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])
    qs = b[:, 2:66]      # [nb, 64]
    qh = b[:, 66:74]     # [nb, 8]: bit j of qh[i] = high bit of idx 8i+j
    signs = b[:, 74:106]  # [nb, 32]
    sc = b[:, 106:110]
    scales = np.empty((nb, 8), F32)
    scales[:, 0::2] = (sc & 0xF).astype(F32)
    scales[:, 1::2] = (sc >> 4).astype(F32)
    db = d * (1 + 2 * scales)
    shift = (np.arange(64) % 8).astype(np.uint8)
    hi = (qh[:, np.arange(64) // 8] >> shift) & 1
    idx = qs.astype(np.uint16) | (hi.astype(np.uint16) << 8)
    vals = g[idx].reshape(nb, 8, 8, 4)  # [nb, group, idx-in-group, 4]
    sgn = np.empty((nb, 32, 8), F32)
    for j in range(8):
        sgn[:, :, j] = np.where((signs >> j) & 1, -1.0, 1.0)
    out = db[:, :, None, None] * (vals * sgn.reshape(nb, 8, 8, 4))
    return out.reshape(-1).astype(F32)


def dequantize_iq1_zeros(raw, block_bytes: int) -> np.ndarray:
    """IQ1_S/IQ1_M -> zeros (reference parity, iq_quants.rs:342-350)."""
    b = _blocks(raw, block_bytes)
    return np.zeros(b.shape[0] * QK_K, F32)
