"""Host-side repacking of GGUF quant blocks into the fused kernels' layouts.

A copy of llama_gguf_tpu/quant/repack.py (the port never imports the JAX
package) for the 13 formats the loader keeps quantized; any other type
raises NotImplementedError, as in the JAX package. Two device layouts,
consumed by the dequant-matmul kernels in ops/qmatmul.py:

  q4: nibble-packed uint8 [K/2, N] in GROUP-LOCAL split order: packed row r
      belongs to scale group g = r // (group/2) and holds element
      j = r % (group/2) of that group in its low nibble and element
      j + group/2 in its high nibble.
  q8: int8 [K, N].

plus float32 scale/min panels [K/group, N]:   W[k, n] = s[g, n] * q[k, n] - m[g, n]

The mapping is exact (integer levels and per-group effective scales come
straight from the block fields), so kernel results match the f32 dequant
oracle up to the order of summation. The levels, scales and mins of the nine
formats of native.NATIVE_FORMATS come from the native library (``_extract``),
bit-equal to the numpy version (``_extract_numpy``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native
from ..gguf.constants import GGMLType, QK_K, type_traits
from . import dequant as DQ

F32 = np.float32


@dataclass
class RepackedWeight:
    """Numpy-land repacked weight for a [N, K] (out, in) GGUF tensor."""

    packed: np.ndarray  # uint8 [K/2, N] (q4) or int8 [K, N] (q8)
    scales: np.ndarray  # f32 [K/group, N]
    mins: np.ndarray | None  # f32 [K/group, N] or None
    fmt: str  # "q4" | "q8"
    group: int
    k: int
    n: int
    source_type: GGMLType


def _f16(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view("<f2").astype(F32)


def _extract(raw: np.ndarray, t: GGMLType, n: int, k: int):
    """Return (q_int [N, K], scales [N, K/g], mins [N, K/g] | None, fmt, g):
    the native library's for the nine formats of native.NATIVE_FORMATS
    (bit-equal), ``_extract_numpy``'s for the other four and under
    LLAMA_GGUF_NO_NATIVE."""
    if t.name in native.NATIVE_FORMATS:
        out = native.extract_native(raw, t.name, n, k)
        native.record("extract", t.name, out is not None)
        if out is not None:
            return out
    return _extract_numpy(raw, t, n, k)


def _extract_numpy(raw: np.ndarray, t: GGMLType, n: int, k: int):
    """``_extract`` in numpy, for every kept format.

    q_int holds the stored integer levels; for q4 formats they are unsigned
    0..15, for q8 formats they are int8.
    """
    tr = type_traits(t)
    nb_row = k // tr.block_size
    b = np.ascontiguousarray(raw).reshape(n, nb_row, tr.type_size)
    flat = b.reshape(n * nb_row, tr.type_size)

    if t == GGMLType.Q4_0:
        d = _f16(flat[:, 0:2])  # [nb, 1]
        qs = flat[:, 2:18]
        q = np.concatenate([qs & 0x0F, qs >> 4], axis=1)  # [nb, 32]
        scales = d
        mins = 8.0 * d
        return (q.reshape(n, k), scales.reshape(n, k // 32),
                mins.reshape(n, k // 32), "q4", 32)

    if t == GGMLType.Q4_1:
        d = _f16(flat[:, 0:2])
        m = _f16(flat[:, 2:4])
        qs = flat[:, 4:20]
        q = np.concatenate([qs & 0x0F, qs >> 4], axis=1)
        return (q.reshape(n, k), d.reshape(n, k // 32),
                (-m).reshape(n, k // 32), "q4", 32)

    if t == GGMLType.Q5_0:
        d = _f16(flat[:, 0:2])
        qh = np.ascontiguousarray(flat[:, 2:6]).view("<u4")
        qs = flat[:, 6:22]
        i = np.arange(16, dtype=np.uint32)
        lo = (qs & 0x0F).astype(np.int16) | (((qh >> i) & 1) << 4).astype(np.int16)
        hi = (qs >> 4).astype(np.int16) | (((qh >> (i + 16)) & 1) << 4).astype(np.int16)
        q = (np.concatenate([lo, hi], axis=1) - 16).astype(np.int8)
        return q.reshape(n, k), d.reshape(n, k // 32), None, "q8", 32

    if t == GGMLType.Q5_1:
        d = _f16(flat[:, 0:2])
        m = _f16(flat[:, 2:4])
        qh = np.ascontiguousarray(flat[:, 4:8]).view("<u4")
        qs = flat[:, 8:24]
        i = np.arange(16, dtype=np.uint32)
        lo = (qs & 0x0F).astype(np.int16) | (((qh >> i) & 1) << 4).astype(np.int16)
        hi = (qs >> 4).astype(np.int16) | (((qh >> (i + 16)) & 1) << 4).astype(np.int16)
        q = np.concatenate([lo, hi], axis=1).astype(np.int8)
        return (q.reshape(n, k), d.reshape(n, k // 32),
                (-m).reshape(n, k // 32), "q8", 32)

    if t == GGMLType.Q8_0:
        d = _f16(flat[:, 0:2])
        q = flat[:, 2:34].view(np.int8)
        return q.reshape(n, k), d.reshape(n, k // 32), None, "q8", 32

    if t == GGMLType.Q2_K:
        scales_b = flat[:, 0:16]
        qs = flat[:, 16:80]
        d = _f16(flat[:, 80:82])
        dmin = _f16(flat[:, 82:84])
        byte_idx, shift, _ = DQ._q2k_index()
        q = (qs[:, byte_idx] >> shift) & 3  # [nb, 256]
        # per-group-of-16 scale/min
        s = d * (scales_b & 0x0F).astype(F32)
        m = dmin * (scales_b >> 4).astype(F32)
        return (q.reshape(n, k), s.reshape(n, k // 16),
                m.reshape(n, k // 16), "q4", 16)

    if t == GGMLType.Q3_K:
        hmask = flat[:, 0:32]
        qs = flat[:, 32:96]
        sc16 = DQ._q3k_scales(flat[:, 96:108])  # [nb, 16] int32
        d = _f16(flat[:, 108:110])
        byte_idx, shift, hm_idx, hm_bit, _ = DQ._q3k_index()
        lo2 = ((qs[:, byte_idx] >> shift) & 3).astype(np.int16)
        hbit = ((hmask[:, hm_idx] >> hm_bit) & 1).astype(np.int16)
        q = (lo2 - 4 * (1 - hbit)).astype(np.int8)
        s = d * sc16.astype(F32)
        return (q.reshape(n, k), s.reshape(n, k // 16), None, "q8", 16)

    if t == GGMLType.Q4_K:
        d = _f16(flat[:, 0:2])
        dmin = _f16(flat[:, 2:4])
        sc, mn = DQ._k4_scale_min(flat[:, 4:16])  # [nb, 8]
        qs = flat[:, 16:144]
        byte_idx, nib, _ = DQ._q4k_index()
        q = (qs[:, byte_idx] >> nib) & 0x0F
        return (q.reshape(n, k), (d * sc).reshape(n, k // 32),
                (dmin * mn).reshape(n, k // 32), "q4", 32)

    if t == GGMLType.Q5_K:
        d = _f16(flat[:, 0:2])
        dmin = _f16(flat[:, 2:4])
        sc, mn = DQ._k4_scale_min(flat[:, 4:16])
        qh = flat[:, 16:48]
        qs = flat[:, 48:176]
        byte_idx, nib, _ = DQ._q4k_index()
        e = np.arange(QK_K)
        hbit = (qh[:, e % 32] >> (e // 32).astype(np.uint8)) & 1
        q = (((qs[:, byte_idx] >> nib) & 0x0F) + 16 * hbit).astype(np.int8)
        return (q.reshape(n, k), (d * sc).reshape(n, k // 32),
                (dmin * mn).reshape(n, k // 32), "q8", 32)

    if t == GGMLType.Q6_K:
        ql = flat[:, 0:128]
        qh = flat[:, 128:192]
        sc = flat[:, 192:208].view(np.int8)
        d = _f16(flat[:, 208:210])
        ql_idx, ql_shift, qh_idx, qh_shift, sc_idx = DQ._q6k_index()
        lo = (ql[:, ql_idx] >> ql_shift) & 0x0F
        hi = (qh[:, qh_idx] >> qh_shift) & 0x03
        # each natural group of 16 elements shares one scale; sc_idx[::16]
        # gives that scale's index in the stored (interleaved) order
        s = d * sc[:, sc_idx[::16]].astype(F32)
        q = ((lo.astype(np.int16) | (hi.astype(np.int16) << 4)) - 32).astype(np.int8)
        return (q.reshape(n, k), s.reshape(n, k // 16), None, "q8", 16)

    if t == GGMLType.Q8_K:
        d = np.ascontiguousarray(flat[:, 0:4]).view("<f4")
        q = flat[:, 4:260].view(np.int8)
        return q.reshape(n, k), d.reshape(n, k // QK_K), None, "q8", QK_K

    if t == GGMLType.IQ4_NL:
        d = _f16(flat[:, 0:2])
        qs = flat[:, 2:18]
        tab = DQ.KVALUES_IQ4NL.astype(np.int8)
        q = np.concatenate([tab[qs & 0x0F], tab[qs >> 4]], axis=1)
        return q.reshape(n, k), d.reshape(n, k // 32), None, "q8", 32

    if t == GGMLType.IQ4_XS:
        d = _f16(flat[:, 0:2])
        scales_h = np.ascontiguousarray(flat[:, 2:4]).view("<u2").astype(np.uint32)
        scales_l = flat[:, 4:8]
        qs = flat[:, 8:136]
        g = np.arange(8)
        ls = ((scales_l[:, g // 2] >> (4 * (g % 2)).astype(np.uint8)) & 0x0F).astype(
            np.int32
        ) | (((scales_h >> (2 * g)) & 3) << 4).astype(np.int32)
        s = d * (ls - 32).astype(F32)  # [nb, 8]
        e = np.arange(QK_K)
        byte_idx = 16 * (e // 32) + e % 16
        nib = ((e % 32) // 16 * 4).astype(np.uint8)
        tab = DQ.KVALUES_IQ4NL.astype(np.int8)
        q = tab[(qs[:, byte_idx] >> nib) & 0x0F]
        return q.reshape(n, k), s.reshape(n, k // 32), None, "q8", 32

    raise NotImplementedError(
        f"repack: {t.name} has no kernel layout, as in the JAX package "
        "(ROADMAP queue 3); such tensors load dense")


def _transpose(a: np.ndarray) -> np.ndarray:
    """Cache-blocked [N, M] -> [M, N] contiguous copy of one-byte levels:
    the native library's, or under LLAMA_GGUF_NO_NATIVE numpy's in slabs
    (numpy's plain ``ascontiguousarray(a.T)`` byte transpose is far slower
    at weight sizes)."""
    out = native.transpose_bytes(a)
    if out is not None:
        return out
    n, m = a.shape
    out = np.empty((m, n), a.dtype)
    step = 1024
    for i in range(0, n, step):
        out[:, i:i + step] = a[i:i + step].T
    return out


def repack(raw: np.ndarray | memoryview | bytes, ggml_type: GGMLType | int,
           shape_nk: tuple[int, int]) -> RepackedWeight:
    """Repack a quantized GGUF tensor (numpy shape [N=out, K=in]) into the
    [K, N] matmul layout. Bit-packing happens in the natural [N, K] layout
    before the transpose; the result is identical to pack_q4_group_split on
    the [K, N] side."""
    t = GGMLType(ggml_type)
    n, k = shape_nk
    arr = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    q, s, m, fmt, group = _extract(arr, t, n, k)

    scales = np.ascontiguousarray(s.T, dtype=F32)  # [K/g, N]
    mins = np.ascontiguousarray(m.T, dtype=F32) if m is not None else None
    if fmt == "q4":
        h = group // 2
        q3 = q.reshape(n, k // group, group).astype(np.uint8, copy=False)
        pk = (q3[..., :h] | (q3[..., h:] << 4)).reshape(n, k // 2)
        packed = _transpose(np.ascontiguousarray(pk))
    else:
        packed = _transpose(np.ascontiguousarray(q, dtype=np.int8))
    return RepackedWeight(packed, scales, mins, fmt, group, k, n, t)


def pack_q4_group_split(q: np.ndarray, group: int) -> np.ndarray:
    """Group-local split packing: within each scale group of ``group``
    elements along K, byte j holds q[g*group + j] (low nibble) and
    q[g*group + j + group/2] (high nibble). q: uint8 [K, N] (0..15) ->
    uint8 [K/2, N]."""
    k, n = q.shape
    h = group // 2
    q3 = q.reshape(k // group, group, n)
    return np.ascontiguousarray(
        (q3[:, :h, :] | (q3[:, h:, :] << 4)).reshape(k // 2, n)
    )


def repack_rows(raw: np.ndarray | memoryview | bytes,
                ggml_type: GGMLType | int,
                shape_vh: tuple[int, int]):
    """Row-major repack for embedding-style gather tables.

    Rows stay rows: returns (packed, scales [V, H/g] f32, mins | None, fmt,
    group) with packed uint8 [V, H/2] (q4, group-split within each row) or
    int8 [V, H] (q8). See ops.linear.QuantEmbedding.
    """
    t = GGMLType(ggml_type)
    v, h = shape_vh
    arr = (np.frombuffer(raw, dtype=np.uint8)
           if not isinstance(raw, np.ndarray) else raw)
    q, s, m, fmt, group = _extract(arr, t, v, h)
    scales = np.ascontiguousarray(s, dtype=F32)  # [V, H/g]
    mins = np.ascontiguousarray(m, dtype=F32) if m is not None else None
    if fmt == "q4":
        g2 = group // 2
        q3 = q.reshape(v, h // group, group).astype(np.uint8)
        packed = np.ascontiguousarray(
            (q3[:, :, :g2] | (q3[:, :, g2:] << 4)).reshape(v, h // 2))
    else:
        packed = np.ascontiguousarray(q).astype(np.int8)
    return packed, scales, mins, fmt, group
