"""The reference's own dequantization of GGML blocks, in plain PyTorch.

Frozen: written from llama.cpp's ``dequantize_row_*`` (ggml-quants.c) for
the three block formats the benchmark's weights use, and held against the
port's dequantization only in a CPU test. It imports nothing of the port.
"""

from __future__ import annotations

import torch

Q5_1, Q4_K, Q6_K, F32 = 7, 12, 14, 0


def _f16(b: torch.Tensor) -> torch.Tensor:
    """[..., 2] little-endian bytes -> float32."""
    return b.contiguous().view(torch.float16).float()[..., 0]


def _q4_k(b: torch.Tensor) -> torch.Tensor:
    d = _f16(b[:, 0:2])[:, None]
    dmin = _f16(b[:, 2:4])[:, None]
    s = b[:, 4:16].long()
    j = torch.arange(4, device=b.device)
    sc = torch.cat([s[:, j] & 63, (s[:, j + 8] & 15) | ((s[:, j] >> 6) << 4)], 1)
    mn = torch.cat([s[:, j + 4] & 63,
                    (s[:, j + 8] >> 4) | ((s[:, j + 4] >> 6) << 4)], 1)
    qs = b[:, 16:144].long().reshape(-1, 4, 32)
    q = torch.stack([qs & 15, qs >> 4], 2).reshape(-1, 8, 32)  # sub-block order
    w = d[:, :, None] * sc[:, :, None] * q - dmin[:, :, None] * mn[:, :, None]
    return w.reshape(-1, 256)


def _q6_k(b: torch.Tensor) -> torch.Tensor:
    ql = b[:, 0:128].long().reshape(-1, 2, 64)
    qh = b[:, 128:192].long().reshape(-1, 2, 32)
    sc = b[:, 192:208].view(torch.int8).float().reshape(-1, 2, 8)
    d = _f16(b[:, 208:210])[:, None, None]
    lo, hi = ql[:, :, :32], ql[:, :, 32:]
    q1 = (lo & 15) | ((qh & 3) << 4)
    q2 = (hi & 15) | (((qh >> 2) & 3) << 4)
    q3 = (lo >> 4) | (((qh >> 4) & 3) << 4)
    q4 = (hi >> 4) | (((qh >> 6) & 3) << 4)
    q = torch.stack([q1, q2, q3, q4], 2).float() - 32.0  # [n, half, 4, 32]
    # scale index: is = l // 16 (+ 0, 2, 4, 6 for q1..q4), per half
    s = sc.reshape(-1, 2, 4, 2)  # [n, half, quarter, l // 16]
    w = d[..., None, None] * s[..., None] * q.reshape(-1, 2, 4, 2, 16)
    return w.reshape(-1, 256)


def _q5_1(b: torch.Tensor) -> torch.Tensor:
    d = _f16(b[:, 0:2])[:, None]
    m = _f16(b[:, 2:4])[:, None]
    qh = b[:, 4:8].contiguous().view(torch.int32).long()  # [n, 1]
    qs = b[:, 8:24].long()
    j = torch.arange(16, device=b.device)
    x0 = (qs & 15) | (((qh >> j) << 4) & 16)
    x1 = (qs >> 4) | ((qh >> (j + 12)) & 16)
    return torch.cat([x0, x1], 1).float() * d + m


_BLOCKS = {Q4_K: (144, _q4_k), Q6_K: (210, _q6_k), Q5_1: (24, _q5_1)}


def dequantize(raw: torch.Tensor, fmt: int, shape: tuple[int, ...]
               ) -> torch.Tensor:
    """Flat uint8 bytes of a tensor -> float32 tensor of numpy ``shape``,
    on the bytes' device."""
    if fmt == F32:
        return raw.contiguous().view(torch.float32).reshape(shape).clone()
    nbytes, fn = _BLOCKS[fmt]
    return fn(raw.reshape(-1, nbytes)).reshape(shape)
