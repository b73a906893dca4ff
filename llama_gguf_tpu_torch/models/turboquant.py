"""TurboQuant: 2/3/4-bit compressed KV-cache primitives and QJL sign
sketches (port of llama_gguf_tpu/models/turboquant.py, which is XLA code,
not a Pallas kernel), in plain torch ops.

A cache vector is Hadamard-rotated (a [D, D] product with the orthonormal
Sylvester matrix), quantized with a mid-rise uniform quantizer scaled by its
largest magnitude, and its levels bit-packed into uint8 lanes (4 values a
byte at 2 bits, 8 values in 3 bytes at 3 bits, 2 a byte at 4 bits). The
matrix is symmetric and orthonormal, so rotating back on read preserves dot
products up to the quantization error. QJL keeps one sign bit a dimension
of the rotated key and its norm; attention scores are estimated on the
signs directly (``qjl_scores_batched``, ops/attention.qjl_attention).

The rotation's sums may run in another order than XLA's, so a value a few
ulps from a level boundary (or from 0, for a sign) can land one level over
from the JAX package's; the quantizer, packing and unpacking themselves are
bit-identical on the same rotated input.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

# the Hadamard matrix on each device, built once per (dim, device): a CUDA
# graph's capture must find it made (its warm-up run makes it)
_ON_DEVICE: dict[tuple[int, str], torch.Tensor] = {}


@lru_cache(maxsize=None)
def hadamard_matrix(dim: int) -> np.ndarray:
    """Orthonormal Walsh-Hadamard matrix (Sylvester), dim a power of 2."""
    if dim & (dim - 1):
        raise ValueError(f"hadamard dim must be a power of 2, got {dim}")
    h = np.array([[1.0]], np.float32)
    while h.shape[0] < dim:
        h = np.block([[h, h], [h, -h]])
    return (h / np.sqrt(dim)).astype(np.float32)


def _hadamard(dim: int, device: torch.device) -> torch.Tensor:
    key = (dim, str(device))
    h = _ON_DEVICE.get(key)
    if h is None:
        h = _ON_DEVICE[key] = torch.from_numpy(hadamard_matrix(dim)).to(
            device)
    return h


def rotate(x: torch.Tensor) -> torch.Tensor:
    """Apply the Hadamard rotation along the last axis, in f32. H is
    symmetric and orthonormal, so it is its own inverse."""
    return torch.matmul(x.float(), _hadamard(x.shape[-1], x.device))


def quantize_midrise(x: torch.Tensor, bits: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (levels uint8 [..., D] in [0, 2^bits), scale [...]):
    deq = (level - 2^bits / 2 + 0.5) * delta, delta = 2 * amax / 2^bits."""
    n = 1 << bits
    amax = x.abs().amax(-1)
    delta = torch.clamp(2.0 * amax / n, min=1e-12)
    q = torch.floor(x / delta[..., None]) + (n // 2)
    return q.clamp(0, n - 1).to(torch.uint8), delta.float()


def dequantize_midrise(q: torch.Tensor, delta: torch.Tensor,
                       bits: int) -> torch.Tensor:
    n = 1 << bits
    return (q.float() - (n // 2) + 0.5) * delta[..., None]


def pack_levels(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack uint8 levels [..., D] -> packed uint8 [..., D * bits / 8]."""
    d = q.shape[-1]
    lead = q.shape[:-1]
    if bits == 2:
        g = q.reshape(*lead, d // 4, 4).to(torch.uint8)
        return (g[..., 0] | (g[..., 1] << 2) | (g[..., 2] << 4)
                | (g[..., 3] << 6))
    if bits == 3:
        g = q.reshape(*lead, d // 8, 8).to(torch.int32)
        word = g[..., 0]
        for i in range(1, 8):
            word = word | (g[..., i] << (3 * i))
        out = torch.stack([word & 0xFF, (word >> 8) & 0xFF,
                           (word >> 16) & 0xFF], dim=-1)
        return out.to(torch.uint8).reshape(*lead, d * 3 // 8)
    if bits == 4:
        g = q.reshape(*lead, d // 2, 2).to(torch.uint8)
        return g[..., 0] | (g[..., 1] << 4)
    raise ValueError(f"unsupported bit width {bits}")


def unpack_levels(p: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """Unpack uint8 [..., D * bits / 8] -> levels uint8 [..., D]."""
    lead = p.shape[:-1]
    if bits == 2:
        vals = torch.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3],
                           dim=-1)
        return vals.reshape(*lead, d)
    if bits == 3:
        trip = p.reshape(*lead, d // 8, 3).to(torch.int32)
        word = trip[..., 0] | (trip[..., 1] << 8) | (trip[..., 2] << 16)
        vals = torch.stack([(word >> (3 * i)) & 7 for i in range(8)], dim=-1)
        return vals.to(torch.uint8).reshape(*lead, d)
    if bits == 4:
        vals = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1)
        return vals.reshape(*lead, d)
    raise ValueError(f"unsupported bit width {bits}")


def compress(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """float [..., D] -> (packed uint8 [..., D * bits / 8], scale [...])."""
    q, delta = quantize_midrise(rotate(x), bits)
    return pack_levels(q, bits), delta


def decompress(packed: torch.Tensor, delta: torch.Tensor, bits: int,
               d: int) -> torch.Tensor:
    """Inverse of compress: the de-rotated f32 [..., D]."""
    q = unpack_levels(packed, bits, d)
    return rotate(dequantize_midrise(q, delta, bits))


def qjl_compress(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """k [..., D] -> (sign bits of H k packed uint8 [..., D / 8], the
    norms [...])."""
    signs = (rotate(k) > 0).to(torch.uint8)
    d = signs.shape[-1]
    g = signs.reshape(*signs.shape[:-1], d // 8, 8)
    packed = g[..., 0]
    for i in range(1, 8):
        packed = packed | (g[..., i] << i)
    kf = k.float()
    return packed, torch.sqrt((kf * kf).sum(-1))


def _signs(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Packed sign bits [..., D / 8] -> +-1 f32 [..., D]."""
    bits = torch.stack([(packed >> i) & 1 for i in range(8)], dim=-1)
    return bits.reshape(*packed.shape[:-1], d).float() * 2 - 1


_QJL_SCALE = float(np.float32(math.sqrt(math.pi / 2)))


def qjl_scores_batched(q: torch.Tensor, packed: torch.Tensor,
                       norms: torch.Tensor) -> torch.Tensor:
    """Estimated <q, k> for GQA attention: q [B, T, K, R, D] (not rotated);
    packed [B, S, K, D / 8]; norms [B, S, K] -> scores [B, T, K, R, S]."""
    d = q.shape[-1]
    raw = torch.einsum("btkrd,bskd->btkrs", rotate(q),
                       _signs(packed, d)) / math.sqrt(d)
    return raw * norms.transpose(1, 2)[:, None, :, None, :] * _QJL_SCALE


def qjl_scores(q: torch.Tensor, packed: torch.Tensor,
               norms: torch.Tensor) -> torch.Tensor:
    """<q, k> ~= sqrt(pi/2) * ||k|| * <sign(H k), H q> / sqrt(D) for every
    stored key. q [..., D]; packed [S, D / 8]; norms [S] -> [..., S]."""
    d = q.shape[-1]
    raw = torch.matmul(rotate(q), _signs(packed, d).t()) / math.sqrt(d)
    return raw * norms * _QJL_SCALE
