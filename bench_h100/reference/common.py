"""Pieces the plain references share: RMSNorm, RoPE on adjacent pairs,
causal attention in query blocks, and the control's float8 rounding."""

from __future__ import annotations

import torch

QUERY_BLOCK = 1024  # queries per attention block: bounds the score matrix


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope_normal(x: torch.Tensor, pos: torch.Tensor, theta: float,
                dims: int) -> torch.Tensor:
    """Rotate adjacent pairs (x[2i], x[2i+1]) of x [T, heads, dims] by
    pos · theta^(-2i/dims) (llama.cpp's rope type NORM)."""
    inv = theta ** (-torch.arange(0, dims, 2, device=x.device,
                                  dtype=torch.float32) / dims)
    ang = pos[:, None].float() * inv  # [T, dims/2]
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], -1).reshape(x.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Causal softmax attention, q [T, H, D], k [T, H, D], v [T, H, Dv] ->
    [T, H, Dv], computed QUERY_BLOCK queries at a time."""
    t = q.shape[0]
    out = []
    for s in range(0, t, QUERY_BLOCK):
        e = min(s + QUERY_BLOCK, t)
        sc = torch.einsum("qhd,khd->hqk", q[s:e], k[:e]) * scale
        mask = torch.arange(e, device=q.device)[None, :] > \
            torch.arange(s, e, device=q.device)[:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out.append(torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), v[:e]))
    return torch.cat(out, 0)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row of its last axis
    (absmax to the format's 448)."""
    amax = x.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
