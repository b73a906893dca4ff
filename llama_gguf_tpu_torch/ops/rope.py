"""Rotary position embeddings: Normal and NeoX pairing, partial, linear/YaRN
scaling (port of llama_gguf_tpu/ops/rope.py).

Normal pairing rotates (x[2i], x[2i+1]), NeoX rotates (x[i], x[i+d/2]);
partial RoPE rotates only the first (or last) n_dims of the head dimension.
"""

from __future__ import annotations

import math

import torch

from ..models.config import RopeConfig, RopeScalingType, RopeType


def rope_inv_freq(cfg: RopeConfig, device=None) -> torch.Tensor:
    """Per-pair inverse frequencies [n_dims/2], with YaRN interpolation."""
    half = cfg.n_dims // 2
    exponents = torch.arange(0, half, dtype=torch.float32,
                             device=device) * (2.0 / cfg.n_dims)
    inv_freq = 1.0 / (cfg.freq_base ** exponents)
    if cfg.scaling_type == RopeScalingType.YARN and cfg.yarn_ext_factor != 0.0:
        # YaRN: interpolate between scaled and unscaled freqs per dimension
        lo = _yarn_corr_dim(cfg, cfg.yarn_beta_fast)
        hi = _yarn_corr_dim(cfg, cfg.yarn_beta_slow)
        ramp = torch.clamp(
            (torch.arange(half, dtype=torch.float32, device=device) - lo)
            / max(hi - lo, 1e-3), 0.0, 1.0)
        mask = (1.0 - ramp) * cfg.yarn_ext_factor
        return inv_freq / cfg.freq_scale * (1 - mask) + inv_freq * mask
    return inv_freq


def _yarn_corr_dim(cfg: RopeConfig, n_rot: float) -> float:
    return (
        cfg.n_dims
        * math.log(cfg.original_max_position_embeddings / (n_rot * 2 * math.pi))
        / (2 * math.log(cfg.freq_base))
    )


def rope_cos_sin(positions: torch.Tensor, cfg: RopeConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions [...], each [..., n_dims/2]."""
    inv_freq = rope_inv_freq(cfg, positions.device)
    scale = cfg.freq_scale if cfg.scaling_type != RopeScalingType.YARN else 1.0
    theta = positions[..., None].float() * scale * inv_freq
    attn_factor = (cfg.yarn_attn_factor
                   if cfg.scaling_type == RopeScalingType.YARN else 1.0)
    return torch.cos(theta) * attn_factor, torch.sin(theta) * attn_factor


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               cfg: RopeConfig) -> torch.Tensor:
    """Apply RoPE to x [..., n_heads, head_dim]; cos/sin [..., n_dims/2]
    broadcast over the heads axis."""
    head_dim = x.shape[-1]
    nd = cfg.n_dims
    if nd < head_dim:
        if cfg.partial_at_end:
            pass_part, rot_part = x[..., : head_dim - nd], x[..., head_dim - nd:]
        else:
            rot_part, pass_part = x[..., :nd], x[..., nd:]
    else:
        rot_part, pass_part = x, None

    rot_part = rot_part.float()
    c = cos[..., None, :]  # broadcast over heads: [..., 1, nd/2]
    s = sin[..., None, :]
    if cfg.rope_type == RopeType.NEOX:
        x1 = rot_part[..., : nd // 2]
        x2 = rot_part[..., nd // 2:]
        rotated = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    else:  # NORMAL: interleaved pairs
        x1 = rot_part[..., 0::2]
        x2 = rot_part[..., 1::2]
        rotated = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                              dim=-1).reshape(rot_part.shape)

    rotated = rotated.to(x.dtype)
    if pass_part is None:
        return rotated
    if cfg.partial_at_end:
        return torch.cat([pass_part, rotated], dim=-1)
    return torch.cat([rotated, pass_part], dim=-1)


def rerotate_keys(k: torch.Tensor, delta: int, cfg: RopeConfig
                  ) -> torch.Tensor:
    """Rotate stored (post-RoPE) keys by a fixed position delta.

    RoPE is linear in position: moving a key from position p to p + delta is
    a rotation by delta * theta whatever p is. Used by the KV context shift
    (models/kv.shift_left), so shifted keys stay consistent with their new
    positions. k: [..., H, D] (any leading dims)."""
    cos, sin = rope_cos_sin(torch.tensor(delta, dtype=torch.float32,
                                         device=k.device), cfg)
    return apply_rope(k, cos, sin, cfg)
