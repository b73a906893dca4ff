"""Normalization ops (port of llama_gguf_tpu/ops/norms.py): f32 arithmetic
whatever the input dtype, result in the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             add_unit_offset: bool = False) -> torch.Tensor:
    """RMSNorm. ``add_unit_offset`` multiplies by (1 + w) (Gemma family)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    w = weight.float()
    if add_unit_offset:
        w = 1.0 + w
    return (normed * w).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps)) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def apply_norm(x: torch.Tensor, norm_params: dict, eps: float,
               use_layer_norm: bool = False,
               add_unit_offset: bool = False) -> torch.Tensor:
    if use_layer_norm:
        return layer_norm(x, norm_params["weight"], norm_params.get("bias"),
                          eps)
    return rms_norm(x, norm_params["weight"], eps, add_unit_offset)
