"""DeltaNet (gated delta rule) linear-attention layers of Qwen3Next hybrids
(port of llama_gguf_tpu/models/deltanet.py).

    S_t = S_{t-1} * exp(g_t) + beta_t (v_t - S_{t-1}' k_t) k_t^T,  o_t = S_t^T q_t

with S_{t-1}' the decayed state, and the causal depthwise conv1d + SiLU
pre-filter. The recurrence is no Pallas kernel in the JAX package (a
``lax.scan`` that XLA compiles), so here it is plain torch ops, one token
at a time, in the JAX order of operations.

The recurrent state lives in ``kv["deltanet"][layer]`` as {"S": [B, Hv, Dk,
Dv] f32, "conv": [B, K-1, C] f32} (placeholders on attention layers, as in
the JAX package) and is updated in place: the layer copies its new state
into the cache's own tensors, so a CUDA graph captured on the cache
(engine/runner.py) carries it from one replay to the next. Padding tokens
(positions >= lengths) leave both bit-unchanged.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops import linear as L
from ..ops.norms import apply_norm, rms_norm


def load_deltanet_layer(loader, i: int, cfg) -> dict:
    """A DeltaNet layer (Qwen3Next naming): the combined [q|k|v] ``ssm_in``
    with z in ``attn_gate``, and either the combined ``ssm_ba`` or separate
    ``ssm_beta``/``ssm_alpha`` projections."""
    p = f"blk.{i}"
    layer: dict[str, Any] = {"attn_norm": loader.norm(f"{p}.attn_norm")}
    dn: dict[str, Any] = {}
    for key, tname in (("in_proj", "ssm_in"), ("beta_proj", "ssm_beta"),
                       ("alpha_proj", "ssm_alpha"), ("ba_proj", "ssm_ba")):
        if loader.has(f"{p}.{tname}.weight"):
            dn[key] = loader.linear(f"{p}.{tname}")
    dn["conv_w"] = loader._put(loader.dense(f"{p}.ssm_conv1d.weight"))
    for key, tname in (("conv_b", "ssm_conv1d.bias"), ("dt_bias", "ssm_dt.bias"),
                       ("ssm_a", "ssm_a"), ("out_norm", "ssm_norm.weight")):
        if loader.has(f"{p}.{tname}"):
            dn[key] = loader._put(loader.dense(f"{p}.{tname}"))
    dn["z_proj"] = loader.linear(f"{p}.attn_gate")
    dn["out_proj"] = loader.linear(f"{p}.ssm_out")
    layer["deltanet"] = dn
    layer["ffn"] = loader._load_ffn(i, cfg)
    ffn_norm = loader.norm(f"{p}.ffn_norm", required=False)
    if ffn_norm is not None:
        layer["ffn_norm"] = ffn_norm
    return layer


def _head_dot(s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """einsum("bhkv,bhk->bhv"): S^T a per head."""
    return torch.matmul(a.unsqueeze(-2), s).squeeze(-2)


def delta_rule_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    beta: torch.Tensor, gate: torch.Tensor,
                    state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gated delta rule over a token sequence.

    q, k: [B, T, Hk, Dk] (L2-normalized per head); v: [B, T, Hv, Dv];
    beta: [B, T, Hv]; gate: [B, T, Hv] (log-decay, <= 0); state: [B, Hv,
    Dk, Dv]. Returns (out [B, T, Hv, Dv], new state); ``state`` itself is
    not written. Hv may be a multiple of Hk (value heads grouped over key
    heads, as jnp.repeat groups them). Per token: decay, prediction error,
    rank-1 update, read."""
    rep = v.shape[2] // q.shape[2]
    kv_ = k.repeat_interleave(rep, dim=2)  # [B, T, Hv, Dk]
    qv = q.repeat_interleave(rep, dim=2)
    decay = torch.exp(gate)
    s = state
    outs = []
    for t in range(q.shape[1]):
        s = s * decay[:, t, :, None, None]
        delta = (v[:, t] - _head_dot(s, kv_[:, t])) * beta[:, t, :, None]
        s = s + kv_[:, t, :, :, None] * delta[:, :, None, :]
        outs.append(_head_dot(s, qv[:, t]))
    return torch.stack(outs, dim=1), s


def deltanet_layer(layer: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                   kv: dict, layer_idx: int,
                   lengths: torch.Tensor | None = None,
                   precision: str | None = None) -> tuple[torch.Tensor, dict]:
    """The full DeltaNet block: norm -> conv + SiLU over [q|k|v] -> delta
    rule -> per-head norm, SiLU(z) gate -> out projection, then the FFN
    half. x [B, T, H]; positions [B, T]; lengths [B] (valid length after
    this step: positions >= lengths are padding, and the valid positions of
    a row come first). The layer's state in ``kv`` is updated in place."""
    from .transformer import ffn_forward

    b, t, _ = x.shape
    if lengths is not None:
        valid = positions < lengths[:, None]  # [B, T]
    else:
        valid = torch.ones((b, t), dtype=torch.bool, device=x.device)
    vm = valid.float()[..., None]
    dk, hk, hv = cfg.ssm_d_state, cfg.ssm_n_group, cfg.ssm_dt_rank
    dv = cfg.ssm_d_inner // max(hv, 1)

    h = apply_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.uses_layer_norm)
    dn = layer["deltanet"]
    # GGUF convention: ssm_in -> [q | k | v] flat, z from attn_gate
    nq, nv = hk * dk, hv * dv
    proj = L.apply(dn["in_proj"], h, precision).float()
    zf = L.apply(dn["z_proj"], h, precision).float()  # [B, T, Hv*Dv]

    # causal depthwise conv over [q|k|v], the ring state in front
    conv_w = dn["conv_w"].float()  # [C, K]
    ksz = conv_w.shape[-1]
    qkv = proj[..., :2 * nq + nv] * vm  # [B, T, C]
    st = kv["deltanet"][layer_idx]
    seq = torch.cat([st["conv"], qkv], dim=1)  # [B, K-1+T, C]
    conv = seq[:, 0:t] * conv_w[:, 0]
    for j in range(1, ksz):
        conv = conv + seq[:, j:j + t] * conv_w[:, j]
    if "conv_b" in dn:
        conv = conv + dn["conv_b"].float()
    conv = torch.nn.functional.silu(conv)
    # the new conv state: the last K-1 VALID inputs (padding excluded)
    n_valid = valid.sum(dim=1)
    gidx = n_valid[:, None] + torch.arange(ksz - 1, device=x.device)[None]
    new_conv = torch.gather(
        seq, 1, gidx[..., None].expand(-1, -1, seq.shape[-1]))

    q = conv[..., :nq].reshape(b, t, hk, dk)
    k = conv[..., nq:2 * nq].reshape(b, t, hk, dk)
    v = conv[..., 2 * nq:].reshape(b, t, hv, dv)
    # per-head L2 norm of q and k; q also scaled by Dk^-0.5
    q = q * torch.rsqrt(torch.sum(q * q, -1, keepdim=True) + 1e-6)
    k = k * torch.rsqrt(torch.sum(k * k, -1, keepdim=True) + 1e-6)
    q = q * (dk ** -0.5)

    if "ba_proj" in dn:  # combined beta/alpha, grouped per k-head:
        # [b(r) | a(r)] x Hk
        ba = L.apply(dn["ba_proj"], h, precision).float()  # [B, T, 2*Hv]
        rep = hv // max(hk, 1)
        bag = ba.reshape(b, t, hk, 2 * rep)
        beta_raw = bag[..., :rep].reshape(b, t, hv)
        alpha_raw = bag[..., rep:].reshape(b, t, hv)
    else:
        beta_raw = L.apply(dn["beta_proj"], h, precision).float()
        alpha_raw = L.apply(dn["alpha_proj"], h, precision).float()
    beta = torch.sigmoid(beta_raw)
    # GGUF stores ssm_a = -exp(A_log), already negative
    a = dn["ssm_a"].float() if "ssm_a" in dn else -1.0
    if "dt_bias" in dn:
        alpha_raw = alpha_raw + dn["dt_bias"].float()
    gate = a * torch.nn.functional.softplus(alpha_raw)  # log-decay <= 0
    # padding freezes the state: beta = 0 (no write), gate = 0 (decay 1)
    beta = beta * vm
    gate = gate * vm

    out, new_s = delta_rule_scan(q, k, v, beta, gate, st["S"])
    st["S"].copy_(new_s)
    st["conv"].copy_(new_conv)

    if "out_norm" in dn:  # per-head RMSNorm of the output
        out = rms_norm(out, dn["out_norm"], cfg.norm_eps)
    out = out * torch.nn.functional.silu(zf.reshape(b, t, hv, dv))
    out = out.reshape(b, t, hv * dv).to(x.dtype)
    x = x + L.apply(dn["out_proj"], out, precision)

    h2 = apply_norm(x, layer["ffn_norm"], cfg.norm_eps, cfg.uses_layer_norm)
    return x + ffn_forward(layer["ffn"], cfg, h2, precision), kv


def state_dims(cfg) -> tuple[int, int, int, int, int]:
    """(Hv, Dk, Dv, K, conv channels) of cfg's DeltaNet state."""
    hk, hv = cfg.ssm_n_group, cfg.ssm_dt_rank
    dk, dv = cfg.ssm_d_state, cfg.ssm_d_inner // max(hv, 1)
    return hv, dk, dv, max(cfg.ssm_conv_kernel, 1), 2 * hk * dk + hv * dv


def init_deltanet_state(cfg, batch: int, num_layers: int,
                        device="cuda") -> list[dict]:
    """Zeroed per-layer recurrent state aligned with cfg.layer_kinds (a
    [B, 1, 1, 1] / [B, 1, 1] placeholder on other layers)."""
    hv, dk, dv, ksz, ch = state_dims(cfg)
    kinds = cfg.layer_kinds or ("attn",) * num_layers
    states = []
    for kind in kinds:
        s_shape, c_shape = (((batch, hv, dk, dv), (batch, ksz - 1, ch))
                            if kind == "deltanet"
                            else ((batch, 1, 1, 1), (batch, 1, 1)))
        states.append({
            "S": torch.zeros(s_shape, dtype=torch.float32, device=device),
            "conv": torch.zeros(c_shape, dtype=torch.float32, device=device)})
    return states


# kind -> (loader, forward), as models/mamba.LAYERS
LAYERS = {"deltanet": (load_deltanet_layer, deltanet_layer)}
