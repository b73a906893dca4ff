"""The Mamba family's mixers (port of llama_gguf_tpu/models/mamba.py):
Mamba-1 (with Jamba's dt/B/C norms and FFN or MoE half), the Mamba-2
mixer (with Falcon-H1's group-wise, norm-before-gate variant) and its
block (with Granite's residual scale), and LFM2's short convolution.

Every matmul runs batched over [B, T] outside the recurrence, through
ops/linear.apply (the quantized kernels in quant mode); the causal
depthwise conv runs over the whole window with the state in front. The
selective scan is no Pallas kernel in the JAX package (a ``lax.scan`` that
XLA compiles), so here it is plain torch ops, one token at a time, in the
JAX order of operations. The JAX package materialises the scan's decay and
drive for every token before the scan ([B, T, nh, hd, ds]: 2 MiB a token
at Granite-4.0-H-Micro's width); here each token's are made inside the
loop, the same values.

The state lives in ``kv["mamba"]`` as {"conv": L x [B, K-1, C], "ssm": L x
[B, ...]} f32, the JAX package's shapes (placeholders on other layers), and
is updated in place: a layer copies its new state into the cache's own
tensors, so a CUDA graph captured on the cache (engine/runner.py) carries
it from one replay to the next. Padding tokens (positions >= lengths)
leave it bit-unchanged: decay 1 and drive 0 in the scan, zero input to the
conv, and the new conv window gathered at each row's valid count, written
only by a row with a valid token. The conv is one kernel on CUDA
(ops/shortconv.py). The short conv alone also runs a few rows of a larger
cache by the runner's row map (its state is the conv window only).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops import linear as L
from ..ops import shortconv as SC
from ..ops.norms import apply_norm, rms_norm

def init_mamba_state(cfg, batch: int, num_layers: int,
                     device="cuda") -> dict[str, list[torch.Tensor]]:
    """Zeroed per-layer conv and ssm buffers by cfg.layer_kinds, in the
    JAX package's shapes: short-conv layers a (L_cache-1)-tap window over
    the hidden width and no ssm; Mamba-2 and parallel-hybrid layers a conv
    over [x|B|C] and an ssm [B, heads, head_dim, d_state]; Mamba-1 (and
    any other layer, as a placeholder) [B, K-1, d_inner] and [B, d_inner,
    d_state]."""
    ks = cfg.ssm_conv_kernel
    di, ds = cfg.ssm_d_inner, cfg.ssm_d_state
    kinds = cfg.layer_kinds or ("mamba",) * num_layers

    def shapes(kind):
        if kind == "shortconv":
            return (batch, cfg.shortconv_l_cache - 1, cfg.hidden_size), \
                (batch, 0, 0)
        if kind in ("mamba2", "hybrid_par"):
            ng, nh = max(cfg.ssm_n_group, 1), max(cfg.ssm_dt_rank, 1)
            return (batch, ks - 1, di + 2 * ng * ds), (batch, nh, di // nh, ds)
        return (batch, max(ks - 1, 0), di), (batch, di, ds)

    state: dict[str, list[torch.Tensor]] = {"conv": [], "ssm": []}
    for i in range(num_layers):
        for key, shape in zip(("conv", "ssm"), shapes(kinds[i])):
            state[key].append(torch.zeros(shape, dtype=torch.float32,
                                          device=device))
    return state


def causal_conv(inp: torch.Tensor, kv: dict, layer_idx: int,
                w: torch.Tensor, bias: torch.Tensor | None,
                valid: torch.Tensor, rows: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Causal depthwise conv of ``inp`` [B, T, C] (padding rows already
    zero) with the layer's conv window in front: out[t] = sum_k w[k] *
    seq[t + k], w [K, C]. The new window, the last K-1 valid inputs, is
    written into the cache in place by the rows with a valid token.
    ``rows``: the runner's row map (input row i is cache row rows[i]), or
    None. One kernel on CUDA, its plain version on the CPU
    (ops/shortconv.causal_conv)."""
    return SC.causal_conv(inp, kv["mamba"]["conv"][layer_idx], w, bias,
                          valid.sum(dim=1, dtype=torch.int32), rows)


def selective_scan(dt: torch.Tensor, xs: torch.Tensor, b_t: torch.Tensor,
                   c_t: torch.Tensor, a: torch.Tensor, valid: torch.Tensor,
                   state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1's scan: s = exp(dt a) s + (dt x) B, y = s C, per channel.
    dt, xs [B, T, di]; b_t, c_t [B, T, ds]; a [di, ds] (negative); valid
    [B, T]; state [B, di, ds], not written. Returns (y [B, T, di], the new
    state). Padding tokens get decay 1 and drive 0."""
    vf = valid.float()[..., None, None]  # [B, T, 1, 1]
    dtx = dt * xs
    s, ys = state, []
    for t in range(dt.shape[1]):
        v = vf[:, t]
        decay = torch.exp(dt[:, t, :, None] * a) * v + (1.0 - v)
        drive = dtx[:, t, :, None] * b_t[:, t, None, :] * v
        s = decay * s + drive
        ys.append(torch.matmul(s, c_t[:, t, :, None])[..., 0])
    return torch.stack(ys, dim=1), s


def ssd_scan(decay: torch.Tensor, dtx: torch.Tensor, b_h: torch.Tensor,
             c_h: torch.Tensor, state: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2's scan, a scalar decay per head: s = decay s + (dt x) B,
    y = s C. decay [B, T, nh] (1 on padding); dtx [B, T, nh, hd] (0 on
    padding); b_h, c_h [B, T, nh, ds]; state [B, nh, hd, ds], not
    written. Returns (y [B, T, nh, hd], the new state)."""
    s, ys = state, []
    for t in range(decay.shape[1]):
        s = (decay[:, t, :, None, None] * s
             + dtx[:, t, :, :, None] * b_h[:, t, :, None, :])
        ys.append(torch.matmul(s, c_h[:, t, :, :, None])[..., 0])
    return torch.stack(ys, dim=1), s


def _ffn_half(layer: dict, cfg, x: torch.Tensor, precision,
              scale: float = 1.0) -> torch.Tensor:
    """x + the block's FFN (or MoE) half off its ffn_norm, scaled."""
    from .transformer import ffn_forward

    h2 = apply_norm(x, layer["ffn_norm"], cfg.norm_eps, cfg.uses_layer_norm)
    out = ffn_forward(layer["ffn"], cfg, h2, precision)
    return x + (out * scale if scale != 1.0 else out)


def mamba_layer(layer: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                kv: dict, layer_idx: int, lengths: torch.Tensor,
                precision: str | None = None) -> tuple[torch.Tensor, dict]:
    """A Mamba-1 block: x [B, T, H] -> ([B, T, H], kv), T tokens causally;
    then Jamba's FFN or MoE half when the block has one. The layer's state
    in ``kv`` is updated in place."""
    di, ds, dtr = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_dt_rank
    valid = positions < lengths[:, None]
    vf = valid.float()[..., None]

    h = rms_norm(x, layer["attn_norm"]["weight"], cfg.norm_eps)
    proj = L.apply(layer["ssm_in"], h, precision).float()  # [B, T, 2 di]
    x_ssm, z = proj[..., :di] * vf, proj[..., di:]
    xs = torch.nn.functional.silu(causal_conv(
        x_ssm, kv, layer_idx, layer["conv_w"], layer.get("conv_b"), valid))

    x_db = L.apply(layer["ssm_x"], xs.to(x.dtype), precision).float()
    dt_raw = x_db[..., :dtr]
    b_t = x_db[..., dtr:dtr + ds]
    c_t = x_db[..., dtr + ds:dtr + 2 * ds]
    if "dt_norm" in layer:  # Jamba: RMSNorms on dt, B and C
        dt_raw = rms_norm(dt_raw, layer["dt_norm"], cfg.norm_eps)
        b_t = rms_norm(b_t, layer["b_norm"], cfg.norm_eps)
        c_t = rms_norm(c_t, layer["c_norm"], cfg.norm_eps)
    dt = L.apply(layer["ssm_dt"], dt_raw.to(x.dtype), precision).float()
    dt = torch.nn.functional.softplus(dt + layer["dt_bias"].float())

    st = kv["mamba"]["ssm"][layer_idx]
    y, s = selective_scan(dt, xs, b_t, c_t, layer["ssm_a"].float(), valid,
                          st)
    st.copy_(s)
    if layer.get("ssm_d") is not None:
        y = y + layer["ssm_d"].float() * xs
    y = y * torch.nn.functional.silu(z)
    x = x + L.apply(layer["ssm_out"], y.to(x.dtype), precision)
    if "ffn" in layer:
        x = _ffn_half(layer, cfg, x, precision)
    return x, kv


def mamba2_mixer(layer: dict, cfg, h: torch.Tensor, positions: torch.Tensor,
                 kv: dict, layer_idx: int, lengths: torch.Tensor,
                 precision: str | None = None) -> tuple[torch.Tensor, dict]:
    """The Mamba-2 mixer on a normed input h [B, T, H]: in_proj -> [z |
    xBC | dt], causal conv over [x|B|C], a scalar decay per head, grouped
    B/C over heads, y = s C + D x, the gated RMSNorm (full width, or per
    group before the gate for Falcon-H1; none when the layer has no
    ssm_norm), out_proj. Returns (out [B, T, H], kv)."""
    b, t, _ = h.shape
    di, ds = cfg.ssm_d_inner, cfg.ssm_d_state
    nh = cfg.ssm_dt_rank  # time_step_rank is the head count for Mamba-2
    ng = max(cfg.ssm_n_group, 1)
    hd = di // nh
    conv_dim = di + 2 * ng * ds
    valid = positions < lengths[:, None]
    vf = valid.float()[..., None]

    proj = L.apply(layer["ssm_in"], h, precision).float()
    z = proj[..., :di]
    xbc = proj[..., di:di + conv_dim] * vf
    dt_raw = proj[..., di + conv_dim:]  # [B, T, nh]
    xbc = torch.nn.functional.silu(causal_conv(
        xbc, kv, layer_idx, layer["conv_w"], layer.get("conv_b"), valid))

    xs = xbc[..., :di].reshape(b, t, nh, hd)
    rep = nh // ng
    b_h = xbc[..., di:di + ng * ds].reshape(b, t, ng, ds) \
        .repeat_interleave(rep, dim=2)
    c_h = xbc[..., di + ng * ds:].reshape(b, t, ng, ds) \
        .repeat_interleave(rep, dim=2)

    dt = torch.nn.functional.softplus(dt_raw + layer["dt_bias"].float())
    a = layer["ssm_a"].float().reshape(-1)  # [nh], -exp(A_log)
    decay = torch.where(valid[..., None], torch.exp(dt * a),
                        torch.ones_like(dt))
    dtx = dt[..., None] * xs * valid[:, :, None, None]

    st = kv["mamba"]["ssm"][layer_idx]
    y, s = ssd_scan(decay, dtx, b_h, c_h, st)
    st.copy_(s)
    if layer.get("ssm_d") is not None:
        y = y + layer["ssm_d"].float().reshape(-1)[:, None] * xs
    y = y.reshape(b, t, di)

    def gated_norm(v):
        groups = cfg.ssm_norm_groups
        if groups > 1:  # Falcon-H1: the variance per group of channels
            vr = v.reshape(b, t, groups, di // groups)
            vr = vr * torch.rsqrt(
                torch.mean(vr * vr, -1, keepdim=True) + cfg.norm_eps)
            return vr.reshape(b, t, di) * layer["ssm_norm"].float()
        return rms_norm(v, layer["ssm_norm"], cfg.norm_eps)

    gate = torch.nn.functional.silu(z)
    if "ssm_norm" not in layer:  # Falcon-H1 without mamba_rms_norm
        y = y * gate
    elif cfg.ssm_norm_before_gate:  # Falcon-H1's order
        y = gated_norm(y) * gate
    else:  # Mamba-2's MambaRMSNormGated: the gate first
        y = gated_norm(y * gate)
    return L.apply(layer["ssm_out"], y.to(h.dtype), precision), kv


def mamba2_layer(layer: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                 kv: dict, layer_idx: int, lengths: torch.Tensor,
                 precision: str | None = None) -> tuple[torch.Tensor, dict]:
    """A Mamba-2 block: pre-norm, the mixer, the residual, and the hybrid
    FFN half when there is one; cfg.residual_scale (Granite's
    residual_multiplier) scales both halves."""
    rs = cfg.residual_scale
    h = apply_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.uses_layer_norm)
    out, kv = mamba2_mixer(layer, cfg, h, positions, kv, layer_idx, lengths,
                           precision)
    x = x + (out * rs if rs != 1.0 else out)
    if "ffn" in layer:
        x = _ffn_half(layer, cfg, x, precision, rs)
    return x, kv


def shortconv_layer(layer: dict, cfg, x: torch.Tensor,
                    positions: torch.Tensor, kv: dict, layer_idx: int,
                    lengths: torch.Tensor,
                    precision: str | None = None,
                    rows: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict]:
    """An LFM2 short-convolution block: in_proj -> [B | C | x], Bx = B x,
    causal depthwise conv over L_cache taps, y = C conv(Bx), out_proj; then
    the SwiGLU FFN half (or MoE, LFM2-MoE). The state is the (L_cache-1)-tap
    Bx window, of cache row rows[i] for input row i under the runner's row
    map (``rows``), else of row i."""
    d = x.shape[-1]
    valid = positions < lengths[:, None]
    vf = valid.float()[..., None]

    h = apply_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.uses_layer_norm)
    proj = L.apply(layer["conv_in"], h, precision).float()  # [B, T, 3H]
    b_g, c_g, x_g = proj[..., :d], proj[..., d:2 * d], proj[..., 2 * d:]
    conv = causal_conv(b_g * x_g * vf, kv, layer_idx, layer["conv_w"],
                       layer.get("conv_b"), valid, rows)
    x = x + L.apply(layer["conv_out"], (c_g * conv).to(x.dtype), precision)
    return _ffn_half(layer, cfg, x, precision), kv


# -- loaders -----------------------------------------------------------------


def _conv_fields(loader, layer: dict, stem: str) -> None:
    """A conv weight (GGUF np shape [C, K]) as [K, C], and its bias."""
    layer["conv_w"] = loader._put(np.ascontiguousarray(
        loader.dense(f"{stem}.weight").T))
    if loader.has(f"{stem}.bias"):
        layer["conv_b"] = loader._put(loader.dense(f"{stem}.bias"))


def _ssm_fields(loader, layer: dict, p: str) -> None:
    """ssm_a (stored as -exp(A_log) already), the dt bias and ssm_d."""
    layer["ssm_a"] = loader._put(loader.dense(f"{p}.ssm_a"))
    layer["dt_bias"] = loader._put(loader.dense(f"{p}.ssm_dt.bias"))
    if loader.has(f"{p}.ssm_d"):
        layer["ssm_d"] = loader._put(loader.dense(f"{p}.ssm_d"))


def _ffn_fields(loader, layer: dict, i: int, cfg) -> None:
    if loader.has(f"blk.{i}.ffn_norm.weight"):  # the hybrid FFN half
        layer["ffn_norm"] = loader.norm(f"blk.{i}.ffn_norm")
        layer["ffn"] = loader._load_ffn(i, cfg)


def load_mamba_layer(loader, i: int, cfg) -> dict:
    """A Mamba-1 block (blk.N.ssm_{in,conv1d,x,dt,a,d,out}, Jamba's
    ssm_{dt,b,c}_norm and FFN half)."""
    p = f"blk.{i}"
    layer: dict[str, Any] = {
        "attn_norm": loader.norm(f"{p}.attn_norm"),
        "ssm_in": loader.linear(f"{p}.ssm_in"),
        "ssm_x": loader.linear(f"{p}.ssm_x"),
        "ssm_dt": loader.linear(f"{p}.ssm_dt", bias_name="__none__"),
        "ssm_out": loader.linear(f"{p}.ssm_out"),
    }
    _conv_fields(loader, layer, f"{p}.ssm_conv1d")
    _ssm_fields(loader, layer, p)
    for tag in ("dt", "b", "c"):
        name = f"{p}.ssm_{tag}_norm.weight"
        if loader.has(name):
            layer[f"{tag}_norm"] = loader._put(loader.dense(name))
    _ffn_fields(loader, layer, i, cfg)
    return layer


def load_mamba2_fields(loader, i: int, cfg) -> dict:
    """The Mamba-2 mixer's tensors: the combined [z|xBC|dt] ssm_in (dt has
    no projection of its own, only ssm_dt.bias), per-head ssm_a and ssm_d,
    and the optional gated ssm_norm (stored [groups, d_inner/groups],
    flattened here). Shared by Mamba-2 blocks and Falcon-H1's parallel
    hybrid."""
    p = f"blk.{i}"
    layer: dict[str, Any] = {"ssm_in": loader.linear(f"{p}.ssm_in"),
                             "ssm_out": loader.linear(f"{p}.ssm_out")}
    _conv_fields(loader, layer, f"{p}.ssm_conv1d")
    _ssm_fields(loader, layer, p)
    if loader.has(f"{p}.ssm_norm.weight"):
        layer["ssm_norm"] = loader._put(
            loader.dense(f"{p}.ssm_norm.weight").reshape(-1))
    return layer


def load_mamba2_layer(loader, i: int, cfg) -> dict:
    """A Mamba-2 block: pre-norm, the mixer, an optional FFN half."""
    layer = {"attn_norm": loader.norm(f"blk.{i}.attn_norm")}
    layer.update(load_mamba2_fields(loader, i, cfg))
    _ffn_fields(loader, layer, i, cfg)
    return layer


def load_shortconv_layer(loader, i: int, cfg) -> dict:
    """An LFM2 conv block: blk.N.shortconv.{in_proj,out_proj,conv} and its
    FFN half."""
    p = f"blk.{i}"
    layer: dict[str, Any] = {
        "attn_norm": loader.norm(f"{p}.attn_norm"),
        "conv_in": loader.linear(f"{p}.shortconv.in_proj"),
        "conv_out": loader.linear(f"{p}.shortconv.out_proj"),
        "ffn_norm": loader.norm(f"{p}.ffn_norm"),
        "ffn": loader._load_ffn(i, cfg),
    }
    _conv_fields(loader, layer, f"{p}.shortconv.conv")
    return layer


# kind -> (loader, forward) of the Mamba-family blocks; models/loader.py and
# models/transformer.py dispatch through it (with models/deltanet.LAYERS)
LAYERS = {"mamba": (load_mamba_layer, mamba_layer),
          "mamba2": (load_mamba2_layer, mamba2_layer),
          "shortconv": (load_shortconv_layer, shortconv_layer)}
# the kinds whose state lives in kv["mamba"]: those blocks and Falcon-H1's
# parallel hybrid, which loads and runs the Mamba-2 mixer beside attention
KINDS = (*LAYERS, "hybrid_par")
