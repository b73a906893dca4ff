"""Decoder-only transformer forward, dense and sparse-MoE paths (port of
llama_gguf_tpu/models/transformer.py).

    forward(params, cfg, tokens[B,T], positions[B,T], kv, lengths) ->
        (logits[B,T,V], kv)

T=1 is the decode step; larger T is (bucketed) prefill. The KV cache is
updated in place. ``precision`` ("highest"/None or "default") reaches every
quantized product: in "default" the kernels emit bfloat16, which is cast back
to float32 exactly where the JAX package casts it (ops/linear.apply, the GLU
input of the down projection, the MoE gate/up/act/down outputs). The port's
own torch matmuls (attention, the router, dense weights) stay float32 in
either mode. Covered: GQA, fused QKV, QK-RMSNorm, Normal/NeoX/partial
RoPE, softcap, sliding window, sinks, ALiBi, gated FFN through the fused GLU
kernel, the no-gate FFN with Apertus's per-layer xIELU, Mixtral-style MoE
(softmax-before-top-k routing) through the MoE kernels with an optional
shared expert behind its sigmoid gate (Qwen3Next), Qwen3Next's DeltaNet
layers (models/deltanet.py), the Mamba family (models/mamba.py: Mamba-1,
Mamba-2, LFM2's short conv, and Falcon-H1's parallel hybrid here),
DeepSeek's multi-head latent attention (absorbed, over a one-head latent
cache) and DeepSeek-V3's sigmoid routing with its bias and group limit
(route_choice), PhiMoE's sparsemixer, llama4's input-scaled experts and
gpt-oss's per-expert biases (moe_layer), parallel residual, post norms, tied
embeddings, and the two-tier ragged read bound on one device, over every
KV-cache format of models/kv.py (the qjl format through
ops/attention.qjl_attention) and the sliding-window ring, and the tier
grouped per data shard. Under a mesh (parallel/sharding.py) an attention
block runs its rank's heads (``layer["heads"]``), a row-parallel product sums
over the model axis inside ops/linear.apply, and an expert-parallel MoE
layer runs its rank's experts and sums once over the model axis.

Nothing here reads a device value on the host, so engine/runner.py can
capture a whole step in a CUDA graph.
"""

from __future__ import annotations

import torch

from ..ops import linear as L
from ..ops.attention import attention_scores, qjl_attention, tiered_attention
from ..ops.norms import apply_norm, rms_norm
from ..ops.qmatmul import (expert_matmul, glu_combine, moe_dims,
                           moe_group_plan, moe_qmatmul, moe_qmatmul_glu,
                           qmatmul_glu)
from ..ops.rope import apply_rope, rope_cos_sin
from ..utils.debug import trace_activation
from . import deltanet, mamba
from . import kv as KV
from .config import Activation, ModelConfig
from .mamba import mamba2_mixer


def _act(x: torch.Tensor, act: Activation) -> torch.Tensor:
    if act == Activation.GELU:  # tanh approximation (ggml_gelu)
        return torch.nn.functional.gelu(x, approximate="tanh")
    if act == Activation.RELU:
        return torch.relu(x)
    if act == Activation.RELU2:
        return torch.square(torch.relu(x))
    if act == Activation.XIELU:  # its constants live in ffn["xielu"]
        raise ValueError("xIELU needs the per-layer constants the loader "
                         "puts in ffn['xielu']")
    return torch.nn.functional.silu(x)


def _glu(g: torch.Tensor, u: torch.Tensor, act: Activation) -> torch.Tensor:
    """Combine gate/up projections into the gated activation (f32)."""
    if act == Activation.SWIGLU_OAI:
        return glu_combine(g, u, "swiglu_oai")
    return _act(g, act) * u


def mla_attention(layer: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, kv: dict, layer_idx: int,
                  lengths: torch.Tensor, read_bound=None,
                  precision: str | None = None,
                  rows: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """Multi-head latent attention (DeepSeek-V2/V3) in the JAX package's
    absorbed form: queries move into the latent's rank space,

        q_eff = [q_nope @ W_uk | rope(q_rope)]         (rank + rope dims)
        k_eff = [c_kv          | rope(k_rope)]         (cached, one head)
        ctx   = softmax(q_eff . k_eff * scale) @ c_kv  (rank dims)
        out   = (ctx @ W_uv^T) @ W_o

    so the cache holds one latent a token (K = k_eff, V = c_kv) and
    attention runs as MQA over it. The scale is head_dim (nope + rope)
    ** -0.5, not the latent's width. The projections go through
    ``L.apply`` (the kernels when quantized); the up-projections W_uk
    [nh, nope, rank] and W_uv [nh, v, rank] are dense f32."""
    b, t, _ = x.shape
    nh, rope_dim, rank = cfg.num_heads, cfg.rope.n_dims, cfg.kv_lora_rank
    nope = cfg.head_dim - rope_dim

    if "q_a" in layer:  # low-rank q (V3, V2); V2-Lite and Moonlight: wq
        qa = L.apply(layer["q_a"], x, precision).float()
        q = L.apply(layer["q_b"], rms_norm(qa, layer["q_a_norm"],
                                           cfg.norm_eps).to(x.dtype),
                    precision)
    else:
        q = L.apply(layer["wq"], x, precision)
    q = q.reshape(b, t, nh, nope + rope_dim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = L.apply(layer["kv_a"], x, precision).float()  # [B,T,rank+rope]
    c_kv = rms_norm(kv_a[..., :rank], layer["kv_a_norm"], cfg.norm_eps)
    k_rope = kv_a[..., None, rank:]  # [B, T, 1, rope], shared by the heads

    cos, sin = rope_cos_sin(positions, cfg.rope)
    q_rope = apply_rope(q_rope, cos, sin, cfg.rope)
    k_rope = apply_rope(k_rope, cos, sin, cfg.rope)

    q_rank = torch.einsum("bthn,hnr->bthr", q_nope.float(),
                          layer["w_uk"].float())
    q_eff = torch.cat([q_rank, q_rope.float()], dim=-1)
    k_eff = torch.cat([c_kv[:, :, None, :], k_rope.float()], dim=-1)
    KV.write(kv, layer_idx, k_eff, c_kv[:, :, None, :], positions, rows)

    qg = q_eff.reshape(b, t, 1, nh, rank + rope_dim)  # one KV head, R = nh
    akw = dict(scale=cfg.attention_scale or cfg.head_dim ** -0.5,
               softcap=cfg.attn_logit_softcap)

    def read_fn(bound, rows):
        return KV.read(kv, layer_idx, head_dim=rank + rope_dim,
                       v_head_dim=rank, bound=bound, rows=rows)

    if isinstance(read_bound, tuple):  # two-tier ragged decode
        lo, hi, tier_idx = read_bound
        ctx = tiered_attention(read_fn, qg, positions, lengths, lo, hi,
                               tier_idx, **akw)
    else:
        keys, vals = read_fn(read_bound, rows)
        ctx = attention_scores(qg, keys, vals, positions, lengths, **akw)
    out_v = torch.einsum("bthr,hvr->bthv", ctx[:, :, 0],
                         layer["w_uv"].float())  # [B, T, nh, v]
    vd = cfg.value_length or cfg.head_dim
    return L.apply(layer["wo"], out_v.reshape(b, t, nh * vd).to(x.dtype),
                   precision), kv


def attention(layer: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, kv: dict, layer_idx: int,
              lengths: torch.Tensor, read_bound: int | None = None,
              precision: str | None = None,
              rows: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Attention with KV cache. x [B, T, H]; positions [B, T]; lengths [B]
    (valid cache length AFTER this step's tokens are written);
    ``read_bound``: cap on cache positions to read (every valid position <
    read_bound), or ``(lo, hi, tier_idx)`` for two-tier ragged decode
    (``forward`` selects ``tier_idx``); ``rows``: ``forward``'s row map."""
    if "kv_a" in layer:  # MLA (DeepSeek-V2/V3)
        return mla_attention(layer, cfg, x, positions, kv, layer_idx,
                             lengths, read_bound, precision, rows)
    b, t, _ = x.shape
    hd = cfg.head_dim
    vd = cfg.value_length or hd
    # a rank's share of the heads under a mesh (parallel/sharding.py):
    # (local heads, local KV heads, first global head, all heads)
    heads = layer.get("heads")
    nh, nkv = heads[:2] if heads else (cfg.num_heads, cfg.num_kv_heads)

    if "wqkv" in layer:  # fused projection (loader._fuse_attn)
        nq, nk, _ = layer["wqkv"].splits
        qkv = L.apply(layer["wqkv"], x, precision)
        q = qkv[..., :nq]
        k = qkv[..., nq: nq + nk]
        v = qkv[..., nq + nk:]
    else:
        q = L.apply(layer["wq"], x, precision)
        k = L.apply(layer["wk"], x, precision)
        v = L.apply(layer["wv"], x, precision)

    if cfg.clamp_kqv > 0:
        c = cfg.clamp_kqv
        q, k, v = q.clamp(-c, c), k.clamp(-c, c), v.clamp(-c, c)

    if "q_norm" in layer and layer["q_norm"].shape[-1] == cfg.num_heads * hd:
        # olmo2: QK RMSNorm over the flat projection (all heads at once)
        q = rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.norm_eps)
    q = q.reshape(b, t, nh, hd)
    k = k.reshape(b, t, nkv, hd)
    v = v.reshape(b, t, nkv, vd)

    per_head_qk = "q_norm" in layer and layer["q_norm"].shape[-1] == hd
    if per_head_qk and not cfg.qk_norm_post_rope:
        q = rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.norm_eps)

    window = cfg.sliding_window if cfg.layer_is_swa(layer_idx) else 0
    if window and cfg.swa_chunked:
        window = -window  # chunked-attention encoding (ops/attention)
    rope_cfg = cfg.layer_rope(layer_idx)  # None = NoPE layer
    if rope_cfg is not None:
        cos, sin = rope_cos_sin(positions, rope_cfg)  # [B, T, nd/2]
        q = apply_rope(q, cos, sin, rope_cfg)
        k = apply_rope(k, cos, sin, rope_cfg)
        if cfg.use_qk_l2norm:  # llama4: weightless L2 norm after rope
            def l2n(a):
                af = a.float()
                return (af * torch.rsqrt(
                    torch.mean(af * af, -1, keepdim=True) + 1e-6)).to(a.dtype)

            q, k = l2n(q), l2n(k)
    if per_head_qk and cfg.qk_norm_post_rope:
        q = rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.norm_eps)
    if cfg.attn_temp_scale > 0.0 and rope_cfg is None:
        pf = positions.float() + 1.0
        tsc = (torch.log1p(torch.floor(pf / cfg.attn_temp_floor))
               * cfg.attn_temp_scale + 1.0)
        q = (q.float() * tsc[:, :, None, None]).to(q.dtype)

    # SWA ring cache: sliding layers keep ~window positions in a ring (read
    # whole, masked by stored position), full layers the plain stack; with
    # no ring every layer indexes the plain stack directly
    ring = "k_swa" in kv and cfg.layer_is_swa(layer_idx)
    if rows is not None and (ring or cfg.kv_format == "qjl"):
        raise ValueError("a row map needs the plain or MLA cache, not the "
                         "SWA ring or qjl")
    cache_idx = (cfg.swa_index(layer_idx) if ring
                 else cfg.full_index(layer_idx) if "k_swa" in kv
                 else layer_idx)
    if ring:
        KV.write_swa(kv, cache_idx, k, v, positions, window)
    else:
        KV.write(kv, cache_idx, k, v, positions, rows)

    rep = nh // nkv
    qg = q.reshape(b, t, nkv, rep, hd).float()
    sinks = None
    if "sinks" in layer:  # attention sinks (gpt-oss): extra logit per head
        sinks = layer["sinks"].reshape(nkv, rep).float()
    scale = cfg.attention_scale or hd ** -0.5
    if ring:
        keys, vals, key_pos = KV.read_swa(kv, cache_idx)
        ctx = attention_scores(qg, keys, vals, positions, lengths,
                               scale=scale, softcap=cfg.attn_logit_softcap,
                               sliding_window=window, key_positions=key_pos,
                               sinks=sinks)
    elif cfg.kv_format == "qjl":  # attention on the compressed keys
        if sinks is not None:
            raise ValueError(
                "kv_format=qjl cannot represent attention sinks "
                "(scores are sign-sketch estimates); use another format")
        if cfg.uses_alibi:
            raise ValueError(
                "kv_format=qjl does not support ALiBi position biases "
                "(bloom/mpt); use another kv format")
        if isinstance(read_bound, tuple):  # qjl scores are cheap: read hi
            read_bound = read_bound[1]
        s_cap = kv["k"][cache_idx].shape[1] - 1
        rb = s_cap if read_bound is None else min(read_bound, s_cap)
        ctx = qjl_attention(
            qg, kv["k"][cache_idx][:, :rb], kv["k_scale"][cache_idx][:, :rb],
            kv["v"][cache_idx][:, :rb], kv["v_scale"][cache_idx][:, :rb],
            positions, lengths, scale=scale, v_head_dim=vd,
            softcap=cfg.attn_logit_softcap, sliding_window=window)
    else:
        alibi = (heads[3], heads[2]) if heads and cfg.uses_alibi \
            else cfg.uses_alibi
        akw = dict(scale=scale, softcap=cfg.attn_logit_softcap,
                   sliding_window=window, sinks=sinks, alibi=alibi)

        def read_fn(bound, rows):
            return KV.read(kv, cache_idx, head_dim=hd, v_head_dim=vd,
                           bound=bound, rows=rows)

        if isinstance(read_bound, tuple):  # two-tier ragged decode
            lo, hi, tier_idx = read_bound
            ctx = tiered_attention(read_fn, qg, positions, lengths, lo, hi,
                                   tier_idx, **akw)
        else:
            keys, vals = read_fn(read_bound, rows)
            ctx = attention_scores(qg, keys, vals, positions, lengths,
                                   **akw)
    ctx = ctx.reshape(b, t, nh * vd).to(x.dtype)

    if "sub_norm" in layer:  # BitNet: RMSNorm on attn output before o_proj
        ctx = rms_norm(ctx, layer["sub_norm"], cfg.norm_eps).to(x.dtype)
    if "gate" in layer:  # Qwen3Next sigmoid attention gate
        g = L.apply(layer["gate"], x, precision)
        ctx = ctx * torch.sigmoid(g.float()).to(ctx.dtype)
    return L.apply(layer["wo"], ctx, precision), kv


def feed_forward(ffn: dict, cfg: ModelConfig, x: torch.Tensor,
                 precision: str | None = None) -> torch.Tensor:
    def down(act):
        if "sub_norm" in ffn:  # BitNet: RMSNorm before down_proj
            act = rms_norm(act, ffn["sub_norm"], cfg.norm_eps)
        return L.apply(ffn["down"], act.to(x.dtype), precision)

    if "gate_up" in ffn:  # fused projection (loader._fuse_ffn)
        gu_lin = ffn["gate_up"]
        if isinstance(gu_lin, L.QuantLinear):
            # GLU epilogue inside the fused kernel: the [B*T, 2F]
            # intermediate never reaches device memory
            lead = x.shape[:-1]
            y = qmatmul_glu(x.reshape(-1, x.shape[-1]).float(), gu_lin,
                            cfg.hidden_act.value, precision)
            if y is not None:
                return down(y.reshape(*lead, -1))
        gu = L.apply(gu_lin, x, precision).float()
        half = gu_lin.splits[0]
        return down(_glu(gu[..., :half], gu[..., half:], cfg.hidden_act))
    if "gate" in ffn:
        g = L.apply(ffn["gate"], x, precision).float()
        u = L.apply(ffn["up"], x, precision).float()
        return down(_glu(g, u, cfg.hidden_act))
    u = L.apply(ffn["up"], x, precision).float()
    if "xielu" in ffn:  # Apertus per-layer xIELU constants
        ap, an, beta, eps = ffn["xielu"]
        return down(torch.where(
            u > 0, ap * u * u + beta * u,
            (torch.expm1(torch.clamp(u, max=eps)) - u) * an + beta * u))
    return down(_act(u, cfg.hidden_act))


def route_choice(ffn: dict, cfg: ModelConfig, xf: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The router's (scores, choice) for tokens xf [N, H], each [N, E] f32:
    the top-k of ``choice`` picks the experts, and ``scores`` at those
    experts are their weights before ``route`` finishes them. Softmax
    routing (gating 1): both are the softmax of the router logits.
    DeepSeek-V3 (gating 2): the scores are the logits' sigmoid, and the
    choice adds the learned per-expert bias (``router_bias``, exp_probs_b)
    and, with expert_group_used_count of expert_group_count groups, sets
    every expert outside the best groups (a group scored by the sum of its
    top-2 choices) to -inf. PhiMoE's sparsemixer (gating 3) and the
    top-k-then-softmax branch (``router_softmax_before_topk`` False): both
    are the logits."""
    logits = L.apply(ffn["router"], xf).float()
    if cfg.expert_gating_func == 3 or (
            cfg.expert_gating_func != 2
            and not ffn.get("router_softmax_before_topk", True)):
        return logits, logits
    if cfg.expert_gating_func != 2:
        probs = torch.softmax(logits, dim=-1)
        return probs, probs
    scores = torch.sigmoid(logits)
    choice = scores
    if "router_bias" in ffn:
        choice = choice + ffn["router_bias"].float()
    ng, tg = cfg.expert_group_count, cfg.expert_group_used_count
    if ng > 1 and tg > 0:
        n, e = choice.shape
        grp = choice.reshape(n, ng, e // ng)
        gscore = torch.topk(grp, 2, dim=-1).values.sum(-1)  # [N, ng]
        keep = torch.zeros_like(gscore, dtype=torch.bool).scatter_(
            1, torch.topk(gscore, tg, dim=-1).indices, True)
        choice = torch.where(keep[:, :, None], grp,
                             torch.full_like(grp, -torch.inf)).reshape(n, e)
    return scores, choice


def sparsemixer(logits: torch.Tensor, jitter_eps: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """PhiMoE's sparsemixer at inference (HF PhimoeSparseMoeBlock, the JAX
    package's gating 3), top-2 of logits [N, E] -> (weights [N, 2], ids
    [N, 2]). Each pick is a raw argmax (the first maximum); its weight is
    its softmax probability over the scores, where a score whose gap to the
    max, relative to max(|score|, max), exceeds 2 * jitter_eps is masked
    out. The second pick first masks the winner of the first."""
    eps2 = 2.0 * jitter_eps

    def pick(sel):
        m = sel.max(dim=-1, keepdim=True).values
        factor = torch.maximum(logits.abs(), m)
        masked = torch.where((m - sel) / factor > eps2,
                             torch.full_like(sel, -torch.inf), sel)
        e = torch.argmax(sel, dim=-1)
        return e, torch.softmax(masked, dim=-1).gather(1, e[:, None])[:, 0]

    e1, w1 = pick(logits)
    e2, w2 = pick(logits.scatter(1, e1[:, None], -torch.inf))
    return torch.stack([w1, w2], dim=-1), torch.stack([e1, e2], dim=-1)


def route(ffn: dict, cfg: ModelConfig,
          xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of tokens xf [N, H] -> (weights [N, k] f32, expert ids
    [N, k]), every branch of the JAX package's moe_layer: PhiMoE's
    sparsemixer (gating 3, always top-2); the top-k of the logits, then
    their softmax (``router_softmax_before_topk`` False); else the top-k
    of ``route_choice``'s choice, the scores there, then the optional
    renormalisation (sum clamped at 1e-9 after a softmax, plus 1e-20 after
    a sigmoid, as the JAX package has them) and the routed scale."""
    scores, choice = route_choice(ffn, cfg, xf)
    if cfg.expert_gating_func == 3:
        return sparsemixer(scores, cfg.router_jitter_eps)
    topi = torch.topk(choice, cfg.num_experts_per_token, dim=-1).indices
    topv = torch.gather(scores, 1, topi)
    if cfg.expert_gating_func != 2 and \
            not ffn.get("router_softmax_before_topk", True):
        return torch.softmax(topv, dim=-1), topi
    if cfg.expert_weights_norm:
        total = topv.sum(-1, keepdim=True)
        topv = topv / (total + 1e-20 if cfg.expert_gating_func == 2
                       else total.clamp_min(1e-9))
    if cfg.expert_weights_scale != 1.0:  # DeepSeek routed scale
        topv = topv * cfg.expert_weights_scale
    return topv, topi


def _expert_mm(x_rows: torch.Tensor, stack, idx: torch.Tensor,
               precision: str | None, plan=None) -> torch.Tensor:
    """A quantized stack goes to the MoE kernels (``plan``: the layer's
    grouped dispatch plan, or None); a dense [E, K, N] stack (dequant mode,
    or experts the loader could not keep quantized) loops over its experts.
    Float32 either way (a "default" kernel output is cast back, as the JAX
    MoE layer does)."""
    if isinstance(stack, L.QuantExpertStack):
        return moe_qmatmul(x_rows, stack, idx, precision, plan=plan).float()
    return expert_matmul(x_rows, stack, idx)


def _expert_ffn(ex: dict, cfg: ModelConfig, xr: torch.Tensor,
                idx: torch.Tensor, precision: str | None) -> torch.Tensor:
    """The routed experts' FFN of slots xr [S, H] on experts idx [S] ->
    [S, H] f32, each slot's down bias added, before the routing weight.
    When gate and up are both quantized and carry no bias the grouped
    gate|up GLU kernel is tried first; else, or below its threshold, the
    two products, each expert's gate and up bias (gpt-oss) added per slot
    in f32, and the GLU; then the down product. Each product is dispatched
    on its own stack (``_expert_mm``). Where the slots are many enough for
    the grouped kernels (``moe_dims``), the dispatch plan is made once here
    and shared by the quantized products."""
    quant = {key: isinstance(ex[key], L.QuantExpertStack)
             for key in ("gate", "up", "down")}
    plan = None
    c_rows, g_blocks, grouped = moe_dims(idx.shape[0], ex["down"].shape[0])
    if grouped and any(quant.values()):
        plan = moe_group_plan(idx, ex["down"].shape[0], c_rows, g_blocks)
    act = None
    if quant["gate"] and quant["up"] and \
            "gate_bias" not in ex and "up_bias" not in ex:
        act = moe_qmatmul_glu(xr, ex["gate"], ex["up"], idx,
                              cfg.hidden_act.value, precision, plan=plan)
    if act is None:
        g = _expert_mm(xr, ex["gate"], idx, precision, plan)
        u = _expert_mm(xr, ex["up"], idx, precision, plan)
        if "gate_bias" in ex:  # gpt-oss per-expert biases
            g = g + ex["gate_bias"].float()[idx]
        if "up_bias" in ex:
            u = u + ex["up_bias"].float()[idx]
        act = _glu(g, u, cfg.hidden_act)
    dn = _expert_mm(act.float(), ex["down"], idx, precision, plan)
    if "down_bias" in ex:  # per expert, before the routing weight
        dn = dn + ex["down_bias"].float()[idx]
    return dn


def moe_layer(ffn: dict, cfg: ModelConfig, x: torch.Tensor,
              precision: str | None = None) -> torch.Tensor:
    """Mixture-of-experts FFN. Slots are token-major (slot s = token * k +
    j). llama4 (``moe_weight_before_ffn``) scales each slot's input row by
    its routing weight and sums the down outputs unweighted. The routed
    products are ``_expert_ffn``'s; then the routing-weighted sum and the
    optional shared expert behind its gate."""
    b, t, h = x.shape
    xf = x.reshape(b * t, h)
    topv, topi = route(ffn, cfg, xf)
    nt, k = topi.shape
    ex = ffn["experts"]
    idx = topi.reshape(-1).to(torch.int32)  # [N*k]
    xr = xf.float()[:, None, :].expand(nt, k, h)
    if cfg.moe_weight_before_ffn:  # llama4: the weight scales the input
        xr = xr * topv[:, :, None]
    xr = xr.reshape(-1, h)
    weights = topv.reshape(-1)
    if "expert_range" in ffn:
        # expert parallel (parallel/sharding.py): this rank runs only the
        # slots routed to its experts, renumbered from 0; the others are
        # dropped here, and the routed sum is completed over the model
        # axis. Their count reaches the host, so such a step runs eagerly
        e0, e1 = ffn["expert_range"]
        keep = torch.nonzero((idx >= e0) & (idx < e1))[:, 0]
        idx = (idx[keep] - e0).contiguous()
        xr, weights = xr[keep], weights[keep]
    if idx.shape[0]:
        dn = _expert_ffn(ex, cfg, xr, idx, precision)
    else:  # no slot routed to this rank's experts
        dn = xr.new_zeros((0, h))
    if "expert_range" in ffn:
        if not cfg.moe_weight_before_ffn:
            dn = dn * weights[:, None]
        y = torch.zeros((nt, h), dtype=dn.dtype, device=dn.device)
        y.index_add_(0, torch.div(keep, k, rounding_mode="floor"), dn)
    else:
        dn = dn.reshape(nt, k, h)
        y = (dn.sum(dim=1) if cfg.moe_weight_before_ffn
             else (dn * topv[:, :, None]).sum(dim=1))
    sh = None
    if "shared" in ffn:  # Qwen2Moe/Qwen3Next shared expert (+ its gate)
        sh = feed_forward(ffn["shared"], cfg, xf[None], precision)[0]
        if "shared_gate" in ffn:
            sh = sh * torch.sigmoid(
                L.apply(ffn["shared_gate"], xf, precision).float())
    if "reduce" in ffn:  # one sum over the model axis, after the combine
        if sh is not None and ffn.get("shared_split"):
            y, sh = y + sh.to(y.dtype), None
        y = ffn["reduce"].all_reduce(y)
    if sh is not None:
        y = y + sh.to(y.dtype)
    return y.reshape(b, t, h).to(x.dtype)


def ffn_forward(ffn: dict, cfg: ModelConfig, x: torch.Tensor,
                precision: str | None) -> torch.Tensor:
    """The FFN half of a block: MoE or dense."""
    return moe_layer(ffn, cfg, x, precision) if "router" in ffn else \
        feed_forward(ffn, cfg, x, precision)


def transformer_layer(layer: dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, kv: dict, layer_idx: int,
                      lengths: torch.Tensor,
                      read_bound: int | None = None,
                      precision: str | None = None,
                      rows: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, dict]:
    def norm(p, xx):
        return apply_norm(xx, p, cfg.norm_eps, cfg.uses_layer_norm)

    h = norm(layer["attn_norm"], x) if layer.get("attn_norm") else x
    attn_out, kv = attention(layer["attn"], cfg, h, positions, kv, layer_idx,
                             lengths, read_bound, precision, rows)
    if "post_attn_norm" in layer:  # Gemma2/3: norm applied to attn output
        attn_out = norm(layer["post_attn_norm"], attn_out)

    if cfg.use_parallel_residual:
        return x + attn_out + ffn_forward(layer["ffn"], cfg, h, precision), kv

    rs = cfg.residual_scale  # Granite residual_multiplier
    if rs != 1.0:
        attn_out = attn_out * rs
    x = x + attn_out
    h2 = norm(layer["ffn_norm"], x) if layer.get("ffn_norm") else x
    ffn_out = ffn_forward(layer["ffn"], cfg, h2, precision)
    if "post_ffn_norm" in layer:
        ffn_out = norm(layer["post_ffn_norm"], ffn_out)
    if rs != 1.0:
        ffn_out = ffn_out * rs
    return x + ffn_out, kv


def parallel_hybrid_layer(layer: dict, cfg: ModelConfig, x: torch.Tensor,
                          positions: torch.Tensor, kv: dict, layer_idx: int,
                          lengths: torch.Tensor, read_bound=None,
                          precision: str | None = None
                          ) -> tuple[torch.Tensor, dict]:
    """A Falcon-H1 block: attention and the Mamba-2 mixer side by side off
    one pre-norm, their outputs summed into the residual, then the FFN
    half (the checkpoint's multipliers are folded into its weights at
    conversion)."""
    h = apply_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.uses_layer_norm)
    attn_out, kv = attention(layer["attn"], cfg, h, positions, kv, layer_idx,
                             lengths, read_bound, precision)
    ssm_out, kv = mamba2_mixer(layer["mamba"], cfg, h, positions, kv,
                               layer_idx, lengths, precision)
    x = x + attn_out + ssm_out.to(x.dtype)
    h2 = apply_norm(x, layer["ffn_norm"], cfg.norm_eps, cfg.uses_layer_norm)
    return x + ffn_forward(layer["ffn"], cfg, h2, precision), kv


# kind -> (loader, forward) of the recurrent blocks, which take no read
# bound; models/loader.py loads through the same table
RECURRENT_LAYERS = {**deltanet.LAYERS, **mamba.LAYERS}
# the layer kinds a row map covers: attention over the plain or MLA cache,
# and the short conv, whose whole state is its conv window
ROW_MAPPED_KINDS = ("attn", "shortconv")


def layer_forward(layer: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, kv: dict, layer_idx: int,
                  lengths: torch.Tensor, read_bound=None,
                  precision: str | None = None,
                  rows: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """Layer ``layer_idx`` by its kind (cfg.layer_kinds): an attention
    block, a Falcon-H1 parallel hybrid, or a recurrent block (DeltaNet,
    Mamba-1, Mamba-2, LFM2's short conv; these ignore the read bound).
    ``rows`` (``forward``'s row map) reaches attention blocks and LFM2's
    short conv, whose conv window the map gathers and writes back
    (ROW_MAPPED_KINDS)."""
    kind = cfg.layer_kinds[layer_idx] if cfg.layer_kinds else "attn"
    if rows is not None and kind not in ROW_MAPPED_KINDS:
        raise ValueError(f"a row map does not cover {kind!r} layers: their "
                         "recurrent state is indexed by input row")
    if kind == "shortconv":
        return mamba.shortconv_layer(layer, cfg, x, positions, kv, layer_idx,
                                     lengths, precision, rows)
    if kind in RECURRENT_LAYERS:
        return RECURRENT_LAYERS[kind][1](layer, cfg, x, positions, kv,
                                         layer_idx, lengths, precision)
    if kind == "hybrid_par":
        return parallel_hybrid_layer(layer, cfg, x, positions, kv, layer_idx,
                                     lengths, read_bound, precision)
    if kind != "attn":
        raise ValueError(f"unknown layer kind {kind!r}")
    return transformer_layer(layer, cfg, x, positions, kv, layer_idx,
                             lengths, read_bound, precision, rows)


def embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
          positions: torch.Tensor | None = None) -> torch.Tensor:
    x = L.embedding_lookup(params["embed"], tokens)
    if params.get("position_embed") is not None and positions is not None:
        # learned absolute positions; out-of-range padding positions clamp
        # to a valid row, whose contribution is masked downstream
        idx = positions.clamp(0, params["position_embed"].shape[0] - 1).long()
        x = x + params["position_embed"][idx]
    if params.get("embed_norm") is not None:
        x = apply_norm(x, params["embed_norm"], cfg.norm_eps,
                       cfg.uses_layer_norm)
    if cfg.embedding_scale != 1.0:
        x = x * cfg.embedding_scale
    return x


def compute_logits(params: dict, cfg: ModelConfig, x: torch.Tensor,
                   precision: str | None = None) -> torch.Tensor:
    x = apply_norm(x, params["final_norm"], cfg.norm_eps, cfg.uses_layer_norm)
    if params.get("output") is not None:
        logits = L.apply(params["output"], x, precision)
    else:  # tied embeddings: contraction against the dense [V, H] table
        logits = torch.matmul(x, params["embed"].to(x.dtype).t())
    logits = logits.float()
    if cfg.logit_scale != 1.0:  # Cohere family
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap > 0.0:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv: dict, lengths: torch.Tensor,
            read_bound: int | None = None,
            logit_positions: torch.Tensor | None = None,
            precision: str | None = None,
            rows: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Full forward. tokens/positions: [B, T]; lengths: [B] valid KV length
    after writing this step. ``read_bound``: cap on KV positions attention
    reads; None reads the whole cache. ``logit_positions``: optional [B]
    per-row T-index; the LM head then runs on that one hidden state per row
    and the result is [B, 1, V]. ``precision``: the matmul precision of the
    quantized products (the runner's ``matmul_precision``).

    ``read_bound`` may also be a tuple ``(lo, hi, cap)`` or ``(lo, hi, cap,
    shards)``: two-tier ragged decode (ops/attention.tiered_attention).
    Every row reads the ``lo`` bucket, and the <= ``cap`` rows whose length
    exceeds ``lo`` re-run against ``hi``; the caller guarantees that no
    more than ``cap`` rows do (engine/runner.pick_read_bound). The tier's
    rows are selected here on the device, with one top-k over ``lengths``.
    ``shards`` > 1 groups the selection into that many contiguous batch
    groups of B/shards rows (where it divides B), each with its own top-k
    of ``cap`` rows, as the JAX package selects the tier per data shard.

    ``rows``: an optional row map, [B] int: input row i is the cache's batch
    row ``rows[i]``, which its K/V writes scatter to and its attention
    reads gather from, so a step can run a few rows of a larger cache
    (engine/runner.py's launch plan). It takes a single read bound, and
    attention layers over the plain or MLA cache (not the SWA ring or qjl)
    and LFM2's short conv (its conv window gathered and written back by
    the same map; models/mamba.causal_conv), not the other recurrent
    states."""
    if rows is not None and isinstance(read_bound, tuple):
        raise ValueError("a row map takes a single read bound, not a tier")
    if isinstance(read_bound, tuple):
        lo, hi, cap, *rest = read_bound
        shards = rest[0] if rest else 1
        b = tokens.shape[0]
        g = shards if shards > 1 and b % shards == 0 else 1
        bl = b // g
        # torch.topk may order tied lengths unlike jax.lax.top_k, but cap
        # covers every row longer than lo, so the same rows get the hi
        # bucket and the result is the same; the others are padding (B/G)
        top, idx = torch.topk(lengths.reshape(g, bl), min(cap, bl), dim=1)
        read_bound = (lo, hi, torch.where(top > lo, idx,
                                          torch.full_like(idx, bl)))
    x = embed(params, cfg, tokens, positions)
    trace_activation("embed", -1, x)
    for i, layer in enumerate(params["layers"]):
        x, kv = layer_forward(layer, cfg, x, positions, kv, i, lengths,
                              read_bound, precision, rows)
        trace_activation("out", i, x)
    if logit_positions is not None and x.shape[1] > 1:
        idx = logit_positions.long()[:, None, None].expand(-1, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    return compute_logits(params, cfg, x, precision), kv
