"""Attention score paths, dense and chunked (online softmax), in plain
PyTorch ops (port of llama_gguf_tpu/ops/attention.py, which is XLA code, not
a Pallas kernel).

Mask semantics as in the JAX package: causal on positions, ``lengths``,
sliding window (a negative window means chunked attention), logit softcap,
attention sinks and ALiBi; GQA grouping qg [B, T, K, R, D]. Two-tier ragged
decode attention (``tiered_attention``, ``group_take``) serves the tuple
read bound of models/transformer.forward; ``qjl_attention`` scores a qjl
cache's sign sketches without rebuilding its keys.
"""

from __future__ import annotations

import functools
import math

import torch

NEG_INF = -1e30
DEFAULT_BLOCK = 256
# use the chunked path when the dense score tensor would exceed this many
# elements (B*T*H*S)
CHUNK_THRESHOLD = 1 << 22


@functools.lru_cache(maxsize=None)
def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Standard ALiBi slopes: geometric sequence from 2^(-8/n) for the
    largest power-of-two n <= num_heads, with interleaved extras. Cached,
    so a CUDA graph's capture copies nothing from the host."""
    n = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-8.0 / n)
    slopes = [base ** (i + 1) for i in range(n)]
    if n < num_heads:
        extra_base = 2.0 ** (-4.0 / n)
        slopes += [extra_base ** (2 * i + 1) for i in range(num_heads - n)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def alibi_bias(positions: torch.Tensor, s_idx: torch.Tensor,
               num_kv_heads: int, rep: int, heads=True) -> torch.Tensor:
    """[B, T, K, R, S] bias: -slope_h * (q_pos - key_pos), clamped at 0 for
    future keys (masked anyway). s_idx: key positions [S] or [B, S].
    ``heads``: True, or (total heads, first head) when these K * R heads
    are a rank's share of the model's (parallel/sharding.py): the slopes
    are those of their global indices."""
    n = num_kv_heads * rep
    total, first = heads if isinstance(heads, tuple) else (n, 0)
    slopes = alibi_slopes(total, positions.device)[first:first + n].reshape(
        num_kv_heads, rep)
    si = s_idx[None, None, :] if s_idx.dim() == 1 else s_idx[:, None, :]
    dist = torch.clamp(positions[:, :, None] - si, min=0).float()
    return -slopes[None, None, :, :, None] * dist[:, :, None, None, :]


def _mask_block(positions, lengths, s_idx, sliding_window: int):
    """[B, T, S_blk] bool visibility mask for key positions s_idx ([S], or
    [B, S] with -1 for empty ring slots)."""
    si = s_idx[None, None, :] if s_idx.dim() == 1 else s_idx[:, None, :]
    valid = (si <= positions[:, :, None]) & (si < lengths[:, None, None])
    if s_idx.dim() == 2:
        valid &= si >= 0  # never-written ring slots
    if sliding_window > 0:
        valid &= si > (positions[:, :, None] - sliding_window)
    elif sliding_window < 0:
        # chunked attention: keys visible only within the query's chunk
        c = -sliding_window
        valid &= si >= torch.div(positions[:, :, None], c,
                                 rounding_mode="floor") * c
    return valid


def dense_attention(qg, keys, vals, positions, lengths, *, scale: float,
                    softcap: float = 0.0, sliding_window: int = 0,
                    sinks=None, alibi=False, key_positions=None):
    """qg [B,T,K,R,D]; keys [B,S,K,D]; vals [B,S,K,Dv] -> [B,T,K,R,Dv].
    ``alibi``: False, True, or (total heads, first head) (alibi_bias).

    ``key_positions`` [B,S]: per-slot absolute positions for ring-buffer
    caches where slot index != position; None = contiguous cache."""
    s = keys.shape[1]
    s_idx = (torch.arange(s, device=keys.device) if key_positions is None
             else key_positions)
    scores = torch.einsum("btkrd,bskd->btkrs", qg, keys) * scale
    if alibi:
        scores = scores + alibi_bias(positions, s_idx, qg.shape[2],
                                     qg.shape[3], alibi)
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    valid = _mask_block(positions, lengths, s_idx, sliding_window)
    scores = torch.where(valid[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    if sinks is not None:
        b, t, k, r, _ = scores.shape
        sk = sinks.reshape(1, 1, k, r, 1).expand(b, t, k, r, 1).to(scores.dtype)
        probs = torch.softmax(torch.cat([scores, sk], dim=-1), dim=-1)[..., :-1]
    else:
        probs = torch.softmax(scores, dim=-1)
    # fully-masked rows (padding slots) -> 0, matching the chunked path
    any_valid = valid.any(-1)[:, :, None, None, None]
    probs = torch.where(any_valid, probs, torch.zeros_like(probs))
    return torch.einsum("btkrs,bskd->btkrd", probs, vals)


def chunked_attention(qg, keys, vals, positions, lengths, *, scale: float,
                      softcap: float = 0.0, sliding_window: int = 0,
                      alibi=False, sinks=None,
                      block: int = DEFAULT_BLOCK):
    """Flash-style attention over KV blocks with online softmax; same result
    as dense_attention with peak intermediate [B,T,K,R,block]."""
    b, t, k, r, _ = qg.shape
    s = keys.shape[1]
    dv = vals.shape[-1]
    m = torch.full((b, t, k, r), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((b, t, k, r), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((b, t, k, r, dv), dtype=torch.float32, device=qg.device)
    for start in range(0, s, block):
        # a ragged last block is simply shorter: its absent slots would carry
        # key positions >= s >= lengths and be masked anyway
        ks = keys[:, start:start + block]
        vs = vals[:, start:start + block]
        s_idx = torch.arange(start, start + ks.shape[1], device=qg.device)
        scores = torch.einsum("btkrd,bskd->btkrs", qg, ks) * scale
        if alibi:
            scores = scores + alibi_bias(positions, s_idx, k, r, alibi)
        if softcap > 0.0:
            scores = torch.tanh(scores / softcap) * softcap
        valid = _mask_block(positions, lengths, s_idx, sliding_window)
        vmask = valid[:, :, None, None, :]
        scores = torch.where(vmask, scores, torch.full_like(scores, NEG_INF))

        m_new = torch.maximum(m, scores.amax(-1))
        # all-masked rows keep m at NEG_INF; exp(NEG_INF - NEG_INF) must not
        # produce NaN
        safe_m = torch.where(m_new == NEG_INF, torch.zeros_like(m_new), m_new)
        p = torch.exp(scores - safe_m[..., None])
        p = torch.where(vmask, p, torch.zeros_like(p))
        alpha = torch.where(m == NEG_INF, torch.zeros_like(m),
                            torch.exp(m - safe_m))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("btkrs,bskd->btkrd", p, vs)
        m = m_new
    if sinks is not None:
        # one extra constant logit per head joins the softmax denominator
        # (no value vector); folded into the running max
        sk = sinks.reshape(1, 1, k, r).expand_as(m).float()
        safe_m = torch.where(m == NEG_INF, torch.zeros_like(m), m)
        m2 = torch.maximum(safe_m, sk)
        alpha = torch.exp(safe_m - m2)
        l = l * alpha + torch.exp(sk - m2)
        acc = acc * alpha[..., None]
    return acc / torch.clamp(l[..., None], min=1e-30)


def qjl_attention(qg, k_packed, k_norms, v_packed, v_scale, positions,
                  lengths, *, scale: float, v_head_dim: int,
                  softcap: float = 0.0, sliding_window: int = 0):
    """Attention on QJL-compressed keys: the scores are the sign-sketch
    estimates (models/turboquant.qjl_scores_batched), K is never rebuilt;
    the values are tq4-decompressed for the weighted sum.

    qg [B,T,K,R,D]; k_packed [B,S,K,D/8]; k_norms [B,S,K];
    v_packed [B,S,K,Dv/2]; v_scale [B,S,K] -> [B,T,K,R,Dv]."""
    from ..models.turboquant import decompress, qjl_scores_batched

    s = k_packed.shape[1]
    scores = qjl_scores_batched(qg, k_packed, k_norms) * scale
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    valid = _mask_block(positions, lengths,
                        torch.arange(s, device=qg.device), sliding_window)
    scores = torch.where(valid[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid.any(-1)[:, :, None, None, None], probs,
                        torch.zeros_like(probs))
    vals = decompress(v_packed, v_scale, 4, v_head_dim)
    return torch.einsum("btkrs,bskd->btkrd", probs, vals)


def group_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather batch rows by group-local indices: ``x`` [B, ...] viewed as G
    contiguous groups of B/G rows, ``idx`` [G, C] row indices within each
    group. Entries == B/G are padding: clamped here (as the JAX package's
    ``mode="clip"`` gather does), dropped at the scatter of
    ``tiered_attention``. Returns [G*C, ...]."""
    g, c = idx.shape
    bl = x.shape[0] // g
    rows = (torch.arange(g, device=idx.device)[:, None] * bl
            + idx.clamp(0, bl - 1)).reshape(-1)
    return x.index_select(0, rows)


def tiered_attention(read_fn, qg, positions, lengths, lo: int, hi: int,
                     tier_idx: torch.Tensor, **kw):
    """Two-tier ragged decode attention (static shapes). Every row attends
    over the ``lo`` KV bucket; the few rows whose live context exceeds
    ``lo``, pre-selected into ``tier_idx`` [G, C] (group-local indices,
    B/G = padding), are gathered, attend over the ``hi`` bucket and
    overwrite their lo-bucket results. Attention reads B*lo + G*C*hi
    positions instead of B*hi. ``read_fn(bound, rows)`` -> (keys, vals):
    the cache sliced to ``bound`` positions, batch rows gathered by
    ``rows`` first when given (models/kv.read).

    The JAX scatter drops the padding index B/G (``mode="drop"``); torch's
    index_put_ would fault on it. So each group gets one extra row that
    the padding entries write to and the result leaves out, as the KV
    cache's drop slot does for padding positions."""
    g, c = tier_idx.shape
    b = qg.shape[0]
    bl = b // g
    keys, vals = read_fn(lo, None)
    ctx = attention_scores(qg, keys, vals, positions, lengths, **kw)
    k_hi, v_hi = read_fn(hi, tier_idx)
    ctx_hi = attention_scores(
        group_take(qg, tier_idx), k_hi, v_hi,
        group_take(positions, tier_idx), group_take(lengths, tier_idx), **kw)
    rest = ctx.shape[1:]
    ctxg = torch.cat([ctx.reshape(g, bl, *rest),
                      ctx.new_zeros((g, 1, *rest))], dim=1)
    ctxg[torch.arange(g, device=ctx.device)[:, None], tier_idx.long()] = \
        ctx_hi.reshape(g, c, *rest)
    return ctxg[:, :bl].reshape(b, *rest)


def attention_scores(qg, keys, vals, positions, lengths, *, scale: float,
                     softcap: float = 0.0, sliding_window: int = 0,
                     sinks=None, alibi=False, key_positions=None):
    """Pick dense vs chunked by the dense score-tensor size. Ring caches
    (key_positions given) are window-sized, so always dense."""
    b, t, k, r, _ = qg.shape
    s = keys.shape[1]
    if key_positions is None and \
            b * t * k * r * s > CHUNK_THRESHOLD and s >= 2 * DEFAULT_BLOCK:
        return chunked_attention(qg, keys, vals, positions, lengths,
                                 scale=scale, softcap=softcap,
                                 sliding_window=sliding_window, alibi=alibi,
                                 sinks=sinks)
    return dense_attention(qg, keys, vals, positions, lengths, scale=scale,
                           softcap=softcap, sliding_window=sliding_window,
                           sinks=sinks, alibi=alibi,
                           key_positions=key_positions)
