"""KV cache: one [B, S + 1, H_kv, D] buffer per layer, updated in place
(port of llama_gguf_tpu/models/kv.py, f32 and bf16 formats only).

A hybrid model's cache also carries recurrent state, updated in place as
well: ``"deltanet"``, one {"S", "conv"} per layer (models/deltanet.py), or
``"mamba"``, {"conv": L x tensor, "ssm": L x tensor} (models/mamba.py).

The JAX cache is immutable and relies on JAX's scatter silently dropping
positions >= S (the runner pads with pos = max_seq on purpose). PyTorch's
``index_put_`` raises on the CPU, and trips a device-side assert on CUDA, for
such an index. So each buffer carries one extra slot at index S: writes
redirect every out-of-range position there, and reads never look at it. The
logical cache is [B, S, H, D], as in the JAX package.

``shift_left`` (the context shift) rolls the logical region in place with
``copy_``: the runner's CUDA graphs replay the addresses they captured, so
no buffer is ever rebound.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.attention import group_take
from ..ops.rope import rerotate_keys

FORMATS = ("f32", "bf16")
_STORE_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def init_cache(num_layers: int, batch: int, max_seq: int, num_kv_heads: int,
               head_dim: int, v_head_dim: int | None = None,
               fmt: str = "f32", device="cuda") -> dict[str, Any]:
    """Empty cache; ``fmt`` picks f32/bf16 storage (the other JAX formats
    are ROADMAP queue 1)."""
    if fmt not in FORMATS:
        raise NotImplementedError(
            f"kv format {fmt!r} is not ported yet (one of {FORMATS}; ROADMAP "
            "queue 1)")
    store = _STORE_DTYPE[fmt]
    vd = head_dim if v_head_dim is None else v_head_dim

    def layers(d):
        return [torch.zeros((batch, max_seq + 1, num_kv_heads, d),
                            dtype=store, device=device)
                for _ in range(num_layers)]

    return {"k": layers(head_dim), "v": layers(vd)}


def zero_(kv: dict[str, Any]) -> None:
    """Zero every buffer of ``kv`` in place: K, V and the recurrent
    state."""
    for t in kv["k"] + kv["v"] + _state_tensors(kv):
        t.zero_()


def clear_state(kv: dict[str, Any], row: int) -> None:
    """Zero batch row ``row``'s recurrent state in place, so a new sequence
    in that row starts from none (its K/V need no clearing: attention reads
    only positions below the row's length)."""
    for t in _state_tensors(kv):
        t[row].zero_()


def _state_tensors(kv: dict[str, Any]) -> list[torch.Tensor]:
    """Every recurrent-state tensor of ``kv`` (DeltaNet and Mamba)."""
    out = [t for st in kv.get("deltanet", ()) for t in (st["S"], st["conv"])]
    mamba = kv.get("mamba", {})
    return out + list(mamba.get("conv", ())) + list(mamba.get("ssm", ()))


def cache_shape(kv: dict[str, Any]) -> tuple[int, int, int, int, int]:
    """Logical [L, B, S, H, D] shape."""
    b, s1, h, d = kv["k"][0].shape
    return (len(kv["k"]), b, s1 - 1, h, d)


def _set_at_positions(cache: torch.Tensor, value: torch.Tensor,
                      positions: torch.Tensor) -> None:
    """cache [B, S+1, ...] <- value [B, T, ...] at positions [B, T], in
    place; positions outside [0, S) go to the drop slot S, so they never
    clobber live entries."""
    s = cache.shape[1] - 1
    pos = torch.where((positions >= 0) & (positions < s), positions,
                      torch.full_like(positions, s)).long()
    b_idx = torch.arange(value.shape[0], device=cache.device)[:, None]
    cache.index_put_((b_idx.expand_as(pos), pos), value.to(cache.dtype))


def write(kv: dict[str, Any], layer: int, k: torch.Tensor, v: torch.Tensor,
          positions: torch.Tensor) -> dict[str, Any]:
    """Scatter new K/V [B, T, H_kv, D] at per-token positions [B, T], in
    place. Padding tokens carry positions >= max_seq and are dropped."""
    _set_at_positions(kv["k"][layer], k, positions)
    _set_at_positions(kv["v"][layer], v, positions)
    return kv


def read(kv: dict[str, Any], layer: int, compute_dtype=torch.float32,
         bound: int | None = None, rows: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V for one layer ([B,S,H,Dk], [B,S,H,Dv]) in ``compute_dtype``,
    sliced to the first ``bound`` positions (the caller guarantees every
    valid position < bound); the drop slot is never read.

    ``rows``: optional batch-row gather (two-tier ragged decode: only the
    long rows' cache bytes are read for the high bucket), either [C] global
    indices or [G, C] group-local ones (ops/attention.group_take); the
    result is [C or G*C, ...]. Out-of-range indices clamp, as the JAX
    package's gather does: the caller drops those rows."""
    s = kv["k"][layer].shape[1] - 1
    n = s if bound is None else min(bound, s)

    def pick(a):
        a = a[:, :n]
        if rows is not None:
            if rows.dim() == 2:
                a = group_take(a, rows)
            else:
                a = a.index_select(0, rows.clamp(0, a.shape[0] - 1))
        return a.to(compute_dtype)

    return pick(kv["k"][layer]), pick(kv["v"][layer])


def shift_left(kv: dict[str, Any], n: int, rope_cfg=None,
               batch_idx: int | None = None, model_cfg=None
               ) -> dict[str, Any]:
    """Drop the first ``n`` cache positions and slide the rest left, in
    place (the JAX package's ``shift_left``, f32 and bf16 formats).

    The logical [:, :S] region of every buffer rolls by -n, as ``jnp.roll``
    does on the JAX cache (the first n slots wrap round to the end); the
    drop slot stays. Stored keys are post-RoPE, so sliding a key from
    position p to p - n re-rotates it by -n * theta, in f32, rounded once to
    the cache's dtype. ``model_cfg`` (a ModelConfig) gives each layer its own
    RoPE (``layer_rope``): NoPE layers only slide, dual-base SWA layers
    rotate at their own base. ``rope_cfg`` alone rotates every layer alike.
    ``batch_idx`` shifts only that row. An MLA latent cache (``model_cfg``
    with a kv_lora_rank) holds K = [c_kv | k_rope]: only its trailing rope
    dims rotate, and c_kv, in K and in V, only slides. A hybrid cache's
    recurrent state ("deltanet", "mamba") is not positional and is left
    alone, as in the JAX package. The caller subtracts n from its
    lengths."""
    if not {"k", "v"} <= set(kv) <= {"k", "v", "deltanet", "mamba"}:
        raise NotImplementedError(
            f"context shift of a cache with keys {sorted(kv)} is not ported "
            "yet (f32/bf16 K/V only; ROADMAP queue 1 item 10)")
    rows = slice(None) if batch_idx is None else slice(batch_idx,
                                                       batch_idx + 1)

    def layer_rope(i):
        if model_cfg is not None:
            return model_cfg.layer_rope(i)
        return rope_cfg if rope_cfg is not None and rope_cfg.n_dims > 0 \
            else None

    rank = getattr(model_cfg, "kv_lora_rank", 0) if model_cfg else 0
    for i, (k, v) in enumerate(zip(kv["k"], kv["v"])):
        s = k.shape[1] - 1
        live = v[rows, :s]
        live.copy_(torch.roll(live, -n, dims=1))
        live = k[rows, :s]
        rolled = torch.roll(live, -n, dims=1)
        rcfg = layer_rope(i)
        if rcfg is not None:
            tail = rolled[..., rank:]  # the whole key when rank is 0
            rolled[..., rank:] = rerotate_keys(tail.float(), -n,
                                               rcfg).to(rolled.dtype)
        live.copy_(rolled)
    return kv
