"""KV cache: one [B, S + 1, H_kv, D] buffer per layer, updated in place
(port of llama_gguf_tpu/models/kv.py, f32 and bf16 formats only).

A hybrid model's cache also carries ``"deltanet"``: one {"S", "conv"}
recurrent state per layer (models/deltanet.py), updated in place as well.

The JAX cache is immutable and relies on JAX's scatter silently dropping
positions >= S (the runner pads with pos = max_seq on purpose). PyTorch's
``index_put_`` raises on the CPU, and trips a device-side assert on CUDA, for
such an index. So each buffer carries one extra slot at index S: writes
redirect every out-of-range position there, and reads never look at it. The
logical cache is [B, S, H, D], as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.attention import group_take

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
    for t in kv["k"] + kv["v"]:
        t.zero_()
    for st in kv.get("deltanet", ()):
        st["S"].zero_()
        st["conv"].zero_()


def clear_state(kv: dict[str, Any], row: int) -> None:
    """Zero batch row ``row``'s recurrent state in place, so a new sequence
    in that row starts from none (its K/V need no clearing: attention reads
    only positions below the row's length)."""
    for st in kv.get("deltanet", ()):
        st["S"][row].zero_()
        st["conv"][row].zero_()


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
