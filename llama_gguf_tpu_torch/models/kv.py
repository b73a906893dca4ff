"""KV cache: per-layer [B, S + 1, H_kv, D] buffers, updated in place (port
of llama_gguf_tpu/models/kv.py, every format).

The storage format is chosen when the cache is made:

  f32 / bf16        plain dense cache
  i8                symmetric int8 with one f32 scale per (position, head)
                    (``k_scale``/``v_scale``), dequantized on read
  f8_e4m3 / f8_e5m2 torch.float8_e4m3fn / float8_e5m2, no scales
  tq2 / tq3 / tq4   TurboQuant: Hadamard-rotated, quantized and bit-packed
                    into uint8 lanes, one f32 scale per (position, head)
                    (models/turboquant.py)
  qjl               keys as 1-bit sign sketches (uint8, D / 8 a head) with
                    their norms in ``k_scale``; values tq4. Attention runs
                    on the sketches (ops/attention.qjl_attention)

A model with interleaved sliding-window layers may also keep those layers
in a ring (``k_swa``/``v_swa`` of ``ring_slots`` positions, each slot's
absolute position in ``swa_pos``, -1 when empty) while the full layers keep
``k``/``v``; attention masks by stored position, so the values are those of
the full cache (the f32, bf16 and f8 formats only, as in the JAX package).

A hybrid model's cache also carries recurrent state, updated in place as
well: ``"deltanet"``, one {"S", "conv"} per layer (models/deltanet.py), or
``"mamba"``, {"conv": L x tensor, "ssm": L x tensor} (models/mamba.py).

The JAX cache is immutable and relies on JAX's scatter silently dropping
positions >= S (the runner pads with pos = max_seq on purpose). PyTorch's
``index_put_`` raises on the CPU, and trips a device-side assert on CUDA, for
such an index. So every positional buffer, the scales and the ring's
included, carries one extra slot at index S (R for the ring): writes
redirect every out-of-range position there, and reads never look at it.
The logical cache is [B, S, H, D], as in the JAX package.

float8 buffers are written, slid, zeroed and gathered through their uint8
view (``byte_view``) everywhere, so no float8 kernel beyond the casts is
needed.
The cast to float8_e4m3fn follows the JAX package's: torch saturates past
448, XLA gives NaN for |x| > 464 (``_cast``).

``shift_left`` (the context shift) rolls the logical region in place with
``copy_``: the runner's CUDA graphs replay the addresses they captured, so
no buffer is ever rebound.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.attention import group_take
from ..ops.rope import rerotate_keys
from . import turboquant as TQ

FORMATS = ("f32", "bf16", "i8", "f8_e4m3", "f8_e5m2", "tq2", "tq3", "tq4",
           "qjl")

_STORE_DTYPE = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
    "i8": torch.int8,
    "f8_e4m3": torch.float8_e4m3fn,
    "f8_e5m2": torch.float8_e5m2,
}
_F8 = (torch.float8_e4m3fn, torch.float8_e5m2)
# dtypes numpy lacks, by the ml_dtypes name that the JAX package's arrays and
# session files carry: (the numpy dtype that holds their raw bits, the torch
# dtype)
RAW_DTYPES = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
              "float8_e5m2": (np.uint8, torch.float8_e5m2)}
# the positional tensors: [B, S + 1, ...] (the ring's [B, R + 1, ...])
POSITIONAL = ("k", "v", "k_scale", "v_scale", "k_swa", "v_swa", "swa_pos")
# past this magnitude XLA's f32 -> float8_e4m3fn cast gives NaN (ties at
# 464 round to 448); torch's saturates to 448
_E4M3_NAN_ABOVE = 464.0


def ring_format_ok(fmt) -> bool:
    """KV formats the SWA ring cache supports (the scale-free dense ones,
    as in the JAX package)."""
    return fmt in (None, "f32", "bf16", "f8_e4m3", "f8_e5m2")


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """A float8 buffer's uint8 view (the bytes every write and slide moves);
    any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype in _F8 else t


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the storage dtype, as the JAX package's ``astype`` gives it:
    to float8_e4m3fn, |x| > 464 and +-inf become NaN of x's sign, where
    torch alone would saturate at +-448."""
    if dtype == torch.float8_e4m3fn:
        x = x.float()
        x = torch.where(x.abs() > _E4M3_NAN_ABOVE,
                        torch.copysign(torch.full_like(x, float("nan")), x),
                        x)
    return x.to(dtype)


def _zeros(shape, dtype, device) -> torch.Tensor:
    if dtype in _F8:  # made as bytes: zero bits are +0.0
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def init_cache(num_layers: int, batch: int, max_seq: int, num_kv_heads: int,
               head_dim: int, v_head_dim: int | None = None,
               fmt: str = "f32", device="cuda", swa_layers: tuple = (),
               ring_slots: int = 0) -> dict[str, Any]:
    """An empty cache in format ``fmt``. ``swa_layers`` (one bool a layer)
    and ``ring_slots``: the sliding-window layers get ring buffers of
    ``ring_slots`` positions (plus the drop slot) instead of ``max_seq``,
    when the format is ring_format_ok, at least one layer is full (the
    logical max_seq comes from a full layer) and the ring is shorter than
    max_seq; else every layer gets the plain cache."""
    use_ring = (ring_slots > 0 and any(swa_layers) and not all(swa_layers)
                and ring_format_ok(fmt) and ring_slots < max_seq)
    if use_ring:
        n_full = sum(not s for s in swa_layers)
        n_swa = len(swa_layers) - n_full
        base = init_cache(n_full, batch, max_seq, num_kv_heads, head_dim,
                          v_head_dim, fmt, device)
        ring = init_cache(n_swa, batch, ring_slots, num_kv_heads, head_dim,
                          v_head_dim, fmt, device)
        base["k_swa"] = ring["k"]
        base["v_swa"] = ring["v"]
        base["swa_pos"] = [torch.full((batch, ring_slots + 1), -1,
                                      dtype=torch.int32, device=device)
                           for _ in range(n_swa)]
        return base
    fmt = fmt or "f32"
    if fmt not in FORMATS:
        raise ValueError(f"unknown kv format {fmt!r} (one of {FORMATS})")
    vd = head_dim if v_head_dim is None else v_head_dim
    s1 = max_seq + 1

    def layers(*tail, dtype):
        return [_zeros((batch, s1, *tail), dtype, device)
                for _ in range(num_layers)]

    if fmt == "qjl" or fmt.startswith("tq"):
        kbits, vbits = (1, 4) if fmt == "qjl" else (int(fmt[2]),) * 2
        return {
            "k": layers(num_kv_heads, head_dim * kbits // 8,
                        dtype=torch.uint8),
            "v": layers(num_kv_heads, vd * vbits // 8, dtype=torch.uint8),
            "k_scale": layers(num_kv_heads, dtype=torch.float32),
            "v_scale": layers(num_kv_heads, dtype=torch.float32),
        }
    store = _STORE_DTYPE[fmt]
    kv = {"k": layers(num_kv_heads, head_dim, dtype=store),
          "v": layers(num_kv_heads, vd, dtype=store)}
    if fmt == "i8":
        kv["k_scale"] = layers(num_kv_heads, dtype=torch.float32)
        kv["v_scale"] = layers(num_kv_heads, dtype=torch.float32)
    return kv


def cache_shape(kv: dict[str, Any]) -> tuple[int, int, int, int, int]:
    """Logical [L, B, S, H, D] shape (L: the full layers of a ring
    cache)."""
    b, s1, h, d = kv["k"][0].shape
    return (len(kv["k"]), b, s1 - 1, h, d)


def cache_format(kv: dict[str, Any], head_dim: int | None = None) -> str:
    """The format of ``kv`` from its key dtype; a packed (uint8) cache is
    "tq" without ``head_dim``, else tq2/tq3/tq4 or qjl by its width."""
    dt = kv["k"][0].dtype
    if dt == torch.uint8:
        if head_dim is None:
            return "tq"
        bits = kv["k"][0].shape[-1] * 8 // head_dim
        return "qjl" if bits == 1 else f"tq{bits}"
    for fmt, store in _STORE_DTYPE.items():
        if dt == store:
            return fmt
    raise ValueError(f"no kv format stores {dt}")


def _quantize_i8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(token, head) int8: x [..., D] f32 -> (q int8, scale
    [...] f32), in the JAX package's order of operations (round half to
    even in both)."""
    scale = x.abs().amax(-1) / 127.0
    inv = torch.where(scale > 0, 1.0 / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(x * inv[..., None]), -127, 127)
    return q.to(torch.int8), scale.float()


def _set_at_positions(cache: torch.Tensor, value: torch.Tensor,
                      positions: torch.Tensor,
                      rows: torch.Tensor | None = None) -> None:
    """cache [B, S+1, ...] <- value [b, T, ...] at positions [b, T], in
    place, into batch rows ``rows`` [b] (default: rows 0..b-1); positions
    outside [0, S) go to the drop slot S, so they never clobber live
    entries."""
    s = cache.shape[1] - 1
    pos = torch.where((positions >= 0) & (positions < s), positions,
                      torch.full_like(positions, s)).long()
    b_idx = (torch.arange(value.shape[0], device=cache.device)
             if rows is None else rows.long())[:, None]
    byte_view(cache).index_put_((b_idx.expand_as(pos), pos),
                           byte_view(_cast(value, cache.dtype)))


def _encode(kv: dict[str, Any], k: torch.Tensor, v: torch.Tensor
            ) -> dict[str, torch.Tensor]:
    """New K/V [B, T, H, D] in the cache's storage: {buffer key: value}."""
    fmt = cache_format(kv, head_dim=k.shape[-1])
    if fmt == "qjl":
        kp, knorm = TQ.qjl_compress(k.float())
        vp, vs = TQ.compress(v.float(), 4)
        return {"k": kp, "v": vp, "k_scale": knorm, "v_scale": vs}
    if fmt.startswith("tq"):
        bits = int(fmt[2])
        kp, ks = TQ.compress(k.float(), bits)
        vp, vs = TQ.compress(v.float(), bits)
        return {"k": kp, "v": vp, "k_scale": ks, "v_scale": vs}
    if fmt == "i8":
        kq, ks = _quantize_i8(k.float())
        vq, vs = _quantize_i8(v.float())
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def write(kv: dict[str, Any], layer: int, k: torch.Tensor, v: torch.Tensor,
          positions: torch.Tensor, rows: torch.Tensor | None = None
          ) -> dict[str, Any]:
    """Scatter new K/V [B, T, H_kv, D] at per-token positions [B, T], in
    place, quantized to the cache's format (and its scales). Padding tokens
    carry positions >= max_seq and are dropped. ``rows``: optional [B]
    cache batch row of each input row (the runner's row map), as ``read``
    gathers them; default the input rows themselves."""
    for key, value in _encode(kv, k, v).items():
        _set_at_positions(kv[key][layer], value, positions, rows)
    return kv


def write_swa(kv: dict[str, Any], swa_idx: int, k: torch.Tensor,
              v: torch.Tensor, positions: torch.Tensor,
              window: int) -> dict[str, Any]:
    """Scatter K/V into sliding-window ring ``swa_idx`` at slot pos % R, in
    place, and record each slot's position in ``swa_pos``.

    Requires T <= R - |window| + 1 (a ValueError otherwise): within one
    step, the oldest key any query needs (q_pos - window + 1) must not share
    a ring slot with a newer key written in the same scatter. Positions at
    or past the full layers' max_seq (padding) map to slot R, the ring's
    drop slot."""
    r = kv["k_swa"][swa_idx].shape[1] - 1
    t = k.shape[1]
    window = abs(window)  # a negative window is chunked attention
    if t > r - window + 1:
        raise ValueError(
            f"prefill chunk T={t} too large for SWA ring (R={r}, "
            f"window={window}); chunk prefill to <= {r - window + 1} tokens "
            "or disable the ring cache (swa_ring=False)")
    max_seq = kv["k"][0].shape[1] - 1
    live = (positions >= 0) & (positions < max_seq)
    slot = torch.where(live, positions % r, torch.full_like(positions, r))
    slot = slot.long()
    b_idx = torch.arange(k.shape[0], device=k.device)[:, None].expand_as(slot)
    for key, value in (("k_swa", k), ("v_swa", v)):
        buf = kv[key][swa_idx]
        byte_view(buf).index_put_((b_idx, slot),
                                  byte_view(_cast(value, buf.dtype)))
    kv["swa_pos"][swa_idx].index_put_((b_idx, slot),
                                      positions.to(torch.int32))
    return kv


def read_swa(kv: dict[str, Any], swa_idx: int, compute_dtype=torch.float32
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring ``swa_idx``'s K/V and the absolute position of each slot:
    ([B, R, H, D], [B, R, H, Dv], [B, R] int32, -1 = empty); the drop slot
    is never read."""
    r = kv["k_swa"][swa_idx].shape[1] - 1
    return (kv["k_swa"][swa_idx][:, :r].to(compute_dtype),
            kv["v_swa"][swa_idx][:, :r].to(compute_dtype),
            kv["swa_pos"][swa_idx][:, :r])


def read(kv: dict[str, Any], layer: int, compute_dtype=torch.float32,
         head_dim: int | None = None, v_head_dim: int | None = None,
         bound: int | None = None, rows: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V for one layer ([B,S,H,Dk], [B,S,H,Dv]) in ``compute_dtype``,
    dequantized (i8: times the scales; tq: unpacked and rotated back, which
    needs ``head_dim``), sliced to the first ``bound`` positions (the caller
    guarantees every valid position < bound); the drop slot is never read.

    ``rows``: optional batch-row gather (two-tier ragged decode: only the
    long rows' cache bytes are read for the high bucket), either [C] global
    indices or [G, C] group-local ones (ops/attention.group_take); the
    result is [C or G*C, ...]. Out-of-range indices clamp, as the JAX
    package's gather does: the caller drops those rows. The scales go
    through the same slice and gather."""
    fmt = cache_format(kv, head_dim=head_dim)
    if fmt == "tq":
        raise ValueError("tq cache read requires head_dim")
    if fmt == "qjl":
        raise ValueError(
            "qjl caches cannot be read back as K/V (keys are sign sketches);"
            " attention runs on the compressed keys via ops.attention."
            "qjl_attention")
    s = kv["k"][layer].shape[1] - 1
    n = s if bound is None else min(bound, s)

    def pick(a):
        a = byte_view(a)[:, :n]
        if rows is not None:
            if rows.dim() == 2:
                a = group_take(a, rows)
            else:
                a = a.index_select(0, rows.clamp(0, a.shape[0] - 1))
        return a

    k, v = pick(kv["k"][layer]), pick(kv["v"][layer])
    if fmt.startswith("tq"):
        bits = int(fmt[2])
        ks, vs = pick(kv["k_scale"][layer]), pick(kv["v_scale"][layer])
        return (TQ.decompress(k, ks, bits, head_dim).to(compute_dtype),
                TQ.decompress(v, vs, bits, v_head_dim or head_dim
                              ).to(compute_dtype))
    if fmt == "i8":
        ks, vs = pick(kv["k_scale"][layer]), pick(kv["v_scale"][layer])
        return (k.to(compute_dtype) * ks[..., None].to(compute_dtype),
                v.to(compute_dtype) * vs[..., None].to(compute_dtype))
    store = kv["k"][layer].dtype
    if store in _F8:
        k, v = k.view(store), v.view(store)
    return k.to(compute_dtype), v.to(compute_dtype)


def zero_(kv: dict[str, Any]) -> None:
    """Empty ``kv`` in place: every K/V, scale and ring buffer and the
    recurrent state to zero, every ring slot's position to -1 (a 0 would
    make each slot claim position 0 under the ring's mask)."""
    for key in POSITIONAL:
        for t in kv.get(key, ()):
            if key == "swa_pos":
                t.fill_(-1)
            else:
                byte_view(t).zero_()
    for t in _state_tensors(kv):
        t.zero_()


def clear_state(kv: dict[str, Any], row: int) -> None:
    """Zero batch row ``row``'s recurrent state in place, so a new sequence
    in that row starts from none. Its positional buffers (K/V, scales, ring
    slots and their positions) need no clearing, as in the JAX package:
    attention reads only positions below the row's length, and a stale ring
    slot holds a position above the new sequence's queries until that
    sequence overwrites it, so the causal mask hides it."""
    for t in _state_tensors(kv):
        t[row].zero_()


def _state_tensors(kv: dict[str, Any]) -> list[torch.Tensor]:
    """Every recurrent-state tensor of ``kv`` (DeltaNet and Mamba)."""
    out = [t for st in kv.get("deltanet", ()) for t in (st["S"], st["conv"])]
    mamba = kv.get("mamba", {})
    return out + list(mamba.get("conv", ())) + list(mamba.get("ssm", ()))


def memory_bytes(kv: dict[str, Any]) -> int:
    """The cache's logical bytes, as the JAX package counts them: every
    buffer without its drop slot, plus the recurrent state."""
    total = sum(t.numel() // t.shape[1] * (t.shape[1] - 1) * t.element_size()
                for key in POSITIONAL for t in kv.get(key, ()))
    return total + sum(t.numel() * t.element_size()
                       for t in _state_tensors(kv))


def shift_left(kv: dict[str, Any], n: int, rope_cfg=None,
               batch_idx: int | None = None, model_cfg=None
               ) -> dict[str, Any]:
    """Drop the first ``n`` cache positions and slide the rest left, in
    place (the JAX package's ``shift_left``).

    The logical [:, :S] region of every positional buffer, the scales
    included, rolls by -n, as ``jnp.roll`` does on the JAX cache (the first
    n slots wrap round to the end); the drop slot stays. Stored keys are
    post-RoPE, so sliding a key from position p to p - n re-rotates it by
    -n * theta, in f32, and stores it once in the cache's format: i8 keys
    are dequantized, rotated and requantized; tq and qjl keys (rotated and
    packed) only slide, as in the JAX package. ``model_cfg`` (a
    ModelConfig) gives each layer its own RoPE (``layer_rope``): NoPE layers
    only slide, dual-base SWA layers rotate at their own base. ``rope_cfg``
    alone rotates every layer alike. ``batch_idx`` shifts only that row. An
    MLA latent cache (``model_cfg`` with a kv_lora_rank) holds K = [c_kv |
    k_rope]: only its trailing rope dims rotate. A hybrid cache's recurrent
    state is not positional and is left alone. A ring cache is refused: its
    slots alias positions modulo R. The caller subtracts n from its
    lengths."""
    if "k_swa" in kv:
        raise ValueError(
            "context shift is not supported with the SWA ring cache "
            "(ring slots alias positions modulo R); create the runner with "
            "swa_ring=False to use context shift")
    rows = slice(None) if batch_idx is None else slice(batch_idx,
                                                       batch_idx + 1)

    def live(t):  # the logical region of the shifted rows, as bytes
        return byte_view(t)[rows, :t.shape[1] - 1]

    def roll_(t):
        region = live(t)
        region.copy_(torch.roll(region, -n, dims=1))

    for key in ("v", "v_scale"):
        for t in kv.get(key, ()):
            roll_(t)
    fmt = cache_format(kv)
    if fmt == "tq":  # tq and qjl: rotated and packed keys only slide
        for key in ("k", "k_scale"):
            for t in kv[key]:
                roll_(t)
        return kv

    def layer_rope(i):
        if model_cfg is not None:
            return model_cfg.layer_rope(i)
        return rope_cfg if rope_cfg is not None and rope_cfg.n_dims > 0 \
            else None

    rank = getattr(model_cfg, "kv_lora_rank", 0) if model_cfg else 0
    for i, k in enumerate(kv["k"]):
        rcfg = layer_rope(i)
        scale = kv["k_scale"][i] if fmt == "i8" else None
        if rcfg is None:
            roll_(k)
            if scale is not None:
                roll_(scale)
            continue
        region = live(k)
        kf = region.view(k.dtype).float() if k.dtype in _F8 else \
            region.float()
        if scale is not None:
            kf = kf * live(scale)[..., None]
        kf = torch.roll(kf, -n, dims=1)
        kf[..., rank:] = rerotate_keys(kf[..., rank:], -n, rcfg)
        if scale is not None:
            q, s = _quantize_i8(kf)
            region.copy_(q)
            live(scale).copy_(s)
        else:
            region.copy_(byte_view(_cast(kf, k.dtype)))
    return kv
