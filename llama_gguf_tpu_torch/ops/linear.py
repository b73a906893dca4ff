"""Linear layers over dense or repacked quantized weights (PyTorch port of
llama_gguf_tpu/ops/linear.py).

Weights are repacked at load time (quant/repack.py) into two layouts:

  * "q4": nibbles packed two per byte, uint8 [K/2, N], group-local split
          order (within each scale group, byte j holds elements j and
          j + group/2);
  * "q8": int8 [K, N];

plus per-group scale (and optional min) panels [K/group, N], float32 or
bfloat16 (``ModelLoader(scale_dtype=)``; the dequantization upcasts them):

    W[k, n] = s[k // group, n] * q[k, n] - m[k // group, n]

An MoE FFN's experts stack the same layout along a leading expert axis
(``QuantExpertStack``). A LoRA adapter wraps a dense or quantized linear
(``LoraLinear``, models/lora.py): the base keeps its kernel and the low-rank
term is added in float32. Under a mesh (parallel/sharding.py) a row-parallel
shard sums its partial product over the model axis before its bias
(``RowParallelLinear``), and the LM head's vocab shards are gathered
(``GatheredLinear``).

``apply`` sends a QuantLinear to ops.qmatmul.qmatmul, which launches the
hand-written CUDA kernel for a CUDA tensor and runs the plain dequantize-then-
matmul version (``dequantize_weight``) for a CPU tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class QuantLinear:
    """Quantized weight for y = x @ W with W logically [K, N] (in, out)."""

    packed: torch.Tensor  # uint8 [K/2, N] for q4; int8 [K, N] for q8
    scales: torch.Tensor  # [K/group, N] float32 or bfloat16
    mins: torch.Tensor | None  # [K/group, N], as scales, or None (symmetric)
    bias: torch.Tensor | None
    fmt: str = "q8"  # q4 | q8
    group: int = 32
    k: int = 0
    n: int = 0
    source_type: str = ""
    # output-slice boundaries of a fused projection
    splits: tuple | None = None

    @property
    def shape(self):
        return (self.k, self.n)


@dataclass
class DenseLinear:
    """Dense weight [K, N] (+ optional bias [N])."""

    weight: torch.Tensor
    bias: torch.Tensor | None = None
    splits: tuple | None = None

    @property
    def shape(self):
        return tuple(self.weight.shape)


@dataclass
class LoraLinear:
    """A low-rank adapter around a base linear: y = base(x) + (x @ a) @ b *
    scale, the low-rank term in float32 (the JAX package's LoraLinear)."""

    base: object  # DenseLinear | QuantLinear
    a: torch.Tensor  # [K, r] float32
    b: torch.Tensor  # [r, N] float32
    scale: float

    @property
    def shape(self):
        return self.base.shape


@dataclass
class RowParallelLinear:
    """A row-parallel shard under a mesh (parallel/sharding.py): this
    rank's input rows of a linear, its partial product summed over the
    model axis, then the bias added once."""

    base: object  # DenseLinear | QuantLinear | LoraLinear, without bias
    bias: torch.Tensor | None
    axis: object  # parallel.sharding.Axis

    @property
    def shape(self):
        return self.base.shape


@dataclass
class GatheredLinear:
    """A column-parallel shard whose output columns are gathered over the
    model axis in rank order (the LM head's vocab shards)."""

    base: object
    axis: object

    @property
    def shape(self):
        return self.base.shape


@dataclass
class QuantEmbedding:
    """Token embedding table kept quantized on the device, dequantized per
    row on gather. Row-major: q4 packed uint8 [V, H/2] (group-split within
    each row's scale groups) or q8 int8 [V, H], plus scales/mins [V, H/g]
    in float32 or bfloat16."""

    packed: torch.Tensor
    scales: torch.Tensor
    mins: torch.Tensor | None
    fmt: str = "q8"
    group: int = 32
    vocab: int = 0
    hidden: int = 0

    @property
    def shape(self):
        return (self.vocab, self.hidden)


@dataclass
class QuantExpertStack:
    """Stacked quantized expert weights [E, K, N] of an MoE FFN, kept
    compressed on the device; the MoE kernels (ops/qmatmul.moe_qmatmul*) read
    only the routed experts' slices, by index."""

    packed: torch.Tensor  # uint8 [E, K/2, N] (q4) or int8 [E, K, N] (q8)
    scales: torch.Tensor  # [E, K/group, N] float32 (any scale_dtype)
    mins: torch.Tensor | None  # [E, K/group, N] or None
    fmt: str  # q4 | q8
    group: int
    k: int
    n: int

    @property
    def shape(self):
        return (self.packed.shape[0], self.k, self.n)


def dequantize_expert(stack: QuantExpertStack, e: int) -> torch.Tensor:
    """Expert ``e``'s dequantized weight [K, N] in float32 (the plain oracle
    of the MoE kernels: one expert at a time, never one weight per slot)."""
    return dequantize_weight(QuantLinear(
        stack.packed[e], stack.scales[e],
        stack.mins[e] if stack.mins is not None else None, None,
        stack.fmt, stack.group, stack.k, stack.n))


def _cat_bias(lins, widths, dtype, device):
    biases = [l.bias for l in lins]
    if all(b is None for b in biases):
        return None
    return torch.cat([b if b is not None else torch.zeros(w, dtype=dtype,
                                                           device=device)
                      for b, w in zip(biases, widths)])


def fuse_linears(lins: list):
    """Fuse same-input linears into one wide matmul (concat along N), as
    llama_gguf_tpu.ops.linear.fuse_linears. Returns None when the weights
    are not compatible (mixed formats / groups / K, or an adapter)."""
    if any(l is None or isinstance(l, LoraLinear) for l in lins) \
            or len(lins) < 2:
        return None
    if all(isinstance(l, DenseLinear) for l in lins):
        w = torch.cat([l.weight for l in lins], dim=1)
        widths = [l.weight.shape[1] for l in lins]
        return DenseLinear(w, _cat_bias(lins, widths, w.dtype, w.device),
                           splits=tuple(widths))
    if not all(isinstance(l, QuantLinear) for l in lins):
        return None
    first = lins[0]
    if any(l.fmt != first.fmt or l.group != first.group or l.k != first.k
           for l in lins):
        return None
    has_mins = [l.mins is not None for l in lins]
    if any(has_mins) != all(has_mins):
        return None
    widths = [l.n for l in lins]
    return QuantLinear(
        torch.cat([l.packed for l in lins], dim=1),
        torch.cat([l.scales for l in lins], dim=1),
        torch.cat([l.mins for l in lins], dim=1) if all(has_mins) else None,
        _cat_bias(lins, widths, torch.float32, first.packed.device),
        first.fmt, first.group, first.k, sum(widths), first.source_type,
        splits=tuple(widths))


def unfuse_linear(lin, splits: list[int]) -> list:
    """Inverse of fuse_linears: slice along N at the given widths. Each
    slice is a contiguous copy (a kernel reads its panels whole), with no
    splits."""
    out, a = [], 0
    for w in splits:
        b = a + w

        def cut(t):
            return t[..., a:b].contiguous() if t is not None else None

        if isinstance(lin, DenseLinear):
            out.append(DenseLinear(cut(lin.weight), cut(lin.bias)))
        else:
            out.append(QuantLinear(
                cut(lin.packed), cut(lin.scales), cut(lin.mins),
                cut(lin.bias), lin.fmt, lin.group, lin.k, w,
                lin.source_type))
        a = b
    return out


def _unpack_q4_last(p: torch.Tensor, group: int) -> torch.Tensor:
    """Group-split nibbles along the LAST axis [..., H/2] -> [..., H]."""
    h = group // 2
    p3 = p.reshape(*p.shape[:-1], p.shape[-1] // h, h)
    return torch.cat([p3 & 0x0F, p3 >> 4], dim=-1).reshape(
        *p.shape[:-1], 2 * p.shape[-1])


def embedding_lookup(emb, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [...] int -> [..., H] float32. Dense tables gather directly;
    a QuantEmbedding gathers packed rows and dequantizes them."""
    tokens = tokens.long()
    if not isinstance(emb, QuantEmbedding):
        return emb[tokens]
    g = emb.group
    rows_p = emb.packed[tokens]
    if emb.fmt == "q4":
        q = _unpack_q4_last(rows_p, g).float()
    else:
        q = rows_p.float()
    w = q * emb.scales[tokens].float().repeat_interleave(g, dim=-1)
    if emb.mins is not None:
        w = w - emb.mins[tokens].float().repeat_interleave(g, dim=-1)
    return w


def unpack_q4(ql: QuantLinear) -> torch.Tensor:
    """Unpack group-split nibbles to integer values [K, N] (uint8, 0..15)."""
    k2, n = ql.packed.shape
    h = ql.group // 2
    p3 = ql.packed.reshape(k2 // h, h, n)
    return torch.cat([p3 & 0x0F, p3 >> 4], dim=1).reshape(2 * k2, n)


def dequantize_weight(ql: QuantLinear) -> torch.Tensor:
    """Materialize the dequantized weight [K, N] in float32 (the plain
    oracle of the dequant-matmul kernels)."""
    q = unpack_q4(ql).float() if ql.fmt == "q4" else ql.packed.float()
    w = q * ql.scales.float().repeat_interleave(ql.group, dim=0)
    if ql.mins is not None:
        w = w - ql.mins.float().repeat_interleave(ql.group, dim=0)
    return w


def apply_qkv(attn: dict, x: torch.Tensor, precision: str | None = None):
    """(q, k, v) of ``attn``'s fused "wqkv" (cut at its splits) or of its
    separate "wq", "wk", "wv"."""
    if "wqkv" in attn:
        nq, nk, _ = attn["wqkv"].splits
        qkv = apply(attn["wqkv"], x, precision)
        return qkv[..., :nq], qkv[..., nq:nq + nk], qkv[..., nq + nk:]
    return tuple(apply(attn[key], x, precision) for key in ("wq", "wk", "wv"))


def apply(lin, x: torch.Tensor, precision: str | None = None) -> torch.Tensor:
    """y = x @ W (+ bias). x: [..., K] -> [..., N]. ``precision`` reaches the
    quantized kernels (bfloat16 outputs in "default"), whose output is cast
    back to x's type, as in the JAX package; a dense weight's torch.matmul
    stays in x's type. A LoraLinear adds its low-rank term to the base's
    output in float32 (torch.matmul, as the JAX package's jnp.dot) and
    casts the sum back to the base output's type."""
    if isinstance(lin, LoraLinear):
        y = apply(lin.base, x, precision)
        delta = torch.matmul(torch.matmul(x.float(), lin.a), lin.b)
        return (y.float() + delta * lin.scale).to(y.dtype)
    if isinstance(lin, DenseLinear):
        y = torch.matmul(x, lin.weight.to(x.dtype))
        if lin.bias is not None:
            y = y + lin.bias.to(y.dtype)
        return y
    if isinstance(lin, RowParallelLinear):
        y = lin.axis.all_reduce(apply(lin.base, x, precision))
        if lin.bias is not None:
            y = y + lin.bias.to(y.dtype)
        return y
    if isinstance(lin, GatheredLinear):
        return lin.axis.all_gather(apply(lin.base, x, precision), dim=-1)
    if not isinstance(lin, QuantLinear):
        raise TypeError(f"apply: unsupported linear {type(lin).__name__}")
    from .qmatmul import qmatmul

    lead = x.shape[:-1]
    y = qmatmul(x.reshape(-1, x.shape[-1]).float(), lin,
                precision).to(x.dtype)
    if lin.bias is not None:
        y = y + lin.bias.to(y.dtype)
    return y.reshape(*lead, y.shape[-1])
