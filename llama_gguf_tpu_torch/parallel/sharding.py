"""Mesh sharding plans: tensor, data and expert parallelism on
torch.distributed (port of llama_gguf_tpu/parallel/sharding.py).

The JAX package annotates its weights with NamedSharding over a ("data",
"model") mesh and lets GSPMD insert the collectives. The port states each
split and each collective itself, Megatron-style, one rank per process:

  q/k/v (by heads), the attention gate, ffn gate/up, the LM head (by vocab)
                          column-parallel: a rank keeps its output columns
  wo, ffn down            row-parallel: a rank keeps its input rows, and
                          ``ops.linear.RowParallelLinear`` sums the partial
                          products over the model axis, then adds the bias
  MoE experts             expert-parallel: a rank keeps E/tp experts and
                          runs only the slots routed to them
  embed, norms, q/k norms, the router, shared_gate, DeltaNet, Mamba and
  every other layer key   replicated
  KV cache                a rank's heads and its data rows

A split that tp does not divide is replicated, as in the JAX plan. Beyond
it, the port replicates a block whose row-parallel product would cut a
scale group of its quantized weight (K/tp not a multiple of the group),
whose norm runs across all heads or all FFN columns (OLMo-2's flat QK norm,
BitNet's sub-norms), or whose KV heads tp does not divide: there GSPMD
moves the activations for the JAX package, where the port keeps no such
collective. The same values either way.

Where the JAX plan unfuses q|k|v and gate|up before splitting, the port
splits each of q, k and v by heads and gate and up by columns, then
re-fuses each rank's pieces, so that every rank keeps the fused QKV product
and the GLU kernel (the same values, summed in another order).

The LM head's vocab shards are gathered in rank order
(``ops.linear.GatheredLinear``). Multi-head latent attention is refused,
as the JAX plan fails on it (its attention has no wk/wv).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any

import torch

from ..ops.linear import (DenseLinear, GatheredLinear, LoraLinear,
                          QuantExpertStack, QuantLinear, RowParallelLinear,
                          fuse_linears, unfuse_linear)

log = logging.getLogger(__name__)


class Axis:
    """One axis of the mesh as this rank sees it: the process group of the
    ranks along it, its size, this rank's index on it, and its backend.
    ``calls`` and ``seconds`` count its collectives outside a graph
    capture, with the host's wall time they took."""

    def __init__(self, name: str, group, size: int, index: int,
                 backend: str):
        self.name, self.group, self.size, self.index = name, group, size, index
        self.backend = backend
        self.calls = 0
        self.seconds = 0.0

    def __repr__(self) -> str:
        return (f"Axis({self.name}, size={self.size}, index={self.index}, "
                f"{self.backend})")

    def _timed(self, fn, t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda and torch.cuda.is_current_stream_capturing():
            return fn(t)
        t0 = time.perf_counter()
        out = fn(t)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the axis (a new tensor; ``t`` is left as
        it is)."""
        import torch.distributed as dist

        def run(x):
            x = x.clone()
            dist.all_reduce(x, group=self.group)
            return x

        return self._timed(run, t)

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The axis's ``t`` concatenated along ``dim`` in rank order."""
        import torch.distributed as dist

        def run(x):
            x = x.contiguous()
            if self.backend == "nccl":
                out = torch.empty((self.size, *x.shape), dtype=x.dtype,
                                  device=x.device)
                dist.all_gather_into_tensor(out, x, group=self.group)
                parts = out.unbind(0)
            else:
                parts = [torch.empty_like(x) for _ in range(self.size)]
                dist.all_gather(parts, x, group=self.group)
            return torch.cat(parts, dim=dim)

        return self._timed(lambda x: host_staged(self.backend, run, x), t)


def host_staged(backend: str, fn, t: torch.Tensor) -> torch.Tensor:
    """Run collective ``fn`` on ``t`` through host memory where the
    backend cannot take a CUDA tensor: gloo's all_gather takes CPU tensors
    only (its all_reduce takes CUDA ones). The result comes back on
    ``t``'s device."""
    if backend == "gloo" and t.is_cuda:
        return fn(t.cpu()).to(t.device)
    return fn(t)


@dataclasses.dataclass
class Mesh:
    """The (data, model) mesh as this rank sees it. Rank r sits at data
    index r // model and model index r % model (the JAX mesh's row-major
    device grid). ``cpu_group`` is a gloo group of every rank, for host
    objects (parallel/service.py)."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    model_axis: Axis
    data_axis: Axis
    cpu_group: Any

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(n_model: int | None = None, n_data: int = 1,
              device=None) -> Mesh:
    """The mesh over the initialized process group (every rank calls this,
    in the same order, as torch.distributed.new_group requires).
    ``n_model`` None takes every rank for the model axis."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.multihost.initialize_cluster)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model is None:
        n_model = world // n_data
    if n_model * n_data != world:
        raise ValueError(f"mesh data={n_data} x model={n_model} does not "
                         f"match the {world} ranks of the process group")
    backend = str(dist.get_backend())
    model_group = data_group = None
    for d in range(n_data):
        g = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
        if rank // n_model == d:
            model_group = g
    for m in range(n_model):
        g = dist.new_group(list(range(m, world, n_model)))
        if rank % n_model == m:
            data_group = g
    cpu_group = (dist.new_group(list(range(world)), backend="gloo")
                 if backend != "gloo" else dist.group.WORLD)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return Mesh(n_data, n_model, rank, torch.device(device), backend,
                Axis("model", model_group, n_model, rank % n_model, backend),
                Axis("data", data_group, n_data, rank // n_model, backend),
                cpu_group)


# -- cutting one linear -------------------------------------------------------

def _cut(t, sl, dim):
    if t is None:
        return None
    idx = [slice(None)] * t.dim()
    idx[dim] = sl
    return t[tuple(idx)].contiguous()


def _cols(lin, lo: int, hi: int):
    """Output columns [lo, hi) of a dense, quantized or adapted linear."""
    if isinstance(lin, LoraLinear):
        return LoraLinear(_cols(lin.base, lo, hi), lin.a,
                          _cut(lin.b, slice(lo, hi), 1), lin.scale)
    sl = slice(lo, hi)
    if isinstance(lin, DenseLinear):
        return DenseLinear(_cut(lin.weight, sl, 1), _cut(lin.bias, sl, 0))
    return QuantLinear(_cut(lin.packed, sl, 1), _cut(lin.scales, sl, 1),
                       _cut(lin.mins, sl, 1), _cut(lin.bias, sl, 0),
                       lin.fmt, lin.group, lin.k, hi - lo, lin.source_type)


def _group(lin) -> int:
    """The scale group a row split must not cut (1 for a dense weight)."""
    base = lin.base if isinstance(lin, LoraLinear) else lin
    return base.group if isinstance(base, QuantLinear) else 1


def _rows(lin, lo: int, hi: int):
    """Input rows [lo, hi) of a linear, without its bias: (linear, bias).
    A quantized weight is cut at scale-group boundaries only (q4 keeps two
    rows a byte, in group-local order)."""
    if isinstance(lin, LoraLinear):
        base, bias = _rows(lin.base, lo, hi)
        return LoraLinear(base, _cut(lin.a, slice(lo, hi), 0), lin.b,
                          lin.scale), bias
    if isinstance(lin, DenseLinear):
        return DenseLinear(_cut(lin.weight, slice(lo, hi), 0)), lin.bias
    g = lin.group
    assert lo % g == 0 and hi % g == 0, (lo, hi, g)
    pk = slice(lo // 2, hi // 2) if lin.fmt == "q4" else slice(lo, hi)
    return QuantLinear(_cut(lin.packed, pk, 0),
                       _cut(lin.scales, slice(lo // g, hi // g), 0),
                       _cut(lin.mins, slice(lo // g, hi // g), 0), None,
                       lin.fmt, g, hi - lo, lin.n, lin.source_type), lin.bias


def row_split_ok(lin, tp: int) -> bool:
    """K splits into tp parts, each a whole number of scale groups."""
    k = lin.shape[0]
    return k % tp == 0 and (k // tp) % _group(lin) == 0


def _span(n: int, axis: Axis) -> tuple[int, int]:
    """This rank's [lo, hi) of ``n`` split evenly over ``axis``."""
    w = n // axis.size
    return axis.index * w, (axis.index + 1) * w


def _row_parallel(lin, axis: Axis):
    return RowParallelLinear(*_rows(lin, *_span(lin.shape[0], axis)), axis)


def _even_cols(lin, axis: Axis):
    return _cols(lin, *_span(lin.shape[1], axis))


# -- the plan -----------------------------------------------------------------

def _attn_split_ok(attn: dict, cfg, tp: int) -> bool:
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    vd = cfg.value_length or cfg.head_dim
    if nh % tp or nkv % tp or "sub_norm" in attn:
        return False
    if "q_norm" in attn and attn["q_norm"].shape[-1] == nh * cfg.head_dim:
        return False  # OLMo-2's QK norm runs across every head
    wo = attn["wo"]
    return wo.shape[0] == nh * vd and row_split_ok(wo, tp)


def _shard_attn(attn: dict, cfg, axis: Axis) -> dict:
    tp, m = axis.size, axis.index
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    vd = cfg.value_length or hd
    hl, kl = nh // tp, nkv // tp
    if "wqkv" in attn:
        wq, wk, wv = unfuse_linear(attn["wqkv"], list(attn["wqkv"].splits))
    else:
        wq, wk, wv = attn["wq"], attn["wk"], attn["wv"]
    q = _cols(wq, m * hl * hd, (m + 1) * hl * hd)
    k = _cols(wk, m * kl * hd, (m + 1) * kl * hd)
    v = _cols(wv, m * kl * vd, (m + 1) * kl * vd)
    out: dict[str, Any] = {}
    fused = fuse_linears([q, k, v])
    if fused is not None:
        out["wqkv"] = fused
    else:
        out.update(wq=q, wk=k, wv=v)
    out["wo"] = _row_parallel(attn["wo"], axis)
    for key in ("q_norm", "k_norm"):
        if key in attn:
            out[key] = attn[key]
    if "sinks" in attn:
        out["sinks"] = attn["sinks"][m * hl:(m + 1) * hl].contiguous()
    if "gate" in attn:
        out["gate"] = _even_cols(attn["gate"], axis)
    out["heads"] = (hl, kl, m * hl, nh)
    return out


def _dense_ffn_split_ok(ffn: dict, tp: int) -> bool:
    if "sub_norm" in ffn:
        return False  # BitNet's norm runs across every FFN column
    f = ffn["down"].shape[0]
    return f % tp == 0 and row_split_ok(ffn["down"], tp)


def _shard_dense_ffn(ffn: dict, axis: Axis, reduce: bool = True) -> dict:
    """gate/up by columns (re-fused), down by rows. ``reduce`` False keeps
    down a plain row shard (of a down with no bias), so that the MoE layer
    sums it with the routed experts in one all_reduce."""
    out = {key: v for key, v in ffn.items()
           if key not in ("gate_up", "gate", "up", "down")}
    if "gate_up" in ffn:
        gate, up = unfuse_linear(ffn["gate_up"], list(ffn["gate_up"].splits))
    else:
        gate, up = ffn.get("gate"), ffn["up"]
    up = _even_cols(up, axis)
    if gate is not None:
        gate = _even_cols(gate, axis)
        fused = fuse_linears([gate, up])
        if fused is not None:
            out["gate_up"] = fused
        else:
            out.update(gate=gate, up=up)
    else:
        out["up"] = up
    down = ffn["down"]
    out["down"] = (_row_parallel(down, axis) if reduce
                   else _rows(down, *_span(down.shape[0], axis))[0])
    return out


def _shard_moe(ffn: dict, axis: Axis) -> dict:
    """A rank's experts (E/tp of the stacks and their biases), the router
    and shared_gate whole, the shared expert split as a dense FFN whose
    down joins the routed sum's one all_reduce."""
    ex = ffn["experts"]
    e_num = ex["down"].shape[0]
    if e_num % axis.size:
        return ffn  # experts tp does not divide: the layer is replicated
    e0, e1 = _span(e_num, axis)
    sl = slice(e0, e1)

    def local(v):
        if isinstance(v, QuantExpertStack):
            return QuantExpertStack(_cut(v.packed, sl, 0),
                                    _cut(v.scales, sl, 0),
                                    _cut(v.mins, sl, 0), v.fmt, v.group,
                                    v.k, v.n)
        return _cut(v, sl, 0)

    out = dict(ffn, experts={key: local(v) for key, v in ex.items()},
               expert_range=(e0, e1), reduce=axis)
    shared = ffn.get("shared")
    if shared is not None and _dense_ffn_split_ok(shared, axis.size) and \
            getattr(shared["down"], "bias", None) is None:
        out["shared"] = _shard_dense_ffn(shared, axis, reduce=False)
        out["shared_split"] = True
    return out


def refuse_unplanned(params: dict) -> None:
    """Raise NotImplementedError for a model the plan has no split for:
    multi-head latent attention (DeepSeek-V2/V3), on which the JAX plan
    fails too (its attention has no wk/wv to split)."""
    if any("kv_a" in layer.get("attn", {}) for layer in params["layers"]):
        raise NotImplementedError(
            "multi-head latent attention (DeepSeek-V2/V3) has no sharding "
            "plan: the JAX plan fails on it too (its attention has no "
            "wk/wv to split)")


def shard_params(params: dict, cfg, mesh: Mesh) -> dict:
    """This rank's params under the plan (a new tree; the tensors it does
    not cut are the same objects). Every split is a contiguous copy."""
    refuse_unplanned(params)
    axis = mesh.model_axis
    tp = axis.size
    layers = params["layers"]
    attn_split = all(_attn_split_ok(layer["attn"], cfg, tp)
                     for layer in layers if "attn" in layer)
    out = dict(params)
    out["output"] = params.get("output")
    if out["output"] is not None and out["output"].shape[1] % tp == 0:
        out["output"] = GatheredLinear(_even_cols(out["output"], axis), axis)
    new_layers = []
    for layer in layers:
        nl = dict(layer)
        if "attn" in layer and attn_split:
            nl["attn"] = _shard_attn(layer["attn"], cfg, axis)
        ffn = layer.get("ffn")
        if ffn is not None:
            if "router" in ffn:
                nl["ffn"] = _shard_moe(ffn, axis)
            elif _dense_ffn_split_ok(ffn, tp):
                nl["ffn"] = _shard_dense_ffn(ffn, axis)
        new_layers.append(nl)
    out["layers"] = new_layers
    log.info("sharded for model rank %d/%d: attention %s, %d of %d FFNs "
             "split", axis.index, tp,
             "split by heads" if attn_split else "replicated",
             sum(nl.get("ffn") is not layer.get("ffn")
                 for nl, layer in zip(new_layers, layers)), len(layers))
    return out


def local_kv_heads(params: dict, cfg) -> int:
    """The KV heads of this rank's cache: the local ones of a split
    attention, else the model's cache heads."""
    for layer in params["layers"]:
        heads = layer.get("attn", {}).get("heads")
        if heads is not None:
            return heads[1]
    return cfg.cache_kv_heads


def expert_parallel(params: dict) -> bool:
    """Whether any MoE layer of ``params`` keeps a part of its experts."""
    return any("expert_range" in (layer.get("ffn") or {})
               for layer in params["layers"])


def to_device(obj, device):
    """``obj`` (a params tree) with every tensor moved to ``device``; the
    mesh axes inside it are kept as they are."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_device(v, device) for v in obj]
    if isinstance(obj, tuple):
        return tuple(to_device(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj
