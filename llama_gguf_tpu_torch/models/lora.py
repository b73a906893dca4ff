"""LoRA runtime adapters: y += (x @ A) @ B * (alpha / r), loaded from GGUF
(port of llama_gguf_tpu/models/lora.py).

An adapter attaches by rewriting the params tree in place: each matching
linear is wrapped in an ops.linear.LoraLinear, whose base keeps its kernel
(the quantized products stay on kernels 1-2) while the low-rank term runs as
two float32 torch.matmul calls, as the JAX package computes it with jnp.dot
outside any Pallas kernel. A projection the loader fused (q|k|v into
"wqkv", gate|up into "gate_up") is split first, so an adapter on gate or up
takes that layer's FFN off the fused GLU kernel (kernel 3); after
``remove_lora`` the split base stays split, as in the JAX package.

A rewrite changes the tensors a captured CUDA graph reads by address:
``apply_lora`` and ``remove_lora`` take the runner that serves the params and
drop its graphs (``ModelRunner.reset_graphs``), so the next step captures
again on the new weights.

GGUF adapter layout (llama.cpp's convention): general.type = "adapter",
adapter.type = "lora", adapter.lora.alpha; per tensor the pair
``<base>.weight.lora_a`` [r, K] and ``<base>.weight.lora_b`` [N, r].
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..gguf.reader import GGUFFile
from ..ops.linear import DenseLinear, LoraLinear, unfuse_linear
from ..quant.dequant import dequantize

log = logging.getLogger(__name__)


@dataclass
class LoraAdapter:
    """Host-side adapter: base tensor name -> (A [K, r], B [r, N]) and its
    alpha."""

    name: str
    alpha: float
    tensors: dict[str, tuple[np.ndarray, np.ndarray]]

    @property
    def rank(self) -> int:
        if not self.tensors:
            return 0
        a, _ = next(iter(self.tensors.values()))
        return a.shape[1]

    @property
    def scale(self) -> float:
        r = self.rank
        return self.alpha / r if r else 1.0

    @classmethod
    def load_gguf(cls, path: str) -> "LoraAdapter":
        g = GGUFFile.open(path)
        try:
            gtype = g.metadata.get("general.type", "")
            atype = g.metadata.get("adapter.type", "")
            if gtype and gtype != "adapter" or (atype and atype != "lora"):
                raise ValueError(
                    f"{path}: not a LoRA adapter "
                    f"(general.type={gtype!r}, adapter.type={atype!r})")
            alpha = float(g.metadata.get("adapter.lora.alpha", 1.0))
            pairs: dict[str, dict[str, np.ndarray]] = {}
            for tname, info in g.tensors.items():
                m = re.match(r"(.+)\.weight\.lora_([ab])$", tname)
                if not m:
                    continue
                arr = dequantize(g.tensor_bytes(tname), info.ggml_type,
                                 shape=info.np_shape)
                pairs.setdefault(m.group(1), {})[m.group(2)] = arr
            tensors = {}
            for base, ab in pairs.items():
                if "a" not in ab or "b" not in ab:
                    log.warning("lora: %s missing a/b pair, skipped", base)
                    continue
                # llama.cpp stores delta = lora_b [N, r] @ lora_a [r, K];
                # the x @ W convention wants A [K, r], B [r, N]
                a = np.ascontiguousarray(ab["a"].T)
                b = np.ascontiguousarray(ab["b"].T)
                tensors[base] = (a.astype(np.float32), b.astype(np.float32))
            if not tensors:
                raise ValueError(f"{path}: no lora_a/lora_b tensor pairs")
            return cls(name=path, alpha=alpha, tensors=tensors)
        finally:
            g.close()


def _param_paths(num_layers: int) -> dict[str, tuple]:
    """GGUF base name -> path into the params tree. Expert stacks and a
    tied head (no "output" linear) have none."""
    paths: dict[str, tuple] = {"output": ("output",)}
    for i in range(num_layers):
        p = f"blk.{i}"
        paths[f"{p}.attn_q"] = ("layers", i, "attn", "wq")
        paths[f"{p}.attn_k"] = ("layers", i, "attn", "wk")
        paths[f"{p}.attn_v"] = ("layers", i, "attn", "wv")
        paths[f"{p}.attn_output"] = ("layers", i, "attn", "wo")
        paths[f"{p}.ffn_gate"] = ("layers", i, "ffn", "gate")
        paths[f"{p}.ffn_up"] = ("layers", i, "ffn", "up")
        paths[f"{p}.ffn_down"] = ("layers", i, "ffn", "down")
    return paths


def _get(params: dict, path: tuple):
    node: Any = params
    for k in path:
        if isinstance(node, dict) and k not in node:
            return None
        node = node[k]
        if node is None:
            return None
    return node


def _set(params: dict, path: tuple, value) -> None:
    node: Any = params
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def _unfuse_for(params: dict, path: tuple) -> None:
    """Split a loader-fused wqkv / gate_up so the adapter can wrap the
    projection it names (the inverse of the loader's fusion)."""
    if len(path) < 4:
        return
    node = _get(params, path[:-1])
    if not isinstance(node, dict):
        return
    if path[-1] in ("wq", "wk", "wv") and "wqkv" in node:
        wq, wk, wv = unfuse_linear(node["wqkv"], list(node["wqkv"].splits))
        node.update(wq=wq, wk=wk, wv=wv)
        del node["wqkv"]
    elif path[-1] in ("gate", "up") and "gate_up" in node:
        gate, up = unfuse_linear(node["gate_up"],
                                 list(node["gate_up"].splits))
        node.update(gate=gate, up=up)
        del node["gate_up"]


def apply_lora(params: dict, adapter: LoraAdapter,
               scale: float | None = None, runner=None) -> int:
    """Wrap matching linears in the params tree with LoraLinear (in place);
    an existing adapter on a linear is replaced. Returns the number of
    attached tensors. ``runner``: the ModelRunner serving ``params``, whose
    captured graphs are dropped. A runner over a mesh is refused: its
    ranks' params are shards, which ``EngineConfig.lora`` cuts the adapter
    for at load (parallel/sharding.py)."""
    if getattr(runner, "mesh", None) is not None:
        raise NotImplementedError(
            "attaching a LoRA adapter to a model served over a mesh: give it "
            "at load (EngineConfig.lora), where each rank cuts it along its "
            "shard (ROADMAP queue 3)")
    s = adapter.scale if scale is None else scale
    try:
        return _attach(params, adapter, s)
    finally:  # a failed attach may have rewritten some linears already
        if runner is not None:
            runner.reset_graphs()


def _attach(params: dict, adapter: LoraAdapter, s: float) -> int:
    paths = _param_paths(len(params["layers"]))
    attached = 0
    for base, (a, b) in adapter.tensors.items():
        path = paths.get(base)
        if path is None:
            log.warning("lora: no param mapping for %s, skipped", base)
            continue
        leaf = _get(params, path)
        if leaf is None:
            _unfuse_for(params, path)  # the loader may have fused them
            leaf = _get(params, path)
        if leaf is None:
            log.warning("lora: param %s missing in model, skipped", base)
            continue
        if isinstance(leaf, LoraLinear):
            leaf = leaf.base
        kk, nn = leaf.shape
        if a.shape[0] != kk or b.shape[1] != nn:
            raise ValueError(
                f"lora {base}: shape mismatch adapter ({a.shape[0]},"
                f"{b.shape[1]}) vs weight ({kk},{nn})")
        dev = (leaf.weight if isinstance(leaf, DenseLinear)
               else leaf.packed).device
        _set(params, path, LoraLinear(
            base=leaf, a=torch.from_numpy(a).to(dev),
            b=torch.from_numpy(b).to(dev), scale=float(np.float32(s))))
        attached += 1
    return attached


def remove_lora(params: dict, runner=None) -> int:
    """Detach all adapters (in place); returns the number removed. A split
    projection stays split. ``runner`` as in apply_lora."""
    if getattr(runner, "mesh", None) is not None:
        raise NotImplementedError(
            "detaching a LoRA adapter from a model served over a mesh "
            "(ROADMAP queue 3)")
    removed = 0
    for path in _param_paths(len(params["layers"])).values():
        leaf = _get(params, path)
        if isinstance(leaf, LoraLinear):
            _set(params, path, leaf.base)
            removed += 1
    if runner is not None:
        runner.reset_graphs()
    return removed
