"""Carry weights and KV caches across from the JAX package.

``params_from_numpy`` turns llama_gguf_tpu's params into the port's;
``kv_from_numpy`` and ``kv_to_numpy`` carry a KV cache either way. The
caller converts the JAX tree to numpy first (for example
``jax.tree_util.tree_map(np.asarray, params)``), so this module imports
nothing of JAX or of the JAX package: QuantLinear-, DenseLinear-,
QuantEmbedding- and QuantExpertStack-like leaves are recognised by their
attributes; every other array (norms, MLA's dense up-projections w_uk and
w_uv, DeepSeek-V3's router_bias, ...) becomes a tensor as it is.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .ops.linear import (DenseLinear, QuantEmbedding, QuantExpertStack,
                         QuantLinear)


def _tensor(a, device) -> torch.Tensor | None:
    """A numpy array as a tensor. The JAX package's bfloat16 arrays come
    through numpy with the ml_dtypes ``bfloat16`` dtype, which torch cannot
    read: their bits are carried over as uint16 and viewed as bfloat16."""
    if a is None:
        return None
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Convert a numpy-leaved llama_gguf_tpu params tree to the port's."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if hasattr(tree, "packed") and hasattr(tree, "vocab"):
        return QuantEmbedding(
            _tensor(tree.packed, device), _tensor(tree.scales, device),
            _tensor(tree.mins, device), fmt=tree.fmt, group=tree.group,
            vocab=tree.vocab, hidden=tree.hidden)
    if hasattr(tree, "packed") and not hasattr(tree, "splits"):
        return QuantExpertStack(
            _tensor(tree.packed, device), _tensor(tree.scales, device),
            _tensor(tree.mins, device), fmt=tree.fmt, group=tree.group,
            k=tree.k, n=tree.n)
    if hasattr(tree, "packed") and hasattr(tree, "splits"):
        return QuantLinear(
            _tensor(tree.packed, device), _tensor(tree.scales, device),
            _tensor(tree.mins, device), _tensor(tree.bias, device),
            fmt=tree.fmt, group=tree.group, k=tree.k, n=tree.n,
            source_type=tree.source_type, splits=tree.splits)
    if hasattr(tree, "weight") and hasattr(tree, "splits"):
        return DenseLinear(_tensor(tree.weight, device),
                           _tensor(tree.bias, device), splits=tree.splits)
    if isinstance(tree, np.ndarray):
        return _tensor(tree, device)
    if isinstance(tree, (int, float, str, bool)):
        return tree
    raise TypeError(f"params_from_numpy: unsupported leaf {type(tree).__name__}")


def kv_from_numpy(kv: dict, device="cpu") -> dict:
    """Convert a numpy-leaved f32/bf16 llama_gguf_tpu KV cache ({"k": L x
    [B, S, H, D], "v": ..., and for a hybrid model "deltanet": L x {"S",
    "conv"} or "mamba": {"conv": L x ..., "ssm": L x ...}}) to the port's
    layout, whose K/V buffers carry one extra drop slot each
    (models/kv.py)."""
    if not {"k", "v"} <= set(kv) <= {"k", "v", "deltanet", "mamba"}:
        raise NotImplementedError(
            f"kv_from_numpy: only plain f32/bf16 caches and recurrent state "
            f"are ported, got keys {sorted(kv)}")

    def pad(a):
        t = _tensor(a, device)
        return torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)

    out = {key: [pad(a) for a in kv[key]] for key in ("k", "v")}
    if "deltanet" in kv:
        out["deltanet"] = [{key: _tensor(st[key], device)
                            for key in ("S", "conv")} for st in kv["deltanet"]]
    if "mamba" in kv:
        out["mamba"] = {key: [_tensor(a, device) for a in kv["mamba"][key]]
                        for key in ("conv", "ssm")}
    return out


def kv_to_numpy(kv: dict) -> dict:
    """The port's f32/bf16 cache as the JAX package's logical arrays: each
    K/V buffer without its drop slot, [B, S, H, D] on the host (bf16 as
    its raw bits, uint16: numpy has no bfloat16), and a hybrid model's
    "deltanet" or "mamba" state as is. The reverse of ``kv_from_numpy``."""
    def host(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()

    out = {key: [host(a[:, :-1]) for a in kv[key]] for key in ("k", "v")}
    if "deltanet" in kv:
        out["deltanet"] = [{key: host(st[key]) for key in ("S", "conv")}
                           for st in kv["deltanet"]]
    if "mamba" in kv:
        out["mamba"] = {key: [host(a) for a in kv["mamba"][key]]
                        for key in ("conv", "ssm")}
    return out
