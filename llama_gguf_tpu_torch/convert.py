"""Carry weights and KV caches across from the JAX package.

``params_from_numpy`` turns llama_gguf_tpu's params into the port's (decoder,
BERT and T5 trees alike: nested dicts, lists and tuples of the leaves
below); ``kv_from_numpy`` and ``kv_to_numpy`` carry a KV cache either way,
a T5 decoder cache ("k", "v" and the cross "ck", "cv") included. The
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

from .models.kv import POSITIONAL, RAW_DTYPES, byte_view
from .ops.linear import (DenseLinear, QuantEmbedding, QuantExpertStack,
                         QuantLinear)


def _tensor(a, device) -> torch.Tensor | None:
    """A numpy array as a tensor. The JAX package's bfloat16 and float8
    arrays come through numpy with ml_dtypes dtypes, which torch cannot
    read: their bits are carried over (models/kv.RAW_DTYPES), viewed as
    the torch dtype and moved to ``device``."""
    if a is None:
        return None
    a = np.array(a, copy=True)
    if a.dtype.name in RAW_DTYPES:
        bits, dtype = RAW_DTYPES[a.dtype.name]
        return torch.from_numpy(a.view(bits)).view(dtype).to(device)
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


_STATE = ("deltanet", "mamba")
_CROSS = ("ck", "cv")  # a T5 decoder cache's cross K/V: not positional


def kv_from_numpy(kv: dict, device="cpu") -> dict:
    """Convert a numpy-leaved llama_gguf_tpu KV cache of any format ({"k": L
    x [B, S, H, D], "v": ..., i8 and tq scales "k_scale"/"v_scale" L x [B,
    S, H], packed uint8 tq and qjl buffers, float8 arrays as ml_dtypes
    arrays, a ring's "k_swa"/"v_swa"/"swa_pos", and for a hybrid model
    "deltanet": L x {"S", "conv"} or "mamba": {"conv": L x ..., "ssm": L x
    ...}}, or a T5 decoder cache's "ck"/"cv": L x [B, S_enc, H, D]) to the
    port's layout, where every positional buffer carries one extra drop
    slot on axis 1 (models/kv.py): zeros, -1 for ``swa_pos``; the cross K/V
    come across as they are."""
    if not {"k", "v"} <= set(kv) <= set(POSITIONAL + _STATE + _CROSS):
        raise ValueError(f"kv_from_numpy: unknown cache keys {sorted(kv)}")

    def pad(a, fill):
        t = _tensor(a, device)
        slot = torch.full_like(byte_view(t[:, :1]), fill)
        return torch.cat([byte_view(t), slot], dim=1).view(t.dtype)

    out = {key: [pad(a, -1 if key == "swa_pos" else 0) for a in kv[key]]
           for key in POSITIONAL if key in kv}
    for key in _CROSS:
        if key in kv:
            out[key] = [_tensor(a, device) for a in kv[key]]
    if "deltanet" in kv:
        out["deltanet"] = [{key: _tensor(st[key], device)
                            for key in ("S", "conv")} for st in kv["deltanet"]]
    if "mamba" in kv:
        out["mamba"] = {key: [_tensor(a, device) for a in kv["mamba"][key]]
                        for key in ("conv", "ssm")}
    return out


def kv_to_numpy(kv: dict) -> dict:
    """The port's cache as the JAX package's logical arrays: each
    positional buffer without its drop slot, [B, S, ...] on the host (bf16
    as its raw bits, uint16, and float8 as its raw bytes, uint8: numpy has
    neither), and a hybrid model's "deltanet" or "mamba" state as is. The
    reverse of ``kv_from_numpy``."""
    def host(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return byte_view(t).cpu().numpy()

    out = {key: [host(a[:, :-1]) for a in kv[key]]
           for key in POSITIONAL if key in kv}
    for key in _CROSS:
        if key in kv:
            out[key] = [host(a) for a in kv[key]]
    if "deltanet" in kv:
        out["deltanet"] = [{key: host(st[key]) for key in ("S", "conv")}
                           for st in kv["deltanet"]]
    if "mamba" in kv:
        out["mamba"] = {key: [host(a) for a in kv["mamba"][key]]
                        for key in ("conv", "ssm")}
    return out
