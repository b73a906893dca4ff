"""Prompt cache: prefix-sharing KV snapshots with LRU eviction (port of
llama_gguf_tpu/engine/prompt_cache.py).

Snapshots are host numpy copies of one batch row of the per-layer
[B, S + 1, H, D] cache buffers (the device memory stays free), taken with
one host copy per cache key, and written back with ``copy_`` into the row of
the cache given: the runner's CUDA graphs replay the addresses they
captured, so a restore never rebinds a buffer. Prefill then continues from
the shared length.

numpy has no bfloat16 and no float8: a bf16 snapshot is kept as its raw 16
bits (uint16) and labelled "bfloat16", a float8 one as its raw bytes
(uint8) labelled "float8_e4m3fn" or "float8_e5m2", the ml_dtypes names the
JAX package writes. i8 and tq snapshots carry their scales (``k_scale``,
``v_scale``). The session file is the JAX package's format (``__meta__``
JSON and raw uint8 blobs), so a file saved by either package loads into the
other. A ring cache (``k_swa``...) is not positional as a whole, so, as in
the JAX package, models that use it bypass the prompt cache.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..models.kv import RAW_DTYPES, byte_view

BF16 = "bfloat16"
_NAME = {tdt: name for name, (_, tdt) in RAW_DTYPES.items()}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s raw bits as an integer tensor numpy can take (bf16: int16,
    float8: uint8); any other tensor as it is."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return byte_view(t)


def _host(layers: list[torch.Tensor]) -> tuple[np.ndarray, str]:
    """The layers stacked on the device, then one device-to-host copy:
    (the numpy array, its dtype's name); bf16 and float8 come back as their
    raw bits."""
    a = torch.stack([_bits(t) for t in layers]).cpu().numpy()
    name = _NAME.get(layers[0].dtype)
    if name is None:
        return a, str(a.dtype)
    return a.view(RAW_DTYPES[name][0]), name


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(RAW_DTYPES[name][0] if name in RAW_DTYPES else name)


def _host_bits(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A host snapshot as the tensor ``_bits`` gives of its cache buffer
    (bf16 as int16, float8 as uint8, others as they are)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int16) if dtype == BF16 else a)


@dataclass
class _Entry:
    tokens: tuple[int, ...]
    arrays: dict[str, np.ndarray]  # key -> [L, len(tokens), ...] host copy
    dtypes: dict[str, str]  # key -> dtype name (bfloat16, float8: raw bits)
    nbytes: int
    last_used: float = field(default_factory=time.monotonic)
    hits: int = 0


@dataclass
class PromptCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    stored: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PromptCache:
    """LRU cache of KV prefixes on host memory."""

    def __init__(self, max_bytes: int = 2 << 30, min_prefix: int = 8):
        self.max_bytes = max_bytes
        self.min_prefix = min_prefix
        self._entries: dict[tuple[int, ...], _Entry] = {}
        self._bytes = 0
        self.stats = PromptCacheStats()

    # -- store --------------------------------------------------------------

    # positional cache entries, indexed by sequence position. Recurrent
    # state ("deltanet", "mamba") is a running summary, not positional:
    # prefixes of it cannot be snapshotted, so hybrid models bypass the
    # prompt cache.
    _POSITIONAL_KEYS = ("k", "v", "k_scale", "v_scale")

    @classmethod
    def _cacheable(cls, kv: dict[str, Any]) -> bool:
        return all(name in cls._POSITIONAL_KEYS for name in kv)

    def put(self, tokens: list[int], kv: dict[str, Any],
            batch_idx: int = 0) -> None:
        """Snapshot the first len(tokens) positions of one batch row: the
        layers are stacked on the device, then copied to the host once per
        cache key."""
        key = tuple(tokens)
        if len(key) < self.min_prefix or key in self._entries or \
                not self._cacheable(kv):
            return
        t = len(key)
        arrays, dtypes = {}, {}
        for name, layers in kv.items():
            arrays[name], dtypes[name] = _host(
                [a[batch_idx, :t] for a in layers])
        nbytes = sum(a.nbytes for a in arrays.values())
        if nbytes > self.max_bytes:
            return
        self._evict_to(self.max_bytes - nbytes)
        self._entries[key] = _Entry(key, arrays, dtypes, nbytes)
        self._bytes += nbytes
        self.stats.stored += 1

    # -- lookup -------------------------------------------------------------

    def longest_prefix(self, tokens: list[int]) -> _Entry | None:
        """Longest cached entry that is a prefix of ``tokens``."""
        best: _Entry | None = None
        t = tuple(tokens)
        for key, entry in self._entries.items():
            n = len(key)
            if n <= len(t) and t[:n] == key:
                if best is None or n > len(best.tokens):
                    best = entry
        return best

    def restore(self, tokens: list[int], kv: dict[str, Any],
                batch_idx: int = 0) -> tuple[dict[str, Any], int]:
        """Restore the longest cached prefix into one batch row of ``kv``,
        in place.

        Returns (kv, shared_len); prefill should continue from shared_len.
        A full match restores len - 1, so the caller still has a last token
        to feed for logits. A snapshot that does not fit the row (another
        model's session file) raises."""
        if not self._cacheable(kv):
            return kv, 0
        entry = self.longest_prefix(tokens)
        if entry is None:
            self.stats.misses += 1
            return kv, 0
        n = len(entry.tokens)
        if n >= len(tokens):
            n = len(tokens) - 1
            if n <= 0:
                self.stats.misses += 1
                return kv, 0
        entry.last_used = time.monotonic()
        entry.hits += 1
        self.stats.hits += 1
        for name, host in entry.arrays.items():  # one host copy per key
            dev = _host_bits(host[:, :n], entry.dtypes[name]).to(
                kv[name][0].device)
            for layer, a in enumerate(kv[name]):  # bf16 and float8 as bits
                _bits(a)[batch_idx, :n].copy_(dev[layer])
        return kv, n

    # -- eviction -----------------------------------------------------------

    def _evict_to(self, budget: int) -> None:
        while self._bytes > max(budget, 0) and self._entries:
            lru_key = min(self._entries,
                          key=lambda k: self._entries[k].last_used)
            e = self._entries.pop(lru_key)
            self._bytes -= e.nbytes
            self.stats.evictions += 1

    def clear(self) -> None:
        self._entries.clear()
        self._bytes = 0

    @property
    def entry_count(self) -> int:
        return len(self._entries)

    @property
    def memory_bytes(self) -> int:
        return self._bytes

    # -- disk persistence (llama.cpp --prompt-cache session files) ----------

    def save(self, path: str) -> int:
        """Persist every entry to one .npz at exactly ``path``; returns the
        entry count. The file holds host snapshots only: it is model- and
        dtype-specific, like llama.cpp session files."""
        blobs: dict[str, np.ndarray] = {}
        meta = []
        for idx, (key, e) in enumerate(self._entries.items()):
            meta.append({
                "tokens": list(key), "hits": e.hits,
                "arrays": {name: {"dtype": e.dtypes[name],
                                  "shape": list(arr.shape)}
                           for name, arr in e.arrays.items()}})
            for name, arr in e.arrays.items():
                blobs[f"e{idx}.{name}"] = np.ascontiguousarray(arr).reshape(
                    -1).view(np.uint8)
        blobs["__meta__"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), np.uint8).copy()
        # through a file handle: np.savez(str) appends ".npz" to the name
        with open(path, "wb") as fh:
            np.savez(fh, **blobs)
        return len(meta)

    def load(self, path: str) -> int:
        """Merge entries from a save() file (the LRU budget still applies);
        returns how many entries were loaded."""
        loaded = 0
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
            for idx, m in enumerate(meta):
                key = tuple(m["tokens"])
                if key in self._entries:
                    continue
                dtypes = {name: info["dtype"]
                          for name, info in m["arrays"].items()}
                arrays = {
                    name: z[f"e{idx}.{name}"].view(
                        _np_dtype(info["dtype"])).reshape(info["shape"])
                    for name, info in m["arrays"].items()}
                nbytes = sum(a.nbytes for a in arrays.values())
                if nbytes > self.max_bytes:
                    continue
                self._evict_to(self.max_bytes - nbytes)
                if self._bytes + nbytes > self.max_bytes:
                    continue
                self._entries[key] = _Entry(key, arrays, dtypes, nbytes,
                                            hits=m["hits"])
                self._bytes += nbytes
                self.stats.stored += 1
                loaded += 1
        return loaded
