"""Paged KV cache: a block pool with per-sequence block tables and
copy-on-write forks (port of llama_gguf_tpu/models/paged.py).

A standalone component, as in the JAX package: the runner and the engines
keep one dense KV row per sequence and do not use it. It serves
many-sequence setups with shared prefixes. The pool is a pair of
[L, num_blocks, block_size, H_kv, D] tensors on an explicit device; blocks
are allocated on the host (``PageAllocator``: a free list and reference
counts), and a sequence's cache is gathered through its block table.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .loader import resolve_device

DEFAULT_BLOCK_SIZE = 16  # tokens per block


class OutOfBlocksError(RuntimeError):
    pass


class PageAllocator:
    """Free-list block allocator with reference counts."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._refs = np.zeros(num_blocks, np.int32)

    def allocate(self) -> int:
        if not self._free:
            raise OutOfBlocksError("no free KV blocks")
        b = self._free.pop()
        self._refs[b] = 1
        return b

    def retain(self, block: int) -> None:
        assert self._refs[block] > 0
        self._refs[block] += 1

    def release(self, block: int) -> None:
        assert self._refs[block] > 0
        self._refs[block] -= 1
        if self._refs[block] == 0:
            self._free.append(block)

    def ref_count(self, block: int) -> int:
        return int(self._refs[block])

    @property
    def free_blocks(self) -> int:
        return len(self._free)


@dataclass
class BlockTable:
    """One sequence's ordered block list and token count."""
    blocks: list[int] = field(default_factory=list)
    length: int = 0

    def padded(self, max_blocks: int) -> np.ndarray:
        out = np.zeros(max_blocks, np.int32)
        out[: len(self.blocks)] = self.blocks
        return out


class PagedKVPool:
    """Block pool and per-sequence tables with copy-on-write forking. The
    tensors live on ``device`` (CUDA unless the caller asks for the CPU);
    appends write one token at (layer, block, offset) in place."""

    def __init__(self, num_layers: int, num_blocks: int, num_kv_heads: int,
                 head_dim: int, block_size: int = DEFAULT_BLOCK_SIZE,
                 v_head_dim: int | None = None, dtype=torch.float32,
                 device="cuda"):
        vd = v_head_dim or head_dim
        self.device = resolve_device(device)
        self.block_size = block_size
        self.num_layers = num_layers
        self.allocator = PageAllocator(num_blocks)
        self.k = torch.zeros((num_layers, num_blocks, block_size,
                              num_kv_heads, head_dim), dtype=dtype,
                             device=self.device)
        self.v = torch.zeros((num_layers, num_blocks, block_size,
                              num_kv_heads, vd), dtype=dtype,
                             device=self.device)
        self.tables: dict[str, BlockTable] = {}

    # -- sequence lifecycle --------------------------------------------------

    def create(self, seq_id: str) -> BlockTable:
        t = BlockTable()
        self.tables[seq_id] = t
        return t

    def fork(self, src_id: str, dst_id: str) -> BlockTable:
        """Copy-on-write fork: share every block, bump its count."""
        src = self.tables[src_id]
        for b in src.blocks:
            self.allocator.retain(b)
        t = BlockTable(blocks=list(src.blocks), length=src.length)
        self.tables[dst_id] = t
        return t

    def free(self, seq_id: str) -> None:
        t = self.tables.pop(seq_id, None)
        if t:
            for b in t.blocks:
                self.allocator.release(b)

    # -- writes --------------------------------------------------------------

    def _writable_block(self, table: BlockTable) -> tuple[int, int]:
        """(block, offset) for the next token, allocating a block or copying
        a shared one first."""
        off = table.length % self.block_size
        if off == 0 and table.length == len(table.blocks) * self.block_size:
            table.blocks.append(self.allocator.allocate())
        blk = table.blocks[-1]
        if self.allocator.ref_count(blk) > 1:  # copy-on-write
            new = self.allocator.allocate()
            self.k[:, new] = self.k[:, blk]
            self.v[:, new] = self.v[:, blk]
            self.allocator.release(blk)
            table.blocks[-1] = new
            blk = new
        return blk, off

    def append(self, seq_id: str, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append one token's K/V: k/v [L, H_kv, D]."""
        table = self.tables[seq_id]
        blk, off = self._writable_block(table)
        self.k[:, blk, off] = k.to(self.device, self.k.dtype)
        self.v[:, blk, off] = v.to(self.device, self.v.dtype)
        table.length += 1

    # -- reads ---------------------------------------------------------------

    def gather(self, seq_id: str, max_blocks: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, int]:
        """A sequence's cache: ([L, max_blocks * bs, H, D] k, v, length).
        With a fixed ``max_blocks`` the shapes are static; positions >=
        length are the caller's to mask."""
        table = self.tables[seq_id]
        nb = max_blocks or len(table.blocks)
        idx = torch.from_numpy(table.padded(nb)).long().to(self.device)
        k = self.k.index_select(1, idx)  # [L, nb, bs, H, D]
        v = self.v.index_select(1, idx)
        n_layers, _, bs, h, d = k.shape
        return (k.reshape(n_layers, nb * bs, h, d),
                v.reshape(n_layers, nb * bs, h, v.shape[-1]), table.length)

    @property
    def memory_bytes(self) -> int:
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())
