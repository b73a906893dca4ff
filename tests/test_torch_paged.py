"""The port's paged KV pool (models/paged.py) against the JAX package's on
the CPU: the allocator's free list and reference counts, appends and
gathers, copy-on-write forks. The same calls give the same block ids, the
same table lengths and bit-equal pool contents."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from llama_gguf_tpu.models import paged as JP

from llama_gguf_tpu_torch.models import paged as TP


def randn(*shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def pools(**kw):
    return (JP.PagedKVPool(**kw),
            TP.PagedKVPool(**kw, device="cpu"))


def same_pool(jp, tp) -> None:
    np.testing.assert_array_equal(tp.k.numpy(), np.asarray(jp.k))
    np.testing.assert_array_equal(tp.v.numpy(), np.asarray(jp.v))
    assert {s: (t.blocks, t.length) for s, t in tp.tables.items()} == \
        {s: (t.blocks, t.length) for s, t in jp.tables.items()}
    assert tp.allocator.free_blocks == jp.allocator.free_blocks
    assert tp.memory_bytes == jp.memory_bytes


def test_page_allocator_matches_jax():
    """JAX's test_page_allocator on both: the same ids in the same order,
    counts, and OutOfBlocksError when empty."""
    for mod in (JP, TP):
        a = mod.PageAllocator(3)
        b1, b2 = a.allocate(), a.allocate()
        assert (b1, b2, a.free_blocks) == (0, 1, 1)
        a.retain(b1)
        a.release(b1)
        assert a.free_blocks == 1
        a.release(b1)
        assert a.free_blocks == 2
        assert [a.allocate(), a.allocate()] == [0, 2]
        with pytest.raises(mod.OutOfBlocksError):
            a.allocate()
        assert a.ref_count(b2) == 1


def test_append_and_gather_match_jax():
    """Six appends across two blocks of 4: the same pool bytes, and the
    gather (static max_blocks, padded table) equals the JAX gather."""
    jp, tp = pools(num_layers=2, num_blocks=8, num_kv_heads=2, head_dim=4,
                   block_size=4)
    jp.create("s1")
    tp.create("s1")
    for i in range(6):
        t = randn(2, 2, 4, seed=i)
        jp.append("s1", jnp.asarray(t), jnp.asarray(t * 2))
        tp.append("s1", torch.from_numpy(t), torch.from_numpy(t * 2))
    same_pool(jp, tp)
    for nb in (None, 4):
        jk, jv, jn = jp.gather("s1", max_blocks=nb)
        tk, tv, tn = tp.gather("s1", max_blocks=nb)
        assert tn == jn == 6
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tk.shape == (2, 16, 2, 4)


def test_copy_on_write_matches_jax():
    """JAX's test_paged_copy_on_write: a fork shares its blocks until an
    append copies the shared tail; both diverge; freeing both returns every
    block. Every step's pool equals the JAX pool's."""
    jp, tp = pools(num_layers=1, num_blocks=8, num_kv_heads=1, head_dim=4,
                   block_size=4)
    for p in (jp, tp):
        p.create("a")
    for i in range(5):
        t = randn(1, 1, 4, seed=10 + i)
        jp.append("a", jnp.asarray(t), jnp.asarray(t))
        tp.append("a", torch.from_numpy(t), torch.from_numpy(t))
    free = tp.allocator.free_blocks
    jp.fork("a", "b")
    tp.fork("a", "b")
    assert tp.allocator.free_blocks == free
    same_pool(jp, tp)
    for seq, seed in (("a", 20), ("b", 21)):
        t = randn(1, 1, 4, seed=seed)
        jp.append(seq, jnp.asarray(t), jnp.asarray(t))
        tp.append(seq, torch.from_numpy(t), torch.from_numpy(t))
        same_pool(jp, tp)
    ka, _, _ = tp.gather("a", max_blocks=4)
    kb, _, _ = tp.gather("b", max_blocks=4)
    assert torch.equal(ka[:, :5], kb[:, :5])  # the shared prefix
    assert not torch.equal(ka[:, 5], kb[:, 5])
    for p in (jp, tp):
        p.free("a")
        p.free("b")
    assert tp.allocator.free_blocks == jp.allocator.free_blocks == 8


def test_pool_lives_on_its_device():
    """The tensors are made on the device given; CUDA asked for and absent
    raises rather than falling back to the CPU."""
    pool = TP.PagedKVPool(1, 2, 1, 4, block_size=2, dtype=torch.bfloat16,
                          device="cpu")
    assert pool.k.device.type == "cpu" and pool.k.dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TP.PagedKVPool(1, 2, 1, 4)
