"""The KV-cache formats and the sliding-window ring on a card: each format's
write, read, shift and prompt-cache snapshot on CUDA against the same calls
on the CPU, the ring's writes and reads, float8_e4m3's NaN past 464, and
graphed steps of a tiny model in every format (and of tiny-gemma3 on its
ring) against eager ones.

Skipped on machines without CUDA. This file imports only the port, torch and
numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_kv_card.py

Tolerances: bytes equal for the f32, bf16, i8 and f8 writes and every
slide; tq and qjl levels and sign bits equal on >= 99.9% (the rotation's
[D, D] product sums in another order on the card), scales within 1e-6
relative; reads within 1e-5 of max |value|; graphed logits within 2e-4 of
max |logit| of eager ones, tokens equal."""

import numpy as np
import pytest
import torch

from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.prompt_cache import PromptCache
from llama_gguf_tpu_torch.engine.runner import ModelRunner
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.models import kv as KV
from llama_gguf_tpu_torch.models.config import ModelConfig, RopeConfig
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

FORMATS = list(KV.FORMATS)
PACKED = ("tq2", "tq3", "tq4", "qjl")
REL_LIMIT = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the KV formats' device path and CUDA "
                    "graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def both(fmt: str, **kw):
    """The same cache on the CPU and on the card."""
    return [KV.init_cache(2, 2, 16, 2, 64, fmt=fmt, device=d, **kw)
            for d in ("cpu", "cuda")]


def write_both(caches, fmt: str, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    pos = np.array([[0, 1, 2, 3, 99, 5], [6, 7, 8, 9, 10, 16]], np.int32)
    for layer in range(2):
        k, v = (torch.from_numpy(rng.normal(size=(2, 6, 2, 64)).astype(
            np.float32) * 3) for _ in range(2))
        for kv in caches:
            d = kv["k"][0].device
            KV.write(kv, layer, k.to(d), v.to(d), torch.from_numpy(pos).to(d))


def same(cpu: dict, card: dict, fmt: str, exact: bool = True) -> None:
    """The live positions of every buffer (the drop slot takes padding
    writes in any order and is never read)."""
    for key in cpu:
        for a, b in zip(cpu[key], card[key]):
            a, b = KV.byte_view(a)[:, :-1], KV.byte_view(b.cpu())[:, :-1]
            if fmt in PACKED and key in ("k", "v") and not exact:
                bits_a = np.unpackbits(a.numpy(), axis=-1)
                bits_b = np.unpackbits(b.numpy(), axis=-1)
                assert (bits_a == bits_b).mean() >= 0.999, key
            elif key.endswith("scale") and not exact:
                torch.testing.assert_close(b, a, rtol=1e-6, atol=0)
            else:
                assert torch.equal(a, b), key


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_write_and_read_match_cpu(cuda, fmt):
    """Writes (one position dropped) and reads, whole, bounded and gathered
    by rows, on the card equal the CPU's."""
    caches = both(fmt)
    write_both(caches, fmt)
    same(*caches, fmt, exact=False)
    if fmt == "qjl":
        return
    rows = torch.tensor([1, 0, 5], dtype=torch.int32)
    for bound, r in ((None, None), (8, None), (8, rows)):
        got = KV.read(caches[1], 1, head_dim=64, bound=bound,
                      rows=None if r is None else r.to(cuda))
        want = KV.read(caches[0], 1, head_dim=64, bound=bound, rows=r)
        for g, w in zip(got, want):
            err = (g.cpu() - w).abs().max().item()
            assert err <= 1e-5 * w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_shift_matches_cpu(cuda, fmt):
    """shift_left (a per-layer RoPE, row 1 alone and then every row) on the
    card's copy of the CPU cache's bytes: tq and qjl slide (the same
    bytes); f32 within 1e-5; bf16, i8 and f8 round the re-rotated keys
    (bytes equal on >= 99%, scales within 1e-5)."""
    cpu, card = both(fmt)
    write_both((cpu,), fmt)
    for key in cpu:
        for a, b in zip(cpu[key], card[key]):
            KV.byte_view(b).copy_(KV.byte_view(a).to(cuda))
    cfg = ModelConfig(arch="llama", num_layers=2, num_heads=2, num_kv_heads=2,
                      head_dim=64, rope=RopeConfig(n_dims=64),
                      nope_layer_interval=2)
    for row in (1, None):
        for kv in (cpu, card):
            KV.shift_left(kv, 3, batch_idx=row, model_cfg=cfg)
    if fmt in PACKED:
        same(cpu, card, fmt)
        return
    for key in cpu:
        for a, b in zip(cpu[key], card[key]):
            a, b = KV.byte_view(a)[:, :-1], KV.byte_view(b.cpu())[:, :-1]
            if a.dtype == torch.float32:
                torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
            else:  # a re-rotated key may round to the neighbouring value
                a, b = (t.view(torch.int16) if t.dtype == torch.bfloat16
                        else t for t in (a, b))
                assert (a == b).float().mean() >= 0.99, key


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["f32", "bf16", "f8_e4m3", "f8_e5m2"])
def test_ring_matches_cpu(cuda, fmt):
    """write_swa across a wrap, padding to the drop slot, read_swa, and
    zero_ (positions back to -1) on the card equal the CPU's."""
    caches = both(fmt, swa_layers=(True, False), ring_slots=8)
    rng = np.random.default_rng(1)
    for start in (0, 6):
        pos = torch.arange(start, start + 6, dtype=torch.int32)[None]
        pos = torch.cat([pos, torch.full_like(pos, 16)])
        k = torch.from_numpy(rng.normal(size=(2, 6, 2, 64)).astype(
            np.float32))
        for kv in caches:
            d = kv["k"][0].device
            KV.write_swa(kv, 0, k.to(d), (2 * k).to(d), pos.to(d), window=3)
    same(*caches, fmt)
    got = KV.read_swa(caches[1], 0)
    for g, w in zip(got, KV.read_swa(caches[0], 0)):
        assert torch.equal(g.cpu(), w)
    assert got[2][0].tolist() == [8, 9, 10, 11, 4, 5, 6, 7]
    for kv in caches:
        KV.zero_(kv)
    assert torch.all(caches[1]["swa_pos"][0] == -1)
    same(*caches, fmt)


@pytest.mark.cuda
def test_f8_e4m3_overflow_on_card(cuda):
    """The card writes the JAX package's NaN for |x| > 464 and +-inf, as
    the CPU does."""
    vals = torch.tensor([448, -448, 463.9, 464, 464.5, 500, -500,
                         float("inf"), float("-inf")])
    x = vals[None, :, None, None].expand(1, 9, 1, 8).contiguous()
    kv = KV.init_cache(1, 1, 9, 1, 8, fmt="f8_e4m3", device=cuda)
    KV.write(kv, 0, x.to(cuda), x.to(cuda),
             torch.arange(9, dtype=torch.int32, device=cuda)[None])
    got = KV.byte_view(kv["k"][0])[0, :9, 0, 0].cpu().tolist()
    assert got == [126, 254, 126, 126, 127, 127, 255, 127, 255]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_prompt_cache_on_card(cuda, fmt):
    """A snapshot of a card cache equals the CPU cache's (float8 as bytes,
    under the ml_dtypes name) and restores in place into a card cache."""
    caches = both(fmt)
    write_both(caches, fmt, seed=3)
    snaps = []
    for kv in caches:
        pc = PromptCache(min_prefix=2)
        pc.put([1, 2, 3, 4, 5], kv, batch_idx=1)
        snaps.append(next(iter(pc._entries.values())))
    assert snaps[0].dtypes == snaps[1].dtypes
    if fmt not in PACKED:
        for name, a in snaps[0].arrays.items():
            assert np.array_equal(a, snaps[1].arrays[name])
    dst = KV.init_cache(2, 2, 16, 2, 64, fmt=fmt, device=cuda)
    ptrs = [t.data_ptr() for t in dst["k"]]
    pc = PromptCache(min_prefix=2)
    pc._entries = {(1, 2, 3, 4, 5): snaps[1]}
    _, n = pc.restore([1, 2, 3, 4, 5, 6], dst, batch_idx=0)
    assert n == 5 and [t.data_ptr() for t in dst["k"]] == ptrs
    for key in dst:
        for a, b in zip(dst[key], caches[1][key]):
            assert torch.equal(KV.byte_view(a)[0, :5],
                               KV.byte_view(b)[1, :5])


def step_logits(runner, ids, steps: int, eager: bool):
    kv = runner._make_kv(1) if eager else runner.init_kv()
    logits, kv, pos = runner.prefill(ids, kv)
    toks, rows = [], []
    for i in range(steps):
        rows.append(logits.float())
        toks.append(int(torch.argmax(logits)))
        if i + 1 < steps:
            logits, kv = runner.decode_one(toks[-1], pos, kv)
            pos += 1
    return toks, rows


@pytest.fixture(scope="module")
def tiny_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("kvcard")
    return {name: build_synthetic_gguf(str(d / f"{name}.gguf"), preset=name,
                                       quant=GGMLType.Q4_K)
            for name in ("tiny", "tiny-gemma3")}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_graphs_match_eager_in_every_format(cuda, tiny_paths, fmt):
    """The tiny preset in each format: graphed prefill and decode steps (the
    scales and packed buffers captured like any other) against eager ones
    on a cache the runner did not make."""
    eng = Engine.load(tiny_paths["tiny"], EngineConfig(kv_format=fmt),
                      device="cuda")
    ids = list(range(3, 43))
    want_t, want = step_logits(eng.runner, ids, 12, eager=True)
    got_t, got = step_logits(eng.runner, ids, 12, eager=False)
    assert got_t == want_t
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= REL_LIMIT * w.abs().max()


@pytest.mark.cuda
def test_ring_graphs_match_eager_and_full(cuda, tiny_paths):
    """tiny-gemma3 on a ring of 256 slots (swa_ring_extra 128), a
    300-token prompt in chunks of 128 and 40 greedy steps: graphed against
    eager (swa_pos read and written in one captured step), and against the
    full cache."""
    eng = Engine.load(tiny_paths["tiny-gemma3"], EngineConfig(),
                      device="cuda")
    params, cfg = eng.runner.params, eng.runner.cfg
    ring = ModelRunner(params, cfg, max_seq=2048, swa_ring_extra=128,
                       device="cuda")
    full = ModelRunner(params, cfg, max_seq=2048, swa_ring=False,
                       device="cuda")
    assert ring.ring_slots == 256
    ids = [int(t) for t in np.random.default_rng(2).integers(3, 512, 300)]
    want_t, want = step_logits(ring, ids, 40, eager=True)
    got_t, got = step_logits(ring, ids, 40, eager=False)
    full_t, full_rows = step_logits(full, ids, 40, eager=False)
    assert got_t == want_t == full_t
    for g, w, f in zip(got, want, full_rows):
        assert (g - w).abs().max() <= REL_LIMIT * w.abs().max()
        assert (g - f).abs().max() <= 1e-5 * f.abs().max()
