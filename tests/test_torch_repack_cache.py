"""The port's repack sidecar (llama_gguf_tpu_torch/quant/repack_cache.py)
and the loader's use of it, on the CPU: a round trip; invalidation when the
GGUF's size or mtime or the format VERSION changes; an unwritable directory
is not fatal; a quant load from the sidecar equals a cold load bit for bit
(linear weights, expert stacks "<name>#j", the embedding's "@rows" and a
tied head's "@out"), at both scale dtypes; and the JAX package's sidecar:
every entry the port writes for a GGUF is array-equal to the entry the JAX
package writes, and each package loads from the other's file the tensors
of its own cold load."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from llama_gguf_tpu.models import loader as jloader_mod
from llama_gguf_tpu.quant import repack as jrepack_mod
from llama_gguf_tpu.quant import repack_cache as JRC

from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.models import loader as loader_mod
from llama_gguf_tpu_torch.models.loader import load_model
from llama_gguf_tpu_torch.quant import repack_cache as RC
from llama_gguf_tpu_torch.quant.repack import repack
from llama_gguf_tpu_torch.quant.quantize import quantize
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

torch.set_num_threads(1)

# tiny-moe: linear weights and expert stacks (an untied Q6_K head);
# tiny-tied: the embedding's rows and the tied head
PRESETS = ("tiny-moe", "tiny-tied")


@pytest.fixture(autouse=True)
def _cache_on(monkeypatch):
    monkeypatch.delenv("LLAMA_GGUF_NO_REPACK_CACHE", raising=False)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sidecar")
    return {p: build_synthetic_gguf(str(d / f"{p}.gguf"), preset=p,
                                    quant=GGMLType.Q4_K) for p in PRESETS}


def fresh(path, tmp_path, name="m.gguf"):
    """A copy of ``path`` (its mtime kept) with no sidecar."""
    out = str(tmp_path / name)
    shutil.copy2(path, out)
    return out


def same_tree(a, b, where="params"):
    """Two port params trees equal, bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{where}.{i}")
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            same_tree(getattr(a, f.name), getattr(b, f.name),
                      f"{where}.{f.name}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("room", ["header in place", "header too large"])
def test_round_trip(tmp_path, monkeypatch, room):
    """Entries come back array-equal, as aligned views of the file; the
    header goes into the room left before the data, or, when it does not
    fit there, ahead of a copy of the data (the JAX package's layout)."""
    if room == "header too large":
        monkeypatch.setattr(RC, "HEADER_ROOM", 128)
    gguf = tmp_path / "x.gguf"
    gguf.write_bytes(b"\0" * 100)
    rng = np.random.default_rng(0)
    rws = {f"w{t.name}": repack(quantize(rng.standard_normal(
        (64, 256)).astype(np.float32), t), t, (64, 256))
           for t in (GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0)}
    cache = RC.RepackCache(str(gguf))
    assert not cache.valid and cache.get("wQ4_K") is None
    for name, rw in rws.items():
        cache.put(name, rw)
    cache.flush()
    assert cache.valid and os.path.exists(RC.cache_path(str(gguf)))
    with open(RC.cache_path(str(gguf)), "rb") as f:
        f.seek(8)
        hlen = int.from_bytes(f.read(4), "little")
    assert ((12 + hlen + 63) // 64 * 64 == RC.HEADER_ROOM) == (
        room == "header in place")
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f or ".hdr" in f]
    again = RC.RepackCache(str(gguf))
    assert again.valid
    for name, rw in rws.items():
        got = again.get(name)
        for field in ("packed", "scales", "mins"):
            a, b = getattr(got, field), getattr(rw, field)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b)
                assert a.ctypes.data % 64 == 0  # aligned views of the file
        assert (got.fmt, got.group, got.k, got.n, got.source_type) == (
            rw.fmt, rw.group, rw.k, rw.n, rw.source_type)
    assert again.get("missing") is None


@pytest.mark.parametrize("change", ["size", "mtime", "version"])
def test_invalidation(tmp_path, monkeypatch, change):
    gguf = tmp_path / "x.gguf"
    gguf.write_bytes(b"\1" * 100)
    cache = RC.RepackCache(str(gguf))
    cache.put("w", repack(quantize(np.ones((32, 256), np.float32),
                                   GGMLType.Q4_K), GGMLType.Q4_K, (32, 256)))
    cache.flush()
    assert RC.RepackCache(str(gguf)).valid
    if change == "size":
        gguf.write_bytes(b"\1" * 101)
    elif change == "mtime":
        st = os.stat(gguf)
        os.utime(gguf, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    else:
        monkeypatch.setattr(RC, "VERSION", RC.VERSION + 1)
    assert not RC.RepackCache(str(gguf)).valid


def test_unwritable_directory_is_not_fatal(ggufs, tmp_path, monkeypatch):
    """Staging fails (as in a directory the loader cannot write): the load
    goes on, equal to a load without the sidecar, and writes nothing."""
    path = fresh(ggufs["tiny-moe"], tmp_path)

    def refuse(*args, **kwargs):
        raise PermissionError("read-only directory")

    monkeypatch.setattr(RC.tempfile, "mkstemp", refuse)
    got, _, _ = load_model(path, mode="quant", device="cpu")
    monkeypatch.setenv("LLAMA_GGUF_NO_REPACK_CACHE", "1")
    want, _, _ = load_model(path, mode="quant", device="cpu")
    same_tree(got, want)
    assert os.listdir(tmp_path) == ["m.gguf"]


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", PRESETS)
def test_sidecar_load_equals_cold_load(ggufs, tmp_path, monkeypatch, preset,
                                       scale_dtype):
    """The first quant load writes the sidecar; the second reads every
    repacked weight from it (repack and repack_rows refuse to run) and
    gives the cold load's params, bit for bit, at either scale dtype (the
    panels are cast after the sidecar). Dequant loads open no sidecar."""
    path = fresh(ggufs[preset], tmp_path)
    load_model(path, mode="dequant", device="cpu")
    assert not os.path.exists(RC.cache_path(path))
    cold, _, _ = load_model(path, mode="quant", device="cpu",
                            scale_dtype=scale_dtype)
    cache = RC.RepackCache(path)
    assert cache.valid
    keys = set(cache._index)
    if preset == "tiny-moe":
        assert {"blk.0.ffn_gate_exps.weight#0", "blk.1.ffn_down_exps.weight#3",
                "blk.0.attn_q.weight", "output.weight"} <= keys
    else:
        assert {"token_embd.weight@rows", "token_embd.weight@out"} <= keys

    def refuse(*args, **kwargs):
        raise AssertionError("repacked on a load from the sidecar")

    monkeypatch.setattr(loader_mod, "repack", refuse)
    monkeypatch.setattr(loader_mod, "repack_rows", refuse)
    warm, _, _ = load_model(path, mode="quant", device="cpu",
                            scale_dtype=scale_dtype)
    same_tree(warm, cold)
    other = "bfloat16" if scale_dtype == "float32" else "float32"
    load_model(path, mode="quant", device="cpu", scale_dtype=other)


def jax_leaves(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


@pytest.mark.parametrize("preset", PRESETS)
def test_sidecar_is_the_jax_packages(ggufs, tmp_path, monkeypatch, preset):
    """One GGUF, two copies with the same bytes and mtime: the JAX package
    writes the sidecar of one, the port of the other. Every entry is
    array-equal between the two files (same keys, dtypes, shapes, layout
    fields); the port loads from the JAX package's file, and the JAX
    package from the port's, with their repack functions refusing to run,
    and each gets its own cold load's tensors."""
    a = fresh(ggufs[preset], tmp_path, "jax.gguf")
    b = fresh(ggufs[preset], tmp_path, "torch.gguf")
    jcold, _, _ = jloader_mod.load_model(a, mode="quant")
    tcold, _, _ = load_model(b, mode="quant", device="cpu")
    jc, tc = JRC.RepackCache(a), RC.RepackCache(b)
    assert jc.valid and tc.valid
    assert (RC.MAGIC, RC.VERSION) == (JRC.MAGIC, JRC.VERSION)
    assert set(jc._index) == set(tc._index)
    for key in tc._index:
        want, got = jc.get(key), tc.get(key)
        assert (got.fmt, got.group, got.k, got.n) == (
            want.fmt, want.group, want.k, want.n), key
        assert got.source_type.name == str(want.source_type), key
        for field in ("packed", "scales", "mins"):
            g, w = getattr(got, field), getattr(want, field)
            assert (g is None) == (w is None), key
            if g is not None:
                assert g.dtype == w.dtype and np.array_equal(g, w), key

    # swap the sidecars: each package reads the other's file
    os.replace(RC.cache_path(a), str(tmp_path / "from_jax"))
    os.replace(RC.cache_path(b), RC.cache_path(a))
    os.replace(str(tmp_path / "from_jax"), RC.cache_path(b))

    def refuse(*args, **kwargs):
        raise AssertionError("repacked on a load from the sidecar")

    for mod in (loader_mod, jloader_mod, jrepack_mod):
        for fn in ("repack", "repack_rows"):
            if hasattr(mod, fn):
                monkeypatch.setattr(mod, fn, refuse)
    twarm, _, _ = load_model(b, mode="quant", device="cpu")
    same_tree(twarm, tcold)
    jwarm, _, _ = jloader_mod.load_model(a, mode="quant")
    for x, y in zip(jax_leaves(jwarm), jax_leaves(jcold), strict=True):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("arch", ["bert", "t5"])
def test_encoders_write_and_read_the_sidecar(tmp_path, monkeypatch, arch):
    """A deliberate difference: the port's BERT and T5 quant loads write
    the sidecar too (the JAX package's encoder loaders never flush it), and
    a second load reads it to the cold load's params, bit for bit."""
    from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
    from llama_gguf_tpu_torch.utils.synthetic import (build_synthetic_bert,
                                                      build_synthetic_t5)

    path = str(tmp_path / f"{arch}.gguf")
    if arch == "bert":
        build_synthetic_bert(path, hidden=64, ffn=128, quant=GGMLType.Q8_0)
    else:
        build_synthetic_t5(path, quant=GGMLType.Q8_0)

    def params():
        eng = Engine.load(path, EngineConfig(weight_mode="quant"),
                          device="cpu")
        return (eng.encoder if arch == "bert" else eng.t5).params

    cold = params()
    assert RC.RepackCache(path).valid

    def refuse(*args, **kwargs):
        raise AssertionError("repacked on a load from the sidecar")

    monkeypatch.setattr(loader_mod, "repack", refuse)
    same_tree(params(), cold)
