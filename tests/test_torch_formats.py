"""Every GGUF weight format the JAX package loads, in the port, against the
JAX package on the CPU: quantize bytes, dequantize values, repack and
repack_rows arrays; the plans of the q4 group-16 (Q2_K) and q8 group-256
(Q8_K) layouts on both paths of csrc/qgemm.cu; the plain products at those
layouts against the JAX Pallas kernels in interpret mode; a model per format
(greedy tokens and logits); the grid formats loading dense; and
gguf/requantize.py with the CLI's ``quantize``, byte for byte."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.gguf.constants import GGMLType, type_traits
from llama_gguf_tpu.gguf.requantize import QuantizeOptions as JOptions
from llama_gguf_tpu.gguf.requantize import quantize_model as jquantize_model
from llama_gguf_tpu.models.loader import ModelLoader as JLoader
from llama_gguf_tpu.models.loader import _QUANTIZED_KEEP as JKEEP
from llama_gguf_tpu.gguf.reader import GGUFFile as JFile
from llama_gguf_tpu.ops.linear import QuantExpertStack as JStack
from llama_gguf_tpu.ops.linear import QuantLinear as JQuantLinear
from llama_gguf_tpu.ops import qmatmul as JQ
from llama_gguf_tpu.quant import dequant as jdq
from llama_gguf_tpu.quant import quantize as jq
from llama_gguf_tpu.quant import repack as jrp
from llama_gguf_tpu.utils.synthetic import build_synthetic_gguf

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.convert import params_from_numpy
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.reader import GGUFFile
from llama_gguf_tpu_torch.gguf.requantize import QuantizeOptions
from llama_gguf_tpu_torch.gguf.requantize import quantize_model
from llama_gguf_tpu_torch.gguf.writer import GGUFWriter
from llama_gguf_tpu_torch.models.loader import _QUANTIZED_KEEP, ModelLoader
from llama_gguf_tpu_torch.ops import parity
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.ops.linear import (DenseLinear, QuantExpertStack,
                                             QuantLinear)
from llama_gguf_tpu_torch.quant import dequant as tdq
from llama_gguf_tpu_torch.quant import quantize as tq
from llama_gguf_tpu_torch.quant import repack as trp

torch.set_num_threads(1)

QUANT_TYPES = sorted(jq._QUANT, key=int)            # 17 types
KEEP = sorted(JKEEP, key=int)                       # 13 types
GRID = [GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ3_XXS,
        GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.IQ1_M]
PLAIN = [GGMLType.F64, GGMLType.I8, GGMLType.I16, GGMLType.I32,
         GGMLType.I64]
# the formats this slice adds to the loader's kept set (Q5_1, Q8_0, Q4_K and
# Q6_K: tests/test_torch_model.py)
NEW = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q2_K,
       GGMLType.Q3_K, GGMLType.Q5_K, GGMLType.Q8_K, GGMLType.IQ4_NL,
       GGMLType.IQ4_XS]
# the two layouts no format of the earlier slices had
NEW_LAYOUTS = [GGMLType.Q2_K, GGMLType.Q8_K]   # q4 group 16, q8 group 256
PROMPT = "The quick brown fox jumps over the lazy dog, again and again."
# f32 with a reassociated product, relative to max |y| (as phase 3 of
# chip_smoke.py) and to max |logit| (as tests/test_torch_arch.py)
REL = 2e-4
LOGIT_RTOL = 1e-3
SMS = 132  # an H100 SXM


def rnd(seed, *shape, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def grid_blocks(t: GGMLType, n_blocks: int, seed: int) -> np.ndarray:
    """Seeded random blocks of a grid format with a finite f16 scale d (the
    first two bytes of every block)."""
    size = type_traits(t).type_size
    raw = np.random.default_rng(seed).integers(
        0, 256, (n_blocks, size), dtype=np.uint8)
    d = np.random.default_rng(seed + 1).uniform(0.001, 0.05, n_blocks)
    raw[:, 0:2] = d.astype("<f2").view(np.uint8).reshape(n_blocks, 2)
    return raw.reshape(-1)


# -- quantize, dequantize, repack ---------------------------------------------


def test_the_loader_keeps_the_jax_set():
    assert _QUANTIZED_KEEP == set(JKEEP) and len(KEEP) == 13
    assert set(tq._QUANT) == set(jq._QUANT) and len(QUANT_TYPES) == 17
    assert set(tdq._DEQUANT) == set(jdq._DEQUANT)


@pytest.mark.parametrize("t", QUANT_TYPES, ids=lambda t: t.name)
def test_quantize_bytes_and_dequantize_values_match_jax(t):
    x = rnd(int(t), 6, 1024, scale=0.3)
    raw = tq.quantize(x, t)
    np.testing.assert_array_equal(raw, jq.quantize(x, t))
    np.testing.assert_array_equal(tdq.dequantize(raw, t),
                                  jdq.dequantize(raw, t))
    # a bulk tensor: the JAX package takes its native path from 64 KiB on
    big = tq.quantize(rnd(int(t) + 50, 256, 1024), t)
    assert big.nbytes >= 1 << 16
    np.testing.assert_array_equal(tdq.dequantize(big, t, (256, 1024)),
                                  jdq.dequantize(big, t, (256, 1024)))


@pytest.mark.parametrize("t", GRID + PLAIN, ids=lambda t: t.name)
def test_other_types_dequantize_like_jax(t):
    """The grid formats (blocks of seeded random bytes with finite f16
    scales; IQ1 decodes to zeros in both) and the plain F64 / integer
    types."""
    if t in GRID:
        raw = grid_blocks(t, 12, int(t))
    else:
        raw = np.random.default_rng(int(t)).integers(
            0, 256, 96 * type_traits(t).type_size, dtype=np.uint8)
        if t == GGMLType.F64:
            raw = rnd(5, 96).astype("<f8").view(np.uint8)
    want = jdq.dequantize(raw.copy(), t)
    got = tdq.dequantize(raw.copy(), t)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()
    if t in GRID[:5]:
        assert np.abs(got).max() > 0


@pytest.mark.parametrize("t", KEEP, ids=lambda t: t.name)
def test_repack_and_repack_rows_match_jax(t):
    n, k = 48, 1024
    raw = tq.quantize(rnd(int(t) + 9, n, k), t)
    a, b = jrp.repack(raw, t, (n, k)), trp.repack(raw, t, (n, k))
    assert (b.fmt, b.group, b.k, b.n, b.source_type) == (
        a.fmt, a.group, a.k, a.n, a.source_type)
    for key in ("packed", "scales", "mins"):
        want, got = getattr(a, key), getattr(b, key)
        assert (want is None) == (got is None)
        if want is not None:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    rows_a, rows_b = jrp.repack_rows(raw, t, (n, k)), trp.repack_rows(
        raw, t, (n, k))
    for want, got in zip(rows_a, rows_b):
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want


def test_unkept_types_still_raise_in_both():
    """A grid format has no kernel layout in either package."""
    raw = grid_blocks(GGMLType.IQ3_S, 8, 3)
    with pytest.raises(NotImplementedError):
        jrp.repack(raw, GGMLType.IQ3_S, (8, 256))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        trp.repack(raw, GGMLType.IQ3_S, (8, 256))


# -- the plans of the new layouts ---------------------------------------------

# (name, K, N, group, fmt, glu): TinyLlama-1.1B at Q2_K (q4 group 16) and at
# Q8_K (q8 group 256); Mixtral-8x7B's expert shapes at Q2_K
NEW_SHAPES = [("Q2_K qkv", 2048, 2560, 16, "q4", False),
              ("Q2_K o_proj", 2048, 2048, 16, "q4", False),
              ("Q2_K gate|up", 2048, 5632, 16, "q4", True),
              ("Q2_K expert gate", 4096, 14336, 16, "q4", False),
              ("Q2_K expert down", 14336, 4096, 16, "q4", False),
              ("Q8_K qkv", 2048, 2560, 256, "q8", False),
              ("Q8_K gate|up", 2048, 5632, 256, "q8", True),
              ("Q8_K ffn_down", 5632, 2048, 256, "q8", False),
              ("Q8_K lm_head", 2048, 32000, 256, "q8", False)]


@pytest.mark.parametrize("b", [1, 2, 4, 5, 8, 128, 512])
@pytest.mark.parametrize("name,k,n,group,fmt,glu", NEW_SHAPES,
                         ids=[s[0] for s in NEW_SHAPES])
def test_plan_at_the_new_layouts(name, k, n, group, fmt, glu, b):
    """Split-K below TC_MIN_ROWS rows, the tensor cores from there; the
    slices cover K in order, in whole units of the kernel's cut (split-K:
    units of 16 packed rows at q4 group 16 and of 32 at q8 group 256; tc:
    stages, or whole groups of 8 stages at group 256, 8 stages a slice at
    least)."""
    plan = Q.qmatmul_plan(b, k, n, group, fmt, SMS, glu=glu)
    assert plan.path == ("tc" if b >= Q.TC_MIN_ROWS else "splitk")
    units = Q.slice_units(k, group, fmt, plan.path)
    assert units == {("q4", "splitk"): k // 32, ("q8", "splitk"): k // 32,
                     ("q4", "tc"): k // 32, ("q8", "tc"): k // 256}[
                         (fmt, plan.path)]
    assert 1 <= plan.splits <= min(Q.MAX_SPLITS, units)
    cut = [(s * units // plan.splits, (s + 1) * units // plan.splits)
           for s in range(plan.splits)]
    assert all(lo < hi for lo, hi in cut)
    if plan.path == "tc" and group < 256:
        assert min(hi - lo for lo, hi in cut) >= 8 or plan.splits == 1
    cols = 64 if glu else 128
    assert plan.grid == (plan.splits, -(-b // plan.rows), -(-n // cols))
    if b == 1:
        assert plan.grid[0] * plan.grid[2] >= SMS


def test_moe_plans_at_q4_group_16():
    """Kernel 4 on split-K at 2 slots; kernels 5 and 6 on the tensor cores at
    256 slots (Mixtral-8x7B's expert shapes at Q2_K)."""
    assert Q.moe_slot_plan(2, 8, 4096, 14336, 16, "q4").path == "splitk"
    assert Q.moe_slot_plan(2, 8, 14336, 4096, 16, "q4").path == "splitk"
    assert Q.moe_grouped_plan(256, 8, 14336, 4096, 16, "q4").path == "tc"
    assert Q.moe_glu_grouped_plan(256, 8, 4096, 14336, 16, "q4").path == "tc"
    # ragged or unaligned stacks keep the CUDA-core grouped kernels
    assert Q.moe_grouped_plan(256, 8, 4096, 200, 16, "q4").path == \
        "cuda cores"


@pytest.mark.parametrize("fmt,group,k", [("q4", 8, 2048), ("q4", 48, 2064),
                                         ("q8", 24, 2064), ("q4", 16, 48)])
def test_a_layout_no_kernel_takes_still_raises(fmt, group, k):
    """q4 groups other than 16 and multiples of 32, q8 groups not a
    multiple of 16, and K not a whole number of split-K units."""
    with pytest.raises(ValueError):
        Q.qmatmul_plan(1, k, 2048, group, fmt)
    with pytest.raises(ValueError):
        Q.qmatmul_plan(8, k, 2048, group, fmt)


@pytest.mark.parametrize("group", [64, 128])
def test_q8_groups_no_format_writes_stay_on_split_k(group):
    """The tensor cores take q8 groups of 16, 32 and 256 (Q8_K) only; other
    groups of 16 rows' multiple run on split-K at every row count."""
    for rows in (1, 8, 512):
        assert Q.qmatmul_plan(rows, 2048, 2048, group, "q8").path == "splitk"


# -- the plain products at the new layouts against the Pallas kernels ---------


def both(t, n, k, seed, splits=None):
    raw = jq.quantize(rnd(seed, n, k), t)
    jr, tr = jrp.repack(raw, t, (n, k)), trp.repack(raw, t, (n, k))
    jl = JQuantLinear(jnp.asarray(jr.packed), jnp.asarray(jr.scales),
                      jnp.asarray(jr.mins) if jr.mins is not None else None,
                      None, jr.fmt, jr.group, k, n, t.name, splits)
    tl = QuantLinear(torch.from_numpy(tr.packed), torch.from_numpy(tr.scales),
                     torch.from_numpy(tr.mins) if tr.mins is not None
                     else None, None, tr.fmt, tr.group, k, n, t.name,
                     splits=splits)
    return jl, tl


def stacks(t, e_num, n, k, seed):
    raws = [jq.quantize(rnd(seed + e, n, k), t) for e in range(e_num)]
    rs = [trp.repack(r, t, (n, k)) for r in raws]
    has_mins = rs[0].mins is not None

    def arrays(put):
        return [put(np.stack([getattr(r, key) for r in rs]))
                if key != "mins" or has_mins else None
                for key in ("packed", "scales", "mins")]

    return (JStack(*arrays(jnp.asarray), rs[0].fmt, rs[0].group, k, n),
            QuantExpertStack(*arrays(torch.from_numpy), rs[0].fmt,
                             rs[0].group, k, n))


def close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=REL * np.abs(want).max())


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("t", NEW_LAYOUTS, ids=lambda t: t.name)
def test_plain_qmatmul_matches_pallas(t, b):
    jl, tl = both(t, 256, 1024, 70 + b)
    x = rnd(71, b, 1024, scale=1.0)
    assert (tl.fmt, tl.group) == {GGMLType.Q2_K: ("q4", 16),
                                  GGMLType.Q8_K: ("q8", 256)}[t]
    want = JQ.qmatmul(jnp.asarray(x), jl, interpret=True, precision="highest")
    close(Q.qmatmul(torch.from_numpy(x), tl), want)


@pytest.mark.parametrize("act", ["silu", "gelu", "swiglu_oai"])
@pytest.mark.parametrize("t", NEW_LAYOUTS, ids=lambda t: t.name)
def test_plain_glu_matches_pallas(t, act):
    jl, tl = both(t, 256, 1024, 72, splits=(128, 128))
    x = rnd(73, 6, 1024, scale=1.0)
    want = JQ.qmatmul_glu(jnp.asarray(x), jl, act, interpret=True,
                          precision="highest")
    assert want is not None
    close(Q.qmatmul_glu(torch.from_numpy(x), tl, act), want)


@pytest.mark.parametrize("s", [2, 40])
@pytest.mark.parametrize("t", NEW_LAYOUTS, ids=lambda t: t.name)
def test_plain_moe_products_match_pallas(t, s):
    """Slot-major at 2 slots, grouped (and the grouped GLU) at 40, over 4
    experts."""
    e_num, k, n = 4, 1024, 128
    js, ts = stacks(t, e_num, n, k, 74)
    ju, tu = stacks(t, e_num, n, k, 84)
    x = rnd(75 + s, s, k, scale=1.0)
    idx = (np.arange(s) * 3 % e_num).astype(np.int32)
    want = JQ.moe_qmatmul(jnp.asarray(x), js, jnp.asarray(idx),
                          interpret=True, precision="highest")
    close(Q.moe_qmatmul(torch.from_numpy(x), ts, torch.from_numpy(idx)),
          want)
    if s >= Q.MOE_GROUPED_MIN_SLOTS:
        want = JQ.moe_qmatmul_glu(jnp.asarray(x), js, ju, jnp.asarray(idx),
                                  "silu", interpret=True, precision="highest")
        close(Q.moe_qmatmul_glu(torch.from_numpy(x), ts, tu,
                                torch.from_numpy(idx), "silu"), want)


def test_parity_gates_raise_on_the_cpu(monkeypatch):
    """The gates never pass quietly where no kernel runs: weights on the
    CPU, or no card at all."""
    _, tl = both(GGMLType.Q2_K, 128, 256, 76)
    with pytest.raises(RuntimeError, match="no kernel"):
        parity.kernel_parity_check({"w": tl})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no kernel"):
        parity.moe_kernel_parity_check(GGMLType.Q2_K)


@pytest.mark.parametrize("t", [GGMLType.Q2_K, GGMLType.Q8_K, GGMLType.Q4_0],
                         ids=lambda v: v.name)
def test_expert_arrays_match_jax_repack(t):
    """ops/parity.expert_arrays (the gate's and chip_smoke's expert stacks):
    the JAX package's repack of the same seeded weights, stacked."""
    e_num, n, k = 3, 64, 512
    got = parity.expert_arrays(np.random.default_rng(5), t, e_num, k, n)
    rng = np.random.default_rng(5)
    rs = [jrp.repack(jq.quantize(rng.standard_normal((n, k), dtype=np.float32)
                                 * 0.1, t), t, (n, k)) for _ in range(e_num)]
    assert (got["fmt"], got["group"]) == (rs[0].fmt, rs[0].group)
    for field in ("packed", "scales", "mins"):
        if getattr(rs[0], field) is None:
            assert field not in got
        else:
            np.testing.assert_array_equal(
                got[field], np.stack([getattr(r, field) for r in rs]))


# -- a model per format -------------------------------------------------------


@pytest.fixture(scope="module", params=NEW, ids=lambda t: t.name)
def pair(request, tmp_path_factory):
    """The synthetic "small" preset (qwen2, hidden 256, 4 layers) at the
    format's mix: attention and gate/up in the format, ffn_down and the
    embedding and head in Q6_K; both packages in quant mode."""
    path = str(tmp_path_factory.mktemp("fmt") / f"{request.param.name}.gguf")
    build_synthetic_gguf(path, preset="small", quant=request.param)
    jeng = JEngine.load(path, JConfig(weight_mode="quant"))
    teng = Engine.load(path, EngineConfig(weight_mode="quant"), device="cpu")
    return request.param, jeng, teng


def test_model_per_format_matches_jax(pair):
    """The format's own layout loads quantized, and the port's greedy tokens
    and prefill logits equal the JAX package's (logits within 1e-3 of max
    |logit|)."""
    t, jeng, teng = pair
    layer = teng.runner.params["layers"][0]
    want = trp.repack(tq.quantize(rnd(1, 8, 256), t), t, (8, 256))
    for lin in (layer["attn"]["wqkv"], layer["ffn"]["gate_up"]):
        assert isinstance(lin, QuantLinear) and lin.source_type == t.name
        assert (lin.fmt, lin.group) == (want.fmt, want.group)
    ids = jeng.tokenizer.encode(PROMPT)
    want_logits = np.asarray(jeng.runner.prefill(ids,
                                                 jeng.runner.init_kv())[0])
    got = teng.runner.prefill(ids, teng.runner.init_kv())[0].numpy()
    scale = np.abs(want_logits).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want_logits, rtol=0,
                               atol=LOGIT_RTOL * scale)
    assert teng.greedy_tokens(ids, 12) == jeng.greedy_tokens(ids, 12)


def test_params_from_numpy_carry_each_format(pair):
    """The JAX package's repacked params, carried across, give the port's
    own logits (fmt and group come through)."""
    t, jeng, teng = pair
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jeng.runner.params))
    wqkv = params["layers"][0]["attn"]["wqkv"]
    own = teng.runner.params["layers"][0]["attn"]["wqkv"]
    assert (wqkv.fmt, wqkv.group, wqkv.source_type) == (
        own.fmt, own.group, own.source_type)
    assert torch.equal(wqkv.packed, own.packed)
    ids = jeng.tokenizer.encode(PROMPT)
    runner = teng.runner
    saved = runner.params
    try:
        runner.params = params
        got = runner.prefill(ids, runner._make_kv(1))[0]
    finally:
        runner.params = saved
    want = runner.prefill(ids, runner._make_kv(1))[0]
    assert torch.equal(got, want)


# -- the grid formats load dense ----------------------------------------------


def write_grid_model(path: str) -> dict:
    """A 1-layer llama GGUF whose FFN up weight is a grid format and whose
    other weights are F32 (the rest of the loader's path)."""
    h, f, v = 256, 512, 64
    rng = np.random.default_rng(8)
    w = GGUFWriter()
    for key, val in [("general.architecture", "llama"),
                     ("llama.embedding_length", h), ("llama.block_count", 1),
                     ("llama.attention.head_count", 4),
                     ("llama.attention.head_count_kv", 4),
                     ("llama.feed_forward_length", f),
                     ("llama.context_length", 64), ("llama.vocab_size", v),
                     ("llama.attention.layer_norm_rms_epsilon", 1e-5)]:
        w.add_metadata(key, val)
    raws = {}
    for t in GRID:
        raws[t] = grid_blocks(t, f * h // 256, int(t) + 20)
        w.add_tensor_raw(f"g_{t.name}.weight", (h, f), t, raws[t].tobytes())
    w.add_tensor_np("token_embd.weight", rnd(9, v, h))
    w.write_to_path(path)
    return raws


def test_grid_formats_load_dense_like_jax(tmp_path):
    path = str(tmp_path / "grid.gguf")
    write_grid_model(path)
    mine = ModelLoader(GGUFFile.open(path), mode="quant", device="cpu")
    theirs = JLoader(JFile.open(path), mode="quant")
    for t in GRID:
        got, want = (mine.linear(f"g_{t.name}"),
                     theirs.linear(f"g_{t.name}"))
        assert isinstance(got, DenseLinear)
        assert type(want).__name__ == "DenseLinear"
        np.testing.assert_array_equal(got.weight.numpy(),
                                      np.asarray(want.weight))


# -- requantize and the CLI's quantize ----------------------------------------


@pytest.mark.parametrize("target,weights_only", [
    (GGMLType.Q2_K, True), (GGMLType.Q8_K, True), (GGMLType.IQ4_XS, False),
    (GGMLType.Q4_0, False)], ids=lambda v: getattr(v, "name", str(v)))
def test_requantize_is_byte_identical(tmp_path, target, weights_only):
    src = str(tmp_path / "src.gguf")
    build_synthetic_gguf(src, preset="tiny", quant=GGMLType.F32)
    a, b = str(tmp_path / "jax.gguf"), str(tmp_path / "torch.gguf")
    ra = jquantize_model(src, a, JOptions(target=target,
                                          weights_only=weights_only))
    rb = quantize_model(src, b, QuantizeOptions(target=target,
                                                weights_only=weights_only))
    assert (rb.converted, rb.skipped, rb.fallback_f16, rb.out_bytes) == (
        ra.converted, ra.skipped, ra.fallback_f16, ra.out_bytes)
    assert rb.per_tensor == ra.per_tensor
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_cli_quantize_is_byte_identical(tmp_path, capsys):
    """``quantize IN OUT -t q3_k --all-tensors`` against the JAX CLI's."""
    from llama_gguf_tpu import cli as jcli

    src = str(tmp_path / "src.gguf")
    build_synthetic_gguf(src, preset="small", quant=GGMLType.Q8_0)
    a, b = str(tmp_path / "jax.gguf"), str(tmp_path / "torch.gguf")
    assert jcli.main(["quantize", src, a, "-t", "q3_k",
                      "--all-tensors"]) == 0
    assert cli.main(["quantize", src, b, "-t", "q3_k", "--all-tensors"]) == 0
    assert "converted" in capsys.readouterr().out
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    g = GGUFFile.open(b)
    try:
        assert g.tensors["blk.0.attn_q.weight"].ggml_type == GGMLType.Q3_K
    finally:
        g.close()
    assert os.path.getsize(b) < os.path.getsize(src)
