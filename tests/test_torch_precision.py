"""The port's serving configuration (bf16 scale panels, "default" matmul
precision, bf16 KV cache) against the JAX package on the CPU.

In "default" precision the JAX package's fused kernels round their f32 sums to
bf16 once (qmatmul.py _out_dtype); its Pallas kernels run here in interpret
mode (ops.qmatmul.set_interpret, ops.linear.set_use_pallas), so both packages
round at the same places. The port's wrappers take their plain versions for
CPU tensors. Where the JAX entry declines a shape (ragged N), it takes its
f32 XLA path, and the port's bf16 output is held against that f32 value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import make_tiny_model

from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.engine.runner import ModelRunner as JRunner
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.models.loader import load_model as jload_model
from llama_gguf_tpu.ops import linear as JL
from llama_gguf_tpu.ops import qmatmul as JQ
from llama_gguf_tpu.quant.quantize import quantize
from llama_gguf_tpu.quant.repack import repack as jrepack
from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler
from llama_gguf_tpu.utils import synthetic as jsynthetic
from llama_gguf_tpu.utils.synthetic import build_synthetic_gguf

from llama_gguf_tpu_torch.convert import params_from_numpy
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.engine.runner import ModelRunner
from llama_gguf_tpu_torch.models.loader import ModelLoader, load_model
from llama_gguf_tpu_torch.gguf.reader import GGUFFile
from llama_gguf_tpu_torch.ops import qmatmul as Q
from llama_gguf_tpu_torch.ops.linear import (DenseLinear, QuantEmbedding,
                                             QuantExpertStack, QuantLinear,
                                             dequantize_weight,
                                             embedding_lookup)
from llama_gguf_tpu_torch.quant.repack import repack
from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig
from llama_gguf_tpu_torch.utils import synthetic as tsynthetic

torch.set_num_threads(1)

PROMPT = "The quick brown fox jumps over the lazy dog, again and again."
# Where a sum cancels to near zero, the f32 order of summation moves it by
# more than one bf16 ulp of the small result: the f32 tolerance of
# tests/test_torch_qmatmul.py covers that (values are of order 1).
F32_ATOL = 1e-4
GREEDY_STEPS = 8


@pytest.fixture
def jax_kernels():
    """The JAX package's fused kernels in interpret mode on the CPU."""
    JQ.set_interpret(True)
    JL.set_use_pallas(True)
    yield
    JQ.set_interpret(False)
    JL.set_use_pallas(None)


def assert_within_one_ulp(got: torch.Tensor, want):
    """The port's bf16 output against JAX's bf16 (or f32) one: both round
    the same f32 sums, taken in another order, once; they differ by at most
    one bf16 ulp of |want|, plus F32_ATOL."""
    assert got.dtype == torch.bfloat16
    g, w = got.float().numpy(), np.array(want, np.float32)
    assert g.shape == w.shape
    ulp = Q.bf16_ulp(torch.from_numpy(w)).numpy()
    excess = np.abs(g - w) - ulp
    assert excess.max() <= F32_ATOL, excess.max()


# -- kernels 1-6 in "default" against the Pallas kernels ----------------------


def make_pair(t, n, k, seed, splits=None):
    """The same weight in both packages, panels rounded to bf16 in each (as
    both loaders' scale_dtype="bfloat16" stores them)."""
    rng = np.random.default_rng(seed)
    raw = quantize(rng.standard_normal((n, k)).astype(np.float32) * 0.1, t)
    jr, tr = jrepack(raw, t, (n, k)), repack(raw, t, (n, k))

    def jbf(a):
        return jnp.asarray(a).astype(jnp.bfloat16) if a is not None else None

    def tbf(a):
        return (torch.from_numpy(a).to(torch.bfloat16) if a is not None
                else None)

    jl = JL.QuantLinear(jnp.asarray(jr.packed), jbf(jr.scales), jbf(jr.mins),
                        None, jr.fmt, jr.group, k, n, t.name, splits=splits)
    pl = QuantLinear(torch.from_numpy(tr.packed), tbf(tr.scales),
                     tbf(tr.mins), None, tr.fmt, tr.group, k, n, t.name,
                     splits=splits)
    return jl, pl


def make_x(b, k, seed):
    return np.random.default_rng(seed + 1).standard_normal(
        (b, k)).astype(np.float32)


# q4 with mins, q8 (group 16) without, q8 without, q8 with mins
FORMATS = [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0, GGMLType.Q5_1]


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("t", FORMATS, ids=lambda t: t.name)
def test_qmatmul_default_matches_pallas(t, b, n):
    """N = 200 is ragged: the JAX entry takes its f32 XLA path there."""
    jl, pl = make_pair(t, n, 512, 1)
    x = make_x(b, 512, 1)
    want = JQ.qmatmul(jnp.asarray(x), jl, interpret=True, precision="default")
    assert want.dtype == (jnp.bfloat16 if n % 128 == 0 else jnp.float32)
    got = Q.qmatmul(torch.from_numpy(x), pl, "default")
    assert got.shape == (b, n)
    assert_within_one_ulp(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q5_1],
                         ids=lambda t: t.name)
def test_qmatmul_glu_default_matches_pallas(t, act):
    f = 256
    jl, pl = make_pair(t, 2 * f, 512, 3, splits=(f, f))
    x = make_x(3, 512, 3)
    want = JQ.qmatmul_glu(jnp.asarray(x), jl, act, interpret=True,
                          precision="default")
    assert want.dtype == jnp.bfloat16
    assert_within_one_ulp(Q.qmatmul_glu(torch.from_numpy(x), pl, act,
                                        "default"), want)


def test_qmatmul_glu_default_ragged_f():
    """F = 96: the JAX entry declines; held against the JAX epilogue over
    its f32 XLA product."""
    f = 96
    jl, pl = make_pair(GGMLType.Q4_K, 2 * f, 256, 5, splits=(f, f))
    x = make_x(5, 256, 5)
    assert JQ.qmatmul_glu(jnp.asarray(x), jl, "silu", interpret=True,
                          precision="default") is None
    y = JL._apply_quant_xla(jnp.asarray(x), jl)
    want = JQ._glu_combine(y[:, :f], y[:, f:], "silu")
    assert_within_one_ulp(Q.qmatmul_glu(torch.from_numpy(x), pl, "silu",
                                        "default"), want)


E, K = 4, 256


def make_stacks(t, n=128, seed=17):
    """E experts in both packages, f32 panels (both loaders keep expert
    stacks in f32 whatever the scale_dtype)."""
    rng = np.random.default_rng(seed)
    raws = [quantize(rng.standard_normal((n, K)).astype(np.float32) * 0.1, t)
            for _ in range(E)]
    jr = [jrepack(r, t, (n, K)) for r in raws]
    tr = [repack(r, t, (n, K)) for r in raws]
    has_mins = jr[0].mins is not None

    def stack(rs, key, put):
        return put(np.stack([getattr(r, key) for r in rs]))

    js = JL.QuantExpertStack(
        stack(jr, "packed", jnp.asarray), stack(jr, "scales", jnp.asarray),
        stack(jr, "mins", jnp.asarray) if has_mins else None, jr[0].fmt,
        jr[0].group, K, n)
    ts = QuantExpertStack(
        stack(tr, "packed", torch.from_numpy),
        stack(tr, "scales", torch.from_numpy),
        stack(tr, "mins", torch.from_numpy) if has_mins else None,
        tr[0].fmt, tr[0].group, K, n)
    return js, ts


def make_idx(s):
    if s == 6:
        return np.array([0, 3, 1, 1, 2, 0], np.int32)
    idx = np.where(np.arange(s) % 2 == 0, 2,
                   np.random.default_rng(1).integers(0, E, size=s))
    idx[idx == 1] = 3
    return idx.astype(np.int32)


@pytest.mark.parametrize("s", [6, 45])
@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K],
                         ids=lambda t: t.name)
def test_moe_qmatmul_default_matches_pallas(t, s):
    """Slot-major (6 slots) and grouped (45) dispatch."""
    js, ts = make_stacks(t)
    x, idx = make_x(s, K, 7), make_idx(s)
    want = JQ.moe_qmatmul(jnp.asarray(x), js, jnp.asarray(idx),
                          interpret=True, precision="default")
    assert want.dtype == jnp.bfloat16
    assert_within_one_ulp(Q.moe_qmatmul(torch.from_numpy(x), ts,
                                        torch.from_numpy(idx), "default"),
                          want)


@pytest.mark.parametrize("s", [6, 45])
def test_moe_qmatmul_default_ragged_n(s):
    """N = 192, which the JAX entry declines: held against the einsum of its
    f32 gather_dequant."""
    js, ts = make_stacks(GGMLType.Q4_K, n=192)
    x, idx = make_x(s, K, 8), make_idx(s)
    assert JQ.moe_qmatmul(jnp.asarray(x), js, jnp.asarray(idx),
                          interpret=True, precision="default") is None
    want = np.einsum("sk,skn->sn", x,
                     np.asarray(js.gather_dequant(jnp.asarray(idx))))
    assert_within_one_ulp(Q.moe_qmatmul(torch.from_numpy(x), ts,
                                        torch.from_numpy(idx), "default"),
                          want)


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_moe_qmatmul_glu_default_matches_pallas(t):
    (jg, tg), (ju, tu) = make_stacks(t, seed=17), make_stacks(t, seed=18)
    x, idx = make_x(45, K, 9), make_idx(45)
    want = JQ.moe_qmatmul_glu(jnp.asarray(x), jg, ju, jnp.asarray(idx),
                              "silu", interpret=True, precision="default")
    assert want.dtype == jnp.bfloat16
    assert_within_one_ulp(Q.moe_qmatmul_glu(
        torch.from_numpy(x), tg, tu, torch.from_numpy(idx), "silu",
        "default"), want)


def test_unknown_precision_and_scale_dtype_raise(tmp_path):
    x = torch.zeros(1, 32)
    lin = QuantLinear(torch.zeros(16, 8, dtype=torch.uint8),
                      torch.zeros(1, 8), None, None, "q4", 32, 32, 8)
    with pytest.raises(ValueError, match="precision"):
        Q.qmatmul(x, lin, "high")
    with pytest.raises(ValueError, match="matmul_precision"):
        ModelRunner({}, None, matmul_precision="fastest", device="cpu")
    path = tsynthetic.build_synthetic_gguf(str(tmp_path / "m.gguf"),
                                           preset="tiny", quant=GGMLType.Q8_0)
    with pytest.raises(ValueError, match="scale_dtype"):
        ModelLoader(GGUFFile.open(path), device="cpu", scale_dtype="float16")


# -- the serving configuration, model level -----------------------------------

VARIANTS = {
    # make_tiny_model: Q4_K everywhere but the F32 table
    "llama-q4k": dict(arch="llama", quant=GGMLType.Q4_K),
    # quantized embedding (Q6_K), Q6_K LM head
    "small": dict(preset="small"),
    # sparse MoE: Q5_1 gate/up experts (q8 with mins), Q6_K down
    "tiny-moe": dict(preset="tiny-moe"),
    # sparse MoE: Q4_K gate/up experts over 8 experts
    "moe-h256": dict(preset="moe-h256"),
}
# (vocab, hidden, layers, heads, kv_heads, ffn, ctx, experts, topk), written
# by both packages' MoE builders and registered for the build only
TEST_MOE_PRESETS = {"moe-h256": (512, 256, 2, 4, 2, 512, 256, 8, 2)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def serving(request, tmp_path_factory):
    """A variant's GGUF loaded by both packages with bf16 panels: (path,
    JAX params, JAX config, port params, port config, prompt ids)."""
    path = str(tmp_path_factory.mktemp("s") / f"{request.param}.gguf")
    kw = VARIANTS[request.param]
    if "preset" in kw:
        with pytest.MonkeyPatch.context() as mp:
            for mod in (jsynthetic, tsynthetic):
                for name, geometry in TEST_MOE_PRESETS.items():
                    mp.setitem(mod.MOE_PRESETS, name, geometry)
            build_synthetic_gguf(path, preset=kw["preset"],
                                 quant=GGMLType.Q4_K)
    else:
        make_tiny_model(path, hidden=256, ffn=512, vocab=512, tokenizer=True,
                        **kw)
    jparams, jcfg, jgguf = jload_model(path, mode="quant",
                                       scale_dtype="bfloat16")
    tparams, tcfg, tgguf = load_model(path, device="cpu",
                                      scale_dtype="bfloat16")
    from llama_gguf_tpu_torch.tokenizer.gguf_tokenizer import Tokenizer

    ids = Tokenizer.from_gguf(tgguf.metadata).encode(PROMPT)
    return path, jparams, jcfg, tparams, tcfg, ids


def leaves(tree, prefix=""):
    """(path, leaf) of a params tree, dicts and lists walked."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_bf16_panel_layouts_match_jax(serving):
    """Both loaders round QuantLinear and QuantEmbedding panels to bf16 and
    keep expert stacks in f32; the port's panels are the JAX package's, bit
    for bit."""
    _, jparams, _, tparams, _, _ = serving
    jl = dict(leaves(jparams))
    kinds = set()
    for path, leaf in leaves(tparams):
        if not isinstance(leaf, (QuantLinear, QuantEmbedding,
                                 QuantExpertStack)):
            continue
        want_dtype = (torch.float32 if isinstance(leaf, QuantExpertStack)
                      else torch.bfloat16)
        kinds.add(type(leaf).__name__)
        j = jl[path]
        for key in ("scales", "mins"):
            got, want = getattr(leaf, key), getattr(j, key)
            if got is None:
                assert want is None, path
                continue
            assert got.dtype == want_dtype, (path, key)
            assert np.asarray(want).dtype.name == str(want_dtype)[6:]
            bits = (np.uint16 if want_dtype == torch.bfloat16
                    else np.uint32)
            np.testing.assert_array_equal(
                got.view(torch.int16 if bits is np.uint16 else torch.int32)
                .numpy().view(bits), np.asarray(want).view(bits))
    assert "QuantLinear" in kinds


def test_params_from_numpy_carries_bf16_panels(serving):
    """The JAX package's bf16 panels come through numpy as ml_dtypes
    bfloat16 and arrive as torch.bfloat16, equal to the port's loader's."""
    _, jparams, _, tparams, _, _ = serving
    converted = dict(leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")))
    n = 0
    for path, leaf in leaves(tparams):
        got = converted[path]
        if isinstance(leaf, (QuantLinear, QuantEmbedding, QuantExpertStack)):
            assert type(got) is type(leaf)
            for key in ("packed", "scales", "mins"):
                a, b = getattr(got, key), getattr(leaf, key)
                assert (a is None) == (b is None)
                if a is not None:
                    assert a.dtype == b.dtype and torch.equal(a, b), path
            n += leaf.scales.dtype == torch.bfloat16
        elif isinstance(leaf, DenseLinear):
            assert torch.equal(got.weight, leaf.weight)
    assert n > 0


def test_dequantize_upcasts_bf16_panels(serving):
    """dequantize_weight and embedding_lookup read bf16 panels as f32
    exactly: the same values as the panels upcast first."""
    _, _, _, tparams, _, _ = serving
    lin = tparams["layers"][0]["attn"]["wqkv"]
    up = QuantLinear(lin.packed, lin.scales.float(),
                     lin.mins.float() if lin.mins is not None else None,
                     None, lin.fmt, lin.group, lin.k, lin.n)
    assert lin.scales.dtype == torch.bfloat16
    assert torch.equal(dequantize_weight(lin), dequantize_weight(up))
    emb = tparams["embed"]
    if isinstance(emb, QuantEmbedding):
        toks = torch.arange(0, emb.vocab, 7)
        emb_up = QuantEmbedding(emb.packed, emb.scales.float(),
                                emb.mins.float() if emb.mins is not None
                                else None, emb.fmt, emb.group, emb.vocab,
                                emb.hidden)
        got = embedding_lookup(emb, toks)
        assert got.dtype == torch.float32
        assert torch.equal(got, embedding_lookup(emb_up, toks))


def runners(serving):
    _, jparams, jcfg, tparams, tcfg, _ = serving
    return (JRunner(jparams, jcfg, matmul_precision="default",
                    kv_format="bf16"),
            ModelRunner(tparams, tcfg, matmul_precision="default",
                        kv_format="bf16", device="cpu"))


def logit_tol(logits) -> float:
    """Both packages round each kernel output to bf16 at the same places;
    an f32 sum taken in another order lands on a neighbouring bf16 value now
    and then. The LM head's own flip moves a logit by one ulp of max |logit|;
    one more ulp covers what flips upstream carry into the logits."""
    return 2 * Q.bf16_ulp(torch.tensor(float(np.abs(logits).max()))).item()


def greedy(runner, ids, steps, to_np):
    """Greedy tokens of a prefill and steps - 1 decodes, with the logits
    each was chosen from."""
    logits, kv, pos = runner.prefill(ids, runner.init_kv())
    toks, rows = [], []
    for i in range(steps):
        rows.append(to_np(logits))
        toks.append(int(np.argmax(rows[-1])))
        if i + 1 < steps:
            logits, kv = runner.decode_one(toks[-1], pos, kv)
            pos += 1
    return toks, rows


def test_serving_prefill_logits_match_jax(serving, jax_kernels):
    ids = serving[-1]
    jr, tr = runners(serving)
    want = np.asarray(jr.prefill(ids, jr.init_kv())[0], np.float32)
    got = tr.prefill(ids, tr.init_kv())[0]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=logit_tol(want))


def test_serving_greedy_tokens_match_jax(serving, jax_kernels):
    """Eight greedy steps: each step's logits within the tolerance, and the
    same token. Where JAX's top-2 margin exceeds the tolerance a flip could
    only be a fault; where it does not (bf16 logits tie now and then) the
    port's token must still score within the tolerance of JAX's best."""
    ids = serving[-1]
    jr, tr = runners(serving)
    jt, jrows = greedy(jr, ids, GREEDY_STEPS,
                       lambda l: np.asarray(l, np.float32))
    tt, trows = greedy(tr, ids, GREEDY_STEPS, lambda l: l.numpy())
    for i, (a, b) in enumerate(zip(jrows, trows)):
        tol = logit_tol(a)
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)
        top = np.sort(a)[::-1]
        if top[0] - top[1] > tol:
            assert tt[i] == jt[i], i
        else:
            assert a[tt[i]] >= top[0] - tol, i
    assert tt == jt


def test_engine_default_same_text(serving, jax_kernels):
    """Engine.load with matmul_precision="default" (f32 panels) gives the
    JAX package's text."""
    path = serving[0]
    greedy_cfg = dict(temperature=0.0)
    jeng = JEngine.load(path, JConfig(weight_mode="quant",
                                      matmul_precision="default"))
    teng = Engine.load(path, EngineConfig(matmul_precision="default"),
                       device="cpu")
    assert teng.runner.matmul_precision == "default"
    want = jeng.generate(PROMPT, max_tokens=12, sampler=JSampler(**greedy_cfg))
    got = teng.generate(PROMPT, max_tokens=12,
                        sampler=SamplerConfig(**greedy_cfg))
    assert got == want
