"""Architectures that store attention's q, k and v as one attn_qkv tensor
(phi3, MPT, DBRX), built with numpy from a seed, through the port's loader
(``_split_qkv``) and forward against the JAX package's on the CPU; and
DBRX's pre-MoE norm, stored as attn_output_norm."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_gguf_tpu.engine.runner import ModelRunner as JRunner
from llama_gguf_tpu.gguf.constants import GGMLType
from llama_gguf_tpu.models.loader import load_model as jload_model

from fixtures import add_quant_tensor

from llama_gguf_tpu_torch.engine.runner import ModelRunner
from llama_gguf_tpu_torch.gguf.writer import GGUFWriter
from llama_gguf_tpu_torch.models.loader import load_model
from llama_gguf_tpu_torch.ops.linear import DenseLinear

torch.set_num_threads(1)

# vocab, hidden, layers, heads, kv heads, ffn, ctx (experts, top-k: DBRX)
DIMS = dict(vocab=96, hidden=64, layers=2, heads=4, kv=2, ffn=96, ctx=64,
            experts=4, topk=2)
# f32 through two layers with a reassociated product, relative to max |logit|
LOGIT_RTOL = 1e-3
TOKENS = [5, 17, 3, 88, 41, 9, 60, 23, 71, 2]


def write(path: str, arch: str, quant: GGMLType, seed: int = 0) -> dict:
    """A random-weight GGUF of ``arch`` with a combined attn_qkv tensor (no
    qkv bias: phi3, MPT and DBRX have none); ``quant`` for the 2D
    projections (qkv, o_proj, FFN, head). Returns the norms written, by
    tensor name."""
    c = DIMS
    rng = np.random.default_rng(seed)
    h, hd = c["hidden"], c["hidden"] // c["heads"]
    kv = c["heads"] if arch == "mpt" else c["kv"]
    w = GGUFWriter()
    w.add_metadata("general.architecture", arch)
    meta = [("embedding_length", h), ("block_count", c["layers"]),
            ("attention.head_count", c["heads"]),
            ("feed_forward_length", c["ffn"]),
            ("context_length", c["ctx"]), ("vocab_size", c["vocab"])]
    if arch != "mpt":
        meta.append(("attention.head_count_kv", kv))
    if arch == "dbrx":
        meta += [("expert_count", c["experts"]),
                 ("expert_used_count", c["topk"])]
    for key, val in meta:
        w.add_metadata(f"{arch}.{key}", val)
    if arch == "phi3":
        w.add_metadata(f"{arch}.attention.layer_norm_rms_epsilon", 1e-5)
    else:
        w.add_metadata(f"{arch}.attention.layer_norm_epsilon", 1e-5)
    if arch == "dbrx":
        w.add_metadata(f"{arch}.attention.clamp_kqv", 0.5)
    if arch != "mpt":
        w.add_metadata(f"{arch}.rope.freq_base", 10000.0)
    norms = {}

    def put(name, *shape, q=GGMLType.F32, offset=0.0, scale=0.3):
        arr = (rng.standard_normal(shape) * scale + offset).astype(np.float32)
        if name.endswith("norm.weight"):
            norms[name] = arr
        add_quant_tensor(w, name, arr, q)

    put("token_embd.weight", c["vocab"], h)
    for i in range(c["layers"]):
        p = f"blk.{i}"
        put(f"{p}.attn_norm.weight", h, offset=1.0, scale=0.1)
        put(f"{p}.attn_qkv.weight", (c["heads"] + 2 * kv) * hd, h, q=quant)
        put(f"{p}.attn_output.weight", h, c["heads"] * hd, q=quant)
        if arch == "dbrx":  # the pre-MoE norm, under DBRX's own name
            put(f"{p}.attn_output_norm.weight", h, offset=1.0, scale=0.1)
            put(f"{p}.ffn_gate_inp.weight", c["experts"], h)
            for key, shape in (("gate", (c["ffn"], h)), ("up", (c["ffn"], h)),
                               ("down", (h, c["ffn"]))):
                put(f"{p}.ffn_{key}_exps.weight", c["experts"], *shape)
            continue
        put(f"{p}.ffn_norm.weight", h, offset=1.0, scale=0.1)
        if arch == "phi3":
            put(f"{p}.ffn_gate.weight", c["ffn"], h, q=quant)
        put(f"{p}.ffn_up.weight", c["ffn"], h, q=quant)
        put(f"{p}.ffn_down.weight", h, c["ffn"], q=quant)
    put("output_norm.weight", h, offset=1.0, scale=0.1)
    put("output.weight", c["vocab"], h, q=quant)
    w.write_to_path(path)
    return norms


def logits_of(path: str, mode: str):
    """Both packages' logits [T, V] of TOKENS, one step from an empty
    cache, and the port's params."""
    t = len(TOKENS)
    jparams, jcfg, _ = jload_model(path, mode=mode)
    jr = JRunner(jparams, jcfg, max_batch=1, max_seq=DIMS["ctx"])
    want, _ = jr.step(jnp.asarray([TOKENS], jnp.int32),
                      jnp.asarray([list(range(t))], jnp.int32),
                      jnp.asarray([t], jnp.int32), jr.init_kv())
    params, cfg, _ = load_model(path, mode=mode, device="cpu")
    tr = ModelRunner(params, cfg, max_batch=1, max_seq=DIMS["ctx"],
                     device="cpu")
    got, _ = tr.step(torch.tensor([TOKENS], dtype=torch.int32),
                     torch.tensor([list(range(t))], dtype=torch.int32),
                     torch.tensor([t], dtype=torch.int32), tr.init_kv())
    return np.asarray(want[0]), got[0].numpy(), params


@pytest.mark.parametrize("mode", ["quant", "dequant"])
@pytest.mark.parametrize("quant", [GGMLType.F32, GGMLType.Q8_0],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("arch", ["phi3", "mpt", "dbrx"])
def test_combined_qkv_matches_jax(tmp_path, arch, quant, mode):
    """Logits of every position within 1e-3 of max |logit|; the combined
    tensor is split into dense q, k and v (whatever its type, as the JAX
    loader does), which fuse into one wqkv."""
    path = str(tmp_path / f"{arch}.gguf")
    write(path, arch, quant)
    want, got, params = logits_of(path, mode)
    assert got.shape == want.shape == (len(TOKENS), DIMS["vocab"])
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * scale)
    attn = params["layers"][0]["attn"]
    hd = DIMS["hidden"] // DIMS["heads"]
    kv = DIMS["heads"] if arch == "mpt" else DIMS["kv"]
    assert isinstance(attn["wqkv"], DenseLinear)
    assert attn["wqkv"].splits == (DIMS["heads"] * hd, kv * hd, kv * hd)


def test_split_qkv_rows_are_q_k_v(tmp_path):
    """The three DenseLinears hold the tensor's rows [q | k | v], each
    transposed to [K, N], as the JAX loader's _split_qkv gives them."""
    from llama_gguf_tpu_torch.gguf.reader import GGUFFile
    from llama_gguf_tpu_torch.models.loader import ModelLoader

    path = str(tmp_path / "phi3.gguf")
    write(path, "phi3", GGMLType.F32)
    loader = ModelLoader(GGUFFile.open(path), mode="quant", device="cpu")
    split = loader._split_qkv(1, loader.config)
    w = loader.dense("blk.1.attn_qkv.weight")
    hd = DIMS["hidden"] // DIMS["heads"]
    cuts = np.cumsum([0, DIMS["heads"] * hd, DIMS["kv"] * hd,
                      DIMS["kv"] * hd])
    for key, lo, hi in zip(("wq", "wk", "wv"), cuts, cuts[1:]):
        assert split[key].bias is None
        np.testing.assert_array_equal(split[key].weight.numpy(), w[lo:hi].T)


@pytest.mark.parametrize("mode", ["quant", "dequant"])
def test_dbrx_takes_the_attn_output_norm_fallback(tmp_path, mode):
    """DBRX has no ffn_norm: its pre-MoE norm is attn_output_norm, which the
    port once dropped (the FFN then ran on the unnormalised stream)."""
    path = str(tmp_path / "dbrx.gguf")
    norms = write(path, "dbrx", GGMLType.F32)
    params, _, gguf = load_model(path, mode=mode, device="cpu")
    for i, layer in enumerate(params["layers"]):
        assert f"blk.{i}.ffn_norm.weight" not in gguf.tensors
        np.testing.assert_array_equal(
            layer["ffn_norm"]["weight"].numpy(),
            norms[f"blk.{i}.attn_output_norm.weight"])


def test_mla_layers_still_raise(tmp_path):
    """MLA (DeepSeek-V2/V3) layers load now, with the JAX loader's
    tensors: no combined QKV is split or fused, the latent's projections
    kv_a and o_proj stay quantized, and attn_kv_b becomes the dense
    up-projections W_uk and W_uv (the BERT/T5 refusals stay,
    tests/test_torch_arch.py)."""
    from llama_gguf_tpu.models.loader import load_model as jload

    from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

    path = str(tmp_path / "dsv3.gguf")
    build_synthetic_gguf(path, preset="tiny-deepseek-v3", quant=GGMLType.Q4_K)
    params, cfg, _ = load_model(path, mode="quant", device="cpu")
    jparams, _, _ = jload(path, mode="quant")
    attn, jattn = params["layers"][0]["attn"], jparams["layers"][0]["attn"]
    assert sorted(attn) == sorted(jattn) == [
        "kv_a", "kv_a_norm", "q_a", "q_a_norm", "q_b", "w_uk", "w_uv", "wo"]
    for key in ("w_uk", "w_uv", "kv_a_norm", "q_a_norm"):
        np.testing.assert_array_equal(attn[key].numpy(),
                                      np.asarray(jattn[key]))
    assert not isinstance(attn["kv_a"], DenseLinear)
    assert (attn["kv_a"].k, attn["kv_a"].n) == (cfg.hidden_size,
                                                cfg.kv_lora_rank
                                                + cfg.rope.n_dims)