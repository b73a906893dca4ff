"""The port's ONNX loader (onnx/wire.py, onnx/loader.py, onnx/export.py)
against the JAX package's on the CPU, after tests/test_onnx.py: inline and
external data, nodes, the missing-config error, opaque MatMul name
recovery; the port's params equal the JAX loader's bit for bit; Engine.load
of an .onnx export (with its tokenizer.json) gives JAX's greedy tokens and
the GGUF twin's."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from fixtures import make_tiny_model
from test_onnx import _node, _tensor_proto, build_onnx_fixture

from llama_gguf_tpu.engine.engine import Engine as JEngine
from llama_gguf_tpu.engine.engine import EngineConfig as JConfig
from llama_gguf_tpu.onnx.loader import OnnxModelLoader as JOnnxLoader
from llama_gguf_tpu.onnx.loader import load_onnx_model as jload_onnx
from llama_gguf_tpu.onnx.loader import parse_onnx as jparse_onnx

from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
from llama_gguf_tpu_torch.gguf.constants import GGMLType
from llama_gguf_tpu_torch.models.loader import load_model
from llama_gguf_tpu_torch.onnx import wire
from llama_gguf_tpu_torch.onnx.export import export_gguf
from llama_gguf_tpu_torch.onnx.loader import (OnnxError, OnnxModelLoader,
                                              load_onnx_model, parse_onnx)
from llama_gguf_tpu_torch.ops.linear import DenseLinear
from llama_gguf_tpu_torch.utils.synthetic import build_synthetic_gguf

torch.set_num_threads(1)

HF_CFG = {
    "architectures": ["Qwen2ForCausalLM"],
    "vocab_size": 128, "hidden_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 96, "max_position_embeddings": 64,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "attention_bias": True, "tie_word_embeddings": False,
}


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    d = tmp_path_factory.mktemp("onnx")
    gguf_path = str(d / "twin.gguf")
    weights = make_tiny_model(gguf_path, arch="qwen2", vocab=128, hidden=64,
                              layers=2, heads=4, kv_heads=2, ffn=96, ctx=64,
                              seed=5)
    return gguf_path, weights


def same_params(got, want, where="params"):
    """The port's params equal the JAX loader's (numpy) bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            same_params(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            same_params(a, b, f"{where}[{i}]")
    elif hasattr(want, "weight"):
        assert isinstance(got, DenseLinear), where
        same_params(got.weight, want.weight, f"{where}.weight")
        same_params(got.bias, want.bias, f"{where}.bias")
    elif want is None:
        assert got is None, where
    else:
        a, b = got.cpu().numpy(), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("external", [False, True],
                         ids=["inline", "external"])
def test_params_bit_equal_jax(twin, tmp_path, external):
    gguf_path, weights = twin
    path = build_onnx_fixture(str(tmp_path), weights, HF_CFG,
                              external=external)
    params, cfg = load_onnx_model(path, device="cpu")
    jparams, jcfg = jload_onnx(path)
    same_params(params, jax.tree_util.tree_map(np.asarray, jparams))
    assert (cfg.arch, cfg.num_layers, cfg.layer_kinds) == \
        (jcfg.arch, jcfg.num_layers, jcfg.layer_kinds)
    assert cfg.tie_word_embeddings == jcfg.tie_word_embeddings
    # and the GGUF twin's weights, as the loader builds them
    gparams, _, _ = load_model(gguf_path, mode="dequant", device="cpu")
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  gparams["embed"].numpy())


def test_parse_onnx_nodes(twin, tmp_path):
    _, weights = twin
    path = build_onnx_fixture(str(tmp_path), weights, HF_CFG)
    tensors, nodes = parse_onnx(path)
    jtensors, jnodes = jparse_onnx(path)
    assert nodes == jnodes
    assert any(n["op_type"] == "MatMul" for n in nodes)
    assert set(tensors) == set(jtensors)
    for name in tensors:
        np.testing.assert_array_equal(tensors[name], jtensors[name])


def test_missing_config_raises(tmp_path):
    p = tmp_path / "model.onnx"
    p.write_bytes(b"")
    with pytest.raises(OnnxError, match="config.json"):
        load_onnx_model(str(p), device="cpu")


def test_opaque_matmul_name_recovery(tmp_path):
    """Slash-style node names with onnx::MatMul_* initializers resolve to
    their semantic weight names, as in the JAX loader."""
    rng = np.random.default_rng(0)
    w_hf = rng.normal(size=(32, 64)).astype(np.float32)  # HF [out, in]
    path = wire.write_model(
        str(tmp_path / "m.onnx"), {"onnx::MatMul_123": w_hf.T},
        [wire.node_proto("MatMul", "/model/layers.0/self_attn/q_proj/MatMul",
                         ["x", "onnx::MatMul_123"], ["y"])])
    tensors, nodes = parse_onnx(path)
    named = OnnxModelLoader._resolve_names(tensors, nodes)
    assert "layers.0.self_attn.q_proj.weight" in named
    np.testing.assert_array_equal(named["layers.0.self_attn.q_proj.weight"],
                                  w_hf)
    jnamed = JOnnxLoader._resolve_names(*jparse_onnx(path))
    assert set(named) == set(jnamed)


def test_wire_writers_match_the_test_fixture(tmp_path):
    """The port's tensor_proto and node_proto write the bytes of
    tests/test_onnx.py's encoders (inline and external)."""
    arr = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    assert wire.tensor_proto("w", arr) == _tensor_proto("w", arr)
    assert wire.tensor_proto("w", arr, "d.bin", 64) == \
        _tensor_proto("w", arr, external="d.bin", offset=64)
    assert wire.node_proto("MatMul", "n", ["a", "b"], ["c"]) == \
        _node("MatMul", "n", ["a", "b"], ["c"])


@pytest.mark.parametrize("preset", ["tiny", "llama-tiny"])
def test_export_round_trips_the_gguf(tmp_path, preset):
    """onnx/export.py writes a GGUF's weights (a llama one with q/k rows
    in HF's order); the loader reads the GGUF's own params back, and the
    JAX loader the same."""
    gguf_path = str(tmp_path / "m.gguf")
    if preset == "tiny":
        build_synthetic_gguf(gguf_path, preset="tiny", quant=GGMLType.F32)
    else:
        make_tiny_model(gguf_path, arch="llama", vocab=96, hidden=64,
                        layers=2, heads=4, kv_heads=2, ffn=96, ctx=64, seed=3)
    path = export_gguf(gguf_path, str(tmp_path / "x"),
                       external=preset == "tiny")
    params, cfg = load_onnx_model(path, device="cpu")
    gparams, gcfg, _ = load_model(gguf_path, mode="dequant", device="cpu")
    for i in range(cfg.num_layers):
        g_attn = gparams["layers"][i]["attn"]
        q = params["layers"][i]["attn"]["wq"].weight
        np.testing.assert_array_equal(
            q.numpy(), g_attn["wqkv"].weight[:, :q.shape[1]].numpy())
    same_params(params, jax.tree_util.tree_map(np.asarray,
                                               jload_onnx(path)[0]))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    gguf_path = build_synthetic_gguf(str(d / "tiny.gguf"), preset="tiny",
                                     quant=GGMLType.F32)
    return gguf_path, export_gguf(gguf_path, str(d / "onnx"))


def test_engine_load_onnx_matches_jax_and_gguf(exported):
    gguf_path, path = exported
    eng = Engine.load(path, EngineConfig(weight_mode="dequant"), device="cpu")
    jeng = JEngine.load(path, JConfig(weight_mode="dequant"))
    geng = Engine.load(gguf_path, EngineConfig(weight_mode="dequant"),
                       device="cpu")
    ids = [5, 77, 300, 12, 9, 401]
    got = eng.greedy_tokens(ids, 12)
    assert got == jeng.greedy_tokens(ids, 12) == geng.greedy_tokens(ids, 12)
    text = "hello world the quick brown fox"
    assert eng.tokenizer.encode(text) == jeng.tokenizer.encode(text)
    assert eng.tokenizer.decode(eng.tokenizer.encode(text)) == text
    from llama_gguf_tpu.sampling.sampler import SamplerConfig as JSampler
    from llama_gguf_tpu_torch.sampling.sampler import SamplerConfig

    assert eng.generate(text, 8, SamplerConfig(temperature=0.7, seed=2)) == \
        jeng.generate(text, 8, JSampler(temperature=0.7, seed=2))


def test_export_config_json(exported):
    _, path = exported
    with open(os.path.join(os.path.dirname(path), "config.json")) as f:
        hf = json.load(f)
    assert hf["architectures"] == ["Qwen2ForCausalLM"]
    assert hf["num_hidden_layers"] == 2 and hf["attention_bias"]
