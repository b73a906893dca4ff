"""ONNX model loading: HF Optimum decoder exports -> the same params the GGUF
loader builds (port of llama_gguf_tpu/onnx/loader.py).

model.onnx (+ model.onnx_data) and config.json in one directory; the
initializers are parsed by onnx/wire.py, named back to their HF names (an
opaque ``onnx::MatMul_N`` through the node that consumes it), and given the
GGUF conventions the functional model expects: q/k rows permuted for
NORMAL-RoPE architectures, Gemma's norms with their +1. Every projection is
a dense f32 DenseLinear (ops/linear.py), run by torch.matmul in the
existing runner, as the JAX package runs them through XLA.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models.config import (
    Activation, ModelConfig, RopeConfig, RopeType, parse_config,
)
from ..models.architecture import resolve
from ..models.loader import resolve_device
from ..ops.linear import DenseLinear
from .wire import iter_fields, packed_varints, zigzag

log = logging.getLogger(__name__)

# ONNX TensorProto.DataType -> numpy
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
           6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
           11: np.float64, 12: np.uint32, 13: np.uint64}


class OnnxError(ValueError):
    pass


def _parse_tensor(buf, base_dir: str) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = 1
    name = ""
    raw = None
    floats: list[bytes] = []
    int64s: list[int] = []
    external: dict[str, str] = {}
    location = 0
    for field, wtype, val in iter_fields(buf):
        if field == 1:  # dims (repeated int64)
            if wtype == 0:
                dims.append(zigzag(val))
            else:
                dims.extend(zigzag(v) for v in packed_varints(val))
        elif field == 2:
            dtype = val
        elif field == 4:  # float_data
            floats.append(bytes(val) if wtype == 2 else val)
        elif field == 7:  # int64_data
            if wtype == 0:
                int64s.append(zigzag(val))
            else:
                int64s.extend(zigzag(v) for v in packed_varints(val))
        elif field == 8:
            name = bytes(val).decode()
        elif field == 9:
            raw = bytes(val)
        elif field == 13:  # external_data: StringStringEntryProto
            k = v = None
            for f2, _, val2 in iter_fields(val):
                if f2 == 1:
                    k = bytes(val2).decode()
                elif f2 == 2:
                    v = bytes(val2).decode()
            if k is not None:
                external[k] = v or ""
        elif field == 14:
            location = val
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        raise OnnxError(f"tensor {name!r}: unsupported data_type {dtype}")
    if location == 1 or (external and raw is None):  # EXTERNAL
        loc = external.get("location")
        if not loc:
            raise OnnxError(f"tensor {name!r}: external data without location")
        offset = int(external.get("offset", 0))
        length = int(external.get("length", 0))
        path = os.path.join(base_dir, loc)
        with open(path, "rb") as f:
            f.seek(offset)
            raw = f.read(length) if length else f.read()
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.frombuffer(b"".join(floats), dtype="<f4").astype(np_dtype)
    elif int64s:
        arr = np.asarray(int64s, dtype=np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def parse_onnx(path: str) -> tuple[dict[str, np.ndarray], list[dict]]:
    """Parse an .onnx file: returns (initializers by name, node list)."""
    data = Path(path).read_bytes()
    base_dir = os.path.dirname(os.path.abspath(path))
    graph = None
    for field, _, val in iter_fields(memoryview(data)):
        if field == 7:  # ModelProto.graph
            graph = val
    if graph is None:
        raise OnnxError(f"{path}: no graph in ModelProto")
    tensors: dict[str, np.ndarray] = {}
    nodes: list[dict] = []
    for field, _, val in iter_fields(graph):
        if field == 5:  # initializer
            name, arr = _parse_tensor(val, base_dir)
            tensors[name] = arr
        elif field == 1:  # node
            node = {"input": [], "output": [], "op_type": "", "name": ""}
            for f2, _, v2 in iter_fields(val):
                if f2 == 1:
                    node["input"].append(bytes(v2).decode())
                elif f2 == 2:
                    node["output"].append(bytes(v2).decode())
                elif f2 == 3:
                    node["name"] = bytes(v2).decode()
                elif f2 == 4:
                    node["op_type"] = bytes(v2).decode()
            nodes.append(node)
    return tensors, nodes


# -- HF config.json -> ModelConfig --------------------


def config_from_hf_json(cfg_path: str) -> ModelConfig:
    with open(cfg_path) as f:
        hf = json.load(f)
    arch = {"LlamaForCausalLM": "llama", "Qwen2ForCausalLM": "qwen2",
            "MistralForCausalLM": "llama", "Gemma2ForCausalLM": "gemma2",
            "Qwen3ForCausalLM": "qwen3", "Phi3ForCausalLM": "phi3",
            }.get((hf.get("architectures") or ["LlamaForCausalLM"])[0],
                  hf.get("model_type", "llama"))
    info = resolve(arch)
    heads = hf.get("num_attention_heads", 32)
    hidden = hf.get("hidden_size", 4096)
    head_dim = hf.get("head_dim", hidden // heads)
    return ModelConfig(
        arch=arch,
        vocab_size=hf.get("vocab_size", 32000),
        hidden_size=hidden,
        intermediate_size=hf.get("intermediate_size", 11008),
        num_layers=hf.get("num_hidden_layers", 32),
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=head_dim,
        max_seq_len=hf.get("max_position_embeddings", 2048),
        norm_eps=hf.get("rms_norm_eps", hf.get("layer_norm_eps", 1e-5)),
        rope=RopeConfig(
            freq_base=hf.get("rope_theta", 10000.0),
            n_dims=head_dim,
            rope_type=RopeType.NEOX if info.uses_neox_rope
            else RopeType.NORMAL,
        ),
        hidden_act=Activation.GELU if hf.get("hidden_act", "silu").startswith(
            "gelu") else Activation.SILU,
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        attention_bias=hf.get("attention_bias",
                              info.default_attention_bias),
        arch_info=info,
    )


# -- HF name mapping ----------------------------------------------------------------

_HF_LAYER_MAP = {
    "self_attn.q_proj": ("attn", "wq"),
    "self_attn.k_proj": ("attn", "wk"),
    "self_attn.v_proj": ("attn", "wv"),
    "self_attn.o_proj": ("attn", "wo"),
    "mlp.gate_proj": ("ffn", "gate"),
    "mlp.up_proj": ("ffn", "up"),
    "mlp.down_proj": ("ffn", "down"),
}


def _strip_hf_name(name: str) -> str:
    # slash-style node names ('/model/layers.0/self_attn/q_proj/MatMul')
    # normalize to dotted form BEFORE prefix/suffix stripping
    name = name.strip("/").replace("/", ".")
    name = name.removesuffix(".MatMul")
    for prefix in ("model.", "transformer.", "onnx::MatMul_"):
        if name.startswith(prefix):
            name = name[len(prefix):]
    return name


class OnnxModelLoader:
    """Builds the functional transformer params from an HF Optimum export
    (model.onnx [+ model.onnx_data] + config.json in one directory)."""

    def __init__(self, onnx_path: str, config_path: str | None = None,
                 device="cuda"):
        self.onnx_path = onnx_path
        self.device = resolve_device(device)
        d = os.path.dirname(os.path.abspath(onnx_path))
        self.config_path = config_path or os.path.join(d, "config.json")
        if not os.path.exists(self.config_path):
            raise OnnxError(f"missing HF config.json next to {onnx_path}")

    def load(self):
        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.array(a, np.float32)).to(self.device)

        cfg = config_from_hf_json(self.config_path)
        tensors, nodes = parse_onnx(self.onnx_path)
        named = self._resolve_names(tensors, nodes)

        # the runtime assumes GGUF-converted conventions; apply the same
        # transforms the HF->GGUF converter does:
        #  * NORMAL-rope archs (llama/mistral): q/k rows permuted
        #    rotate-half -> interleaved
        #  * gemma family: (1+w) norms stored with the +1 baked in
        info = cfg.arch_info
        permute_qk = info is not None and not info.uses_neox_rope
        norm_offset = 1.0 if (info is not None and info.is_gemma) else 0.0

        def permute_rows(w: np.ndarray, n_head: int) -> np.ndarray:
            out_dim = w.shape[0]
            rest = w.shape[1:]
            return (w.reshape(n_head, 2, out_dim // n_head // 2, *rest)
                    .swapaxes(1, 2).reshape(out_dim, *rest))

        def lin(key: str, transpose: bool = True,
                permute_heads: int = 0) -> DenseLinear | None:
            w = named.get(f"{key}.weight")
            if w is None:
                return None
            w = np.asarray(w, np.float32)
            b = named.get(f"{key}.bias")
            b = np.asarray(b, np.float32) if b is not None else None
            if permute_heads:
                w = permute_rows(w, permute_heads)
                if b is not None:
                    b = permute_rows(b, permute_heads)
            if transpose:  # HF stores [out, in]; we want [in, out]
                w = np.ascontiguousarray(w.T)
            return DenseLinear(put(w), put(b) if b is not None else None)

        params: dict[str, Any] = {}
        emb = named.get("embed_tokens.weight")
        if emb is None:
            raise OnnxError("embed_tokens.weight not found in ONNX graph")
        params["embed"] = put(emb)
        def norm(key: str):
            w = np.asarray(named[key], np.float32) + norm_offset
            return {"weight": put(w)}

        layers = []
        for i in range(cfg.num_layers):
            lp = f"layers.{i}"
            layer: dict[str, Any] = {
                "attn_norm": norm(f"{lp}.input_layernorm.weight"),
                "ffn_norm": norm(f"{lp}.post_attention_layernorm.weight"),
                "attn": {},
                "ffn": {},
            }
            for hf_key, (group, name) in _HF_LAYER_MAP.items():
                heads = 0
                if permute_qk and name == "wq":
                    heads = cfg.num_heads
                elif permute_qk and name == "wk":
                    heads = cfg.num_kv_heads
                l = lin(f"{lp}.{hf_key}", permute_heads=heads)
                if l is not None:
                    layer[group][name] = l
            qn = named.get(f"{lp}.self_attn.q_norm.weight")
            if qn is not None:
                layer["attn"]["q_norm"] = put(qn)
                layer["attn"]["k_norm"] = put(
                    named[f"{lp}.self_attn.k_norm.weight"])
            layers.append(layer)
        params["layers"] = layers
        cfg.layer_kinds = ("attn",) * cfg.num_layers
        params["final_norm"] = norm("norm.weight")
        out = lin("lm_head", transpose=True)
        if out is None and not cfg.tie_word_embeddings:
            cfg.tie_word_embeddings = True
        params["output"] = out
        return params, cfg

    @staticmethod
    def _resolve_names(tensors: dict[str, np.ndarray],
                       nodes: list[dict]) -> dict[str, np.ndarray]:
        """Normalize initializer names. HF Optimum sometimes renames MatMul
        weights to opaque ids (onnx::MatMul_123); recover the semantic name
        by tracing which node consumes them."""
        named: dict[str, np.ndarray] = {}
        for name, arr in tensors.items():
            named[_strip_hf_name(name)] = arr
        opaque = {n for n in tensors if n.startswith("onnx::")}
        if opaque:
            for node in nodes:
                if node["op_type"] not in ("MatMul", "Gemm"):
                    continue
                used = [i for i in node["input"] if i in opaque]
                if not used or not node["name"]:
                    continue
                sem = _strip_hf_name(node["name"])
                # MatMul B operands are [in, out]; store back in the HF
                # [out, in] layout so the uniform transpose below applies
                named[f"{sem}.weight"] = np.asarray(tensors[used[0]]).T
        return named


def load_onnx_model(path: str, device="cuda"):
    """Returns (params, cfg) for ModelRunner, on ``device``."""
    return OnnxModelLoader(path, device=device).load()
