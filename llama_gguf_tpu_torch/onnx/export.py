"""Write a GGUF decoder's weights as an HF-Optimum-style ONNX export, for
tests and chip_smoke.py: model.onnx (+ model.onnx_data with ``external``),
config.json and a Unigram tokenizer.json in one directory, all with
onnx/wire.py's writers.

The tensors take their HF names and layout ([out, in]); for a NORMAL-RoPE
architecture (llama) the q/k rows go back to HF's rotate-half order, which
onnx/loader.py permutes again on load, so the export loads to the GGUF's
own weights. Dense llama-family decoders (llama, qwen2) of F32 (or any
dequantizable) GGUFs.

    python -m llama_gguf_tpu_torch.onnx.export MODEL.gguf OUT_DIR
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..gguf.reader import GGUFFile
from ..models.config import RopeType, parse_config
from ..quant.dequant import dequantize
from .wire import node_proto, write_model

_HF_ARCH = {"llama": "LlamaForCausalLM", "qwen2": "Qwen2ForCausalLM"}
_LAYER_NAMES = {
    "attn_norm.weight": "input_layernorm.weight",
    "ffn_norm.weight": "post_attention_layernorm.weight",
    "attn_q.weight": "self_attn.q_proj.weight",
    "attn_q.bias": "self_attn.q_proj.bias",
    "attn_k.weight": "self_attn.k_proj.weight",
    "attn_k.bias": "self_attn.k_proj.bias",
    "attn_v.weight": "self_attn.v_proj.weight",
    "attn_v.bias": "self_attn.v_proj.bias",
    "attn_output.weight": "self_attn.o_proj.weight",
    "ffn_gate.weight": "mlp.gate_proj.weight",
    "ffn_up.weight": "mlp.up_proj.weight",
    "ffn_down.weight": "mlp.down_proj.weight",
}
SPM_SPACE = "▁"
# the Unigram vocabulary's pieces after <unk>, <s>, </s>: whole words
# score above their letters, so the Viterbi path takes them
_WORDS = ("hello", "world", "the", "quick", "brown", "fox", "jumps", "over",
          "lazy", "dog", "onnx", "model", "export")


def _unpermute(w: np.ndarray, n_head: int) -> np.ndarray:
    """GGUF's interleaved q/k rows -> HF's rotate-half rows (the inverse of
    the loader's permute_rows)."""
    out_dim = w.shape[0]
    rest = w.shape[1:]
    return (w.reshape(n_head, out_dim // n_head // 2, 2, *rest)
            .swapaxes(1, 2).reshape(out_dim, *rest))


def unigram_tokenizer_json(vocab: int) -> dict:
    """A Unigram + Metaspace tokenizer.json of ``vocab`` pieces: <unk>,
    <s>, </s> (special), the Metaspace space, lowercase letters, digits and
    punctuation with and without it, a few whole words, then fillers. Any
    lowercase ASCII text round-trips."""
    pieces = [["<unk>", 0.0], ["<s>", 0.0], ["</s>", 0.0], [SPM_SPACE, -3.0]]
    for c in "abcdefghijklmnopqrstuvwxyz0123456789.,!?'":
        pieces += [[c, -4.0], [SPM_SPACE + c, -4.5]]
    pieces += [[SPM_SPACE + w, -2.0] for w in _WORDS]
    while len(pieces) < vocab:
        pieces.append([f"<extra_{len(pieces)}>", -20.0])
    return {
        "version": "1.0",
        "added_tokens": [
            {"id": i, "content": c, "special": True}
            for i, c in enumerate(("<unk>", "<s>", "</s>"))],
        "normalizer": None,
        "pre_tokenizer": {"type": "Metaspace", "replacement": SPM_SPACE,
                          "prepend_scheme": "always", "split": True},
        "post_processor": None,
        "decoder": {"type": "Metaspace", "replacement": SPM_SPACE,
                    "prepend_scheme": "always", "split": True},
        "model": {"type": "Unigram", "unk_id": 0, "vocab": pieces[:vocab]},
    }


def export_gguf(gguf_path: str, out_dir: str, external: bool = False) -> str:
    """Export ``gguf_path`` into ``out_dir``; returns the model.onnx path."""
    g = GGUFFile.open(gguf_path)
    try:
        cfg = parse_config(g.metadata, g.tensors)
        arch = cfg.arch
        if arch not in _HF_ARCH:
            raise ValueError(f"export: no HF architecture for {arch!r}")

        def dense(name):
            info = g.tensors[name]
            return np.array(dequantize(g.tensor_bytes(name), info.ggml_type,
                                       shape=info.np_shape), np.float32)

        permute = cfg.rope.rope_type == RopeType.NORMAL
        tensors = {"model.embed_tokens.weight": dense("token_embd.weight"),
                   "model.norm.weight": dense("output_norm.weight")}
        if "output.weight" in g.tensors:
            tensors["lm_head.weight"] = dense("output.weight")
        for i in range(cfg.num_layers):
            for gname, hname in _LAYER_NAMES.items():
                name = f"blk.{i}.{gname}"
                if name not in g.tensors:
                    continue
                arr = dense(name)
                if permute and gname.startswith(("attn_q.", "attn_k.")):
                    heads = (cfg.num_heads if gname.startswith("attn_q.")
                             else cfg.num_kv_heads)
                    arr = _unpermute(arr, heads)
                tensors[f"model.layers.{i}.{hname}"] = arr
        hf = {
            "architectures": [_HF_ARCH[arch]], "model_type": arch,
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "max_position_embeddings": cfg.max_seq_len,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope.freq_base,
            "tie_word_embeddings": "lm_head.weight" not in tensors,
            "attention_bias": "blk.0.attn_q.bias" in g.tensors,
            "hidden_act": "silu",
        }
    finally:
        g.close()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "model.onnx")
    write_model(path, tensors,
                [node_proto("MatMul", "/model/layers.0/self_attn/q_proj/"
                            "MatMul", ["x", "model.layers.0.self_attn."
                                       "q_proj.weight"], ["y"])],
                external="model.onnx_data" if external else None)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    with open(os.path.join(out_dir, "tokenizer.json"), "w") as f:
        json.dump(unigram_tokenizer_json(cfg.vocab_size), f)
    return path


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    print(export_gguf(sys.argv[1], sys.argv[2]))
