"""GGUF -> PyTorch params (port of llama_gguf_tpu/models/loader.py, dense
decoders of the llama and qwen2 families, architectures that store a
combined attn_qkv tensor (phi3, MPT, DBRX, GPT-2, Falcon, Bloom, ...),
Mixtral-style sparse MoE with optional shared experts, Qwen3Next's
DeltaNet layers, models/deltanet.py, the Mamba family, models/mamba.py:
Mamba-1, Mamba-2, Falcon-H1's parallel hybrid and LFM2's short conv, and
the DeepSeek family: multi-head latent attention and DeepSeek-V3's routing
bias, gpt-oss's per-expert biases), and T5 (models/t5.load_t5).
Encoder-only BERT-family models load through models/bert.load_bert, which
the engine calls, as in the JAX package.

The params are a plain dict of tensors, QuantLinear/DenseLinear leaves and
norm dicts, consumed by models/transformer.forward. Two weight modes:

  * "dequant": weights dequantized to f32 on the host (the oracle path;
               matmuls run as torch.matmul);
  * "quant":   matmul weights of the 13 block formats of _QUANTIZED_KEEP
               repacked to the kernel layouts (quant/repack.py) with scale
               panels in ``scale_dtype``, MoE experts as QuantExpertStacks
               (f32 panels); norms and biases stay dense; the embedding
               table stays quantized. Other types (the IQ grid formats,
               F16, ...) and combined QKV tensors load dense, as in the
               JAX package.

In "quant" mode every repack goes through the GGUF's repack sidecar
(quant/repack_cache.py) under the JAX package's keys: a matrix by its
tensor name, expert j of a stack as "<name>#j", the embedding's row layout
as "<name>@rows" and a tied head as "<name>@out". The scale panels are cast
to ``scale_dtype`` after it, so one sidecar serves both.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFFile
from ..ops.linear import (DenseLinear, QuantEmbedding, QuantExpertStack,
                          QuantLinear, fuse_linears)
from ..quant.dequant import dequantize
from ..quant.repack import RepackedWeight, repack, repack_rows
from ..quant.repack_cache import open_cache
from .config import Activation, ModelConfig, parse_config
from .mamba import load_mamba2_fields
from .transformer import RECURRENT_LAYERS

# formats kept quantized on the device (the ones quant/repack.py handles)
_QUANTIZED_KEEP = {
    GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
    GGMLType.Q8_0, GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K,
    GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q8_K, GGMLType.IQ4_NL,
    GGMLType.IQ4_XS,
}


def resolve_device(device) -> torch.device:
    """The device to load onto; CUDA requested and absent raises (no
    fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


class ModelLoader:
    def __init__(self, gguf: GGUFFile, mode: str = "quant",
                 device="cuda", scale_dtype: str = "float32"):
        """mode: "quant" keeps matmul weights in the kernel layouts;
        "dequant" materializes everything as dense f32 tensors.
        ``scale_dtype``: "bfloat16" rounds the scale and min panels of
        QuantLinear and QuantEmbedding weights to bf16 (half the panel
        bytes); expert stacks keep f32 panels, as in the JAX package.
        "float32" (default) is exact."""
        if mode not in ("quant", "dequant"):
            raise ValueError(f"unknown weight mode {mode!r}")
        if scale_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown scale_dtype {scale_dtype!r}")
        self.scale_dtype = getattr(torch, scale_dtype)
        self.gguf = gguf
        self.mode = mode
        self.device = resolve_device(device)
        self.config = parse_config(gguf.metadata, gguf.tensors)
        self.repack_cache = (open_cache(gguf.path) if mode == "quant"
                             and os.path.exists(gguf.path) else None)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:  # a view into the GGUF mmap
            arr = arr.copy()
        return torch.from_numpy(arr).to(self.device)

    # -- tensor access -------------------------------------------------------

    def has(self, name: str) -> bool:
        return name in self.gguf.tensors

    def dense(self, name: str) -> np.ndarray:
        """Dequantized f32 numpy tensor in np (row-major) shape."""
        info = self.gguf.tensors[name]
        return dequantize(self.gguf.tensor_bytes(name), info.ggml_type,
                          shape=info.np_shape)

    def norm(self, prefix: str, required: bool = True,
             unit_ok: bool = False) -> dict | None:
        wname = f"{prefix}.weight"
        if not self.has(wname):
            if unit_ok and self.config.non_parametric_norm:
                ones = np.ones(self.config.hidden_size, np.float32)
                return {"weight": self._put(ones)}
            if required:
                raise KeyError(f"missing tensor {wname}")
            return None
        out = {"weight": self._put(self.dense(wname))}
        bname = f"{prefix}.bias"
        if self.has(bname):
            out["bias"] = self._put(self.dense(bname))
        return out

    def _keep_quantized(self, name: str) -> bool:
        info = self.gguf.tensors[name]
        return (self.mode == "quant" and info.ggml_type in _QUANTIZED_KEEP
                and len(info.np_shape) == 2 and info.np_shape[1] % 32 == 0)

    def linear(self, name: str, bias_name: str | None = None,
               required: bool = True):
        """Load a matmul weight as DenseLinear or QuantLinear. GGUF stores W
        as [N_out, K_in] (np shape); the result is the [K, N] layout."""
        wname = f"{name}.weight"
        if not self.has(wname):
            if required:
                raise KeyError(f"missing tensor {wname}")
            return None
        info = self.gguf.tensors[wname]
        bias = None
        bname = bias_name or f"{name}.bias"
        if self.has(bname):
            bias = self._put(self.dense(bname).astype(np.float32))
        if self._keep_quantized(wname):
            rw = self._repack_cached(wname, lambda: repack(
                self.gguf.tensor_bytes(wname), info.ggml_type, info.np_shape))
            return self._quant_linear(rw, info.ggml_type.name, bias)
        w = self.dense(wname)
        if w.ndim != 2:
            raise ValueError(f"{wname}: expected 2D, got {w.shape}")
        # transposed where it lands (on the card, a copy at its memory rate)
        return DenseLinear(self._put(w).t().contiguous(), bias)

    def _repack_cached(self, key: str, compute) -> RepackedWeight:
        """The sidecar's entry ``key``, or ``compute()`` staged into it."""
        if self.repack_cache is not None:
            rw = self.repack_cache.get(key)
            if rw is not None:
                return rw
        rw = compute()
        if self.repack_cache is not None:
            self.repack_cache.put(key, rw)
        return rw

    def flush_repack_cache(self) -> None:
        """Write the sidecar a cold load staged (at the end of a load)."""
        if self.repack_cache is not None:
            self.repack_cache.flush()

    def _panel(self, arr: np.ndarray | None) -> torch.Tensor | None:
        """A scale or min panel on the device, in scale_dtype."""
        if arr is None:
            return None
        return self._put(arr).to(self.scale_dtype)

    def _quant_linear(self, rw, source_type: str, bias=None) -> QuantLinear:
        """Device-place a RepackedWeight as a QuantLinear (scale panels in
        scale_dtype)."""
        return QuantLinear(
            packed=self._put(rw.packed),
            scales=self._panel(rw.scales),
            mins=self._panel(rw.mins),
            bias=bias, fmt=rw.fmt, group=rw.group, k=rw.k, n=rw.n,
            source_type=source_type)

    # -- model building ------------------------------------------------------

    def layer_kind(self, i: int) -> str:
        """Classify layer i by tensor presence, as the JAX loader does:
        DeltaNet layers carry ssm_beta/ssm_ba (and ssm_a too, so those come
        first); ssm_a beside attention projections is Falcon-H1's parallel
        hybrid; Mamba-1 has ssm_x, Mamba-2 folds it into ssm_in."""
        p = f"blk.{i}"
        if self.has(f"{p}.ssm_beta.weight") or self.has(f"{p}.ssm_ba.weight"):
            return "deltanet"
        if self.has(f"{p}.ssm_a.weight") or self.has(f"{p}.ssm_a"):
            if self.has(f"{p}.attn_q.weight") or \
                    self.has(f"{p}.attn_qkv.weight"):
                return "hybrid_par"
            return "mamba" if self.has(f"{p}.ssm_x.weight") else "mamba2"
        if self.has(f"{p}.ssm_in.weight"):
            return "deltanet"
        if self.has(f"{p}.shortconv.in_proj.weight"):  # LFM2 conv blocks
            return "shortconv"
        return "attn"

    def load_layer(self, i: int, cfg: ModelConfig) -> dict:
        p = f"blk.{i}"
        kind = self.layer_kind(i)
        if kind in RECURRENT_LAYERS:
            return RECURRENT_LAYERS[kind][0](self, i, cfg)
        # "attn" and "hybrid_par" take the attention path; hybrid_par also
        # gets the Mamba-2 mixer's fields (Falcon-H1)
        layer: dict[str, Any] = {}
        attn_norm = self.norm(f"{p}.attn_norm", required=False, unit_ok=True)
        if attn_norm is not None:
            layer["attn_norm"] = attn_norm
        if self.has(f"{p}.attn_kv_a_mqa.weight"):  # MLA (DeepSeek-V2/V3)
            layer["attn"] = self._load_mla_attn(i, cfg)
        else:
            layer["attn"] = self._load_attn(i, cfg)

        ffn_norm = self.norm(f"{p}.ffn_norm", required=False, unit_ok=True)
        if ffn_norm is None:
            # DBRX stores its pre-MoE norm as attn_output_norm
            # (norm_attn_norm.norm_2 in HF, ATTN_OUT_NORM in llama.cpp)
            ffn_norm = self.norm(f"{p}.attn_output_norm", required=False)
        if ffn_norm is not None:
            layer["ffn_norm"] = ffn_norm
        layer["ffn"] = self._load_ffn(i, cfg)
        post_attn = self.norm(f"{p}.post_attention_norm", required=False)
        if post_attn is not None:
            layer["post_attn_norm"] = post_attn
        post_ffw = self.norm(f"{p}.post_ffw_norm", required=False)
        if post_ffw is not None:
            layer["post_ffn_norm"] = post_ffw
        if kind == "hybrid_par":
            layer["mamba"] = load_mamba2_fields(self, i, cfg)
        return layer

    def _load_attn(self, i: int, cfg: ModelConfig) -> dict:
        """Q/K/V (or a combined QKV), o_proj and the optional norms, sinks
        and output gate; q/k/v fused into one product where they can be."""
        p = f"blk.{i}"
        if self.has(f"{p}.attn_qkv.weight"):
            attn: dict[str, Any] = self._split_qkv(i, cfg)
        else:
            attn = {"wq": self.linear(f"{p}.attn_q"),
                    "wk": self.linear(f"{p}.attn_k"),
                    "wv": self.linear(f"{p}.attn_v")}
        attn["wo"] = self.linear(f"{p}.attn_output")
        for key, tname in (("q_norm", "attn_q_norm"), ("k_norm", "attn_k_norm"),
                           ("sinks", "attn_sinks"),
                           ("sub_norm", "attn_sub_norm")):
            if self.has(f"{p}.{tname}.weight"):
                attn[key] = self._put(self.dense(f"{p}.{tname}.weight"))
        if self.has(f"{p}.attn_gate.weight"):
            attn["gate"] = self.linear(f"{p}.attn_gate")
        self._fuse_attn(attn)
        return attn

    def _load_mla_attn(self, i: int, cfg: ModelConfig) -> dict:
        """Multi-head latent attention (DeepSeek-V2/V3), in the tensor names
        the JAX loader reads: attn_q_a, attn_q_a_norm and attn_q_b, or a
        dense attn_q; attn_kv_a_mqa [rank + rope, H] and attn_kv_a_norm;
        attn_kv_b [nh * (nope + v), rank], dequantized on the host whatever
        its type and split into the per-head up-projections W_uk [nh, nope,
        rank] and W_uv [nh, v, rank] of the absorbed attention
        (models/transformer.mla_attention); attn_output. Nothing is fused."""
        p = f"blk.{i}"
        attn: dict[str, Any] = {}
        if self.has(f"{p}.attn_q_a.weight"):
            attn["q_a"] = self.linear(f"{p}.attn_q_a")
            attn["q_a_norm"] = self._put(
                self.dense(f"{p}.attn_q_a_norm.weight"))
            attn["q_b"] = self.linear(f"{p}.attn_q_b")
        else:
            attn["wq"] = self.linear(f"{p}.attn_q")
        attn["kv_a"] = self.linear(f"{p}.attn_kv_a_mqa")
        attn["kv_a_norm"] = self._put(self.dense(f"{p}.attn_kv_a_norm.weight"))
        nope = cfg.head_dim - cfg.rope.n_dims
        kvb = self.dense(f"{p}.attn_kv_b.weight").reshape(
            cfg.num_heads, nope + (cfg.value_length or cfg.head_dim),
            cfg.kv_lora_rank)
        attn["w_uk"] = self._put(kvb[:, :nope])
        attn["w_uv"] = self._put(kvb[:, nope:])
        attn["wo"] = self.linear(f"{p}.attn_output")
        return attn

    def _split_qkv(self, i: int, cfg: ModelConfig) -> dict:
        """A combined QKV tensor (rows [q | k | v]) as three DenseLinears,
        dequantized whatever its type, as the JAX loader does."""
        p = f"blk.{i}"
        w = self.dense(f"{p}.attn_qkv.weight")  # [q+k+v rows, H]
        nq = cfg.num_heads * cfg.head_dim
        nkv = cfg.num_kv_heads * cfg.head_dim
        cuts = [nq, nq + nkv]
        bname = f"{p}.attn_qkv.bias"
        biases = (np.split(self.dense(bname), cuts, axis=0)
                  if self.has(bname) else [None] * 3)
        return {key: DenseLinear(self._put(np.ascontiguousarray(ww.T)),
                                 self._put(bb) if bb is not None else None)
                for key, ww, bb in zip(("wq", "wk", "wv"),
                                       np.split(w, cuts, axis=0), biases)}

    @staticmethod
    def _fuse_attn(attn: dict) -> None:
        """Fuse q/k/v into one wide matmul (ops.linear.fuse_linears)."""
        fused = fuse_linears([attn.get("wq"), attn.get("wk"), attn.get("wv")])
        if fused is not None:
            attn["wqkv"] = fused  # slice boundaries live in fused.splits
            del attn["wq"], attn["wk"], attn["wv"]

    @staticmethod
    def _fuse_ffn(ffn: dict) -> None:
        if "gate" in ffn and "up" in ffn:
            fused = fuse_linears([ffn["gate"], ffn["up"]])
            if fused is not None:
                ffn["gate_up"] = fused
                del ffn["gate"], ffn["up"]

    def _load_ffn(self, i: int, cfg: ModelConfig) -> dict:
        p = f"blk.{i}"
        if self.has(f"{p}.ffn_gate_inp.weight"):  # MoE
            ffn: dict[str, Any] = {
                "router": self.linear(f"{p}.ffn_gate_inp"),
                "experts": {key: self._expert_stack(f"{p}.ffn_{key}_exps.weight")
                            for key in ("gate", "up", "down")},
            }
            for key in ("gate", "up", "down"):  # gpt-oss per-expert biases
                bname = f"{p}.ffn_{key}_exps.bias"
                if self.has(bname):
                    ffn["experts"][f"{key}_bias"] = self._put(self.dense(bname))
            if self.has(f"{p}.exp_probs_b.bias"):  # DeepSeek-V3 choice bias
                ffn["router_bias"] = self._put(
                    self.dense(f"{p}.exp_probs_b.bias"))
            if self.has(f"{p}.ffn_gate_shexp.weight"):
                # the JAX package runs gate and up as two products; fused,
                # the GLU kernel runs them (same values)
                shared = {key: self.linear(f"{p}.ffn_{key}_shexp")
                          for key in ("gate", "up", "down")}
                self._fuse_ffn(shared)
                ffn["shared"] = shared
                if self.has(f"{p}.ffn_gate_inp_shexp.weight"):
                    ffn["shared_gate"] = self.linear(f"{p}.ffn_gate_inp_shexp")
            return ffn
        ffn = {}
        if cfg.has_ffn_gate and self.has(f"{p}.ffn_gate.weight"):
            ffn["gate"] = self.linear(f"{p}.ffn_gate")
        ffn["up"] = self.linear(f"{p}.ffn_up")
        ffn["down"] = self.linear(f"{p}.ffn_down")
        if cfg.hidden_act == Activation.XIELU:
            if not cfg.xielu_alpha_p:
                # without them _act would have no xIELU to compute
                raise ValueError(
                    "xIELU architecture requires per-layer "
                    f"{cfg.arch}.xielu.alpha_p/alpha_n metadata arrays")
            # Apertus: per-layer learned activation constants (the
            # effective post-softplus values from metadata)
            ffn["xielu"] = (
                float(cfg.xielu_alpha_p[i]), float(cfg.xielu_alpha_n[i]),
                float(cfg.xielu_beta[i]) if cfg.xielu_beta else 0.5,
                float(cfg.xielu_eps[i]) if cfg.xielu_eps else -1e-6)
        if self.has(f"{p}.ffn_sub_norm.weight"):  # BitNet pre-down norm
            ffn["sub_norm"] = self._put(self.dense(f"{p}.ffn_sub_norm.weight"))
        self._fuse_ffn(ffn)
        return ffn

    def _expert_stack(self, name: str):
        """Stacked expert weights [E, in, out]. In quant mode the experts stay
        compressed on the device (QuantExpertStack, each expert repacked as
        ``linear`` repacks a matrix); in dequant mode a dense f32 tensor."""
        info = self.gguf.tensors[name]
        t = info.ggml_type
        e, n_out, k_in = info.np_shape  # [E, out, in]
        if self.mode == "quant" and t in _QUANTIZED_KEEP and k_in % 32 == 0:
            raw = np.frombuffer(self.gguf.tensor_bytes(name), np.uint8)
            per = raw.size // e
            rws = [self._repack_cached(
                f"{name}#{j}", lambda j=j: repack(
                    raw[j * per: (j + 1) * per], t, (n_out, k_in)))
                   for j in range(e)]
            return QuantExpertStack(
                packed=self._put(np.stack([r.packed for r in rws])),
                scales=self._put(np.stack([r.scales for r in rws])),
                mins=(self._put(np.stack([r.mins for r in rws]))
                      if rws[0].mins is not None else None),
                fmt=rws[0].fmt, group=rws[0].group, k=k_in, n=n_out)
        w = self.dense(name)
        if w.ndim != 3:
            raise ValueError(f"{name}: expected a 3D expert stack, got "
                             f"{w.shape}")
        return self._put(w).transpose(1, 2).contiguous()  # [E, in, out]

    def build(self) -> tuple[dict, ModelConfig]:
        cfg = self.config
        info = cfg.arch_info
        if info is not None and info.name in ("t5", "t5encoder"):
            from .t5 import load_t5  # encoder-decoder stacks (enc./dec.)

            params = load_t5(self, cfg)
            self.flush_repack_cache()
            return params, cfg
        params: dict[str, Any] = {}
        emb_name = "token_embd.weight"
        emb_info = self.gguf.tensors[emb_name]
        if self._keep_quantized(emb_name):
            # the table stays quantized on the device; lookups gather packed
            # rows and dequantize them (ops.linear.embedding_lookup)
            v, h = emb_info.np_shape
            rows = self._repack_cached(emb_name + "@rows", lambda: (
                RepackedWeight(*repack_rows(self.gguf.tensor_bytes(emb_name),
                                            emb_info.ggml_type, (v, h)),
                               k=h, n=v, source_type=emb_info.ggml_type)))
            params["embed"] = QuantEmbedding(
                packed=self._put(rows.packed), scales=self._panel(rows.scales),
                mins=self._panel(rows.mins),
                fmt=rows.fmt, group=rows.group, vocab=v, hidden=h)
        else:
            params["embed"] = self._put(self.dense(emb_name))
        if self.has("position_embd.weight"):  # learned positions (gpt2...)
            params["position_embed"] = self._put(
                self.dense("position_embd.weight"))
        # LFM2 stores its FINAL norm as token_embd_norm (llama.cpp maps HF's
        # embedding_norm there); bloom's is a real post-embedding LayerNorm
        lfm2_final = (info is not None and info.name in ("lfm2", "lfm2moe")
                      and not self.has("output_norm.weight"))
        embed_norm = self.norm("token_embd_norm", required=False)
        if embed_norm is not None and not lfm2_final:
            params["embed_norm"] = embed_norm
        params["layers"] = [self.load_layer(i, cfg)
                            for i in range(cfg.num_layers)]
        cfg.layer_kinds = tuple(
            self.layer_kind(i) for i in range(cfg.num_layers))
        params["final_norm"] = (embed_norm if lfm2_final
                                else self.norm("output_norm", unit_ok=True))
        if self.has("output.weight"):
            params["output"] = self.linear("output")
        else:
            cfg.tie_word_embeddings = True
            if self._keep_quantized(emb_name):
                # tied embeddings in quant mode: the output head is a
                # QuantLinear built from the same quantized embedding data
                rw = self._repack_cached(emb_name + "@out", lambda: repack(
                    self.gguf.tensor_bytes(emb_name), emb_info.ggml_type,
                    emb_info.np_shape))
                params["output"] = self._quant_linear(
                    rw, emb_info.ggml_type.name)
            else:
                params["output"] = None  # dense tied table used directly
        self.flush_repack_cache()
        return params, cfg


def load_model(path: str, mode: str = "quant", device="cuda",
               scale_dtype: str = "float32"
               ) -> tuple[dict, ModelConfig, GGUFFile]:
    gguf = GGUFFile.open(path)
    params, cfg = ModelLoader(gguf, mode=mode, device=device,
                              scale_dtype=scale_dtype).build()
    return params, cfg, gguf
