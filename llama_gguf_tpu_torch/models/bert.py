"""BERT-family encoder-only models (embedding models); port of
llama_gguf_tpu/models/bert.py.

Pre-norm residual blocks in the GGUF naming (token_embd + position_embd +
token_types embeddings, token_embd_norm, blk.N.attn_output_norm /
layer_output_norm), bidirectional attention with a key mask, and a tanh-GELU
FFN without a gate. One batched forward over [B, T] with a padding mask,
eagerly: an encoder runs once per request. The q|k|v projections are fused
into one product (ops/linear.fuse_linears) where their layouts agree; the
JAX package runs three.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import linear as L
from ..ops.norms import apply_norm
from .config import ModelConfig

NEG_INF = -1e30


def bert_layer(layer: dict, cfg: ModelConfig, x: torch.Tensor,
               mask: torch.Tensor, precision: str | None = None
               ) -> torch.Tensor:
    """One encoder layer. x: [B, T, H]; mask: [B, T] bool (True = real)."""
    b, t, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim

    h = apply_norm(x, layer["attn_norm"], cfg.norm_eps, use_layer_norm=True)
    q, k, v = (y.reshape(b, t, nh, hd).float()
               for y in L.apply_qkv(layer["attn"], h, precision))
    scores = torch.einsum("bthd,bshd->bhts", q, k) * (hd ** -0.5)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhts,bshd->bthd", probs, v)
    ctx = ctx.reshape(b, t, nh * hd).to(x.dtype)
    x = x + L.apply(layer["attn"]["wo"], ctx, precision)

    h2 = apply_norm(x, layer["ffn_norm"], cfg.norm_eps, use_layer_norm=True)
    up = L.apply(layer["ffn"]["up"], h2, precision).float()
    act = F.gelu(up, approximate="tanh")
    return x + L.apply(layer["ffn"]["down"], act.to(x.dtype), precision)


def bert_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 mask: torch.Tensor,
                 token_types: torch.Tensor | None = None,
                 precision: str | None = None) -> torch.Tensor:
    """Full encoder: tokens/mask [B, T] -> hidden states [B, T, H]."""
    tokens = tokens.long()
    x = params["embed"][tokens]
    if params.get("position_embed") is not None:
        x = x + params["position_embed"][None, :tokens.shape[1]]
    if params.get("type_embed") is not None:
        tt = (token_types.long() if token_types is not None
              else torch.zeros_like(tokens))
        x = x + params["type_embed"][tt]
    if params.get("embed_norm") is not None:
        x = apply_norm(x, params["embed_norm"], cfg.norm_eps,
                       use_layer_norm=True)
    x = x * mask[..., None].to(x.dtype)
    for layer in params["layers"]:
        x = bert_layer(layer, cfg, x, mask, precision)
    return x


class BertEncoder:
    """Batched encoder: a batch padded to ``bucket_len`` of its longest
    sequence, run eagerly under the device's lock (engine/runner.py), the
    hidden states handed back on the host, so server handler threads can
    call ``encode``/``embed`` beside each other and a reload."""

    def __init__(self, params: dict, cfg: ModelConfig, device="cuda",
                 matmul_precision: str = "highest"):
        from ..engine.runner import _device_lock
        from .loader import resolve_device

        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self.matmul_precision = matmul_precision
        self._lock = _device_lock(self.device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity

    @torch.no_grad()
    def encode(self, token_ids: list[list[int]]) -> np.ndarray:
        """Encode a batch of sequences; returns [B, T_bucket, H] (rows past
        a sequence's length are padding)."""
        from ..engine.runner import bucket_len

        b = len(token_ids)
        t = bucket_len(max(len(ids) for ids in token_ids))
        toks = np.zeros((b, t), np.int32)
        mask = np.zeros((b, t), bool)
        for i, ids in enumerate(token_ids):
            toks[i, :len(ids)] = ids
            mask[i, :len(ids)] = True
        with self._lock:
            out = bert_forward(
                self.params, self.cfg,
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(mask).to(self.device),
                precision=self.matmul_precision)
            return out.float().cpu().numpy()

    def embed(self, token_ids: list[int], pooling: str = "mean",
              normalize: bool = True) -> np.ndarray:
        from .embeddings import pool

        hidden = self.encode([token_ids])[0, :len(token_ids)]
        vec = pool(hidden, pooling)
        if normalize:
            n = np.linalg.norm(vec)
            if n > 0:
                vec = vec / n
        return vec


def load_bert(loader) -> tuple[dict, ModelConfig]:
    """BERT params from a GGUF (the JAX load_bert): the embedding tables
    dense, the projections through ``loader.linear`` (kept quantized in
    "quant" mode) with q|k|v fused. A model whose tensors it does not find
    (nomic-bert's fused attn_qkv, for one) raises KeyError, as in JAX."""
    cfg = loader.config
    params: dict[str, Any] = {}
    params["embed"] = loader._put(loader.dense("token_embd.weight"))
    params["position_embed"] = (
        loader._put(loader.dense("position_embd.weight"))
        if loader.has("position_embd.weight") else None)
    params["type_embed"] = (
        loader._put(loader.dense("token_types.weight"))
        if loader.has("token_types.weight") else None)
    params["embed_norm"] = loader.norm("token_embd_norm", required=False)

    layers = []
    for i in range(cfg.num_layers):
        p = f"blk.{i}"
        attn_norm = (loader.norm(f"{p}.attn_output_norm", required=False)
                     or loader.norm(f"{p}.attn_norm"))
        ffn_norm = (loader.norm(f"{p}.layer_output_norm", required=False)
                    or loader.norm(f"{p}.ffn_norm"))
        attn = {"wq": loader.linear(f"{p}.attn_q"),
                "wk": loader.linear(f"{p}.attn_k"),
                "wv": loader.linear(f"{p}.attn_v"),
                "wo": loader.linear(f"{p}.attn_output")}
        loader._fuse_attn(attn)
        layers.append({
            "attn_norm": attn_norm,
            "attn": attn,
            "ffn_norm": ffn_norm,
            "ffn": {
                "up": loader.linear(f"{p}.ffn_up"),
                "down": loader.linear(f"{p}.ffn_down"),
            },
        })
    params["layers"] = layers
    loader.flush_repack_cache()
    return params, cfg
