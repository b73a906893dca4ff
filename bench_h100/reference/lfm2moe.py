"""Plain reference of LFM2-MoE (Liquid AI's ``lfm2_moe``, LFM2-24B-A2B), in
llama.cpp's ``lfm2moe`` GGUF layout.

The conv and attention blocks follow the published description of LFM2
(HF ``transformers`` 4.57 ``models/lfm2/modeling_lfm2.py``). A block is
pre-norm: x + mixer(RMSNorm(x)), then x + FFN(RMSNorm(x)). The mixer of a
``conv`` layer is the gated short convolution: in_proj -> [B | C | x]; B·x;
a depthwise causal conv of ``conv_L_cache`` taps with no bias over the
sequence (zeros before its start); C·conv; out_proj. The mixer of a
``full_attention`` layer is GQA whose per-head q and k RMSNorms
(q_layernorm, k_layernorm) come before RoPE, and the RoPE rotates halves
(HF's rotate_half; the conversion does not permute q and k). The FFN of
the first ``num_dense_layers`` layers is a dense SwiGLU; the others are
sparse MoE. The final RMSNorm is stored as ``token_embd_norm`` (HF's
``embedding_norm``, applied after the last layer).

Departures, each listed under ``assumed`` in the configuration:

  * the MoE routing is written from the configuration's keys, as
    ``transformers`` 4.57 has no ``lfm2_moe``: the scores are the sigmoid of
    the router logits, the experts the top ``num_experts_per_tok`` of the
    scores plus the learned ``expert_bias`` (``use_expert_bias``), their
    weights the chosen scores without the bias, divided by their sum
    (``norm_topk_prob``) and times ``routed_scaling_factor``; each expert a
    SwiGLU;
  * the dense width ``intermediate_size`` is used as given, without
    LFM2's ``block_auto_adjust_ff_dim``;
  * the head is its own ``output.weight`` (Q6_K), where the published model
    ties it to the token table: the same shape, bytes and operations, run
    by the same kernel as the other configurations' heads;
  * the conv taps are drawn as the harness draws norm weights (1 + N(0,
    0.02)), so that the conv path carries a large share of each block's
    output.

float32 throughout, TF32 off (the caller sets it), no cache, no batching:
one sequence at a time, every position in one pass. ``fp8=True`` is the
control: every product's input activations, the keys and values, and the
conv's input window (B·x) rounded to float8 e4m3 (per-row absmax scale).
Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import attention, fp8_round, rms_norm

Q4_K, Q6_K = 12, 14
STATE = 4  # bytes of a float32 value: the conv's input, output, window, taps


def _attn_layers(cfg: dict) -> list[int]:
    return [i for i, kind in enumerate(cfg["layer_types"]
                                       [:cfg["num_hidden_layers"]])
            if kind == "full_attention"]


def _head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def layout(cfg: dict) -> tuple[dict, list[tuple]]:
    """(GGUF metadata without the tokenizer, tensor specs), as in
    reference/mixtral.py. ``head_count_kv`` is written one a layer, 0 on
    the conv layers, as llama.cpp's LFM2 conversion writes it."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = _head_dim(cfg)
    e, ef = cfg["num_experts"], cfg["moe_intermediate_size"]
    fd, dense = cfg["intermediate_size"], cfg["num_dense_layers"]
    lc = cfg["conv_L_cache"]
    n = cfg["num_hidden_layers"]
    kinds = cfg["layer_types"][:n]
    a = "lfm2moe"
    md = {
        "general.architecture": a,
        "general.name": "bench-" + cfg["name"],
        f"{a}.vocab_size": v,
        f"{a}.embedding_length": h,
        f"{a}.block_count": n,
        f"{a}.context_length": cfg["max_position_embeddings"],
        f"{a}.feed_forward_length": fd,
        f"{a}.attention.head_count": nh,
        f"{a}.attention.head_count_kv": np.array(
            [nkv if k == "full_attention" else 0 for k in kinds], np.int32),
        f"{a}.attention.layer_norm_rms_epsilon": float(cfg["norm_eps"]),
        f"{a}.rope.freq_base": float(cfg["rope_parameters"]["rope_theta"]),
        f"{a}.rope.dimension_count": hd,
        f"{a}.shortconv.l_cache": lc,
        f"{a}.leading_dense_block_count": dense,
        f"{a}.expert_count": e,
        f"{a}.expert_used_count": cfg["num_experts_per_tok"],
        f"{a}.expert_feed_forward_length": ef,
        f"{a}.expert_gating_func": 2,  # sigmoid
        f"{a}.expert_weights_norm": bool(cfg["norm_topk_prob"]),
        f"{a}.expert_weights_scale": float(cfg["routed_scaling_factor"]),
    }
    specs = [("token_embd.weight", (v, h), Q6_K, "quant")]
    for i, kind in enumerate(kinds):
        p = f"blk.{i}"
        specs.append((f"{p}.attn_norm.weight", (h,), 0, "norm"))
        if kind == "conv":
            specs += [
                (f"{p}.shortconv.in_proj.weight", (3 * h, h), Q4_K, "quant"),
                (f"{p}.shortconv.conv.weight", (h, lc), 0, "norm"),
                (f"{p}.shortconv.out_proj.weight", (h, h), Q4_K, "quant"),
            ]
        else:
            specs += [
                (f"{p}.attn_q.weight", (nh * hd, h), Q4_K, "quant"),
                (f"{p}.attn_k.weight", (nkv * hd, h), Q4_K, "quant"),
                (f"{p}.attn_v.weight", (nkv * hd, h), Q4_K, "quant"),
                (f"{p}.attn_output.weight", (h, nh * hd), Q4_K, "quant"),
                (f"{p}.attn_q_norm.weight", (hd,), 0, "norm"),
                (f"{p}.attn_k_norm.weight", (hd,), 0, "norm"),
            ]
        specs.append((f"{p}.ffn_norm.weight", (h,), 0, "norm"))
        if i < dense:
            specs += [(f"{p}.ffn_gate.weight", (fd, h), Q4_K, "quant"),
                      (f"{p}.ffn_up.weight", (fd, h), Q4_K, "quant"),
                      (f"{p}.ffn_down.weight", (h, fd), Q6_K, "quant")]
            continue
        specs += [
            (f"{p}.ffn_gate_inp.weight", (e, h), 0, "router"),
            (f"{p}.exp_probs_b.bias", (e,), 0, "bias"),
            (f"{p}.ffn_gate_exps.weight", (e, ef, h), Q4_K, "quant"),
            (f"{p}.ffn_up_exps.weight", (e, ef, h), Q4_K, "quant"),
            (f"{p}.ffn_down_exps.weight", (e, h, ef), Q6_K, "quant"),
        ]
    specs += [("token_embd_norm.weight", (h,), 0, "norm"),
              ("output.weight", (v, h), Q6_K, "quant")]
    return md, specs


def attention_work(cfg: dict, pairs: int, new: int, ctx: int
                   ) -> tuple[float, float]:
    """(operations, bytes) of the attention layers alone, as in
    reference/mixtral.py: QK^T and PV per (query, key) pair and head; the
    bf16 K and V read once and the new ones written once, the queries read
    and the context written once."""
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = _head_dim(cfg)
    n = len(_attn_layers(cfg))
    flops = 2.0 * pairs * nh * 2 * hd
    nbytes = (ctx + new) * 2 * nkv * hd * 2 + new * 2 * nh * hd * 2
    return n * flops, n * nbytes


def shortconv_work(cfg: dict, rows) -> tuple[float, float]:
    """(operations, bytes) of the conv layers' short conv (the kernel of
    csrc/shortconv.cu) in a step whose live rows are ``rows``, (new tokens,
    first position) each: 2 · taps · tokens · H operations; the bytes the
    kernel moves, all float32: B·x read and the output written once a
    token, each real row's window of taps - 1 values a channel read and
    written once, and the taps read once."""
    h, taps = cfg["hidden_size"], cfg["conv_L_cache"]
    n = cfg["num_hidden_layers"] - len(_attn_layers(cfg))
    tokens = sum(t for t, _ in rows)
    real = sum(1 for t, _ in rows if t > 0)
    flops = 2.0 * taps * tokens * h
    nbytes = (2 * tokens * h * STATE + 2 * real * (taps - 1) * h * STATE
              + taps * h * STATE)
    return n * flops, n * nbytes


def rope_neox(x: torch.Tensor, pos: torch.Tensor, theta: float
              ) -> torch.Tensor:
    """Rotate the halves (x[i], x[i + D/2]) of x [T, heads, D] by pos ·
    theta^(-2i/D) (HF's rotate_half; llama.cpp's rope type NEOX)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device,
                                  dtype=torch.float32) / d)
    ang = pos[:, None].float() * inv  # [T, D/2]
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


class Model:
    """The forward pass over float32 weights ``w`` (name -> tensor)."""

    def __init__(self, cfg: dict, w: dict[str, torch.Tensor]):
        self.cfg, self.w = cfg, w
        self.nh = cfg["num_attention_heads"]
        self.nkv = cfg["num_key_value_heads"]
        self.hd = _head_dim(cfg)
        self.eps = float(cfg["norm_eps"])

    @staticmethod
    def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
        return (fp8_round(x) if fp8 else x) @ w.t()

    def _swiglu(self, x, gate, up, down, fp8):
        act = F.silu(self._mm(x, gate, fp8)) * self._mm(x, up, fp8)
        return self._mm(act, down, fp8)

    def logits(self, ids: list[int], first: int, fp8: bool = False
               ) -> torch.Tensor:
        """Logits [len(ids) - first, V] of positions first..len(ids)-1."""
        w, cfg = self.w, self.cfg
        dev = w["output.weight"].device
        t = len(ids)
        pos = torch.arange(t, device=dev)
        x = w["token_embd.weight"][torch.tensor(ids, device=dev)]
        for i, kind in enumerate(cfg["layer_types"]
                                 [:cfg["num_hidden_layers"]]):
            p = f"blk.{i}"
            h = rms_norm(x, w[f"{p}.attn_norm.weight"], self.eps)
            x = x + (self._conv(p, h, fp8) if kind == "conv"
                     else self._attention(p, h, pos, fp8))
            h = rms_norm(x, w[f"{p}.ffn_norm.weight"], self.eps)
            if i < cfg["num_dense_layers"]:
                x = x + self._swiglu(h, w[f"{p}.ffn_gate.weight"],
                                     w[f"{p}.ffn_up.weight"],
                                     w[f"{p}.ffn_down.weight"], fp8)
            else:
                x = x + self._moe(p, h, fp8)
        h = rms_norm(x[first:], w["token_embd_norm.weight"], self.eps)
        return self._mm(h, w["output.weight"], fp8)

    def _conv(self, p: str, h: torch.Tensor, fp8: bool) -> torch.Tensor:
        """The gated short conv: y = C · conv(B · x), out_proj."""
        w = self.w
        t, d = h.shape
        b, c, xx = self._mm(h, w[f"{p}.shortconv.in_proj.weight"],
                            fp8).split(d, dim=-1)
        bx = b * xx
        if fp8:  # the conv window the cache would hold
            bx = fp8_round(bx)
        taps = w[f"{p}.shortconv.conv.weight"]  # [H, L]
        lc = taps.shape[1]
        seq = torch.cat([bx.new_zeros(lc - 1, d), bx], 0)
        conv = sum(seq[k:k + t] * taps[:, k] for k in range(lc))
        return self._mm(c * conv, w[f"{p}.shortconv.out_proj.weight"], fp8)

    def _attention(self, p: str, h: torch.Tensor, pos: torch.Tensor,
                   fp8: bool) -> torch.Tensor:
        w, t = self.w, h.shape[0]
        theta = float(self.cfg["rope_parameters"]["rope_theta"])
        q = self._mm(h, w[f"{p}.attn_q.weight"], fp8).view(t, self.nh, self.hd)
        k = self._mm(h, w[f"{p}.attn_k.weight"], fp8).view(t, self.nkv,
                                                           self.hd)
        v = self._mm(h, w[f"{p}.attn_v.weight"], fp8).view(t, self.nkv,
                                                           self.hd)
        q = rope_neox(rms_norm(q, w[f"{p}.attn_q_norm.weight"], self.eps),
                      pos, theta)
        k = rope_neox(rms_norm(k, w[f"{p}.attn_k_norm.weight"], self.eps),
                      pos, theta)
        if fp8:
            k, v = fp8_round(k), fp8_round(v)
        rep = self.nh // self.nkv
        ctx = attention(q, k.repeat_interleave(rep, 1),
                        v.repeat_interleave(rep, 1), self.hd ** -0.5)
        return self._mm(ctx.reshape(t, -1), w[f"{p}.attn_output.weight"], fp8)

    def _moe(self, p: str, h: torch.Tensor, fp8: bool) -> torch.Tensor:
        """Sigmoid scores; the top k of scores + expert bias chosen; their
        scores renormalised and scaled; each chosen expert's SwiGLU
        weighted and summed."""
        w, cfg = self.w, self.cfg
        scores = torch.sigmoid(h @ w[f"{p}.ffn_gate_inp.weight"].t())
        choice = scores + w[f"{p}.exp_probs_b.bias"]
        top_i = torch.topk(choice, cfg["num_experts_per_tok"], -1).indices
        top_w = torch.gather(scores, 1, top_i)
        if cfg["norm_topk_prob"]:
            top_w = top_w / top_w.sum(-1, keepdim=True)
        top_w = top_w * float(cfg["routed_scaling_factor"])
        out = torch.zeros_like(h)
        gate, up = w[f"{p}.ffn_gate_exps.weight"], w[f"{p}.ffn_up_exps.weight"]
        down = w[f"{p}.ffn_down_exps.weight"]
        for e in range(gate.shape[0]):
            rows, slot = torch.nonzero(top_i == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            out.index_add_(0, rows, self._swiglu(h[rows], gate[e], up[e],
                                                 down[e], fp8)
                           * top_w[rows, slot, None])
        return out
