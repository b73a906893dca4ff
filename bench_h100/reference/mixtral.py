"""Plain reference of the Mixtral family (MixtralForCausalLM), written from
the published description (HF ``modeling_mixtral``) in the GGUF layout that
llama.cpp converts it to (arch ``llama`` with ``expert_count``; q/k rows
permuted at conversion, so RoPE pairs adjacent dimensions).

float32 throughout, TF32 off (the caller sets it), no cache, no batching:
one sequence at a time, every position in one pass. ``fp8=True`` is the
control: every product's input activations and the keys and values rounded
to float8 e4m3 (per-row absmax scale), the precision step below the bf16 the
serving configuration computes in. Imports nothing of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import attention, fp8_round, rms_norm, rope_normal

Q4_K, Q6_K = 12, 14


def layout(cfg: dict) -> tuple[dict, list[tuple]]:
    """(GGUF metadata without the tokenizer, tensor specs). A spec is
    (name, numpy shape, format, init): init "quant" (random blocks),
    "norm" (1 + N(0, 0.02)), "router" (N(0, 0.02)) or "bias"."""
    h, f, e = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_local_experts"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or h // nh
    v = cfg["vocab_size"]
    md = {
        "general.architecture": "llama",
        "general.name": "bench-" + cfg["name"],
        "llama.vocab_size": v,
        "llama.embedding_length": h,
        "llama.block_count": cfg["num_hidden_layers"],
        "llama.feed_forward_length": f,
        "llama.context_length": cfg["max_position_embeddings"],
        "llama.attention.head_count": nh,
        "llama.attention.head_count_kv": nkv,
        "llama.attention.layer_norm_rms_epsilon": float(cfg["rms_norm_eps"]),
        "llama.rope.freq_base": float(cfg["rope_theta"]),
        "llama.rope.dimension_count": hd,
        "llama.expert_count": e,
        "llama.expert_used_count": cfg["num_experts_per_tok"],
        "llama.expert_weights_norm": True,
    }
    specs = [("token_embd.weight", (v, h), Q6_K, "quant")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"blk.{i}"
        specs += [
            (f"{p}.attn_norm.weight", (h,), 0, "norm"),
            (f"{p}.attn_q.weight", (nh * hd, h), Q4_K, "quant"),
            (f"{p}.attn_k.weight", (nkv * hd, h), Q4_K, "quant"),
            (f"{p}.attn_v.weight", (nkv * hd, h), Q4_K, "quant"),
            (f"{p}.attn_output.weight", (h, nh * hd), Q4_K, "quant"),
            (f"{p}.ffn_norm.weight", (h,), 0, "norm"),
            (f"{p}.ffn_gate_inp.weight", (e, h), 0, "router"),
            (f"{p}.ffn_gate_exps.weight", (e, f, h), Q4_K, "quant"),
            (f"{p}.ffn_up_exps.weight", (e, f, h), Q4_K, "quant"),
            (f"{p}.ffn_down_exps.weight", (e, h, f), Q6_K, "quant"),
        ]
    specs += [("output_norm.weight", (h,), 0, "norm"),
              ("output.weight", (v, h), Q6_K, "quant")]
    return md, specs


def attention_work(cfg: dict, pairs: int, new: int, ctx: int
                   ) -> tuple[float, float]:
    """(operations, bytes) of attention over all layers for a step whose
    new tokens attend ``pairs`` (query, key) pairs in all, and whose rows
    hold ``ctx`` cached tokens after it: QK^T and PV per pair and head;
    the bf16 K and V read once and the new ones written once, the
    queries read and the context written once."""
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // nh
    n = cfg["num_hidden_layers"]
    flops = 2.0 * pairs * nh * 2 * hd
    nbytes = (ctx + new) * 2 * nkv * hd * 2 + new * 2 * nh * hd * 2
    return n * flops, n * nbytes


class Model:
    """The forward pass over float32 weights ``w`` (name -> tensor)."""

    def __init__(self, cfg: dict, w: dict[str, torch.Tensor]):
        self.cfg, self.w = cfg, w
        self.nh = cfg["num_attention_heads"]
        self.nkv = cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or cfg["hidden_size"] // self.nh
        self.eps = float(cfg["rms_norm_eps"])

    def _mm(self, x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
        return (fp8_round(x) if fp8 else x) @ w.t()

    def logits(self, ids: list[int], first: int, fp8: bool = False
               ) -> torch.Tensor:
        """Logits [len(ids) - first, V] of positions first..len(ids)-1."""
        w, cfg = self.w, self.cfg
        dev = w["output.weight"].device
        t = len(ids)
        pos = torch.arange(t, device=dev)
        x = w["token_embd.weight"][torch.tensor(ids, device=dev)]
        for i in range(cfg["num_hidden_layers"]):
            p = f"blk.{i}"
            h = rms_norm(x, w[f"{p}.attn_norm.weight"], self.eps)
            q = self._mm(h, w[f"{p}.attn_q.weight"], fp8).view(t, self.nh, self.hd)
            k = self._mm(h, w[f"{p}.attn_k.weight"], fp8).view(t, self.nkv, self.hd)
            v = self._mm(h, w[f"{p}.attn_v.weight"], fp8).view(t, self.nkv, self.hd)
            q = rope_normal(q, pos, float(cfg["rope_theta"]), self.hd)
            k = rope_normal(k, pos, float(cfg["rope_theta"]), self.hd)
            if fp8:
                k, v = fp8_round(k), fp8_round(v)
            rep = self.nh // self.nkv
            ctx = attention(q, k.repeat_interleave(rep, 1),
                            v.repeat_interleave(rep, 1), self.hd ** -0.5)
            x = x + self._mm(ctx.reshape(t, -1), w[f"{p}.attn_output.weight"],
                             fp8)
            h = rms_norm(x, w[f"{p}.ffn_norm.weight"], self.eps)
            x = x + self._moe(p, h, fp8)
        h = rms_norm(x[first:], w["output_norm.weight"], self.eps)
        return self._mm(h, w["output.weight"], fp8)

    def _moe(self, p: str, h: torch.Tensor, fp8: bool) -> torch.Tensor:
        """Softmax over the experts, the top k renormalised, each chosen
        expert's SwiGLU weighted and summed (HF MixtralSparseMoeBlock)."""
        w, k = self.w, self.cfg["num_experts_per_tok"]
        probs = torch.softmax(h @ w[f"{p}.ffn_gate_inp.weight"].t(), dim=-1)
        top_w, top_i = torch.topk(probs, k, dim=-1)
        top_w = top_w / top_w.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        gate, up = w[f"{p}.ffn_gate_exps.weight"], w[f"{p}.ffn_up_exps.weight"]
        down = w[f"{p}.ffn_down_exps.weight"]
        for e in range(gate.shape[0]):
            rows, slot = torch.nonzero(top_i == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = h[rows]
            act = F.silu(self._mm(xe, gate[e], fp8)) * self._mm(xe, up[e], fp8)
            out.index_add_(0, rows,
                           self._mm(act, down[e], fp8) * top_w[rows, slot, None])
        return out
