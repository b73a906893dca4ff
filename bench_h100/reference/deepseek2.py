"""Plain reference of the DeepSeek-V3 layout (Moonlight-16B-A3B), written
from the published description (HF ``modeling_deepseek_v3``) in llama.cpp's
``deepseek2`` GGUF layout.

Multi-head latent attention is written unabsorbed, as DeepSeek-V3 describes
it: the latent c_kv = RMSNorm(x W_kv_a)[:rank] is expanded per head by
W_kv_b into the no-RoPE keys and the values, each head's key gets the
shared RoPE part, and standard causal attention follows (scale
(nope + rope)^-1/2). The leading ``first_k_dense_replace`` layers have a
dense SwiGLU; the others route with sigmoid scores, the choice adding the
learned bias (noaux_tc), top-k, renormalised, times the routed scale, plus
the shared experts as one SwiGLU. float32, no cache; ``fp8=True`` rounds
every product's input and the cached latent to float8 e4m3 (the control).
Imports nothing of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import attention, fp8_round, rms_norm, rope_normal

Q4_K, Q6_K = 12, 14


def layout(cfg: dict) -> tuple[dict, list[tuple]]:
    """(GGUF metadata without the tokenizer, tensor specs), as in
    reference/mixtral.py. The experts' down stack has rows of
    moe_intermediate_size (1,408), which Q6_K's 256-weight super-block does
    not divide: the writer stores it as Q5_1 (h100bench/ggml.pick_format)."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    nh = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    e, ef = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    sf = cfg["n_shared_experts"] * ef
    dense = cfg["first_k_dense_replace"]
    a = "deepseek2"
    md = {
        "general.architecture": a,
        "general.name": "bench-" + cfg["name"],
        f"{a}.vocab_size": v,
        f"{a}.embedding_length": h,
        f"{a}.block_count": cfg["num_hidden_layers"],
        f"{a}.context_length": cfg["max_position_embeddings"],
        f"{a}.attention.layer_norm_rms_epsilon": float(cfg["rms_norm_eps"]),
        f"{a}.attention.head_count": nh,
        f"{a}.attention.head_count_kv": cfg["num_key_value_heads"],
        f"{a}.attention.key_length": nope + rope,
        f"{a}.attention.value_length": vd,
        f"{a}.attention.kv_lora_rank": rank,
        f"{a}.rope.dimension_count": rope,
        f"{a}.rope.freq_base": float(cfg["rope_theta"]),
        f"{a}.feed_forward_length": cfg["intermediate_size"],
        f"{a}.leading_dense_block_count": dense,
        f"{a}.expert_count": e,
        f"{a}.expert_used_count": cfg["num_experts_per_tok"],
        f"{a}.expert_feed_forward_length": ef,
        f"{a}.expert_shared_count": cfg["n_shared_experts"],
        f"{a}.expert_gating_func": 2 if cfg["scoring_func"] == "sigmoid" else 1,
        f"{a}.expert_weights_scale": float(cfg["routed_scaling_factor"]),
        f"{a}.expert_weights_norm": bool(cfg["norm_topk_prob"]),
        f"{a}.expert_group_count": cfg["n_group"],
        f"{a}.expert_group_used_count": cfg["topk_group"],
    }
    specs = [("token_embd.weight", (v, h), Q6_K, "quant")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"blk.{i}"
        specs += [
            (f"{p}.attn_norm.weight", (h,), 0, "norm"),
            (f"{p}.attn_q.weight", (nh * (nope + rope), h), Q4_K, "quant"),
            (f"{p}.attn_kv_a_mqa.weight", (rank + rope, h), Q4_K, "quant"),
            (f"{p}.attn_kv_a_norm.weight", (rank,), 0, "norm"),
            (f"{p}.attn_kv_b.weight", (nh * (nope + vd), rank), Q4_K, "quant"),
            (f"{p}.attn_output.weight", (h, nh * vd), Q4_K, "quant"),
            (f"{p}.ffn_norm.weight", (h,), 0, "norm"),
        ]
        if i < dense:
            fd = cfg["intermediate_size"]
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
            (f"{p}.ffn_gate_shexp.weight", (sf, h), Q4_K, "quant"),
            (f"{p}.ffn_up_shexp.weight", (sf, h), Q4_K, "quant"),
            (f"{p}.ffn_down_shexp.weight", (h, sf), Q6_K, "quant"),
        ]
    specs += [("output_norm.weight", (h,), 0, "norm"),
              ("output.weight", (v, h), Q6_K, "quant")]
    return md, specs


def attention_work(cfg: dict, pairs: int, new: int, ctx: int
                   ) -> tuple[float, float]:
    """(operations, bytes) of attention over all layers, as in
    reference/mixtral.py, at the least of each that some implementation
    needs: the operations of the unabsorbed form (QK^T over nope + rope
    and PV over v per pair and head; W_kv_b is counted as a product of its
    own), the bytes of the absorbed one (the bf16 latent [c_kv | k_rope] a
    token, read once and written once)."""
    nh = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    vd = cfg["v_head_dim"]
    lat = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    n = cfg["num_hidden_layers"]
    flops = 2.0 * pairs * nh * (qk + vd)
    nbytes = (ctx + new) * lat * 2 + new * nh * (qk + vd) * 2
    return n * flops, n * nbytes


class Model:
    """The forward pass over float32 weights ``w`` (name -> tensor)."""

    def __init__(self, cfg: dict, w: dict[str, torch.Tensor]):
        self.cfg, self.w = cfg, w
        self.eps = float(cfg["rms_norm_eps"])

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
        nh = cfg["num_attention_heads"]
        nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
        theta = float(cfg["rope_theta"])
        dev = w["output.weight"].device
        t = len(ids)
        pos = torch.arange(t, device=dev)
        x = w["token_embd.weight"][torch.tensor(ids, device=dev)]
        for i in range(cfg["num_hidden_layers"]):
            p = f"blk.{i}"
            h = rms_norm(x, w[f"{p}.attn_norm.weight"], self.eps)
            q = self._mm(h, w[f"{p}.attn_q.weight"], fp8).view(t, nh, nope + rope)
            kv_a = self._mm(h, w[f"{p}.attn_kv_a_mqa.weight"], fp8)
            c_kv = rms_norm(kv_a[:, :rank], w[f"{p}.attn_kv_a_norm.weight"],
                            self.eps)
            k_rope = rope_normal(kv_a[:, None, rank:], pos, theta, rope)
            q_rope = rope_normal(q[..., nope:], pos, theta, rope)
            if fp8:  # the latent cache: [c_kv | k_rope] a token
                c_kv, k_rope = fp8_round(c_kv), fp8_round(k_rope)
            kv = self._mm(c_kv, w[f"{p}.attn_kv_b.weight"], fp8).view(
                t, nh, nope + vd)
            k = torch.cat([kv[..., :nope], k_rope.expand(t, nh, rope)], -1)
            qq = torch.cat([q[..., :nope], q_rope], -1)
            ctx = attention(qq, k, kv[..., nope:], (nope + rope) ** -0.5)
            x = x + self._mm(ctx.reshape(t, nh * vd),
                             w[f"{p}.attn_output.weight"], fp8)
            h = rms_norm(x, w[f"{p}.ffn_norm.weight"], self.eps)
            if i < cfg["first_k_dense_replace"]:
                x = x + self._swiglu(h, w[f"{p}.ffn_gate.weight"],
                                     w[f"{p}.ffn_up.weight"],
                                     w[f"{p}.ffn_down.weight"], fp8)
            else:
                x = x + self._moe(p, h, fp8)
        h = rms_norm(x[first:], w["output_norm.weight"], self.eps)
        return self._mm(h, w["output.weight"], fp8)

    def _moe(self, p: str, h: torch.Tensor, fp8: bool) -> torch.Tensor:
        w, cfg = self.w, self.cfg
        k = cfg["num_experts_per_tok"]
        logits = h @ w[f"{p}.ffn_gate_inp.weight"].t()
        scores = torch.sigmoid(logits) if cfg["scoring_func"] == "sigmoid" \
            else torch.softmax(logits, -1)
        choice = scores + w[f"{p}.exp_probs_b.bias"]
        ng, tg = cfg["n_group"], cfg["topk_group"]
        if ng > 1:  # keep the best tg groups, a group scored by its top 2
            n, e = choice.shape
            grp = choice.view(n, ng, e // ng)
            best = torch.topk(torch.topk(grp, 2, -1).values.sum(-1), tg,
                              -1).indices
            keep = torch.zeros(n, ng, dtype=torch.bool, device=h.device)
            keep.scatter_(1, best, True)
            choice = grp.masked_fill(~keep[..., None], float("-inf")).view(n, e)
        top_i = torch.topk(choice, k, -1).indices
        top_w = torch.gather(scores, 1, top_i)
        if cfg["norm_topk_prob"]:
            top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
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
        return out + self._swiglu(h, w[f"{p}.ffn_gate_shexp.weight"],
                                  w[f"{p}.ffn_up_shexp.weight"],
                                  w[f"{p}.ffn_down_shexp.weight"], fp8)
