"""Synthetic GGUF model builder (random weights, real configs).

A trimmed copy of llama_gguf_tpu/utils/synthetic.py (dense, Mixtral-style
MoE and Qwen3Next hybrid presets; the port never imports the JAX package).
The same preset, quant and seed give the same file byte for byte as the JAX
package's builder (the -l2 presets and HYBRID_MOE_PRESETS are the port's
own). ``quant`` is any quantizable type;
Q4_K_M convention: embeddings and LM head Q6_K (dense presets: Q8_0 when the row does
not divide the 256-element super-block), attention and gate/up Q4_K, ffn_down
Q6_K; a K-quant whose super-block does not divide the row falls back to Q5_1.
"""

from __future__ import annotations

import os

import numpy as np

from ..gguf.constants import GGMLType, type_traits
from ..gguf.writer import GGUFWriter
from ..quant.quantize import quantize

PRESETS = {
    # name: (arch, vocab, hidden, layers, heads, kv_heads, ffn, ctx, tie)
    "tiny": ("qwen2", 512, 128, 2, 4, 2, 256, 256, False),
    "tiny-tied": ("qwen2", 512, 128, 2, 4, 2, 256, 256, True),
    "small": ("qwen2", 2048, 256, 4, 8, 2, 512, 512, False),
    "qwen2.5-0.5b": ("qwen2", 151936, 896, 24, 14, 2, 4864, 32768, True),
    "llama3-8b": ("llama", 128256, 4096, 32, 32, 8, 14336, 8192, False),
    "tinyllama-1.1b": ("llama", 32000, 2048, 22, 32, 4, 5632, 2048, False),
    # port-only: TinyLlama-1.1B's widths cut to 2 of 22 layers (every
    # kernel shape is local to a layer), so one file per weight format fits
    # chip_smoke.py's time limit
    "tinyllama-1.1b-l2": ("llama", 32000, 2048, 2, 32, 4, 5632, 2048, False),
}

# Mixtral-style sparse-MoE presets (llama arch + expert_count, the GGUF
# convention Mixtral converts to). "mixtral-8x7b" is the published geometry of
# Mixtral-8x7B-v0.1; the -lN presets keep its per-layer widths and cut only
# the depth, since every kernel shape is local to a layer.
# name: (vocab, hidden, layers, heads, kv_heads, ffn, ctx, experts, topk)
MOE_PRESETS = {
    "tiny-moe": (512, 128, 2, 4, 2, 256, 256, 4, 2),
    "mixtral-8x7b": (32000, 4096, 32, 32, 8, 14336, 32768, 8, 2),
    "mixtral-8x7b-l8": (32000, 4096, 8, 32, 8, 14336, 32768, 8, 2),
    # 2 of 32 layers: one layer takes one to two minutes to build on a CPU
    # and over a minute to load in dequant mode, so two fit chip_smoke.py's
    # time limit beside its other phases
    "mixtral-8x7b-l2": (32000, 4096, 2, 32, 8, 14336, 32768, 8, 2),
}

# Qwen3Next-style hybrid (gated full attention every 4th layer, DeltaNet
# linear attention elsewhere), dense FFNs, as the JAX package's builder.
# name: (vocab, hidden, layers, heads, kv_heads, head_dim, ffn, ctx,
#        hv, hk, dk, dv, conv)
HYBRID_PRESETS = {
    "tiny-qwen3next": (512, 128, 4, 4, 2, 32, 256, 256, 4, 2, 32, 32, 4),
}

# Port-only: the same hybrid with MoE FFNs (softmax top-k routing,
# renormalised, plus a shared expert behind a sigmoid gate), as
# Qwen/Qwen3-Next-80B-A3B-Instruct's config.json has them. Q4_K_M mix of
# _build_moe: attention, DeltaNet projections, gate/up experts and the
# shared gate/up Q4_K; down experts, shared down, embedding and head Q6_K.
HYBRID_MOE_PRESETS = {
    # the CPU tests' size: hidden 256 so gate/up stay Q4_K (q4) and the
    # down stacks Q6_K (q8), as at full width
    "tiny-qwen3next-moe": dict(
        vocab=512, hidden=256, layers=4, heads=4, kv_heads=2, head_dim=64,
        ffn=512, ctx=256, hv=4, hk=2, dk=32, dv=32, conv=4, experts=8,
        topk=2, expert_ffn=256, shared_ffn=256, rope_base=1e7),
    # Qwen3-Next-80B-A3B at its published widths: hidden 2048, 16 q / 2 kv
    # heads of 256 with an output gate, partial RoPE 0.25 (64 dims), rope
    # base 1e7; DeltaNet 16 key / 32 value heads of 128, conv 4; top-10 of
    # 512 experts of ffn 512, shared expert 512; every 4th layer full
    # attention. Reduced: layers 48 -> 4 (one period: 3 DeltaNet layers, 1
    # attention) and experts 512 -> 64 (host quantization time; the kernels
    # read only routed experts, and 64 is 6.4x the 10 a token uses)
    "qwen3-next-80b-a3b-l4": dict(
        vocab=151936, hidden=2048, layers=4, heads=16, kv_heads=2,
        head_dim=256, ffn=5120, ctx=262144, hv=32, hk=16, dk=128, dv=128,
        conv=4, experts=64, topk=10, expert_ffn=512, shared_ffn=512,
        rope_base=1e7),
}


def build_synthetic_gguf(
    path: str,
    preset: str = "tiny",
    quant: GGMLType = GGMLType.Q4_K,
    seed: int = 0,
    max_ctx: int | None = None,
) -> str:
    """Write a synthetic model if not already cached; returns path."""
    if os.path.exists(path):
        return path
    if preset in MOE_PRESETS:
        return _build_moe(path, preset, quant, seed, max_ctx)
    if preset in HYBRID_PRESETS or preset in HYBRID_MOE_PRESETS:
        return _build_hybrid(path, preset, quant, seed, max_ctx)
    arch, vocab, hidden, layers, heads, kv_heads, ffn, ctx, tie = PRESETS[preset]
    if max_ctx:
        ctx = min(ctx, max_ctx)
    head_dim = hidden // heads
    rng = np.random.default_rng(seed)

    w = GGUFWriter()
    w.add_metadata("general.architecture", arch)
    w.add_metadata("general.name", f"synthetic-{preset}")
    w.add_metadata(f"{arch}.embedding_length", hidden)
    w.add_metadata(f"{arch}.block_count", layers)
    w.add_metadata(f"{arch}.attention.head_count", heads)
    w.add_metadata(f"{arch}.attention.head_count_kv", kv_heads)
    w.add_metadata(f"{arch}.feed_forward_length", ffn)
    w.add_metadata(f"{arch}.context_length", ctx)
    w.add_metadata(f"{arch}.attention.layer_norm_rms_epsilon", 1e-6)
    w.add_metadata(f"{arch}.rope.freq_base", 1000000.0 if arch == "qwen2" else 10000.0)
    w.add_metadata(f"{arch}.vocab_size", vocab)
    _add_tokenizer(w, vocab)

    scale = 0.02

    def rw(*shape):
        return (rng.standard_normal(shape).astype(np.float32) * scale)

    def addq(name, arr, q=quant):
        _quant_put(w, name, arr, q)

    if quant == GGMLType.F32:
        emb_q = GGMLType.F32
    elif hidden % 256 == 0:
        emb_q = GGMLType.Q6_K
    else:
        emb_q = GGMLType.Q8_0
    addq("token_embd.weight", rw(vocab, hidden), emb_q)
    for i in range(layers):
        p = f"blk.{i}"
        w.add_tensor_np(f"{p}.attn_norm.weight",
                        np.ones(hidden, np.float32) + rw(hidden))
        addq(f"{p}.attn_q.weight", rw(heads * head_dim, hidden))
        addq(f"{p}.attn_k.weight", rw(kv_heads * head_dim, hidden))
        addq(f"{p}.attn_v.weight", rw(kv_heads * head_dim, hidden))
        addq(f"{p}.attn_output.weight", rw(hidden, heads * head_dim))
        if arch == "qwen2":
            w.add_tensor_np(f"{p}.attn_q.bias", rw(heads * head_dim))
            w.add_tensor_np(f"{p}.attn_k.bias", rw(kv_heads * head_dim))
            w.add_tensor_np(f"{p}.attn_v.bias", rw(kv_heads * head_dim))
        w.add_tensor_np(f"{p}.ffn_norm.weight",
                        np.ones(hidden, np.float32) + rw(hidden))
        addq(f"{p}.ffn_gate.weight", rw(ffn, hidden))
        addq(f"{p}.ffn_up.weight", rw(ffn, hidden))
        addq(f"{p}.ffn_down.weight", rw(hidden, ffn),
             GGMLType.Q6_K if quant != GGMLType.F32 else GGMLType.F32)
    w.add_tensor_np("output_norm.weight", np.ones(hidden, np.float32) + rw(hidden))
    if not tie:
        addq("output.weight", rw(vocab, hidden), emb_q)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    w.write_to_path(path)
    return path


def _quant_put(w: GGUFWriter, name: str, arr: np.ndarray, q: GGMLType) -> None:
    """Quantize (last-dim blocks) and add a 2D/3D tensor; f32 when the row
    length does not divide the block size."""
    k = arr.shape[-1]
    if q != GGMLType.F32 and k % type_traits(q).block_size != 0 and k % 32 == 0:
        # llama.cpp falls back to a legacy 32-block format when a K-quant's
        # 256-superblock doesn't divide the row
        q = GGMLType.Q5_1
    if q != GGMLType.F32 and k % type_traits(q).block_size == 0:
        raw = quantize(arr, q)
        w.add_tensor_raw(name, tuple(reversed(arr.shape)), q, raw.tobytes())
    else:
        w.add_tensor_np(name, arr)


def _build_moe(path: str, preset: str, quant: GGMLType, seed: int,
               max_ctx: int | None) -> str:
    """Mixtral-convention sparse MoE: llama arch + expert_count metadata and
    stacked ffn_{gate,up,down}_exps expert tensors [E, out, in]."""
    vocab, hidden, layers, heads, kv_heads, ffn, ctx, experts, topk = \
        MOE_PRESETS[preset]
    if max_ctx:
        ctx = min(ctx, max_ctx)
    head_dim = hidden // heads
    rng = np.random.default_rng(seed)

    def rw(*shape):
        return (rng.standard_normal(shape).astype(np.float32) * 0.02)

    w = GGUFWriter()
    w.add_metadata("general.architecture", "llama")
    w.add_metadata("general.name", f"synthetic-{preset}")
    w.add_metadata("llama.embedding_length", hidden)
    w.add_metadata("llama.block_count", layers)
    w.add_metadata("llama.attention.head_count", heads)
    w.add_metadata("llama.attention.head_count_kv", kv_heads)
    w.add_metadata("llama.feed_forward_length", ffn)
    w.add_metadata("llama.context_length", ctx)
    w.add_metadata("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add_metadata("llama.rope.freq_base", 1000000.0)
    w.add_metadata("llama.expert_count", experts)
    w.add_metadata("llama.expert_used_count", topk)
    w.add_metadata("llama.expert_weights_norm", True)
    w.add_metadata("llama.vocab_size", vocab)
    _add_tokenizer(w, vocab)

    def addq(name, arr, q=quant):
        _quant_put(w, name, arr, q)

    f32 = quant == GGMLType.F32
    addq("token_embd.weight", rw(vocab, hidden),
         GGMLType.F32 if f32 else GGMLType.Q6_K)
    for i in range(layers):
        p = f"blk.{i}"
        w.add_tensor_np(f"{p}.attn_norm.weight",
                        np.ones(hidden, np.float32) + rw(hidden))
        addq(f"{p}.attn_q.weight", rw(heads * head_dim, hidden))
        addq(f"{p}.attn_k.weight", rw(kv_heads * head_dim, hidden))
        addq(f"{p}.attn_v.weight", rw(kv_heads * head_dim, hidden))
        addq(f"{p}.attn_output.weight", rw(hidden, heads * head_dim))
        w.add_tensor_np(f"{p}.ffn_norm.weight",
                        np.ones(hidden, np.float32) + rw(hidden))
        w.add_tensor_np(f"{p}.ffn_gate_inp.weight", rw(experts, hidden))
        addq(f"{p}.ffn_gate_exps.weight", rw(experts, ffn, hidden))
        addq(f"{p}.ffn_up_exps.weight", rw(experts, ffn, hidden))
        addq(f"{p}.ffn_down_exps.weight", rw(experts, hidden, ffn),
             GGMLType.F32 if f32 else GGMLType.Q6_K)
    w.add_tensor_np("output_norm.weight",
                    np.ones(hidden, np.float32) + rw(hidden))
    addq("output.weight", rw(vocab, hidden),
         GGMLType.F32 if f32 else GGMLType.Q6_K)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    w.write_to_path(path)
    return path


def _build_hybrid(path: str, preset: str, quant: GGMLType, seed: int,
                  max_ctx: int | None) -> str:
    """Qwen3Next-convention hybrid: DeltaNet linear-attention layers with a
    gated full-attention layer every 4th block (ssm_in = [q|k|v] grouped per
    k-head, z in attn_gate, combined ssm_ba, (1+w) norms, partial RoPE,
    ssm_a pre-transformed). HYBRID_PRESETS give the JAX builder's bytes;
    HYBRID_MOE_PRESETS replace the dense FFN by routed and shared
    experts."""
    moe = HYBRID_MOE_PRESETS.get(preset)
    if moe is None:
        (vocab, hidden, layers, heads, kv_heads, head_dim, ffn, ctx,
         hv, hk, dk, dv, conv) = HYBRID_PRESETS[preset]
        rope_base = 10000.0
    else:
        (vocab, hidden, layers, heads, kv_heads, head_dim, ffn, ctx, hv, hk,
         dk, dv, conv, rope_base) = (moe[k] for k in (
             "vocab", "hidden", "layers", "heads", "kv_heads", "head_dim",
             "ffn", "ctx", "hv", "hk", "dk", "dv", "conv", "rope_base"))
    if max_ctx:
        ctx = min(ctx, max_ctx)
    rng = np.random.default_rng(seed)

    def rw(*shape):
        return (rng.standard_normal(shape).astype(np.float32) * 0.02)

    a = "qwen3next"
    w = GGUFWriter()
    w.add_metadata("general.architecture", a)
    w.add_metadata("general.name", f"synthetic-{preset}")
    w.add_metadata(f"{a}.embedding_length", hidden)
    w.add_metadata(f"{a}.block_count", layers)
    w.add_metadata(f"{a}.attention.head_count", heads)
    w.add_metadata(f"{a}.attention.head_count_kv", kv_heads)
    w.add_metadata(f"{a}.attention.key_length", head_dim)
    w.add_metadata(f"{a}.attention.value_length", head_dim)
    w.add_metadata(f"{a}.feed_forward_length", ffn)
    w.add_metadata(f"{a}.context_length", ctx)
    w.add_metadata(f"{a}.attention.layer_norm_rms_epsilon", 1e-6)
    w.add_metadata(f"{a}.rope.freq_base", rope_base)
    w.add_metadata(f"{a}.rope.dimension_count", head_dim // 4)
    w.add_metadata(f"{a}.ssm.inner_size", hv * dv)
    w.add_metadata(f"{a}.ssm.state_size", dk)
    w.add_metadata(f"{a}.ssm.group_count", hk)
    w.add_metadata(f"{a}.ssm.time_step_rank", hv)
    w.add_metadata(f"{a}.ssm.conv_kernel", conv)
    if moe is not None:
        w.add_metadata(f"{a}.expert_count", moe["experts"])
        w.add_metadata(f"{a}.expert_used_count", moe["topk"])
        w.add_metadata(f"{a}.expert_feed_forward_length", moe["expert_ffn"])
        w.add_metadata(f"{a}.expert_shared_feed_forward_length",
                       moe["shared_ffn"])
        w.add_metadata(f"{a}.expert_weights_norm", True)
    w.add_metadata(f"{a}.vocab_size", vocab)
    _add_tokenizer(w, vocab)

    def addq(name, arr, q=quant):
        _quant_put(w, name, arr, q)

    f32 = quant == GGMLType.F32
    # the JAX builder's table and head are Q8_0; the MoE presets' Q6_K
    emb_q = (GGMLType.F32 if f32 else GGMLType.Q8_0 if moe is None
             else GGMLType.Q6_K)
    down_q = GGMLType.F32 if f32 else GGMLType.Q6_K
    conv_dim = 2 * hk * dk + hv * dv
    addq("token_embd.weight", rw(vocab, hidden), emb_q)
    for i in range(layers):
        p = f"blk.{i}"
        w.add_tensor_np(f"{p}.attn_norm.weight",
                        np.ones(hidden, np.float32) + rw(hidden))
        w.add_tensor_np(f"{p}.ffn_norm.weight",
                        np.ones(hidden, np.float32) + rw(hidden))
        if moe is None:
            addq(f"{p}.ffn_gate.weight", rw(ffn, hidden))
            addq(f"{p}.ffn_up.weight", rw(ffn, hidden))
            addq(f"{p}.ffn_down.weight", rw(hidden, ffn))
        else:
            e, ef, sf = moe["experts"], moe["expert_ffn"], moe["shared_ffn"]
            w.add_tensor_np(f"{p}.ffn_gate_inp.weight", rw(e, hidden))
            addq(f"{p}.ffn_gate_exps.weight", rw(e, ef, hidden))
            addq(f"{p}.ffn_up_exps.weight", rw(e, ef, hidden))
            addq(f"{p}.ffn_down_exps.weight", rw(e, hidden, ef), down_q)
            addq(f"{p}.ffn_gate_shexp.weight", rw(sf, hidden))
            addq(f"{p}.ffn_up_shexp.weight", rw(sf, hidden))
            addq(f"{p}.ffn_down_shexp.weight", rw(hidden, sf), down_q)
            w.add_tensor_np(f"{p}.ffn_gate_inp_shexp.weight", rw(1, hidden))
        if (i + 1) % 4 != 0:  # DeltaNet linear-attention layer
            addq(f"{p}.ssm_in.weight",
                 rw(hk * dk + hk * dk + hv * dv, hidden))
            addq(f"{p}.attn_gate.weight", rw(hv * dv, hidden))
            w.add_tensor_np(f"{p}.ssm_ba.weight", rw(2 * hv, hidden))
            w.add_tensor_np(f"{p}.ssm_conv1d.weight", rw(conv_dim, conv))
            w.add_tensor_np(f"{p}.ssm_dt.bias", rw(hv))
            w.add_tensor_np(f"{p}.ssm_a",
                            -np.exp(rw(hv)).astype(np.float32))
            w.add_tensor_np(f"{p}.ssm_norm.weight",
                            np.ones(dv, np.float32) + rw(dv))
            addq(f"{p}.ssm_out.weight", rw(hidden, hv * dv))
        else:  # gated full attention
            addq(f"{p}.attn_q.weight", rw(heads * head_dim, hidden))
            addq(f"{p}.attn_gate.weight", rw(heads * head_dim, hidden))
            addq(f"{p}.attn_k.weight", rw(kv_heads * head_dim, hidden))
            addq(f"{p}.attn_v.weight", rw(kv_heads * head_dim, hidden))
            addq(f"{p}.attn_output.weight", rw(hidden, heads * head_dim))
            w.add_tensor_np(f"{p}.attn_q_norm.weight",
                            np.ones(head_dim, np.float32) + rw(head_dim))
            w.add_tensor_np(f"{p}.attn_k_norm.weight",
                            np.ones(head_dim, np.float32) + rw(head_dim))
    w.add_tensor_np("output_norm.weight",
                    np.ones(hidden, np.float32) + rw(hidden))
    addq("output.weight", rw(vocab, hidden), emb_q)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    w.write_to_path(path)
    return path


def _add_tokenizer(w: GGUFWriter, vocab: int) -> None:
    """Minimal byte-fallback SPM tokenizer metadata."""
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    ttypes = [2, 3, 3] + [6] * 256
    while len(toks) < min(vocab, 4096):
        toks.append(f"tok{len(toks)}")
        ttypes.append(1)
    w.add_metadata("tokenizer.ggml.model", "llama")
    w.add_metadata("tokenizer.ggml.tokens", toks)
    w.add_metadata("tokenizer.ggml.scores", np.zeros(len(toks), np.float32))
    w.add_metadata("tokenizer.ggml.token_type", np.array(ttypes, np.int32))
    w.add_metadata("tokenizer.ggml.bos_token_id", 1)
    w.add_metadata("tokenizer.ggml.eos_token_id", 2)
    w.add_metadata("tokenizer.ggml.unknown_token_id", 0)
