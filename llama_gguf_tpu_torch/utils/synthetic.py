"""Synthetic GGUF model builder (random weights, real configs).

A trimmed copy of llama_gguf_tpu/utils/synthetic.py (dense, Mixtral-style
MoE, Qwen3Next hybrid and Falcon-H1 presets; the port never imports the JAX
package). The same preset, quant and seed give the same file byte for byte
as the JAX package's synthetic.py (the -l2 presets, HYBRID_MOE_PRESETS,
SSM_PRESETS, MLA_PRESETS, GEMMA3_PRESETS, ROUTING_PRESETS and
ENCODER_PRESETS are the port's own, and the JAX package loads them too). ``build_synthetic_t5`` writes the
JAX builder's bytes at its defaults; ``build_synthetic_bert`` the tensor
names of the JAX package's BERT test builder.
``quant`` is any quantizable type;
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


# Falcon-H1-convention parallel hybrid: every block runs attention AND a
# Mamba-2 mixer off one pre-norm, outputs summed, then a SwiGLU FFN half.
# name: (vocab, hidden, layers, heads, kv_heads, ffn, ctx, d_inner,
#        d_state, n_groups, n_heads, conv)
FALCONH1_PRESETS = {
    "tiny-falconh1": (512, 128, 2, 4, 2, 256, 256, 128, 16, 2, 4, 4),
}

# Port-only Mamba-family presets (_build_ssm). ``kinds``: one letter a
# layer, "m" Mamba-1, "2" Mamba-2, "c" LFM2's short conv, "a" attention;
# ``moe``: the layers whose FFN half is routed experts. Q4_K_M mix as the
# dense presets pick it: ssm_in, ssm_x, ssm_out, the short conv's
# projections, q/k/v/o, gate/up and gate/up experts Q4_K; down (and down
# experts), the table and the head Q6_K; conv weights, ssm_a, ssm_d, the dt
# bias and projection, ssm_norm, the router and the norms F32. The
# recurrences' parameters follow the HF initialisers (dt in [1e-3, 0.1],
# A = -(1..n), D = 1), so the state carries memory.
SSM_PRESETS = {
    # Mamba-1 blocks alone (arch mamba: no FFN half, no dt/B/C norms)
    "tiny-mamba": dict(
        arch="mamba", vocab=512, hidden=256, kinds="mm", ctx=256, di=512,
        ds=16, dtr=16, conv=4, tie=False),
    # Mamba-2 blocks alone (arch mamba2: no FFN half), gated full-width norm
    "tiny-mamba2": dict(
        arch="mamba2", vocab=512, hidden=256, kinds="22", ctx=256,
        di=512, ds=16, ng=2, nh=8, conv=4, tie=False),
    # LFM2: short-conv blocks and QK-normed GQA blocks, each with a SwiGLU
    # half; its final norm stored as token_embd_norm, tied embeddings
    "tiny-lfm2": dict(
        arch="lfm2", vocab=512, hidden=256, kinds="caca", heads=4,
        kv_heads=2, ffn=512, ctx=256, lc=3, tie=True, rope_base=1e6),
    # Jamba: NoPE attention and Mamba-1 blocks (dt/B/C norms), a
    # softmax-top-2 MoE half of 4 experts every other layer
    "tiny-jamba": dict(
        arch="jamba", vocab=512, hidden=256, kinds="amam", heads=4,
        kv_heads=2, ffn=512, ctx=256, di=512, ds=16, dtr=16, conv=4,
        experts=4, topk=2, moe=(1, 3), tie=False),
    # Granite-4.0 hybrid: Mamba-2 and NoPE GQA blocks, each with a dense
    # SwiGLU half, the four Granite multipliers, tied embeddings
    "tiny-granitehybrid": dict(
        arch="granitehybrid", vocab=512, hidden=256, kinds="22a2", heads=4,
        kv_heads=2, ffn=512, ctx=256, di=512, ds=16, ng=1, nh=8, conv=4,
        tie=True, granite=(12.0, 8.0, 0.22, 0.015625)),
    # ibm-granite/granite-4.0-h-micro's config.json: vocab 100352, hidden
    # 2048, 32 q / 8 kv heads of 64 (NoPE), SwiGLU 8192 in every block,
    # Mamba-2 64 heads of 64 (d_inner 4096), d_state 128, 1 group, conv 4
    # with bias, rms eps 1e-5, multipliers embedding 12, logits / 8,
    # residual 0.22, attention 0.015625, tied embeddings. Reduced: layers
    # 40 -> 10, one period of layer_types (attention at index 5), so 9
    # Mamba-2 blocks and 1 attention block, the published 9:1 ratio (host
    # quantization time; every kernel shape is local to a layer)
    "granite-4.0-h-micro-l10": dict(
        arch="granitehybrid", vocab=100352, hidden=2048, kinds="22222a2222",
        heads=32, kv_heads=8, ffn=8192, ctx=131072, di=4096, ds=128, ng=1,
        nh=64, conv=4, tie=True, granite=(12.0, 8.0, 0.22, 0.015625),
        eps=1e-5),
}


# Port-only DeepSeek-family presets (_build_deepseek2), in the llama.cpp
# deepseek2 convention the JAX loader reads: multi-head latent attention
# (attn_q_a/attn_q_a_norm/attn_q_b when q_lora is set, else a dense attn_q;
# attn_kv_a_mqa = [c_kv | k_rope], attn_kv_a_norm, attn_kv_b the per-head
# up-projections [heads * (nope + v), kv_lora]); ``dense`` leading SwiGLU
# layers of width ffn, then routed experts of expert_ffn beside ``shared``
# shared experts stored as one shared FFN of shared * expert_ffn. Routing:
# ``gating`` 1 softmax, 2 sigmoid with the learned exp_probs_b bias that
# only the choice of experts sees; ``groups`` (count, used) limits the
# choice to the best groups; ``norm`` renormalises the top-k weights and
# ``scale`` multiplies them. Q4_K_M mix as the MoE presets pick it: the
# attention projections, gate/up and the experts' gate/up Q4_K; the dense
# and shared down, the table and the head Q6_K, the experts' down Q6_K
# where its K divides 256, else Q5_1 (_quant_put); the router, the bias
# and the norms F32.
MLA_PRESETS = {
    # DeepSeek-V3's layout at the CPU tests' size: low-rank q, sigmoid
    # routing with the bias and a group limit (4 groups, 2 used)
    "tiny-deepseek-v3": dict(
        vocab=512, hidden=256, layers=3, dense=1, heads=4, q_lora=256,
        kv_lora=64, rope=32, nope=64, v=64, ffn=512, experts=8, topk=2,
        expert_ffn=256, shared=1, gating=2, scale=2.5, norm=True,
        groups=(4, 2), ctx=256, rope_base=10000.0),
    # DeepSeek-V2-Lite's layout: a dense wq, softmax routing without
    # renormalisation, DeepSeek-V2's routed scale 16 (so the scale shows)
    "tiny-deepseek-v2-lite": dict(
        vocab=512, hidden=256, layers=3, dense=1, heads=4, q_lora=0,
        kv_lora=64, rope=32, nope=64, v=64, ffn=512, experts=8, topk=2,
        expert_ffn=256, shared=2, gating=1, scale=16.0, norm=False,
        groups=(1, 1), ctx=256, rope_base=10000.0),
    # Moonlight's layout: a dense wq, sigmoid routing with the bias, one
    # group, top-6, routed scale 2.446, renormalised, 2 shared experts
    "tiny-moonlight": dict(
        vocab=512, hidden=256, layers=3, dense=1, heads=4, q_lora=0,
        kv_lora=64, rope=32, nope=64, v=64, ffn=512, experts=16, topk=6,
        expert_ffn=256, shared=2, gating=2, scale=2.446, norm=True,
        groups=(1, 1), ctx=256, rope_base=50000.0),
    # moonshotai/Moonlight-16B-A3B's config.json (model_type deepseek_v3):
    # vocab 163840, hidden 2048, 16 heads, q_lora_rank null (dense wq),
    # kv_lora_rank 512, qk_nope 128, qk_rope 64, v 128, rope theta 50000
    # without scaling, rms eps 1e-5; first_k_dense_replace 1 with a SwiGLU
    # of 11264; 64 routed experts of 1408, top-6, 2 shared, sigmoid scoring
    # with e_score_correction_bias (noaux_tc), n_group 1, routed scale
    # 2.446, norm_topk_prob; untied head. Reduced: layers 27 -> 2, the
    # leading dense layer and one MoE layer (host quantization and load
    # time; every kernel shape is local to a layer)
    "moonlight-16b-a3b-l2": dict(
        vocab=163840, hidden=2048, layers=2, dense=1, heads=16, q_lora=0,
        kv_lora=512, rope=64, nope=128, v=128, ffn=11264, experts=64,
        topk=6, expert_ffn=1408, shared=2, gating=2, scale=2.446,
        norm=True, groups=(1, 1), ctx=8192, rope_base=50000.0, eps=1e-5),
}

# Gemma-3 presets (port-only, arch gemma3): sliding-window attention on 5
# of every 6 layers at RoPE base 1e4, the 6th global at the model's base
# with its linear scaling, per-head QK RMSNorm, sandwich norms (the GGUF
# stores the +1 of Gemma's norms), GELU-tanh FFN, tied embeddings; the
# same Q4_K_M mix as the dense presets (the table Q6_K).
GEMMA3_PRESETS = {
    # the CPU tests' size: every width a multiple of 256 where a K-quant
    # needs it, head_dim 64 (a power of 2, for the TurboQuant formats), a
    # window of 16 shorter than the tests' prompts
    "tiny-gemma3": dict(
        vocab=512, hidden=256, layers=6, heads=4, kv_heads=2, head_dim=64,
        ffn=512, window=16, rope_base=1e6, rope_linear=8.0, ctx=2048),
    # google/gemma-3-4b-it config.json, text_config: vocab 262208, hidden
    # 2560, 8 heads and 4 KV heads of head_dim 256, FFN 10240, sliding
    # window 1024 with pattern 6, rope_theta 1e6 with linear scaling x8 on
    # the global layers and rope_local_base_freq 1e4 on the local ones,
    # query_pre_attn_scalar 256 (= head_dim: the default scale), tied
    # embeddings, 131072 positions. Reduced: layers 34 -> 6, one period (5
    # local, 1 global), for chip_smoke.py's time limit; every width is a
    # multiple of 256, so each matrix takes the mix's own K-quant
    "gemma-3-4b-l6": dict(
        vocab=262208, hidden=2560, layers=6, heads=8, kv_heads=4,
        head_dim=256, ffn=10240, window=1024, rope_base=1e6,
        rope_linear=8.0, ctx=131072),
}


# MoE presets routed past softmax-top-k (port-only; the tensor names and
# GGUF keys of tests/test_arch_zoo.py's gpt-oss, phimoe and llama4 builders,
# random weights): gpt-oss (router and per-expert biases, sinks, sliding
# window on even layers, clamped SwiGLU, the YaRN keys the JAX parse_config
# reads), PhiMoE (sparsemixer top-2, LayerNorm with biases; its
# router_jitter_eps is the architecture's default 0.01) and llama4 (MoE on
# odd layers with a shared expert, sigmoid routing scaling the expert input,
# chunked attention, NoPE every 4th layer, L2 QK-norm, temperature tuning).
# The Q4_K_M mix: attention, gate/up and the experts' gate/up Q4_K; the
# down projections, the table and the head Q6_K; a K-quant whose
# super-block does not divide the row falls back to Q5_1 (_quant_put);
# routers, biases, sinks and norms F32.
ROUTING_PRESETS = {
    # the CPU tests' size: every width a multiple of 256
    "tiny-gpt-oss": dict(
        arch="gpt-oss", vocab=512, hidden=256, layers=2, heads=4,
        kv_heads=2, head_dim=64, experts=8, topk=4, expert_ffn=256,
        window=16, ctx=2048, rope_base=150000.0),
    "tiny-phimoe": dict(
        arch="phimoe", vocab=512, hidden=256, layers=2, heads=4,
        kv_heads=2, head_dim=64, experts=8, topk=2, expert_ffn=256,
        ctx=2048, rope_base=10000.0),
    "tiny-llama4": dict(
        arch="llama4", vocab=512, hidden=256, layers=4, heads=4,
        kv_heads=2, head_dim=64, experts=8, topk=2, expert_ffn=256,
        ffn=512, chunk=32, ctx=2048, rope_base=500000.0),
    # openai/gpt-oss-20b config.json: vocab 201088, hidden 2880, 64 query
    # and 8 KV heads of head_dim 64, 32 experts of 2880, top-4, a sliding
    # window of 128 on the even layers (sliding / full alternating), sinks,
    # biases on q/k/v/o, the router and the experts, swiglu_limit 7.0,
    # rms_norm_eps 1e-5, untied head, rope_theta 150000 with YaRN (factor
    # 32, original context 4096, beta_fast 32, beta_slow 1), 131072
    # positions. Reduced: layers 24 -> 2 (one sliding layer and one full);
    # the real GGUFs store the experts as MXFP4, which neither package
    # reads: here every tensor with 2880-long rows is Q5_1 (the mix's
    # fallback) and attn_output (K = 4096) Q4_K
    "gpt-oss-20b-l2": dict(
        arch="gpt-oss", vocab=201088, hidden=2880, layers=2, heads=64,
        kv_heads=8, head_dim=64, experts=32, topk=4, expert_ffn=2880,
        window=128, ctx=131072, rope_base=150000.0),
}


# Encoder presets (port-only; full depth and width, random weights): the
# Q4_K_M mix (attention, up and gate|up Q4_K; ffn_down, the token table and
# an untied head Q6_K; biases, norms, position and type tables and T5's
# relative-bias table f32).
ENCODER_PRESETS = {
    # BAAI/bge-base-en-v1.5 config.json (BertModel): vocab 30522, hidden
    # 768, 12 layers, 12 heads of 64, intermediate 3072, GELU, 512
    # positions, type vocab 2, layer_norm_eps 1e-12, CLS pooling
    "bge-base-en-v1.5": dict(
        arch="bert", vocab=30522, hidden=768, layers=12, heads=12, ffn=3072,
        ctx=512, types=2, eps=1e-12),
    # google/flan-t5-base config.json: vocab 32128, d_model 768, 12 heads
    # of d_kv 64, d_ff 2048, gated-GELU, 12 encoder and 12 decoder layers,
    # 32 relative buckets, max distance 128, layer_norm_epsilon 1e-6,
    # untied lm_head, decoder_start_token_id 0; 512 positions (n_positions)
    "flan-t5-base": dict(
        arch="t5", vocab=32128, hidden=768, layers=12, heads=12, hd=64,
        ffn=2048, buckets=32, max_distance=128, ctx=512, eps=1e-6),
    # its t5encoder variant: the same encoder stack, no decoder
    "flan-t5-base-encoder": dict(
        arch="t5encoder", vocab=32128, hidden=768, layers=12, heads=12,
        hd=64, ffn=2048, buckets=32, max_distance=128, ctx=512, eps=1e-6),
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
    if preset in FALCONH1_PRESETS:
        return _build_falconh1(path, preset, quant, seed, max_ctx)
    if preset in SSM_PRESETS:
        return _build_ssm(path, preset, quant, seed, max_ctx)
    if preset in MLA_PRESETS:
        return _build_deepseek2(path, preset, quant, seed, max_ctx)
    if preset in GEMMA3_PRESETS:
        return _build_gemma3(path, preset, quant, seed, max_ctx)
    if preset in ENCODER_PRESETS:
        return _build_encoder(path, preset, quant, seed)
    if preset in ROUTING_PRESETS:
        return _build_routing(path, preset, quant, seed, max_ctx)
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


def _build_falconh1(path: str, preset: str, quant: GGMLType, seed: int,
                    max_ctx: int | None) -> str:
    """Falcon-H1-convention parallel hybrid: attention + Mamba-2 mixer in
    every block (in_proj = [z|xBC|dt], ssm_a = -exp(A_log) per head,
    per-group gated ssm_norm stored [ng, di/ng])."""
    (vocab, hidden, layers, heads, kv_heads, ffn, ctx,
     di, ds, ng, nh, conv) = FALCONH1_PRESETS[preset]
    if max_ctx:
        ctx = min(ctx, max_ctx)
    head_dim = hidden // heads
    rng = np.random.default_rng(seed)

    def rw(*shape):
        return (rng.standard_normal(shape).astype(np.float32) * 0.02)

    a = "falcon-h1"
    w = GGUFWriter()
    w.add_metadata("general.architecture", a)
    w.add_metadata("general.name", f"synthetic-{preset}")
    w.add_metadata(f"{a}.embedding_length", hidden)
    w.add_metadata(f"{a}.block_count", layers)
    w.add_metadata(f"{a}.attention.head_count", heads)
    w.add_metadata(f"{a}.attention.head_count_kv", kv_heads)
    w.add_metadata(f"{a}.feed_forward_length", ffn)
    w.add_metadata(f"{a}.context_length", ctx)
    w.add_metadata(f"{a}.attention.layer_norm_rms_epsilon", 1e-6)
    w.add_metadata(f"{a}.rope.freq_base", 10000.0)
    w.add_metadata(f"{a}.ssm.inner_size", di)
    w.add_metadata(f"{a}.ssm.state_size", ds)
    w.add_metadata(f"{a}.ssm.group_count", ng)
    w.add_metadata(f"{a}.ssm.time_step_rank", nh)
    w.add_metadata(f"{a}.ssm.conv_kernel", conv)
    w.add_metadata(f"{a}.vocab_size", vocab)
    _add_tokenizer(w, vocab)

    def addq(name, arr, q=quant):
        _quant_put(w, name, arr, q)

    conv_dim = di + 2 * ng * ds
    addq("token_embd.weight", rw(vocab, hidden),
         GGMLType.F32 if quant == GGMLType.F32 else GGMLType.Q8_0)
    for i in range(layers):
        p = f"blk.{i}"
        w.add_tensor_np(f"{p}.attn_norm.weight",
                        np.ones(hidden, np.float32) + rw(hidden))
        w.add_tensor_np(f"{p}.ffn_norm.weight",
                        np.ones(hidden, np.float32) + rw(hidden))
        addq(f"{p}.attn_q.weight", rw(heads * head_dim, hidden))
        addq(f"{p}.attn_k.weight", rw(kv_heads * head_dim, hidden))
        addq(f"{p}.attn_v.weight", rw(kv_heads * head_dim, hidden))
        addq(f"{p}.attn_output.weight", rw(hidden, heads * head_dim))
        addq(f"{p}.ssm_in.weight", rw(2 * di + 2 * ng * ds + nh, hidden))
        w.add_tensor_np(f"{p}.ssm_conv1d.weight", rw(conv_dim, conv))
        w.add_tensor_np(f"{p}.ssm_conv1d.bias", rw(conv_dim))
        w.add_tensor_np(f"{p}.ssm_dt.bias", rw(nh))
        w.add_tensor_np(f"{p}.ssm_a", -np.exp(rw(nh)).astype(np.float32))
        w.add_tensor_np(f"{p}.ssm_d", rw(nh))
        w.add_tensor_np(f"{p}.ssm_norm.weight",
                        (np.ones(di, np.float32) + rw(di)).reshape(ng, -1))
        addq(f"{p}.ssm_out.weight", rw(hidden, di))
        addq(f"{p}.ffn_gate.weight", rw(ffn, hidden))
        addq(f"{p}.ffn_up.weight", rw(ffn, hidden))
        addq(f"{p}.ffn_down.weight", rw(hidden, ffn))
    w.add_tensor_np("output_norm.weight",
                    np.ones(hidden, np.float32) + rw(hidden))
    addq("output.weight", rw(vocab, hidden),
         GGMLType.F32 if quant == GGMLType.F32 else GGMLType.Q8_0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    w.write_to_path(path)
    return path


def _build_ssm(path: str, preset: str, quant: GGMLType, seed: int,
               max_ctx: int | None) -> str:
    """A port-only Mamba-family preset (SSM_PRESETS), in the llama.cpp
    tensor names the JAX loader reads: Mamba-1 blk.N.ssm_{in,conv1d,x,dt,
    a,d,out} (+ Jamba's ssm_{dt,b,c}_norm), Mamba-2 ssm_in = [z|xBC|dt]
    with per-head ssm_a/ssm_d and ssm_norm [ng, di/ng], LFM2's
    shortconv.{in_proj,conv,out_proj}, attention q/k/v/o (LFM2 with QK
    norms), and a SwiGLU or routed FFN half under ffn_norm."""
    c = SSM_PRESETS[preset]
    a, vocab, hidden, kinds = c["arch"], c["vocab"], c["hidden"], c["kinds"]
    ctx = min(c["ctx"], max_ctx) if max_ctx else c["ctx"]
    heads, kv_heads = c.get("heads", 0), c.get("kv_heads", 0)
    hd = hidden // heads if heads else 0
    ffn, moe = c.get("ffn", 0), c.get("moe", ())
    di, ds, conv = c.get("di", 0), c.get("ds", 0), c.get("conv", 0)
    ng, nh, dtr = c.get("ng", 1), c.get("nh", 0), c.get("dtr", 0)
    rng = np.random.default_rng(seed)

    def rw(*shape, scale=0.02):
        return rng.standard_normal(shape).astype(np.float32) * scale

    def ones(n):
        return np.ones(n, np.float32) + rw(n)

    def dt_bias(n):  # softplus^-1 of dt drawn log-uniform in [1e-3, 0.1]
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), n))
        return (dt + np.log(-np.expm1(-dt))).astype(np.float32)

    w = GGUFWriter()
    md = {"embedding_length": hidden, "block_count": len(kinds),
          "context_length": ctx, "vocab_size": vocab,
          "attention.layer_norm_rms_epsilon": c.get("eps", 1e-6)}
    if heads:
        md.update({"attention.head_count": heads,
                   "attention.head_count_kv": kv_heads,
                   "attention.key_length": hd, "attention.value_length": hd,
                   "rope.freq_base": c.get("rope_base", 10000.0)})
        if "a" in kinds and a != "lfm2":  # Jamba and Granite: NoPE
            md["rope.dimension_count"] = 0
    if ffn:
        md["feed_forward_length"] = ffn
    if di:
        md.update({"ssm.inner_size": di, "ssm.state_size": ds,
                   "ssm.conv_kernel": conv,
                   "ssm.time_step_rank": nh or dtr})
        if nh:  # Mamba-2: its B/C groups
            md["ssm.group_count"] = ng
    if "lc" in c:
        md["shortconv.l_cache"] = c["lc"]
    if moe:
        md.update({"expert_count": c["experts"],
                   "expert_used_count": c["topk"]})
    if "granite" in c:
        emb, logit, resid, attn = c["granite"]
        md.update({"embedding_scale": emb, "logit_scale": logit,
                   "residual_scale": resid, "attention.scale": attn})
    w.add_metadata("general.architecture", a)
    w.add_metadata("general.name", f"synthetic-{preset}")
    for key, value in md.items():
        w.add_metadata(f"{a}.{key}", value)
    _add_tokenizer(w, vocab)

    f32 = quant == GGMLType.F32
    q6 = GGMLType.F32 if f32 else GGMLType.Q6_K
    emb_q = GGMLType.F32 if f32 else (GGMLType.Q6_K if hidden % 256 == 0
                                      else GGMLType.Q8_0)

    def addq(name, arr, q=quant):
        _quant_put(w, name, arr, q)

    addq("token_embd.weight", rw(vocab, hidden), emb_q)
    for i, kind in enumerate(kinds):
        p = f"blk.{i}"
        w.add_tensor_np(f"{p}.attn_norm.weight", ones(hidden))
        if kind == "a":
            addq(f"{p}.attn_q.weight", rw(heads * hd, hidden))
            addq(f"{p}.attn_k.weight", rw(kv_heads * hd, hidden))
            addq(f"{p}.attn_v.weight", rw(kv_heads * hd, hidden))
            addq(f"{p}.attn_output.weight", rw(hidden, heads * hd))
            if a == "lfm2":
                w.add_tensor_np(f"{p}.attn_q_norm.weight", ones(hd))
                w.add_tensor_np(f"{p}.attn_k_norm.weight", ones(hd))
        elif kind == "c":
            lc = c["lc"]
            addq(f"{p}.shortconv.in_proj.weight", rw(3 * hidden, hidden))
            w.add_tensor_np(f"{p}.shortconv.conv.weight",
                            rw(hidden, lc, scale=0.3))
            addq(f"{p}.shortconv.out_proj.weight", rw(hidden, hidden))
        elif kind == "m":
            addq(f"{p}.ssm_in.weight", rw(2 * di, hidden))
            w.add_tensor_np(f"{p}.ssm_conv1d.weight", rw(di, conv, scale=0.3))
            w.add_tensor_np(f"{p}.ssm_conv1d.bias", rw(di))
            addq(f"{p}.ssm_x.weight", rw(dtr + 2 * ds, di))
            addq(f"{p}.ssm_dt.weight", rw(di, dtr, scale=0.1))
            w.add_tensor_np(f"{p}.ssm_dt.bias", dt_bias(di))
            w.add_tensor_np(f"{p}.ssm_a", -np.tile(
                np.arange(1, ds + 1, dtype=np.float32), (di, 1)))
            w.add_tensor_np(f"{p}.ssm_d", ones(di))
            addq(f"{p}.ssm_out.weight", rw(hidden, di))
            for tag, n in (("dt", dtr), ("b", ds), ("c", ds)) \
                    if a == "jamba" else ():
                w.add_tensor_np(f"{p}.ssm_{tag}_norm.weight", ones(n))
        else:  # Mamba-2
            conv_dim = di + 2 * ng * ds
            addq(f"{p}.ssm_in.weight", rw(2 * di + 2 * ng * ds + nh, hidden))
            w.add_tensor_np(f"{p}.ssm_conv1d.weight",
                            rw(conv_dim, conv, scale=0.3))
            w.add_tensor_np(f"{p}.ssm_conv1d.bias", rw(conv_dim))
            w.add_tensor_np(f"{p}.ssm_dt.bias", dt_bias(nh))
            w.add_tensor_np(f"{p}.ssm_a",
                            -np.arange(1, nh + 1, dtype=np.float32))
            w.add_tensor_np(f"{p}.ssm_d", ones(nh))
            w.add_tensor_np(f"{p}.ssm_norm.weight", ones(di).reshape(ng, -1))
            addq(f"{p}.ssm_out.weight", rw(hidden, di))
        if not ffn:
            continue
        w.add_tensor_np(f"{p}.ffn_norm.weight", ones(hidden))
        if i in moe:
            e = c["experts"]
            w.add_tensor_np(f"{p}.ffn_gate_inp.weight", rw(e, hidden))
            addq(f"{p}.ffn_gate_exps.weight", rw(e, ffn, hidden))
            addq(f"{p}.ffn_up_exps.weight", rw(e, ffn, hidden))
            addq(f"{p}.ffn_down_exps.weight", rw(e, hidden, ffn), q6)
        else:
            addq(f"{p}.ffn_gate.weight", rw(ffn, hidden))
            addq(f"{p}.ffn_up.weight", rw(ffn, hidden))
            addq(f"{p}.ffn_down.weight", rw(hidden, ffn), q6)
    # LFM2 keeps its final norm under token_embd_norm
    final = "token_embd_norm" if a == "lfm2" else "output_norm"
    w.add_tensor_np(f"{final}.weight", ones(hidden))
    if not c["tie"]:
        addq("output.weight", rw(vocab, hidden), emb_q)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    w.write_to_path(path)
    return path


def _build_deepseek2(path: str, preset: str, quant: GGMLType, seed: int,
                     max_ctx: int | None) -> str:
    """A port-only DeepSeek-family preset (MLA_PRESETS) under arch
    deepseek2, with the GGUF keys the JAX parse_config reads."""
    c = MLA_PRESETS[preset]
    a, hidden, heads = "deepseek2", c["hidden"], c["heads"]
    nope, rope, v, rank = c["nope"], c["rope"], c["v"], c["kv_lora"]
    e, ef = c["experts"], c["expert_ffn"]
    ctx = min(c["ctx"], max_ctx) if max_ctx else c["ctx"]
    rng = np.random.default_rng(seed)

    def rw(*shape, scale=0.02):
        return rng.standard_normal(shape).astype(np.float32) * scale

    def ones(n):
        return np.ones(n, np.float32) + rw(n)

    md = {"embedding_length": hidden, "block_count": c["layers"],
          "context_length": ctx, "vocab_size": c["vocab"],
          "attention.layer_norm_rms_epsilon": c.get("eps", 1e-6),
          "attention.head_count": heads, "attention.head_count_kv": heads,
          "attention.key_length": nope + rope, "attention.value_length": v,
          "attention.kv_lora_rank": rank, "rope.dimension_count": rope,
          "rope.freq_base": c["rope_base"], "feed_forward_length": c["ffn"],
          "leading_dense_block_count": c["dense"], "expert_count": e,
          "expert_used_count": c["topk"], "expert_feed_forward_length": ef,
          "expert_shared_count": c["shared"],
          "expert_gating_func": c["gating"],
          "expert_weights_scale": c["scale"],
          "expert_weights_norm": c["norm"],
          "expert_group_count": c["groups"][0],
          "expert_group_used_count": c["groups"][1]}
    if c["q_lora"]:
        md["attention.q_lora_rank"] = c["q_lora"]
    w = GGUFWriter()
    w.add_metadata("general.architecture", a)
    w.add_metadata("general.name", f"synthetic-{preset}")
    for key, value in md.items():
        w.add_metadata(f"{a}.{key}", value)
    _add_tokenizer(w, c["vocab"])

    f32 = quant == GGMLType.F32
    q6 = GGMLType.F32 if f32 else GGMLType.Q6_K

    def addq(name, arr, q=quant):
        _quant_put(w, name, arr, q)

    addq("token_embd.weight", rw(c["vocab"], hidden), q6)
    for i in range(c["layers"]):
        p = f"blk.{i}"
        w.add_tensor_np(f"{p}.attn_norm.weight", ones(hidden))
        if c["q_lora"]:
            addq(f"{p}.attn_q_a.weight", rw(c["q_lora"], hidden))
            w.add_tensor_np(f"{p}.attn_q_a_norm.weight", ones(c["q_lora"]))
            addq(f"{p}.attn_q_b.weight",
                 rw(heads * (nope + rope), c["q_lora"]))
        else:
            addq(f"{p}.attn_q.weight", rw(heads * (nope + rope), hidden))
        addq(f"{p}.attn_kv_a_mqa.weight", rw(rank + rope, hidden))
        w.add_tensor_np(f"{p}.attn_kv_a_norm.weight", ones(rank))
        addq(f"{p}.attn_kv_b.weight", rw(heads * (nope + v), rank))
        addq(f"{p}.attn_output.weight", rw(hidden, heads * v))
        w.add_tensor_np(f"{p}.ffn_norm.weight", ones(hidden))
        if i < c["dense"]:
            addq(f"{p}.ffn_gate.weight", rw(c["ffn"], hidden))
            addq(f"{p}.ffn_up.weight", rw(c["ffn"], hidden))
            addq(f"{p}.ffn_down.weight", rw(hidden, c["ffn"]), q6)
            continue
        sf = c["shared"] * ef
        w.add_tensor_np(f"{p}.ffn_gate_inp.weight", rw(e, hidden))
        if c["gating"] == 2:
            w.add_tensor_np(f"{p}.exp_probs_b.bias", rw(e, scale=0.05))
        addq(f"{p}.ffn_gate_exps.weight", rw(e, ef, hidden))
        addq(f"{p}.ffn_up_exps.weight", rw(e, ef, hidden))
        addq(f"{p}.ffn_down_exps.weight", rw(e, hidden, ef), q6)
        addq(f"{p}.ffn_gate_shexp.weight", rw(sf, hidden))
        addq(f"{p}.ffn_up_shexp.weight", rw(sf, hidden))
        addq(f"{p}.ffn_down_shexp.weight", rw(hidden, sf), q6)
    w.add_tensor_np("output_norm.weight", ones(hidden))
    addq("output.weight", rw(c["vocab"], hidden), q6)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    w.write_to_path(path)
    return path


def _build_gemma3(path: str, preset: str, quant: GGMLType, seed: int,
                  max_ctx: int | None) -> str:
    """A port-only Gemma-3 preset (GEMMA3_PRESETS) under arch gemma3, with
    the GGUF keys the JAX parse_config reads (the local layers' base 1e4
    and the pattern of 6 are the architecture's defaults there)."""
    c = GEMMA3_PRESETS[preset]
    a, hidden, hd = "gemma3", c["hidden"], c["head_dim"]
    heads, kvh = c["heads"], c["kv_heads"]
    ctx = min(c["ctx"], max_ctx) if max_ctx else c["ctx"]
    rng = np.random.default_rng(seed)

    def rw(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    def ones(n):
        return np.ones(n, np.float32) + rw(n)

    md = {"embedding_length": hidden, "block_count": c["layers"],
          "context_length": ctx, "vocab_size": c["vocab"],
          "attention.layer_norm_rms_epsilon": 1e-6,
          "attention.head_count": heads, "attention.head_count_kv": kvh,
          "attention.key_length": hd, "attention.value_length": hd,
          "attention.sliding_window": c["window"],
          "rope.freq_base": c["rope_base"], "rope.scaling.type": "linear",
          "rope.scaling.factor": c["rope_linear"],
          "feed_forward_length": c["ffn"]}
    w = GGUFWriter()
    w.add_metadata("general.architecture", a)
    w.add_metadata("general.name", f"synthetic-{preset}")
    for key, value in md.items():
        w.add_metadata(f"{a}.{key}", value)
    _add_tokenizer(w, c["vocab"])

    q6 = GGMLType.F32 if quant == GGMLType.F32 else GGMLType.Q6_K

    def addq(name, arr, q=quant):
        _quant_put(w, name, arr, q)

    addq("token_embd.weight", rw(c["vocab"], hidden), q6)
    for i in range(c["layers"]):
        p = f"blk.{i}"
        addq(f"{p}.attn_q.weight", rw(heads * hd, hidden))
        addq(f"{p}.attn_k.weight", rw(kvh * hd, hidden))
        addq(f"{p}.attn_v.weight", rw(kvh * hd, hidden))
        addq(f"{p}.attn_output.weight", rw(hidden, heads * hd))
        for norm, n in (("attn_q_norm", hd), ("attn_k_norm", hd),
                        ("attn_norm", hidden), ("post_attention_norm", hidden),
                        ("ffn_norm", hidden), ("post_ffw_norm", hidden)):
            w.add_tensor_np(f"{p}.{norm}.weight", ones(n))
        addq(f"{p}.ffn_gate.weight", rw(c["ffn"], hidden))
        addq(f"{p}.ffn_up.weight", rw(c["ffn"], hidden))
        addq(f"{p}.ffn_down.weight", rw(hidden, c["ffn"]), q6)
    w.add_tensor_np("output_norm.weight", ones(hidden))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    w.write_to_path(path)
    return path


def _build_routing(path: str, preset: str, quant: GGMLType, seed: int,
                   max_ctx: int | None) -> str:
    """A ROUTING_PRESETS model under its own arch (gpt-oss, phimoe or
    llama4)."""
    c = ROUTING_PRESETS[preset]
    a, hidden, hd = c["arch"], c["hidden"], c["head_dim"]
    heads, kvh, e, ef = c["heads"], c["kv_heads"], c["experts"], c["expert_ffn"]
    ctx = min(c["ctx"], max_ctx) if max_ctx else c["ctx"]
    rng = np.random.default_rng(seed)

    def rw(*shape, scale=0.02):
        return rng.standard_normal(shape).astype(np.float32) * scale

    def ones(n):
        return np.ones(n, np.float32) + rw(n)

    md = {"embedding_length": hidden, "block_count": c["layers"],
          "context_length": ctx, "vocab_size": c["vocab"],
          "attention.layer_norm_rms_epsilon": 1e-5,
          "attention.head_count": heads, "attention.head_count_kv": kvh,
          "attention.key_length": hd, "attention.value_length": hd,
          "rope.freq_base": c["rope_base"], "expert_count": e,
          "expert_used_count": c["topk"], "expert_feed_forward_length": ef,
          "feed_forward_length": c.get("ffn", ef)}
    if a == "gpt-oss":
        md.update({"attention.sliding_window": c["window"],
                   "rope.scaling.type": "yarn", "rope.scaling.factor": 32.0,
                   "rope.scaling.original_context_length": 4096})
    if a == "llama4":
        md.update({"attention.chunk_size": c["chunk"],
                   "expert_shared_count": 1, "expert_gating_func": 2,
                   "attention.use_kq_norm": True,
                   "attention.temperature_scale": 0.1,
                   "attention.floor_scale": 16.0})
    w = GGUFWriter()
    w.add_metadata("general.architecture", a)
    w.add_metadata("general.name", f"synthetic-{preset}")
    for key, value in md.items():
        w.add_metadata(f"{a}.{key}", value)
    _add_tokenizer(w, c["vocab"])

    q6 = GGMLType.F32 if quant == GGMLType.F32 else GGMLType.Q6_K

    def addq(name, arr, q=quant):
        _quant_put(w, name, arr, q)

    def norm(name, n):
        w.add_tensor_np(f"{name}.weight", ones(n))
        if a == "phimoe":  # LayerNorm
            w.add_tensor_np(f"{name}.bias", rw(n))

    addq("token_embd.weight", rw(c["vocab"], hidden), q6)
    for i in range(c["layers"]):
        p = f"blk.{i}"
        norm(f"{p}.attn_norm", hidden)
        for key, n_out, k_in in (("q", heads * hd, hidden),
                                 ("k", kvh * hd, hidden),
                                 ("v", kvh * hd, hidden),
                                 ("output", hidden, heads * hd)):
            addq(f"{p}.attn_{key}.weight", rw(n_out, k_in))
            if a == "gpt-oss":
                w.add_tensor_np(f"{p}.attn_{key}.bias", rw(n_out))
        if a == "gpt-oss":
            w.add_tensor_np(f"{p}.attn_sinks.weight", rw(heads, scale=0.5))
        norm(f"{p}.ffn_norm", hidden)
        if a == "llama4" and i % 2 == 0:  # llama4's dense layers
            addq(f"{p}.ffn_gate.weight", rw(c["ffn"], hidden))
            addq(f"{p}.ffn_up.weight", rw(c["ffn"], hidden))
            addq(f"{p}.ffn_down.weight", rw(hidden, c["ffn"]), q6)
            continue
        w.add_tensor_np(f"{p}.ffn_gate_inp.weight", rw(e, hidden))
        addq(f"{p}.ffn_gate_exps.weight", rw(e, ef, hidden))
        addq(f"{p}.ffn_up_exps.weight", rw(e, ef, hidden))
        addq(f"{p}.ffn_down_exps.weight", rw(e, hidden, ef), q6)
        if a == "gpt-oss":
            w.add_tensor_np(f"{p}.ffn_gate_inp.bias", rw(e, scale=0.1))
            for key, n in (("gate", ef), ("up", ef), ("down", hidden)):
                w.add_tensor_np(f"{p}.ffn_{key}_exps.bias", rw(e, n))
        if a == "llama4":
            addq(f"{p}.ffn_gate_shexp.weight", rw(ef, hidden))
            addq(f"{p}.ffn_up_shexp.weight", rw(ef, hidden))
            addq(f"{p}.ffn_down_shexp.weight", rw(hidden, ef), q6)
    norm("output_norm", hidden)
    addq("output.weight", rw(c["vocab"], hidden), q6)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    w.write_to_path(path)
    return path


def _add_tokenizer(w: GGUFWriter, vocab: int, cap: int = 4096) -> None:
    """Minimal byte-fallback SPM tokenizer metadata (at most ``cap``
    tokens)."""
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    ttypes = [2, 3, 3] + [6] * 256
    while len(toks) < min(vocab, cap):
        toks.append(f"tok{len(toks)}")
        ttypes.append(1)
    w.add_metadata("tokenizer.ggml.model", "llama")
    w.add_metadata("tokenizer.ggml.tokens", toks)
    w.add_metadata("tokenizer.ggml.scores", np.zeros(len(toks), np.float32))
    w.add_metadata("tokenizer.ggml.token_type", np.array(ttypes, np.int32))
    w.add_metadata("tokenizer.ggml.bos_token_id", 1)
    w.add_metadata("tokenizer.ggml.eos_token_id", 2)
    w.add_metadata("tokenizer.ggml.unknown_token_id", 0)


def build_synthetic_t5(path: str, vocab: int = 512, hidden: int = 64,
                       layers: int = 2, heads: int = 4, hd: int = 16,
                       ffn: int = 128, gated: bool = False,
                       decoder: bool = True, seed: int = 0, *,
                       quant: GGMLType = GGMLType.F32, buckets: int = 8,
                       max_distance: int = 20, ctx: int = 512,
                       eps: float = 1e-6, untied: bool = False,
                       name: str = "synthetic-tiny-t5",
                       tokenizer_cap: int = 4096,
                       hf_init: bool = False) -> str:
    """Synthetic T5 GGUF (llama.cpp enc./dec. naming); ``decoder=False``
    emits an encoder-only `t5encoder` model. At the defaults, the JAX
    builder's bytes. ``quant``: the Q4_K_M mix (attention, cross-attention
    and gate/up in ``quant``; ffn_down, the token table and the head
    Q6_K); ``untied``: an output.weight after the stacks (flan-t5);
    ``hf_init``: each matrix drawn at the standard deviation of HF's
    T5PreTrainedModel._init_weights (q (d_model d_kv)^-1/2, k, v, the FFN
    input and the bias table d_model^-1/2, o (heads d_kv)^-1/2, the FFN
    output d_ff^-1/2, the embedding and head 1) instead of 0.05 for all:
    at full width 0.05 makes the unscaled q.k scores ~15 wide, and the
    attention then multiplies a 1e-6 error by 2-5 in every layer."""
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(seed)
    std = dict(q=(hidden * hd) ** -0.5, kv=hidden ** -0.5,
               o=(heads * hd) ** -0.5, ffn_in=hidden ** -0.5,
               ffn_out=ffn ** -0.5, rel=hidden ** -0.5, embed=1.0)

    def rw(*shape, kind=None):
        arr = rng.standard_normal(shape).astype(np.float32)
        if hf_init and kind is not None:
            return arr * np.float32(std[kind])
        return arr * 0.05

    q6 = GGMLType.F32 if quant == GGMLType.F32 else GGMLType.Q6_K

    def addq(name_, arr, q=quant):
        if q == GGMLType.F32:
            w.add_tensor_np(name_, arr)
        else:
            _quant_put(w, name_, arr, q)

    a = "t5" if decoder else "t5encoder"
    w = GGUFWriter()
    w.add_metadata("general.architecture", a)
    w.add_metadata("general.name", name)
    w.add_metadata(f"{a}.embedding_length", hidden)
    w.add_metadata(f"{a}.block_count", layers)
    w.add_metadata(f"{a}.attention.head_count", heads)
    w.add_metadata(f"{a}.attention.key_length", hd)
    w.add_metadata(f"{a}.attention.value_length", hd)
    w.add_metadata(f"{a}.attention.relative_buckets_count", buckets)
    w.add_metadata(f"{a}.attention.relative_max_distance", max_distance)
    w.add_metadata(f"{a}.decoder_start_token_id", 0)
    w.add_metadata(f"{a}.feed_forward_length", ffn)
    w.add_metadata(f"{a}.context_length", ctx)
    w.add_metadata(f"{a}.attention.layer_norm_rms_epsilon", eps)
    w.add_metadata(f"{a}.vocab_size", vocab)
    _add_tokenizer(w, vocab, tokenizer_cap)
    addq("token_embd.weight", rw(vocab, hidden, kind="embed"), q6)
    for pre in (("enc", "dec") if decoder else ("enc",)):
        for i in range(layers):
            p = f"{pre}.blk.{i}"
            addq(f"{p}.attn_q.weight", rw(heads * hd, hidden, kind="q"))
            addq(f"{p}.attn_k.weight", rw(heads * hd, hidden, kind="kv"))
            addq(f"{p}.attn_v.weight", rw(heads * hd, hidden, kind="kv"))
            addq(f"{p}.attn_o.weight", rw(hidden, heads * hd, kind="o"))
            w.add_tensor_np(f"{p}.attn_norm.weight",
                            np.ones(hidden, np.float32) + rw(hidden))
            if i == 0:
                w.add_tensor_np(f"{p}.attn_rel_b.weight",
                                rw(buckets, heads, kind="rel"))
            if pre == "dec":
                for key, kind, shape in (("q", "q", (heads * hd, hidden)),
                                         ("k", "kv", (heads * hd, hidden)),
                                         ("v", "kv", (heads * hd, hidden)),
                                         ("o", "o", (hidden, heads * hd))):
                    addq(f"{p}.cross_attn_{key}.weight",
                         rw(*shape, kind=kind))
                w.add_tensor_np(f"{p}.cross_attn_norm.weight",
                                np.ones(hidden, np.float32) + rw(hidden))
            if gated:
                addq(f"{p}.ffn_gate.weight", rw(ffn, hidden, kind="ffn_in"))
            addq(f"{p}.ffn_up.weight", rw(ffn, hidden, kind="ffn_in"))
            addq(f"{p}.ffn_down.weight", rw(hidden, ffn, kind="ffn_out"), q6)
            w.add_tensor_np(f"{p}.ffn_norm.weight",
                            np.ones(hidden, np.float32) + rw(hidden))
        w.add_tensor_np(f"{pre}.output_norm.weight",
                        np.ones(hidden, np.float32) + rw(hidden))
    if untied:
        addq("output.weight", rw(vocab, hidden, kind="embed"), q6)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    w.write_to_path(path)
    return path


# WordPiece pieces of the synthetic BERT tokenizer: the specials at BERT's
# own ids are not kept; these come first, then every piece again with the
# "##" continuation prefix, then filler up to the vocab size
_BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
_BERT_PIECES = tuple("abcdefghijklmnopqrstuvwxyz0123456789.,;:!?'\"()-") + (
    "the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog", "and",
    "embed", "ding", "search", "query", "passage", "model", "text")


def _add_bert_tokenizer(w: GGUFWriter, vocab: int) -> None:
    """WordPiece ("bert") tokenizer metadata: [CLS] and [SEP] around every
    input (add_bos/add_eos), characters and a few words, each also as a
    "##" continuation, so any lowercase ASCII text tokenizes."""
    toks = list(_BERT_SPECIALS) + list(_BERT_PIECES) + [
        "##" + t for t in _BERT_PIECES]
    while len(toks) < vocab:
        toks.append(f"[unused{len(toks)}]")
    ttypes = [3] * len(_BERT_SPECIALS) + [1] * (len(toks) - len(_BERT_SPECIALS))
    w.add_metadata("tokenizer.ggml.model", "bert")
    w.add_metadata("tokenizer.ggml.tokens", toks)
    w.add_metadata("tokenizer.ggml.token_type", np.array(ttypes, np.int32))
    for key, tid in (("padding_token_id", 0), ("unknown_token_id", 1),
                     ("bos_token_id", 2), ("eos_token_id", 3)):
        w.add_metadata(f"tokenizer.ggml.{key}", tid)
    w.add_metadata("tokenizer.ggml.add_bos_token", True)
    w.add_metadata("tokenizer.ggml.add_eos_token", True)


def build_synthetic_bert(path: str, vocab: int = 64, hidden: int = 32,
                         layers: int = 2, heads: int = 4, ffn: int = 64,
                         ctx: int = 32, seed: int = 0,
                         quant: GGMLType = GGMLType.F32, types: int = 2,
                         eps: float = 1e-5, name: str = "tiny-bert",
                         wordpiece: bool = False, scale: float = 0.1) -> str:
    """A BERT GGUF in the tensor names of the JAX package's BERT test
    builder (token_embd, position_embd, token_types, token_embd_norm;
    blk.N.attn_{q,k,v,output} with biases, attn_output_norm, ffn_up,
    ffn_down, layer_output_norm). ``quant``: the Q4_K_M mix (q, k, v,
    output and up in ``quant``; ffn_down and the token table Q6_K);
    ``wordpiece``: a WordPiece tokenizer that tokenizes lowercase ASCII
    (else the test builder's "tokN" vocabulary); ``scale``: the weights'
    standard deviation (the test builder's 0.1; BERT's initializer_range
    is 0.02)."""
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(seed)
    q6 = GGMLType.F32 if quant == GGMLType.F32 else GGMLType.Q6_K
    w = GGUFWriter()
    w.add_metadata("general.architecture", "bert")
    w.add_metadata("general.name", name)
    w.add_metadata("bert.block_count", layers)
    w.add_metadata("bert.embedding_length", hidden)
    w.add_metadata("bert.attention.head_count", heads)
    w.add_metadata("bert.feed_forward_length", ffn)
    w.add_metadata("bert.context_length", ctx)
    w.add_metadata("bert.attention.layer_norm_epsilon", eps)
    w.add_metadata("bert.pooling_type", 2)  # CLS
    if wordpiece:
        _add_bert_tokenizer(w, vocab)
    else:
        w.add_metadata("tokenizer.ggml.model", "bert")
        w.add_metadata("tokenizer.ggml.tokens",
                       [f"tok{i}" for i in range(vocab)])
        w.add_metadata("tokenizer.ggml.token_type", [1] * vocab)

    def t(name_, shape, offset=0.0, q=GGMLType.F32):
        arr = rng.normal(size=shape).astype(np.float32) * scale + offset
        if q == GGMLType.F32:
            w.add_tensor_np(name_, arr)
        else:
            _quant_put(w, name_, arr, q)

    t("token_embd.weight", (vocab, hidden), q=q6)
    t("position_embd.weight", (ctx, hidden))
    t("token_types.weight", (types, hidden))
    t("token_embd_norm.weight", (hidden,), offset=1.0)
    t("token_embd_norm.bias", (hidden,))
    for i in range(layers):
        p = f"blk.{i}"
        for nm, shape, off, q in (
            (f"{p}.attn_q.weight", (hidden, hidden), 0.0, quant),
            (f"{p}.attn_q.bias", (hidden,), 0.0, GGMLType.F32),
            (f"{p}.attn_k.weight", (hidden, hidden), 0.0, quant),
            (f"{p}.attn_k.bias", (hidden,), 0.0, GGMLType.F32),
            (f"{p}.attn_v.weight", (hidden, hidden), 0.0, quant),
            (f"{p}.attn_v.bias", (hidden,), 0.0, GGMLType.F32),
            (f"{p}.attn_output.weight", (hidden, hidden), 0.0, quant),
            (f"{p}.attn_output.bias", (hidden,), 0.0, GGMLType.F32),
            (f"{p}.attn_output_norm.weight", (hidden,), 1.0, GGMLType.F32),
            (f"{p}.attn_output_norm.bias", (hidden,), 0.0, GGMLType.F32),
            (f"{p}.ffn_up.weight", (ffn, hidden), 0.0, quant),
            (f"{p}.ffn_up.bias", (ffn,), 0.0, GGMLType.F32),
            (f"{p}.ffn_down.weight", (hidden, ffn), 0.0, q6),
            (f"{p}.ffn_down.bias", (hidden,), 0.0, GGMLType.F32),
            (f"{p}.layer_output_norm.weight", (hidden,), 1.0, GGMLType.F32),
            (f"{p}.layer_output_norm.bias", (hidden,), 0.0, GGMLType.F32),
        ):
            t(nm, shape, offset=off, q=q)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    w.write_to_path(path)
    return path


def _build_encoder(path: str, preset: str, quant: GGMLType,
                   seed: int) -> str:
    """An ENCODER_PRESETS model at ``quant``'s mix."""
    c = ENCODER_PRESETS[preset]
    if c["arch"] == "bert":
        return build_synthetic_bert(
            path, vocab=c["vocab"], hidden=c["hidden"], layers=c["layers"],
            heads=c["heads"], ffn=c["ffn"], ctx=c["ctx"], seed=seed,
            quant=quant, types=c["types"], eps=c["eps"],
            name=f"synthetic-{preset}", wordpiece=True, scale=0.02)
    decoder = c["arch"] == "t5"
    return build_synthetic_t5(
        path, vocab=c["vocab"], hidden=c["hidden"], layers=c["layers"],
        heads=c["heads"], hd=c["hd"], ffn=c["ffn"], gated=True,
        decoder=decoder, seed=seed, quant=quant, buckets=c["buckets"],
        max_distance=c["max_distance"], ctx=c["ctx"], eps=c["eps"],
        untied=decoder, name=f"synthetic-{preset}",
        tokenizer_cap=c["vocab"], hf_init=True)
