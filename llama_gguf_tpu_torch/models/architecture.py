"""Architecture registry: GGUF `general.architecture` string -> model quirks.

Each predicate is a set of architecture names; `ArchInfo` bundles the
answers for one architecture. A copy of llama_gguf_tpu/models/architecture.py
(the port never imports the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

# Canonical names (the GGUF string after alias folding). Aliases below.
KNOWN_ARCHITECTURES = {
    "llama", "llama2", "llama3", "llama4", "mistral", "mistral3", "mixtral",
    "qwen", "qwen2", "qwen2moe", "qwen2vl", "qwen3", "qwen35", "qwen35moe",
    "qwen3moe", "qwen3next", "qwen3vl", "qwen3vlmoe", "phi", "phi2", "phi3",
    "phimoe", "gemma", "gemma2", "gemma3", "gemma3n", "gemma-embedding",
    "falcon", "falcon-h1", "starcoder", "starcoder2", "mpt", "gptneox",
    "gpt2", "gptj", "bloom", "opt", "baichuan", "internlm", "internlm2",
    "yi", "deepseek", "deepseek2", "codellama", "orion", "olmo", "olmo2",
    "olmo3", "olmoe", "dbrx", "command", "command-r", "jamba", "mamba",
    "mamba2",
    "deci", "grok", "refact", "bert", "modern-bert", "nomic-bert",
    "nomic-bert-moe", "neo-bert", "jina-bert-v2", "jina-bert-v3", "eurobert",
    "stablelm", "plamo", "plamo2", "plamo3", "codeshell", "minicpm",
    "minicpm3", "xverse", "cohere2", "openelm", "arctic", "chatglm", "glm4",
    "glm4moe", "glm-dsa", "bitnet", "t5", "t5encoder", "jais", "jais2",
    "nemotron", "nemotron_h", "nemotron_h_moe", "exaone", "exaone4",
    "exaone-moe", "rwkv6", "rwkv6qwen2", "rwkv7", "arwkv7", "granite",
    "granitemoe", "granitehybrid", "chameleon", "wavtokenizer-dec", "plm",
    "bailingmoe", "bailingmoe2", "dots1", "arcee", "afmoe", "ernie4_5",
    "ernie4_5-moe", "hunyuan-moe", "hunyuan-dense", "smollm3", "gpt-oss",
    "lfm2", "lfm2moe", "dream", "smallthinker", "llada", "llada-moe",
    "seed_oss", "grovemoe", "apertus", "minimax-m2", "cogvlm", "rnd1",
    "pangu-embedded", "paddleocr", "mimo2", "step35", "llama-embed",
    "maincoder", "kimi-linear",
}

_ALIASES = {
    "qwen3_5": "qwen35", "qwen3.5": "qwen35",
    "gpt-neox": "gptneox", "gpt-j": "gptj",
    "deepseekv2": "deepseek2",
    "code-llama": "codellama",
    "commandr": "command-r",
}

MOE = {
    "mixtral", "qwen2moe", "qwen3moe", "qwen3next", "deepseek2", "dbrx",
    "phimoe", "qwen35moe", "qwen3vlmoe", "olmoe", "arctic", "glm4moe",
    "nemotron_h_moe", "exaone-moe", "granitemoe", "nomic-bert-moe",
    "bailingmoe", "bailingmoe2", "afmoe", "ernie4_5-moe", "hunyuan-moe",
    "gpt-oss", "lfm2moe", "llada-moe", "grovemoe",
}

QK_NORM = {
    "qwen3", "qwen35", "qwen35moe", "qwen3moe", "qwen3next",
    "gemma2", "gemma3", "gemma3n", "olmo2", "olmo3", "apertus",
    # HunYuan's per-head norms apply AFTER rope (cfg.qk_norm_post_rope)
    "hunyuan-dense", "hunyuan-moe",
    # OLMoE: flat RMSNorm over the whole q/k projection before RoPE (HF
    # OlmoeAttention.q_norm/k_norm) — the reference misses it
    # (architecture.rs:512-526 has no OlmoE arm); HF-oracle verified
    "olmoe",
}

# StableLM is NOT here: HF/llama.cpp keep separate q/k/v projections
# (verified against StableLmForCausalLM, tests/test_arch_zoo.py)
COMBINED_QKV = {
    # falcon-h1 is NOT here: HF FalconH1Attention keeps split q/k/v
    "phi2", "phi3", "phimoe", "gptneox", "gptj", "falcon",
    "refact", "codeshell", "bloom", "mpt",
    # StarCoder (gpt_bigcode) stores c_attn as one [q|k|v] tensor (MQA:
    # kv rows are a single head); the reference misses this
    # (architecture.rs:529-545 has no StarCoder arm) — HF-oracle verified
    "starcoder",
    # DBRX Wqkv is combined as well (HF DbrxAttention.Wqkv)
    "dbrx",
}

POST_FFN_NORM = {"gemma2", "gemma3", "gemma3n", "olmo2", "olmo3"}

LOGIT_SOFTCAP = {"gemma2"}

GEMMA_FAMILY = {"gemma", "gemma2", "gemma3", "gemma3n", "gemma-embedding"}

LAYER_NORM = {
    "gpt2", "bloom", "gptj", "gptneox", "falcon", "mpt", "opt", "phi2",
    "bert", "modern-bert", "nomic-bert", "jina-bert-v2", "jina-bert-v3",
    "eurobert", "t5", "t5encoder", "stablelm", "starcoder", "starcoder2",
    # PhiMoE keeps Phi-2's LayerNorm (HF PhimoeDecoderLayer uses nn.LayerNorm
    # with rms_norm_eps), unlike phi3's RMSNorm
    "phimoe",
    # Cohere family LayerNorm is mean-centered, weight-only (no bias)
    "command", "command-r", "cohere2",
    # Nemotron LayerNorm1P: the conversion stores weight+1 (zero-centered
    # gamma compensation), so runtime is a PLAIN LayerNorm with bias
    "nemotron",
    # DBRX uses bias-free LayerNorm (HF DbrxNormAttentionNorm nn.LayerNorm
    # with bias=False)
    "dbrx",
    # OLMo v1 uses non-parametric LayerNorm (F.layer_norm, no weight/bias)
    "olmo",
}

# OPT is plain ReLU MLP (HF activation_function="relu")
RELU = {"opt"}

# Nemotron and Arcee (AFM) are squared-ReLU ("relu2": relu(x)**2, no
# gate); BitNet is GATED relu2 (relu2(gate) * up)
RELU2 = {"nemotron", "arcee", "bitnet"}

GELU = {
    # NOTE: phi3/phimoe are SwiGLU (silu), unlike phi2's gelu_new.
    # StableLM is SwiGLU too (HF StableLmMLP: silu gate/up/down).
    "phi2", "gpt2", "gptj", "gptneox", "bloom",
    "falcon", "bert", "modern-bert", "starcoder", "starcoder2",
    "codeshell", "refact",
    # gemma family uses gated GELU (geglu) rather than SwiGLU
    "gemma", "gemma2", "gemma3", "gemma3n", "gemma-embedding",
}

ENCODER_ONLY = {
    "bert", "modern-bert", "nomic-bert", "nomic-bert-moe", "neo-bert",
    "jina-bert-v2", "jina-bert-v3", "eurobert", "gemma-embedding",
    "llama-embed", "pangu-embedded",
}

RECURRENT = {"mamba", "mamba2", "rwkv6", "rwkv7", "arwkv7", "rwkv6qwen2"}

# learned absolute position embeddings instead of RoPE
NO_ROPE = {"gpt2", "bloom", "opt", "starcoder", "mpt", "jais", "refact"}

# ALiBi per-head linear attention biases instead of positional embeddings
ALIBI = {"bloom", "mpt", "jais"}

NO_GATE_FFN = {
    # NOTE: phi3/phimoe use gated SwiGLU, unlike phi/phi2's plain GELU MLP;
    # stablelm is gated SwiGLU as well
    "gpt2", "gptj", "gptneox", "bloom", "opt", "falcon", "phi", "phi2",
    "codeshell", "bert", "modern-bert",
    "nomic-bert", "t5", "t5encoder", "starcoder", "starcoder2",
    # Nemotron and Arcee MLPs are up -> relu^2 -> down (no gate projection)
    "nemotron", "arcee",
    # Apertus MLP is up -> xIELU -> down
    "apertus",
}

NEOX_ROPE = {
    "qwen2", "qwen2moe", "qwen3", "qwen35", "qwen35moe", "qwen3moe",
    "qwen3next", "gptneox", "falcon", "phi", "phi2", "phi3", "phimoe",
    "gptj", "stablelm", "starcoder2",
    # gpt-oss conversion does not permute q/k -> rotate-half at runtime
    "gpt-oss",
    # falcon-h1 likewise (HF rotate-half, no conversion permute)
    "falcon-h1",
    # glm4moe partial rope is rotate-half on the FIRST rotary dims (unlike
    # dense glm4's interleaved rope); dots1 is full rotate-half — neither
    # conversion permutes
    "glm4moe", "dots1",
    # exaone4 is rotate-half with no conversion permute (sliding layers
    # only; global layers are NoPE)
    "exaone4",
    # hunyuan is rotate-half, no conversion permute, per-head norms after
    "hunyuan-dense", "hunyuan-moe",
    # apertus is rotate-half with per-head pre-rope QK-norm, no permute
    "apertus",
    # gemma GGUFs are not permuted at conversion; llama.cpp ropes them NEOX
    "gemma", "gemma2", "gemma3", "gemma3n", "gemma-embedding",
    # nemotron / dbrx conversions don't permute q/k (only nemotron's norm
    # weights get +1), so runtime rope is rotate-half = NEOX; nemotron is
    # also partial (rope.dimension_count = head_dim/2)
    "nemotron", "dbrx",
    # LFM2-MoE: HF rotate-half, no conversion permute (llama.cpp ropes
    # lfm2moe NEOX)
    "lfm2moe",
}

ATTENTION_BIAS = {
    "qwen", "qwen2", "qwen2moe", "phi2", "phi3", "phimoe", "gptneox",
    "gptj", "falcon", "bloom", "mpt", "opt", "gpt2", "stablelm", "baichuan",
    # gpt_bigcode keeps GPT-2's biases everywhere
    "starcoder",
    # gpt-oss has biases on q/k/v/o (and on the router + experts)
    "gpt-oss",
}

MLP_BIAS = {
    "gpt2", "gptj", "gptneox", "bloom", "opt", "stablelm", "phi2", "phi3",
    "starcoder",
}

PARALLEL_RESIDUAL = {
    # falcon-7b style (parallel_attn=True, single input norm); stablelm is
    # NOT parallel (HF StableLmConfig use_parallel_residual defaults False)
    "gptneox", "gptj", "phi", "phi2", "codeshell", "falcon",
    # Cohere family: attn and ffn both read the single pre-norm
    "command", "command-r", "cohere2",
}

# Qwen3Next hybrid: DeltaNet linear-attention layers interleaved with GQA.
DELTANET = {"qwen3next", "qwen35", "qwen35moe", "kimi-linear"}

# gpt-oss clamped SwiGLU (ggml_swiglu_oai: alpha=1.702, limit=7.0, up+1) —
# hardcoded in llama.cpp's build_gpt_oss, no GGUF key
SWIGLU_OAI = {"gpt-oss"}

# Archs whose converters do NOT write `{arch}.expert_weights_norm` but whose
# runtime graph renormalizes the top-k routing weights anyway (llama.cpp
# hardcodes norm_w=true in the model build; HF Mixtral divides by the top-k
# sum, Qwen3MoE/DBRX set norm_topk_prob/moe_normalize_expert_weights).
# Real Mixtral GGUFs carry general.architecture="llama" + expert_count>0
# and no expert_weights_norm key — without this default they'd silently
# skip renormalization. Metadata, when present, still wins.
MOE_RENORM_DEFAULT = {
    "llama", "mixtral", "dbrx", "qwen3moe", "qwen3vlmoe",
    # gpt-oss routing is top-k THEN softmax over the kept logits — exactly
    # softmax-before-top-k followed by renormalization (same top-k set,
    # same weights), which is this flag
    "gpt-oss",
    # GraniteMoeTopKGating: logits.topk(k) then softmax == renorm (verified
    # numerically vs HF: renorm matches 100x closer than no-renorm)
    "granitemoe", "granitehybrid",
}

# Sliding-window layer pattern N: every Nth layer (il % N == N-1) is FULL
# attention, the rest use the sliding window — llama.cpp set_swa_pattern
# semantics (gemma2 alternates 1:1, gemma3 runs 5 local + 1 global,
# cohere2 runs 3 local + 1 global).
SWA_PATTERN = {"gemma2": 2, "gemma3": 6, "gemma3n": 6, "cohere2": 4,
               # gpt-oss alternates sliding (even) / full (odd) layers
               "gpt-oss": 2,
               # exaone4 runs 3 sliding : 1 full ("LLLG")
               "exaone4": 4,
               # llama4: 3 chunked-attention rope layers : 1 full NoPE
               "llama4": 4}

# archs whose full-attention (global) layers carry NO positional encoding
# at all (cohere2 and exaone4 global layers are NoPE)
NOPE_GLOBAL_LAYERS = {"cohere2", "exaone4"}

# every Nth layer ((il+1) % N == 0) skips RoPE entirely, independent of any
# sliding window (SmolLM3 no_rope_layers, Llama-4 nope_layer_interval);
# GGUF `{arch}.nope_layer_interval` overrides when present
NOPE_LAYER_INTERVAL = {"smollm3": 4, "llama4": 4}

# OLMo (v1): non-parametric LayerNorm — no weight/bias tensors exist in the
# GGUF; the loader synthesizes unit weights (HF OlmoLayerNorm)
NON_PARAMETRIC_NORM = {"olmo"}

# [nope | rope] head-dim layout instead of [rope | nope] for partial RoPE.
# archs whose partial RoPE rotates the LAST n_dims of the head (HF Qwen3Next
# rotates the FIRST rotary_dim, verified against transformers — see
# tests/test_arch_zoo.py)
ROPE_PARTIAL_AT_END: set[str] = set()


@dataclass(frozen=True)
class ArchInfo:
    """Quirk flags for one architecture (answers to the reference's
    per-arch predicate methods, architecture.rs:435-673)."""

    name: str
    known: bool

    @property
    def is_moe(self) -> bool:
        return self.name in MOE

    @property
    def uses_qk_norm(self) -> bool:
        return self.name in QK_NORM

    @property
    def has_combined_qkv(self) -> bool:
        return self.name in COMBINED_QKV

    @property
    def has_post_ffn_norm(self) -> bool:
        return self.name in POST_FFN_NORM

    @property
    def has_logit_softcap(self) -> bool:
        return self.name in LOGIT_SOFTCAP

    @property
    def is_gemma(self) -> bool:
        return self.name in GEMMA_FAMILY

    @property
    def uses_layer_norm(self) -> bool:
        return self.name in LAYER_NORM

    @property
    def uses_gelu(self) -> bool:
        return self.name in GELU

    @property
    def uses_relu(self) -> bool:
        return self.name in RELU

    @property
    def uses_relu2(self) -> bool:
        return self.name in RELU2

    @property
    def moe_renorm_default(self) -> bool:
        return self.name in MOE_RENORM_DEFAULT

    @property
    def is_encoder_only(self) -> bool:
        return self.name in ENCODER_ONLY

    @property
    def is_recurrent(self) -> bool:
        return self.name in RECURRENT

    @property
    def has_no_gate_ffn(self) -> bool:
        return self.name in NO_GATE_FFN

    @property
    def uses_neox_rope(self) -> bool:
        return self.name in NEOX_ROPE

    @property
    def has_rope(self) -> bool:
        return self.name not in NO_ROPE

    @property
    def uses_alibi(self) -> bool:
        return self.name in ALIBI

    @property
    def default_attention_bias(self) -> bool:
        return self.name in ATTENTION_BIAS

    @property
    def default_mlp_bias(self) -> bool:
        return self.name in MLP_BIAS

    @property
    def uses_parallel_residual(self) -> bool:
        return self.name in PARALLEL_RESIDUAL

    @property
    def has_deltanet_layers(self) -> bool:
        return self.name in DELTANET

    @property
    def uses_swiglu_oai(self) -> bool:
        return self.name in SWIGLU_OAI

    @property
    def rope_partial_at_end(self) -> bool:
        return self.name in ROPE_PARTIAL_AT_END

    @property
    def swa_pattern(self) -> int:
        return SWA_PATTERN.get(self.name, 1)

    @property
    def nope_global_layers(self) -> bool:
        return self.name in NOPE_GLOBAL_LAYERS

    @property
    def nope_layer_interval(self) -> int:
        return NOPE_LAYER_INTERVAL.get(self.name, 0)

    @property
    def non_parametric_norm(self) -> bool:
        return self.name in NON_PARAMETRIC_NORM

    @property
    def is_llama_like(self) -> bool:
        return (
            self.known
            and not self.is_encoder_only
            and not self.is_recurrent
            and self.name not in ("t5", "t5encoder")
        )


def resolve(arch_str: str) -> ArchInfo:
    """Map a GGUF `general.architecture` string to its quirks."""
    name = arch_str.lower()
    name = _ALIASES.get(name, name)
    return ArchInfo(name=name, known=name in KNOWN_ARCHITECTURES)
