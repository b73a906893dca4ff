"""Model configuration parsed from GGUF metadata.

A copy of llama_gguf_tpu/models/config.py (ModelConfig, RopeConfig,
parse_config); the port never imports the JAX package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Mapping

from .architecture import ArchInfo, resolve


class RopeType(enum.Enum):
    NORMAL = "normal"  # consecutive pairs (x[2i], x[2i+1])
    NEOX = "neox"  # first half paired with second half (x[i], x[i+d/2])


class RopeScalingType(enum.Enum):
    NONE = "none"
    LINEAR = "linear"
    YARN = "yarn"
    DYNAMIC_NTK = "dynamic_ntk"


class Activation(enum.Enum):
    SILU = "silu"
    GELU = "gelu"
    RELU = "relu"
    RELU2 = "relu2"  # squared ReLU (nemotron)
    # gpt-oss clamped SwiGLU: glu = min(g,7)*sigmoid(1.702*min(g,7)),
    # out = glu * (clip(u,-7,7) + 1) — ggml_swiglu_oai semantics
    SWIGLU_OAI = "swiglu_oai"
    # Apertus xIELU (per-layer learned alpha_p/alpha_n scalars; the
    # effective post-softplus values ride the GGUF metadata)
    XIELU = "xielu"


@dataclass
class RopeConfig:
    freq_base: float = 10000.0
    freq_scale: float = 1.0
    n_dims: int = 0  # dims RoPE applies to (<= head_dim for partial RoPE)
    scaling_type: RopeScalingType = RopeScalingType.NONE
    original_max_position_embeddings: int = 2048
    rope_type: RopeType = RopeType.NORMAL
    # YaRN parameters (parsed when present)
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_ext_factor: float = 0.0
    yarn_attn_factor: float = 1.0
    partial_at_end: bool = False  # Qwen3Next: [nope | rope] layout


@dataclass
class ModelConfig:
    arch: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_seq_len: int = 2048
    norm_eps: float = 1e-5
    rope: RopeConfig = field(default_factory=RopeConfig)
    use_parallel_residual: bool = False
    hidden_act: Activation = Activation.SILU
    attention_bias: bool = False
    mlp_bias: bool = False
    clamp_kqv: float = 0.0  # DBRX clip_qkv / MPT attn clamp; 0 = off
    tie_word_embeddings: bool = False
    num_experts: int = 0
    num_experts_per_token: int = 0
    expert_intermediate_size: int = 0
    expert_shared_count: int = 0
    expert_weights_norm: bool = False
    expert_weights_scale: float = 1.0  # DeepSeek routed_scaling_factor
    expert_gating_func: int = 1  # 1 = softmax, 2 = sigmoid (V3), 3 = sparsemixer (phimoe)
    router_jitter_eps: float = 0.0  # sparsemixer mask threshold (phimoe 0.01)
    expert_group_count: int = 0  # DeepSeek-V3 node-limited routing groups
    expert_group_used_count: int = 0
    # MLA (DeepSeek-V2/V3): low-rank q/kv projections. head_dim is the
    # FULL qk head dim (nope + rope); rope.n_dims is the rope part.
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    key_length: int = 0
    value_length: int = 0
    ssm_d_inner: int = 0
    ssm_d_state: int = 0
    ssm_n_group: int = 0
    ssm_dt_rank: int = 0
    ssm_conv_kernel: int = 0
    # gated RMSNorm variant in the mamba2 mixer: Falcon-H1 normalizes per
    # GROUP and applies the norm BEFORE the silu(z) gate
    ssm_norm_groups: int = 1
    ssm_norm_before_gate: bool = False
    shortconv_l_cache: int = 0  # LFM2 short-conv tap count
    # llama4: local (rope) layers use CHUNKED attention of sliding_window
    # size; NoPE q gets log-floor temperature scaling; weightless L2
    # QK-norm AFTER rope; MoE scales the expert INPUT by the router score
    swa_chunked: bool = False
    attn_temp_scale: float = 0.0
    attn_temp_floor: float = 8192.0
    use_qk_l2norm: bool = False
    moe_weight_before_ffn: bool = False
    qk_norm_post_rope: bool = False  # HunYuan: per-head norms after rope
    # T5 encoder-decoder
    rel_buckets: int = 32
    rel_max_distance: int = 128
    decoder_start_token_id: int = 0
    # Apertus xIELU per-layer EFFECTIVE constants (softplus pre-applied)
    xielu_alpha_p: tuple = ()
    xielu_alpha_n: tuple = ()
    xielu_beta: tuple = ()
    xielu_eps: tuple = ()
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    # logits MULTIPLIER before sampling (Cohere stores the multiplier;
    # Granite stores a divisor — parse_config inverts it at load)
    logit_scale: float = 1.0
    attention_scale: float = 0.0  # 0 = default head_dim**-0.5 (Granite)
    residual_scale: float = 1.0  # Granite residual_multiplier
    sliding_window: int = 0
    # every Nth layer is full attention; 1 = window (if any) on all layers
    swa_pattern: int = 1
    nope_global_layers: bool = False  # cohere2: global layers skip RoPE
    nope_layer_interval: int = 0  # smollm3/llama4: every Nth layer is NoPE
    non_parametric_norm: bool = False  # olmo: weightless LayerNorm
    # local (sliding) layers' RoPE base when it differs from the global
    # layers' (gemma3 locals use 10k while globals use 1M); 0 = same
    rope_freq_base_swa: float = 0.0
    has_combined_qkv: bool = False
    uses_layer_norm: bool = False
    uses_gelu: bool = False
    has_ffn_gate: bool = True
    uses_qk_norm: bool = False
    has_post_ffn_norm: bool = False
    uses_alibi: bool = False
    embedding_scale: float = 1.0  # Gemma: sqrt(hidden_size)
    # runtime KV-cache storage format (set by the runner, not the GGUF)
    kv_format: str = "f32"
    arch_info: ArchInfo | None = None
    # per-layer kind for hybrid models ("attn" | "deltanet" | "mamba");
    # empty tuple = all attention
    layer_kinds: tuple = ()

    @property
    def n_rep(self) -> int:
        """GQA group size: query heads per KV head."""
        return self.num_heads // max(self.num_kv_heads, 1)

    def swa_index(self, i: int) -> int:
        """Index of layer i within the SWA ring stack (# swa layers < i)."""
        return sum(self.layer_is_swa(j) for j in range(i))

    def full_index(self, i: int) -> int:
        """Index of layer i within the full-cache stack."""
        return sum(not self.layer_is_swa(j) for j in range(i))

    # -- KV-cache storage dims (MLA caches the compressed latent + shared
    # rope key at ONE kv head instead of per-head K/V: [c_kv | k_rope]
    # as "K" (rank + rope dims) and c_kv as "V")
    @property
    def cache_kv_heads(self) -> int:
        return 1 if self.kv_lora_rank > 0 else max(self.num_kv_heads, 1)

    @property
    def cache_k_dim(self) -> int:
        if self.kv_lora_rank > 0:
            return self.kv_lora_rank + self.rope.n_dims
        return self.head_dim

    @property
    def cache_v_dim(self) -> int:
        if self.kv_lora_rank > 0:
            return self.kv_lora_rank
        return self.value_length or self.head_dim

    def layer_is_swa(self, i: int) -> bool:
        """Does layer i use the sliding window? (llama.cpp set_swa_pattern:
        every swa_pattern-th layer is full attention.)"""
        if self.sliding_window <= 0:
            return False
        if self.swa_pattern <= 1:
            return True
        return i % self.swa_pattern != self.swa_pattern - 1

    def layer_rope(self, i: int) -> "RopeConfig | None":
        """The RoPE actually applied to layer i's keys, or None for a NoPE
        layer. Single source of truth for the forward pass AND for
        context-shift re-rotation (kv.shift_left) — per-layer because of
        periodic NoPE intervals (smollm3/llama4), NoPE global layers
        (cohere2/exaone4) and dual-base SWA layers (gemma3)."""
        if self.rope.n_dims <= 0:
            return None
        if self.nope_layer_interval > 0 and \
                (i + 1) % self.nope_layer_interval == 0:
            return None
        is_swa = self.layer_is_swa(i)
        if self.nope_global_layers and self.sliding_window > 0 and \
                not is_swa:
            return None
        if is_swa and self.rope_freq_base_swa > 0:
            # gemma3: local layers rope at 10k unscaled, globals at 1M+scale
            import dataclasses

            return dataclasses.replace(
                self.rope, freq_base=self.rope_freq_base_swa,
                freq_scale=1.0, scaling_type=RopeScalingType.NONE)
        return self.rope


def _get_int(md: Mapping[str, Any], key: str, default: int | None = None) -> int | None:
    v = md.get(key)
    if v is None:
        return default
    return int(v)


def _kv_heads(v, num_heads: int) -> int:
    """head_count_kv: one count, or one a layer (LFM2's conversions write
    0 for the conv layers and the attention layers' count for the others);
    the attention layers' count, which must be one number."""
    if v is None:
        return num_heads
    if not hasattr(v, "__iter__"):
        return int(v)
    counts = {int(n) for n in v} - {0}
    if len(counts) > 1:
        raise ValueError(f"per-layer head_count_kv {sorted(counts)}: the "
                         "cache takes one KV head count")
    return counts.pop() if counts else num_heads


def _float_tuple(md: Mapping[str, Any], key: str) -> tuple:
    v = md.get(key)
    if v is None:
        return ()
    return tuple(float(x) for x in v)


def _get_float(md: Mapping[str, Any], key: str, default: float) -> float:
    v = md.get(key)
    if v is None:
        return default
    return float(v)


def parse_config(metadata: Mapping[str, Any],
                 tensors: Mapping[str, Any] | None = None) -> ModelConfig:
    """Build a ModelConfig from GGUF metadata (`{arch}.*` keys)."""
    arch_str = str(metadata.get("general.architecture", "llama"))
    info = resolve(arch_str)
    arch = arch_str.lower()

    def gi(suffix: str, default: int | None = None) -> int | None:
        return _get_int(metadata, f"{arch}.{suffix}", default)

    def gf(suffix: str, default: float) -> float:
        return _get_float(metadata, f"{arch}.{suffix}", default)

    # vocab size fallback chain: {arch}.vocab_size -> tokenizer vocab ->
    # token_embd shape -> 32000 (loader.rs:78-97)
    vocab_size = gi("vocab_size")
    if vocab_size is None:
        vocab_size = _get_int(metadata, "tokenizer.ggml.vocab_size")
    if vocab_size is None:
        toks = metadata.get("tokenizer.ggml.tokens")
        if toks is not None:
            vocab_size = len(toks)
    if vocab_size is None and tensors and "token_embd.weight" in tensors:
        shape = tensors["token_embd.weight"].shape  # GGUF order
        if len(shape) == 2:
            vocab_size = int(shape[1])
    if vocab_size is None:
        vocab_size = 32000

    hidden_size = gi("embedding_length")
    if hidden_size is None:
        raise KeyError(f"missing {arch}.embedding_length")
    num_layers = gi("block_count")
    if num_layers is None:
        raise KeyError(f"missing {arch}.block_count")

    is_mamba = arch in ("mamba", "mamba2")
    num_heads = gi("attention.head_count", 1 if is_mamba else None)
    if num_heads is None:
        raise KeyError(f"missing {arch}.attention.head_count")
    num_kv_heads = _kv_heads(
        metadata.get(f"{arch}.attention.head_count_kv"), num_heads)
    head_dim = gi("attention.key_length", hidden_size // max(num_heads, 1))

    intermediate_size = gi(
        "feed_forward_length",
        hidden_size if is_mamba else hidden_size * 4 * 2 // 3,
    )
    max_seq_len = gi("context_length", 2048)

    norm_eps = metadata.get(f"{arch}.attention.layer_norm_rms_epsilon")
    if norm_eps is None:
        norm_eps = metadata.get(f"{arch}.attention.layer_norm_epsilon", 1e-5)
    norm_eps = float(norm_eps)

    # RoPE
    freq_base = gf("rope.freq_base", 10000.0)
    freq_scale = gf("rope.scale_linear", 1.0)
    scaling_type = RopeScalingType.NONE
    st = metadata.get(f"{arch}.rope.scaling.type")
    if st is not None:
        try:
            scaling_type = RopeScalingType(str(st))
        except ValueError:
            scaling_type = RopeScalingType.NONE
    factor = metadata.get(f"{arch}.rope.scaling.factor")
    if factor is not None and scaling_type == RopeScalingType.LINEAR:
        freq_scale = 1.0 / float(factor)
    orig_ctx = gi(
        "rope.scaling.original_context_length", max_seq_len
    )

    rope = RopeConfig(
        freq_base=freq_base,
        freq_scale=freq_scale,
        n_dims=gi("rope.dimension_count",
                  head_dim if info.has_rope else 0),
        scaling_type=scaling_type,
        original_max_position_embeddings=orig_ctx,
        rope_type=RopeType.NEOX if info.uses_neox_rope else RopeType.NORMAL,
        partial_at_end=info.rope_partial_at_end,
    )

    tie = metadata.get("general.tie_word_embeddings", False)
    if isinstance(tie, str):
        tie = tie == "true"

    cfg = ModelConfig(
        arch=arch,
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        intermediate_size=intermediate_size,
        num_layers=num_layers,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        head_dim=head_dim,
        max_seq_len=max_seq_len,
        norm_eps=norm_eps,
        rope=rope,
        use_parallel_residual=info.uses_parallel_residual,
        hidden_act=(Activation.GELU if info.uses_gelu
                    else Activation.RELU if info.uses_relu
                    else Activation.RELU2 if info.uses_relu2
                    else Activation.SWIGLU_OAI if info.uses_swiglu_oai
                    else Activation.XIELU if arch == "apertus"
                    else Activation.SILU),
        attention_bias=info.default_attention_bias,
        mlp_bias=info.default_mlp_bias,
        tie_word_embeddings=bool(tie),
        num_experts=gi("expert_count", 0),
        num_experts_per_token=gi("expert_used_count", 0),
        expert_intermediate_size=gi("expert_feed_forward_length", 0),
        expert_shared_count=gi("expert_shared_count", 0),
        expert_weights_norm=bool(metadata.get(
            f"{arch}.expert_weights_norm",
            # converters for the Mixtral/DBRX/Qwen3MoE families never
            # write the key; their runtimes renormalize top-k anyway
            info.moe_renorm_default)),
        expert_weights_scale=gf("expert_weights_scale", 1.0),
        # phimoe routes with sparsemixer (HF PhimoeSparseMoeBlock), not
        # plain softmax-topk — selection by thresholded argmax, weights
        # from the masked softmax
        expert_gating_func=(3 if arch == "phimoe"
                            # llama4 routing is sigmoid(top-k logits);
                            # conversions don't write the key
                            else gi("expert_gating_func",
                                    2 if arch == "llama4" else 1) or 1),
        router_jitter_eps=gf("router_jitter_eps",
                             0.01 if arch == "phimoe" else 0.0),
        expert_group_count=gi("expert_group_count", 0),
        expert_group_used_count=gi("expert_group_used_count", 0),
        q_lora_rank=gi("attention.q_lora_rank", 0),
        kv_lora_rank=gi("attention.kv_lora_rank", 0),
        key_length=gi("attention.key_length", head_dim),
        value_length=gi("attention.value_length", head_dim),
        ssm_d_inner=gi("ssm.inner_size", 0),
        ssm_d_state=gi("ssm.state_size", 0),
        ssm_n_group=gi("ssm.group_count", 1 if is_mamba else 0),
        ssm_dt_rank=gi("ssm.time_step_rank", 0),
        ssm_conv_kernel=gi("ssm.conv_kernel", 0),
        ssm_norm_groups=(max(gi("ssm.group_count", 1) or 1, 1)
                         if arch == "falcon-h1" else 1),
        ssm_norm_before_gate=(arch == "falcon-h1"),
        shortconv_l_cache=gi("shortconv.l_cache", 0),
        attn_logit_softcap=gf("attn_logit_softcapping", 0.0),
        # granite.logit_scale is a DIVISOR (llama.cpp scales by 1/x);
        # command-r's is a multiplier
        logit_scale=(1.0 / gf("logit_scale", 1.0)
                     if arch.startswith("granite") and gf("logit_scale", 1.0)
                     else gf("logit_scale", 1.0)),
        attention_scale=gf("attention.scale", 0.0),
        clamp_kqv=gf("attention.clamp_kqv", 0.0),
        residual_scale=gf("residual_scale", 1.0),
        final_logit_softcap=gf("final_logit_softcapping", 0.0),
        # llama4 conversions don't write these keys (llama.cpp hardcodes
        # them in the graph builder), so the arch defaults must match the
        # real checkpoints: 8192-token chunked attention, L2 QK-norm on
        sliding_window=gi("attention.sliding_window",
                          gi("attention.chunk_size", 8192)
                          if arch == "llama4" else 0),
        swa_chunked=(arch == "llama4"),
        swa_pattern=gi("attention.sliding_window_pattern",
                       info.swa_pattern) or 1,
        attn_temp_scale=gf("attention.temperature_scale",
                           0.1 if arch == "llama4" else 0.0),
        attn_temp_floor=gf("attention.floor_scale", 8192.0),
        use_qk_l2norm=bool(metadata.get(
            f"{arch}.attention.use_kq_norm", arch == "llama4")),
        moe_weight_before_ffn=(arch == "llama4"),
        qk_norm_post_rope=arch in ("hunyuan-dense", "hunyuan-moe"),
        xielu_alpha_p=_float_tuple(metadata, f"{arch}.xielu.alpha_p"),
        xielu_alpha_n=_float_tuple(metadata, f"{arch}.xielu.alpha_n"),
        xielu_beta=_float_tuple(metadata, f"{arch}.xielu.beta"),
        xielu_eps=_float_tuple(metadata, f"{arch}.xielu.eps"),
        rel_buckets=gi("attention.relative_buckets_count", 32) or 32,
        rel_max_distance=gi("attention.relative_max_distance", 128) or 128,
        decoder_start_token_id=gi("decoder_start_token_id", 0) or 0,
        nope_global_layers=info.nope_global_layers,
        nope_layer_interval=gi("nope_layer_interval",
                               info.nope_layer_interval) or 0,
        non_parametric_norm=info.non_parametric_norm,
        rope_freq_base_swa=gf(
            "rope.freq_base_swa",
            10000.0 if arch in ("gemma3", "gemma3n") else 0.0),
        has_combined_qkv=info.has_combined_qkv,
        uses_layer_norm=info.uses_layer_norm,
        uses_gelu=info.uses_gelu,
        has_ffn_gate=not info.has_no_gate_ffn,
        uses_qk_norm=info.uses_qk_norm,
        has_post_ffn_norm=info.has_post_ffn_norm,
        uses_alibi=info.uses_alibi,
        embedding_scale=gf(
            "embedding_scale",
            float(hidden_size) ** 0.5 if info.is_gemma else 1.0),
        arch_info=info,
    )
    return cfg
