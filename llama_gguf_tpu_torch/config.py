"""Layered configuration: TOML file < environment < CLI flags (port of
llama_gguf_tpu/config.py: the same sections, keys, LLAMA_GGUF_* variables
and example text).

Precedence: CLI > env > TOML > defaults. TOML parsing uses the stdlib
tomllib. ``[parallel]`` data and model are the mesh axes of every model
command (the CLI's --dp and --tp); ``[rag]`` holds the ``rag`` subcommand's
defaults.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any

ENV_PREFIX = "LLAMA_GGUF_"

DEFAULT_CONFIG_PATHS = (
    "llama-gguf.toml",
    "~/.config/llama-gguf/config.toml",
)


@dataclass
class ModelSection:
    path: str | None = None
    max_context_len: int | None = None
    weight_mode: str = "quant"          # quant | dequant
    # f32 | bf16 | i8 | f8_e4m3 | f8_e5m2 | tq2 | tq3 | tq4 | qjl (the
    # example file below keeps the JAX package's text)
    kv_cache_type: str = "f32"
    matmul_precision: str = "highest"   # highest | default
    lora: str | None = None             # GGUF LoRA adapter applied at load


@dataclass
class GenerationSection:
    max_tokens: int = 512
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.0
    repetition_penalty: float = 1.1
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    seed: int | None = None
    stop: list[str] = field(default_factory=list)


@dataclass
class ChatSection:
    system_prompt: str | None = None
    template: str | None = None  # override autodetection


@dataclass
class ServerSection:
    host: str = "127.0.0.1"
    port: int = 8080
    max_batch: int = 8
    max_queue: int = 64
    api_keys: list[str] = field(default_factory=list)
    served_model_name: str | None = None


@dataclass
class QuantizeSection:
    type: str = "q4_k"
    weights_only: bool = True
    min_elements: int = 1024


@dataclass
class BenchSection:
    prompt_tokens: int = 32
    gen_tokens: int = 64
    batch: int = 1


@dataclass
class EmbedSection:
    pooling: str = "mean"  # mean | last | first | max
    normalize: bool = True


@dataclass
class RagSection:
    db: str = "knowledge.db"
    backend: str = "sqlite"   # sqlite | pgvector
    dsn: str | None = None    # postgres DSN for pgvector
    chunker: str = "recursive"
    chunk_size: int = 512
    chunk_overlap: int = 64
    embed_model: str | None = None
    top_k: int = 5
    search: str = "hybrid"    # semantic | keyword | hybrid


@dataclass
class ParallelSection:
    data: int = 1
    model: int = 1
    coordinator_address: str | None = None
    num_processes: int = 1
    process_id: int = 0


@dataclass
class Config:
    model: ModelSection = field(default_factory=ModelSection)
    generation: GenerationSection = field(default_factory=GenerationSection)
    chat: ChatSection = field(default_factory=ChatSection)
    server: ServerSection = field(default_factory=ServerSection)
    quantize: QuantizeSection = field(default_factory=QuantizeSection)
    bench: BenchSection = field(default_factory=BenchSection)
    embed: EmbedSection = field(default_factory=EmbedSection)
    rag: RagSection = field(default_factory=RagSection)
    parallel: ParallelSection = field(default_factory=ParallelSection)

    # -- loading ----------------------------------------------------------------

    @classmethod
    def load(cls, path: str | None = None, apply_env: bool = True) -> "Config":
        """Load TOML config (explicit path, or the first default path that
        exists), then apply LLAMA_GGUF_* env overrides."""
        cfg = cls()
        candidates = [path] if path else [
            os.path.expanduser(p) for p in DEFAULT_CONFIG_PATHS
        ]
        for p in candidates:
            if p and os.path.exists(p):
                with open(p, "rb") as f:
                    data = tomllib.load(f)
                cfg._merge_dict(data)
                break
        else:
            if path:
                raise FileNotFoundError(path)
        if apply_env:
            cfg.apply_env()
        return cfg

    def _merge_dict(self, data: dict[str, Any]) -> None:
        for f in fields(self):
            section = data.get(f.name)
            if not isinstance(section, dict):
                continue
            target = getattr(self, f.name)
            for sf in fields(target):
                if sf.name in section:
                    setattr(target, sf.name,
                            _coerce(section[sf.name], sf.type))

    def apply_env(self) -> None:
        """LLAMA_GGUF_<SECTION>_<KEY> overrides, e.g.
        LLAMA_GGUF_SERVER_PORT=9000."""
        for f in fields(self):
            target = getattr(self, f.name)
            for sf in fields(target):
                var = f"{ENV_PREFIX}{f.name.upper()}_{sf.name.upper()}"
                val = os.environ.get(var)
                if val is not None:
                    setattr(target, sf.name, _parse_env(val, sf.type))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _coerce(value, type_str):
    if isinstance(value, list):
        return [str(v) for v in value] if "list[str]" in str(type_str) else value
    return value


def _parse_env(val: str, type_str) -> Any:
    t = str(type_str)
    if "bool" in t:
        return val.lower() in ("1", "true", "yes", "on")
    if "list" in t:
        return [v.strip() for v in val.split(",") if v.strip()]
    if "int" in t:
        return int(val)
    if "float" in t:
        return float(val)
    return val


EXAMPLE_CONFIG = """\
# llama-gguf-tpu configuration (TOML).
# Precedence: CLI flags > LLAMA_GGUF_* env vars > this file > defaults.
# Env override naming: LLAMA_GGUF_<SECTION>_<KEY>, e.g. LLAMA_GGUF_SERVER_PORT.

[model]
# path = "/models/qwen2.5-0.5b-instruct-q4_k_m.gguf"
# max_context_len = 8192
weight_mode = "quant"        # quant: fused dequant-matmul kernels on TPU
kv_cache_type = "f32"        # f32 | bf16 | i8 | f8_e4m3 | f8_e5m2
matmul_precision = "highest" # highest = f32-accurate MXU passes
# lora = "/adapters/my-adapter.gguf"  # LoRA adapter applied at load

[generation]
max_tokens = 512
temperature = 0.8
top_k = 40
top_p = 0.95
min_p = 0.0
repetition_penalty = 1.1
# seed = 42
# stop = ["\\n\\n"]

[chat]
# system_prompt = "You are a helpful assistant."

[server]
host = "127.0.0.1"
port = 8080
max_batch = 8                # continuous-batching slots (one KV row each)
max_queue = 64               # admission control depth
# api_keys = ["sk-..."]

[quantize]
type = "q4_k"
weights_only = true          # skip norms/embeddings (keep f32)
min_elements = 1024

[bench]
prompt_tokens = 32
gen_tokens = 64
batch = 1

[embed]
pooling = "mean"             # mean | last | first | max
normalize = true

[rag]
db = "knowledge.db"          # sqlite store path (backend = "sqlite")
# backend = "pgvector"       # requires psycopg2 + dsn
chunker = "recursive"        # recursive | markdown | sliding | sentence | paragraph
chunk_size = 512
chunk_overlap = 64
top_k = 5
search = "hybrid"            # semantic | keyword | hybrid

[parallel]
data = 1                     # mesh axes; model = tensor-parallel size
model = 1
# coordinator_address = "host0:1234"   # multi-host jax.distributed
# num_processes = 2
# process_id = 0
"""


def example_config() -> str:
    """Documented example TOML (the JAX package's text)."""
    return EXAMPLE_CONFIG
