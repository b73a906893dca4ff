"""Engine: model + tokenizer + sampler -> text generation (port of
llama_gguf_tpu/engine/engine.py, GGUF decoders only).

Prefill runs the prompt through one bucketed forward; decode runs one forward
per token with the KV cache updated in place on the device. On CUDA both
replay the runner's CUDA graphs, on the runner's own cache (``init_kv``):
one request per engine runs at a time. Grammar-constrained decoding, the
prompt cache, context shift and chat templates are ROADMAP queue 1.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import torch

from ..gguf.reader import GGUFFile
from ..models.loader import ModelLoader, resolve_device
from ..sampling.sampler import Sampler, SamplerConfig
from ..tokenizer.gguf_tokenizer import Tokenizer
from .runner import ModelRunner

log = logging.getLogger(__name__)


@dataclass
class EngineConfig:
    max_context_len: int | None = None
    max_batch: int = 1
    weight_mode: str = "quant"  # "quant" (CUDA kernels) | "dequant"
    kv_format: str = "f32"  # f32 | bf16
    matmul_precision: str = "highest"
    seed: int | None = None


@dataclass
class GenerationStats:
    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_time: float = 0.0
    decode_time: float = 0.0

    @property
    def decode_tps(self) -> float:
        return self.generated_tokens / self.decode_time if self.decode_time else 0.0

    @property
    def prefill_tps(self) -> float:
        return self.prompt_tokens / self.prefill_time if self.prefill_time else 0.0


class Engine:
    def __init__(self, runner: ModelRunner, tokenizer, config: EngineConfig,
                 gguf: GGUFFile | None = None):
        self.runner = runner
        self.tokenizer = tokenizer
        self.config = config
        self.gguf = gguf
        self.stats = GenerationStats()

    @classmethod
    def load(cls, path: str, config: EngineConfig | None = None,
             device="cuda") -> "Engine":
        """Load a GGUF model onto ``device`` (default CUDA; raises when CUDA
        is requested and absent — pass device="cpu" for the plain path)."""
        config = config or EngineConfig()
        dev = resolve_device(device)
        t0 = time.time()
        gguf = GGUFFile.open(path)
        tokenizer = Tokenizer.from_gguf(gguf.metadata)
        loader = ModelLoader(gguf, mode=config.weight_mode, device=dev)
        params, cfg = loader.build()
        max_seq = cfg.max_seq_len
        if config.max_context_len:
            max_seq = min(max_seq, config.max_context_len)
        runner = ModelRunner(
            params, cfg, max_batch=config.max_batch, max_seq=max_seq,
            matmul_precision=config.matmul_precision,
            kv_format=config.kv_format, device=dev)
        log.info("loaded %s (%s, %d layers, vocab %d) on %s in %.1fs", path,
                 cfg.arch, cfg.num_layers, cfg.vocab_size, dev,
                 time.time() - t0)
        return cls(runner, tokenizer, config, gguf)

    def _sync(self) -> None:
        if self.runner.device.type == "cuda":
            torch.cuda.synchronize(self.runner.device)

    # -- generation ----------------------------------------------------------

    def generate(self, prompt: str, max_tokens: int = 128,
                 sampler: SamplerConfig | Sampler | None = None,
                 stop: list[str] | None = None,
                 on_token: Callable[[str], None] | None = None) -> str:
        return "".join(self.generate_streaming(prompt, max_tokens, sampler,
                                               stop, on_token))

    def generate_streaming(self, prompt: str, max_tokens: int = 128,
                           sampler: SamplerConfig | Sampler | None = None,
                           stop: list[str] | None = None,
                           on_token: Callable[[str], None] | None = None
                           ) -> Iterator[str]:
        if sampler is None:
            sampler = Sampler(SamplerConfig(seed=self.config.seed))
        elif isinstance(sampler, SamplerConfig):
            sampler = Sampler(sampler)

        ids = self.tokenizer.encode(prompt)
        ids = ids[-(self.runner.max_seq - max_tokens - 1):] if \
            len(ids) + max_tokens >= self.runner.max_seq else ids
        self.stats = GenerationStats(prompt_tokens=len(ids))

        t0 = time.time()
        kv = self.runner.init_kv()
        logits, kv, pos = self.runner.prefill(ids, kv)
        self._sync()
        self.stats.prefill_time = time.time() - t0

        decoder = self.tokenizer.streaming_decoder()
        history = list(ids)
        tail = ""  # holds text that might be a stop-pattern prefix
        t1 = time.time()
        for _ in range(max_tokens):
            tok = sampler.sample(logits.float().cpu().numpy(), history)
            if self.tokenizer.is_eog(tok):
                break
            history.append(tok)
            piece = decoder.push(tok)
            self.stats.generated_tokens += 1
            if piece:
                if stop:
                    tail += piece
                    hit = next((s for s in stop if s in tail), None)
                    if hit is not None:
                        out = tail[: tail.index(hit)]
                        if out:
                            if on_token:
                                on_token(out)
                            yield out
                        break
                    # emit all but the longest possible stop prefix
                    keep = max(
                        (len(s) - 1 for s in stop
                         if s and tail.endswith(s[: len(s) - 1])),
                        default=0,
                    )
                    emit, tail = (tail[:-keep], tail[-keep:]) if keep else (tail, "")
                    if emit:
                        if on_token:
                            on_token(emit)
                        yield emit
                else:
                    if on_token:
                        on_token(piece)
                    yield piece
            if pos >= self.runner.max_seq - 1:
                break
            logits, kv = self.runner.decode_one(tok, pos, kv)
            pos += 1
        else:
            if tail:
                yield tail
                tail = ""
        self.stats.decode_time = time.time() - t1

    def greedy_tokens(self, prompt_ids: list[int], max_tokens: int) -> list[int]:
        """Pure greedy decode for parity harnesses: returns generated ids."""
        kv = self.runner.init_kv()
        logits, kv, pos = self.runner.prefill(prompt_ids, kv)
        out = []
        for _ in range(max_tokens):
            tok = int(torch.argmax(logits).item())
            out.append(tok)
            if self.tokenizer is not None and self.tokenizer.is_eog(tok):
                break
            if pos >= self.runner.max_seq - 1:
                break
            logits, kv = self.runner.decode_one(tok, pos, kv)
            pos += 1
        return out
