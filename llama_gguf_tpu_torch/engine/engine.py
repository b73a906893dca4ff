"""Engine: model + tokenizer + sampler -> text generation (port of
llama_gguf_tpu/engine/engine.py).

``Engine.load`` takes a GGUF decoder (a ModelRunner), a T5 or t5encoder GGUF
(models/t5.T5Runner: seq2seq generation and pooled encoder embeddings), a
BERT-family encoder-only GGUF (models/bert.BertEncoder: embeddings only), or
an HF Optimum ONNX export with its config.json and tokenizer.json
(onnx/loader.py, tokenizer/hf_json.py) into the same ModelRunner.

Prefill runs the prompt through one bucketed forward; decode runs one forward
per token with the KV cache updated in place on the device. On CUDA both
replay the runner's CUDA graphs, on the runner's unowned one-row cache
(``init_kv(1)``): single-stream requests on one engine run one at a time
(each holds the engine's stream lock from its prefill to its last token),
and a continuous-batching engine on the same runner (engine/batched.py)
keeps its own cache. The runner hands the logits back on the host.
Grammar-constrained decoding, embeddings and chat templates are here, and
two features that work on that cache in place, so the steps after them
replay the same graphs: the prompt cache (engine/prompt_cache.py: a cached
prefix is restored into the row, and prefill runs only the rest) and the
context shift (models/kv.shift_left: past the window the cache slides left
by a quarter, its keys re-rotated).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from ..gguf.reader import GGUFFile
from ..models.loader import ModelLoader, resolve_device
from ..sampling.sampler import Sampler, SamplerConfig
from ..tokenizer.gguf_tokenizer import Tokenizer
from .chat import ChatTemplate
from .runner import ModelRunner

log = logging.getLogger(__name__)


@dataclass
class EngineConfig:
    max_context_len: int | None = None
    max_batch: int = 1
    weight_mode: str = "quant"  # "quant" (CUDA kernels) | "dequant"
    # f32 | bf16 | i8 | f8_e4m3 | f8_e5m2 | tq2 | tq3 | tq4 | qjl
    kv_format: str = "f32"
    matmul_precision: str = "highest"
    seed: int | None = None
    chat_template: str | None = None  # override the detected style
    # generate past the context window by sliding the KV cache left
    # (exact RoPE re-rotation; see models/kv.shift_left). Off, a model with
    # interleaved sliding-window layers (Gemma-2/3) keeps them in the ring
    # cache, which cannot shift
    context_shift: bool = False
    prompt_cache: bool = False  # prefix-sharing KV snapshots (LRU)
    prompt_cache_bytes: int = 2 << 30
    # session file (llama.cpp --prompt-cache): loaded from this .npz at
    # construction (implies prompt_cache=True); Engine.save_prompt_cache()
    # writes it back
    prompt_cache_file: str | None = None
    # GGUF LoRA adapter applied at load (models/lora.py); None = base
    lora: str | None = None
    lora_scale: float | None = None  # override adapter alpha/rank scaling
    # tensor/data-parallel mesh axes (parallel/sharding.py; 1, 1 = one
    # device, one process); mesh_model=0 picks the smallest model axis that
    # fits the cards' memory (multihost.auto_mesh)
    mesh_data: int = 1
    mesh_model: int = 1


def runner_kwargs(cfg, config: EngineConfig) -> dict:
    """The runner's settings for loaded weights: the context window capped
    at max_context_len, the config's batch, precision and KV format, and
    the sliding-window ring unless the context shift is on (the ring
    cannot shift)."""
    max_seq = cfg.max_seq_len
    if config.max_context_len:
        max_seq = min(max_seq, config.max_context_len)
    return dict(max_batch=config.max_batch, max_seq=max_seq,
                matmul_precision=config.matmul_precision,
                kv_format=config.kv_format,
                swa_ring=not config.context_shift)


def make_runner(params: dict, cfg, config: EngineConfig,
                device="cuda") -> ModelRunner:
    """The runner ``Engine.load`` makes for loaded weights
    (``runner_kwargs``)."""
    return ModelRunner(params, cfg, device=device,
                       **runner_kwargs(cfg, config))


def mesh_axes(config: EngineConfig, gguf: GGUFFile, device) -> tuple:
    """(data, model) of ``config``'s mesh; model 0 asks ``auto_mesh`` over
    the cards of this host (one for the CPU), as the JAX engine does."""
    n_data, n_model = config.mesh_data, config.mesh_model
    if n_model == 0:
        import torch

        from ..parallel.multihost import auto_mesh

        weight_bytes = sum(i.nbytes for i in gguf.tensors.values())
        n = torch.cuda.device_count() if device.type == "cuda" else 1
        n_data, n_model = auto_mesh(int(weight_bytes * 1.5),
                                    n_devices=max(n, 1))
    return n_data, n_model


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
    def __init__(self, runner: ModelRunner | None, tokenizer,
                 config: EngineConfig, gguf: GGUFFile | None = None,
                 encoder=None, t5=None):
        self.runner = runner
        self.encoder = encoder  # BertEncoder of an encoder-only model
        self.t5 = t5  # T5Runner of an encoder-decoder model
        self.tokenizer = tokenizer
        self.config = config
        self.gguf = gguf
        self.chat_template = (ChatTemplate(config.chat_template)
                              if config.chat_template
                              else ChatTemplate.detect(tokenizer))
        self.stats = GenerationStats()
        # single-stream requests share the runner's unowned one-row cache
        self._stream = threading.Lock()
        self.prompt_cache = None
        if config.prompt_cache or config.prompt_cache_file:
            from .prompt_cache import PromptCache

            self.prompt_cache = PromptCache(max_bytes=config.prompt_cache_bytes)
            if config.prompt_cache_file and \
                    os.path.exists(config.prompt_cache_file):
                n = self.prompt_cache.load(config.prompt_cache_file)
                log.info("prompt cache: loaded %d entries from %s", n,
                         config.prompt_cache_file)

    @classmethod
    def load(cls, path: str, config: EngineConfig | None = None,
             device="cuda") -> "Engine":
        """Load a GGUF model onto ``device`` (default CUDA; raises when CUDA
        is requested and absent — pass device="cpu" for the plain path)."""
        config = config or EngineConfig()
        dev = resolve_device(device)
        t0 = time.time()
        if str(path).endswith(".onnx"):
            return cls._load_onnx(path, config, dev, t0)
        gguf = GGUFFile.open(path)
        tokenizer = Tokenizer.from_gguf(gguf.metadata)
        # a serving runner on this device may capture meanwhile: its
        # "thread_local" captures survive this thread's allocations, copies
        # and kernels, so a load must make no device-wide synchronize
        loader = ModelLoader(gguf, mode=config.weight_mode, device=dev)
        info = loader.config.arch_info
        if info is not None and info.name in ("t5", "t5encoder"):
            from ..models.t5 import T5Runner

            params, cfg = loader.build()
            log.info("loaded encoder-decoder %s (%s, %d enc / %d dec layers) "
                     "on %s in %.1fs", path, cfg.arch,
                     len(params["enc"]["layers"]),
                     len(params.get("dec", {}).get("layers", ())), dev,
                     time.time() - t0)
            # the decoder cache is capped at 1024 slots unless
            # max_context_len says otherwise (T5 models rarely decode long)
            dec_cap = config.max_context_len or min(cfg.max_seq_len, 1024)
            return cls(None, tokenizer, config, gguf, t5=T5Runner(
                params, cfg, max_seq=dec_cap, device=dev,
                matmul_precision=config.matmul_precision))
        if info is not None and info.is_encoder_only:
            from ..models.bert import BertEncoder, load_bert

            params, cfg = load_bert(loader)
            log.info("loaded encoder-only %s (%s, %d layers) on %s in %.1fs",
                     path, cfg.arch, cfg.num_layers, dev, time.time() - t0)
            return cls(None, tokenizer, config, gguf, encoder=BertEncoder(
                params, cfg, device=dev,
                matmul_precision=config.matmul_precision))
        n_data, n_model = mesh_axes(config, gguf, dev)
        import torch.distributed as dist

        if n_data * n_model > 1 or dist.is_initialized():
            return cls._load_mesh(path, gguf, tokenizer, config, dev,
                                  n_data, n_model, t0)
        params, cfg = loader.build()
        if config.lora:
            # before the runner: it captures its graphs on the adapted
            # params
            from ..models.lora import LoraAdapter, apply_lora

            adapter = LoraAdapter.load_gguf(config.lora)
            n = apply_lora(params, adapter, scale=config.lora_scale)
            log.info("lora: attached %d tensors from %s (rank %d)",
                     n, config.lora, adapter.rank)
        runner = make_runner(params, cfg, config, dev)
        log.info("loaded %s (%s, %d layers, vocab %d) on %s in %.1fs", path,
                 cfg.arch, cfg.num_layers, cfg.vocab_size, dev,
                 time.time() - t0)
        return cls(runner, tokenizer, config, gguf)

    @classmethod
    def _load_mesh(cls, path: str, gguf: GGUFFile, tokenizer,
                   config: EngineConfig, dev, n_data: int, n_model: int,
                   t0: float) -> "Engine":
        """A decoder over a (data, model) mesh, one process per rank
        (parallel/service.load_mesh): inside a process group (the CLI's
        ``shard``) this process's shard of it; else rank 0 here, with ranks
        1..N-1 spawned as follower processes that ``close`` stops. The
        LoRA adapter is attached to the whole model and cut along each
        base's split. T5 and encoder-only models never get here: they
        ignore the mesh, as in the JAX engine."""
        from ..parallel.service import load_mesh

        if config.prompt_cache or config.prompt_cache_file:
            raise NotImplementedError(
                "the prompt cache is not supported under a mesh: each "
                "rank's cache holds its own heads and rows (ROADMAP queue 3)")
        runner = load_mesh(path, config, dev, n_data, n_model)
        log.info("loaded %s (%s, %d layers, vocab %d) over mesh (data=%d, "
                 "model=%d) in %.1fs", path, runner.cfg.arch,
                 runner.cfg.num_layers, runner.cfg.vocab_size, n_data,
                 n_model, time.time() - t0)
        return cls(runner, tokenizer, config, gguf)

    def close(self) -> None:
        """Stop the follower ranks of a mesh this engine spawned and leave
        their process group (nothing to do on one device)."""
        if self.runner is not None and self.runner.mesh is not None:
            from ..parallel.service import close_mesh

            close_mesh(self.runner)

    @classmethod
    def _load_onnx(cls, path: str, config: EngineConfig, dev,
                   t0: float) -> "Engine":
        """An HF Optimum export, with tokenizer.json (when present) from the
        same directory."""
        from ..onnx.loader import load_onnx_model

        params, cfg = load_onnx_model(path, device=dev)
        tok_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                                "tokenizer.json")
        tokenizer = None
        if os.path.exists(tok_path):
            from ..tokenizer.hf_json import HFTokenizer

            tokenizer = HFTokenizer(tok_path)
        runner = make_runner(params, cfg, config, dev)
        log.info("loaded ONNX %s (%s, %d layers) on %s in %.1fs", path,
                 cfg.arch, cfg.num_layers, dev, time.time() - t0)
        return cls(runner, tokenizer, config)

    def save_prompt_cache(self, path: str | None = None) -> int:
        """Write the prompt cache to disk (a llama.cpp session file); path
        defaults to config.prompt_cache_file. Returns the entries saved."""
        path = path or self.config.prompt_cache_file
        if self.prompt_cache is None or not path:
            return 0
        return self.prompt_cache.save(path)

    # -- generation ----------------------------------------------------------

    def generate(self, prompt: str, max_tokens: int = 128,
                 sampler: SamplerConfig | Sampler | None = None,
                 stop: list[str] | None = None,
                 on_token: Callable[[str], None] | None = None,
                 grammar=None) -> str:
        return "".join(self.generate_streaming(prompt, max_tokens, sampler,
                                               stop, on_token,
                                               grammar=grammar))

    def make_grammar_sampler(self, machine):
        """Bind a grammar machine (json_grammar()/gbnf_grammar()/...) to this
        model's vocab for constrained decoding."""
        from ..sampling.grammar import GrammarSampler

        vocab = [self.tokenizer.decode([i]) for i in
                 range(self.tokenizer.vocab_size)]
        return GrammarSampler(machine, vocab,
                              eos_token_id=self.tokenizer.eos_id)

    def _prefill(self, ids: list[int], cached: bool = False):
        """Prefill on the runner's unowned one-row cache. Returns (the last
        position's logits on the host, kv, position). ``cached``: with a
        prompt cache, restore the longest cached prefix into the row first,
        prefill only the rest, then store the prompt."""
        r = self.runner
        kv = r.init_kv(1)
        if not cached or self.prompt_cache is None:
            return r.prefill(ids, kv, host=True)
        shared = r.restore_prefix(self.prompt_cache, ids, kv)
        logits, kv, pos = r.prefill(ids[shared:], kv, start_pos=shared,
                                    host=True)
        r.store_prefix(self.prompt_cache, ids, kv)
        return logits, kv, pos

    def _fit_prompt(self, ids: list[int], max_tokens: int) -> list[int]:
        """The prompt's tail that fits the window. Without the context
        shift, the JAX package's rule: prompt and ``max_tokens`` fit
        (keeping at least one token, where JAX's slice empties or garbles
        the prompt once max_tokens >= max_seq - 1). With it, generation
        slides past the window, so only the prompt must fit: its last
        max_seq - 1 tokens (JAX applies the first rule there too, which
        leaves the shift unreachable but for an emptied prompt)."""
        max_seq = self.runner.max_seq
        if self.config.context_shift:
            return ids[-(max_seq - 1):]
        if len(ids) + max_tokens >= max_seq:
            return ids[-max(max_seq - max_tokens - 1, 1):]
        return ids

    def _decode(self, tok: int, pos: int, kv: dict) -> np.ndarray:
        return self.runner.decode_one(tok, pos, kv, host=True)[0]

    def _t5_encoder_ids(self, prompt: str | list[int]) -> list[int]:
        """Tokenize (or pass through) the encoder input, with the trailing
        EOS that the llama.cpp and HF T5 conventions expect."""
        ids = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
               else list(prompt))
        eos = self.tokenizer.eos_id if self.tokenizer else None
        if eos is not None and (not ids or ids[-1] != eos):
            ids = ids + [eos]
        return ids

    def _t5_stream(self, prompt: str, max_tokens: int, sampler, stop,
                   on_token) -> Iterator[str]:
        """Seq2seq generation: encode the prompt once (with its trailing
        EOS), load the T5 runner's decoder cache, then decode from
        decoder_start_token_id one graphed step at a time. Stop strings use
        the batched engine's prefix-withholding buffer."""
        t5 = self.t5
        if "dec" not in t5.params:
            raise RuntimeError(
                "t5encoder model: use embed(), not generate()")
        if sampler is not None and isinstance(sampler, SamplerConfig):
            sampler = Sampler(sampler)
        ids = self._t5_encoder_ids(prompt)
        self.stats = GenerationStats(prompt_tokens=len(ids))
        history: list[int] = []

        def pick(row):  # row: 1-D [V] raw logits
            if sampler is None:
                return int(np.argmax(row))
            return sampler.sample(row, history)

        from .batched import _StopBuffer

        decoder = self.tokenizer.streaming_decoder()
        stopbuf = _StopBuffer(stop or [])
        with t5.stream:
            t0 = time.time()
            sess = t5.begin(ids)
            self.stats.prefill_time = time.time() - t0
            t1 = time.time()
            tok = t5.cfg.decoder_start_token_id
            for t in range(min(max_tokens, t5.max_seq - 1)):
                tok = pick(t5.step_host(sess, tok, t))
                if self.tokenizer.is_eog(tok):
                    break
                history.append(tok)
                self.stats.generated_tokens += 1
                piece = decoder.push(tok)
                if piece:
                    out, hit = stopbuf.push(piece)
                    if out:
                        if on_token:
                            on_token(out)
                        yield out
                    if hit:
                        self.stats.decode_time = time.time() - t1
                        return
            tail = stopbuf.flush()
            if tail:
                if on_token:
                    on_token(tail)
                yield tail
            self.stats.decode_time = time.time() - t1

    def generate_streaming(self, prompt: str, max_tokens: int = 128,
                           sampler: SamplerConfig | Sampler | None = None,
                           stop: list[str] | None = None,
                           on_token: Callable[[str], None] | None = None,
                           grammar=None) -> Iterator[str]:
        if self.t5 is not None:  # encoder-decoder (T5) path
            if grammar is not None:
                raise ValueError(
                    "grammar-constrained decoding is not supported for "
                    "T5 models")
            yield from self._t5_stream(prompt, max_tokens, sampler, stop,
                                       on_token)
            return
        if self.runner is None:
            raise RuntimeError(
                "encoder-only model: use embed(), not generate()")
        if sampler is None:
            sampler = Sampler(SamplerConfig(seed=self.config.seed))
        elif isinstance(sampler, SamplerConfig):
            sampler = Sampler(sampler)

        ids = self._fit_prompt(self.tokenizer.encode(prompt), max_tokens)
        with self._stream:
            yield from self._stream_tokens(ids, max_tokens, sampler, stop,
                                           on_token, grammar)

    def _stream_tokens(self, ids, max_tokens, sampler, stop, on_token,
                       grammar) -> Iterator[str]:
        self.stats = GenerationStats(prompt_tokens=len(ids))
        t0 = time.time()
        logits, kv, pos = self._prefill(ids, cached=True)
        self.stats.prefill_time = time.time() - t0

        decoder = self.tokenizer.streaming_decoder()
        history = list(ids)
        tail = ""  # holds text that might be a stop-pattern prefix
        t1 = time.time()
        for _ in range(max_tokens):
            mask = grammar.get_token_mask() if grammar is not None else None
            tok = sampler.sample(logits, history, mask=mask)
            if self.tokenizer.is_eog(tok):
                break
            history.append(tok)
            piece = decoder.push(tok)
            if grammar is not None:
                grammar.record_token(self.tokenizer.decode([tok]))
                if grammar.is_complete and grammar.state is not None and \
                        grammar.machine.exhausted(grammar.state):
                    if piece:
                        if on_token:
                            on_token(piece)
                        yield piece
                    break
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
                if not self.config.context_shift:
                    break
                # drop the oldest quarter of the window: the cache slides
                # left in place, its keys re-rotated
                n = max(self.runner.max_seq // 4, 1)
                self.runner.shift_left(kv, n)
                pos -= n
            logits = self._decode(tok, pos, kv)
            pos += 1
        else:
            if tail:
                yield tail
                tail = ""
        self.stats.decode_time = time.time() - t1

    def greedy_tokens(self, prompt_ids: list[int], max_tokens: int) -> list[int]:
        """Pure greedy decode for parity harnesses: returns generated ids."""
        if self.t5 is not None:
            eos = self.tokenizer.eos_id if self.tokenizer else None
            return self.t5.generate_ids(self._t5_encoder_ids(prompt_ids),
                                        max_tokens, eos_id=eos)
        with self._stream:
            logits, kv, pos = self._prefill(prompt_ids)
            out = []
            for _ in range(max_tokens):
                tok = int(np.argmax(logits))
                out.append(tok)
                if self.tokenizer is not None and self.tokenizer.is_eog(tok):
                    break
                if pos >= self.runner.max_seq - 1:
                    break
                logits = self._decode(tok, pos, kv)
                pos += 1
            return out

    # -- embeddings ----------------------------------------------------------

    def embed(self, text: str, pooling: str = "mean",
              normalize: bool = True) -> np.ndarray:
        ids = self.tokenizer.encode(text)
        if self.encoder is not None:  # encoder-only (BERT-family) model
            return self.encoder.embed(ids, pooling=pooling,
                                      normalize=normalize)
        if self.t5 is not None:  # t5 / t5encoder: pooled encoder output
            h = self.t5.encode_host(ids)
            vec = h[-1] if pooling == "last" else (
                h[0] if pooling == "cls" else h.mean(axis=0))
            if normalize:
                vec = vec / (np.linalg.norm(vec) + 1e-12)
            return vec
        from ..models.embeddings import extract_embedding

        return extract_embedding(self.runner, ids, pooling=pooling,
                                 normalize=normalize)

    # -- chat ----------------------------------------------------------------

    def chat(self, messages: list[dict], max_tokens: int = 512,
             sampler: SamplerConfig | None = None,
             stop: list[str] | None = None) -> str:
        prompt = self.chat_template.render(messages)
        return self.generate(prompt, max_tokens=max_tokens, sampler=sampler,
                             stop=stop)

    def chat_streaming(self, messages: list[dict], max_tokens: int = 512,
                       sampler: SamplerConfig | None = None,
                       stop: list[str] | None = None) -> Iterator[str]:
        prompt = self.chat_template.render(messages)
        return self.generate_streaming(prompt, max_tokens=max_tokens,
                                       sampler=sampler, stop=stop)


class ChatEngine:
    """Multi-turn conversation state on top of Engine (the JAX package's
    ChatEngine)."""

    def __init__(self, engine: Engine, system_prompt: str | None = None):
        self.engine = engine
        self.messages: list[dict] = []
        if system_prompt:
            self.messages.append({"role": "system", "content": system_prompt})

    def send(self, user_message: str, max_tokens: int = 512,
             sampler: SamplerConfig | None = None) -> str:
        self.messages.append({"role": "user", "content": user_message})
        self._ensure_context_space(max_tokens)
        reply = self.engine.chat(self.messages, max_tokens=max_tokens,
                                 sampler=sampler)
        self.messages.append({"role": "assistant", "content": reply})
        return reply

    def send_streaming(self, user_message: str, max_tokens: int = 512,
                       sampler: SamplerConfig | None = None) -> Iterator[str]:
        self.messages.append({"role": "user", "content": user_message})
        self._ensure_context_space(max_tokens)
        parts: list[str] = []
        for piece in self.engine.chat_streaming(self.messages,
                                                max_tokens=max_tokens,
                                                sampler=sampler):
            parts.append(piece)
            yield piece
        self.messages.append({"role": "assistant", "content": "".join(parts)})

    def _ensure_context_space(self, max_tokens: int) -> None:
        """Drop oldest non-system turns until the prompt fits."""
        limit = self.engine.runner.max_seq - max_tokens - 16
        while len(self.messages) > 2:
            prompt = self.engine.chat_template.render(self.messages)
            if len(self.engine.tokenizer.encode(prompt)) <= limit:
                return
            start = 1 if self.messages[0]["role"] == "system" else 0
            del self.messages[start : start + 2]

    def reset(self) -> None:
        keep_system = self.messages[:1] if self.messages and \
            self.messages[0]["role"] == "system" else []
        self.messages = keep_system
