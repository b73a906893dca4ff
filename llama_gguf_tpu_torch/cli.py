"""Command-line interface of the PyTorch port (port of llama_gguf_tpu/cli.py):
``info``, ``run``, ``chat``, ``serve``, ``bench``, ``quantize``,
``perplexity``, ``embed``, ``tokenize``, ``sysinfo``, ``download``,
``models``, ``rag``, ``init-config``, ``manpages``, ``shard`` and
``cluster``.

    python -m llama_gguf_tpu_torch run MODEL.gguf -p "Hello" -n 32
        [--prompt-cache FILE] [--context-shift] [--lora ADAPTER.gguf]
        [--draft DRAFT.gguf | --self-speculative N | --prompt-lookup N]
        [--num-draft K]
    python -m llama_gguf_tpu_torch chat MODEL.gguf [--system TEXT]
    python -m llama_gguf_tpu_torch serve MODEL.gguf [--port N] [--max-batch B]
        [--prefill-chunk T] [--rag-db KB.db]
    python -m llama_gguf_tpu_torch perplexity MODEL.gguf -f TEXT [--chunk 512]
        [--json]
    python -m llama_gguf_tpu_torch embed MODEL.gguf -p TEXT [-p TEXT] [--json]
    python -m llama_gguf_tpu_torch tokenize MODEL.gguf -p TEXT | --ids 5,9
    python -m llama_gguf_tpu_torch info MODEL.gguf [--tensors] [--json]
    python -m llama_gguf_tpu_torch bench MODEL.gguf [--json] [--profile DIR]
    python -m llama_gguf_tpu_torch quantize IN.gguf OUT.gguf -t q4_k
        [--all-tensors] [--min-elements N]
    python -m llama_gguf_tpu_torch sysinfo | models [--dir D] |
        init-config [PATH] | manpages [--dir D]
    python -m llama_gguf_tpu_torch download REPO_ID [FILE] [--list] [--dir D]
    python -m llama_gguf_tpu_torch rag ingest PATH... [--db KB.db]
        [--model EMBED.gguf] [--chunker markdown]
    python -m llama_gguf_tpu_torch rag search|ask QUERY [--db KB.db]
        [--model EMBED.gguf] [-k 5] [--search semantic|keyword|hybrid]
    python -m llama_gguf_tpu_torch shard MODEL.gguf --coordinator HOST:PORT
        --num-processes N --process-id I [--tp T] [--dp D] [--prompt TEXT]
    python -m llama_gguf_tpu_torch cluster [--model-bytes N]

Every subcommand takes ``--config FILE`` (TOML, config.py); each option is
taken from its flag, else its LLAMA_GGUF_* variable, else the file, else the
default. Every subcommand that loads a model loads it onto CUDA unless
``--device cpu`` is given, and raises when CUDA is absent. ``--tp``/``--dp``
(or ``[parallel]``) serve one model over a (data, model) mesh, one process
per rank: this process is rank 0 and spawns the others
(parallel/service.py); ``shard`` runs one rank of a group that every
process joins itself. ``rag`` embeds with ``--model`` on ``--device`` (with
no model: the feature-hashing embedder, no device); ``ask`` is
retrieval-only, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile

from .config import Config, example_config

KV_CHOICES = ["f32", "bf16", "i8", "f8_e4m3", "f8_e5m2", "tq2", "tq3", "tq4",
              "qjl"]


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", help="TOML config file path")
    p.add_argument("-v", "--verbose", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="llama-gguf-tpu-torch",
        description="GGUF LLM inference engine, PyTorch/CUDA port.")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("info", help="show GGUF metadata and tensor inventory")
    p.add_argument("model")
    p.add_argument("--tensors", action="store_true", help="list all tensors")
    p.add_argument("--json", dest="json_out", action="store_true")
    _add_common(p)

    p = sub.add_parser("run", help="generate text from a prompt")
    _add_model_flags(p)
    p.add_argument("-p", "--prompt", default=None)
    p.add_argument("--no-stream", action="store_true")
    p.add_argument("--draft", default=None,
                   help="draft model gguf for speculative decoding")
    p.add_argument("--self-speculative", type=int, default=None,
                   metavar="N", help="early-exit self-draft after N layers")
    p.add_argument("--num-draft", type=int, default=4,
                   help="draft tokens per speculative round")
    p.add_argument("--prompt-lookup", type=int, default=None, metavar="N",
                   help="draft-free n-gram speculation, N tokens per round")
    _add_gen_flags(p)
    p.add_argument("--stop", action="append", default=None)
    _add_common(p)

    p = sub.add_parser("chat", help="interactive chat")
    _add_model_flags(p)
    p.add_argument("--system", default=None, help="system prompt")
    p.add_argument("--template", default=None,
                   choices=["chatml", "llama2", "llama3", "gemma", "phi",
                            "plain"], help="override chat template style")
    _add_gen_flags(p)
    _add_common(p)

    p = sub.add_parser("serve", help="OpenAI-compatible HTTP server")
    _add_model_flags(p)
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--max-batch", type=int, default=None)
    p.add_argument("--max-queue", type=int, default=None)
    p.add_argument("--prefill-chunk", type=int, default=512,
                   help="prompt tokens per row in one batched step: a "
                   "longer prompt is prefilled in chunks beside the "
                   "decoding rows (smaller: shorter stalls for them)")
    p.add_argument("--api-key", action="append", default=None)
    p.add_argument("--rag-db", default=None,
                   help="sqlite path enabling /v1/rag/* endpoints")
    _add_common(p)

    p = sub.add_parser("bench", help="benchmark prefill/decode throughput")
    _add_model_flags(p)
    p.add_argument("--prompt-tokens", type=int, default=None)
    p.add_argument("--gen-tokens", type=int, default=None)
    p.add_argument("--batch", type=int, default=None,
                   help="accepted as the JAX CLI accepts it; one stream")
    p.add_argument("--json", dest="json_out", action="store_true")
    p.add_argument("--profile", nargs="?", default=None,
                   const=os.path.join(tempfile.gettempdir(),
                                      "llama_gguf_tpu_torch_profile"),
                   help="write a torch.profiler chrome trace to DIR")
    _add_common(p)

    p = sub.add_parser("quantize", help="requantize a GGUF model")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-t", "--type", default=None,
                   help="target type (q4_k, q6_k, q8_0, ...)")
    p.add_argument("--all-tensors", action="store_true",
                   help="also requantize embeddings/output")
    p.add_argument("--min-elements", type=int, default=None)
    _add_common(p)

    p = sub.add_parser("tokenize",
                       help="tokenize text / detokenize ids (debugging)")
    p.add_argument("model", help="path to .gguf model")
    p.add_argument("-p", "--prompt", default=None,
                   help="text to tokenize (default: stdin)")
    p.add_argument("--ids", default=None,
                   help="comma-separated ids to DEtokenize instead")
    p.add_argument("--no-bos", action="store_true",
                   help="do not add the BOS token")
    _add_common(p)

    p = sub.add_parser("sysinfo", help="show torch, the CUDA devices and the "
                       "kernel build directory")
    _add_common(p)

    p = sub.add_parser("perplexity", help="perplexity over a text file")
    _add_model_flags(p)
    p.add_argument("-f", "--file", required=True, help="input text file")
    p.add_argument("--chunk", type=int, default=512)
    p.add_argument("--json", dest="json_out", action="store_true")
    _add_common(p)

    p = sub.add_parser("embed", help="compute text embeddings")
    _add_model_flags(p)
    p.add_argument("-p", "--text", action="append", required=True)
    p.add_argument("--pooling", default=None,
                   choices=["mean", "last", "first", "max"])
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--json", dest="json_out", action="store_true")
    _add_common(p)

    p = sub.add_parser("download", help="download a GGUF from HuggingFace Hub")
    p.add_argument("repo_id", help="e.g. Qwen/Qwen2.5-0.5B-Instruct-GGUF")
    p.add_argument("filename", nargs="?", help="file within the repo")
    p.add_argument("--list", action="store_true", dest="list_files",
                   help="list GGUF files in the repo")
    p.add_argument("--dir", default=None, help="download directory")
    _add_common(p)

    p = sub.add_parser("models", help="list locally cached models")
    p.add_argument("--dir", default=None)
    _add_common(p)

    p = sub.add_parser("rag", help="RAG knowledge-base operations")
    rag_sub = p.add_subparsers(dest="rag_command", required=True)
    for name, help_ in (("ingest", "ingest documents"),
                        ("search", "search the knowledge base"),
                        ("ask", "retrieve-and-generate with citations")):
        rp = rag_sub.add_parser(name, help=help_)
        rp.add_argument("--db", default=None,
                        help="sqlite database path (default: [rag].db)")
        rp.add_argument("--model", help="embedding model gguf", default=None)
        rp.add_argument("--device", default="cuda",
                        help="the embedding model's device: cuda (default) "
                        "or cpu")
        if name == "ingest":
            rp.add_argument("paths", nargs="+")
            rp.add_argument("--chunker", default=None,
                            choices=["recursive", "markdown", "sliding",
                                     "sentence", "paragraph"])
        else:
            rp.add_argument("query")
            rp.add_argument("-k", type=int, default=None)
            rp.add_argument("--search", default=None,
                            choices=["semantic", "keyword", "hybrid"])
        _add_common(rp)

    p = sub.add_parser("init-config", help="write an example config file")
    p.add_argument("path", nargs="?", default="llama-gguf.toml")
    _add_common(p)

    p = sub.add_parser("manpages", help="generate man pages")
    p.add_argument("--dir", default="man")
    _add_common(p)

    p = sub.add_parser(
        "shard", help="join a process group and serve one rank of a mesh "
        "(every process loads its own shard of the GGUF)")
    p.add_argument("model", nargs="?", help="GGUF model path")
    p.add_argument("--coordinator", required=True,
                   help="coordinator address host:port")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--tp", type=int, default=0,
                   help="model-axis size (0 = every process)")
    p.add_argument("--dp", type=int, default=1, help="data-axis size")
    p.add_argument("--prompt", default=None,
                   help="rank 0 only: generate for this prompt then stop")
    p.add_argument("-n", "--max-tokens", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: card rank %% count) or cpu")
    _add_common(p)

    p = sub.add_parser(
        "cluster", help="show distributed cluster topology/status")
    p.add_argument("--cluster-config", default=None,
                   help="cluster TOML file")
    p.add_argument("--model-bytes", type=int, default=0,
                   help="planned model size for auto mesh sizing")
    _add_common(p)
    return ap


def _add_gen_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-n", "--max-tokens", type=int, default=None)
    p.add_argument("-t", "--temperature", type=float, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--min-p", type=float, default=None)
    p.add_argument("--repeat-penalty", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("model", nargs="?", help="path to .gguf model")
    p.add_argument("--ctx", type=int, default=None, help="max context length")
    p.add_argument("--weight-mode", choices=["quant", "dequant"],
                   default=None)
    p.add_argument("--kv-cache-type", choices=KV_CHOICES, default=None,
                   help="KV-cache storage: f32, bf16, i8 (per-head scales), "
                   "f8_e4m3, f8_e5m2, TurboQuant tq2-tq4, or qjl (1-bit "
                   "key sketches, tq4 values)")
    p.add_argument("--context-shift", action="store_true",
                   help="generate past the window by sliding the KV cache")
    p.add_argument("--lora", default=None,
                   help="GGUF LoRA adapter to apply at load")
    p.add_argument("--lora-scale", type=float, default=None,
                   help="override the adapter's alpha/rank scaling")
    p.add_argument("--prompt-cache", default=None, metavar="FILE",
                   help="session file: load cached KV prefixes at start, "
                        "save back after generation (llama.cpp parity)")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel mesh axis (0 = auto-fit the cards' "
                   "memory)")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel mesh axis")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _load_config(args) -> Config:
    return Config.load(getattr(args, "config", None))


def _pick(args, flag: str, default):
    """The flag's value when given, else ``default`` (env or TOML)."""
    v = getattr(args, flag, None)
    return v if v is not None else default


def _engine_config(cfg: Config, args):
    from .engine.engine import EngineConfig

    return EngineConfig(
        max_context_len=_pick(args, "ctx", cfg.model.max_context_len),
        weight_mode=_pick(args, "weight_mode", cfg.model.weight_mode),
        kv_format=_pick(args, "kv_cache_type", cfg.model.kv_cache_type),
        matmul_precision=cfg.model.matmul_precision,
        chat_template=_pick(args, "template", cfg.chat.template),
        context_shift=args.context_shift,
        seed=_pick(args, "seed", cfg.generation.seed),
        prompt_cache_file=args.prompt_cache,
        lora=_pick(args, "lora", cfg.model.lora),
        lora_scale=args.lora_scale,
        mesh_model=_pick(args, "tp", cfg.parallel.model),
        mesh_data=_pick(args, "dp", cfg.parallel.data))


def _sampler(cfg: Config, args):
    from .sampling.sampler import SamplerConfig

    g = cfg.generation
    return SamplerConfig(
        temperature=_pick(args, "temperature", g.temperature),
        top_k=_pick(args, "top_k", g.top_k),
        top_p=_pick(args, "top_p", g.top_p),
        min_p=_pick(args, "min_p", g.min_p),
        repetition_penalty=_pick(args, "repeat_penalty", g.repetition_penalty),
        frequency_penalty=g.frequency_penalty,
        presence_penalty=g.presence_penalty,
        mirostat=g.mirostat, mirostat_tau=g.mirostat_tau,
        mirostat_eta=g.mirostat_eta,
        seed=_pick(args, "seed", g.seed))


def _model_path(cfg: Config, args) -> str:
    path = getattr(args, "model", None) or cfg.model.path
    if not path:
        sys.exit("error: no model path (pass MODEL or set [model].path)")
    if not os.path.exists(path):
        sys.exit(f"error: model not found: {path}")
    return path


_LOADED: list = []  # engines of the running command, closed by main


def _load_engine(cfg: Config, args):
    """The engine of the model flags; ``main`` closes it when the command
    ends (a mesh's follower ranks stop)."""
    from .engine.engine import Engine

    engine = Engine.load(_model_path(cfg, args), _engine_config(cfg, args),
                         device=args.device)
    _LOADED.append(engine)
    return engine


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------


def cmd_info(args) -> int:
    from .gguf.reader import GGUFFile

    g = GGUFFile.open(args.model)
    try:
        by_type: dict[str, int] = {}
        total_bytes = 0
        for info in g.tensors.values():
            by_type[info.ggml_type.name] = by_type.get(info.ggml_type.name, 0) + 1
            total_bytes += info.nbytes
        if args.json_out:
            meta = {k: (v.tolist() if hasattr(v, "tolist") else v)
                    for k, v in g.metadata.items()
                    if not k.startswith("tokenizer.")}
            print(json.dumps({
                "path": args.model, "version": g.version,
                "tensor_count": len(g.tensors), "data_bytes": total_bytes,
                "types": by_type, "metadata": meta,
            }, default=str))
            return 0
        print(f"GGUF v{g.version}  {args.model}")
        arch = g.metadata.get("general.architecture", "?")
        print(f"  architecture : {arch}")
        for key in ("general.name", f"{arch}.block_count",
                    f"{arch}.embedding_length", f"{arch}.attention.head_count",
                    f"{arch}.attention.head_count_kv", f"{arch}.context_length",
                    f"{arch}.feed_forward_length", "general.file_type"):
            if key in g.metadata:
                print(f"  {key.split('.', 1)[1]:<28}: {g.metadata[key]}")
        print(f"  tensors      : {len(g.tensors)} "
              f"({total_bytes / 1e6:.1f} MB) {by_type}")
        if args.tensors:
            for name in g.tensor_order:
                info = g.tensors[name]
                print(f"  {name:<48} {info.ggml_type.name:<8} "
                      f"{list(info.shape)}")
        return 0
    finally:
        g.close()


def cmd_run(args) -> int:
    cfg = _load_config(args)
    engine = _load_engine(cfg, args)
    prompt = args.prompt if args.prompt is not None else sys.stdin.read()
    sampler = _sampler(cfg, args)
    max_tokens = _pick(args, "max_tokens", cfg.generation.max_tokens)
    stop = args.stop if args.stop is not None else cfg.generation.stop
    if args.draft or args.self_speculative or args.prompt_lookup:
        try:
            return _run_speculative(cfg, args, engine, prompt, sampler,
                                    max_tokens)
        except NotImplementedError as e:  # a model speculation refuses
            print(f"error: {e}", file=sys.stderr)
            return 1
    if args.no_stream:
        print(engine.generate(prompt, max_tokens=max_tokens,
                              sampler=sampler, stop=stop))
    else:
        for piece in engine.generate_streaming(prompt, max_tokens=max_tokens,
                                               sampler=sampler, stop=stop):
            print(piece, end="", flush=True)
        print()
    s = engine.stats
    print(f"[prefill {s.prompt_tokens} tok @ {s.prefill_tps:.1f} tok/s | "
          f"decode {s.generated_tokens} tok @ {s.decode_tps:.1f} tok/s]",
          file=sys.stderr)
    if engine.save_prompt_cache():
        print(f"[prompt cache saved to {args.prompt_cache}]",
              file=sys.stderr)
    return 0


def _run_speculative(cfg, args, engine, prompt, sampler, max_tokens) -> int:
    """run --draft / --self-speculative / --prompt-lookup: the draft model
    loads with the target's EngineConfig."""
    import time

    from .engine.engine import Engine
    from .engine.speculative import (PromptLookupDecoder, SpeculativeDecoder,
                                     refuse_unrollable)

    refuse_unrollable(engine.runner, "target")
    if args.prompt_lookup:
        dec = PromptLookupDecoder(engine.runner,
                                  num_draft=args.prompt_lookup)
    elif args.draft:
        draft_engine = Engine.load(args.draft, _engine_config(cfg, args),
                                   device=args.device)
        dec = SpeculativeDecoder(engine.runner, draft_engine.runner,
                                 num_draft=args.num_draft)
    else:
        dec = SpeculativeDecoder.self_speculative(
            engine.runner, exit_layer=args.self_speculative,
            num_draft=args.num_draft)
    ids = engine.tokenizer.encode(prompt)
    t0 = time.time()
    if args.prompt_lookup and not sampler.is_greedy:
        print("warning: --prompt-lookup is greedy-only; sampling flags "
              "ignored", file=sys.stderr)
    if sampler.is_greedy or args.prompt_lookup:
        out = dec.generate_greedy(ids, max_tokens,
                                  is_eog=engine.tokenizer.is_eog)
    else:
        out = dec.generate_sampled(ids, max_tokens, sampler,
                                   seed=sampler.seed,
                                   is_eog=engine.tokenizer.is_eog)
    dt = time.time() - t0
    print(engine.tokenizer.decode(out))
    s = dec.stats
    print(f"[speculative: {len(out)} tok @ {len(out) / dt:.1f} tok/s | "
          f"acceptance {s.acceptance_rate:.0%} | "
          f"{s.tokens_per_round:.2f} tok/round]", file=sys.stderr)
    return 0


def cmd_chat(args) -> int:
    """Interactive chat on stdin: one user turn per line; /reset clears the
    history, /exit (or the end of the input) quits and saves the prompt
    cache when one was given."""
    from .engine.engine import ChatEngine

    cfg = _load_config(args)
    engine = _load_engine(cfg, args)
    chat = ChatEngine(engine, system_prompt=args.system
                      or cfg.chat.system_prompt)
    sampler = _sampler(cfg, args)
    max_tokens = _pick(args, "max_tokens", cfg.generation.max_tokens)

    def bye() -> int:
        if engine.save_prompt_cache():
            print(f"[prompt cache saved to {args.prompt_cache}]",
                  file=sys.stderr)
        return 0

    print("(interactive chat — /exit to quit, /reset to clear)")
    while True:
        try:
            user = input("> ")
        except (EOFError, KeyboardInterrupt):
            print()
            return bye()
        if user.strip() in ("/exit", "/quit"):
            return bye()
        if user.strip() == "/reset":
            chat.reset()
            continue
        if not user.strip():
            continue
        for piece in chat.send_streaming(user, max_tokens=max_tokens,
                                         sampler=sampler):
            print(piece, end="", flush=True)
        print()


def serve_config(args, cfg: Config | None = None):
    """The ServerConfig of ``serve``'s flags over ``cfg`` (default: the
    --config file and the environment)."""
    from .server.app import ServerConfig

    cfg = cfg or _load_config(args)
    return ServerConfig(
        host=_pick(args, "host", cfg.server.host),
        port=_pick(args, "port", cfg.server.port),
        model_path=_model_path(cfg, args),
        max_batch=_pick(args, "max_batch", cfg.server.max_batch),
        max_queue=_pick(args, "max_queue", cfg.server.max_queue),
        max_tokens_default=cfg.generation.max_tokens,
        prefill_chunk=args.prefill_chunk,
        weight_mode=_pick(args, "weight_mode", cfg.model.weight_mode),
        api_keys=args.api_key or cfg.server.api_keys,
        served_model_name=cfg.server.served_model_name,
        rag_db=args.rag_db, device=args.device,
        max_context_len=_pick(args, "ctx", cfg.model.max_context_len),
        kv_format=_pick(args, "kv_cache_type", cfg.model.kv_cache_type),
        lora=_pick(args, "lora", cfg.model.lora),
        mesh_model=_pick(args, "tp", cfg.parallel.model),
        mesh_data=_pick(args, "dp", cfg.parallel.data))


def cmd_serve(args) -> int:
    from .server.app import run_server

    run_server(serve_config(args))
    return 0


def bench(engine, prompt_tokens: int = 32, gen_tokens: int = 64,
          profile_dir: str | None = None) -> dict:
    """The JAX CLI's bench on a loaded engine: a prefill of random prompt
    ids (``default_rng(0)``), a 1-step greedy_decode warm-up, then a timed
    greedy_decode ended by one host fetch of its tokens. The prefill's time
    includes its graph's capture, as the JAX one includes its compile.
    ``profile_dir``: write a torch.profiler chrome trace of the timed
    decode there (utils/debug.profile)."""
    import contextlib
    import time

    import numpy as np
    import torch

    from .utils.debug import profile

    r = engine.runner
    ids = np.random.default_rng(0).integers(
        0, r.cfg.vocab_size, size=prompt_tokens).tolist()
    kv = r.init_kv()
    t0 = time.time()
    logits, kv, pos = r.prefill(ids, kv)
    logits.cpu()
    prefill_s = time.time() - t0
    first = torch.argmax(logits)[None].to(torch.int32)
    _, kv = r.greedy_decode(first, [pos], kv, steps=1)  # warm-up
    prof = profile(profile_dir) if profile_dir else contextlib.nullcontext()
    with prof:
        t0 = time.time()
        toks, kv = r.greedy_decode(first, [pos + 1], kv, steps=gen_tokens)
        toks.cpu()
        decode_s = time.time() - t0
    return {"prefill_tps": prompt_tokens / prefill_s,
            "decode_tps": gen_tokens / decode_s,
            "prompt_tokens": prompt_tokens, "gen_tokens": gen_tokens}


def cmd_bench(args) -> int:
    cfg = _load_config(args)
    engine = _load_engine(cfg, args)
    ptoks = _pick(args, "prompt_tokens", cfg.bench.prompt_tokens)
    gtoks = _pick(args, "gen_tokens", cfg.bench.gen_tokens)
    result = bench(engine, ptoks, gtoks, args.profile)
    if args.json_out:
        print(json.dumps(result))
    else:
        print(f"prefill: {result['prefill_tps']:.1f} tok/s "
              f"({ptoks} tok, incl. capture)")
        print(f"decode:  {result['decode_tps']:.1f} tok/s ({gtoks} tok)")
    return 0


def cmd_quantize(args) -> int:
    import time

    from .gguf.constants import GGMLType
    from .gguf.requantize import QuantizeOptions, quantize_model

    cfg = _load_config(args)
    tname = (args.type or cfg.quantize.type).upper()
    try:
        target = GGMLType[tname]
    except KeyError:
        sys.exit(f"error: unknown quant type {tname!r}")
    t0 = time.time()

    def progress(name, i, total):
        print(f"\r[{i}/{total}] {name[:60]:<60}", end="", flush=True)

    report = quantize_model(
        args.input, args.output,
        QuantizeOptions(
            target=target,
            weights_only=not args.all_tensors and cfg.quantize.weights_only,
            min_elements=_pick(args, "min_elements",
                               cfg.quantize.min_elements)),
        progress=progress)
    print(f"\n{report.converted} converted, {report.skipped} kept, "
          f"{report.fallback_f16} f16-fallback; "
          f"{report.in_bytes / 1e6:.1f} -> {report.out_bytes / 1e6:.1f} MB "
          f"in {time.time() - t0:.1f}s")
    return 0


def cmd_perplexity(args) -> int:
    from .engine.perplexity import perplexity

    cfg = _load_config(args)
    engine = _load_engine(cfg, args)
    with open(args.file, errors="replace") as f:
        text = f.read()
    ids = engine.tokenizer.encode(text)

    def progress(done, total, ppl):
        print(f"\r[{done}/{total}] ppl={ppl:.4f}   ", end="",
              file=sys.stderr, flush=True)

    result = perplexity(engine.runner, ids, chunk=args.chunk,
                        progress=progress)
    print(file=sys.stderr)
    if args.json_out:
        print(json.dumps({"ppl": result.ppl, "nll": result.nll,
                          "tokens": result.count}))
    else:
        print(f"perplexity: {result.ppl:.4f} over {result.count} tokens "
              f"(nll {result.nll:.4f})")
    return 0


def cmd_embed(args) -> int:
    import numpy as np

    cfg = _load_config(args)
    engine = _load_engine(cfg, args)
    pooling = args.pooling or cfg.embed.pooling
    normalize = not args.no_normalize and cfg.embed.normalize
    try:
        vecs = [engine.embed(t, pooling=pooling, normalize=normalize)
                for t in args.text]
    except NotImplementedError as e:  # a model with no embeddings
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.json_out:
        print(json.dumps([np.asarray(v).tolist() for v in vecs]))
    else:
        for t, v in zip(args.text, vecs):
            print(f"{t[:40]!r}: dim={v.shape[0]} "
                  f"head={np.round(v[:6], 4).tolist()}")
        if len(vecs) == 2:
            from .models.embeddings import cosine_similarity

            print(f"cosine similarity: "
                  f"{cosine_similarity(vecs[0], vecs[1]):.4f}")
    return 0


def cmd_tokenize(args) -> int:
    """llama-tokenize analogue: ids + per-token pieces, or detokenize."""
    from .gguf.reader import GGUFFile
    from .tokenizer.gguf_tokenizer import Tokenizer

    g = GGUFFile.open(args.model)
    try:
        tok = Tokenizer.from_gguf(g.metadata)
    finally:
        g.close()
    if args.ids is not None:
        ids = [int(x) for x in args.ids.replace(",", " ").split()]
        print(tok.decode(ids))
        return 0
    text = args.prompt if args.prompt is not None else sys.stdin.read()
    ids = tok.encode(text, add_bos=False if args.no_bos else None)
    for i in ids:
        print(f"{i:>8} -> {tok.decode([i])!r}")
    print(f"total: {len(ids)} tokens")
    return 0


def cmd_sysinfo(args) -> int:
    """torch and its CUDA, each CUDA device (name, capability, free and
    total memory) and the port's kernel build directory; a host with no
    card says so."""
    import torch

    from .utils.cuda_build import BUILD_DIR

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda or 'none'})")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        print("devices: 0 (no CUDA device: the port's kernels need one; "
              "--device cpu runs the plain path)")
    else:
        print(f"devices: {n}")
    for i in range(n):
        major, minor = torch.cuda.get_device_capability(i)
        free, total = torch.cuda.mem_get_info(i)
        print(f"  [{i}] cuda {torch.cuda.get_device_name(i)} (sm_{major}"
              f"{minor}) memory: {(total - free) / 1e9:.2f} / "
              f"{total / 1e9:.2f} GB in use")
    print(f"kernel build directory: {BUILD_DIR}")
    return 0


def cmd_download(args) -> int:
    from .hub import HubClient

    client = HubClient(cache_dir=args.dir)
    if args.list_files or not args.filename:
        files = client.list_gguf_files(args.repo_id)
        for f in files:
            print(f)
        if not args.list_files and len(files) == 1:
            print(client.download(args.repo_id, files[0]))
        return 0
    print(client.download(args.repo_id, args.filename))
    return 0


def cmd_models(args) -> int:
    from .hub import HubClient

    for path, size in HubClient(cache_dir=args.dir).list_local_models():
        print(f"{size / 1e6:10.1f} MB  {path}")
    return 0


def cmd_rag(args) -> int:
    from .rag.cli import run_rag_command

    return run_rag_command(args)


def cmd_init_config(args) -> int:
    if os.path.exists(args.path):
        sys.exit(f"error: {args.path} already exists")
    with open(args.path, "w") as f:
        f.write(example_config())
    print(f"wrote {args.path}")
    return 0


def cmd_manpages(args) -> int:
    from .manpages import write_manpages

    n = write_manpages(build_parser(), args.dir)
    print(f"wrote {n} man pages to {args.dir}/")
    return 0


def cmd_shard(args) -> int:
    """Join a process group and run the lock-step serve loop
    (parallel/service.serve_spmd): every process loads its own shard of the
    GGUF; rank 0 serves ``--prompt`` and the loop ends."""
    import torch.distributed as dist

    from .parallel.multihost import ClusterConfig, initialize_cluster
    from .parallel.service import serve_spmd

    info = initialize_cluster(ClusterConfig(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id, device=args.device))
    print(f"[shard {args.process_id}/{args.num_processes}] cluster up: "
          f"{info}", file=sys.stderr)
    try:
        if not args.model:
            return 0
        from .engine.engine import Engine

        from .engine.engine import EngineConfig

        m = _load_config(args).model
        engine = Engine.load(args.model, EngineConfig(
            max_context_len=m.max_context_len, weight_mode=m.weight_mode,
            kv_format=m.kv_cache_type, matmul_precision=m.matmul_precision,
            lora=m.lora,
            mesh_model=args.tp or args.num_processes // max(args.dp, 1),
            mesh_data=args.dp), device=args.device)
        reqs = []
        if args.process_id == 0 and args.prompt is not None:
            reqs = [(engine.tokenizer.encode(args.prompt), args.max_tokens)]
        outs = serve_spmd(engine.runner, engine.tokenizer, reqs,
                          on_text=lambda txt: print(txt, flush=True))
        print(f"[shard {args.process_id}] served {len(outs)} request(s)",
              file=sys.stderr)
        return 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def cmd_cluster(args) -> int:
    """The cluster's topology as JSON: the ClusterConfig of the environment
    or a TOML file's [cluster] table, this host's cards, and with
    ``--model-bytes`` the auto-mesh plan."""
    import torch

    from .parallel.multihost import ClusterConfig, auto_mesh

    cc = ClusterConfig.from_env()
    if args.cluster_config:
        import tomllib

        with open(args.cluster_config, "rb") as f:
            t = tomllib.load(f).get("cluster", {})
        cc = ClusterConfig(
            coordinator_address=t.get("coordinator_address",
                                      cc.coordinator_address),
            num_processes=t.get("num_processes", cc.num_processes),
            process_id=t.get("process_id", cc.process_id),
            data=t.get("data", 0), model=t.get("model", 0))
    cuda = torch.cuda.is_available()
    out = {
        "coordinator": cc.coordinator_address,
        "num_processes": cc.num_processes,
        "local_devices": torch.cuda.device_count() if cuda else 1,
        "platform": "gpu" if cuda else "cpu",
    }
    if cuda:
        out["devices"] = [torch.cuda.get_device_name(i)
                          for i in range(torch.cuda.device_count())]
    if args.model_bytes:
        data, model = auto_mesh(args.model_bytes,
                                n_devices=out["local_devices"])
        out["auto_mesh"] = {"data": data, "model": model}
    print(json.dumps(out, indent=2))
    return 0


COMMANDS = {"info": cmd_info, "run": cmd_run, "chat": cmd_chat,
            "serve": cmd_serve, "bench": cmd_bench, "quantize": cmd_quantize,
            "perplexity": cmd_perplexity, "embed": cmd_embed,
            "tokenize": cmd_tokenize, "sysinfo": cmd_sysinfo,
            "download": cmd_download, "models": cmd_models,
            "rag": cmd_rag, "init-config": cmd_init_config,
            "manpages": cmd_manpages, "shard": cmd_shard,
            "cluster": cmd_cluster}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if getattr(args, "verbose", False) else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s")
    try:
        return COMMANDS[args.command](args)
    except KeyboardInterrupt:
        return 130
    finally:
        while _LOADED:
            _LOADED.pop().close()


if __name__ == "__main__":
    sys.exit(main())
