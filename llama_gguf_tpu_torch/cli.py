"""Command-line interface of the PyTorch port (subset of
llama_gguf_tpu/cli.py): ``info``, ``run``, ``chat``, ``serve``, ``bench`` and
``quantize``.

    python -m llama_gguf_tpu_torch run MODEL.gguf -p "Hello" -n 32
    python -m llama_gguf_tpu_torch chat MODEL.gguf [--system TEXT]
    python -m llama_gguf_tpu_torch serve MODEL.gguf [--port N] [--max-batch B]
        [--prefill-chunk T]
    python -m llama_gguf_tpu_torch info MODEL.gguf [--tensors] [--json]
    python -m llama_gguf_tpu_torch bench MODEL.gguf [--json] [--profile DIR]
    python -m llama_gguf_tpu_torch quantize IN.gguf OUT.gguf -t q4_k
        [--all-tensors] [--min-elements N]

Every subcommand that loads a model loads it onto CUDA unless ``--device
cpu`` is given, and raises when CUDA is absent (``quantize`` is host work and
loads no model). The TOML config file, the speculative, grammar and LoRA
flags and the other subcommands are ROADMAP queue 1 item 6; without the
config file ``quantize`` takes the JAX CLI's defaults (q4_k, weights only,
1024 elements).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="llama-gguf-tpu-torch",
        description="GGUF LLM inference engine, PyTorch/CUDA port.")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("info", help="show GGUF metadata and tensor inventory")
    p.add_argument("model")
    p.add_argument("--tensors", action="store_true", help="list all tensors")
    p.add_argument("--json", dest="json_out", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")

    p = sub.add_parser("run", help="generate text from a prompt")
    _add_model_flags(p)
    p.add_argument("-p", "--prompt", default=None)
    p.add_argument("--no-stream", action="store_true")
    _add_gen_flags(p)
    p.add_argument("--stop", action="append", default=None)
    p.add_argument("-v", "--verbose", action="store_true")

    p = sub.add_parser("chat", help="interactive chat")
    _add_model_flags(p)
    p.add_argument("--system", default=None, help="system prompt")
    p.add_argument("--template", default=None,
                   choices=["chatml", "llama2", "llama3", "gemma", "phi",
                            "plain"], help="override chat template style")
    _add_gen_flags(p)
    p.add_argument("-v", "--verbose", action="store_true")

    p = sub.add_parser("serve", help="OpenAI-compatible HTTP server")
    _add_model_flags(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--prefill-chunk", type=int, default=512,
                   help="prompt tokens per row in one batched step: a "
                   "longer prompt is prefilled in chunks beside the "
                   "decoding rows (smaller: shorter stalls for them)")
    p.add_argument("--api-key", action="append", default=None)
    p.add_argument("--rag-db", default=None,
                   help="not ported yet (ROADMAP queue 1 item 13): raises")
    p.add_argument("-v", "--verbose", action="store_true")

    p = sub.add_parser("bench", help="benchmark prefill/decode throughput")
    _add_model_flags(p)
    p.add_argument("--prompt-tokens", type=int, default=32)
    p.add_argument("--gen-tokens", type=int, default=64)
    p.add_argument("--batch", type=int, default=None,
                   help="accepted as the JAX CLI accepts it; one stream")
    p.add_argument("--json", dest="json_out", action="store_true")
    p.add_argument("--profile", nargs="?", default=None,
                   const=os.path.join(tempfile.gettempdir(),
                                      "llama_gguf_tpu_torch_profile"),
                   help="write a torch.profiler chrome trace to DIR")
    p.add_argument("-v", "--verbose", action="store_true")

    p = sub.add_parser("quantize", help="requantize a GGUF model")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-t", "--type", default="q4_k",
                   help="target type (q4_k, q6_k, q8_0, ...)")
    p.add_argument("--all-tensors", action="store_true",
                   help="also requantize embeddings/output")
    p.add_argument("--min-elements", type=int, default=1024)
    p.add_argument("-v", "--verbose", action="store_true")
    return ap


def _add_gen_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-n", "--max-tokens", type=int, default=512)
    p.add_argument("-t", "--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--min-p", type=float, default=0.0)
    p.add_argument("--repeat-penalty", type=float, default=1.1)
    p.add_argument("--seed", type=int, default=None)


def _sampler(args):
    from .sampling.sampler import SamplerConfig

    return SamplerConfig(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        min_p=args.min_p, repetition_penalty=args.repeat_penalty,
        seed=args.seed)


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("model", help="path to .gguf model")
    p.add_argument("--ctx", type=int, default=None, help="max context length")
    p.add_argument("--weight-mode", choices=["quant", "dequant"],
                   default="quant")
    p.add_argument("--kv-cache-type", choices=["f32", "bf16"], default="f32")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch path)")


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
    from .engine.engine import Engine, EngineConfig

    if not os.path.exists(args.model):
        sys.exit(f"error: model not found: {args.model}")
    engine = Engine.load(
        args.model,
        EngineConfig(max_context_len=args.ctx, weight_mode=args.weight_mode,
                     kv_format=args.kv_cache_type, seed=args.seed),
        device=args.device)
    prompt = args.prompt if args.prompt is not None else sys.stdin.read()
    sampler = _sampler(args)
    if args.no_stream:
        print(engine.generate(prompt, max_tokens=args.max_tokens,
                              sampler=sampler, stop=args.stop))
    else:
        for piece in engine.generate_streaming(prompt,
                                               max_tokens=args.max_tokens,
                                               sampler=sampler,
                                               stop=args.stop):
            print(piece, end="", flush=True)
        print()
    s = engine.stats
    print(f"[prefill {s.prompt_tokens} tok @ {s.prefill_tps:.1f} tok/s | "
          f"decode {s.generated_tokens} tok @ {s.decode_tps:.1f} tok/s]",
          file=sys.stderr)
    return 0


def cmd_chat(args) -> int:
    """Interactive chat on stdin: one user turn per line; /reset clears the
    history, /exit (or the end of the input) quits."""
    from .engine.engine import ChatEngine, Engine, EngineConfig

    if not os.path.exists(args.model):
        sys.exit(f"error: model not found: {args.model}")
    engine = Engine.load(
        args.model,
        EngineConfig(max_context_len=args.ctx, weight_mode=args.weight_mode,
                     kv_format=args.kv_cache_type, seed=args.seed,
                     chat_template=args.template),
        device=args.device)
    chat = ChatEngine(engine, system_prompt=args.system)
    sampler = _sampler(args)
    print("(interactive chat — /exit to quit, /reset to clear)")
    while True:
        try:
            user = input("> ")
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if user.strip() in ("/exit", "/quit"):
            return 0
        if user.strip() == "/reset":
            chat.reset()
            continue
        if not user.strip():
            continue
        for piece in chat.send_streaming(user, max_tokens=args.max_tokens,
                                         sampler=sampler):
            print(piece, end="", flush=True)
        print()


def serve_config(args):
    """The ServerConfig of ``serve``'s flags."""
    from .server.app import ServerConfig

    return ServerConfig(
        host=args.host, port=args.port, model_path=args.model,
        max_batch=args.max_batch, max_queue=args.max_queue,
        prefill_chunk=args.prefill_chunk, weight_mode=args.weight_mode,
        api_keys=args.api_key or [], rag_db=args.rag_db, device=args.device,
        max_context_len=args.ctx, kv_format=args.kv_cache_type)


def cmd_serve(args) -> int:
    from .server.app import run_server

    if not os.path.exists(args.model):
        sys.exit(f"error: model not found: {args.model}")
    run_server(serve_config(args))
    return 0


def bench(engine, prompt_tokens: int = 32, gen_tokens: int = 64,
          profile_dir: str | None = None) -> dict:
    """The JAX CLI's bench on a loaded engine: a prefill of random prompt
    ids (``default_rng(0)``), a 1-step greedy_decode warm-up, then a timed
    greedy_decode ended by one host fetch of its tokens. The prefill's time
    includes its graph's capture, as the JAX one includes its compile.
    ``profile_dir``: write a torch.profiler chrome trace of the timed
    decode there."""
    import contextlib
    import time

    import numpy as np
    import torch

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
    prof = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if r.device.type == "cuda" else [])
        prof = profile(activities=acts)
    with prof:
        t0 = time.time()
        toks, kv = r.greedy_decode(first, [pos + 1], kv, steps=gen_tokens)
        toks.cpu()
        decode_s = time.time() - t0
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        logging.getLogger(__name__).info("profile trace written to %s",
                                         profile_dir)
    return {"prefill_tps": prompt_tokens / prefill_s,
            "decode_tps": gen_tokens / decode_s,
            "prompt_tokens": prompt_tokens, "gen_tokens": gen_tokens}


def cmd_bench(args) -> int:
    from .engine.engine import Engine, EngineConfig

    if not os.path.exists(args.model):
        sys.exit(f"error: model not found: {args.model}")
    engine = Engine.load(
        args.model,
        EngineConfig(max_context_len=args.ctx, weight_mode=args.weight_mode,
                     kv_format=args.kv_cache_type),
        device=args.device)
    result = bench(engine, args.prompt_tokens, args.gen_tokens, args.profile)
    if args.json_out:
        print(json.dumps(result))
    else:
        print(f"prefill: {result['prefill_tps']:.1f} tok/s "
              f"({args.prompt_tokens} tok, incl. capture)")
        print(f"decode:  {result['decode_tps']:.1f} tok/s "
              f"({args.gen_tokens} tok)")
    return 0


def cmd_quantize(args) -> int:
    import time

    from .gguf.constants import GGMLType
    from .gguf.requantize import QuantizeOptions, quantize_model

    tname = args.type.upper()
    try:
        target = GGMLType[tname]
    except KeyError:
        sys.exit(f"error: unknown quant type {tname!r}")
    t0 = time.time()

    def progress(name, i, total):
        print(f"\r[{i}/{total}] {name[:60]:<60}", end="", flush=True)

    report = quantize_model(
        args.input, args.output,
        QuantizeOptions(target=target, weights_only=not args.all_tensors,
                        min_elements=args.min_elements),
        progress=progress)
    print(f"\n{report.converted} converted, {report.skipped} kept, "
          f"{report.fallback_f16} f16-fallback; "
          f"{report.in_bytes / 1e6:.1f} -> {report.out_bytes / 1e6:.1f} MB "
          f"in {time.time() - t0:.1f}s")
    return 0


COMMANDS = {"info": cmd_info, "run": cmd_run, "chat": cmd_chat,
            "serve": cmd_serve, "bench": cmd_bench, "quantize": cmd_quantize}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if getattr(args, "verbose", False) else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s")
    try:
        return COMMANDS[args.command](args)
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
