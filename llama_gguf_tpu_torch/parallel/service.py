"""Serving over a mesh: the lock-step SPMD loop, and rank 0 driving ranks
it spawned (port of llama_gguf_tpu/parallel/service.py).

Two ways to run the ranks of one model, one process per rank:

* ``serve_spmd`` (the CLI's ``shard``): every process joined the process
  group itself and runs this loop. Rank 0 takes the requests; each round
  it broadcasts [op, n_tokens, max_new | token_ids...] as one int32 vector,
  and every rank decodes the same buffer and runs the same prefill and
  greedy decode on its own runner. op=0 stops. Each round's wall time is
  gathered from every rank into the imbalance monitor
  (multihost.evaluate_imbalance); the first round is left out, as it holds
  the kernels' first launches.

* ``load_mesh`` (``Engine.load`` with a mesh and no process group): rank 0
  spawns ranks 1..N-1 as child processes (``python -m
  llama_gguf_tpu_torch.parallel.follower``). Each loads its own shard and
  then ``follow``s: rank 0's runner (engine/runner.MeshRunner) sends each of
  its device calls down the children's stdin pipes, and they make the same
  call, so an Engine, a BatchedEngine or the server runs over the mesh as
  on one device. A child whose pipe closes (rank 0 stopped or died) exits;
  ``Followers.close`` stops them, as does the interpreter's exit.

The JAX package runs one process over all its local devices; one process
per rank is the port's deliberate difference (ROADMAP queue 3).
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import logging
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from .multihost import leave_group

log = logging.getLogger(__name__)

OP_STOP = 0
OP_GENERATE = 1

# test hook: artificial per-round slowdown (seconds) for degraded-host
# simulation in the 2-process CPU tests
_SLOWDOWN_ENV = "LLAMA_GGUF_STEP_SLOWDOWN_S"


def encode_request(op: int, tokens: list[int], max_new: int,
                   max_prompt: int) -> np.ndarray:
    buf = np.zeros(3 + max_prompt, np.int32)
    buf[0] = op
    buf[1] = len(tokens)
    buf[2] = max_new
    buf[3: 3 + len(tokens)] = tokens
    return buf


def _broadcast(vec: np.ndarray, group) -> np.ndarray:
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(vec))
    dist.broadcast(t, src=0, group=group)
    return t.numpy()


def _all_gather_float(x: float, group, size: int) -> np.ndarray:
    import torch.distributed as dist

    parts = [torch.zeros(1, dtype=torch.float32) for _ in range(size)]
    dist.all_gather(parts, torch.tensor([x], dtype=torch.float32),
                    group=group)
    return torch.cat(parts).numpy()


def serve_spmd(runner, tokenizer, requests: Iterable[tuple[list[int], int]],
               max_prompt: int = 1024,
               on_text: Callable[[str], None] | None = None,
               step_metrics: dict | None = None) -> list[list[int]]:
    """Run the lock-step loop on a MeshRunner. On rank 0, ``requests``
    yields (token_ids, max_new) pairs; on the others it must be empty (they
    take requests from the broadcast). Returns the generated token lists
    (every rank returns the same). ``step_metrics`` (a dict) receives each
    rank's StepMetrics under "host{rank}"; a rank running 1.5x slower than
    the fastest is logged as degraded."""
    from .multihost import StepMetrics, evaluate_imbalance

    mesh = runner.mesh
    leader = mesh.rank == 0
    outs: list[list[int]] = []
    it = iter(requests) if leader else None
    metrics: dict = step_metrics if step_metrics is not None else {}
    slowdown = float(os.environ.get(_SLOWDOWN_ENV, "0") or 0)
    rounds = 0

    while True:
        if leader:
            try:
                toks, max_new = next(it)
                buf = encode_request(OP_GENERATE, toks, max_new, max_prompt)
            except StopIteration:
                buf = encode_request(OP_STOP, [], 0, max_prompt)
        else:
            buf = np.zeros(3 + max_prompt, np.int32)
        buf = _broadcast(buf, mesh.cpu_group)
        op, n, max_new = int(buf[0]), int(buf[1]), int(buf[2])
        if op == OP_STOP:
            return outs
        toks = buf[3: 3 + n].tolist()

        t0 = time.time()
        kv = runner.init_kv(1)
        logits, kv, pos = runner.prefill(toks, kv)
        first = int(torch.argmax(logits))
        gen = [first]
        if max_new > 1:
            more, _ = runner.greedy_decode(
                np.asarray([first]), np.asarray([pos]), kv,
                steps=max_new - 1)
            gen += more[0].cpu().tolist()
        if slowdown > 0:
            time.sleep(slowdown)  # degraded-host simulation (tests)
        local_s = time.time() - t0

        all_s = _all_gather_float(local_s, mesh.cpu_group, mesh.size)
        rounds += 1
        if rounds > 1:
            for p, s in enumerate(all_s):
                metrics.setdefault(f"host{p}", StepMetrics()).record(float(s))
        report = evaluate_imbalance(metrics)
        if report.imbalanced and leader:
            log.warning(
                "host imbalance detected: slowest %.3fs vs fastest %.3fs "
                "(ratio %.2fx) — a degraded host drags every collective; "
                "replace it or drop it from the mesh",
                report.max_ewma, report.min_ewma, report.ratio)

        outs.append(gen)
        if leader and on_text is not None and tokenizer is not None:
            on_text(tokenizer.decode(gen))


# -- rank 0 and the ranks it spawns ------------------------------------------

class Followers:
    """Ranks 1..N-1, child processes of rank 0: ``send`` pickles a message
    down each child's stdin; ``close`` sends the stop (None), waits, kills
    what is left and removes the group's store directory."""

    def __init__(self, procs: list[subprocess.Popen], store_dir: str):
        self.procs = procs
        self.store_dir = store_dir
        self.closed = False
        atexit.register(self.close)

    def send(self, msg) -> None:
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        for rank, p in enumerate(self.procs, 1):
            if p.poll() is not None:
                raise RuntimeError(f"mesh rank {rank}'s process exited "
                                   f"with code {p.returncode}")
            p.stdin.write(data)
            p.stdin.flush()

    def wait_for(self, word: str) -> None:
        """Read ``word`` from every child's handshake line; a child that
        exits first (its pipe ends) raises with its exit code."""
        for p in self.procs:
            line = p.stdout.readline().decode().strip()
            if line != word:
                p.wait()
                raise RuntimeError(
                    f"mesh rank process exited with code {p.returncode} "
                    f"before {word!r} (see its stderr above)")

    def close(self, timeout: float = 60.0) -> None:
        if self.closed:
            return
        self.closed = True
        for p in self.procs:
            try:
                if p.poll() is None:
                    p.stdin.write(pickle.dumps(None))
                    p.stdin.flush()
                p.stdin.close()
            except (BrokenPipeError, OSError):
                pass
        deadline = time.time() + timeout
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for p in self.procs:
            p.stdout.close()
        shutil.rmtree(self.store_dir, ignore_errors=True)


def follow(runner, stream) -> None:
    """A spawned rank's loop: make each call rank 0's runner sends, until
    the stop (None) or the end of the pipe. A call that raises here raised
    on rank 0 too (the same call on the same inputs): it is logged, and
    the loop goes on."""
    while True:
        try:
            msg = pickle.load(stream)
        except EOFError:
            return
        if msg is None:
            return
        name, args, kw = msg
        try:
            getattr(runner, name)(*runner.decode(args), **runner.decode(kw))
        except Exception as e:  # noqa: BLE001 - rank 0 raises the same
            log.warning("mesh rank %d: %s raised %s: %s", runner.mesh.rank,
                        name, type(e).__name__, e)


def _spawn(spec: dict, world: int, store_dir: str) -> Followers:
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = []
    for rank in range(1, world):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "llama_gguf_tpu_torch.parallel.follower",
             json.dumps({**spec, "rank": rank})],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env))
    return Followers(procs, store_dir)


def load_params(path: str, config):
    """The whole model's params on the host, with the config's LoRA
    adapter attached (engine.EngineConfig), before sharding."""
    from ..gguf.reader import GGUFFile
    from ..models.loader import ModelLoader

    params, cfg = ModelLoader(GGUFFile.open(path), mode=config.weight_mode,
                              device="cpu").build()
    if config.lora:
        from ..models.lora import LoraAdapter, apply_lora

        adapter = LoraAdapter.load_gguf(config.lora)
        n = apply_lora(params, adapter, scale=config.lora_scale)
        log.info("lora: attached %d tensors from %s (rank %d)", n,
                 config.lora, adapter.rank)
    return params, cfg


def rank_runner(params: dict, cfg, config, n_data: int, n_model: int,
                device, followers: Followers | None = None):
    """This rank's MeshRunner over the initialized process group: the
    mesh, this rank's shard on ``device``, its runner."""
    from ..engine.engine import runner_kwargs
    from ..engine.runner import MeshRunner
    from .sharding import make_mesh, shard_params, to_device

    mesh = make_mesh(n_model, n_data, device)
    local = to_device(shard_params(params, cfg, mesh), device)
    return MeshRunner(local, cfg, mesh, followers,
                      **runner_kwargs(cfg, config), device=device)


def _init_group(rank: int, world: int, init_method: str, device) -> tuple:
    import torch.distributed as dist

    from .multihost import dist_timeout, placement

    dev, backend = placement(rank, world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=dist_timeout())
    return dev, backend


def load_mesh(path: str, config, device, n_data: int, n_model: int):
    """Rank 0's MeshRunner of ``path`` over a (data, model) mesh. Where a
    process group exists (the CLI's ``shard``), over it, with no followers:
    every process drives its own runner. Else rank 0 loads first (so the
    others load from the repack sidecar it writes), builds the CUDA kernels
    once, spawns ranks 1..N-1, and meets them in a new process group whose
    store is a file in a new temporary directory."""
    import torch.distributed as dist

    from .sharding import refuse_unplanned

    dev = torch.device(device)
    params, cfg = load_params(path, config)
    refuse_unplanned(params)
    if dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return rank_runner(params, cfg, config, n_data, n_model, dev)
    world = n_data * n_model
    if dev.type == "cuda":
        from ..utils import cuda_build

        cuda_build.build_all(["qgemm", "moe_qmatmul"])
    store_dir = tempfile.mkdtemp(prefix="llama_gguf_mesh_")
    init_method = (Path(store_dir) / "store").as_uri()
    spec = {"path": str(path), "config": dataclasses.asdict(config),
            "device": dev.type, "data": n_data, "model": n_model,
            "world": world, "init_method": init_method,
            "threads": torch.get_num_threads()}
    followers = _spawn(spec, world, store_dir)
    try:
        followers.wait_for("loaded")
        rank_dev, backend = _init_group(0, world, init_method, dev.type)
        log.info("mesh of %d ranks (data=%d, model=%d) over %s, rank 0 on "
                 "%s", world, n_data, n_model, backend, rank_dev)
        runner = rank_runner(params, cfg, config, n_data, n_model, rank_dev,
                             followers)
        followers.wait_for("ready")
    except BaseException:
        followers.close(timeout=10)
        leave_group()
        raise
    atexit.register(close_mesh, runner)  # a process in a live group aborts
    return runner


def close_mesh(runner) -> None:
    """Stop the followers of rank 0's ``runner`` and leave the process
    group it made (a ``shard`` process keeps its own group)."""
    followers = getattr(runner, "followers", None)
    if followers is None:
        return
    followers.close()
    runner.followers = None
    leave_group()


def follower_main(spec: dict) -> int:
    """Rank ``spec["rank"]`` of a mesh that rank 0 spawned (the entry point
    of parallel/follower.py). Its stdout carries only the handshake
    ("loaded", then "ready"); everything it prints goes to stderr."""
    from ..engine.engine import EngineConfig

    proto = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    logging.basicConfig(level=logging.WARNING)
    torch.set_num_threads(spec["threads"])
    config = EngineConfig(**spec["config"])
    params, cfg = load_params(spec["path"], config)
    print("loaded", file=proto, flush=True)
    dev, _ = _init_group(spec["rank"], spec["world"], spec["init_method"],
                         spec["device"])
    runner = rank_runner(params, cfg, config, spec["data"], spec["model"],
                         dev)
    del params
    print("ready", file=proto, flush=True)
    try:
        follow(runner, sys.stdin.buffer)
    finally:
        leave_group()
    return 0
