"""The graph keys a run's window will ask for, found and captured before it.

The port's runner captures one CUDA graph per (batch, T bucket, read
bound, gathered) key at first use, and a capture inside the window would
stall it: a run whose window captures fails. So set-up drives the cell's
own traffic, from a fresh stream of the run's seed, through a second
``BatchedEngine`` (the program's own scheduler: its admission, chunking
and read-bound choice) over a stand-in for the runner that records each
step's key and hands back zero logits without touching the device. Each
recorded key is then captured on the real runner. Every request of a mix
is greedy with ids 0-2 banned, so the scheduler picks id 3 from zero logits
of any width, and a step's key depends on lengths alone: the stand-in's
logits are 4 ids wide, which keeps the scheduler's host sampling cheap.

A closed loop's client resubmits from the finish hook, on the scheduler's
thread, so the steps are the same whatever a step takes: the dry run meets
the window's keys in the window's order, as far as ``horizon_steps`` steps
of primer, warm-up and window together (8,000 in each mix; the cells' runs
make about 1,000 and 500 on the H100 today). New keys keep appearing late
in a stream (at step 37,000 of 40,000), so a window of more steps than the
horizon may meet one the dry run did not, and the run then fails.
"""

from __future__ import annotations

import threading

import numpy as np

from .traffic import Traffic


class DryRunner:
    """The runner as the scheduler sees it, minus the model: ``step``
    records its key and returns zero logits for the picked rows; the cache
    is an empty dict; everything else is the real runner's."""

    WIDTH = 4  # ids 0-2 banned, 3 picked

    def __init__(self, runner, horizon: int):
        self._runner = runner
        self._horizon = horizon
        self.keys: dict[tuple, None] = {}
        self.steps = 0
        self.done = threading.Event()

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def init_kv(self, batch: int, owner=None) -> dict:
        return {}

    def clear_state(self, kv, slot) -> None:
        pass

    def release_kv(self, owner) -> None:
        pass

    def step(self, tokens, positions, lengths, kv, read_bound=None,
             logit_positions=None, host_rows=None):
        self.keys.setdefault((np.shape(tokens)[1], read_bound))
        self.steps += 1
        if self.steps >= self._horizon:
            self.done.set()
        return np.zeros((len(host_rows or ()), self.WIDTH), np.float32), kv


def dry_keys(batched, spec: dict, seed: int, vocab: int) -> list[tuple]:
    """(T bucket, read bound) keys, in order of first use, of the run's
    primer, warm-up and window, met by the program's scheduler over a
    ``DryRunner``."""
    from llama_gguf_tpu_torch.engine.batched import BatchedEngine

    from .serve import Window

    if spec["loop"] != "closed":
        raise ValueError("the dry run replays closed loops only: an open "
                         "loop's steps depend on how long each one takes")
    dry = DryRunner(batched.runner, spec["horizon_steps"])
    eng = BatchedEngine(dry, batched.tokenizer, max_queue=spec["max_queue"],
                        prefill_chunk=spec["prefill_chunk"])
    drv = Window(eng, Traffic(spec, seed, vocab), spec, 0.0)
    undo = drv.install()
    try:
        drv.prime()
        if not dry.done.wait(600):
            raise RuntimeError(f"the dry run made {dry.steps} of "
                               f"{spec['horizon_steps']} steps in 600 s")
    finally:
        drv.resubmit = False
        eng.shutdown()
        undo()
    return list(dry.keys)


def capture(batched, keys: list[tuple]) -> None:
    """Capture each key on the scheduler's own cache, with inputs that are
    all padding (as the server's warm-up does)."""
    r = batched.runner
    b, drop = r.max_batch, r.max_seq
    for bt, rb in keys:
        r.step(np.zeros((b, bt), np.int32), np.full((b, bt), drop, np.int32),
               np.zeros((b,), np.int32), batched._kv, read_bound=rb,
               logit_positions=np.zeros((b,), np.int32), host_rows=[0])
