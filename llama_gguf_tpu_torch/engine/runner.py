"""ModelRunner: prefill and decode steps over the functional model (port of
llama_gguf_tpu/engine/runner.py).

    step(tokens[B,T], positions[B,T], lengths[B], kv) -> (logits, kv)

Prefill pads the prompt to a bucket length (padding tokens carry position
max_seq and are dropped by the cache write), and attention reads the KV
cache up to a power-of-two read bucket, or, for a ragged batch, two of them
(``pick_read_bound``). Decode is one forward per token; ``greedy_decode``
keeps the argmax on the device and fetches nothing.

On CUDA a step runs as a CUDA graph, the counterpart of the JAX package's
jitted steps: one graph per (batch, T, read bound, gathered logits), the JAX
compile key, and one per (batch, read bound) for a greedy decode step, all
captured after one eager warm-up run and sharing one memory pool. Each graph
has static input buffers, so a call copies its inputs in and replays: one
launch from the host where the eager step makes ~1,700. A graph is bound to
the addresses of the cache it was captured on, so the runner owns its caches
(``init_kv``): one per batch size and owner, each with its own graphs, so
no caller can zero or overwrite another's (the continuous-batching engine
owns one, the single-stream paths use the unowned one). A cache it did not
make runs eagerly and is counted in ``eager_steps``. On the CPU every step
runs eagerly (the plain path).

A step whose grid is wider than one launch of ``LAUNCH_TOKENS`` token rows
runs as a launch plan (``step``): the rows that carry a prefill chunk go G
at a time through a (G, T) forward that scatters and gathers their cache
rows by a row map, and every other row rides the (B, 1) decode graph, so
the padding of a continuous batch's mixed step is not computed. A hybrid
cache takes the plan when its recurrent state is LFM2's short-conv window
alone: the map gathers and writes back each chunk row's window, and a
launch's spare places, which repeat its first row, write none. The plan
follows from the step's key and the cache's kinds alone, so a key's first
step, whatever its inputs, captures every graph of its plan.

Threads: the runner is the one module that makes a served model's CUDA
calls, and it serializes them itself. Every step, capture, greedy loop and
embedding forward holds one re-entrant lock per device, and the forms a
server uses hand back host arrays copied under it (``step(...,
host_rows=)``, ``prefill``/``decode_one(..., host=True)``,
``hidden_states``), so no caller takes a lock or touches a device tensor;
the context shift and the prompt cache's restore and store write or read
a cache in place under the same lock (``shift_left``, ``restore_prefix``,
``store_prefix``), so the graphs captured on it replay after them.
Captures run in PyTorch's "thread_local" error mode: CUDA work that another
thread queues meanwhile (a model load during a hot reload: allocations,
copies, kernels) cannot break them. Two things still must not happen on
another thread during a capture, and neither a load nor the serving path
does them: a device-wide synchronize (``torch.cuda.synchronize()`` ends the
capture) and a draw from the default CUDA generator (bound to the capture,
so the draw raises).

A graph reads the params by address too: whatever rewrites them in place
(models/lora.py's apply_lora and remove_lora) calls ``reset_graphs``, and
the next step captures again. A runner over the same tensors (the early-exit
self-draft of engine/speculative.py) is tied to this one by
``share_params``, and the reset drops its graphs too. With LLAMA_DEBUG set (utils/debug.py) the
forward prints each layer's activation RMS, which a graph cannot do: every
step then runs eagerly and counts in ``eager_steps``.

Spans (utils/debug.py): a ``step`` records ``runner.inputs`` (its int32
inputs packed and copied), then ``runner.replay`` (preceded by
``runner.capture`` at a key's first step) or, on the eager path,
``runner.forward``, then ``runner.fetch`` (the picked rows' logits copied to
the host, with ``host_rows``); a plan's launches run inside the one
``runner.replay`` or ``runner.forward``. Counters: ``captures``,
``capture_seconds`` (their total), ``pool_bytes``, ``replays`` per key,
``eager_steps``, and ``last_launch``, the prefill launches, token rows and
recurrent-state rows of the calling thread's last step.

``MeshRunner`` is one rank's runner under a (data, model) mesh
(parallel/): its params are the rank's shard, its caches the rank's heads
and rows, and rank 0 sends each of its device calls to the other ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import threading
import time
import weakref

import numpy as np
import torch

from ..models import kv as KV
from ..models.config import ModelConfig
from ..models.deltanet import init_deltanet_state
from ..models.mamba import KINDS as MAMBA_KINDS, init_mamba_state
from ..models.loader import resolve_device
from ..models.transformer import (ROW_MAPPED_KINDS, embed, forward,
                                  layer_forward)
from ..ops import qmatmul as Q
from ..ops.norms import apply_norm
from ..utils.debug import debug_activations_enabled, span

log = logging.getLogger(__name__)

_DEVICE_LOCKS: dict[str, threading.RLock] = {}


def _device_lock(device) -> threading.RLock:
    """The one lock of ``device``, shared by every runner on it (an old and
    a new engine during a hot reload): a capture begins with a device-wide
    synchronize, which would end another runner's capture in progress."""
    dev = torch.device(device)
    return _DEVICE_LOCKS.setdefault(f"{dev.type}:{dev.index or 0}",
                                    threading.RLock())


PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_len(t: int) -> int:
    for b in PREFILL_BUCKETS:
        if t <= b:
            return b
    return int(2 ** math.ceil(math.log2(t)))


READ_BOUND_MIN = 256


def read_bucket(n: int, max_seq: int) -> int:
    """KV read bound covering ``n`` live positions: the smallest power of two
    >= n (floor 256, cap max_seq)."""
    if n >= max_seq:
        return max_seq
    b = READ_BOUND_MIN
    while b < n:
        b *= 2
    return min(b, max_seq)


# the most token rows one prefill launch of a step's launch plan carries
LAUNCH_TOKENS = 512
# the cache formats a launch plan's row map covers (models/kv.write and read
# scatter and gather them by row); tq and qjl steps run the whole grid
PLAN_FORMATS = ("f32", "bf16", "i8", "f8_e4m3", "f8_e5m2")


def launch_rows(t: int) -> int:
    """G, the rows of one prefill launch of a T = ``t`` step's plan: the
    largest power of two with G * t <= max(t, LAUNCH_TOKENS)."""
    g = 1
    while 2 * g * t <= max(t, LAUNCH_TOKENS):
        g *= 2
    return g


TIER_CAP_MAX = 8  # most rows the high tier will carry
TIER_GAIN = 0.9  # tier only when it saves >=10% of attention reads
TIER_HYSTERESIS = 1.3  # keep the previous config while within 1.3x optimum


def pick_read_bound(lengths, max_seq: int, shards: int = 1,
                    prev: int | tuple[int, int, int] | None = None,
                    ) -> int | tuple[int, int, int]:
    """Choose the decode-step KV read configuration for a ragged batch (the
    JAX package's function). ``lengths``: per-row live context (0 = empty
    slot). Returns a single bucket (every row reads it) or a two-tier
    ``(lo, hi, cap)`` tuple for models/transformer.forward: all rows read
    ``lo``, the <= ``cap`` longest rows re-run at ``hi``. Chosen by
    minimising the modelled attention reads B*lo + shards*cap*hi over the
    power-of-two lo buckets, so one long row in a batch stops taxing the
    others. ``shards``: contiguous batch groups the tier is selected in
    (``cap`` covers the worst group). ``prev``: the caller's previous pick,
    kept while it is still correct for these lengths and within
    TIER_HYSTERESIS of the optimum, so a serving loop does not hop between
    graph keys."""
    lens = [int(x) for x in lengths]
    b = len(lens)
    g = shards if shards > 1 and b % shards == 0 else 1
    bl = b // g
    hi = read_bucket(max(lens), max_seq)
    best_cost = b * hi
    best: int | tuple[int, int, int] = hi
    lo = READ_BOUND_MIN
    while lo < hi:
        c = max(sum(1 for n in lens[i * bl:(i + 1) * bl] if n > lo)
                for i in range(g))
        if 0 < c <= TIER_CAP_MAX and g * c < b:
            cap = min(1 << (c - 1).bit_length(), bl)
            cost = b * lo + g * cap * hi
            if cost < TIER_GAIN * best_cost:
                best_cost, best = cost, (lo, hi, cap)
        lo *= 2
    if prev is not None and prev != best:
        if isinstance(prev, tuple):
            plo, phi, pcap = prev
            over = max(sum(1 for n in lens[i * bl:(i + 1) * bl] if n > plo)
                       for i in range(g))
            if (max(lens) <= phi and over <= pcap <= bl
                    and b * plo + g * pcap * phi
                    <= TIER_HYSTERESIS * best_cost):
                return prev
        elif max(lens) <= prev <= max_seq \
                and b * prev <= TIER_HYSTERESIS * best_cost:
            return prev
    return best


@dataclasses.dataclass
class _Graph:
    """A captured step: its key, the graph, its static packed int32 inputs
    (None for a greedy step, which reads the runner's token and position
    buffers), its static output, and the kernel launches one replay makes
    (ops/qmatmul.launch_counts)."""
    key: tuple
    graph: torch.cuda.CUDAGraph
    inputs: torch.Tensor | None
    out: torch.Tensor | None
    launches: tuple[dict, dict]
    capture_s: float  # its warm-up and capture


class ModelRunner:
    def __init__(self, params: dict, cfg: ModelConfig, max_batch: int = 1,
                 max_seq: int | None = None,
                 matmul_precision: str = "highest",
                 kv_format: str | None = None, device="cuda",
                 swa_ring: bool = True, swa_ring_extra: int = 1024):
        """``matmul_precision``: "highest" (f32 throughout, no TF32) or
        "default", in which the quantized kernels emit bf16 outputs, rounded
        once from their f32 sums (the JAX package's _out_dtype). The port's
        own torch matmuls (attention, router, dense weights) stay f32 in
        "default", where the JAX package on a TPU takes one bf16 pass.
        ``kv_format``: the KV-cache storage, one of models/kv.FORMATS (f32,
        bf16, i8, f8_e4m3, f8_e5m2, tq2, tq3, tq4, qjl).
        ``swa_ring``: a model with interleaved sliding-window layers
        (swa_pattern > 1) keeps those layers in a ring of ``ring_slots`` =
        the window rounded up to 128 plus ``swa_ring_extra`` slots, when
        that is shorter than max_seq and the format takes a ring
        (models/kv.ring_format_ok); the same values in less memory. The
        context shift needs swa_ring=False. Each runner captures its graphs
        into its own pool, on caches of its one format."""
        if matmul_precision not in ("highest", "default"):
            raise ValueError(f"unknown matmul_precision {matmul_precision!r}: "
                             "'highest' or 'default'")
        kv_format = kv_format or "f32"
        if kv_format not in KV.FORMATS:
            raise ValueError(f"unknown kv format {kv_format!r} (one of "
                             f"{KV.FORMATS})")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 parity: no TF32 in cuBLAS matmuls (dense and attention)
            torch.backends.cuda.matmul.allow_tf32 = False
        self.params = params
        self.cfg = cfg = dataclasses.replace(cfg, kv_format=kv_format)
        self.max_batch = max_batch
        self.max_seq = max_seq or cfg.max_seq_len
        self.kv_format = kv_format
        self.matmul_precision = matmul_precision
        self.swa_layers = tuple(cfg.layer_is_swa(i)
                                for i in range(cfg.num_layers))
        self.ring_slots = 0
        if swa_ring and cfg.swa_pattern > 1 and any(self.swa_layers) \
                and KV.ring_format_ok(kv_format):
            want = -(-cfg.sliding_window // 128) * 128 + swa_ring_extra
            if want - abs(cfg.sliding_window) + 1 < PREFILL_BUCKETS[0]:
                raise ValueError(
                    f"SWA ring headroom too small: ring of {want} slots "
                    f"leaves {want - abs(cfg.sliding_window) + 1} safe "
                    f"prefill tokens (< {PREFILL_BUCKETS[0]}); raise "
                    "swa_ring_extra or pass swa_ring=False")
            if want < self.max_seq:
                self.ring_slots = want
        self.swa_ring, self.swa_ring_extra = swa_ring, swa_ring_extra
        self._lock = _device_lock(self.device)
        self.mesh = None  # parallel.sharding.Mesh of a MeshRunner
        self.tier_shards = 1  # batch groups of a tiered read (one device)
        self.cache_kv_heads = cfg.cache_kv_heads  # a rank's under a mesh
        # the runner's own caches, by (batch, owner)
        self._kv: dict[tuple[int, str | None], dict] = {}
        self._graphs: dict[tuple, _Graph] = {}
        self._greedy_io: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        self._pool = None  # the graphs' shared memory pool
        self.eager_steps = 0  # CUDA steps run eagerly (a foreign cache)
        self.replays: dict[tuple, int] = {}  # per graph key
        # the captures made, their seconds of warm-up and capture, and the
        # device memory they reserved (the pool's growth)
        self.captures = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        # (prefill launches, rows launched) of each thread's last step
        self._launched = threading.local()
        self._debug_logged = False
        # the runners whose params alias this one's (share_params), itself
        # included: reset_graphs drops the graphs of them all
        self._param_sharers = weakref.WeakSet([self])

    @property
    def ring_safe(self) -> int:
        """The most tokens one step may write into the ring, R - window + 1
        (models/kv.write_swa); 0 without a ring."""
        if not self.ring_slots:
            return 0
        return self.ring_slots - abs(self.cfg.sliding_window) + 1

    @property
    def ring_chunk(self) -> int:
        """The longest prefill step a ring cache takes: the largest prefill
        bucket within ring_safe (the padded length is what write_swa
        checks); 0 without a ring."""
        if not self.ring_slots:
            return 0
        return max(b for b in PREFILL_BUCKETS if b <= self.ring_safe)

    # -- state ---------------------------------------------------------------

    def _make_kv(self, batch: int) -> dict:
        """A new zeroed cache, with the recurrent state of a hybrid model's
        DeltaNet or Mamba-family layers. The runner keeps none of these: a
        step on one runs eagerly (the plain path the graphs are held
        against)."""
        cache = KV.init_cache(
            self.cfg.num_layers, batch, self.max_seq,
            self.cache_kv_heads, self.cfg.cache_k_dim,
            v_head_dim=self.cfg.cache_v_dim, fmt=self.kv_format,
            device=self.device, swa_layers=self.swa_layers,
            ring_slots=self.ring_slots)
        kinds = set(self.cfg.layer_kinds or ())
        if "deltanet" in kinds:
            cache["deltanet"] = init_deltanet_state(
                self.cfg, batch, self.cfg.num_layers, device=self.device)
        if kinds & set(MAMBA_KINDS):
            cache["mamba"] = init_mamba_state(
                self.cfg, batch, self.cfg.num_layers, device=self.device)
        return cache

    def init_kv(self, batch: int | None = None,
                owner: str | None = None) -> dict:
        """The runner's own cache for ``batch`` rows and ``owner``, zeroed
        in place: the same tensors at every call, so the graphs captured on
        them replay. The JAX runner returns a new cache and donates it to
        each step; the port's steps update the cache in place instead, and
        a new request reuses (and clears) the previous one's, so one request
        per (batch, owner) runs at a time. A caller that keeps its rows
        across requests (engine/batched.py) names itself as ``owner``, and
        no other caller's ``init_kv`` touches its cache."""
        with self._lock:
            key = (batch or self.max_batch, owner)
            kv = self._kv.get(key)
            if kv is None:
                kv = self._kv[key] = self._make_kv(key[0])
            else:
                KV.zero_(kv)
            return kv

    def clear_state(self, kv: dict, row: int) -> None:
        """Zero batch row ``row``'s recurrent state in ``kv`` in place
        (models/kv.clear_state), under the runner's lock: a new sequence in
        a reused row starts from no state."""
        with self._lock:
            KV.clear_state(kv, row)

    def shift_left(self, kv: dict, n: int, batch_idx: int | None = None
                   ) -> None:
        """Context shift on ``kv`` in place, under the runner's lock
        (models/kv.shift_left with this model's per-layer RoPE): the graphs
        captured on one of the runner's own caches replay on it after."""
        with self._lock:
            KV.shift_left(kv, n, batch_idx=batch_idx, model_cfg=self.cfg)

    def restore_prefix(self, cache, token_ids: list[int], kv: dict,
                       batch_idx: int = 0) -> int:
        """``cache.restore`` (engine/prompt_cache.py) into row ``batch_idx``
        of ``kv`` in place, under the runner's lock. Returns the restored
        length: prefill continues from there."""
        with self._lock:
            return cache.restore(token_ids, kv, batch_idx=batch_idx)[1]

    def store_prefix(self, cache, token_ids: list[int], kv: dict,
                     batch_idx: int = 0) -> None:
        """``cache.put`` of row ``batch_idx``'s first len(token_ids)
        positions, under the runner's lock."""
        with self._lock:
            cache.put(token_ids, kv, batch_idx=batch_idx)

    def release_kv(self, owner: str) -> None:
        """Drop ``owner``'s caches, and the graphs and buffers bound to
        them. A memory pool that no graph holds any more is not captured
        into again (PyTorch's allocator asserts on such a pool): the next
        capture starts a new one."""
        with self._lock:
            for d in (self._kv, self._greedy_io):
                for key in [k for k in d if k[-1] == owner]:
                    del d[key]
            for key in [k for k in self._graphs if k[-1] == owner]:
                del self._graphs[key]
            if not self._graphs:
                self._pool = None

    def share_params(self, other: "ModelRunner") -> None:
        """Tie ``other``, a runner over tensors of this one's params (the
        self-draft's layers are the target's own dicts), to this one: a
        reset_graphs on either drops the graphs of both, since an in-place
        rewrite of the shared dicts frees what either's graphs read."""
        self._param_sharers |= other._param_sharers
        for r in self._param_sharers:
            r._param_sharers = self._param_sharers

    def reset_graphs(self) -> None:
        """Drop every captured graph, the greedy loop's I/O buffers and the
        graphs' memory pool, of this runner and of every runner tied to it
        by share_params. Whatever rewrites the params in place calls this
        (a graph reads the old tensors by address, and replays them after
        they are freed); the next step on a cache captures anew. The caches
        themselves stay."""
        for r in list(self._param_sharers):
            with r._lock:
                r._graphs.clear()
                r._greedy_io.clear()
                r._pool = None

    def _graphed(self, kv: dict, steps: int = 1):
        """The (batch, owner) of ``kv`` when steps on it replay graphs: on
        CUDA, with one of the runner's own caches, and LLAMA_DEBUG off;
        else None. ``steps`` that run eagerly on CUDA are counted in
        ``eager_steps``."""
        if self.device.type != "cuda":
            return None
        if debug_activations_enabled():
            if not self._debug_logged:
                self._debug_logged = True
                log.warning("LLAMA_DEBUG is set: every step runs eagerly "
                            "(a CUDA graph cannot print the activations)")
            self.eager_steps += steps
            return None
        for key, own in self._kv.items():
            if own is kv:
                return key
        self.eager_steps += steps
        return None

    @staticmethod
    def _graph_key(key: tuple, cache: tuple) -> tuple:
        """A graph's key: the step's key, and the cache's owner unless the
        cache is the unowned one (whose keys are the JAX compile keys)."""
        return key if cache[1] is None else key + (cache[1],)

    # -- graphs --------------------------------------------------------------

    def _capture(self, key: tuple, warm, body,
                 inputs: torch.Tensor | None = None) -> _Graph:
        """Run ``warm()`` (the step on dummy inputs that are all padding:
        positions in the drop slot, lengths 0, so neither the K/V nor a
        recurrent state changes) eagerly on a side stream, so every kernel is
        built and every workspace sized, then capture ``body()`` into the
        runner's pool. The launches counted during the capture are taken
        back (it launches nothing) and kept for crediting at each replay.
        A failure raises: nothing falls back to the eager step."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm()
        cur.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = Q.launch_counts()
        # the capture empties the allocator's cache first: so does this,
        # and what is reserved after the capture is the pool's growth
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        # "thread_local": only this thread's unsafe calls end the capture,
        # not another thread's CUDA work (the runner's lock orders its own)
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            out = body()
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        launches = Q.launch_counts(since=before)
        Q.credit(launches, -1)
        seconds = time.perf_counter() - t0
        self.capture_seconds += seconds
        self.captures += 1
        return _Graph(key, graph, inputs, out, launches, seconds)

    def _replay(self, g: _Graph) -> None:
        g.graph.replay()
        Q.credit(g.launches)
        self.replays[g.key] = self.replays.get(g.key, 0) + 1

    def _norm_bound(self, read_bound):
        """A read bound capped at max_seq; a tier whose lo reaches hi is the
        single bound hi. Tuples get the shard count 1 (one device)."""
        if isinstance(read_bound, tuple):
            lo, hi, cap = read_bound[:3]
            hi = min(hi, self.max_seq)
            return (lo, hi, cap, 1) if lo < hi else hi
        if read_bound is not None:
            return min(read_bound, self.max_seq)
        return None

    def _forward(self, kv, read_bound, tokens, positions, lengths, lp=None,
                 rows=None):
        logits, _ = forward(self.params, self.cfg, tokens, positions, kv,
                            lengths, read_bound=read_bound,
                            logit_positions=lp,
                            precision=self.matmul_precision, rows=rows)
        return logits

    def _step_logits(self, b: int, t: int, read_bound, gather: bool,
                     kv: dict, parts: tuple, copy: bool) -> torch.Tensor:
        """The logits of one step on ``kv`` over its whole grid: eagerly, or
        by replaying the graph of its key (``copy``: the caller's own copy
        of the graph's output, else the output buffer itself)."""
        cache = self._graphed(kv)
        if cache is None:
            with span("runner.inputs"):
                inputs = [self._tensor(p) for p in parts]
            with span("runner.forward"):
                return self._forward(kv, read_bound, *inputs)
        g = self._step_graph(b, t, read_bound, gather, kv, cache)
        with span("runner.inputs"):
            if any(torch.is_tensor(p) and p.device.type != "cpu"
                   for p in parts):
                g.inputs.copy_(torch.cat([self._tensor(p).reshape(-1)
                                          for p in parts]))
            else:  # one copy from the host
                g.inputs.copy_(torch.from_numpy(np.concatenate(
                    [np.asarray(p, np.int32).reshape(-1) for p in parts])))
        with span("runner.replay"):
            self._replay(g)
        return g.out.clone() if copy else g.out

    def _packed_graph(self, key: tuple, m: int, t: int, n: int,
                      run) -> _Graph:
        """The graph of ``key``, captured at its first use: ``run(buf)``
        is the step on a packed int32 buffer of ``n`` values whose
        [m * t, 2 * m * t) part is the positions; the warm-up's buffer is
        all padding (every position the drop slot, every other value 0)."""
        g = self._graphs.get(key)
        if g is not None:
            return g
        dummy = torch.zeros(n, dtype=torch.int32, device=self.device)
        dummy[m * t: 2 * m * t] = self.max_seq  # every write dropped
        inputs = dummy.clone()
        with span("runner.capture"):
            g = self._graphs[key] = self._capture(
                key, lambda: run(dummy), lambda: run(inputs), inputs)
        return g

    def _step_graph(self, b: int, t: int, read_bound, gather: bool,
                    kv: dict, cache: tuple) -> _Graph:
        def unpack(buf):
            lp = buf[2 * b * t + b:].view(b) if gather else None
            return (buf[:b * t].view(b, t), buf[b * t: 2 * b * t].view(b, t),
                    buf[2 * b * t: 2 * b * t + b].view(b), lp)

        return self._packed_graph(
            self._graph_key((b, t, read_bound, gather), cache), b, t,
            2 * b * t + b + (b if gather else 0),
            lambda buf: self._forward(kv, read_bound, *unpack(buf)))

    @staticmethod
    def _unpack_rows(buf: torch.Tensor, g: int, t: int) -> tuple:
        """A prefill launch's packed inputs: tokens and positions [G, T],
        lengths, logit positions and the row map [G]."""
        n = g * t
        return (buf[:n].view(g, t), buf[n: 2 * n].view(g, t),
                buf[2 * n: 2 * n + g], buf[2 * n + g: 2 * n + 2 * g],
                buf[2 * n + 2 * g: 2 * n + 3 * g])

    def _rows_graph(self, b: int, t: int, bound, kv: dict,
                    cache: tuple) -> _Graph:
        """The prefill launch's graph of a (b, t) step's plan at read bound
        ``bound``: G = launch_rows(t) rows of ``kv`` by its row map."""
        g = launch_rows(t)
        return self._packed_graph(
            self._graph_key((b, t, bound, "rows"), cache), g, t,
            2 * g * t + 3 * g,
            lambda buf: self._forward(kv, bound,
                                      *self._unpack_rows(buf, g, t)))

    def _row_mapped(self, kv: dict) -> bool:
        """Whether the row map covers every layer of ``kv``: the plain or
        MLA cache (PLAN_FORMATS, no SWA ring), and recurrent state only of
        the kinds it gathers and writes back (ROW_MAPPED_KINDS: LFM2's short
        conv)."""
        return ("k_swa" not in kv and "deltanet" not in kv
                and self.kv_format in PLAN_FORMATS
                and ("mamba" not in kv or all(
                    k in ROW_MAPPED_KINDS for k in self.cfg.layer_kinds)))

    def _plan_rows(self, b: int, t: int, gather: bool, kv: dict) -> int:
        """G when a step of key (b, t, gathered logits) on ``kv`` runs as a
        launch plan, else 0 (one launch over the whole grid). From the key
        and the cache's kinds alone: gathered logits, G < b, a cache the
        row map covers, one device."""
        if not gather or self.mesh is not None or not self._row_mapped(kv):
            return 0
        g = launch_rows(t)
        return g if g < b else 0

    def _planned_logits(self, b: int, t: int, g: int, read_bound,
                        kv: dict, parts: tuple, host_rows) -> torch.Tensor:
        """The logits [b, 1, V] of a step run as its launch plan (``step``),
        the caller's own, the picked rows' set (a row no launch ran holds
        zeros); records the launches that ran in ``last_launch``.

        Each launch's rows are copied out of its graph's output before the
        next launch replays: the graphs share one memory pool, in which a
        graph captured before another may keep its scratch where the other
        keeps its output."""
        tokens, positions, lengths, lp = (
            np.asarray(p.cpu() if torch.is_tensor(p) else p, np.int32)
            for p in parts)
        drop = self.max_seq
        live = (positions >= 0) & (positions < drop)
        # a chunk row: a live column past the first, or its logits at one
        chunk = live[:, 1:].any(1) | (live[:, 0] & (lp != 0))
        pre = np.flatnonzero(chunk)
        picked = range(b) if host_rows is None else host_rows
        decode = bool(live[~chunk, 0].any()) or \
            not all(chunk[r] for r in picked)
        bound = read_bound[1] if isinstance(read_bound, tuple) \
            else read_bound
        packed = [np.where(chunk, 0, tokens[:, 0]),
                  np.where(chunk, drop, positions[:, 0]),
                  np.where(chunk, 0, lengths)]
        launches = []  # (offset in the packed inputs, real rows)
        off = 3 * b
        for i in range(0, len(pre), g):
            rows = pre[i: i + g]
            sel = np.concatenate([rows, np.full(g - len(rows), rows[0])])
            tk, ps, ln, lq = tokens[sel], positions[sel], lengths[sel], \
                lp[sel]
            n = len(rows)  # spare places: all padding, writes dropped
            tk[n:], ps[n:], ln[n:], lq[n:] = 0, drop, 0, 0
            packed += [tk.reshape(-1), ps.reshape(-1), ln, lq, sel]
            launches.append((off, n))
            off += 2 * g * t + 3 * g
        cache = self._graphed(kv)
        if cache is not None:  # the whole plan, at the key's first use
            dg = self._step_graph(b, 1, read_bound, False, kv, cache)
            pg = self._rows_graph(b, t, bound, kv, cache)
        with span("runner.inputs"):
            buf = torch.from_numpy(np.concatenate(packed).astype(
                np.int32)).to(self.device)
        m = 2 * g * t + 3 * g
        with span("runner.replay" if cache is not None else
                  "runner.forward"):
            out = None
            if decode and cache is not None:
                dg.inputs.copy_(buf[:3 * b])
                self._replay(dg)
                out = dg.out.clone()
            elif decode:
                out = self._forward(kv, read_bound, buf[:b].view(b, 1),
                                    buf[b: 2 * b].view(b, 1),
                                    buf[2 * b: 3 * b])
            for o, n in launches:
                if cache is not None:
                    pg.inputs.copy_(buf[o: o + m])
                    self._replay(pg)
                    res, rows = pg.out, pg.inputs[m - g: m]
                else:
                    inputs = self._unpack_rows(buf[o: o + m], g, t)
                    res, rows = self._forward(kv, bound, *inputs), inputs[4]
                if out is None:
                    out = res.new_zeros((b, *res.shape[1:]))
                out.index_copy_(0, rows[:n].long(), res[:n])
        self._launched.value = {
            "prefill_launches": len(launches),
            "rows_launched": len(launches) * g * t + (b if decode else 0),
            "state_rows": sum(n for _, n in launches) if "mamba" in kv
            else 0}
        return out

    # -- steps ---------------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int32).to(self.device)

    @property
    def last_launch(self) -> dict | None:
        """What this thread's last ``step`` on this runner launched:
        ``prefill_launches``, ``rows_launched`` (token rows, padding
        included) and ``state_rows`` (the chunk rows whose recurrent state
        a plan's prefill launches carried by the row map; 0 without
        recurrent state or a plan); None before its first."""
        return getattr(self._launched, "value", None)

    @torch.no_grad()
    def step(self, tokens, positions, lengths, kv: dict,
             read_bound=None, logit_positions=None, host_rows=None):
        """Run one step. tokens/positions [B, T], lengths [B] (int arrays or
        tensors). ``read_bound``: cap on KV positions attention reads (all
        valid positions must be < read_bound); use read_bucket() to pick, or
        a ``(lo, hi, cap)`` tier from pick_read_bound. ``logit_positions``:
        optional [B] per-row T-index — the LM head runs on that single
        position per row and logits come back [B, 1, V]. Returns (logits,
        kv): the logits are the caller's own (a copy of a graph's output).
        ``host_rows``: a list of batch rows; the logits are then those rows'
        last column, copied to the host as one f32 [len(host_rows), V]
        array under the runner's lock (none copied for an empty list).

        A step with gathered logits whose grid is wider than one launch of
        ``LAUNCH_TOKENS`` rows (G = launch_rows(T) < B) runs as a launch
        plan, on a cache the row map covers (PLAN_FORMATS, no SWA ring,
        recurrent state only of LFM2's short conv, one device; a spare
        place writes no state): the chunk rows (a live column past
        the first, or logits at one) run G at a time through the prefill
        launch, a (G, T) forward over their cache rows by a row map at the
        read bound (a tier's hi), its spare places all padding; every other
        row rides the decode launch, the (B, 1) step at the same read
        bound from column 0, with the chunk rows' position the drop slot
        and length 0. The picked rows' logits are put together on the
        device. On CUDA the key's first step captures both launches'
        graphs, whatever its inputs. ``last_launch`` reads what ran."""
        b, t = np.shape(tokens)
        read_bound = self._norm_bound(read_bound)
        gather = logit_positions is not None and t > 1
        parts = (tokens, positions, lengths) + (
            (logit_positions,) if gather else ())
        with self._lock:
            g = self._plan_rows(b, t, gather, kv)
            if g:
                out = self._planned_logits(b, t, g, read_bound, kv, parts,
                                           host_rows)
            else:
                out = self._step_logits(b, t, read_bound, gather, kv, parts,
                                        copy=host_rows is None)
                self._launched.value = {"prefill_launches": int(t > 1),
                                        "rows_launched": b * t,
                                        "state_rows": 0}
            if host_rows is None:
                return out, kv
            with span("runner.fetch"):
                if not len(host_rows):
                    return np.zeros((0, out.shape[-1]), np.float32), kv
                return out[list(host_rows), -1].float().cpu().numpy(), kv

    @staticmethod
    def plan_segments(start: int, steps: int,
                      max_seq: int) -> list[tuple[int, int]]:
        """Chunk a ``steps``-token decode starting after position ``start``
        into (chunk_len, read_bound) segments that never cross a read-bucket
        boundary, so each runs with the smallest bound covering its
        positions. Chunk lengths are powers of two."""
        plan: list[tuple[int, int]] = []
        done = 0
        while done < steps:
            bound = read_bucket(start + done + 1, max_seq)
            cap = bound - (start + done)
            if cap <= 0:
                # past the cache end: positions >= max_seq are dropped
                cap = steps - done
            room = min(cap, steps - done)
            chunk = 1 << (room.bit_length() - 1)  # largest pow2 <= room
            plan.append((chunk, bound))
            done += chunk
        return plan

    def _decode_body(self, tok: torch.Tensor, pos: torch.Tensor, kv: dict,
                     read_bound, warm: bool = False) -> None:
        """One greedy decode step on tok/pos [B] in place: the argmax token
        replaces tok, and pos advances by one. ``warm``: a capture's
        warm-up, whose lengths are 0 so that every token is padding (a
        recurrent layer's state only freezes for positions >= lengths; the
        K/V writes go to the drop slot either way)."""
        logits = self._forward(kv, read_bound, tok[:, None], pos[:, None],
                               torch.zeros_like(pos) if warm else pos + 1)
        tok.copy_(torch.argmax(logits[:, 0, :], dim=-1))
        pos.add_(1)

    def _greedy_graph(self, b: int, read_bound, kv: dict,
                      cache: tuple) -> _Graph:
        key = self._graph_key(("greedy", b, read_bound), cache)
        g = self._graphs.get(key)
        if g is None:
            tok, pos = self._greedy_io[cache]
            dtok = torch.zeros_like(tok)
            dpos = torch.full_like(pos, self.max_seq)  # writes dropped
            g = self._graphs[key] = self._capture(
                key, lambda: self._decode_body(dtok, dpos, kv, read_bound,
                                               warm=True),
                lambda: self._decode_body(tok, pos, kv, read_bound))
        return g

    @torch.no_grad()
    def greedy_decode(self, tokens0, pos0, kv, steps: int):
        """Run ``steps`` greedy decode steps. tokens0/pos0: [B] (the last
        sampled token and its position per sequence; pos0 from the host).
        Returns (generated [B, steps] int32 tensor on the device, kv).

        Segments follow plan_segments; at B > 1 each segment's bound is
        pick_read_bound's at the segment-end lengths (a two-tier bound for
        a ragged batch). On CUDA with the runner's cache every step replays
        the graph of its (B, bound): the token and positions stay in device
        buffers the graph updates, and nothing is fetched; the caller
        fetches the tokens once."""
        with self._lock:
            return self._greedy_decode(tokens0, pos0, kv, steps)

    def _local_rows(self, b: int) -> slice:
        """The rows of a B-row batch this runner computes (all of them on
        one device)."""
        return slice(0, b)

    def _gather_rows(self, t: torch.Tensor, b: int) -> torch.Tensor:
        """Every row of a B-row result of which this runner computed
        ``_local_rows`` (on one device, ``t`` itself)."""
        return t

    def batch_of(self, kv: dict) -> int:
        """The rows of ``kv`` as its callers index them."""
        return KV.cache_shape(kv)[1]

    def _greedy_decode(self, tokens0, pos0, kv, steps: int):
        lens_all = np.asarray(pos0.cpu() if torch.is_tensor(pos0) else pos0,
                              np.int64).reshape(-1)
        b_all = lens_all.shape[0]
        rows = self._local_rows(b_all)
        lens0 = lens_all[rows]
        b = lens0.shape[0]
        cache = self._graphed(kv, steps)
        graphed = cache is not None
        if graphed:
            if cache not in self._greedy_io:
                self._greedy_io[cache] = (
                    torch.zeros(b, dtype=torch.int32, device=self.device),
                    torch.zeros(b, dtype=torch.int32, device=self.device))
            tok, pos = self._greedy_io[cache]
            tok.copy_(self._tensor(tokens0)[rows])
            pos.copy_(torch.from_numpy(lens0.astype(np.int32)))
        else:
            tok = self._tensor(tokens0)[rows].clone()
            pos = self._tensor(lens0)
        out = torch.empty((b, steps), dtype=torch.int32, device=self.device)
        done = 0
        for chunk, bound in self.plan_segments(int(lens_all.max()), steps,
                                               self.max_seq):
            if b_all > 1:
                # ragged batch: the bound of the segment-END lengths (each
                # row's context grows by ``chunk`` in the segment), over
                # every row, so that each data shard picks the same one
                bound = pick_read_bound(lens_all + done + chunk,
                                        self.max_seq,
                                        shards=self.tier_shards)
            bound = self._norm_bound(bound)
            g = self._greedy_graph(b, bound, kv, cache) if graphed else None
            for _ in range(chunk):
                if graphed:
                    self._replay(g)
                else:
                    self._decode_body(tok, pos, kv, bound)
                out[:, done].copy_(tok)
                done += 1
        return self._gather_rows(out, b_all), kv

    # -- single-sequence prefill + decode ------------------------------------

    def prefill(self, token_ids: list[int], kv: dict, batch_idx: int = 0,
                start_pos: int = 0, host: bool = False):
        """Prefill one sequence (padded to a bucket). Returns (last-token
        logits [V], kv, seq_len); ``host``: the logits as an f32 numpy
        array, copied under the runner's lock. ``start_pos`` > 0 continues
        from an existing KV prefix. With a ring cache, a prompt longer than
        the ring's safe length (``ring_chunk``) is prefilled in chunks of
        it, so no step's scatter wraps the ring."""
        chunk = self.ring_chunk
        if chunk and len(token_ids) > chunk:
            out = None
            for off in range(0, len(token_ids), chunk):
                out, kv, start_pos = self.prefill(
                    token_ids[off: off + chunk], kv, batch_idx, start_pos,
                    host)
            return out, kv, start_pos
        t = len(token_ids)
        bt = bucket_len(t)
        b = self.batch_of(kv)
        toks = np.zeros((b, bt), np.int32)
        toks[batch_idx, :t] = token_ids
        pos = np.full((b, bt), self.max_seq, np.int32)  # dropped
        pos[batch_idx, :t] = start_pos + np.arange(t)
        lengths = np.zeros((b,), np.int32)
        lengths[batch_idx] = start_pos + t
        logits, kv = self.step(
            toks, pos, lengths, kv,
            read_bound=read_bucket(start_pos + t, self.max_seq),
            logit_positions=np.full((b,), t - 1, np.int32),
            host_rows=[batch_idx] if host else None)
        if host:
            return logits[0], kv, start_pos + t
        return logits[batch_idx, logits.shape[1] - 1], kv, start_pos + t

    def decode_one(self, token_id: int, pos: int, kv: dict,
                   batch_idx: int = 0, host: bool = False):
        """Single-token decode for one sequence. Returns (logits [V], kv);
        ``host`` as in prefill."""
        b = self.batch_of(kv)
        toks = np.zeros((b, 1), np.int32)
        toks[batch_idx, 0] = token_id
        posa = np.full((b, 1), self.max_seq, np.int32)
        posa[batch_idx, 0] = pos
        lengths = np.zeros((b,), np.int32)
        lengths[batch_idx] = pos + 1
        logits, kv = self.step(toks, posa, lengths, kv,
                               read_bound=read_bucket(pos + 1, self.max_seq),
                               host_rows=[batch_idx] if host else None)
        return (logits[0] if host else logits[batch_idx, 0]), kv

    @torch.no_grad()
    def hidden_states(self, token_ids: list[int], owner: str) -> np.ndarray:
        """The final-norm hidden states [T, H] of one sequence, on the host
        (models/embeddings.py), eagerly, on ``owner``'s one-row cache, so no
        request's cache is touched. This follows the JAX package's
        ``extract_hidden_states``, not the forward: the embedding takes no
        learned position rows, and the Gemma family's final norm multiplies
        by (1 + w).

        The Mamba family is refused: the JAX function sends those layers
        through the attention block, which raises on a Mamba-1 model and
        skips Falcon-H1's mixer, so there are no reference values to
        follow (ROADMAP queue 3)."""
        cfg = self.cfg
        mamba = sorted(set(cfg.layer_kinds or ()) & set(MAMBA_KINDS))
        if mamba:
            raise NotImplementedError(
                f"embeddings of models with {'/'.join(mamba)} layers are "
                "not supported: the reference's extract_hidden_states runs "
                "no Mamba-family mixer, so it has no values to match "
                "(ROADMAP queue 3)")
        t = len(token_ids)
        gemma = cfg.arch_info.is_gemma if cfg.arch_info else False
        with self._lock:
            kv = self.init_kv(1, owner=owner)
            tokens = self._tensor([token_ids])
            positions = torch.arange(t, dtype=torch.int32,
                                     device=self.device)[None]
            lengths = self._tensor([t])
            x = embed(self.params, cfg, tokens)
            for i, layer in enumerate(self.params["layers"]):
                x, kv = layer_forward(layer, cfg, x, positions, kv, i,
                                      lengths,
                                      precision=self.matmul_precision)
            x = apply_norm(x, self.params["final_norm"], cfg.norm_eps,
                           cfg.uses_layer_norm, gemma)
            return x[0].float().cpu().numpy()


class MeshRunner(ModelRunner):
    """One rank's runner under a (data, model) mesh (parallel/sharding.py),
    one process per rank. ``params`` are this rank's shard; its caches hold
    its heads and, for a batch the data axis divides, its B/data rows. A
    step runs the rank's rows over the whole grid (no launch plan) and
    gathers the logits over the data axis, so every rank returns the whole
    batch; the tier of a ragged batch is picked over every row with
    ``shards`` = data and selected over the rank's own rows, which is the
    JAX package's tier grouped per data shard.

    Every rank must make the same calls in the same order, as the same
    tensors pass through each collective. Under ``parallel/service.serve_spmd``
    each process drives its own runner. Under ``Engine.load`` with a mesh,
    rank 0 drives and ``followers`` (parallel/service.Followers) carry each
    of its calls that reach the device (those made under ``_call``) to the
    other ranks, which make the same call (``parallel/service.follow``): an
    Engine, a
    BatchedEngine or the server then run over the mesh unchanged. A cache
    crosses as a handle: an owned cache by its key, one made by a direct
    ``_make_kv`` call by its number.

    Steps run eagerly under gloo (a CUDA graph cannot hold a gloo
    collective) and with expert-parallel layers (the count of a rank's
    routed slots reaches the host), counted in ``eager_steps``; under NCCL
    they replay graphs as on one device. The prompt cache is refused."""

    MADE_KEPT = 16  # caches made by _make_kv that a handle can still name

    def __init__(self, params: dict, cfg: ModelConfig, mesh, followers=None,
                 **kw):
        from ..parallel.sharding import expert_parallel, local_kv_heads

        super().__init__(params, cfg, **kw)
        self.mesh = mesh
        self.tier_shards = mesh.data
        self.cache_kv_heads = local_kv_heads(params, cfg)
        self.followers = followers
        self.graphs_ok = mesh.backend == "nccl" and not expert_parallel(
            params)
        self._depth = 0
        # steps run (a greedy decode's each count) and their host wall time
        self.steps, self.step_seconds = 0, 0.0
        self._made: dict[int, tuple[dict, int]] = {}  # handle -> (kv, rows)
        self._made_next = 0
        self._eager_logged = False
        log.info("mesh rank %d (data %d/%d, model %d/%d) on %s over %s; %s",
                 mesh.rank, mesh.data_axis.index, mesh.data,
                 mesh.model_axis.index, mesh.model, self.device, mesh.backend,
                 "steps replay CUDA graphs" if self.graphs_ok
                 else "steps run eagerly")

    # -- mirroring ------------------------------------------------------------

    @contextlib.contextmanager
    def _call(self, name: str, args: tuple, kw: dict):
        """Context of a call that reaches the device: rank 0 sends it to
        the followers first, once (not the calls it makes itself), under
        the lock."""
        with self._lock:
            if self.followers is not None and self._depth == 0:
                self.followers.send((name, self._encode(args),
                                     self._encode(kw)))
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1

    def _handle(self, kv: dict):
        """("own", key) or ("made", number) of one of this runner's caches,
        else None."""
        for key, own in self._kv.items():
            if own is kv:
                return ("own", key)
        for n, (made, _) in self._made.items():
            if made is kv:
                return ("made", n)
        return None

    def _encode(self, obj):
        if isinstance(obj, dict) and "k" in obj and "v" in obj:
            handle = self._handle(obj)
            if handle is None:
                raise ValueError("this cache is not one of the mesh "
                                 "runner's: make it with init_kv or _make_kv")
            return ("__kv__", handle)
        if torch.is_tensor(obj):
            return ("__tensor__", obj.detach().cpu().numpy())
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._encode(v) for v in obj)
        if isinstance(obj, dict):
            return {k: self._encode(v) for k, v in obj.items()}
        return obj

    def decode(self, obj):
        """A follower's arguments from rank 0's ``_encode``d ones."""
        if isinstance(obj, tuple) and len(obj) == 2 and \
                obj[0] in ("__kv__", "__tensor__"):
            if obj[0] == "__tensor__":
                return torch.from_numpy(obj[1])
            kind, key = obj[1]
            return self._kv[key] if kind == "own" else self._made[key][0]
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.decode(v) for v in obj)
        if isinstance(obj, dict):
            return {k: self.decode(v) for k, v in obj.items()}
        return obj

    # -- rows -----------------------------------------------------------------

    def _split_rows(self, b: int) -> bool:
        return self.mesh.data > 1 and b % self.mesh.data == 0

    def _local_rows(self, b: int) -> slice:
        if not self._split_rows(b):
            return slice(0, b)
        bl = b // self.mesh.data
        d = self.mesh.data_axis.index
        return slice(d * bl, (d + 1) * bl)

    def _gather_rows(self, t: torch.Tensor, b: int) -> torch.Tensor:
        if not self._split_rows(b):
            return t
        return self.mesh.data_axis.all_gather(t, dim=0)

    def batch_of(self, kv: dict) -> int:
        handle = self._handle(kv)
        if handle is None:
            return super().batch_of(kv)
        kind, key = handle
        return key[0] if kind == "own" else self._made[key][1]

    def _row_of(self, kv: dict, row: int | None) -> int | None | bool:
        """Batch row ``row`` of ``kv`` as this rank holds it: the same row,
        its local index, or False when another data shard holds it."""
        b = self.batch_of(kv)
        if row is None or not self._split_rows(b):
            return row
        rows = self._local_rows(b)
        return row - rows.start if rows.start <= row < rows.stop else False

    # -- graphs ---------------------------------------------------------------

    def _graphed(self, kv: dict, steps: int = 1):
        if self.device.type == "cuda" and not self.graphs_ok:
            if not self._eager_logged:
                self._eager_logged = True
                log.warning("mesh rank %d: steps run eagerly (%s)",
                            self.mesh.rank,
                            "a CUDA graph cannot hold a gloo collective"
                            if self.mesh.backend != "nccl" else
                            "expert-parallel slot counts reach the host")
            self.eager_steps += steps
            return None
        return super()._graphed(kv, steps)

    # -- the mirrored calls ---------------------------------------------------

    def _make_kv(self, batch: int) -> dict:
        with self._call("_make_kv", (batch,), {}):
            rows = self._local_rows(batch)
            cache = super()._make_kv(rows.stop - rows.start)
            if self._depth == 1:  # made for a caller: give it a handle
                self._made[self._made_next] = (cache, batch)
                self._made.pop(self._made_next - self.MADE_KEPT, None)
                self._made_next += 1
            return cache

    def init_kv(self, batch: int | None = None,
                owner: str | None = None) -> dict:
        with self._call("init_kv", (batch, owner), {}):
            return super().init_kv(batch, owner)

    def clear_state(self, kv: dict, row: int) -> None:
        with self._call("clear_state", (kv, row), {}):
            local = self._row_of(kv, row)
            if local is not False:
                super().clear_state(kv, local)

    def shift_left(self, kv: dict, n: int, batch_idx: int | None = None
                   ) -> None:
        with self._call("shift_left", (kv, n, batch_idx), {}):
            local = self._row_of(kv, batch_idx)
            if local is not False:
                super().shift_left(kv, n, local)

    def restore_prefix(self, cache, token_ids, kv, batch_idx=0) -> int:
        raise NotImplementedError(
            "the prompt cache is not supported under a mesh: each rank's "
            "cache holds its own heads and rows (ROADMAP queue 3)")

    store_prefix = restore_prefix

    def release_kv(self, owner: str) -> None:
        with self._call("release_kv", (owner,), {}):
            super().release_kv(owner)

    def reset_graphs(self) -> None:
        with self._call("reset_graphs", (), {}):
            super().reset_graphs()

    def step(self, tokens, positions, lengths, kv: dict, read_bound=None,
             logit_positions=None, host_rows=None):
        with self._call("step", (tokens, positions, lengths, kv),
                        dict(read_bound=read_bound,
                             logit_positions=logit_positions,
                             host_rows=host_rows)):
            t0 = time.perf_counter()
            out = super().step(tokens, positions, lengths, kv, read_bound,
                               logit_positions, host_rows)
            self.steps += 1
            self.step_seconds += time.perf_counter() - t0
            return out

    def _step_logits(self, b, t, read_bound, gather, kv, parts, copy):
        rows = self._local_rows(b)
        local = tuple(p[rows] for p in parts)
        out = super()._step_logits(rows.stop - rows.start, t, read_bound,
                                   gather, kv, local, copy)
        return self._gather_rows(out, b)

    def greedy_decode(self, tokens0, pos0, kv, steps: int):
        with self._call("greedy_decode", (tokens0, pos0, kv, steps), {}):
            t0 = time.perf_counter()
            out = super().greedy_decode(tokens0, pos0, kv, steps)
            self.steps += steps
            self.step_seconds += time.perf_counter() - t0
            return out

    def hidden_states(self, token_ids: list[int], owner: str) -> np.ndarray:
        with self._call("hidden_states", (token_ids, owner), {}):
            return super().hidden_states(token_ids, owner)

    def rank_stats(self) -> list[dict]:
        """Every rank's placement and counters, in rank order: device,
        backend, kernel launches (ops/qmatmul.launch_counts), eager steps,
        the steps and their host wall seconds (under gloo the host waits
        for each collective, so this is the steps' time), and the
        collectives' calls and host wall seconds per axis."""
        import torch.distributed as dist

        with self._call("rank_stats", (), {}):
            m = self.mesh
            launches, by_path = Q.launch_counts()
            mine = {"rank": m.rank, "device": str(self.device),
                    "backend": m.backend,
                    "data_index": m.data_axis.index,
                    "model_index": m.model_axis.index,
                    "launches": launches, "launches_by_path": by_path,
                    "eager_steps": self.eager_steps,
                    "steps": self.steps, "step_seconds": self.step_seconds,
                    "collectives": {a.name: {"calls": a.calls,
                                             "seconds": a.seconds}
                                    for a in (m.model_axis, m.data_axis)}}
            out: list = [None] * m.size
            dist.all_gather_object(out, mine, group=m.cpu_group)
            return out

    def reset_rank_stats(self) -> None:
        """Zero every rank's launch, step and collective counters."""
        with self._call("reset_rank_stats", (), {}):
            Q.reset_launches()
            self.steps, self.step_seconds, self.eager_steps = 0, 0.0, 0
            for a in (self.mesh.model_axis, self.mesh.data_axis):
                a.calls, a.seconds = 0, 0.0
