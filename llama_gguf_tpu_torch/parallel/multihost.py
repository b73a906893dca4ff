"""Cluster runtime: bring-up, mesh planning, fault detection, recovery and
load metrics (port of llama_gguf_tpu/parallel/multihost.py).

The JAX package joins one ``jax.distributed`` cluster; the port joins one
``torch.distributed`` process group (``initialize_cluster``), one process
per rank. Every rank loads its own shard from the GGUF
(parallel/sharding.py), so no weight travels between processes.

Placement and backend are chosen once, stated in the log, and never
switched on a failure (``placement``): rank r runs on ``cuda:(local_rank %
device_count)`` (or the CPU when the caller asks for it), over NCCL when the
ranks of this host sit on distinct cards, and over gloo when they share one
(NCCL refuses two ranks on one GPU) or run on the CPU.

Health is the device answering a tiny CUDA computation followed by a
synchronize (``HealthMonitor``); recovery re-initializes and reloads with
exponential backoff (``RecoveryManager``); ``StepMetrics`` and
``evaluate_imbalance`` report a rank whose rounds run slower than the
others (parallel/service.serve_spmd feeds them).
"""

from __future__ import annotations

import atexit
import enum
import logging
import os
import threading
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable

import torch

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# cluster bootstrap
# ---------------------------------------------------------------------------


@dataclass
class ClusterConfig:
    """Where the process group meets and this process's place in it (the
    JAX ClusterConfig's fields, plus the port's placement: ``device``
    "cuda" or "cpu", and ``local_world``, the ranks on this host, which
    default to every process)."""

    coordinator_address: str | None = None  # "host0:1234"
    num_processes: int | None = None
    process_id: int | None = None
    local_device_ids: list[int] | None = None
    # mesh axes; 0 = derive via auto_mesh
    data: int = 0
    model: int = 0
    device: str | None = None
    local_world: int | None = None

    @classmethod
    def from_env(cls) -> "ClusterConfig":
        return cls(
            coordinator_address=os.environ.get("LLAMA_GGUF_COORDINATOR"),
            num_processes=_int_env("LLAMA_GGUF_NUM_PROCESSES"),
            process_id=_int_env("LLAMA_GGUF_PROCESS_ID"),
        )


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def dist_timeout() -> timedelta:
    """How long a collective waits for a missing rank before it raises
    (``LLAMA_GGUF_DIST_TIMEOUT_S``, default 1800 s)."""
    return timedelta(seconds=float(
        os.environ.get("LLAMA_GGUF_DIST_TIMEOUT_S", "1800")))


def placement(rank: int, local_world: int, device: str | None = None
              ) -> tuple[torch.device, str]:
    """(device, backend) of ``rank`` among ``local_world`` ranks on this
    host. ``device`` "cpu" puts every rank on the CPU (gloo); else the rank
    takes card ``rank % device_count``, and NCCL carries the collectives
    when the host's ranks have a card each, gloo when they share one."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu"), "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but CUDA is not available; pass "
            "device='cpu' to run the ranks on the CPU")
    n = torch.cuda.device_count()
    dev = torch.device("cuda", (rank % local_world) % n)
    return dev, ("nccl" if local_world <= n else "gloo")


def initialize_cluster(cfg: ClusterConfig | None = None) -> dict:
    """Join the process group (``torch.distributed.init_process_group`` at
    ``tcp://coordinator_address``, or at the address itself when it is a
    URL such as ``file:///shared/store``) when a coordinator or a process
    count is given; a lone process joins nothing. The group it joins is
    left at the interpreter's exit, if its caller has not left it (a
    process that exits in a live gloo group aborts). Returns the topology,
    with this rank's device and backend."""
    import torch.distributed as dist

    cfg = cfg or ClusterConfig.from_env()
    world = cfg.num_processes or 1
    rank = cfg.process_id or 0
    local_world = cfg.local_world or world
    dev, backend = placement(rank, local_world, cfg.device)
    if (cfg.coordinator_address or cfg.num_processes) and \
            not dist.is_initialized():
        addr = cfg.coordinator_address or "127.0.0.1:29500"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=addr if "://" in addr else f"tcp://{addr}",
            world_size=world, rank=rank, timeout=dist_timeout())
        atexit.register(leave_group)
    info = {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": (dist.get_world_size() if dist.is_initialized()
                          else 1),
        "local_devices": (torch.cuda.device_count() if dev.type == "cuda"
                          else 1),
        "global_devices": world,
        "device": str(dev),
        "backend": backend,
    }
    log.info("cluster up: %s", info)
    return info


def leave_group() -> None:
    """Leave the process group, if this process is in one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def device_hbm_bytes(device=None) -> int:
    """A card's memory (``torch.cuda.get_device_properties``); 16 GiB when
    there is no card to ask, as the JAX function falls back."""
    if not torch.cuda.is_available():
        return 16 << 30
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", 0)
    if dev.type != "cuda":
        return 16 << 30
    return int(torch.cuda.get_device_properties(dev).total_memory)


def auto_mesh(model_bytes: int, kv_bytes: int = 0,
              n_devices: int | None = None,
              hbm_bytes: int | None = None,
              headroom: float = 0.85) -> tuple[int, int]:
    """Choose (data, model) axes: the smallest model-parallel degree whose
    per-device share of weights+KV fits in memory; the remaining devices
    become data-parallel replicas."""
    n = n_devices or max(torch.cuda.device_count(), 1)
    hbm = (hbm_bytes or device_hbm_bytes()) * headroom
    model_axis = 1
    while model_axis <= n:
        if n % model_axis == 0 and \
                (model_bytes + kv_bytes) / model_axis <= hbm:
            return (n // model_axis, model_axis)
        model_axis += 1
    raise RuntimeError(
        f"model ({(model_bytes + kv_bytes) / 1e9:.1f} GB) does not fit on "
        f"{n} devices x {hbm / 1e9:.1f} GB")


# ---------------------------------------------------------------------------
# health / fault detection
# ---------------------------------------------------------------------------


class HealthState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    FAILED = "failed"


@dataclass
class FaultConfig:
    health_check_interval: float = 10.0
    failure_threshold: int = 3       # consecutive failures -> FAILED
    degraded_threshold: int = 1      # consecutive failures -> DEGRADED
    probe_timeout: float = 30.0
    recovery_backoff: float = 2.0
    recovery_max_backoff: float = 60.0
    recovery_max_attempts: int = 5


def device_probe(device=None) -> bool:
    """A tiny computation on ``device`` (the current card, or the CPU where
    there is none), then a synchronize: the device answers."""
    try:
        dev = torch.device(device) if device is not None else (
            torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))
        out = torch.zeros(8, dtype=torch.float32, device=dev) + 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return bool(out[0].item() == 1.0)
    except Exception:
        return False


class HealthMonitor:
    """Background device-liveness monitor with a consecutive-failure state
    machine (Healthy -> Degraded -> Failed)."""

    def __init__(self, config: FaultConfig | None = None,
                 on_state_change: Callable[[HealthState], None] | None = None,
                 probe: Callable[[], bool] | None = None):
        self.config = config or FaultConfig()
        self.on_state_change = on_state_change
        self.state = HealthState.HEALTHY
        self.consecutive_failures = 0
        self.last_check: float = 0.0
        self.checks = 0
        self._probe = probe or device_probe
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def check_once(self) -> HealthState:
        self.checks += 1
        self.last_check = time.monotonic()
        ok = False
        try:
            ok = self._probe()
        except Exception:
            ok = False
        if ok:
            self.consecutive_failures = 0
            self._transition(HealthState.HEALTHY)
        else:
            self.consecutive_failures += 1
            if self.consecutive_failures >= self.config.failure_threshold:
                self._transition(HealthState.FAILED)
            elif self.consecutive_failures >= self.config.degraded_threshold:
                self._transition(HealthState.DEGRADED)
        return self.state

    def _transition(self, new: HealthState) -> None:
        if new is not self.state:
            log.warning("health: %s -> %s", self.state.value, new.value)
            self.state = new
            if self.on_state_change:
                self.on_state_change(new)

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.config.health_check_interval):
                self.check_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="health-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None


class RecoveryManager:
    """Exponential-backoff recovery: re-initialize the runtime and reload
    the rank's shard from its local GGUF."""

    def __init__(self, reload_fn: Callable[[], Any],
                 config: FaultConfig | None = None,
                 reinit_fn: Callable[[], Any] | None = None):
        self.reload_fn = reload_fn
        self.reinit_fn = reinit_fn
        self.config = config or FaultConfig()
        self.attempts = 0
        self.recoveries = 0

    def recover(self) -> bool:
        backoff = self.config.recovery_backoff
        for attempt in range(1, self.config.recovery_max_attempts + 1):
            self.attempts += 1
            try:
                if self.reinit_fn is not None:
                    self.reinit_fn()
                self.reload_fn()
                self.recoveries += 1
                log.info("recovery succeeded on attempt %d", attempt)
                return True
            except Exception as e:
                log.warning("recovery attempt %d failed: %s", attempt, e)
                time.sleep(min(backoff, self.config.recovery_max_backoff))
                backoff *= 2
        return False


# ---------------------------------------------------------------------------
# load metrics
# ---------------------------------------------------------------------------


@dataclass
class StepMetrics:
    """EWMA step latency per rank; detects imbalance across ranks."""

    alpha: float = 0.2
    ewma_s: float = 0.0
    count: int = 0
    total_s: float = 0.0

    def record(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.ewma_s = (seconds if self.count == 1
                       else self.alpha * seconds
                       + (1 - self.alpha) * self.ewma_s)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


@dataclass
class ImbalanceReport:
    imbalanced: bool
    max_ewma: float
    min_ewma: float
    ratio: float


def evaluate_imbalance(metrics: dict[str, StepMetrics],
                       threshold: float = 1.5) -> ImbalanceReport:
    """Cross-rank imbalance check: a slow rank drags every collective, so
    the fix is operational (replace the host), not a reassignment."""
    vals = [m.ewma_s for m in metrics.values() if m.count]
    if len(vals) < 2:
        return ImbalanceReport(False, vals[0] if vals else 0.0,
                               vals[0] if vals else 0.0, 1.0)
    hi, lo = max(vals), min(vals)
    ratio = hi / lo if lo > 0 else float("inf")
    return ImbalanceReport(ratio > threshold, hi, lo, ratio)
