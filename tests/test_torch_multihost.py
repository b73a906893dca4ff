"""The port's cluster runtime (parallel/multihost.py) and SPMD serving
(parallel/service.py) against the JAX package's on the CPU: the
ClusterConfig from the environment, auto_mesh, the health state machine
and its device probe, the recovery backoff, StepMetrics and the imbalance
check, encode_request, the ``cluster`` JSON, and the ``shard`` CLI as two
processes over gloo, with the degraded-host imbalance of a rank slowed by
LLAMA_GGUF_STEP_SLOWDOWN_S. The process groups meet through a file store
in the test's directory."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fixtures import make_tiny_model
from llama_gguf_tpu import cli as jcli
from llama_gguf_tpu.parallel import multihost as J
from llama_gguf_tpu.parallel import service as jservice

from llama_gguf_tpu_torch import cli
from llama_gguf_tpu_torch.parallel import multihost as P
from llama_gguf_tpu_torch.parallel import service as pservice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB = 1 << 30


def test_initialize_single_host():
    """A lone process joins no group, as in the JAX package."""
    info = P.initialize_cluster(P.ClusterConfig(device="cpu"))
    want = J.initialize_cluster(J.ClusterConfig())
    assert info["process_count"] == want["process_count"] == 1
    assert info["process_index"] == want["process_index"] == 0
    assert set(want) <= set(info)
    assert (info["device"], info["backend"]) == ("cpu", "gloo")


def test_cluster_config_from_env(monkeypatch):
    monkeypatch.setenv("LLAMA_GGUF_COORDINATOR", "h0:1234")
    monkeypatch.setenv("LLAMA_GGUF_NUM_PROCESSES", "4")
    monkeypatch.setenv("LLAMA_GGUF_PROCESS_ID", "2")
    got, want = P.ClusterConfig.from_env(), J.ClusterConfig.from_env()
    for key in ("coordinator_address", "num_processes", "process_id",
                "local_device_ids", "data", "model"):
        assert getattr(got, key) == getattr(want, key)
    assert (got.coordinator_address, got.num_processes, got.process_id) == \
        ("h0:1234", 4, 2)


@pytest.mark.parametrize("model,kv,n,hbm", [
    (int(4.5 * GB), 0, 8, 16 * GB),    # fits one device: pure DP
    (60 * GB, 0, 8, 16 * GB),          # model axis >= 5 -> 8
    (10 * GB, 30 * GB, 8, 16 * GB),    # KV counts toward the budget
    (70 * GB, 0, 1, 80 * GB),          # one H100: too large at 0.85
    (40 * GB, 0, 4, 80 * GB),
    (200 * GB, 10 * GB, 4, 80 * GB),
])
def test_auto_mesh_matches_jax(model, kv, n, hbm):
    def plan(fn):
        try:
            return fn(model, kv, n_devices=n, hbm_bytes=hbm)
        except RuntimeError as e:
            return str(e)

    assert plan(P.auto_mesh) == plan(J.auto_mesh)


def test_device_hbm_bytes_without_a_card():
    """No card to ask: the JAX fallback's 16 GiB."""
    assert P.device_hbm_bytes() == 16 << 30


@pytest.mark.parametrize("probes", [
    [True, False, False, False, True],
    [False, True, False, False, False, False, True, True],
    [True] * 3,
])
def test_health_state_machine_matches_jax(probes):
    def run(mod):
        results = iter(probes)
        changes = []
        mon = mod.HealthMonitor(
            mod.FaultConfig(failure_threshold=3, degraded_threshold=1),
            on_state_change=lambda s: changes.append(s.value),
            probe=lambda: next(results))
        states = [mon.check_once().value for _ in probes]
        return states, changes, mon.consecutive_failures, mon.checks

    assert run(P) == run(J)


def test_health_device_probe_and_loop():
    """The default probe is a tiny computation and a synchronize on the
    device (the CPU here); the background loop checks repeatedly."""
    import time

    assert P.device_probe()
    assert P.HealthMonitor().check_once() is P.HealthState.HEALTHY
    mon = P.HealthMonitor(P.FaultConfig(health_check_interval=0.05),
                          probe=lambda: True)
    mon.start()
    time.sleep(0.3)
    mon.stop()
    assert mon.checks >= 2
    bad = P.HealthMonitor(probe=lambda: 1 / 0)  # a probe that raises fails
    assert bad.check_once() is P.HealthState.DEGRADED


@pytest.mark.parametrize("fails,attempts", [(2, 5), (9, 3), (0, 1)])
def test_recovery_backoff_matches_jax(monkeypatch, fails, attempts):
    def run(mod):
        sleeps, calls = [], []
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)

        def reload():
            calls.append(1)
            if len(calls) <= fails:
                raise RuntimeError("still down")

        rm = mod.RecoveryManager(reload, mod.FaultConfig(
            recovery_backoff=0.5, recovery_max_backoff=1.5,
            recovery_max_attempts=attempts))
        return rm.recover(), rm.attempts, rm.recoveries, sleeps, len(calls)

    assert run(P) == run(J)


def test_step_metrics_and_imbalance_match_jax():
    rng = np.random.default_rng(0)
    times = rng.uniform(0.005, 0.05, size=(3, 12))
    for threshold in (1.2, 1.5, 3.0):
        out = []
        for mod in (P, J):
            ms = {f"h{i}": mod.StepMetrics() for i in range(3)}
            for i, row in enumerate(times):
                for s in row:
                    ms[f"h{i}"].record(float(s))
            rep = mod.evaluate_imbalance(ms, threshold=threshold)
            out.append(([(m.count, m.ewma_s, m.mean_s) for m in ms.values()],
                        (rep.imbalanced, rep.max_ewma, rep.min_ewma,
                         rep.ratio)))
        assert out[0] == out[1]
    for mod in (P, J):
        one = mod.evaluate_imbalance({"h0": mod.StepMetrics()})
        assert not one.imbalanced and one.ratio == 1.0


def test_encode_request_matches_jax():
    for args in ((1, [5, 6, 7], 9, 16), (0, [], 0, 4), (1, [1], 1, 1)):
        np.testing.assert_array_equal(pservice.encode_request(*args),
                                      jservice.encode_request(*args))
    assert (pservice.OP_STOP, pservice.OP_GENERATE) == \
        (jservice.OP_STOP, jservice.OP_GENERATE)


def test_cluster_json_matches_jax(tmp_path, capsys):
    """The ``cluster`` JSON has the JAX keys; the auto-mesh plan is the
    one for this host's devices (the JAX package sees its virtual CPU
    devices here, the port one device)."""
    toml = tmp_path / "c.toml"
    toml.write_text('[cluster]\ncoordinator_address = "h0:99"\n'
                    "num_processes = 2\n")
    for argv in (["cluster"], ["cluster", "--cluster-config", str(toml),
                               "--model-bytes", str(GB)]):
        assert cli.main(argv) == 0
        got = json.loads(capsys.readouterr().out)
        assert jcli.main(argv) == 0
        want = json.loads(capsys.readouterr().out)
        assert set(want) <= set(got)
        for key in ("coordinator", "num_processes"):
            assert got[key] == want[key]
        assert got["platform"] == "cpu" and got["local_devices"] == 1
        if "auto_mesh" in want:
            assert got["auto_mesh"] == {"data": 1, "model": 1}


def _two_ranks(tmp_path, argv_of, env_of=lambda pid: {}) -> list[str]:
    """Run ranks 0 and 1 (``argv_of(pid, store)``, one thread each) to
    their end; their outputs. Each must exit 0."""
    store = (tmp_path / "store").as_uri()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        argv_of(pid, store), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env={**env, **env_of(pid)},
        cwd=REPO) for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def shard_model(tmp_path_factory):
    model = str(tmp_path_factory.mktemp("shard") / "tiny.gguf")
    make_tiny_model(model, arch="qwen2", vocab=260, hidden=64, layers=2,
                    heads=8, kv_heads=8, ffn=128, ctx=128, tokenizer=True)
    return model


def test_shard_cli_two_process(tmp_path, shard_model):
    """``shard`` as two processes: they join one group, each loads its
    half of the model (tp=2), and rank 0 serves the prompt through the
    lock-step loop; its text equals the JAX engine's greedy run on one
    device."""
    outs = _two_ranks(tmp_path, lambda pid, store: [
        sys.executable, "-m", "llama_gguf_tpu_torch", "shard", shard_model,
        "--coordinator", store, "--num-processes", "2", "--process-id",
        str(pid), "--device", "cpu", "--tp", "2", "--prompt", "hello world",
        "-n", "6"])
    for out in outs:
        assert "served 1 request(s)" in out
    from llama_gguf_tpu.engine.engine import Engine as JEngine

    jeng = JEngine.load(shard_model)
    ids = jeng.tokenizer.encode("hello world")
    want = jeng.tokenizer.decode(jeng.greedy_tokens(ids, 6))
    assert want and f"\n{want}\n" in outs[0]


SLOW_WORKER = r"""
import logging, sys
logging.basicConfig(level=logging.WARNING)
from llama_gguf_tpu_torch.parallel.multihost import (ClusterConfig,
                                                     initialize_cluster)
from llama_gguf_tpu_torch.parallel.service import serve_spmd
from llama_gguf_tpu_torch.engine.engine import Engine, EngineConfig
store, pid, model = sys.argv[1], int(sys.argv[2]), sys.argv[3]
initialize_cluster(ClusterConfig(coordinator_address=store, num_processes=2,
                                 process_id=pid, device="cpu"))
eng = Engine.load(model, EngineConfig(weight_mode="dequant", mesh_model=2,
                                      max_context_len=128), device="cpu")
reqs = [([1, 2, 3], 3)] * 3 if pid == 0 else []
metrics = {}
outs = serve_spmd(eng.runner, eng.tokenizer, reqs, step_metrics=metrics)
if pid == 0:
    print("leader metrics:", {k: round(m.ewma_s, 3)
                              for k, m in metrics.items()})
print(f"proc {pid} done rounds={len(outs)}")
"""


def test_degraded_host_imbalance_detected(tmp_path, shard_model):
    """Rank 1 is slowed by 1 s a round (LLAMA_GGUF_STEP_SLOWDOWN_S): the
    rounds' times gathered from both ranks make rank 0's monitor log the
    imbalance from rounds 2-3 (the first round is left out)."""
    script = tmp_path / "slow_worker.py"
    script.write_text(SLOW_WORKER)
    outs = _two_ranks(
        tmp_path,
        lambda pid, store: [sys.executable, str(script), store, str(pid),
                            shard_model],
        lambda pid: {"LLAMA_GGUF_STEP_SLOWDOWN_S": "1.0"} if pid else {})
    for pid, out in enumerate(outs):
        assert f"proc {pid} done rounds=3" in out
    assert "host imbalance detected" in outs[0], outs[0][-3000:]
    assert "leader metrics:" in outs[0]
