"""PyTorch port: the serving service's lifecycle on the CPU (``serve/server.py``).

Pinned on tiny_cnn, 64 synthetic examples, batch 16, port 0:

* admission control: 429 + Retry-After past ``serve.max_queue`` while the
  dispatcher is wedged, every admitted request completing after it;
* SIGTERM through ``wait_until_preempted``: the in-flight request completes
  bitwise, a new one gets 503, ``Preempted`` is raised;
* the serve SLOs trip, ``/healthz`` degrades and ``run_monitor --once`` exits 1;
* refresh: 200 installs a checkpoint step and clears the cached scores; a
  corrupt or missing step gives 409 with the old variables still serving;
  the refresh watcher installs a newer step;
* the serve fault classes fire at their sites (the wedged dispatcher turns
  /healthz critical, the partition drops connections, the slow replica
  delays; ``kill_replica_after_requests`` SIGKILLs a ``cli serve`` subprocess);
* every record of every stream passes ``tools/validate_metrics.py``.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data.datasets import load_dataset
from data_diet_distributed_tpu_torch.models import create_model_from_cfg
from data_diet_distributed_tpu_torch.obs.metrics import MetricsLogger
from data_diet_distributed_tpu_torch.obs.session import ObsSession
from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
from data_diet_distributed_tpu_torch.resilience import inject
from data_diet_distributed_tpu_torch.resilience.preemption import Preempted
from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
from data_diet_distributed_tpu_torch.serve.server import ServeService
from data_diet_distributed_tpu_torch.train.state import state_from_variables
from data_diet_distributed_tpu_torch.weights import init_variables
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
N, B = 64, 16


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sc = _load_tool("serve_client")
vm = _load_tool("validate_metrics")


def _cfg(tmp, *extra):
    return load_config(None, [
        "data.dataset=synthetic", f"data.synthetic_size={N}", "model.arch=tiny_cnn",
        "train.half_precision=false", f"train.checkpoint_dir={tmp}/ckpt",
        "score.pretrain_epochs=0", f"score.batch_size={B}", "serve.port=0",
        "serve.coalesce_ms=2", "serve.tenant=tiny",
        f"obs.metrics_path={tmp}/metrics.jsonl", f"obs.heartbeat_dir={tmp}/hb", *extra])


class Served:
    """A started in-process service on the init variables of seed 0."""

    def __init__(self, tmp, *extra):
        self.cfg = _cfg(tmp, *extra)
        self.ds, _ = load_dataset("synthetic", synthetic_size=N, seed=0)
        self.logger = MetricsLogger(self.cfg.obs.metrics_path, echo=False)
        self.engine = ServeEngine(self.cfg, device="cpu", logger=self.logger)
        self.variables = init_variables("tiny_cnn", 0, "cpu")
        self.engine.register_tenant("tiny", self.ds, [self.variables])
        self.service = ServeService(self.engine, self.cfg, logger=self.logger)
        assert self.service.start()
        self.client = sc.ServeClient(f"http://127.0.0.1:{self.service.port}",
                                     timeout_s=60.0)

    def offline(self, method="el2n", variables=None):
        return score_dataset(create_model_from_cfg(self.cfg), [variables or self.variables],
                             self.ds, method=method, batch_size=B, device="cpu")

    def records(self):
        with open(self.cfg.obs.metrics_path) as fh:
            lines = fh.read().splitlines()
        assert vm.validate_lines(lines, where="stream") == []
        return [json.loads(line) for line in lines if line.strip()]

    def close(self):
        self.service.stop()
        self.logger.close()


@pytest.fixture
def served(tmp_path, request):
    s = Served(tmp_path, *getattr(request, "param", ()))
    yield s
    s.close()
    inject.deactivate()


@pytest.mark.parametrize("served", [("serve.max_queue=2", "serve.retry_after_s=2")],
                         indirect=True)
def test_backpressure_429_with_retry_after(served):
    served.client.score(indices=[0, 1])   # the first call at the geometry is done
    results = []

    def one(i):
        try:
            results.append(("ok", served.client.score(indices=[i])))
        except sc.ServeError as err:
            results.append((err.status, err))

    with served.engine._lock:   # wedge the dispatcher mid-dispatch
        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and sum(s == 429 for s, _ in results) < 2:
            time.sleep(0.05)
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    codes = [s for s, _ in results]
    assert codes.count("ok") + codes.count(429) == 8, codes
    assert codes.count(429) >= 2 and codes.count("ok") >= 2, codes
    assert next(e for s, e in results if s == 429).retry_after_s == 2.0
    offline = served.offline()
    for s, resp in results:
        if s == "ok":
            assert np.array_equal(np.asarray(resp["scores"], np.float32),
                                  offline[resp["indices"]])
    recs = served.records()
    assert sum(r["kind"] == "serve_admission" and r["action"] == "reject"
               for r in recs) == codes.count(429)
    stats = served.service.stats_record()
    assert stats["rejected"] == codes.count(429)
    assert stats["requests"] == 1 + codes.count("ok")


@pytest.mark.parametrize("served", [("serve.coalesce_ms=400", "serve.drain_timeout_s=10")],
                         indirect=True)
def test_sigterm_drains_inflight_and_preempts(served):
    served.client.score(indices=[0])
    inflight = {}
    t = threading.Thread(target=lambda: inflight.update(
        resp=served.client.score(indices=[5, 6, 7])))

    def killer():
        t.start()
        time.sleep(0.1)   # the request sits inside the 400 ms window
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=killer, daemon=True).start()
    with pytest.raises(Preempted):
        served.service.wait_until_preempted()
    t.join(30)
    assert np.array_equal(np.asarray(inflight["resp"]["scores"], np.float32),
                          served.offline()[[5, 6, 7]])
    with pytest.raises(sc.ServeError) as err:
        served.client.score(indices=[1])
    assert err.value.status == 503
    recs = served.records()
    pre = next(r for r in recs if r["kind"] == "preempted")
    assert pre["signal"] == "SIGTERM" and pre["drained"] is True
    assert any(r["kind"] == "serve_admission" and r["action"] == "drain" for r in recs)


@pytest.mark.parametrize("served", [("obs.slo_serve_p95_ms=0.001",
                                     "obs.slo_serve_reject_frac=0.01")], indirect=True)
def test_serve_slo_trips_and_healthz_degrades(served):
    with ObsSession(served.cfg, logger=served.logger) as obs:
        assert obs.slo is not None and obs.heartbeat is not None
        served.client.score(indices=[0, 1, 2])
        assert served.service.emit_stats()["p95_ms"] > 0.001
        rm = _load_tool("run_monitor")
        assert rm.main(["--port", str(served.service.port), "--once", "--json"]) == 1
        health = served.client.healthz()
        assert health["status"] == "degraded" and health["slo"]["violations"] >= 1
        assert "serve_p95" in " ".join(health["reasons"])
    viol = [r for r in served.records() if r["kind"] == "slo_violation"]
    assert {r["slo"] for r in viol} == {"serve_p95"}
    assert viol[0]["dominant_phase"] in ("queue_wait", "coalesce_wait", "dispatch", "fetch",
                                         "serialize")


def _save_steps(cfg, steps_seeds):
    mngr = CheckpointManager(cfg.train.checkpoint_dir)
    model = create_model_from_cfg(cfg)
    for step, seed in steps_seeds:
        mngr.save(step, state_from_variables(init_variables("tiny_cnn", seed, "cpu"), model))
    return mngr


def test_refresh_installs_and_rejects_corrupt_steps(served):
    mngr = _save_steps(served.cfg, [(1, 0), (2, 5)])
    before = list(served.client.topk(k=5))
    assert served.engine.tenant("tiny").scores
    resp = served.client.refresh(step=2)
    assert resp["status"] == "installed" and resp["step"] == 2
    assert served.engine.tenant("tiny").scores == {}   # the old model's, cleared
    new = mngr.restore_variables(2, "cpu")
    offline = served.offline("grand", new)
    got = served.client.score(indices=[3, 4, 40], method="grand")
    assert np.array_equal(np.asarray(got["scores"], np.float32), offline[[3, 4, 40]])
    order = np.lexsort((served.ds.indices, -served.offline("el2n", new)))[:5]
    after = list(served.client.topk(k=5))
    assert [i for i, _ in after] == order.tolist() and after != before
    # A truncated step and a missing one: 409, the step-2 model still serving.
    _save_steps(served.cfg, [(3, 7)])
    inject.truncate_checkpoint(served.cfg.train.checkpoint_dir, 3)
    for step in (3, 9):
        with pytest.raises(sc.ServeError) as err:
            served.client.refresh(step=step)
        assert err.value.status == 409 and err.value.payload["status"] == "rejected"
    again = served.client.score(indices=[3, 4, 40], method="grand")
    assert again["scores"] == got["scores"]
    assert served.service.model_steps == {"tiny": 2}
    refreshes = [r for r in served.records() if r["kind"] == "model_refresh"]
    assert [(r["status"], r["step"]) for r in refreshes] == [
        ("installed", 2), ("rejected", 3), ("rejected", 9)]


@pytest.mark.parametrize("served", [("serve.refresh_poll_s=0.1",)], indirect=True)
def test_refresh_watcher_installs_a_newer_step(served):
    served.service.start_refresh_watch()
    for step, seed in ((1, 0), (4, 3)):
        _save_steps(served.cfg, [(step, seed)])
        deadline = time.monotonic() + 20
        while (served.service.model_steps.get("tiny") != step
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert served.service.model_steps.get("tiny") == step


@pytest.mark.parametrize("served", [("serve.dispatch_stall_s=0.3",)], indirect=True)
def test_wedged_dispatcher_turns_healthz_critical(served):
    served.client.score(indices=[0])
    inject.activate(inject.FaultPlan(wedge_dispatcher_after=2, hang_seconds=2.0))
    out = {}
    t = threading.Thread(target=lambda: out.update(resp=served.client.score(indices=[8, 9])))
    t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        health = served.client.healthz()   # a 503 (critical) carries its body
        if health["status"] == "critical":
            break
        time.sleep(0.05)
    assert health["status"] == "critical"
    assert any("serve dispatcher stalled" in r for r in health["reasons"])
    t.join(30)
    assert np.array_equal(np.asarray(out["resp"]["scores"], np.float32),
                          served.offline()[[8, 9]])
    assert served.client.healthz()["status"] == "ok"


def test_partition_and_slow_replica_fire_in_the_fault_gate(served):
    inject.activate(inject.FaultPlan(partition_replica_after=1, partition_seconds=1.0))
    served.client.score(indices=[0])
    served.client.score(indices=[1])      # its dispatch opens the partition
    with pytest.raises(sc.ServeError) as err:   # status 0: a transport error
        served.client.score(indices=[2])
    assert err.value.status == 0
    time.sleep(1.1)                       # the partition heals
    assert served.client.score(indices=[2])["n"] == 1
    inject.activate(inject.FaultPlan(slow_replica_ms=300, slow_if_step=2))
    t0 = time.monotonic()
    served.client.healthz()               # model step None: not slowed
    fast = time.monotonic() - t0
    inject.activate(inject.FaultPlan(slow_replica_ms=300))
    t0 = time.monotonic()
    served.client.healthz()
    assert time.monotonic() - t0 >= 0.3 > fast


def test_kill_replica_after_requests_sigkills_the_service(tmp_path):
    """The non-graceful class, in a ``cli serve`` subprocess (it SIGKILLs its
    own process): the first request completes, the second dies unanswered."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO),
               DDT_FAULT_PLAN=json.dumps({"kill_replica_after_requests": 1}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "serve",
         "--device", "cpu", "data.dataset=synthetic", f"data.synthetic_size={N}",
         "model.arch=tiny_cnn", "train.half_precision=false", "score.pretrain_epochs=0",
         f"score.batch_size={B}", "score.method=el2n", "serve.port=0",
         f"obs.metrics_path={tmp_path}/metrics.jsonl",
         f"train.checkpoint_dir={tmp_path}/ckpt"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port = _read_port(proc)
        client = sc.ServeClient(f"http://127.0.0.1:{port}", timeout_s=30.0)
        assert client.score(indices=[0])["n"] == 1
        with pytest.raises(sc.ServeError) as err:   # status 0: a transport error
            client.score(indices=[1])
        assert err.value.status == 0
        assert proc.wait(timeout=30) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=30)


def _read_port(proc, timeout_s: float = 120.0) -> int:
    """The bound port from the service's ``obs_server`` record on stderr."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            assert proc.poll() is None, f"service exited {proc.returncode}"
            continue
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("kind") == "obs_server":
                return int(rec["port"])
    raise AssertionError("the service never announced its port")
