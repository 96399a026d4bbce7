"""PyTorch port: the serving fleet as ``cli serve --device cpu`` subprocesses
(``serve/fleet.py`` + ``serve/router.py``), tiny_cnn on 128 synthetic
examples, batch 32, EL2N.

Three drills, one fleet each (class-scoped):

* **kill and refresh**: replica 1 SIGKILLs itself mid-dispatch under load
  (``kill_replica_after_requests``): zero client-visible failures, a ``died``
  and a ``respawn`` on the same port, every served answer bitwise the port's
  offline ``score_dataset`` on the same variables before and after; a
  stepless refresh whose newest step is truncated is refused with the old
  model serving; a good step rolls one replica at a time under a hammer
  (capacity never zero, every answer bitwise old or new); SIGTERM exits 75
  and the stream passes ``tools/validate_metrics.py --expect-terminal``;
  ``tools/run_monitor.py --once`` exits 0 and ``obs/postmortem.py`` names
  the death and the respawn;
* **canary**: a good step in the watched directory rolls fleet-wide, a
  regressed one (slow past ``obs.slo_fleet_p95_ms`` while installed) is
  rolled back on the canary and the prior model keeps serving bitwise;
* **partition and autoscale**, through the remote backend (``serve.hosts``
  with the ``/usr/bin/env`` launch template): replica 1's endpoint goes dark
  with its process alive, is put on probation and reconnects with the
  restart budget untouched and no client-visible failure; the fleet SLO's
  pressure grows the fleet to ``serve.max_replicas`` and sustained idle
  shrinks it back.
"""

import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data.datasets import load_dataset
from data_diet_distributed_tpu_torch.models import create_model_from_cfg
from data_diet_distributed_tpu_torch.obs import postmortem
from data_diet_distributed_tpu_torch.obs import timeline as tl
from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
from data_diet_distributed_tpu_torch.resilience.inject import truncate_checkpoint
from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
from data_diet_distributed_tpu_torch.train.state import state_from_variables
from data_diet_distributed_tpu_torch.weights import init_variables
from torch_threads import SUBPROCESS_ENV, one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
N, B = 128, 32
IDS = [3, 7, 10, 100, 5]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sc = _load_tool("serve_client")
vm = _load_tool("validate_metrics")

ARGS = ["data.dataset=synthetic", f"data.synthetic_size={N}", f"data.batch_size={B}",
        "model.arch=tiny_cnn", "train.half_precision=false", "score.pretrain_epochs=0",
        f"score.batch_size={B}", "score.method=el2n", "serve.router_port=0",
        "serve.port=0", "serve.tenant=tiny", "serve.coalesce_ms=2", "serve.warm=false",
        "serve.health_poll_s=0.25", "serve.breaker_reset_s=0.5",
        "serve.request_timeout_s=120", "elastic.max_restarts=4", "elastic.backoff_s=0.2"]


def _records(path):
    out = []
    for line in open(path):
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue   # a killed replica's partial last line
    return out


def _launch(tmp: Path, plan: dict, *extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DDT_") and k != "PYTHONPATH"}
    env.update(SUBPROCESS_ENV, PYTHONPATH=str(REPO), DDT_FAULT_PLAN=json.dumps(plan))
    metrics = tmp / "metrics.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "serve", "--device",
         "cpu", *ARGS, f"obs.metrics_path={metrics}", f"obs.heartbeat_dir={tmp}/hb",
         f"train.checkpoint_dir={tmp}/ckpt", *extra],
        env=env, cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, metrics


def _wait_record(proc, metrics, pred, what, budget_s):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stdout.read()[-4000:]
        if metrics.exists():
            for rec in _records(metrics):
                if pred(rec):
                    return rec
        time.sleep(0.25)
    raise AssertionError(f"no {what} record within {budget_s}s")


def _router(proc, metrics):
    rec = _wait_record(proc, metrics, lambda r: r.get("kind") == "serve_fleet"
                       and r.get("event") == "launch", "launch", 120)
    return f"http://127.0.0.1:{rec['router_port']}"


def _wait_available(proc, probe, n, budget_s=120):
    deadline = time.monotonic() + budget_s
    verdict = None
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stdout.read()[-4000:]
        try:
            verdict = probe.healthz()
        except sc.ServeError:
            verdict = None
        if verdict and verdict.get("available") == n:
            return verdict
        time.sleep(0.2)
    raise AssertionError(f"fleet never reached {n} available: {verdict}")


def _stop(proc, out):
    proc.send_signal(signal.SIGTERM)
    out["rc"] = proc.wait(timeout=120)
    out["stdout"] = proc.stdout.read()


def _scores(client):
    return np.asarray(client.score(indices=IDS)["scores"], np.float32)


def _cfg(tmp):
    return load_config(None, ARGS + [f"train.checkpoint_dir={tmp}/ckpt"])


def _offline(cfg, variables_seeds):
    ds, _ = load_dataset("synthetic", synthetic_size=N, seed=0)
    return score_dataset(create_model_from_cfg(cfg), variables_seeds, ds, method="el2n",
                         batch_size=B, device="cpu")


def _save(cfg, directory, step, seed):
    mngr = CheckpointManager(str(directory))
    mngr.save(step, state_from_variables(init_variables("tiny_cnn", seed, "cpu"),
                                         create_model_from_cfg(cfg)))
    return mngr.restore_variables(step, "cpu")


def _terminal_stream_ok(drill):
    assert drill["rc"] == 75, drill["stdout"][-4000:]
    assert vm.validate_file(str(drill["metrics"]), expect_terminal=True) == []
    summary = drill["records"][-1]
    assert summary["kind"] == "run_summary" and summary["exit_class"] == "preempted"
    return summary


def _monitor(metrics):
    mon = subprocess.run(
        [sys.executable, str(REPO / "tools" / "run_monitor.py"), "--metrics", str(metrics),
         "--once", "--json"], capture_output=True, text=True, timeout=60)
    return mon.returncode, json.loads(mon.stdout.strip().splitlines()[-1])


class TestKillAndRefresh:
    @pytest.fixture(scope="class")
    def drill(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("fleet_kill")
        cfg = _cfg(tmp)
        ds, _ = load_dataset("synthetic", synthetic_size=N, seed=0)
        truth_init = _offline(cfg, ServeEngine(cfg, device="cpu").scoring_variables(ds))
        refresh_dir = tmp / "refresh_ck"
        truth_new = _offline(cfg, [_save(cfg, refresh_dir, 10, seed=5)])
        assert not np.array_equal(truth_init, truth_new)
        _save(cfg, refresh_dir, 20, seed=9)
        truncate_checkpoint(str(refresh_dir), 20)   # the newest step is torn
        proc, metrics = _launch(tmp, {"rank": 1, "kill_replica_after_requests": 6},
                                "serve.replicas=2", "serve.stats_every_s=2",
                                f"serve.refresh_from={refresh_dir}")
        out = dict(metrics=metrics, truth_init=truth_init, truth_new=truth_new)
        try:
            url = _router(proc, metrics)
            client = sc.ServeClient(url, timeout_s=120.0, retries=6, backoff_s=0.25)
            probe = sc.ServeClient(url, timeout_s=10.0)
            _wait_available(proc, probe, 2)
            out["pre_kill"] = _scores(client)
            out["load"] = sc.load_generate(url, rps=12, duration_s=4, batch=8,
                                           max_index=N - 1, timeout_s=120, retries=6,
                                           backoff_s=0.25)
            _wait_available(proc, probe, 2)
            out["post_kill"] = _scores(client)
            try:
                out["corrupt"] = client.refresh()
            except sc.ServeError as err:
                out["corrupt"] = err
            out["post_corrupt"] = _scores(client)
            hammered, avail, stop = [], [], threading.Event()

            def hammer():
                hc = sc.ServeClient(url, timeout_s=120.0, retries=6)
                while not stop.is_set():
                    hammered.append(_scores(hc))

            def capacity():
                while not stop.is_set():
                    try:
                        avail.append(probe.healthz().get("available"))
                    except sc.ServeError:
                        pass
                    time.sleep(0.05)

            threads = [threading.Thread(target=hammer, daemon=True),
                       threading.Thread(target=capacity, daemon=True)]
            for t in threads:
                t.start()
            try:
                out["roll"] = client.refresh(step=10)
            finally:
                time.sleep(0.3)
                stop.set()
                for t in threads:
                    t.join(timeout=60)
            out["hammered"], out["avail"] = hammered, avail
            out["post_roll"] = _scores(client)
            _stop(proc, out)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        out["records"] = _records(metrics)
        return out

    def test_zero_client_visible_failures_through_the_kill(self, drill):
        load = drill["load"]
        assert load["errors"] == 0 and load["rejected"] == 0, (load, drill["stdout"][-3000:])
        assert load["ok"] == load["sent"] and load["ok"] > 20, load

    def test_death_and_respawn_on_the_same_port(self, drill):
        revs = [r for r in drill["records"] if r.get("kind") == "replica_event"]
        deaths = [r for r in revs if r["event"] == "died"]
        respawns = [r for r in revs if r["event"] == "respawn"]
        assert deaths and deaths[0]["replica"] == 1
        assert deaths[0]["signal"] == signal.SIGKILL
        assert respawns and respawns[0]["replica"] == 1 and respawns[0]["generation"] == 1
        spawn_port = next(r["port"] for r in revs
                          if r["event"] == "spawn" and r["replica"] == 1)
        assert respawns[0]["port"] == spawn_port

    def test_served_scores_bitwise_the_offline_pass(self, drill):
        truth = drill["truth_init"][IDS]
        for key in ("pre_kill", "post_kill", "post_corrupt"):
            np.testing.assert_array_equal(drill[key], truth, err_msg=key)

    def test_torn_refresh_refused_old_model_serving(self, drill):
        err = drill["corrupt"]
        assert isinstance(err, Exception) and err.status == 409, err
        assert err.payload.get("status") == "roll_aborted", err.payload
        assert any(r.get("kind") == "model_refresh" and r.get("status") == "rejected"
                   for r in drill["records"])

    def test_refresh_rolls_one_at_a_time_capacity_never_zero(self, drill):
        roll = drill["roll"]
        assert roll["status"] == "rolled" and [r["code"] for r in roll["replicas"]] == [200, 200]
        np.testing.assert_array_equal(drill["post_roll"], drill["truth_new"][IDS])
        assert drill["avail"] and min(drill["avail"]) >= 1
        old, new = drill["truth_init"][IDS], drill["truth_new"][IDS]
        assert drill["hammered"]
        for got in drill["hammered"]:
            assert np.array_equal(got, old) or np.array_equal(got, new), got
        installs = [r for r in drill["records"] if r.get("kind") == "model_refresh"
                    and r.get("status") == "installed" and r.get("step") == 10]
        assert sorted(r["replica"] for r in installs) == [0, 1]

    def test_sigterm_exits_75_with_a_valid_terminal_stream(self, drill):
        summary = _terminal_stream_ok(drill)
        lin = summary["lineage"]
        assert lin["replicas"] == 2 and lin["respawns"] == 1 and lin["generations"] == [0, 1]
        events = {r["event"] for r in drill["records"] if r.get("kind") == "serve_fleet"}
        assert {"supervise", "launch", "stats", "drain", "preempted_exit"} <= events

    def test_run_monitor_once_exits_zero(self, drill):
        rc, view = _monitor(drill["metrics"])
        assert rc == 0, view
        sf = view["serve_fleet"]
        assert sf["deaths"] >= 1 and sf["respawns"] >= 1
        assert sf["refreshes"] >= 2 and sf["refresh_rejected"] >= 1

    def test_postmortem_names_the_death_and_the_respawn(self, drill):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = postmortem.main([str(drill["metrics"]), "--timeline", "100000"])
        text = buf.getvalue()
        assert rc == 0, text
        assert " died" in text and " respawn" in text
        events = tl.build_timeline({"records": drill["records"]})
        died = [e for e in events if e["kind"] == "replica_event" and e.get("event") == "died"]
        back = [e for e in events if e["kind"] == "replica_event"
                and e.get("event") == "respawn"]
        assert died[0]["replica"] == back[0]["replica"] == 1
        assert died[0]["ts"] <= back[0]["ts"]
        view = tl.lineage_view(drill["records"])
        assert view["attempts"] == 1 and view["unexplained"] == []


class TestCanary:
    @pytest.fixture(scope="class")
    def drill(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("fleet_canary")
        cfg = _cfg(tmp)
        watch = tmp / "watched"
        proc, metrics = _launch(tmp, {"rank": 0, "slow_replica_ms": 600.0,
                                      "slow_if_step": 999},
                                "serve.replicas=2", f"serve.refresh_from={watch}",
                                "serve.refresh_poll_s=0.3", "serve.canary_requests=3",
                                "serve.canary_timeout_s=10", "serve.stats_every_s=2",
                                "obs.slo_fleet_p95_ms=300")
        out = dict(metrics=metrics, errors=0)
        try:
            url = _router(proc, metrics)
            client = sc.ServeClient(url, timeout_s=120.0, retries=6, backoff_s=0.25)
            _wait_available(proc, sc.ServeClient(url, timeout_s=10.0), 2)

            def burst_until(pred, what):
                # The canary hold judges routed requests: offer traffic until
                # the awaited record lands.
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    for rec in _records(metrics):
                        if pred(rec):
                            return rec
                    load = sc.load_generate(url, rps=10, duration_s=1, batch=8,
                                            max_index=N - 1, timeout_s=120, retries=6,
                                            backoff_s=0.25)
                    out["errors"] += load["errors"]
                raise AssertionError(f"no {what} within 60 s")

            out["good"] = _offline(cfg, [_save(cfg, watch, 10, seed=5)])
            out["roll10"] = burst_until(
                lambda r: r.get("kind") == "model_refresh"
                and r.get("status") == "roll_complete" and r.get("step") == 10,
                "roll_complete step 10")
            out["baseline"] = _scores(client)
            _save(cfg, watch, 999, seed=9)
            out["rolled_back"] = burst_until(
                lambda r: r.get("kind") == "model_refresh"
                and r.get("status") == "rolled_back", "rolled_back")
            out["after"] = _scores(client)
            _stop(proc, out)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        out["records"] = _records(metrics)
        return out

    def test_good_step_rolls_fleet_wide(self, drill):
        assert drill["errors"] == 0, drill["stdout"][-3000:]
        installs = {r["replica"] for r in drill["records"] if r.get("kind") == "model_refresh"
                    and r.get("status") == "installed" and r.get("step") == 10}
        assert installs == {0, 1}
        np.testing.assert_array_equal(drill["baseline"], drill["good"][IDS])

    def test_regressed_step_rolled_back_at_the_canary(self, drill):
        rec = drill["rolled_back"]
        assert rec["step"] == 999 and rec["prior"]["step"] == 10
        assert rec["canary"]["verdict"] == "fail" and rec["canary"]["replica"] == 0
        assert any("p95" in r for r in rec["canary"]["reasons"]), rec["canary"]
        assert not [r for r in drill["records"] if r.get("kind") == "model_refresh"
                    and r.get("status") == "roll_complete" and r.get("step") == 999]

    def test_prior_model_serves_bitwise_after_the_rollback(self, drill):
        np.testing.assert_array_equal(drill["after"], drill["baseline"])
        _terminal_stream_ok(drill)
        rc, view = _monitor(drill["metrics"])
        assert rc in (0, 1) and view["serve_fleet"]["refresh_rolled_back"] >= 1


class TestPartitionAndAutoscale:
    """``serve.replicas=2`` placed through ``serve.remote_launch`` on
    127.0.0.1, ``serve.max_replicas=3``, and a fleet p95 floor every routed
    request exceeds: load is pressure, idle is headroom."""

    @pytest.fixture(scope="class")
    def drill(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("fleet_partition")
        proc, metrics = _launch(
            tmp, {"rank": 1, "partition_replica_after": 2, "partition_seconds": 2.0},
            "serve.replicas=2", "serve.max_replicas=3", "serve.hosts=[127.0.0.1]",
            "serve.remote_launch='/usr/bin/env DDT_REMOTE_HOST={host}'",
            "serve.partition_after_misses=2", "serve.probe_backoff_s=0.25",
            "serve.probe_backoff_max_s=1.0", "serve.stats_every_s=0.5",
            "serve.scale_up_after=2", "serve.scale_down_after=3",
            "serve.scale_cooldown_s=1", "obs.slo_fleet_p95_ms=0.001")
        out = dict(metrics=metrics)
        try:
            url = _router(proc, metrics)
            probe = sc.ServeClient(url, timeout_s=10.0)
            _wait_available(proc, probe, 2)
            out["load"] = sc.load_generate(url, rps=10, duration_s=4, batch=8,
                                           max_index=N - 1, timeout_s=120, retries=6,
                                           backoff_s=0.25)
            for what, pred in (
                    ("reconnected", lambda r: r.get("event") == "reconnected"),
                    ("scale_up", lambda r: r.get("action") == "scale_up"),
                    ("scale_down", lambda r: r.get("action") == "scale_down")):
                out[what] = _wait_record(proc, metrics, pred, what, 90)
            _stop(proc, out)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        out["records"] = _records(metrics)
        return out

    def test_zero_client_visible_failures_through_the_partition(self, drill):
        load = drill["load"]
        assert load["errors"] == 0 and load["rejected"] == 0, (load, drill["stdout"][-3000:])

    def test_partition_is_probation_not_a_death(self, drill):
        revs = [r for r in drill["records"] if r.get("kind") == "replica_event"]
        parts = [r for r in revs if r["event"] == "partitioned"]
        assert parts and parts[0]["replica"] == 1 and parts[0]["misses"] >= 2
        probes = [r for r in revs if r["event"] == "probation_probe"]
        assert all(r["replica"] == 1 and r["next_probe_s"] <= 1.0 for r in probes)
        assert not [r for r in revs if r["event"] in ("died", "respawn")]
        rec = drill["reconnected"]
        assert rec["replica"] == 1 and rec["restarts_left"] == 4 and rec["outage_s"] > 0
        spawns = [r for r in revs if r["event"] == "spawn" and r.get("cause") != "autoscale"]
        assert len(spawns) == 2 and all(r.get("host") == "127.0.0.1" for r in spawns)

    def test_pressure_grows_and_idle_shrinks_the_fleet(self, drill):
        up, down = drill["scale_up"], drill["scale_down"]
        assert (up["replicas_from"], up["replicas_to"]) == (2, 3) and up["max_replicas"] == 3
        assert any("p95" in r for r in up["reasons"]) and up["evidence"]["p95_ms"] > 0.001
        assert (down["replicas_from"], down["replicas_to"]) == (3, 2)
        assert down["min_replicas"] == 2 and any("headroom" in r for r in down["reasons"])
        revs = [r for r in drill["records"] if r.get("kind") == "replica_event"]
        assert [r["replica"] for r in revs if r.get("cause") == "autoscale"
                and r["event"] in ("spawn", "retired")] == [2, 2]

    def test_terminal_stream_and_monitor_see_both(self, drill):
        _terminal_stream_ok(drill)
        rc, view = _monitor(drill["metrics"])
        assert rc == 1, view   # the floor's violations are real slo_violation records
        assert view["serve_fleet"]["partitioned"] >= 1
        assert view["serve_fleet"]["reconnected"] >= 1
        assert view["autoscale"]["scale_ups"] >= 1 and view["autoscale"]["scale_downs"] >= 1
