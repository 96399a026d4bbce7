"""PyTorch port: the serve-fleet soak tool
(``data_diet_distributed_tpu_torch.tools.serve_soak``), against the JAX
tool ``tools/serve_soak.py`` (loaded by path; its module level imports only
the standard library).

* ``FAULTS``, ``SCHEDULE``, ``MONITOR_OK`` and ``REGRESSED_STEP`` equal the
  JAX tool's, and ``_fault_overrides`` / ``_cycle_overrides`` give the same
  overrides for every fault;
* ``_forensics`` returns the JAX tool's problem lists on the same records,
  a passing and a failing set per fault (the ``rc != 75`` and the
  restart-budget branches among them);
* the ``soak_report`` keys are the JAX tool's, and each cycle's verdict has
  the JAX verdict's keys plus ``kernel_launches`` and ``timeline``;
* the refresh checkpoints: the torn step 20 is refused by the port's refresh
  verification, step 10 installs the seed-5 weights, the regressed step the
  seed-7 ones;
* the tool runs with JAX unimportable, and without a card the default
  ``--device cuda`` exits non-zero before it writes anything;
* a replica's cold call (the first of its program, 2-5 s on the card) is
  held to ``serve.request_timeout_s``, not read as a wedge under the soak's
  1-s ``serve.dispatch_stall_s``, while a warm dispatch past that budget
  still turns ``/healthz`` critical.

One real ``kill`` cycle and the whole schedule on the CPU are ``slow``: a
cycle boots a fleet of CLI processes (~20 s on the CPU). The card runs the
``partition``, ``autoscale`` and ``wedge`` cycles in ``chip_smoke.py``'s
serve_soak phase.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.resilience import inject
from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
from data_diet_distributed_tpu_torch.tools import serve_soak
from data_diet_distributed_tpu_torch.tools.validate_metrics import validate_file
from data_diet_distributed_tpu_torch.weights import init_variables
from test_torch_serve_service import Served
from torch_threads import SUBPROCESS_ENV, one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
JAX_TOOL = REPO / "tools" / "serve_soak.py"
PORT_TOOL = REPO / "data_diet_distributed_tpu_torch" / "tools" / "serve_soak.py"
NEW_FILES = [PORT_TOOL, REPO / "data_diet_distributed_tpu_torch" / "examples" / "__init__.py",
             REPO / "data_diet_distributed_tpu_torch" / "examples" / "walkthrough.py"]


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_tool_serve_soak", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(**over) -> argparse.Namespace:
    return argparse.Namespace(**{**vars(serve_soak.parse_args([])), **over})


@pytest.mark.parametrize("name", ["FAULTS", "SCHEDULE", "MONITOR_OK", "REGRESSED_STEP"])
def test_constants_match(jax_tool, name):
    assert getattr(serve_soak, name) == getattr(jax_tool, name)


@pytest.mark.parametrize("fault", sorted(serve_soak.FAULTS))
def test_overrides_match(jax_tool, fault, tmp_path):
    cycle_dir, refresh_dir = str(tmp_path / "c"), str(tmp_path / "r")
    assert serve_soak._fault_overrides(fault, cycle_dir) \
        == jax_tool._fault_overrides(fault, cycle_dir)
    args = _args(arch="resnet18", method="grand", size=512, replicas=3, max_restarts=2)
    assert serve_soak._cycle_overrides(args, cycle_dir, refresh_dir) \
        == jax_tool._cycle_overrides(args, cycle_dir, refresh_dir)


def _ev(event, **kw):
    return {"kind": "replica_event", "event": event, **kw}


def _refresh(status, **kw):
    return {"kind": "model_refresh", "status": status, **kw}


def _scale(action, **kw):
    return {"kind": "autoscale_event", "action": action, **kw}


PREEMPTED = {"kind": "run_summary", "exit_class": "preempted"}
GOOD_ROLL = {"replicas": 2, "max_restarts": 4, "corrupt_rejected": True,
             "roll": {"status": "rolled"}, "min_available": 1}
UP = _scale("scale_up", reasons=["p95"], evidence={"p95_ms": 420.0}, replicas_to=3,
            max_replicas=3)
DOWN = _scale("scale_down", replicas_to=2, min_replicas=2)

#: (name, fault, records, rc, refresh verdicts, passes)
FORENSICS = [
    ("kill-pass", "kill", [_ev("died", signal="SIGKILL"), _ev("respawn"), PREEMPTED], 75, {},
     True),
    ("kill-fail", "kill", [_ev("died", signal=None)], 75, {}, False),
    ("wedge-pass", "wedge", [_ev("wedged"), _ev("wedged_reaped"), _ev("respawn"), PREEMPTED],
     75, {}, True),
    ("wedge-fail", "wedge", [_ev("wedged"), PREEMPTED], 75, {}, False),
    ("refresh-pass", "refresh", [_refresh("rejected"), _refresh("installed"),
                                 _refresh("installed"), _refresh("roll_complete"), PREEMPTED],
     75, GOOD_ROLL, True),
    ("refresh-fail", "refresh", [_refresh("installed"), PREEMPTED], 75,
     {"replicas": 2, "corrupt_rejected": False, "roll": {"status": "aborted"},
      "min_available": 0}, False),
    ("partition-pass", "partition", [_ev("partitioned", restarts_left=4),
                                     _ev("probation_probe"), _ev("reconnected", restarts_left=4),
                                     PREEMPTED], 75, {"max_restarts": 4}, True),
    # The restart-budget branch, and a partition taken for a death.
    ("partition-fail", "partition", [_ev("partitioned"), _ev("died"), _ev("respawn"),
                                     _ev("reconnected", restarts_left=3), PREEMPTED], 75,
     {"max_restarts": 4}, False),
    ("autoscale-pass", "autoscale", [UP, DOWN, _ev("spawn", cause="autoscale"),
                                     _ev("retired", cause="autoscale"), PREEMPTED], 75, {},
     True),
    ("autoscale-fail", "autoscale",
     [_scale("scale_up", reasons=[], evidence={}, replicas_to=4, max_replicas=3),
      _scale("scale_down", replicas_to=1, min_replicas=2), _ev("spawn", cause="initial"),
      PREEMPTED], 75, {}, False),
    ("autoscale-none", "autoscale", [PREEMPTED], 75, {}, False),
    ("canary-pass", "canary", [_refresh("roll_complete", step=2),
                               _refresh("rolled_back", step=999, canary={"reasons": ["p95"]}),
                               PREEMPTED], 75, {"regressed_step": 999, "bit_identical": True},
     True),
    ("canary-fail", "canary", [_refresh("roll_complete", step=999),
                               _refresh("rolled_back", step=999, canary={}), PREEMPTED], 75,
     {"regressed_step": 999, "bit_identical": False}, False),
    ("sigterm-pass", "sigterm", [PREEMPTED], 75, {}, True),
    # The rc != 75 branch.
    ("sigterm-fail", "sigterm", [{"kind": "run_summary", "exit_class": "ok"}], 0, {}, False),
    ("none-pass", "none", [PREEMPTED], 75, {}, True),
    ("none-fail", "none", [], 1, {}, False),
]


@pytest.mark.parametrize("name,fault,recs,rc,verdicts,passes", FORENSICS,
                         ids=[case[0] for case in FORENSICS])
def test_forensics_match(jax_tool, name, fault, recs, rc, verdicts, passes):
    got = serve_soak._forensics(fault, recs, rc, verdicts)
    assert got == jax_tool._forensics(fault, recs, rc, verdicts)
    assert (got == []) == passes, got


def _dict_keys(path: Path, func: str, target: str) -> list[str]:
    """The keys of the dict literal assigned to ``target`` in ``func``."""
    fn = next(node for node in ast.parse(path.read_text()).body
              if isinstance(node, ast.FunctionDef) and node.name == func)
    node = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == target for t in n.targets)
                and isinstance(n.value, ast.Dict))
    return [k.value for k in node.value.keys]


def _verdict_keys(path: Path) -> list[str]:
    """The keyword names of ``verdict.update(...)`` in ``run_cycle``."""
    fn = next(node for node in ast.parse(path.read_text()).body
              if isinstance(node, ast.FunctionDef) and node.name == "run_cycle")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "update"
                and getattr(n.func.value, "id", None) == "verdict")
    return [kw.arg for kw in call.keywords]


def test_report_keys_match():
    assert _dict_keys(PORT_TOOL, "main", "report") == _dict_keys(JAX_TOOL, "main", "report")
    port, jax_keys = _verdict_keys(PORT_TOOL), _verdict_keys(JAX_TOOL)
    assert [k for k in port if k not in ("kernel_launches", "timeline")] == jax_keys
    assert {"kernel_launches", "timeline"} <= set(port)


def test_refresh_checkpoints(tmp_path):
    """The torn newest step is refused by the refresh path's verification, the
    good step installs seed 5's weights, the regressed step seed 7's."""
    args = _args(device="cpu")
    refresh_dir = str(tmp_path / "refresh_ck")
    cfg = load_config(None, serve_soak._cycle_overrides(args, str(tmp_path), refresh_dir))
    serve_soak._make_refresh_ckpt(cfg, refresh_dir)
    engine = ServeEngine(cfg, device="cpu")
    with pytest.raises(Exception, match="step_20|digest|sha256|corrupt|Corrupt|truncat"):
        engine.load_checkpoint_variables(refresh_dir)
    got, step = engine.load_checkpoint_variables(refresh_dir, 10)
    want = init_variables("tiny_cnn", 5, "cpu", num_classes=cfg.model.num_classes)
    assert step == 10 and got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    watch = str(tmp_path / "live_ckpt")
    serve_soak._make_regressed_ckpt(cfg, watch)
    got, step = engine.load_checkpoint_variables(watch)
    want = init_variables("tiny_cnn", serve_soak.REGRESSED_SEED, "cpu",
                          num_classes=cfg.model.num_classes)
    assert step == serve_soak.REGRESSED_STEP
    assert all(np.array_equal(got[k].numpy(), want[k].numpy()) for k in want)


def test_launches_and_timeline_from_the_records():
    recs = [{"kind": "serve_fleet", "event": "launch", "ts": 100.0},
            {"kind": "metrics", "gauges": {"kernel_launches:conv_grad_norm_direct": 24,
                                           "kernel_launches:conv_grad_norm_gram": 6,
                                           "slo_ok": 1.0}},
            {"kind": "metrics", "gauges": {"kernel_launches:conv_grad_norm_direct": 12}},
            {"kind": "serve_trace", "ts": 101.0, "where": "replica", "replica": 1,
             "status": 200},
            {"kind": "serve_trace", "ts": 101.5, "where": "router", "replica": 1,
             "status": 200},
            {"kind": "slo_violation", "ts": 101.8, "slo": "fleet_p95_ms", "value": 400,
             "threshold": 150},
            {"kind": "slo_violation", "ts": 101.9, "slo": "fleet_p95_ms"},
            {"kind": "replica_event", "event": "partitioned", "replica": 1, "ts": 102.25,
             "restarts_left": 4, "misses": 2},
            {"kind": "replica_event", "event": "reconnected", "replica": 1, "ts": 106.0,
             "restarts_left": 4, "outage_s": 3.75}]
    assert serve_soak.kernel_launches(recs) == {"conv_grad_norm_direct": 36,
                                                "conv_grad_norm_gram": 6}
    assert serve_soak.timeline(recs, {"available": 100.5}) == [
        {"t_s": 0.5, "what": "available"},
        {"t_s": 1.0, "what": "dark", "replica": 1},
        {"t_s": 1.8, "what": "slo_violation:fleet_p95_ms", "value": 400, "threshold": 150},
        {"t_s": 2.25, "what": "replica_event:partitioned", "replica": 1, "restarts_left": 4},
        {"t_s": 6.0, "what": "replica_event:reconnected", "replica": 1, "restarts_left": 4,
         "outage_s": 3.75}]
    assert serve_soak.timeline(recs[1:], {}) == []


def test_imports_no_jax():
    """The port's new files import nothing of JAX or the JAX package and start
    no child of it."""
    banned = ("jax", "flax", "optax", "oracle", "data_diet_distributed_tpu")
    for path in NEW_FILES:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
        assert "data_diet_distributed_tpu.cli" not in path.read_text(), path


def test_help_without_jax(tmp_path):
    code = ("import runpy, sys\n"
            "for m in ('jax', 'flax', 'optax', 'data_diet_distributed_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['serve_soak', '--help']\n"
            "runpy.run_module('data_diet_distributed_tpu_torch.tools.serve_soak', "
            "run_name='__main__')\n")
    env = {**os.environ, **SUBPROCESS_ENV,
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for flag in ("--device", "--smoke", "--schedule", "--respawn-timeout"):
        assert flag in proc.stdout


@pytest.mark.parametrize("argv", [[], ["--smoke"]])
def test_cuda_without_a_card_exits_nonzero(tmp_path, argv):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is then valid")
    out = io.StringIO()
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stdout(out):
        serve_soak.main(argv + ["--workdir", str(tmp_path / "wd")])
    assert exc.value.code not in (0, None) and "--device cpu" in str(exc.value.code)
    assert out.getvalue() == "" and sorted(os.listdir(tmp_path)) == []


def test_a_cold_call_is_held_to_the_request_timeout(tmp_path, monkeypatch):
    """A first call made 1 s slow (as kernel loads and a graph capture make it
    on the card) under a 0.3-s stall budget: ``/healthz`` stays ok and says
    the call is cold. Then a warm dispatch wedged past the budget turns it
    critical."""
    served = Served(tmp_path, "serve.dispatch_stall_s=0.3")
    real = served.engine._first_call

    def slow_first_call(key, local):
        call = real(key, local)
        if call is local:
            return call

        def slow(*args):
            time.sleep(1.0)
            return call(*args)
        return slow

    monkeypatch.setattr(served.engine, "_first_call", slow_first_call)
    try:
        out = {}
        t = threading.Thread(target=lambda: out.update(resp=served.client.score(indices=[0, 1])))
        t.start()
        seen = []
        while t.is_alive():
            seen.append(served.client.healthz())
            time.sleep(0.05)
        t.join()
        watch = [h["serve_watchdog"] for h in seen]
        assert any(w["cold"] and w["dispatch_age_s"] > 0.3 for w in watch), watch
        assert all(h["status"] == "ok" for h in seen), seen
        assert np.array_equal(np.asarray(out["resp"]["scores"], np.float32),
                              served.offline()[[0, 1]])
        inject.activate(inject.FaultPlan(wedge_dispatcher_after=2, hang_seconds=2.0))
        t = threading.Thread(target=lambda: served.client.score(indices=[8, 9]))
        t.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            health = served.client.healthz()
            if health["status"] == "critical":
                break
            time.sleep(0.05)
        t.join(30)
        assert health["status"] == "critical" and not health["serve_watchdog"]["cold"]
        assert any(r.startswith("serve dispatcher stalled: dispatch in flight")
                   and "serve.dispatch_stall_s=0.3" in r for r in health["reasons"])
    finally:
        inject.deactivate()
        served.close()


def _run_soak(args: list[str], cwd, timeout: float) -> tuple[int, dict]:
    env = {**os.environ, **SUBPROCESS_ENV,
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    env.pop("DDT_FAULT_PLAN", None)
    proc = subprocess.run(
        [sys.executable, "-m", "data_diet_distributed_tpu_torch.tools.serve_soak", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    return proc.returncode, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.slow
def test_kill_cycle_on_the_cpu(tmp_path):
    """One real kill cycle (tiny CNN, two replicas): zero client-visible
    failures, the died/respawn pair, exit 75, a valid soak stream."""
    workdir = tmp_path / "soak"
    rc, report = _run_soak(["--device", "cpu", "--schedule", "kill", "--duration", "2",
                            "--workdir", str(workdir), "--quiet"], tmp_path, 300)
    assert rc == 0 and report["ok"] is True, json.dumps(report)[:3000]
    assert report["faults"] == ["kill"] and report["passed"] == 1
    assert report["monitor_exits"] == [0] and report["replicas"] == 2
    (cycle,) = report["per_cycle"]
    assert cycle["errors"] == cycle["rejected"] == 0 and cycle["requests"] > 0
    assert cycle["rc"] == 75 and cycle["exit_class"] == "preempted"
    whats = [row["what"] for row in cycle["timeline"]]
    assert "replica_event:died" in whats and "replica_event:respawn" in whats
    assert cycle["kernel_launches"] == {}   # the CPU runs the plain versions
    assert validate_file(str(workdir / "soak.jsonl")) == []


@pytest.mark.slow
def test_whole_schedule_on_the_cpu(tmp_path):
    """``--smoke``: the seven cycles of the default schedule, every one passed."""
    rc, report = _run_soak(["--device", "cpu", "--smoke", "--workdir", str(tmp_path / "soak"),
                            "--quiet"], tmp_path, 900)
    assert rc == 0 and report["ok"] is True, json.dumps(report)[:3000]
    assert report["faults"] == serve_soak.SCHEDULE.split(",")
    assert report["passed"] == 7 and report["smoke"] is True
    assert report["monitor_exits"][serve_soak.SCHEDULE.split(",").index("autoscale")] == 1
