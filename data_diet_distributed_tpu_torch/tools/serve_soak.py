"""Serve-fleet soak: the replicated scoring service's proof harness.

The port's copy of ``tools/serve_soak.py``: the same fault cycles, arguments,
records and final JSON line, run without JAX, with ``--device cuda|cpu``
(default ``cuda``) in place of the JAX backends. Without a card and without
``--device cpu`` the tool exits non-zero before it writes anything; the fleet
and the canary cycle's live training run get the same ``--device``, and
nothing falls back to the CPU.

Each cycle boots the REAL production fleet (``python -m
data_diet_distributed_tpu_torch.cli serve`` with ``serve.replicas=N``: N serve
children behind the health-aware router, supervised by
``serve/fleet.ServeFleet``), injects exactly one fault, and drives open-loop
load through the router with ``tools/serve_client.py``'s generator. The
acceptance bar is **zero client-visible request failures** through every
fault, judged per cycle by

* the load report (``errors == 0 and rejected == 0``),
* ``python -m data_diet_distributed_tpu_torch.tools.run_monitor --once`` exit
  codes over the cycle's records (0 healthy / 1 SLO-violated / 2
  unreachable-or-stale),
* ``tools/validate_metrics.py`` schema validation of the stream,
* the request observatory: every cycle's stream must carry schema-valid
  ``serve_trace`` records AND ``tools/request_report.py`` must produce a
  tail-attribution verdict over them (exit 0 — a stream with no traces
  fails the cycle), and
* fault-specific record forensics (a kill cycle must leave a
  ``replica_event`` died/respawn pair; a wedge cycle a
  wedged/wedged_reaped/respawn chain; a refresh cycle a digest-loud
  ``model_refresh`` rejection AND a completed one-replica-at-a-time roll
  with capacity never zero; a sigterm cycle exit 75 with
  ``exit_class=preempted``).

Fault cycles (``--schedule``):

* ``kill``    — replica 1 SIGKILLs itself mid-dispatch
  (``kill_replica_after_requests``); the router replays the dead
  replica's in-flight idempotent requests and the fleet respawns it.
* ``wedge``   — replica 1's dispatcher hangs (``wedge_dispatcher_after``);
  its /healthz goes critical past ``serve.dispatch_stall_s``, the router
  routes around it, the fleet drains + relaunches.
* ``refresh`` — a TORN newest checkpoint step is refresh-rejected
  (digest verification, old model keeps serving), then a good step is
  rolled across replicas one at a time under hammer load.
* ``partition`` — replica 1's network partitions mid-dispatch (alive
  process, connections torn with no response bytes) for
  ``partition_seconds``; the fleet must QUARANTINE it (probation +
  bounded re-probes), never respawn it, spend zero restart budget, and
  un-quarantine on reconnect — all with zero client-visible failures.
  The cycle also exercises the REMOTE replica backend: every replica is
  placed through ``serve.remote_launch`` against ``serve.hosts``
  (127.0.0.1, so the "remote" path runs end-to-end on one machine; the
  fault plan and ``--device`` reach each child through the launch argv).
* ``autoscale`` — replica 1 serves 400 ms slow, pushing the router tick
  p95 past ``obs.slo_fleet_p95_ms``; the SLO-driven autoscaler must grow
  the fleet within ``[min_replicas, max_replicas]`` under sustained
  pressure, then shrink back on sustained idle — each decision an
  evidence-carrying ``autoscale_event``. run_monitor exits 1 here BY
  DESIGN: the injected pressure records real slo_violations.
* ``canary`` — continuous deployment against a LIVE training run: a real
  ``cli train`` subprocess writes checkpoints into the watched dir and
  the fleet's refresh watcher rolls them canary-first. A deliberately
  regressed step (slow only when the canary serves it) must be rolled
  BACK at the canary stage with the prior model restored and serving
  bit-identical scores; the good steps roll to the full fleet.
* ``sigterm`` — the whole fleet is preempted after a clean load pass:
  admission stops, replicas drain, exit 75.
* ``none``    — control cycle: load + clean shutdown, no fault.

Each cycle's verdict also carries ``kernel_launches``: the replicas' launches
by kernel, summed over the ``kernel_launches:<kernel>`` gauges of the
``metrics`` records the replicas left in the cycle's stream when they exited
(a replica that was SIGKILLed leaves none).

The tool emits one ``{"kind": "soak_report"}`` record (and prints it as
the final JSON line); exit 0 iff every cycle passed. Each cycle's fleet
supervisor writes its output to ``supervisor.log`` in the cycle's directory
(the canary's live run to ``train.log``).

CPU::

    python -m data_diet_distributed_tpu_torch.tools.serve_soak --device cpu --smoke

Card::

    python -m data_diet_distributed_tpu_torch.tools.serve_soak --arch resnet18 --method grand
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

from .autotune import _child_env, device_error

#: fault name -> DDT_FAULT_PLAN payload for the fleet's children. Replica 1
#: is targeted (rank == fleet index via DDT_SERVE_REPLICA) so replica 0
#: survives to carry the load while the fault plays out.
#: The deliberately-regressed checkpoint step the canary cycle fabricates —
#: pinned here so the fault plan (slow only when the canary SERVES this
#: step) and the checkpoint writer agree.
REGRESSED_STEP = 999

FAULTS = {
    "none": None,
    "kill": {"rank": 1, "kill_replica_after_requests": 4},
    "wedge": {"rank": 1, "wedge_dispatcher_after": 3, "hang_seconds": 600.0},
    "refresh": None,
    "partition": {"rank": 1, "partition_replica_after": 3,
                  "partition_seconds": 4.0},
    "autoscale": {"rank": 1, "slow_replica_ms": 400.0},
    "canary": {"rank": 0, "slow_replica_ms": 600.0,
               "slow_if_step": REGRESSED_STEP},
    "sigterm": None,
}

SCHEDULE = "kill,wedge,refresh,partition,autoscale,canary,sigterm"

#: run_monitor --once exits each cycle is ALLOWED to end with. The
#: autoscale cycle records real slo_violations (that is the injected
#: pressure working) so exit 1 is the expectation, not a failure; the
#: canary cycle's regressed window may or may not cross a stats tick.
MONITOR_OK = {"autoscale": (1,), "canary": (0, 1)}

#: The checkpoint seeds: good refresh step 10, torn step 20, the regressed
#: step (each the seed of the ``torch.Generator`` that ``init_variables``
#: draws the weights from).
REFRESH_SEEDS = {10: 5, 20: 9}
REGRESSED_SEED = 7

_LAUNCH_GAUGE = "kernel_launches:"

#: The records a cycle's timeline lists, each by the field that names its
#: moment, and the fields it carries along when the record has them.
_TIMELINE_KINDS = {"replica_event": "event", "autoscale_event": "action",
                   "model_refresh": "status"}
_TIMELINE_FIELDS = ("replica", "step", "cause", "restarts_left", "outage_s",
                    "probes", "replicas_to")


def _fault_overrides(fault: str, cycle_dir: str) -> list[str]:
    """Per-fault config appended AFTER the base overrides (later wins)."""
    if fault == "partition":
        # Fast partition detection + probation cadence, and the remote
        # replica backend end-to-end: every replica placed via the
        # remote_launch template against a "host" that is this machine.
        return ["serve.partition_after_misses=2",
                "serve.probe_backoff_s=0.25", "serve.probe_backoff_max_s=1.0",
                "serve.hosts=[127.0.0.1]",
                "serve.remote_launch='/usr/bin/env DDT_REMOTE_HOST={host}'"]
    if fault == "autoscale":
        return ["serve.min_replicas=2", "serve.max_replicas=3",
                "serve.scale_up_after=2", "serve.scale_down_after=3",
                "serve.scale_cooldown_s=3", "serve.stats_every_s=1",
                "obs.slo_fleet_p95_ms=150"]
    if fault == "canary":
        watch = os.path.join(cycle_dir, "live_ckpt")
        return [f"serve.refresh_from={watch}", "serve.refresh_poll_s=0.5",
                "serve.canary_requests=4", "serve.canary_timeout_s=10",
                "obs.slo_fleet_p95_ms=150"]
    return []


def _stream_recs(path: str) -> list[dict]:
    recs = []
    try:
        with open(path) as fh:
            for line in fh:
                try:
                    recs.append(json.loads(line))
                except ValueError:
                    continue   # a torn tail line is the reader's problem
    except OSError:
        pass
    return recs


def _tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, errors="replace") as fh:
            return fh.read()[-n:]
    except OSError:
        return ""


def _make_refresh_ckpt(cfg, directory: str) -> None:
    """A GOOD step 10 plus a TORN (truncated-payload) step 20 in one
    checkpoint dir: a stepless refresh takes the newest durable step — the
    torn one — so digest verification must reject it; step 10 then rolls.
    Written on the CPU: the weights are drawn there whatever the device."""
    from ..checkpoint import CheckpointManager
    from ..resilience.inject import truncate_checkpoint
    from ..train.state import create_train_state
    mngr = CheckpointManager(directory)
    for step, seed in REFRESH_SEEDS.items():
        mngr.save(step, create_train_state(cfg, seed, device="cpu"))
    mngr.close()
    truncate_checkpoint(directory, 20)


def _make_regressed_ckpt(cfg, directory: str) -> None:
    """A digest-VALID checkpoint at ``REGRESSED_STEP`` (fresh random
    weights — a genuinely different, worse model) dropped into the canary
    cycle's watched dir. The fault plan makes the canary replica slow only
    while SERVING this step, so the canary window regresses and the roll
    must come back."""
    from ..checkpoint import CheckpointManager
    from ..train.state import create_train_state
    mngr = CheckpointManager(directory)
    mngr.save(REGRESSED_STEP, create_train_state(cfg, REGRESSED_SEED, device="cpu"))
    mngr.close()


def _launch_train(args, cycle_dir: str, watch_dir: str,
                  env: dict) -> subprocess.Popen:
    """The LIVE training run whose promotion stream the canary cycle's
    fleet follows: a real ``cli train`` on the fleet's ``--device`` writing
    epoch checkpoints into the watched dir, with its own metrics/heartbeat
    artifacts so the fleet's stream stays single-writer, and none of the
    fleet's fault plan."""
    train_env = {k: v for k, v in env.items() if k != "DDT_FAULT_PLAN"}
    overrides = [
        "data.dataset=synthetic", f"data.synthetic_size={args.size}",
        "data.batch_size=64", f"model.arch={args.arch}",
        "train.half_precision=false", "score.pretrain_epochs=0",
        "score.batch_size=64", f"score.method={args.method}",
        "train.num_epochs=2", "train.checkpoint_every=1",
        f"train.checkpoint_dir={watch_dir}",
        f"obs.metrics_path={os.path.join(cycle_dir, 'train_metrics.jsonl')}",
        f"obs.heartbeat_dir={os.path.join(cycle_dir, 'train_hb')}",
    ]
    with open(os.path.join(cycle_dir, "train.log"), "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "train",
             "--device", args.device, *overrides],
            env=train_env, cwd=cycle_dir, stdout=log, stderr=subprocess.STDOUT)


def _cycle_overrides(args, cycle_dir: str, refresh_dir: str) -> list[str]:
    return [
        "data.dataset=synthetic", f"data.synthetic_size={args.size}",
        "data.batch_size=64", f"model.arch={args.arch}",
        "train.half_precision=false", "score.pretrain_epochs=0",
        "score.batch_size=64", f"score.method={args.method}",
        f"serve.replicas={args.replicas}", "serve.router_port=0",
        "serve.port=0", "serve.tenant=soak", "serve.coalesce_ms=2",
        "serve.warm=false", "serve.health_poll_s=0.25",
        "serve.breaker_reset_s=0.5", "serve.stats_every_s=2",
        "serve.dispatch_stall_s=1.0", "serve.request_timeout_s=120",
        # A wedged dispatcher can never finish its in-flight work, so a
        # tight drain bound turns the wedge recovery wall from
        # O(drain_timeout) into O(detection + respawn). The clean SIGTERM
        # drain is unaffected: it returns as soon as in-flight completes.
        # Soak cycles are forensics runs: retain every request trace so the
        # per-cycle attribution gate always has evidence to judge.
        "serve.trace_sample_frac=1.0",
        "serve.drain_timeout_s=5.0", "elastic.reap_timeout_s=20",
        f"elastic.max_restarts={args.max_restarts}", "elastic.backoff_s=0.2",
        f"serve.refresh_from={refresh_dir}",
        f"obs.metrics_path={os.path.join(cycle_dir, 'metrics.jsonl')}",
        f"obs.heartbeat_dir={os.path.join(cycle_dir, 'hb')}",
        f"train.checkpoint_dir={os.path.join(cycle_dir, 'ckpt')}",
    ]


def _run_tool(module: str, argv: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", f"data_diet_distributed_tpu_torch.tools.{module}", *argv],
        capture_output=True, text=True, timeout=60, env=_child_env({}))


def _monitor_once(metrics: str) -> tuple[int, dict]:
    proc = _run_tool("run_monitor", ["--metrics", metrics, "--once", "--json"])
    try:
        view = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        view = {"error": f"unparseable monitor output: {proc.stdout[-200:]}"}
    return proc.returncode, view


def _attribution(metrics: str) -> tuple[int, dict]:
    """``request_report --json`` over the cycle's stream: the exit code
    (2 = no serve_trace records — a cycle failure) plus the report."""
    proc = _run_tool("request_report", [metrics, "--json"])
    try:
        report = json.loads(proc.stdout)
    except ValueError:
        report = {"error": f"unparseable report output: {proc.stdout[-200:]}"}
    return proc.returncode, report


def kernel_launches(recs: list[dict]) -> dict[str, int]:
    """The launches by kernel of the processes that left a ``metrics``
    record in ``recs`` (each a process's total at its exit), summed."""
    out: dict[str, int] = {}
    for rec in recs:
        if rec.get("kind") != "metrics":
            continue
        for name, n in (rec.get("gauges") or {}).items():
            if name.startswith(_LAUNCH_GAUGE):
                kernel = name[len(_LAUNCH_GAUGE):]
                out[kernel] = out.get(kernel, 0) + int(n)
    return out


def timeline(recs: list[dict], marks: dict[str, float]) -> list[dict]:
    """The cycle's moments in seconds since the fleet's ``launch`` record:
    every ``replica_event``, ``autoscale_event`` and ``model_refresh``
    record, the first ``slo_violation``, the last request each partitioned
    replica answered before its quarantine (``dark``), and the tool's
    ``marks`` (name -> wall-clock time), in time order. Empty without a
    ``launch`` record."""
    t0 = next((r["ts"] for r in recs if r.get("kind") == "serve_fleet"
               and r.get("event") == "launch"), None)
    if t0 is None:
        return []
    out = [{"t_s": t, "what": name} for name, t in marks.items()]
    violation = False
    for i, rec in enumerate(recs):
        kind = rec.get("kind")
        if kind in _TIMELINE_KINDS:
            row = {"t_s": rec["ts"], "what": f"{kind}:{rec.get(_TIMELINE_KINDS[kind])}"}
            row.update({k: rec[k] for k in _TIMELINE_FIELDS if k in rec})
            out.append(row)
            if kind == "replica_event" and rec.get("event") == "partitioned":
                answered = [r["ts"] for r in recs[:i] if r.get("kind") == "serve_trace"
                            and r.get("where") == "replica"
                            and r.get("replica") == rec.get("replica")
                            and r.get("status") == 200]
                if answered:
                    out.append({"t_s": answered[-1], "what": "dark",
                                "replica": rec.get("replica")})
        elif kind == "slo_violation" and not violation:
            violation = True
            out.append({"t_s": rec["ts"], "what": f"slo_violation:{rec.get('slo')}",
                        "value": rec.get("value"), "threshold": rec.get("threshold")})
    for row in out:
        row["t_s"] = round(row["t_s"] - t0, 3)
    return sorted(out, key=lambda row: row["t_s"])


def _forensics(fault: str, recs: list[dict], rc: int,
               refresh_verdicts: dict) -> list[str]:
    """Fault-specific record checks; each miss is one problem string."""
    problems = []
    rep = [r for r in recs if r.get("kind") == "replica_event"]
    refresh = [r for r in recs if r.get("kind") == "model_refresh"]
    events = {r.get("event") for r in rep}
    if fault == "kill":
        if not any(r.get("event") == "died" and r.get("signal")
                   for r in rep):
            problems.append("kill: no replica_event died-by-signal record")
        if "respawn" not in events:
            problems.append("kill: no replica_event respawn record")
    elif fault == "wedge":
        for want in ("wedged", "wedged_reaped", "respawn"):
            if want not in events:
                problems.append(f"wedge: no replica_event {want} record")
    elif fault == "refresh":
        if not any(r.get("status") == "rejected" for r in refresh):
            problems.append("refresh: torn step never digest-rejected")
        if not any(r.get("status") == "roll_complete" for r in refresh):
            problems.append("refresh: no roll_complete record")
        installed = [r for r in refresh if r.get("status") == "installed"]
        if len(installed) < refresh_verdicts.get("replicas", 2):
            problems.append(f"refresh: only {len(installed)} installs "
                            "— roll did not reach every replica")
        if not refresh_verdicts.get("corrupt_rejected"):
            problems.append("refresh: client saw the torn refresh succeed")
        if refresh_verdicts.get("roll", {}).get("status") != "rolled":
            problems.append(f"refresh: good roll did not complete: "
                            f"{refresh_verdicts.get('roll')}")
        if refresh_verdicts.get("min_available", 0) < 1:
            problems.append("refresh: capacity hit zero during the roll")
    elif fault == "partition":
        # A partition is NOT a death: the supervisor must quarantine +
        # probe + reconnect, never respawn, and spend zero restart budget.
        for want in ("partitioned", "probation_probe", "reconnected"):
            if want not in events:
                problems.append(f"partition: no replica_event {want} record")
        for never in ("respawn", "died"):
            if never in events:
                problems.append(f"partition: saw replica_event {never} — "
                                "partition was mistaken for a death")
        recon = [r for r in rep if r.get("event") == "reconnected"]
        budget = refresh_verdicts.get("max_restarts")
        if recon and recon[-1].get("restarts_left") != budget:
            problems.append(
                f"partition: restart budget was spent "
                f"({recon[-1].get('restarts_left')} left of {budget})")
    elif fault == "autoscale":
        asc = [r for r in recs if r.get("kind") == "autoscale_event"]
        ups = [r for r in asc if r.get("action") == "scale_up"]
        downs = [r for r in asc if r.get("action") == "scale_down"]
        if not ups:
            problems.append("autoscale: no scale_up decision")
        else:
            up = ups[0]
            if not up.get("reasons") or not (up.get("evidence") or
                                             {}).get("p95_ms"):
                problems.append("autoscale: scale_up names no evidence")
            if up.get("replicas_to", 99) > (up.get("max_replicas") or 0):
                problems.append("autoscale: grew past max_replicas")
        if not downs:
            problems.append("autoscale: no scale_down decision")
        elif downs[-1].get("replicas_to", -1) < (downs[-1].get(
                "min_replicas") or 0):
            problems.append("autoscale: shrank below min_replicas")
        if not any(r.get("event") == "spawn"
                   and r.get("cause") == "autoscale" for r in rep):
            problems.append("autoscale: no autoscale-caused spawn record")
        if not any(r.get("event") == "retired"
                   and r.get("cause") == "autoscale" for r in rep):
            problems.append("autoscale: no autoscale-caused retire record")
    elif fault == "canary":
        if not any(r.get("status") == "roll_complete" for r in refresh):
            problems.append("canary: live run's step never rolled")
        rolled_back = [r for r in refresh
                       if r.get("status") == "rolled_back"]
        if not rolled_back:
            problems.append("canary: regressed step was never rolled back")
        elif not (rolled_back[-1].get("canary") or {}).get("reasons"):
            problems.append("canary: rollback record carries no canary "
                            "evidence")
        if any(r.get("status") == "roll_complete"
               and r.get("step") == refresh_verdicts.get("regressed_step")
               for r in refresh):
            problems.append("canary: the regressed step reached the fleet")
        if not refresh_verdicts.get("bit_identical"):
            problems.append("canary: post-rollback scores differ from the "
                            "pre-regression baseline")
    if fault == "sigterm" or rc is not None:
        # Every cycle ends in SIGTERM; the preemption contract always holds.
        if rc != 75:
            problems.append(f"fleet exit {rc}, want 75 (preempted)")
        summaries = [r for r in recs if r.get("kind") == "run_summary"]
        if not summaries or summaries[-1].get("exit_class") != "preempted":
            problems.append("terminal run_summary is not exit_class=preempted")
    return problems


def run_cycle(args, index: int, fault: str, refresh_dir: str,
              workdir: str, cfg) -> dict:
    from . import serve_client as sc
    from .validate_metrics import validate_file

    cycle_dir = os.path.join(workdir, f"cycle{index}_{fault}")
    os.makedirs(cycle_dir, exist_ok=True)
    metrics = os.path.join(cycle_dir, "metrics.jsonl")
    sup_log = os.path.join(cycle_dir, "supervisor.log")
    watch_dir = os.path.join(cycle_dir, "live_ckpt")
    env = {k: v for k, v in _child_env({}).items()
           if k not in ("DDT_FAULT_PLAN", "DDT_SERVE_REPLICA")}
    plan = FAULTS[fault]
    if plan is not None:
        env["DDT_FAULT_PLAN"] = json.dumps(plan)
    t0 = time.perf_counter()
    with open(sup_log, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "serve",
             "--device", args.device,
             *_cycle_overrides(args, cycle_dir, refresh_dir),
             *_fault_overrides(fault, cycle_dir)],
            env=env, cwd=cycle_dir, stdout=log, stderr=subprocess.STDOUT)
    verdict = {"cycle": index, "fault": fault}
    refresh_verdicts = {"replicas": args.replicas,
                        "max_restarts": args.max_restarts}
    rc = None
    train_proc = None
    marks: dict[str, float] = {}
    grown = threading.Event()   # ends the autoscale cycle's growth watch
    try:
        port = None
        deadline = time.monotonic() + args.boot_timeout
        while port is None and time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError("fleet died during boot: " + _tail(sup_log))
            time.sleep(0.25)
            for rec in _stream_recs(metrics):
                if rec.get("kind") == "serve_fleet" \
                        and rec.get("event") == "launch":
                    port = rec["router_port"]
        if port is None:
            raise RuntimeError("fleet never published its router port")
        url = f"http://127.0.0.1:{port}"
        probe = sc.ServeClient(url, timeout_s=10.0)
        client = sc.ServeClient(url, timeout_s=300.0, retries=6,
                                backoff_s=0.25)

        def wait_available(n, budget_s):
            stop_at = time.monotonic() + budget_s
            seen = None
            while time.monotonic() < stop_at:
                if proc.poll() is not None:
                    raise RuntimeError("fleet died mid-cycle: " + _tail(sup_log))
                try:
                    seen = probe.healthz()
                except sc.ServeError:
                    seen = None
                if seen and seen.get("available") == n:
                    return
                time.sleep(0.25)
            raise RuntimeError(f"never reached {n} available: {seen}")

        def wait_for_record(pred, what, budget_s):
            stop_at = time.monotonic() + budget_s
            while time.monotonic() < stop_at:
                if proc.poll() is not None:
                    raise RuntimeError("fleet died mid-cycle: " + _tail(sup_log))
                hits = [r for r in _stream_recs(metrics) if pred(r)]
                if hits:
                    return hits[-1]
                time.sleep(0.5)
            raise RuntimeError(f"never saw {what} in the stream")

        burst_loads: list[dict] = []
        verdict["burst_loads"] = burst_loads

        def burst_until(pred, what, budget_s):
            """Short load bursts until the stream shows ``pred`` — the
            canary hold judges ROUTED traffic, so the wait must drive
            some."""
            stop_at = time.monotonic() + budget_s
            while time.monotonic() < stop_at:
                if proc.poll() is not None:
                    raise RuntimeError("fleet died mid-cycle: " + _tail(sup_log))
                hits = [r for r in _stream_recs(metrics) if pred(r)]
                if hits:
                    return hits[-1]
                burst_loads.append(sc.load_generate(
                    url, rps=args.rps, duration_s=2.0, batch=8,
                    max_index=args.size - 1, timeout_s=120, retries=6,
                    backoff_s=0.25))
            raise RuntimeError(f"never saw {what} under load")

        if fault == "canary":
            # The live training run this fleet's refresh watcher follows.
            train_proc = _launch_train(args, cycle_dir, watch_dir, env)
        wait_available(args.replicas, args.boot_timeout)
        marks["available"] = time.time()
        if fault == "autoscale":
            # The moment the grown replica first answers through the
            # router, watched without blocking: it may be retired again
            # before a blocking wait would look.
            def watch_growth():
                while not grown.is_set():
                    try:
                        if probe.healthz().get("available", 0) > args.replicas:
                            marks.setdefault("grown_routable", time.time())
                    except sc.ServeError:
                        pass
                    time.sleep(0.1)

            threading.Thread(target=watch_growth, daemon=True).start()
        # Open-loop load through the router — the fault (if any) fires
        # under it, and the bar is zero client-visible failures.
        verdict["load"] = sc.load_generate(
            url, rps=args.rps, duration_s=args.duration, batch=8,
            max_index=args.size - 1, timeout_s=120, retries=6,
            backoff_s=0.25)
        marks["load_done"] = time.time()
        if fault in ("kill", "wedge", "partition"):
            # kill/wedge: the casualty must respawn. partition: the
            # quarantined replica must RECONNECT (no respawn — the
            # forensics hold the budget to account).
            wait_available(args.replicas, args.respawn_timeout)
            marks["recovered"] = time.time()
        elif fault == "autoscale":
            # The slow replica's sustained pressure fires the scale-up
            # under the load window; the post-load idle (once the grown
            # replica is routable — the N-1 discipline defers the drain
            # until then) fires the scale-down.
            wait_for_record(
                lambda r: (r.get("kind") == "autoscale_event"
                           and r.get("action") == "scale_up"),
                "autoscale_event scale_up", 60)
            wait_for_record(
                lambda r: (r.get("kind") == "autoscale_event"
                           and r.get("action") == "scale_down"),
                "autoscale_event scale_down", args.respawn_timeout)
            grown.set()
            wait_available(args.replicas, args.respawn_timeout)
            marks["recovered"] = time.time()
        elif fault == "canary":
            t_rc = train_proc.wait(timeout=600)
            if t_rc != 0:
                raise RuntimeError("live training run failed: "
                                   + _tail(os.path.join(cycle_dir, "train.log")))
            from ..serve.fleet import discover_steps
            final_step = max(discover_steps(watch_dir))
            refresh_verdicts["live_final_step"] = final_step
            # The run's newest promoted step rolls to the FULL fleet (the
            # good model is fast, so its canary window passes).
            burst_until(
                lambda r: (r.get("kind") == "model_refresh"
                           and r.get("status") == "roll_complete"
                           and r.get("step") == final_step),
                f"roll_complete of live step {final_step}", 120)
            baseline = client.score(indices=list(range(16)))["scores"]
            # The regressed model: digest-valid, genuinely different
            # weights, slow only when the canary SERVES it. It must die at
            # the canary stage, under live traffic.
            refresh_verdicts["regressed_step"] = REGRESSED_STEP
            _make_regressed_ckpt(cfg, watch_dir)
            rb = burst_until(
                lambda r: (r.get("kind") == "model_refresh"
                           and r.get("status") == "rolled_back"),
                "rolled_back", 120)
            refresh_verdicts["rollback_record"] = {
                "step": rb.get("step"), "canary": rb.get("canary"),
                "prior": rb.get("prior")}
            after = client.score(indices=list(range(16)))["scores"]
            refresh_verdicts["bit_identical"] = after == baseline
        elif fault == "refresh":
            # Torn step 20 is the newest — a stepless refresh must be
            # rejected digest-loudly while the old model keeps serving.
            try:
                client.refresh()
                refresh_verdicts["corrupt_rejected"] = False
            except sc.ServeError as err:
                refresh_verdicts["corrupt_rejected"] = err.status in (409,
                                                                      502)
            # The good step, rolled one replica at a time under hammer
            # load; capacity (router-available replicas) must never be 0.
            stop = threading.Event()
            avail_seen: list[int] = []

            def watch():
                while not stop.is_set():
                    try:
                        avail_seen.append(probe.healthz().get("available"))
                    except sc.ServeError:
                        pass
                    time.sleep(0.05)

            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            hammer = threading.Thread(
                target=lambda: verdict.__setitem__(
                    "roll_load", sc.load_generate(
                        url, rps=args.rps, duration_s=3.0, batch=8,
                        max_index=args.size - 1, timeout_s=120,
                        retries=6, backoff_s=0.25)),
                daemon=True)
            hammer.start()
            try:
                refresh_verdicts["roll"] = client.refresh(step=10)
            finally:
                hammer.join(timeout=120)
                stop.set()
                watcher.join(timeout=10)
            refresh_verdicts["min_available"] = min(
                [a for a in avail_seen if a is not None], default=0)
        marks["sigterm"] = time.time()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    except Exception as err:   # the cycle verdict carries the failure
        verdict["error"] = f"{type(err).__name__}: {err}"
    finally:
        grown.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if train_proc is not None and train_proc.poll() is None:
            train_proc.kill()
            train_proc.wait(timeout=30)
        if rc is None:
            rc = proc.returncode
    recs = _stream_recs(metrics)
    monitor_exit, view = _monitor_once(metrics)
    summary = view.get("run_summary") or {}
    try:
        stream_problems = validate_file(metrics)
    except OSError as err:
        stream_problems = [f"{metrics}: unreadable ({err})"]
    problems = list(verdict.get("error") and [verdict["error"]] or [])
    loads = [verdict.get("load") or {}, verdict.get("roll_load") or {},
             *(verdict.get("burst_loads") or [])]
    sent = sum(ld.get("sent", 0) for ld in loads)
    errors = sum(ld.get("errors", 0) for ld in loads)
    rejected = sum(ld.get("rejected", 0) for ld in loads)
    if sent == 0:
        problems.append("no load reached the router")
    if errors or rejected:
        problems.append(f"client-visible failures: {errors} errors, "
                        f"{rejected} rejected of {sent}")
    if monitor_exit not in MONITOR_OK.get(fault, (0,)):
        problems.append(f"run_monitor --once exit {monitor_exit}, want one "
                        f"of {MONITOR_OK.get(fault, (0,))}")
    problems += [f"stream: {p}" for p in stream_problems[:5]]
    problems += _forensics(fault, recs, rc, refresh_verdicts)
    # Request-observatory contract: the cycle must leave attributable
    # traces — request_report exits 2 on a traceless stream, nonzero on
    # any failure to attribute.
    n_traces = sum(r.get("kind") == "serve_trace" for r in recs)
    attr_exit, attr = _attribution(metrics)
    if attr_exit != 0:
        problems.append(f"request_report exit {attr_exit} over the stream "
                        f"({n_traces} serve_trace record(s))")
    verdict.update(
        rc=rc, wall_s=round(time.perf_counter() - t0, 1),
        requests=sent, errors=errors, rejected=rejected,
        monitor_exit=monitor_exit, exit_class=summary.get("exit_class"),
        slo=summary.get("slo"), refresh=refresh_verdicts,
        p95_ms=(verdict.get("load") or {}).get("p95_ms"),
        traces=n_traces,
        dominant_phase=(attr.get("tail") or {}).get("dominant_phase"),
        kernel_launches=kernel_launches(recs),
        timeline=timeline(recs, marks),
        problems=problems, ok=not problems)
    # Load reports are bulky; the verdict keys above carry what the
    # soak_report needs.
    verdict.pop("load", None)
    verdict.pop("roll_load", None)
    verdict.pop("burst_loads", None)
    return verdict


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m data_diet_distributed_tpu_torch.tools.serve_soak",
        description="Serve-fleet fault soak: one fault a cycle, zero "
                    "client-visible failures")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="the fleet's and the live training run's --device "
                             "(cuda: no fallback)")
    parser.add_argument("--smoke", action="store_true",
                        help="the bounded lane: the default schedule at the "
                             "CPU-sized defaults (the device is --device's)")
    parser.add_argument("--workdir", default="/tmp/ddt_serve_soak")
    parser.add_argument("--schedule", default=None,
                        help=f"comma-separated fault cycles from "
                             f"{sorted(FAULTS)} (default: {SCHEDULE})")
    parser.add_argument("--cycles", type=int, default=None,
                        help="total cycles (schedule repeats); default: one "
                             "pass over the schedule")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--rps", type=float, default=12.0)
    parser.add_argument("--duration", type=float, default=6.0,
                        help="per-cycle load seconds")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--arch", default="tiny_cnn")
    parser.add_argument("--method", default="el2n")
    parser.add_argument("--max-restarts", type=int, default=4)
    parser.add_argument("--boot-timeout", type=float, default=240.0)
    parser.add_argument("--respawn-timeout", type=float, default=240.0)
    parser.add_argument("--quiet", action="store_true")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    err = device_error(args.device)
    if err:
        raise SystemExit(err)
    schedule = [f.strip() for f in (args.schedule or SCHEDULE).split(",")
                if f.strip()]
    unknown = [f for f in schedule if f not in FAULTS]
    if unknown:
        raise SystemExit(f"unknown fault(s) {unknown}; known: "
                         f"{sorted(FAULTS)}")
    if args.cycles:
        schedule = (schedule * args.cycles)[: args.cycles]

    from ..config import load_config
    from ..resilience.elastic import JsonlLogger
    os.makedirs(args.workdir, exist_ok=True)
    refresh_dir = os.path.join(args.workdir, "refresh_ck")
    # One shared refresh checkpoint dir (good step 10 + torn step 20),
    # built with the SAME model geometry the cycles serve.
    cfg = load_config(None, _cycle_overrides(args, args.workdir,
                                             refresh_dir))
    _make_refresh_ckpt(cfg, refresh_dir)

    soak_log = JsonlLogger(os.path.join(args.workdir, "soak.jsonl"),
                             echo=not args.quiet)
    t0 = time.perf_counter()
    cycles = []
    for i, fault in enumerate(schedule):
        verdict = run_cycle(args, i, fault, refresh_dir, args.workdir, cfg)
        cycles.append(verdict)
        soak_log.log("elastic_event", event="soak_cycle", **verdict)
    ok = bool(cycles) and all(c["ok"] for c in cycles)
    report = {
        "cycles": len(cycles), "ok": ok,
        "faults": [c["fault"] for c in cycles],
        "passed": sum(c["ok"] for c in cycles),
        "monitor_exits": [c["monitor_exit"] for c in cycles],
        "cycle_wall_s": [c["wall_s"] for c in cycles],
        "p95_ms": [c["p95_ms"] for c in cycles],
        "replicas": args.replicas, "smoke": bool(args.smoke),
        "wall_s": round(time.perf_counter() - t0, 1),
        "per_cycle": cycles,
    }
    soak_log.log("soak_report", **report)
    soak_log.close()
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
