"""ServeFleet: a replicated serve pod with bounded-restart supervision (copy
of ``data_diet_distributed_tpu/serve/fleet.py``).

``serve.replicas > 1`` (or ``serve.max_replicas``) turns ``cli serve`` into
this supervisor: N serve replicas as child processes (``python -m
data_diet_distributed_tpu_torch.cli serve`` with the supervisor's
``--device``, each its own CUDA context and port, each knowing its index via
``DDT_SERVE_REPLICA``), fronted by the health-aware router (``router.py``) —
the one address clients keep while replicas die, wedge, and come back. The
supervisor never touches CUDA: on one card the replicas share it and own it.

The machinery is the elastic pod's (``resilience/elastic.py``), re-aimed at
serving: the same ``RestartBudget`` bounds respawns with exponential
backoff, the same ``classify_rc`` names exits, the same ``JsonlLogger``
lands every decision in the run's metrics JSONL — as
``{"kind": "serve_fleet"}`` (fleet lifecycle) and ``{"kind":
"replica_event"}`` (per-replica deaths/wedges/respawns) records the
postmortem timeline and ``run_monitor`` replay. Unlike the elastic
supervisor, replicas are independent (no collective to tear), so one
death never restarts the others — the router routes around it while the
supervisor respawns it in place, on the SAME port (clients of the router
never see the churn).

Failure paths:

* **replica death** (SIGKILL, OOM, crash): the supervision loop sees the
  exit, the router's in-flight requests fail over to the survivors
  (idempotent replay), and the replica respawns on its port — budgeted.
* **wedged replica**: a dispatch in flight past ``serve.dispatch_stall_s``
  makes the replica's own /healthz critical; the health poller stops
  routing there, SIGTERMs it (bounded by ``elastic.reap_timeout_s``, then
  SIGKILL), and respawns it.
* **fleet SIGTERM**: admission stops at the router, replicas drain
  (their own SIGTERM contract), and the fleet exits 75 — the same
  preemption vocabulary as every other command.

* **network partition** (process alive, endpoint unreachable): NOT a
  death — after ``serve.partition_after_misses`` consecutive unreachable
  health polls on a previously-healthy replica, the supervisor puts it on
  probation (quarantined behind the router's breaker, re-probed with
  doubling backoff bounded by ``serve.probe_backoff_max_s``) instead of
  burning restart budget on a process that is fine. Reconnect clears the
  quarantine. Partition / probation probes / reconnect are first-class
  ``replica_event`` records.

Zero-downtime refresh: ``POST /v1/refresh`` at the router (or the
``serve.refresh_poll_s`` watcher here) rolls the new checkpoint across
replicas ONE at a time; each installs atomically between dispatches
(``ServeService.refresh``), so capacity never drops and every response is
bit-identical to exactly one of {old, new}. With ``serve.canary_requests``
set the roll is canary-first (``router.roll_refresh_direct``): the first
replica holds under live traffic and a regression rolls it back to the
prior model. The watcher follows a live training run's promotion stream
(``discover_steps`` over the run's checkpoint dir) and never re-attempts a
step whose roll was rejected or rolled back.

Cross-host placement: ``serve.hosts`` + ``serve.remote_launch`` route a
slot's spawn through a command template (the same worker-launch plumbing
``tests/multihost_worker.py`` uses) — see ``_spawn_remote``. The launcher
process is supervised exactly like a local child.

Elasticity: setting ``serve.max_replicas`` arms the ``Autoscaler`` — a
control loop on the stats cadence reading the same signals
``check_fleet``/``check_serve`` judge (router tick p95, summed replica
queue depth, reject fraction, routable fraction) and growing/shrinking
the replica table within ``[serve.min_replicas, serve.max_replicas]``
with hysteresis + cooldown. Every decision is an ``autoscale_event``
record carrying its evidence. Scale-down retires the highest slot
(tombstoned, never removed — routing state is positional) and only while
every OTHER active replica is routable, so capacity never drops below
N-1 during the drain.

Tuning roll: with ``serve.refresh_poll_s`` set and ``tuning.apply`` not
``off``, the supervisor watches the signed tuning manifest's digest
(``tuning.py``) and, when it changes, respawns the replicas one at a time
(budget-free); each new replica applies the manifest in its own CLI startup
hook.

All lineage stays at attempt 0: replica respawns are tracked by their own
generation counter, not lineage attempts — a serving fleet's churn is
steady-state, not a run-level recovery chain.
"""

from __future__ import annotations

import json
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

from ..checkpoint import restorable_steps as discover_steps
from ..obs import lineage
from ..obs import reqtrace
from ..obs.slo import SloEngine
from ..resilience.elastic import (EXIT_PREEMPTED, JsonlLogger, RestartBudget,
                                  classify_rc, free_port)
from .router import Replica, ServeRouter

#: A serve child's fleet index — set by the supervisor, read by the fault
#: injector (replica-targeted plans) and the replica's own stats records.
REPLICA_ENV = "DDT_SERVE_REPLICA"


def fleet_dir(checkpoint_dir: str) -> str:
    """Fleet control-plane directory (child logs, per-replica heartbeat
    roots), sibling of the checkpoint dir like ``_elastic``."""
    return f"{checkpoint_dir}_fleet"


class Autoscaler:
    """Hysteresis'd scale decisions from the fleet's SLO signals.

    Pure decision logic — ``evaluate`` consumes one stats-tick evidence
    dict and returns ``{"action": "scale_up"|"scale_down"|"at_max",
    "reasons": [...]}`` or None; the fleet executes decisions and emits
    the ``autoscale_event`` records. Keeping it stateful-but-pure makes
    the hysteresis pinnable by unit test without booting a fleet.

    Evidence keys (any may be None = unknown): ``p95_ms`` (router tick
    p95), ``requests`` (routed this tick), ``queue_depth`` (summed over
    replicas), ``reject_frac`` (this tick's rejected fraction). Floors
    are the SAME objectives ``check_fleet``/``check_serve`` judge —
    pressure here and an slo_violation record are two views of one fact.

    Hysteresis: ``up_after`` consecutive violating ticks to scale up,
    ``down_after`` consecutive headroom ticks to scale down, ``cooldown_s``
    between any two actions. Steady load that neither violates nor shows
    headroom resets both counters — no flapping.
    """

    def __init__(self, *, min_replicas: int, max_replicas: int,
                 up_after: int, down_after: int, cooldown_s: float,
                 p95_floor_ms: float | None = None,
                 queue_floor: int | None = None,
                 reject_frac_floor: float | None = None):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_after = max(1, int(up_after))
        self.down_after = max(1, int(down_after))
        self.cooldown_s = float(cooldown_s)
        self.p95_floor_ms = p95_floor_ms
        self.queue_floor = queue_floor
        self.reject_frac_floor = reject_frac_floor
        self._hot = 0       # consecutive violating ticks
        self._cold = 0      # consecutive headroom ticks
        self._last_action_mono: float | None = None

    def pressure(self, ev: dict) -> list[str]:
        """The tick's SLO-floor violations, named (empty = none)."""
        reasons: list[str] = []
        if (self.p95_floor_ms is not None and ev.get("p95_ms") is not None
                and ev["p95_ms"] > self.p95_floor_ms):
            reasons.append(f"tick p95 {ev['p95_ms']:.1f}ms > "
                           f"slo_fleet_p95_ms={self.p95_floor_ms:g}")
        if (self.queue_floor is not None
                and ev.get("queue_depth") is not None
                and ev["queue_depth"] > self.queue_floor):
            reasons.append(f"queue depth {ev['queue_depth']} > "
                           f"slo_serve_queue_depth={self.queue_floor}")
        if (self.reject_frac_floor is not None and ev.get("reject_frac")
                and ev["reject_frac"] > self.reject_frac_floor):
            reasons.append(f"reject frac {ev['reject_frac']:.3f} > "
                           f"slo_serve_reject_frac="
                           f"{self.reject_frac_floor:g}")
        return reasons

    def headroom(self, ev: dict) -> bool:
        """True when the tick shows spare capacity: no pressure, empty
        queues, no rejects, and either no traffic at all or a p95
        comfortably under half the floor."""
        if self.pressure(ev):
            return False
        if ev.get("queue_depth") or ev.get("reject_frac"):
            return False
        if not ev.get("requests"):
            return True
        if self.p95_floor_ms is not None and ev.get("p95_ms") is not None:
            return ev["p95_ms"] <= 0.5 * self.p95_floor_ms
        return False

    def evaluate(self, *, now: float, replicas: int, routable: int,
                 ev: dict) -> dict | None:
        reasons = self.pressure(ev)
        if reasons:
            self._hot += 1
            self._cold = 0
        elif self.headroom(ev):
            self._cold += 1
            self._hot = 0
        else:
            self._hot = 0
            self._cold = 0
        if (self._last_action_mono is not None
                and now - self._last_action_mono < self.cooldown_s):
            return None
        if self._hot >= self.up_after:
            self._hot = 0
            if replicas >= self.max_replicas:
                # At the bound under sustained pressure: surface it (once
                # per sustained episode) — an operator decision, not ours.
                return {"action": "at_max", "reasons": reasons}
            self._last_action_mono = now
            return {"action": "scale_up", "reasons": reasons}
        if self._cold >= self.down_after:
            self._cold = 0
            if replicas <= self.min_replicas:
                return None   # idle at the floor is simply fine
            if routable < replicas:
                # Never start a drain while another replica is unroutable:
                # the N-1 capacity discipline during scale-down.
                return None
            self._last_action_mono = now
            return {"action": "scale_down",
                    "reasons": [f"sustained headroom "
                                f"({self.down_after} idle ticks)"]}
        return None


class ServeFleet:
    """Bounded-restart supervisor over N serve replicas + the router.

    ``spawn(index, generation)`` (injectable for tests) must return a
    ``subprocess.Popen``-like object; ``fault_env(index, generation)``
    returns extra child environment — generation-0 children inherit the
    operator's ``DDT_FAULT_PLAN``, respawns never do (a replica-killing
    plan re-arming on every respawn would burn the budget on one fault).
    ``device`` is the supervisor's ``--device``, passed to every replica.
    """

    def __init__(self, cfg, *, config_path: str | None = None,
                 overrides: list[str] | None = None, logger=None,
                 spawn=None, fault_env=None, device: str | None = None):
        self.cfg = cfg
        self.config_path = config_path
        self.overrides = list(overrides or [])
        self.device = device
        self.logger = logger
        self._spawn = spawn or self._spawn_backend
        self._fault_env = fault_env
        sv = cfg.serve
        self.n = int(sv.replicas)
        self.budget = RestartBudget(int(cfg.elastic.max_restarts),
                                    float(cfg.elastic.backoff_s))
        self.reap_timeout_s = float(cfg.elastic.reap_timeout_s)
        self.run_id = (os.environ.get(lineage.RUN_ID_ENV)
                       or lineage.new_run_id())
        self._lineage = lineage.install(
            lineage.Lineage(run_id=self.run_id, attempt=0))
        self.log_dir = fleet_dir(cfg.train.checkpoint_dir)
        # One port per replica slot, picked once and REUSED across respawns:
        # a slot's routing entry never changes, so a respawn is invisible
        # to routing the moment the replica's /healthz answers. (Ports are
        # picked on the SUPERVISOR — a remote placement assumes the range
        # is free on its host too, the standard template-launch contract.)
        self.ports = [free_port() for _ in range(self.n)]
        self.slot_hosts = [self._host_for(i) or sv.host
                           for i in range(self.n)]
        self.replicas = [Replica(i, self.slot_hosts[i], p,
                                 breaker_failures=sv.breaker_failures,
                                 breaker_reset_s=sv.breaker_reset_s)
                         for i, p in enumerate(self.ports)]
        self.router = ServeRouter(
            self.replicas, host=sv.host, port=int(sv.router_port),
            retries=int(sv.route_retries), hedge_ms=sv.hedge_ms,
            # Router deadline strictly wider than the replicas' own
            # request bound: a slow-but-legal dispatch must time out THERE
            # (429/504 from the replica), never as a router transport kill.
            timeout_s=float(sv.request_timeout_s) + 5.0,
            idem_cache=int(sv.idempotency_cache),
            retry_after_s=float(sv.retry_after_s), logger=logger,
            canary_requests=sv.canary_requests,
            canary_timeout_s=float(sv.canary_timeout_s),
            # The canary's floors ARE the fleet SLOs (obs/slo.judge_canary).
            canary_p95_floor_ms=cfg.obs.slo_fleet_p95_ms,
            canary_error_frac=cfg.obs.slo_serve_reject_frac,
            # Request tracing: same sampling fraction and slow threshold
            # the replicas resolve, so both edges keep/drop in agreement.
            trace_sample_frac=sv.trace_sample_frac,
            trace_slow_ms=reqtrace.slow_threshold_ms(cfg))
        self.procs: list = [None] * self.n
        self.gens = [0] * self.n
        self.events: list[dict] = []
        self.slo = SloEngine.from_cfg(cfg, logger=logger)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._preempted = False
        self._give_up = False
        self._threads: list[threading.Thread] = []
        self._stats_seq = 0
        # Partition probation (per slot): consecutive unreachable polls on
        # an alive process, whether this generation ever answered /healthz
        # (boot is not a partition), and the probation ledger
        # {index: {"since", "backoff", "next_probe", "probes"}}.
        self._misses = [0] * self.n
        self._seen_healthy = [False] * self.n
        self._probation: dict[int, dict] = {}
        # Autoscaler (armed by serve.max_replicas) + scale bookkeeping.
        self.min_replicas = self.max_replicas = None
        self.autoscaler: Autoscaler | None = None
        if sv.max_replicas is not None:
            self.min_replicas = int(sv.min_replicas
                                    if sv.min_replicas is not None
                                    else sv.replicas)
            self.max_replicas = int(sv.max_replicas)
            self.autoscaler = Autoscaler(
                min_replicas=self.min_replicas,
                max_replicas=self.max_replicas,
                up_after=int(sv.scale_up_after),
                down_after=int(sv.scale_down_after),
                cooldown_s=float(sv.scale_cooldown_s),
                p95_floor_ms=cfg.obs.slo_fleet_p95_ms,
                queue_floor=cfg.obs.slo_serve_queue_depth,
                reject_frac_floor=cfg.obs.slo_serve_reject_frac)
        self._retiring: set[int] = set()
        self._last_load = (0, 0)   # (accepted, rejected) at last stats tick
        # Supervisor self-monitoring: threads already reported dead.
        self._dead_threads: set[str] = set()
        # Tuning roll: how long a freshly rolled replica gets to answer
        # /healthz before the roll aborts (generous: the child recompiles).
        self.tuning_roll_wait_s = max(60.0, float(sv.canary_timeout_s) * 2)

    # ------------------------------------------------------------- records

    def _event(self, event: str, **fields) -> None:
        rec = {"event": event, "replicas": self.n, **fields}
        self.events.append(rec)
        if self.logger is not None:
            self.logger.log("serve_fleet", **rec)

    def _replica_event(self, index: int | None, event: str,
                       **fields) -> None:
        if self.logger is not None:
            self.logger.log("replica_event", replica=index, event=event,
                            **fields)

    # ------------------------------------------------------------- spawning

    def _host_for(self, index: int) -> str | None:
        """The slot's remote host (serve.hosts wraps round-robin), or None
        for the local backend (hosts empty)."""
        hosts = self.cfg.serve.hosts
        if not hosts:
            return None
        return hosts[index % len(hosts)]

    def _child_argv(self, index: int) -> list[str]:
        argv = [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli",
                "serve"]
        if self.config_path:
            argv += ["--config", self.config_path]
        if self.device is not None:
            argv += ["--device", self.device]
        argv += self.overrides
        # Appended LAST so the fleet's geometry wins over the operator's:
        # one replica per child (no recursion), its own port/bind-host and
        # heartbeat root (replicas are all rank 0 — a shared heartbeat file
        # would make them overwrite each other), refresh rolled by the
        # FLEET (a per-replica watcher racing the roll could tear the
        # one-at-a-time discipline), and no elastic supervision inside.
        # A remote slot binds its own host — the address the router dials.
        argv += [f"serve.port={self.ports[index]}",
                 f"serve.host={self.slot_hosts[index]}",
                 "serve.replicas=1",
                 # Autoscaling is the FLEET's loop; a child is one fixed
                 # replica (and the operator's bounds would fail its
                 # replicas=1 validation).
                 "serve.min_replicas=null", "serve.max_replicas=null",
                 "serve.refresh_poll_s=null",
                 "elastic.enabled=false",
                 f"obs.heartbeat_dir={os.path.join(self.log_dir, f'hb_r{index}')}"]
        return argv

    def _child_env(self, index: int, generation: int) -> dict:
        """The env block a replica child runs under (local: the whole
        supervisor env + these; remote: these ride the launch argv)."""
        env = dict(os.environ)
        env[REPLICA_ENV] = str(index)
        # Lineage attempt stays 0 (see module docstring); world = fleet size.
        env.update(lineage.child_env(self.run_id, 0, self.n))
        if generation > 0:
            env.pop("DDT_FAULT_PLAN", None)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        if self._fault_env is not None:
            env.update(self._fault_env(index, generation) or {})
        return env

    def _open_log(self, index: int, generation: int):
        os.makedirs(self.log_dir, exist_ok=True)
        log_path = os.path.join(self.log_dir,
                                f"replica{index}_g{generation}.log")
        return log_path, open(log_path, "ab")

    def _spawn_backend(self, index: int, generation: int):
        """Default spawn: local fork, or the remote-launch template when
        the slot has a ``serve.hosts`` placement."""
        host = self._host_for(index)
        if host is None:
            return self._spawn_local(index, generation)
        return self._spawn_remote(index, generation, host)

    def _spawn_local(self, index: int, generation: int):
        env = self._child_env(index, generation)
        log_path, log_fh = self._open_log(index, generation)
        proc = subprocess.Popen(self._child_argv(index), stdout=log_fh,
                                stderr=subprocess.STDOUT, env=env)
        proc._ddt_log_path = log_path       # type: ignore[attr-defined]
        proc._ddt_log_fh = log_fh           # type: ignore[attr-defined]
        return proc

    #: Env the remote launch carries onto the host (everything else is the
    #: host's own login environment, ssh semantics). The fleet's identity
    #: vars, the fault plan (generation 0 only — _child_env strips it for
    #: respawns), the card selection, and the thread pin the CPU drills
    #: rely on.
    REMOTE_CARRIED_ENV = (REPLICA_ENV, "DDT_FAULT_PLAN", "PYTHONPATH",
                          "CUDA_VISIBLE_DEVICES", "OMP_NUM_THREADS",
                          lineage.RUN_ID_ENV, lineage.ATTEMPT_ENV,
                          lineage.WORLD_ENV)

    def _remote_argv(self, index: int, generation: int,
                     host: str) -> list[str]:
        """The RemoteReplicaBackend launch line: the ``serve.remote_launch``
        template (formatted with {host}) yields the argv prefix that
        executes a command on the host — the same worker-launch plumbing
        ``tests/multihost_worker.py`` uses — and the child's argv rides
        behind it with its carried env as ``env K=V ...`` tokens."""
        prefix = shlex.split(
            self.cfg.serve.remote_launch.format(host=host))
        env = self._child_env(index, generation)
        carried = [f"{k}={env[k]}" for k in self.REMOTE_CARRIED_ENV
                   if env.get(k) is not None]
        # A respawn must not re-arm the operator's fault plan. The carried
        # env already omits it (_child_env), but a LOCAL launch template
        # (the drills' /usr/bin/env) inherits the supervisor's environment
        # too — unset it explicitly so both template styles agree with ssh
        # semantics (a real remote login env never had it).
        unset = ["-u", "DDT_FAULT_PLAN"] if generation > 0 else []
        return prefix + ["env", *unset, *carried] + self._child_argv(index)

    def _spawn_remote(self, index: int, generation: int, host: str):
        """Spawn a serve child on ``host`` via the launch template. The
        launcher is supervised exactly like a local child — poll, SIGTERM,
        reap — and its lifetime is the remote process's lifetime (ssh
        semantics: the remote side gets HUP when the launcher dies).
        stdout/stderr land in the same per-replica fleet logs."""
        log_path, log_fh = self._open_log(index, generation)
        proc = subprocess.Popen(self._remote_argv(index, generation, host),
                                stdout=log_fh, stderr=subprocess.STDOUT)
        proc._ddt_log_path = log_path       # type: ignore[attr-defined]
        proc._ddt_log_fh = log_fh           # type: ignore[attr-defined]
        proc._ddt_remote_host = host        # type: ignore[attr-defined]
        return proc

    def _tail(self, index: int, generation: int) -> str:
        path = os.path.join(self.log_dir,
                            f"replica{index}_g{generation}.log")
        try:
            with open(path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                fh.seek(max(0, fh.tell() - 2000))
                return fh.read().decode(errors="replace")
        except OSError:
            return ""

    # ----------------------------------------------------------- respawning

    def _replace(self, index: int, proc, *, cause: str,
                 term_first: bool) -> None:
        """Reap one replica and respawn it in place (budgeted). No-ops when
        another thread already replaced ``proc`` — the health poller and
        the supervision loop can both spot the same casualty."""
        with self._lock:
            if self.procs[index] is not proc or self._stop.is_set():
                return
            if self.replicas[index].retired or index in self._retiring:
                return   # a scale-down drain, not a casualty
            self.router.set_health(index, False)
            if term_first and proc.poll() is None:
                proc.terminate()
            try:
                proc.wait(timeout=self.reap_timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            rc = proc.returncode
            fh = getattr(proc, "_ddt_log_fh", None)
            if fh is not None:
                fh.close()
            gen = self.gens[index]
            died_by_signal = rc is not None and rc < 0
            self._replica_event(
                index,
                "died" if (died_by_signal and not term_first) else
                ("wedged_reaped" if cause == "wedged" else "exited"),
                cause=cause, rc=rc,
                signal=(-rc if died_by_signal else None),
                exit_class=(classify_rc(rc) if not died_by_signal else None),
                generation=gen)
            if self.budget.exhausted():
                print(f"[fleet] replica {index} g{gen} rc={rc} tail:\n"
                      f"{self._tail(index, gen)}", file=sys.stderr,
                      flush=True)
                self._give_up = True
                self._stop.set()
                return
            backoff = self.budget.spend(gen)
            if backoff:
                time.sleep(backoff)
            self.gens[index] += 1
            self.replicas[index].generation = self.gens[index]
            # Fresh generation: its boot window is not a partition.
            self._misses[index] = 0
            self._seen_healthy[index] = False
            self._probation.pop(index, None)
            self.procs[index] = self._spawn(index, self.gens[index])
            self._replica_event(index, "respawn",
                                generation=self.gens[index],
                                port=self.ports[index],
                                restarts_left=self.budget.left)

    # -------------------------------------------------------------- polling

    def _poll_health(self, rep: Replica) -> dict | None:
        """One /healthz read; None = unreachable (booting or dead)."""
        url = f"http://{rep.host}:{rep.port}/healthz"
        timeout = max(1.0, float(self.cfg.serve.health_poll_s) * 2)
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as err:
            # 503 IS an answer (critical verdict rides the body).
            try:
                return json.loads(err.read().decode())
            except ValueError:
                return {"status": "critical",
                        "reasons": [f"http {err.code}"]}
        except (OSError, ValueError):
            return None

    def _health_loop(self) -> None:
        poll = float(self.cfg.serve.health_poll_s)
        while not self._stop.wait(poll):
            with self._lock:
                snapshot = list(enumerate(self.procs))
            for index, proc in snapshot:
                if self._stop.is_set():
                    return
                if index < len(self.replicas) \
                        and self.replicas[index].retired:
                    continue
                if proc is None or proc.poll() is not None:
                    # Dead PROCESS: the supervision loop's _replace path
                    # (respawn, budgeted) — never probation.
                    self.router.set_health(index, False)
                    continue
                prob = self._probation.get(index)
                if prob is not None \
                        and time.monotonic() < prob["next_probe"]:
                    continue   # bounded re-probe, not tight polling
                verdict = self._poll_health(self.replicas[index])
                if verdict is None:
                    self._note_unreachable(index)
                elif verdict.get("status") == "critical":
                    # The replica's own watchdog verdict (wedged dispatcher
                    # past serve.dispatch_stall_s, stale heartbeat, …):
                    # stop routing there, drain it, respawn it.
                    self.router.set_health(index, False, verdict)
                    self._replica_event(index, "wedged",
                                        reasons=verdict.get("reasons"),
                                        generation=self.gens[index])
                    self._replace(index, proc, cause="wedged",
                                  term_first=True)
                else:
                    self._note_reachable(index, verdict)

    def _note_unreachable(self, index: int) -> None:
        """An alive process whose endpoint did not answer. Boot windows
        (never yet healthy this generation) just stay unroutable; a
        previously-healthy replica accrues misses and, past
        ``serve.partition_after_misses``, enters probation: quarantined,
        re-probed with doubling backoff, restart budget UNTOUCHED."""
        sv = self.cfg.serve
        self.router.set_health(index, False)
        prob = self._probation.get(index)
        if prob is not None:
            prob["probes"] += 1
            prob["backoff"] = min(float(sv.probe_backoff_max_s),
                                  prob["backoff"] * 2.0)
            prob["next_probe"] = time.monotonic() + prob["backoff"]
            self._replica_event(
                index, "probation_probe", probes=prob["probes"],
                next_probe_s=round(prob["backoff"], 3),
                outage_s=round(time.monotonic() - prob["since"], 3))
            return
        if not self._seen_healthy[index]:
            return   # still booting: unreachable is not a partition
        self._misses[index] += 1
        if self._misses[index] < int(sv.partition_after_misses):
            return
        # Alive process, dead endpoint, previously healthy: a network
        # partition, not a death. Quarantine + probation.
        self._probation[index] = {
            "since": time.monotonic(),
            "backoff": float(sv.probe_backoff_s),
            "next_probe": time.monotonic() + float(sv.probe_backoff_s),
            "probes": 0}
        self._replica_event(index, "partitioned",
                            misses=self._misses[index],
                            generation=self.gens[index],
                            restarts_left=self.budget.left)

    def _note_reachable(self, index: int, verdict: dict) -> None:
        self._misses[index] = 0
        self._seen_healthy[index] = True
        prob = self._probation.pop(index, None)
        self.router.set_health(index, True, verdict)
        if prob is not None:
            # Reconnect: close the quarantine breaker immediately — the
            # supervisor's probe already proved the path.
            self.router.clear_quarantine(index)
            self._replica_event(
                index, "reconnected",
                outage_s=round(time.monotonic() - prob["since"], 3),
                probes=prob["probes"], restarts_left=self.budget.left)

    def _stats_loop(self) -> None:
        every = float(self.cfg.serve.stats_every_s)
        while not self._stop.wait(every):
            self._emit_stats()

    def _emit_stats(self) -> None:
        stats = self.router.stats()
        tick = self.router.take_tick_stats()
        load = self._fleet_load()
        self._stats_seq += 1
        self._event("stats", seq=self._stats_seq, **stats,
                    tick_p95_ms=tick["p95_ms"], tick_requests=tick["n"],
                    queue_depth=load["queue_depth"],
                    reject_frac=load["reject_frac"])
        if self.slo is not None:
            self.slo.check_fleet(
                point=self._stats_seq,
                p95_ms=(stats["p95_ms"] if stats["proxied"] else None),
                available_frac=stats["available"] / max(1, self.n),
                logger=self.logger)
        if self.autoscaler is not None and not self._stop.is_set():
            self._autoscale_tick(tick, load, stats)

    # ----------------------------------------------------------- autoscaling

    def _fleet_load(self) -> dict:
        """Queue/admission evidence summed from the replicas' last health
        verdicts (the ``serve_load`` block each /healthz carries):
        current queue depth, and this tick's rejected fraction from the
        accepted/rejected counter deltas (clamped — a respawn resets a
        replica's counters)."""
        queued = acc = rej = 0
        for rep in self.replicas:
            if rep.retired:
                continue
            block = (rep.health or {}).get("serve_load") or {}
            queued += int(block.get("queued") or 0)
            acc += int(block.get("accepted") or 0)
            rej += int(block.get("rejected") or 0)
        d_acc = max(0, acc - self._last_load[0])
        d_rej = max(0, rej - self._last_load[1])
        self._last_load = (acc, rej)
        denom = d_acc + d_rej
        return {"queue_depth": queued,
                "reject_frac": round(d_rej / denom, 6) if denom else 0.0}

    def _autoscale_tick(self, tick: dict, load: dict, stats: dict) -> None:
        ev = {"p95_ms": tick["p95_ms"], "requests": tick["n"],
              "queue_depth": load["queue_depth"],
              "reject_frac": load["reject_frac"],
              "routable_frac": round(stats["available"]
                                     / max(1, self.n), 3)}
        decision = self.autoscaler.evaluate(
            now=time.monotonic(), replicas=self.n,
            routable=stats["available"], ev=ev)
        if decision is None:
            return
        before = self.n
        if decision["action"] == "scale_up":
            if self._grow_one():
                self._autoscale_event("scale_up", before, decision, ev)
        elif decision["action"] == "scale_down":
            victim = self._shrink_one()
            if victim is not None:
                self._autoscale_event("scale_down", before, decision, ev,
                                      replica=victim)
        else:
            self._autoscale_event(decision["action"], before, decision, ev)

    def _autoscale_event(self, action: str, before: int, decision: dict,
                         ev: dict, **extra) -> None:
        if self.logger is not None:
            self.logger.log("autoscale_event", action=action,
                            replicas_from=before, replicas_to=self.n,
                            reasons=decision.get("reasons"), evidence=ev,
                            min_replicas=self.min_replicas,
                            max_replicas=self.max_replicas, **extra)

    def _grow_one(self) -> bool:
        """Scale up: append a slot (new index, new port, unhealthy until
        its first /healthz) and spawn it at generation 0 — growth never
        spends restart budget."""
        with self._lock:
            if self._stop.is_set() or self.n >= self.max_replicas:
                return False
            sv = self.cfg.serve
            index = len(self.replicas)
            host = self._host_for(index) or sv.host
            port = free_port()
            self.ports.append(port)
            self.slot_hosts.append(host)
            rep = self.router.add_replica(
                host, port, breaker_failures=sv.breaker_failures,
                breaker_reset_s=sv.breaker_reset_s)
            self.replicas.append(rep)
            self.procs.append(None)
            self.gens.append(0)
            self._misses.append(0)
            self._seen_healthy.append(False)
            self.n += 1
            self.procs[index] = self._spawn(index, 0)
            self._replica_event(index, "spawn", generation=0, port=port,
                                cause="autoscale")
        return True

    def _shrink_one(self) -> int | None:
        """Scale down: retire the highest active slot — only while every
        OTHER active replica is routable (capacity never below N-1 during
        the drain). Routing stops first (tombstone), then the child drains
        under its own SIGTERM contract."""
        with self._lock:
            active = [r for r in self.replicas if not r.retired]
            if self.min_replicas is None or len(active) <= self.min_replicas:
                return None
            victim = active[-1]
            if not all(r.routable() for r in active
                       if r.index != victim.index):
                return None
            index = victim.index
            self._retiring.add(index)
            self.router.retire(index)
            self._probation.pop(index, None)
            self.n -= 1
            proc = self.procs[index]
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=float(self.cfg.serve.drain_timeout_s) + 5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        fh = getattr(proc, "_ddt_log_fh", None)
        if fh is not None:
            fh.close()
        self._retiring.discard(index)
        self._replica_event(index, "retired", cause="autoscale",
                            rc=(proc.returncode if proc is not None
                                else None))
        return index

    def _refresh_watch_loop(self) -> None:
        poll = float(self.cfg.serve.refresh_poll_s)
        source = (self.cfg.serve.refresh_from
                  or self.cfg.train.checkpoint_dir)
        installed: int | None = None
        attempted: set[int] = set()
        while not self._stop.wait(poll):
            steps = discover_steps(source)
            fresh = [s for s in steps if s not in attempted
                     and (installed is None or s > installed)]
            if not fresh:
                continue
            newest = fresh[-1]
            # One shot per step: a roll the canary rolled BACK (or a
            # replica rejected) must not be retried every poll forever.
            attempted.add(newest)
            code, _ = self.router.roll_refresh_direct(
                {"step": newest, "dir": source})
            if code == 200:
                installed = newest

    def _tuning_watch_loop(self) -> None:
        """Fleet-wide tuning-manifest deployment: watch the signed manifest's
        digest and roll replicas ONE AT A TIME when it changes. Replicas
        re-apply the manifest themselves at boot (the CLI startup hook runs
        in every child), so a roll is a sequential budget-free respawn; a
        replica that does not come back healthy aborts the roll and the
        remaining replicas keep serving the old configuration."""
        from ..tuning import (DEFAULT_MANIFEST_PATH, TuningError,
                              read_tuning_manifest)
        poll = float(self.cfg.serve.refresh_poll_s)
        path = self.cfg.tuning.manifest or DEFAULT_MANIFEST_PATH
        last_reject: str | None = None

        def digest_of() -> str | None:
            nonlocal last_reject
            if not os.path.exists(path):
                return None
            try:
                return read_tuning_manifest(path).get("digest")
            except TuningError as err:
                # Once per distinct failure, not once per poll: a corrupt
                # manifest sits there until an operator acts.
                if str(err) != last_reject:
                    last_reject = str(err)
                    self._event("tuning_manifest_rejected", manifest=path,
                                error=str(err))
                return None

        # A manifest present at fleet boot was already applied by every
        # replica's own startup hook — only a CHANGE rolls the fleet.
        installed = digest_of()
        attempted: set[str] = set()
        while not self._stop.wait(poll):
            digest = digest_of()
            if digest is None or digest == installed or digest in attempted:
                continue
            attempted.add(digest)   # one shot per digest, like refresh steps
            if self._tuning_roll(path, digest):
                installed = digest

    def _tuning_roll(self, path: str, digest: str) -> bool:
        self._event("tuning_roll", manifest=path, digest=digest)
        with self._lock:
            indices = [r.index for r in self.replicas if not r.retired]
        for index in indices:
            if self._stop.is_set():
                return False
            if not self._roll_replica_for_tuning(index):
                self._event("tuning_roll_abort", replica=index,
                            digest=digest)
                return False
        self._event("tuning_roll_complete", digest=digest)
        return True

    def _roll_replica_for_tuning(self, index: int) -> bool:
        """Respawn one slot on the new manifest (budget-free, like growth)
        and wait for its /healthz before the roll may touch the next slot.
        Returns False when the fresh generation never answers — the abort
        signal that keeps a bad manifest from taking the whole fleet."""
        with self._lock:
            if (self._stop.is_set() or self.replicas[index].retired
                    or index in self._retiring):
                return True   # nothing to roll — not a failure
            proc = self.procs[index]
            self.router.set_health(index, False)
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=self.reap_timeout_s)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            fh = getattr(proc, "_ddt_log_fh", None)
            if fh is not None:
                fh.close()
            self.gens[index] += 1
            self.replicas[index].generation = self.gens[index]
            # Fresh generation: its boot window is not a partition.
            self._misses[index] = 0
            self._seen_healthy[index] = False
            self._probation.pop(index, None)
            self.procs[index] = self._spawn(index, self.gens[index])
            self._replica_event(index, "tuning_respawn",
                                generation=self.gens[index],
                                port=self.ports[index])
        deadline = time.monotonic() + self.tuning_roll_wait_s
        rep = self.replicas[index]
        while time.monotonic() < deadline and not self._stop.is_set():
            verdict = self._poll_health(rep)
            if verdict is not None and verdict.get("status") != "critical":
                return True
            time.sleep(min(1.0, float(self.cfg.serve.health_poll_s)))
        return False

    # ------------------------------------------------------------------ run

    def _on_signal(self, signum, frame) -> None:   # noqa: ARG002
        self._preempted = True
        self._stop.set()

    def run(self) -> int:
        signal.signal(signal.SIGTERM, self._on_signal)
        signal.signal(signal.SIGINT, self._on_signal)
        self._event("supervise", restarts=self.budget.left,
                    ports=list(self.ports))
        with self._lock:
            for index in range(self.n):
                self.procs[index] = self._spawn(index, 0)
                self._replica_event(index, "spawn", generation=0,
                                    port=self.ports[index],
                                    host=self.slot_hosts[index])
        # Unroutable until their first reachable /healthz — the router must
        # not send real traffic into a replica that is still compiling.
        for rep in self.replicas:
            rep.healthy = False
        port = self.router.bind()
        self._event("launch", router_port=port)
        print(f"[fleet] router on http://{self.cfg.serve.host}:{port} "
              f"({self.n} replicas, ports {self.ports})", flush=True)
        self._threads = [
            threading.Thread(target=self._health_loop,
                             name="fleet-health", daemon=True),
            threading.Thread(target=self._stats_loop,
                             name="fleet-stats", daemon=True)]
        if self.cfg.serve.refresh_poll_s is not None:
            self._threads.append(
                threading.Thread(target=self._refresh_watch_loop,
                                 name="fleet-refresh", daemon=True))
            if self.cfg.tuning.apply != "off":
                self._threads.append(
                    threading.Thread(target=self._tuning_watch_loop,
                                     name="fleet-tuning", daemon=True))
        for t in self._threads:
            t.start()
        while not self._stop.is_set():
            with self._lock:
                snapshot = list(enumerate(self.procs))
            for index, proc in snapshot:
                if proc is not None and proc.poll() is not None:
                    self._replace(index, proc, cause="exit",
                                  term_first=False)
            self._check_threads()
            self._stop.wait(0.2)
        return self._shutdown()

    def _check_threads(self) -> None:
        """Supervisor self-monitoring: a dead router/health/stats thread
        leaves a healthy-looking supervisor serving nothing. First sighting
        flips the fleet /healthz critical (router.supervisor_faults) and
        lands a replica_event-style record (replica=null: the casualty is
        the supervisor itself)."""
        threads = list(self._threads)
        if self.router._thread is not None:
            threads.append(self.router._thread)
        for t in threads:
            if t.is_alive() or t.name in self._dead_threads:
                continue
            self._dead_threads.add(t.name)
            self.router.supervisor_faults.append(
                f"supervisor thread {t.name!r} died")
            self._replica_event(None, "supervisor_thread_dead",
                                thread=t.name)

    def _shutdown(self) -> int:
        self.router.stop_admission()
        self._event("drain", preempted=self._preempted,
                    give_up=self._give_up)
        for t in self._threads:
            t.join(timeout=5)
        with self._lock:
            procs = list(self.procs)
        for proc in procs:
            if proc is not None and proc.poll() is None:
                proc.terminate()
        rcs = []
        deadline = time.monotonic() + float(self.cfg.serve.drain_timeout_s) + 5
        for proc in procs:
            if proc is None:
                rcs.append(None)
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            rcs.append(proc.returncode)
            fh = getattr(proc, "_ddt_log_fh", None)
            if fh is not None:
                fh.close()
        self._emit_stats()
        self.router.stop()
        if self._give_up:
            self._event("give_up", rcs=rcs)
            return max((rc for rc in rcs if rc and rc > 0), default=1)
        self._event("preempted_exit" if self._preempted else "complete",
                    rcs=rcs)
        return EXIT_PREEMPTED if self._preempted else 0

    # ------------------------------------------------------------- terminal

    def lineage_block(self) -> dict:
        """The fleet's terminal summary (the supervisor run_summary's
        lineage twin): replica count, per-slot generations (how many times
        each was respawned), and the budget left."""
        return {"run_id": self.run_id, "replicas": self.n,
                "generations": list(self.gens),
                "respawns": sum(self.gens),
                "restarts_left": self.budget.left}

    def exit_class(self, rc: int) -> str:
        return classify_rc(rc)
