"""Elastic supervision: survive the loss (and the return) of a worker mid-run
(counterpart of ``data_diet_distributed_tpu/resilience/elastic.py``).

The pieces a recovery needs are the port's own: the consensus layer names a
dead rank and bounds the survivors' abort (``resilience/consensus.py``), the
stage manifest re-enters the pipeline at its stage (``resilience/stages.py``),
and the checkpoint tier makes the newest step every rank promoted restorable
at any later world size (``checkpoint.py`` assembles the whole state from the
ranks' shard files, and ``fit`` re-slices the ZeRO-1 momentum for the new
world). This module is the loop that drives them.

Recovery is by restart (in-process retry is refused across ranks: one rank
re-entering ``fit`` desyncs every collective):

* **Worker loss** (SIGKILL, OOM, a lost host): the survivors exit retriably
  (69) through their watchdog and the poison side channel, or by the error of
  a collective whose peer is gone; after ``elastic.reap_timeout_s`` the
  supervisor terminates, then kills, whatever is still running (a survivor
  wedged inside a CUDA or NCCL call, where no in-process watchdog reaches).
  ``ElasticSupervisor`` names the ranks that died on their own (exit by
  signal; the reaped ones are not evidence) and relaunches on the surviving
  world with ``train.resume=true``.
* **Worker join**: a join request (``request_join``: an operator, a
  node-arrival hook, or the ``rejoin_after_stage`` fault) becomes a resize
  request, which the pipeline honours at its next stage boundary
  (``stage_barrier``: a clean exit 75); the supervisor relaunches on the
  grown world.

Supervision is bounded: ``elastic.max_restarts`` relaunches with exponential
backoff (``elastic.backoff_s``), never below ``elastic.min_world`` nor above
``elastic.max_world``. The model axis (``mesh.model_axis`` = M) is kept
through every shrink and grow: each new world is a multiple of M (a shrink
rounds down, a join adds whole model groups, the floor rounds up), so the
relaunch's ``remap_mesh`` only ever recomputes the data axis. Every decision is an ``{"kind": "elastic_event"}``
record in the run's metrics stream, with the JAX package's event names and
fields, so its ``tools/run_monitor.py`` and the port's post-mortem
(``obs/postmortem.py``) replay what the supervisor did.

The supervisor never touches the card: it starts processes, reads exit codes,
heartbeat files and request files, and appends JSON lines. Its workers run
``python -m data_diet_distributed_tpu_torch.cli`` with the supervisor's own
``--device``; with CUDA each rank takes one card, so one card runs W = 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from ..obs import lineage

#: Exit statuses the supervisor classifies (the CLI's contract, literal here
#: so the supervisor imports nothing that reaches the card).
EXIT_PREEMPTED = 75
EXIT_RETRIABLE = 69
EXIT_DIVERGED = 13

#: Set in every worker the supervisor spawns, so a child with
#: ``elastic.enabled=true`` in its config runs the command (its stage barriers
#: armed) instead of supervising again.
CHILD_ENV = "DDT_ELASTIC_CHILD"


# --------------------------------------------------------------- conventions

def elastic_dir(checkpoint_dir: str) -> str:
    """Control-plane directory, sibling of the checkpoint dir like the poison
    side-channel and the stage manifest — it must be on a filesystem every
    rank (and the supervisor) sees."""
    return f"{checkpoint_dir}_elastic"


def checkpoint_dir_from_manifest(manifest_path: str) -> str:
    """The checkpoint dir behind a stage-manifest path
    (``<ckpt>_stages.json`` → ``<ckpt>``) — the reverse of
    ``stages.stage_manifest_path``, used by the ``rejoin_after_stage``
    fault injection, which only holds the manifest path at fire time."""
    suffix = "_stages.json"
    if not manifest_path.endswith(suffix):
        raise ValueError(f"not a stage-manifest path: {manifest_path!r}")
    return manifest_path[: -len(suffix)]


def join_request_path(checkpoint_dir: str) -> str:
    return os.path.join(elastic_dir(checkpoint_dir), "join.json")


def resize_request_path(checkpoint_dir: str) -> str:
    return os.path.join(elastic_dir(checkpoint_dir), "resize.json")


def _write_request(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(dict(payload, ts=round(time.time(), 3)), fh)
    os.replace(tmp, path)


def _read_request(path: str) -> dict | None:
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        # A torn request (writer killed mid-replace cannot happen — atomic —
        # but a foreign/corrupt file can): treat as a request with no
        # payload rather than wedging the control plane on it.
        return {"corrupt": True}


def _clear_request(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def request_join(checkpoint_dir: str, *, ranks: int = 1,
                 reason: str = "") -> str:
    """Ask the supervisor to grow the pod by ``ranks`` processes at the next
    stage boundary. Idempotent (one outstanding request; a second ask
    overwrites). Returns the request path."""
    path = join_request_path(checkpoint_dir)
    _write_request(path, {"ranks": int(ranks), "reason": str(reason)[:300]})
    return path


def read_join_request(checkpoint_dir: str) -> dict | None:
    return _read_request(join_request_path(checkpoint_dir))


def clear_join_request(checkpoint_dir: str) -> None:
    _clear_request(join_request_path(checkpoint_dir))


def request_resize(checkpoint_dir: str, world: int, *,
                   reason: str = "") -> str:
    """Arm a resize: the training pipeline exits cleanly preempted at its
    next stage boundary (``stage_barrier``), and the supervisor relaunches
    at ``world`` processes."""
    path = resize_request_path(checkpoint_dir)
    _write_request(path, {"world": int(world), "reason": str(reason)[:300]})
    return path


def read_resize_request(checkpoint_dir: str) -> dict | None:
    return _read_request(resize_request_path(checkpoint_dir))


def clear_resize_request(checkpoint_dir: str) -> None:
    _clear_request(resize_request_path(checkpoint_dir))


# ------------------------------------------------------------ event records

def log_elastic_event(logger, event: str, **fields) -> None:
    """One ``{"kind": "elastic_event"}`` record. ``logger`` is anything with
    ``.log(kind, **fields)`` (``MetricsLogger`` or the supervisor's
    ``JsonlLogger``) or a callable ``log(kind, **fields)`` (the pipeline's);
    None is a no-op, so callers thread it unconditionally."""
    if logger is None:
        return
    log = getattr(logger, "log", logger)
    log("elastic_event", event=event, **fields)


class JsonlLogger:
    """The supervisor's records: append-only JSON lines of the
    ``{"ts", "kind", ...}`` shape ``obs.MetricsLogger`` writes, without its
    rank gate and flight-recorder mirror (the supervisor is no rank)."""

    def __init__(self, path: str | None, echo: bool = True):
        self.echo = echo
        self._fh = None
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, kind: str, **fields) -> None:
        # The MetricsLogger's lineage stamp: the supervisor's records share
        # the workers' stream, and the post-mortem attributes every line to
        # a run and an attempt.
        record = lineage.stamp({"ts": round(time.time(), 3), "kind": kind,
                                **fields})
        if self._fh is not None:
            try:
                self._fh.write(json.dumps(record) + "\n")
            except (OSError, ValueError):
                pass   # a full disk degrades supervision telemetry, not recovery
        if self.echo:
            body = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{kind}] {body}", flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# --------------------------------------------------------- stage barrier

def stage_barrier(cfg, logger, boundary: str) -> None:
    """Elastic barrier at a pipeline stage boundary: when a resize request is
    armed, exit the run cleanly preempted (75) HERE — the last durable point
    before the next stage's mesh-shaped state exists — so the supervisor can
    relaunch at the new world size and stage-resume skips everything already
    done. No-op without ``elastic.enabled`` or without a request; under
    multi-host every rank reads the same shared request file at the same
    boundary, so the exit is lockstep without a collective."""
    if not getattr(cfg, "elastic", None) or not cfg.elastic.enabled:
        return
    from .preemption import Preempted
    req = read_resize_request(cfg.train.checkpoint_dir)
    if req is not None:
        log_elastic_event(logger, "resize_honored", boundary=boundary,
                          world=req.get("world"), reason=req.get("reason"))
        raise Preempted("ELASTIC", step=None, epoch=None, durable_step=None)
    join = read_join_request(cfg.train.checkpoint_dir)
    if join is not None:
        # A join the supervisor has not yet translated (its poll is
        # periodic; a join written microseconds before this boundary —
        # e.g. at the preceding stage's completion — would otherwise slip
        # past the run's LAST barrier and never be honored). Exit here
        # too: the supervisor translates pending joins at classification.
        log_elastic_event(logger, "join_pending", boundary=boundary,
                          reason=join.get("reason"))
        raise Preempted("ELASTIC", step=None, epoch=None, durable_step=None)


# ------------------------------------------------------- survivor naming

def survivors(heartbeat_dir: str | None, world: int,
              stale_after_s: float = 30.0,
              now: float | None = None) -> tuple[list[int], list[int]]:
    """(alive, dead) ranks by heartbeat freshness — the supervisor's
    filesystem view of the verdict the consensus layer already named in its
    poison records. A rank with no heartbeat file at all counts alive (it
    may not have started writing yet); only a rank that WAS reporting and
    went stale past the budget is named dead."""
    alive, dead = list(range(world)), []
    if not heartbeat_dir:
        return alive, dead
    from ..obs.heartbeat import read_heartbeats
    beats = read_heartbeats(heartbeat_dir)
    now = time.time() if now is None else now
    dead = sorted(r for r, rec in beats.items()
                  if r < world and now - float(rec.get("ts", now))
                  > stale_after_s)
    alive = [r for r in range(world) if r not in dead]
    return alive, dead


def clear_rank_artifacts(checkpoint_dir: str, heartbeat_dir: str | None,
                         ranks: list[int], attempt: int = 0) -> None:
    """ARCHIVE a departed rank's control-plane residue (heartbeat file,
    poison record) so the shrunken pod's fleet view and the next consensus
    open don't keep reporting a ghost — while the postmortem keeps the
    evidence: the files are renamed with an ``.a<attempt>`` suffix (which
    no live reader matches), never deleted: they are the dead rank's last
    recorded progress, which the post-mortem reads. Checkpoint SHARDS are kept —
    the departed rank's promoted tier files are exactly what the survivors
    restore."""
    from ..obs.heartbeat import archive_heartbeat
    for rank in ranks:
        if heartbeat_dir:
            archive_heartbeat(heartbeat_dir, rank, attempt)
        poison = os.path.join(f"{checkpoint_dir}_sidechannel",
                              f"poison.rank{rank}.json")
        try:
            os.replace(poison, f"{poison}.a{int(attempt)}")
        except OSError:
            pass


# ----------------------------------------------------------- the supervisor

def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]



def classify_rc(rc: int) -> str:
    """The CLI exit-status contract, named — shared by every supervisor
    (elastic pod, serve fleet) and their terminal ``run_summary`` records."""
    if rc == 0:
        return "ok"
    if rc == EXIT_PREEMPTED:
        return "preempted"
    if rc == EXIT_RETRIABLE:
        return "retriable"
    if rc == EXIT_DIVERGED:
        return "diverged"
    return f"fatal:rc{rc}"


class RestartBudget:
    """Bounded-restart accounting shared by the supervisors: ``max_restarts``
    relaunches, exponential backoff between them (exponent capped so a long
    soak never sleeps unboundedly). A requested grow/resize is free — only
    failure relaunches spend."""

    def __init__(self, max_restarts: int, backoff_s: float):
        self.max_restarts = int(max_restarts)
        self.left = int(max_restarts)
        self.backoff_s = float(backoff_s)

    def exhausted(self) -> bool:
        return self.left <= 0

    def spend(self, exponent: int) -> float:
        """Spend one relaunch; returns the backoff (seconds) to sleep before
        it. Callers check ``exhausted()`` first — spending past zero is a
        supervisor bug, not a policy."""
        self.left -= 1
        return self.backoff_s * (2 ** min(int(exponent), 6))


class ElasticSupervisor:
    """Bounded restart supervisor over a (single-host) pod of CLI workers.

    Drives the elastic recovery loop: spawn ``world`` ranks of the SAME cli
    invocation (each with ``mesh.multihost`` overrides and ``CHILD_ENV``
    set), wait, classify the exits, and either finish, shrink to the
    survivors, grow on a join request, or restart in place — each relaunch
    with ``train.resume=true`` so the stage manifest + multi-tier
    checkpoints re-enter at the exact point. On a real multi-host pod the
    per-host launcher replaces ``spawn`` (one rank per host); the
    classification/relaunch policy is the part that does not change.

    ``spawn(world, rank, attempt, coordinator)`` (injectable for tests and
    alternative launchers) must return a ``subprocess.Popen``-like object
    with ``poll()``/``wait()``/``terminate()``/``kill()``/``returncode``.
    ``fault_env(attempt)`` (the soak driver's hook) returns extra environment
    for that attempt's children — fault plans are per-attempt so a replayed
    attempt does not re-trip its predecessor's fault.
    """

    def __init__(self, cfg, command: str, *, config_path: str | None = None,
                 overrides: list[str] | None = None, logger=None,
                 spawn=None, fault_env=None, device: str | None = None):
        self.cfg = cfg
        self.command = command
        # The workers' --device, exactly as the supervisor was given it
        # (None: the CLI's default, CUDA).
        self.device = device
        self.config_path = config_path
        self.overrides = list(overrides or [])
        self.logger = logger
        self._spawn = spawn or self._spawn_local
        self._fault_env = fault_env
        e = cfg.elastic
        self.world = int(e.world or cfg.mesh.num_processes or 1)
        self.initial_world = self.world
        self.model = max(int(cfg.mesh.model_axis), 1)
        self.min_world = int(e.min_world) + (-int(e.min_world) % self.model)
        self.max_world = int(e.max_world or self.world)
        self.budget = RestartBudget(int(e.max_restarts), float(e.backoff_s))
        self.backoff_s = float(e.backoff_s)
        self.reap_timeout_s = float(e.reap_timeout_s)
        self.stale_after_s = float(e.heartbeat_stale_s)
        self.attempt = 0
        self._reaped: set[int] = set()
        self.events: list[dict] = []
        # Run lineage: ONE run_id for the whole supervised run, threaded to
        # every child attempt via env (an outer orchestrator's DDT_RUN_ID is
        # honored; otherwise minted here). Installed so the supervisor's own
        # JsonlLogger records carry it too.
        self.run_id = os.environ.get(lineage.RUN_ID_ENV) or lineage.new_run_id()
        # world stays None in the supervisor's OWN ambient stamp: its world
        # changes across relaunches and every elastic_event already carries
        # it explicitly — a stale ambient world would misstamp later records.
        # attempt is kept in step by _next_attempt(): the supervisor's late
        # records (terminal run_summary, perf ledger) must name the attempt
        # the run actually ended on, not a pin at 0.
        self._lineage = lineage.install(
            lineage.Lineage(run_id=self.run_id, attempt=0))
        self.worlds: list[int] = []       # world size of each launched attempt
        self._lost_wall_s = 0.0           # classification -> relaunch gaps
        self._classified_mono: float | None = None
        ckpt = cfg.train.checkpoint_dir
        self.checkpoint_dir = ckpt
        from ..obs.heartbeat import dir_from_cfg
        self.heartbeat_dir = dir_from_cfg(cfg)
        self.log_dir = elastic_dir(ckpt)

    # ------------------------------------------------------------- plumbing

    @property
    def restarts_left(self) -> int:
        return self.budget.left

    def _next_attempt(self) -> None:
        self.attempt += 1
        self._lineage.attempt = self.attempt

    def _event(self, event: str, **fields) -> None:
        rec = {"event": event, "attempt": self.attempt,
               "world": self.world, **fields}
        self.events.append(rec)
        log_elastic_event(self.logger, **rec)

    def _tiled(self, world: int) -> int:
        """``world`` rounded down to whole model groups."""
        return world - world % self.model

    def _child_argv(self, world: int, rank: int) -> list[str]:
        argv = [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli",
                self.command]
        if self.config_path:
            argv += ["--config", self.config_path]
        if self.device is not None:
            argv += ["--device", self.device]
        argv += self.overrides
        # Appended LAST: load_config applies overrides in order, so the
        # supervisor's world-geometry always wins over whatever the
        # operator's invocation carried.
        if world > 1:
            argv += ["mesh.multihost=true",
                     f"mesh.coordinator_address={self._coordinator}",
                     f"mesh.num_processes={world}",
                     f"mesh.process_id={rank}"]
        else:
            argv += ["mesh.multihost=false"]
        if self.attempt > 0:
            argv += ["train.resume=true"]
        return argv

    def _spawn_local(self, world: int, rank: int, attempt: int,
                     coordinator: str):
        env = dict(os.environ)
        env[CHILD_ENV] = "1"
        # Lineage identity: same run_id every attempt, attempt monotonic,
        # world as launched — the children stamp all three into every JSONL
        # record and suffix their per-attempt artifacts with the attempt.
        env.update(lineage.child_env(self.run_id, attempt, world))
        if attempt > 0:
            # An env-armed fault plan (the README ops drills) fires once:
            # resume can replay the faulted unit, and an exact-coordinate
            # plan re-arming on every relaunch would re-kill the recovery
            # until the budget is gone. A per-attempt fault_env (the soak
            # driver) decides re-arming explicitly below.
            env.pop("DDT_FAULT_PLAN", None)
        # `-m data_diet_distributed_tpu_torch.cli` must resolve wherever the
        # supervisor was launched from: prepend the package's own root.
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        if self._fault_env is not None:
            env.update(self._fault_env(attempt) or {})
        os.makedirs(self.log_dir, exist_ok=True)
        log_path = os.path.join(self.log_dir, f"child_a{attempt}_r{rank}.log")
        log_fh = open(log_path, "ab")
        proc = subprocess.Popen(self._child_argv(world, rank),
                                stdout=log_fh, stderr=subprocess.STDOUT,
                                env=env)
        proc._ddt_log_path = log_path       # type: ignore[attr-defined]
        proc._ddt_log_fh = log_fh           # type: ignore[attr-defined]
        return proc

    def _wait_attempt(self, procs) -> list[int]:
        """Wait for every child. The moment ANY child dies non-gracefully
        (exit by signal), the rest get a bounded grace (their own
        watchdog/poison escalation is the designed path out of the dead
        collective) and are then terminated — the supervisor never waits
        unboundedly on a wedge the fault just created. A pending join
        request is translated into a resize request live, so the pipeline
        can honor it at its next stage boundary."""
        death_seen_at = None
        self._reaped = set()
        while True:
            running = [p for p in procs if p.poll() is None]
            if not running:
                break
            # Any UNCOORDINATED exit starts the reap clock — exit by signal
            # (host loss) but also a positive fatal/retriable rc: 0 and 75
            # are the only statuses the consensus layer exits in lockstep,
            # so after anything else the remaining ranks may be wedged in a
            # dead collective with (by default) no watchdog of their own.
            if death_seen_at is None and any(
                    p.returncode is not None
                    and p.returncode not in (0, EXIT_PREEMPTED)
                    for p in procs):
                death_seen_at = time.monotonic()
            if (death_seen_at is not None
                    and time.monotonic() - death_seen_at
                    > self.reap_timeout_s):
                # Ranks the SUPERVISOR reaps here were alive (wedged in the
                # collective the real death tore); their exit-by-signal is
                # our doing, not host-loss evidence — _classify excludes
                # them from the dead set so the pod only shrinks by the
                # ranks that died on their own.
                self._reaped = {procs.index(p) for p in running}
                self._event("reap_timeout",
                            still_running=sorted(self._reaped))
                for p in running:
                    p.terminate()
                for p in running:
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                break
            self._poll_join_request()
            time.sleep(0.2)
        rcs = []
        for p in procs:
            rcs.append(p.wait())
            fh = getattr(p, "_ddt_log_fh", None)
            if fh is not None:
                fh.close()
        return rcs

    def _poll_join_request(self) -> None:
        req = read_join_request(self.checkpoint_dir)
        if req is None:
            return
        if self.world >= self.max_world:
            # Denied joins are CLEARED, not left standing: the stage
            # barrier exits on a pending join, so an unclearable one would
            # re-trip it on every relaunch.
            clear_join_request(self.checkpoint_dir)
            self._event("join_denied", reason=req.get("reason"),
                        max_world=self.max_world)
            return
        if read_resize_request(self.checkpoint_dir) is not None:
            # A translated-but-unhonored resize is already in flight: leave
            # the join STANDING to be re-polled once that resize resolves —
            # clearing it here would silently drop the request.
            return
        ranks = int(req.get("ranks") or 1)
        target = min(self.max_world, self.world + ranks + (-ranks % self.model))
        request_resize(self.checkpoint_dir, target,
                       reason=f"join: {req.get('reason', '')}"[:200])
        self._event("join_requested", target_world=target,
                    reason=req.get("reason"))
        clear_join_request(self.checkpoint_dir)

    def _tail(self, rank: int) -> str:
        path = os.path.join(self.log_dir,
                            f"child_a{self.attempt}_r{rank}.log")
        try:
            with open(path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                fh.seek(max(0, fh.tell() - 2000))
                return fh.read().decode(errors="replace")
        except OSError:
            return ""

    # --------------------------------------------------------------- policy

    def _classify(self, rcs: list[int]) -> tuple[str, dict]:
        """One attempt's verdict: ``done`` / ``preempted`` / ``shrink`` /
        ``restart`` — plus the evidence (dead ranks named by exit signal and
        by heartbeat staleness)."""
        reaped = getattr(self, "_reaped", set())
        dead = [r for r, rc in enumerate(rcs)
                if rc is not None and rc < 0 and r not in reaped]
        _, stale = survivors(self.heartbeat_dir, len(rcs),
                             self.stale_after_s)
        info = {"rcs": rcs, "dead_ranks": dead, "stale_ranks": stale,
                "reaped_ranks": sorted(reaped)}
        if dead:
            return "shrink", info
        if all(rc == 0 for rc in rcs):
            return "done", info
        if all(rc in (0, EXIT_PREEMPTED) for rc in rcs):
            return "preempted", info
        return "restart", info

    # ----------------------------------------------------------------- run

    def run(self) -> int:
        # Stale control files from a previous incarnation must not trigger
        # a phantom resize on attempt 0.
        clear_resize_request(self.checkpoint_dir)
        clear_join_request(self.checkpoint_dir)
        self._event("supervise", command=self.command,
                    min_world=self.min_world, max_world=self.max_world,
                    restarts=self.restarts_left)
        last_rcs: list[int] = []
        while True:
            self._coordinator = f"127.0.0.1:{free_port()}"
            world = self.world
            if self._classified_mono is not None:
                # Supervision gap: fault classification -> this relaunch.
                # The full recovery wall (through restore + compile to the
                # first training step) is the postmortem's record-derived
                # number; this is the slice the supervisor itself owns.
                self._lost_wall_s += time.monotonic() - self._classified_mono
                self._classified_mono = None
            self.worlds.append(world)
            self._event("launch", coordinator=(self._coordinator
                                               if world > 1 else None),
                        resume=self.attempt > 0)
            procs = [self._spawn(world, rank, self.attempt, self._coordinator)
                     for rank in range(world)]
            rcs = self._wait_attempt(procs)
            last_rcs = rcs
            action, info = self._classify(rcs)
            if action != "done":
                self._classified_mono = time.monotonic()
            self._event("children_exited", action=action, **info)
            if action == "done":
                self._event("complete")
                return 0
            if action == "preempted":
                # A join written just before the children's last stage
                # boundary may not have met the wait loop's periodic poll —
                # translate it NOW so the barrier exit it caused
                # ("join_pending") resolves into a resize, not a restart.
                self._poll_join_request()
                resize = read_resize_request(self.checkpoint_dir)
                if resize is not None and resize.get("world"):
                    # The clean stage-boundary exit we asked for: grow (or
                    # operator-directed shrink) to the requested world.
                    new_world = max(self.min_world,
                                    min(self.max_world,
                                        self._tiled(int(resize["world"]))))
                    clear_resize_request(self.checkpoint_dir)
                    self._event("grow" if new_world > world else "resize",
                                new_world=new_world)
                    self.world = new_world
                    self._next_attempt()
                    # A requested resize is not a failure: no budget, and
                    # the gap to its relaunch is not LOST wall (same
                    # exclusion the postmortem's lineage_view applies).
                    self._classified_mono = None
                    continue
                if resize is not None:
                    # Malformed request (corrupt file, world=0): the stage
                    # barrier honored it, but it names no world to resize
                    # to. Clear it HERE or every relaunch re-trips the
                    # barrier — a livelock that burns the whole restart
                    # budget on one stray control file.
                    clear_resize_request(self.checkpoint_dir)
                    self._event("resize_invalid", request=resize)
                if not self.cfg.elastic.resume_preempted:
                    self._event("preempted_exit")
                    return EXIT_PREEMPTED
            if self.budget.exhausted():
                for rank, rc in enumerate(rcs):
                    if rc not in (0,):
                        print(f"[elastic] rank {rank} rc={rc} tail:\n"
                              f"{self._tail(rank)}", file=sys.stderr,
                              flush=True)
                self._event("give_up", last_rcs=rcs)
                return max((rc for rc in rcs if rc > 0), default=1)
            backoff = self.budget.spend(self.attempt)
            if action == "shrink":
                # Only exit-by-signal ranks are LOST hosts. A stale
                # heartbeat alone (info["stale_ranks"], reported for
                # triage) is not removal evidence: a survivor that sat
                # through its own watchdog grace before exiting 69 is
                # stale too — and it is exactly the rank coming back.
                dead = sorted(set(info["dead_ranks"]))
                new_world = max(self.min_world, self._tiled(world - len(dead)))
                clear_rank_artifacts(self.checkpoint_dir, self.heartbeat_dir,
                                     [r for r in range(new_world, world)],
                                     attempt=self.attempt)
                self._event("shrink", dead_ranks=dead, new_world=new_world,
                            reaped_ranks=info["reaped_ranks"],
                            restarts_left=self.restarts_left)
                self.world = new_world
            else:
                self._event("restart", restarts_left=self.restarts_left)
            if backoff:
                time.sleep(backoff)
            self._next_attempt()

    # ------------------------------------------------------------- terminal

    def lineage_block(self) -> dict:
        """The run's lineage summary for the supervisor's terminal
        ``run_summary``: attempts launched, the world size of each, how many
        relaunches were RECOVERIES (shrink/restart — a requested grow is not
        a failure), and the wall the supervision gaps cost. The postmortem
        derives the richer per-recovery chains from the records; this block
        is the one-line answer a dashboard reads."""
        recoveries = sum(e["event"] in ("shrink", "restart")
                         for e in self.events)
        # supervision_gap_s, NOT lost_wall_s: the supervisor owns only the
        # classification -> relaunch slice. The full classification ->
        # training-again wall needs the children's records and is the
        # postmortem's lost_wall_s — one key per meaning, so a reader
        # joining this record against a postmortem_report can never
        # mistake the ~0.2 s gap for the ~4.5 s wall (or vice versa).
        return {"run_id": self.run_id, "attempts": len(self.worlds) or 1,
                "worlds": list(self.worlds),
                "recoveries": recoveries,
                "supervision_gap_s": round(self._lost_wall_s, 3)}

    def exit_class(self, rc: int) -> str:
        return classify_rc(rc)
