"""Deterministic fault injection for the single-process training paths (counterpart
of ``data_diet_distributed_tpu/resilience/inject.py``).

Each failure class the resilience layer claims to handle is injectable at an
exact coordinate (a global step or epoch index within a fit, or a count of
scored seeds), and each planned fault fires exactly ONCE, so a recovery retry
replays the same training without re-tripping it, and "recovered to the
uninjected result" is a pinnable assertion.

The sites are no-ops without a plan (one ``None`` check a call). Arm a plan in
process::

    from data_diet_distributed_tpu_torch.resilience import inject
    inject.activate(inject.FaultPlan(hang_at=2, hang_seconds=60))
    try:
        fit_with_recovery(...)
    finally:
        inject.deactivate()

or from the environment for a drill through the CLI:
``DDT_FAULT_PLAN='{"sigterm_at_epoch_end": 0}' python -m
data_diet_distributed_tpu_torch.cli train ...``.

The classes here are all of the JAX package's, under its field names: the
training classes, the storage classes (the ``shard_read`` site of
``data/sharded.py``), the consensus ones, the elastic ones
(``kill_rank_after_epoch``: a SIGKILL at the ``epoch_end`` site, with no
handler, save or agreed exit; ``rejoin_after_stage``: a join request
(``resilience/elastic.py::request_join``) at the ``stage_done`` site of
``resilience/stages.py``) and the serve ones: ``rank`` targets a plan at one
process of a process group (in a serve replica, its ``DDT_SERVE_REPLICA``
index), ``hide_latest_durable`` drops a rank's newest verified step from its
consensus-restore candidates (the ``durable_candidates`` site of ``fit``),
``kill_replica_after_requests`` and ``wedge_dispatcher_after`` fire at the
batcher's ``serve_dispatch`` site (``serve/batcher.py``), and the partition
and slow-replica classes in the HTTP handler's fault gate
(``serve/server.py``, through ``serve_partitioned`` and ``serve_slow_ms``).
An unknown key refuses by name. The elastic supervisor drops
``DDT_FAULT_PLAN`` from every relaunch, so a plan fires in the first attempt
only.
"""

from __future__ import annotations

import json
import os
import signal
import time
from dataclasses import dataclass, fields

from ..parallel.mesh import process_index


@dataclass
class FaultPlan:
    """One coordinate per fault class; ``None`` = that class is off. Step
    coordinates are GLOBAL step indices within a fit (``epoch *
    steps_per_epoch + i``); epoch coordinates are epoch indices. ``rank``
    targets the whole plan at one process of a group (None = every one)."""

    step_exception_at: int | None = None   # raise RuntimeError before step N
    hang_at: int | None = None             # sleep hang_seconds before step N
    hang_seconds: float = 3600.0
    sigterm_at_step: int | None = None     # SIGTERM self before step N (mid-epoch)
    sigterm_at_epoch_end: int | None = None  # SIGTERM self after epoch N
    # SIGKILL self after epoch N (after its checkpoint): a lost host, with no
    # handler, no final save and no agreed exit.
    kill_rank_after_epoch: int | None = None
    truncate_after_save_step: int | None = None  # corrupt the ckpt saved at step N
    nan_loss_at_epoch: int | None = None   # replace epoch N's train loss with NaN
    # SIGTERM self after N seed score passes have persisted their partials.
    sigterm_after_seed_scores: int | None = None
    # When the named pipeline stage completes ("score", "retrain:final",
    # ...), write an elastic join request beside the stage manifest: the
    # supervisor grows the world at the next stage boundary.
    rejoin_after_stage: str | None = None
    # Storage (the shard_read site). Shard S's raw bytes are flipped before
    # the digest check on every read from torn_on_read on: NOT fired once,
    # on-disk corruption does not heal between retries, so the read path
    # must exhaust its retries and quarantine the shard.
    torn_shard_read: int | None = None
    torn_on_read: int = 1
    # OSError(EIO) on read eio_on_read of shard S, fired once: the retry's
    # re-read succeeds and the read recovers in place.
    eio_shard_read: int | None = None
    eio_on_read: int = 1
    # This much latency on every shard read (slow storage); not fired once.
    slow_shard_read_ms: float | None = None
    # Drop the newest step from this rank's consensus-restore candidates, as
    # if its final save never landed (the min-agreed restore drill).
    hide_latest_durable: bool = False
    # Serve (the batcher's serve_dispatch site): SIGKILL self once >= K
    # requests completed, at the start of the next dispatch, so its HTTP
    # requests die unanswered (non-graceful, no drain)...
    kill_replica_after_requests: int | None = None
    # ...and hang the dispatcher (a sleep of hang_seconds) at the start of
    # dispatch K: requests queue, /healthz goes critical past
    # serve.dispatch_stall_s.
    wedge_dispatcher_after: int | None = None
    # Serve network (the HTTP fault gate): once >= K requests completed, drop
    # every connection unanswered for partition_seconds (the process lives)...
    partition_replica_after: int | None = None
    partition_seconds: float = 30.0
    # ...and delay every response by this much, only while the installed
    # model is checkpoint step slow_if_step when that is set.
    slow_replica_ms: float | None = None
    slow_if_step: int | None = None
    rank: int | None = None                # target process index (None = all)


class FaultInjector:
    def __init__(self):
        self.plan: FaultPlan | None = None
        self.fired: set[str] = set()
        # Until when this replica's HTTP surface drops connections (armed by
        # partition_replica_after at the serve_dispatch site).
        self.partition_until: float | None = None

    def _rank_targeted(self) -> bool:
        """Whether this process is the plan's target (always, untargeted). A
        serve replica's rank is its index in ``DDT_SERVE_REPLICA``."""
        if self.plan.rank is None:
            return True
        replica = os.environ.get("DDT_SERVE_REPLICA")
        if replica is not None:
            return int(replica) == self.plan.rank
        return process_index() == self.plan.rank

    def _due(self, fault: str, coord) -> bool:
        """True exactly once, when the plan arms ``fault`` at ``coord`` and this
        process is the targeted rank."""
        if self.plan is None or fault in self.fired:
            return False
        if getattr(self.plan, fault) != coord or not self._rank_targeted():
            return False
        self.fired.add(fault)
        return True

    def fire(self, site: str, **ctx) -> None:
        if self.plan is None or not self._rank_targeted():
            return
        if site == "step":
            step = ctx["step"]
            if self._due("step_exception_at", step):
                raise RuntimeError(f"injected step exception at global step {step}")
            if self._due("hang_at", step):
                # Interruptible: the watchdog's raising handler breaks a sleep,
                # and the sleep does not resume (PEP 475 restarts only calls
                # whose handler returns).
                time.sleep(self.plan.hang_seconds)
            if self._due("sigterm_at_step", step):
                os.kill(os.getpid(), signal.SIGTERM)
        elif site == "epoch_end":
            if self._due("sigterm_at_epoch_end", ctx["epoch"]):
                os.kill(os.getpid(), signal.SIGTERM)
            if self._due("kill_rank_after_epoch", ctx["epoch"]):
                os.kill(os.getpid(), signal.SIGKILL)
        elif site == "stage_done":
            if self._due("rejoin_after_stage", ctx["stage"]):
                from .elastic import checkpoint_dir_from_manifest, request_join
                request_join(checkpoint_dir_from_manifest(ctx["manifest_path"]),
                             ranks=1, reason=f"injected rejoin after {ctx['stage']}")
        elif site == "seed_scored":
            if self._due("sigterm_after_seed_scores", ctx["completed"]):
                os.kill(os.getpid(), signal.SIGTERM)
        elif site == "shard_read":
            # Coordinates: the shard id and its 1-based read count (a retry
            # reads again, and must not re-trip a fired-once fault).
            if self.plan.slow_shard_read_ms is not None:
                time.sleep(self.plan.slow_shard_read_ms / 1000.0)
            s = self.plan.eio_shard_read
            if (s is not None and ctx["shard"] == s
                    and ctx["read"] >= self.plan.eio_on_read
                    and "eio_shard_read" not in self.fired):
                self.fired.add("eio_shard_read")
                raise OSError(5, f"injected EIO on read {ctx['read']} of shard {s}")
        elif site == "checkpoint_saved":
            if self._due("truncate_after_save_step", ctx["step"]):
                truncate_checkpoint(ctx["directory"], ctx["step"])
        elif site == "serve_dispatch":
            # Threshold coordinates (>=): a dispatch coalesces a variable
            # number of requests, so the completed count can jump past K.
            k = self.plan.kill_replica_after_requests
            if (k is not None and ctx["completed"] >= k
                    and "kill_replica_after_requests" not in self.fired):
                self.fired.add("kill_replica_after_requests")
                os.kill(os.getpid(), signal.SIGKILL)
            k = self.plan.wedge_dispatcher_after
            if (k is not None and ctx["dispatch"] >= k
                    and "wedge_dispatcher_after" not in self.fired):
                self.fired.add("wedge_dispatcher_after")
                time.sleep(self.plan.hang_seconds)
            k = self.plan.partition_replica_after
            if (k is not None and ctx["completed"] >= k
                    and "partition_replica_after" not in self.fired):
                self.fired.add("partition_replica_after")
                self.partition_until = time.monotonic() + self.plan.partition_seconds

    def serve_partitioned(self) -> bool:
        """True while the armed partition window is open; expiry clears it."""
        if self.partition_until is None:
            return False
        if time.monotonic() >= self.partition_until:
            self.partition_until = None
            return False
        return True

    def serve_slow_ms(self, model_step: int | None = None) -> float | None:
        """Injected per-response latency of this replica, or None; gated to
        the installed model step when ``slow_if_step`` is armed."""
        if self.plan is None or self.plan.slow_replica_ms is None:
            return None
        if not self._rank_targeted():
            return None
        if self.plan.slow_if_step is not None and model_step != self.plan.slow_if_step:
            return None
        return self.plan.slow_replica_ms

    def transform(self, site: str, value, **ctx):
        if self.plan is None or not self._rank_targeted():
            return value
        if site == "epoch_loss" and self._due("nan_loss_at_epoch", ctx["epoch"]):
            return float("nan")
        if (site == "durable_candidates" and self.plan.hide_latest_durable
                and "hide_latest_durable" not in self.fired and len(value)):
            self.fired.add("hide_latest_durable")
            return [s for s in value if s != max(value)]
        if (site == "shard_read" and self.plan.torn_shard_read is not None
                and ctx["shard"] == self.plan.torn_shard_read
                and ctx["read"] >= self.plan.torn_on_read):
            # A deterministic spread of flipped bytes in the raw buffer, before
            # the digest check, the same on every read.
            buf = bytearray(value)
            step = max(1, len(buf) // 7)
            for i in range(len(buf) // 2, len(buf), step):
                buf[i] ^= 0xFF
            return bytes(buf)
        return value


_INJECTOR = FaultInjector()


def activate(plan: FaultPlan) -> None:
    if not isinstance(plan, FaultPlan):
        raise TypeError(f"activate takes a FaultPlan, got {type(plan).__name__}")
    _INJECTOR.plan = plan
    _INJECTOR.fired = set()
    _INJECTOR.partition_until = None


def deactivate() -> None:
    _INJECTOR.plan = None
    _INJECTOR.fired = set()
    _INJECTOR.partition_until = None


def active_plan() -> FaultPlan | None:
    return _INJECTOR.plan


def fire(site: str, **ctx) -> None:
    _INJECTOR.fire(site, **ctx)


def transform(site: str, value, **ctx):
    return _INJECTOR.transform(site, value, **ctx)


def serve_partitioned() -> bool:
    return _INJECTOR.serve_partitioned()


def serve_slow_ms(model_step: int | None = None) -> float | None:
    return _INJECTOR.serve_slow_ms(model_step)


def plan_from_dict(spec: dict, where: str = "fault plan") -> FaultPlan:
    """A ``FaultPlan`` from JAX-package keys. An unknown key raises
    ``ValueError`` naming it: a drill is never silently disarmed."""
    valid = {f.name for f in fields(FaultPlan)}
    unknown = set(spec) - valid
    if unknown:
        raise ValueError(f"{where}: unknown fault plan keys {sorted(unknown)}; "
                         f"valid: {sorted(valid)}")
    return FaultPlan(**spec)


def activate_from_env(env_var: str = "DDT_FAULT_PLAN") -> FaultPlan | None:
    """Arm a plan from a JSON env var (drills through the CLI)."""
    raw = os.environ.get(env_var)
    if not raw:
        return None
    plan = plan_from_dict(json.loads(raw), env_var)
    activate(plan)
    return plan


def truncate_checkpoint(directory: str, step: int) -> list[str]:
    """Corrupt the checkpoint at ``step`` (``<directory>/step_<N>/``, the
    port's layout) by truncating its largest file to a third, the signature
    of a write cut off by a kill. Returns the paths truncated; refuses when
    none is found, so a layout change never makes the injection test
    nothing."""
    step_dir = os.path.join(os.path.abspath(directory), f"step_{int(step)}")
    candidates: list[tuple[int, str]] = []
    for root, _, names in os.walk(step_dir):
        for name in names:
            p = os.path.join(root, name)
            size = os.path.getsize(p)
            if size > 0:
                candidates.append((size, p))
    if not candidates:
        raise FileNotFoundError(
            f"no non-empty files under {step_dir} to truncate — checkpoint layout "
            "changed or the step was not saved")
    size, path = max(candidates)
    with open(path, "r+b") as fh:
        fh.truncate(max(1, size // 3))
    return [path]
