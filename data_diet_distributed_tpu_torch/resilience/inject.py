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

The classes here are the JAX package's training classes, its storage
classes (the ``shard_read`` site of ``data/sharded.py``) and its consensus
ones, under its field names: ``rank`` targets a plan at one process of a
process group, and ``hide_latest_durable`` drops a rank's newest verified
step from its consensus-restore candidates (the ``durable_candidates`` site
of ``fit``). Its other classes (``NOT_PORTED``: host kill and rejoin, which
belong to elastic supervision, and the serve classes) have no site in this
package yet; a plan that arms one is refused by name.
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
    truncate_after_save_step: int | None = None  # corrupt the ckpt saved at step N
    nan_loss_at_epoch: int | None = None   # replace epoch N's train loss with NaN
    # SIGTERM self after N seed score passes have persisted their partials.
    sigterm_after_seed_scores: int | None = None
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
    rank: int | None = None                # target process index (None = all)


#: The JAX package's FaultPlan fields this package cannot fire yet.
NOT_PORTED = ("kill_rank_after_epoch", "rejoin_after_stage",
              "kill_replica_after_requests", "wedge_dispatcher_after",
              "partition_replica_after", "partition_seconds", "slow_replica_ms",
              "slow_if_step")


class FaultInjector:
    def __init__(self):
        self.plan: FaultPlan | None = None
        self.fired: set[str] = set()

    def _rank_targeted(self) -> bool:
        """Whether this process is the plan's target (always, untargeted)."""
        return self.plan.rank is None or process_index() == self.plan.rank

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


def deactivate() -> None:
    _INJECTOR.plan = None
    _INJECTOR.fired = set()


def active_plan() -> FaultPlan | None:
    return _INJECTOR.plan


def fire(site: str, **ctx) -> None:
    _INJECTOR.fire(site, **ctx)


def transform(site: str, value, **ctx):
    return _INJECTOR.transform(site, value, **ctx)


def plan_from_dict(spec: dict, where: str = "fault plan") -> FaultPlan:
    """A ``FaultPlan`` from JAX-package keys. A key of a class this package
    cannot fire yet, or an unknown key, raises ``ValueError`` naming it: a
    drill is never silently disarmed."""
    unported = sorted(set(spec) & set(NOT_PORTED))
    if unported:
        raise ValueError(
            f"{where}: fault classes {unported} are not ported to the PyTorch "
            "package yet (no site fires them; ROADMAP.md Queue 1)")
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
