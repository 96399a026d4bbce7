"""Cross-rank fleet view (counterpart of
``data_diet_distributed_tpu/obs/fleet.py``): merged heartbeats, straggler
naming, ``fleet_status`` records.

``fleet_view`` merges every rank's heartbeat (``obs/heartbeat.py``) into
per-rank step/epoch/stage/age rows with the step lag behind the fleet's
newest step, names the stalest rank and, when it is past the staleness
budget, the straggler. ``{"kind": "fleet_status"}`` records come from two
paths:

* ``maybe_emit``: rank 0 at each epoch boundary of a multi-rank fit;
* the watch thread (``FleetMonitor.start_watch``, multi-rank runs): samples
  the heartbeat directory on its own clock and emits on straggler
  transitions, also while the training thread is stuck in a collective.

Module-level slot, no-op until installed. The SLO engine's heartbeat check
and ``/healthz`` read the same merge. Imports no torch.
"""

from __future__ import annotations

import threading
import time

from .heartbeat import read_heartbeats

__all__ = ["fleet_view", "FleetMonitor", "install", "uninstall", "current",
           "maybe_emit", "DEFAULT_STALE_BUDGET_S"]

#: Staleness budget when the run configures none (obs.slo_heartbeat_stale_s).
DEFAULT_STALE_BUDGET_S = 60.0


def fleet_view(heartbeat_dir: str, *, now: float | None = None,
               stale_budget_s: float = DEFAULT_STALE_BUDGET_S) -> dict | None:
    """Merge every rank's heartbeat into one fleet dict (None when the
    directory holds no heartbeats).

    Per rank: last-known step/epoch/stage/host, heartbeat age, and ``lag``
    (the fleet's newest step minus this rank's — 0 in lockstep, positive for
    a rank that fell behind in a non-lockstep phase). Fleet-level:
    ``stalest_rank``/``stalest_age_s`` (always), ``slowest_rank``/``max_lag``
    (when steps are known), and ``straggler_rank``/``straggler_reason`` —
    the stalest rank IF its age exceeds the budget, else None: naming is a
    verdict, not a ranking, so healthy fleets name nobody."""
    beats = read_heartbeats(heartbeat_dir)
    if not beats:
        return None
    now = time.time() if now is None else now
    steps = {rank: rec.get("step") for rank, rec in beats.items()}
    known = [s for s in steps.values() if s is not None]
    max_step = max(known) if known else None
    ranks = []
    for rank, rec in sorted(beats.items()):
        lag = (max_step - steps[rank]
               if max_step is not None and steps[rank] is not None else None)
        ranks.append({"rank": int(rank), "step": steps[rank],
                      "epoch": rec.get("epoch"), "stage": rec.get("stage"),
                      "host": rec.get("host"),
                      "age_s": round(now - float(rec.get("ts", now)), 3),
                      "lag": lag})
    stalest = max(ranks, key=lambda r: r["age_s"])
    out: dict = {"n_ranks": len(ranks), "ranks": ranks,
                 "max_step": max_step,
                 "stalest_rank": stalest["rank"],
                 "stalest_age_s": stalest["age_s"],
                 "stale_budget_s": float(stale_budget_s),
                 "slowest_rank": None, "max_lag": None,
                 "straggler_rank": None, "straggler_reason": None}
    lagged = [r for r in ranks if r["lag"] is not None]
    if lagged:
        slowest = max(lagged, key=lambda r: r["lag"])
        out["slowest_rank"] = slowest["rank"]
        out["max_lag"] = slowest["lag"]
    if stalest["age_s"] > stale_budget_s:
        out["straggler_rank"] = stalest["rank"]
        reason = (f"rank{stalest['rank']} last progressed "
                  f"{stalest['age_s']:.1f}s ago "
                  f"(budget {stale_budget_s:g}s)")
        if stalest.get("step") is not None:
            reason += f" at step {stalest['step']}"
        out["straggler_reason"] = reason
    return out


class FleetMonitor:
    """Fleet aggregation bound to one heartbeat directory.

    ``emit`` logs a ``fleet_status`` record (and refreshes the ``fleet_*``
    gauges) when at least ``min_ranks`` heartbeats exist — single-process
    runs produce no fleet noise. ``start_watch`` adds the independent
    sampling thread with edge-triggered emission on straggler transitions."""

    def __init__(self, directory: str, *,
                 stale_budget_s: float = DEFAULT_STALE_BUDGET_S,
                 logger=None, min_ranks: int = 2):
        self.directory = directory
        self.stale_budget_s = float(stale_budget_s)
        self.logger = logger
        self.min_ranks = int(min_ranks)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_straggler: int | None = None

    def view(self) -> dict | None:
        return fleet_view(self.directory, stale_budget_s=self.stale_budget_s)

    def emit(self, logger=None, view: dict | None = None) -> dict | None:
        """One ``fleet_status`` record from the current view (None when
        under ``min_ranks``). Thread-safe by the same argument the flight
        recorder makes: the logger's write path takes its own locks."""
        view = view if view is not None else self.view()
        if view is None or view["n_ranks"] < self.min_ranks:
            return None
        logger = logger or self.logger
        if logger is not None:
            logger.log("fleet_status", **view)
        from . import registry as obs_registry
        obs_registry.set_gauge("fleet_n_ranks", view["n_ranks"])
        obs_registry.set_gauge("fleet_stalest_age_s", view["stalest_age_s"])
        if view["max_lag"] is not None:
            obs_registry.set_gauge("fleet_max_lag", view["max_lag"])
        return view

    # ------------------------------------------------------- watch thread

    def start_watch(self, interval_s: float | None = None) -> None:
        """Sample on a daemon thread; emit on straggler transitions. The
        interval defaults to a quarter of the staleness budget (bounded to
        [0.25s, 10s]) so a budget-crossing is seen within ~25% of the
        budget."""
        if self._thread is not None:
            return
        if interval_s is None:
            interval_s = min(10.0, max(0.25, self.stale_budget_s / 4.0))
        self._thread = threading.Thread(
            target=self._watch, args=(float(interval_s),),
            name="obs-fleet-watch", daemon=True)
        self._thread.start()

    def stop_watch(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._stop.clear()

    def _watch(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                view = self.view()
                if view is None or view["n_ranks"] < self.min_ranks:
                    continue
                from . import registry as obs_registry
                obs_registry.set_gauge("fleet_stalest_age_s",
                                       view["stalest_age_s"])
                straggler = view["straggler_rank"]
                if straggler != self._last_straggler:
                    # Transition (a rank crossed the budget, or recovered):
                    # emit once — the record that survives a wedged main
                    # thread.
                    self._last_straggler = straggler
                    self.emit(view=view)
            except Exception:   # noqa: BLE001 — observation must never kill a run
                continue


# --------------------------------------------------------- module-level slot

_MONITOR: FleetMonitor | None = None


def install(monitor: FleetMonitor) -> FleetMonitor:
    global _MONITOR
    _MONITOR = monitor
    return monitor


def uninstall() -> None:
    global _MONITOR
    if _MONITOR is not None:
        _MONITOR.stop_watch()
    _MONITOR = None


def current() -> FleetMonitor | None:
    return _MONITOR


def maybe_emit(logger=None) -> dict | None:
    """The training loop's epoch-boundary hook: rank 0 emits one
    ``fleet_status`` record when a monitor is installed (no-op otherwise —
    one is-None check, same contract as every obs helper)."""
    if _MONITOR is None:
        return None
    from ..parallel.mesh import process_index
    if process_index() != 0:
        return None
    return _MONITOR.emit(logger)
