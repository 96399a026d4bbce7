"""SLO engine (counterpart of ``data_diet_distributed_tpu/obs/slo.py``):
objectives declared in config (``obs.slo_*``), evaluated during the run at
the points where their inputs exist.

Training objectives:

* **throughput floor**: a steady epoch's ``examples_per_s`` against
  ``slo_throughput_floor`` and/or ``slo_throughput_frac`` × the trailing
  baseline of the ``obs.perf_ledger`` ledger (``ledger_baseline``: clean
  ``perf_history`` records of the same geometry and backend, ``cuda`` or
  ``cpu``, so a port run is never held to a TPU's); the warm-up epoch is
  exempt;
* **eval-accuracy floor**: ``slo_eval_accuracy_floor`` against each eval;
* **nonfinite scores**: ``slo_nonfinite_frac`` against the NaN/inf fraction
  of a scoring pass's output;
* **heartbeat staleness**: ``slo_heartbeat_stale_s`` against the stalest
  rank's heartbeat age at steady epoch boundaries (``obs/fleet.py``);
* **recovery**: ``slo_recovery_s``, the one objective across attempts: on a
  supervised relaunch (lineage attempt > 0), the wall from the supervisor's
  classification of the previous attempt (its ``children_exited`` record in
  the shared stream; else the last fault record) to this attempt's first
  training step. One verdict per relaunched attempt; a requested grow or
  resize never arms it. ``obs/postmortem.py --recovery-budget-s`` applies
  the same budget offline.

Serving objectives, at every ``serve_stats`` point of the serve loop:

* **p95 request latency** against ``slo_serve_p95_ms``; a violation names the
  phase whose live p95 is largest (``dominant_phase``, from the request
  trace histograms);
* **pending queue depth** against ``slo_serve_queue_depth``;
* **admission**: the rejected fraction of all submits so far against
  ``slo_serve_reject_frac``.

Each violation emits ONE ``{"kind": "slo_violation"}`` record, increments the
``slo_violations`` counter, sets the ``slo_ok`` / ``slo_margin:<name>``
gauges, and is retained (bounded) for the ``/healthz`` verdict and
``run_summary.slo``. A sustained breach re-records at each new evaluation
point, never twice for one. The fleet objectives (``slo_fleet_*``) go with
the serving fleet, which is not ported; the config refuses them by name.
Module-level slot, no-op until installed. Imports no torch.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import registry as obs_registry

__all__ = ["SloEngine", "ledger_baseline", "install", "uninstall", "current",
           "check_epoch", "check_scores", "check_serve", "arm_recovery",
           "note_training_step", "DEFAULT_BASELINE_WINDOW"]

#: Trailing clean records forming the ledger baseline.
DEFAULT_BASELINE_WINDOW = 5

#: Retained violations (the /healthz verdict); the JSONL holds them all.
MAX_RETAINED = 64


def _clean_value(rec: dict, field: str) -> float | None:
    """Error records, non-ok exit classes and non-positive or non-numeric
    values never enter a baseline."""
    if rec.get("error") or rec.get("exit_class") not in (None, "ok"):
        return None
    v = rec.get(field)
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return None
    v = float(v)
    if v != v or v <= 0:
        return None
    return v


def ledger_baseline(path: str | None, *, field: str = "examples_per_s",
                    metric: str | None = None, geometry: dict | None = None,
                    backend: str | None = None,
                    window: int = DEFAULT_BASELINE_WINDOW) -> float | None:
    """Median of the last ``window`` clean ``perf_history`` records' ``field``
    (filtered to one metric, geometry and backend when given); None when the
    ledger is absent or holds no such record."""
    if not path or not os.path.exists(path):
        return None
    values: list[float] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(rec, dict) or rec.get("kind") != "perf_history":
                    continue
                if metric is not None and rec.get("metric") != metric:
                    continue
                if geometry is not None and rec.get("geometry") != geometry:
                    continue
                if backend is not None and rec.get("backend") != backend:
                    continue
                v = _clean_value(rec, field)
                if v is not None:
                    values.append(v)
    except OSError:
        return None
    if not values:
        return None
    return float(np.median(values[-window:]))


def geometry_of(cfg) -> dict:
    """The ledger's grouping key of a run (``cli._append_perf_ledger`` writes
    the same block)."""
    return {"dataset": cfg.data.dataset, "arch": cfg.model.arch,
            "batch": cfg.data.batch_size, "epochs": cfg.train.num_epochs,
            "method": cfg.score.method}


class SloEngine:
    def __init__(self, *, throughput_floor: float | None = None,
                 throughput_frac: float | None = None, ledger: str | None = None,
                 heartbeat_stale_s: float | None = None,
                 nonfinite_frac: float | None = None,
                 eval_accuracy_floor: float | None = None,
                 recovery_s: float | None = None,
                 serve_p95_ms: float | None = None,
                 serve_queue_depth: int | None = None,
                 serve_reject_frac: float | None = None,
                 baseline_window: int = DEFAULT_BASELINE_WINDOW,
                 geometry: dict | None = None, backend: str | None = None,
                 logger=None):
        self.throughput_floor = throughput_floor
        self.throughput_frac = throughput_frac
        self.ledger = ledger
        # The baseline's grouping: runs of this shape on this backend only.
        self.geometry = geometry
        self.backend = backend
        self.baseline_window = baseline_window
        self.nonfinite_frac = nonfinite_frac
        self.eval_accuracy_floor = eval_accuracy_floor
        self.heartbeat_stale_s = heartbeat_stale_s
        self.recovery_s = recovery_s
        # The recovery clock: the classification's ts (read at resume) and
        # the latch of the attempt's one verdict.
        self._recovery_anchor: float | None = None
        self._recovery_attempt = 0
        self._recovery_done = False
        self.serve_p95_ms = serve_p95_ms
        self.serve_queue_depth = serve_queue_depth
        self.serve_reject_frac = serve_reject_frac
        self.logger = logger
        self.violations: list[dict] = []   # bounded retention (MAX_RETAINED)
        self.total_violations = 0          # exact count, never trimmed
        self._seen_points: set = set()
        # The ledger is read once, at the first steady check.
        self._baseline: float | None = None
        self._baseline_resolved = False

    @classmethod
    def from_cfg(cls, cfg, logger=None, backend: str | None = None) -> "SloEngine | None":
        """None when the config declares no objective (is-not-None:
        ``slo_serve_reject_frac=0.0`` and ``slo_nonfinite_frac=0.0`` arm it).
        ``backend`` (``cuda`` / ``cpu``) filters the ledger baseline."""
        o = cfg.obs
        if all(v is None for v in (
                o.slo_throughput_floor, o.slo_throughput_frac, o.slo_heartbeat_stale_s,
                o.slo_nonfinite_frac, o.slo_eval_accuracy_floor, o.slo_recovery_s,
                o.slo_serve_p95_ms,
                o.slo_serve_queue_depth, o.slo_serve_reject_frac)):
            return None
        return cls(throughput_floor=o.slo_throughput_floor,
                   throughput_frac=o.slo_throughput_frac, ledger=o.perf_ledger,
                   geometry=geometry_of(cfg), backend=backend,
                   heartbeat_stale_s=o.slo_heartbeat_stale_s,
                   nonfinite_frac=o.slo_nonfinite_frac,
                   eval_accuracy_floor=o.slo_eval_accuracy_floor,
                   recovery_s=o.slo_recovery_s,
                   serve_p95_ms=o.slo_serve_p95_ms,
                   serve_queue_depth=o.slo_serve_queue_depth,
                   serve_reject_frac=o.slo_serve_reject_frac, logger=logger)

    def objectives(self) -> dict:
        """The configured floors and budgets (for the verdict), the resolved
        ledger baseline once known."""
        out = {k: getattr(self, k) for k in
               ("throughput_floor", "throughput_frac", "heartbeat_stale_s",
                "nonfinite_frac", "eval_accuracy_floor", "recovery_s", "serve_p95_ms",
                "serve_queue_depth", "serve_reject_frac")
               if getattr(self, k) is not None}
        if self._baseline_resolved:
            out["throughput_baseline"] = self._baseline
        return out

    def _resolved_floor(self) -> float | None:
        """The larger of the absolute floor and frac × the ledger baseline."""
        floors = []
        if self.throughput_floor is not None:
            floors.append(float(self.throughput_floor))
        if self.throughput_frac is not None:
            if not self._baseline_resolved:
                self._baseline = ledger_baseline(
                    self.ledger, geometry=self.geometry, backend=self.backend,
                    window=self.baseline_window)
                self._baseline_resolved = True
            if self._baseline is not None:
                floors.append(self.throughput_frac * self._baseline)
        return max(floors) if floors else None

    def _violate(self, name: str, value, threshold, *, logger=None,
                 point=None, **ctx) -> None:
        if point is not None:
            key = (name, point)
            if key in self._seen_points:
                return   # one record per (objective, evaluation point)
            self._seen_points.add(key)
        rec = {"slo": name, "value": value, "threshold": threshold, **ctx}
        self.violations.append(rec)
        self.total_violations += 1
        del self.violations[:-MAX_RETAINED]
        obs_registry.inc("slo_violations")
        obs_registry.set_gauge("slo_ok", 0.0)
        if isinstance(value, (int, float)) and isinstance(threshold, (int, float)):
            obs_registry.set_gauge(f"slo_margin:{name}", float(value) - float(threshold))
        logger = logger or self.logger
        if logger is not None:
            logger.log("slo_violation", **rec)

    def _mark_ok(self) -> None:
        if not self.violations:
            obs_registry.set_gauge("slo_ok", 1.0)

    def verdict(self) -> dict:
        """The run-so-far verdict (the ``/healthz`` slo block)."""
        return {"ok": self.total_violations == 0,
                "violations": self.total_violations,
                "recent": self.violations[-5:],
                "objectives": self.objectives()}

    def check_epoch(self, *, tag: str, epoch: int,
                    examples_per_s: float | None = None,
                    eval_accuracy: float | None = None,
                    steady: bool = True, logger=None) -> None:
        """An epoch boundary: the throughput floor (steady epochs), the
        eval-accuracy floor, and the heartbeat staleness budget (steady)."""
        if steady and examples_per_s is not None:
            floor = self._resolved_floor()
            if floor is not None and examples_per_s < floor:
                self._violate("throughput", round(float(examples_per_s), 1),
                              round(floor, 1), logger=logger,
                              point=("epoch", tag, epoch), tag=tag, epoch=epoch,
                              baseline=self._baseline)
        if (eval_accuracy is not None and self.eval_accuracy_floor is not None
                and eval_accuracy < self.eval_accuracy_floor):
            self._violate("eval_accuracy", round(float(eval_accuracy), 4),
                          self.eval_accuracy_floor, logger=logger,
                          point=("eval", tag, epoch), tag=tag, epoch=epoch)
        if self.heartbeat_stale_s is not None and steady:
            self._check_heartbeats(tag=tag, epoch=epoch, logger=logger)
        self._mark_ok()

    def _check_heartbeats(self, *, tag: str, epoch: int, logger=None) -> None:
        from . import heartbeat as obs_heartbeat
        hb = obs_heartbeat.current()
        if hb is None:
            return
        from .fleet import fleet_view
        view = fleet_view(hb.directory, stale_budget_s=self.heartbeat_stale_s)
        if view is None or view["straggler_rank"] is None:
            return
        self._violate("heartbeat_staleness", view["stalest_age_s"],
                      self.heartbeat_stale_s, logger=logger,
                      point=("heartbeat", tag, epoch), tag=tag, epoch=epoch,
                      rank=view["straggler_rank"], reason=view["straggler_reason"])

    def check_scores(self, method: str, scores, *, logger=None) -> None:
        """A scoring pass: the nonfinite-score budget over its output."""
        if self.nonfinite_frac is None:
            return
        arr = np.asarray(scores)
        if arr.size == 0:
            return
        frac = float(np.mean(~np.isfinite(arr)))
        if frac > self.nonfinite_frac:
            self._violate("nonfinite_scores", round(frac, 6), self.nonfinite_frac,
                          logger=logger, point=("scores", method), method=method,
                          n=int(arr.size))
        self._mark_ok()

    def arm_recovery(self, metrics_path: str | None) -> bool:
        """Arm the recovery clock at resume time (attempt > 0 only): read the
        shared lineage-stamped stream for the supervisor's classification of
        an earlier attempt (``children_exited``; else the last fault-class
        record) and anchor the clock there, so the budget covers relaunch,
        restore and first step, not only this process's start. A requested
        grow or resize never arms (it is no failure). Returns whether armed."""
        if self.recovery_s is None or self._recovery_done \
                or self._recovery_anchor is not None:
            return self._recovery_anchor is not None
        from . import lineage
        lin = lineage.current() or lineage.ensure()
        if lin.attempt == 0 or not metrics_path:
            return False
        from .timeline import read_records
        classified = fault_ts = None
        requested = False
        for rec in read_records(metrics_path):
            if not isinstance(rec.get("ts"), (int, float)):
                continue
            att = rec.get("attempt")
            if not isinstance(att, int) or att >= lin.attempt:
                continue
            if rec.get("kind") == "elastic_event":
                if rec.get("event") == "children_exited":
                    classified = rec["ts"]
                    requested = False
                elif rec.get("event") in ("shrink", "grow", "resize", "restart"):
                    # The decision after the classification: the last pair
                    # (the transition into this attempt) stands at the end.
                    requested = rec["event"] in ("grow", "resize")
            elif rec.get("kind") in ("fault", "preempted"):
                fault_ts = rec["ts"]   # the last fault-class record wins
        if classified is not None and requested:
            return False
        anchor = classified if classified is not None else fault_ts
        if anchor is None:
            return False
        self._recovery_anchor = anchor
        self._recovery_attempt = lin.attempt
        return True

    def note_training_step(self, *, logger=None, now: float | None = None) -> None:
        """The recovery clock's far end: the first training step after an
        armed resume. One verdict per attempt: the wall as the
        ``slo_recovery_wall_s`` gauge, and a violation only past the budget."""
        if self._recovery_anchor is None or self._recovery_done:
            return
        self._recovery_done = True
        import time as _time
        wall = (now if now is not None else _time.time()) - self._recovery_anchor
        # Disarmed: the module-level hook is one attribute check again.
        self._recovery_anchor = None
        obs_registry.set_gauge("slo_recovery_wall_s", round(wall, 3))
        if self.recovery_s is not None and wall > self.recovery_s:
            self._violate("recovery", round(wall, 3), self.recovery_s, logger=logger,
                          point=("recovery", self._recovery_attempt),
                          attempt=self._recovery_attempt)
        self._mark_ok()

    def check_serve(self, *, point, p95_ms: float | None = None,
                    queue_depth: int | None = None,
                    reject_frac: float | None = None, logger=None,
                    phases: dict | None = None) -> None:
        """One serve_stats point: p95 vs ``slo_serve_p95_ms`` (naming the
        dominant phase from ``phases``, the reqtrace per-phase summary), queue
        depth vs ``slo_serve_queue_depth``, rejected fraction vs
        ``slo_serve_reject_frac``. ``point`` is the stats sequence number."""
        if (self.serve_p95_ms is not None and p95_ms is not None
                and p95_ms > self.serve_p95_ms):
            ctx = {}
            if phases:
                dom = max(phases, key=lambda p: phases[p].get("p95") or 0.0)
                ctx = {"dominant_phase": dom,
                       "dominant_phase_p95_ms": phases[dom].get("p95")}
            self._violate("serve_p95", round(float(p95_ms), 3), self.serve_p95_ms,
                          logger=logger, point=("serve_p95", point), **ctx)
        if (self.serve_queue_depth is not None and queue_depth is not None
                and queue_depth > self.serve_queue_depth):
            self._violate("serve_queue_depth", int(queue_depth),
                          self.serve_queue_depth, logger=logger,
                          point=("serve_queue", point))
        if (self.serve_reject_frac is not None and reject_frac is not None
                and reject_frac > self.serve_reject_frac):
            self._violate("serve_admission", round(float(reject_frac), 6),
                          self.serve_reject_frac, logger=logger,
                          point=("serve_admission", point))
        self._mark_ok()


# --------------------------------------------------------- module-level slot

_ENGINE: SloEngine | None = None


def install(engine: SloEngine) -> SloEngine:
    global _ENGINE
    _ENGINE = engine
    return engine


def uninstall() -> None:
    global _ENGINE
    _ENGINE = None


def current() -> SloEngine | None:
    return _ENGINE


def check_epoch(**kwargs) -> None:
    """Library-code entry (the epoch boundary): no-op until installed."""
    if _ENGINE is not None:
        _ENGINE.check_epoch(**kwargs)


def check_scores(method: str, scores, *, logger=None) -> None:
    if _ENGINE is not None:
        _ENGINE.check_scores(method, scores, logger=logger)


def check_serve(**kwargs) -> None:
    """Library-code entry (the serve loop's stats points): no-op until an
    engine is installed."""
    if _ENGINE is not None:
        _ENGINE.check_serve(**kwargs)


def arm_recovery(metrics_path: str | None) -> None:
    """Library-code entry (``fit``'s resume): no-op until installed."""
    if _ENGINE is not None:
        _ENGINE.arm_recovery(metrics_path)


def note_training_step(*, logger=None) -> None:
    """The train loop's per-step hook: one attribute check unless the
    recovery clock is armed."""
    if _ENGINE is not None and _ENGINE._recovery_anchor is not None:
        _ENGINE.note_training_step(logger=logger)
