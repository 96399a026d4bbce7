"""SLO engine, serving objectives (counterpart of
``data_diet_distributed_tpu/obs/slo.py``).

Objectives declared in config (``obs.slo_serve_*``), evaluated at every
``serve_stats`` point of the serve loop:

* **p95 request latency** against ``slo_serve_p95_ms``; a violation names the
  phase whose live p95 is largest (``dominant_phase``, from the request
  trace histograms);
* **pending queue depth** against ``slo_serve_queue_depth``;
* **admission**: the rejected fraction of all submits so far against
  ``slo_serve_reject_frac``.

Each violation emits ONE ``{"kind": "slo_violation"}`` record, increments the
``slo_violations`` counter, sets the ``slo_ok`` / ``slo_margin:<name>``
gauges, and is retained (bounded) for the ``/healthz`` verdict. A sustained
breach re-records at each new evaluation point, never twice for one. The
training, fleet and recovery objectives and the ledger baseline are not
ported. Module-level slot, no-op until installed. Imports no torch.
"""

from __future__ import annotations

from . import registry as obs_registry

__all__ = ["SloEngine", "install", "uninstall", "current", "check_serve"]

#: Retained violations (the /healthz verdict); the JSONL holds them all.
MAX_RETAINED = 64


class SloEngine:
    def __init__(self, *, heartbeat_stale_s: float | None = None,
                 serve_p95_ms: float | None = None,
                 serve_queue_depth: int | None = None,
                 serve_reject_frac: float | None = None, logger=None):
        self.heartbeat_stale_s = heartbeat_stale_s
        self.serve_p95_ms = serve_p95_ms
        self.serve_queue_depth = serve_queue_depth
        self.serve_reject_frac = serve_reject_frac
        self.logger = logger
        self.violations: list[dict] = []   # bounded retention (MAX_RETAINED)
        self.total_violations = 0          # exact count, never trimmed
        self._seen_points: set = set()

    @classmethod
    def from_cfg(cls, cfg, logger=None) -> "SloEngine | None":
        """None when the config declares none of the objectives the port holds
        (is-not-None: ``slo_serve_reject_frac=0.0``, zero tolerated
        rejections, arms it)."""
        o = cfg.obs
        if all(v is None for v in (o.slo_heartbeat_stale_s, o.slo_serve_p95_ms,
                                   o.slo_serve_queue_depth, o.slo_serve_reject_frac)):
            return None
        return cls(heartbeat_stale_s=o.slo_heartbeat_stale_s,
                   serve_p95_ms=o.slo_serve_p95_ms,
                   serve_queue_depth=o.slo_serve_queue_depth,
                   serve_reject_frac=o.slo_serve_reject_frac, logger=logger)

    def objectives(self) -> dict:
        """The configured budgets (for the verdict)."""
        return {k: getattr(self, k) for k in
                ("heartbeat_stale_s", "serve_p95_ms", "serve_queue_depth",
                 "serve_reject_frac") if getattr(self, k) is not None}

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


def check_serve(**kwargs) -> None:
    """Library-code entry (the serve loop's stats points): no-op until an
    engine is installed."""
    if _ENGINE is not None:
        _ENGINE.check_serve(**kwargs)
