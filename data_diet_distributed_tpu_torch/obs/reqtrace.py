"""Request-level tracing for the serve path (copy of
``data_diet_distributed_tpu/obs/reqtrace.py``).

Every serve request carries an ``X-Trace-Id`` header, minted at the
first edge it crosses (load-generating client, router, or a replica hit
directly) and propagated on every hop; every response echoes it back.
Each process that touches the request records named *phase* spans —

========================  ==================================================
phase                      meaning
========================  ==================================================
``admission``              router: draining/idempotency gate before routing
``routing``                router: candidate selection + failed attempts +
                           hedge wait (everything between admission and the
                           winning replica's proxy span)
``proxy``                  router: the winning attempt's wire time
``queue_wait``             replica: enqueue -> first taken into a dispatch,
                           minus any coalesce share
``coalesce_wait``          replica: share of the wait attributable to the
                           deadline-bounded coalescing window (only a
                           partial, window-expired batch pays it)
``dispatch``               replica: the score function's call (a cold
                           first call at a geometry flagged via ``cold``)
``fetch``                  replica: ``.cpu()`` of the scores (waits for the card)
``serialize``              replica: JSON-encoding the response body
========================  ==================================================

emitted as ``{"kind": "serve_trace"}`` records: a replica's with
``where="replica"`` (``serve/server.py``), the router's with
``where="router"`` and the ``replica``, ``retries``, ``hedged``, ``replay``
and per-attempt ``attempts`` fields (``serve/router.py::ServeRouter``,
where a failover shows up as ``routing`` time). Retention is
*tail-biased*: failed, slow, retried, hedged, and replayed requests are
always kept; healthy traffic is head-sampled by hashing the trace id
against ``serve.trace_sample_frac`` — a pure function of the id, so the
router and every replica independently reach the same keep/drop answer
for the same request without coordination.

The attribution half (:func:`attribute`) answers "why is p99 slow": it
takes a stream of ``serve_trace`` records, ranks the tail by wall time,
names the dominant phase per tail request, and returns per-phase
p50/p95 plus exemplar trace ids — consumed by ``tools/request_report.py``,
``run_monitor``, ``postmortem``, and the serve bench.
"""
from __future__ import annotations

import hashlib
import time
import uuid
from typing import Any, Iterable

from . import registry as obs_registry

#: Canonical header names (request + response).
TRACE_HEADER = "X-Trace-Id"
#: Hop-to-hop retention hint: a router that already decided to keep a
#: trace (retry/hedge in flight) sets this on the forwarded request so
#: the replica's record survives sampling too and the lane stitches.
KEEP_HEADER = "X-Trace-Keep"

#: Replica-side phases in request order (used for lane layout + reports).
REPLICA_PHASES = ("queue_wait", "coalesce_wait", "dispatch", "fetch",
                  "serialize")
#: Router-side phases in request order.
ROUTER_PHASES = ("admission", "routing", "proxy")
#: Every phase a serve_trace record may carry, in timeline order.
ALL_PHASES = ROUTER_PHASES + REPLICA_PHASES

#: Registry histogram prefix: each phase feeds ``serve_phase_ms:<phase>``
#: in the emitting process regardless of record retention, so /status and
#: serve_stats always see the full-traffic aggregate.
PHASE_HIST_PREFIX = "serve_phase_ms:"

#: Fallback "slow" threshold when neither serve.trace_slow_ms nor
#: obs.slo_serve_p95_ms is configured.
DEFAULT_SLOW_MS = 250.0


def mint_trace_id() -> str:
    """A fresh 32-hex trace id (uuid4, no dashes)."""
    return uuid.uuid4().hex


def keep_fraction(trace_id: str, frac: float) -> bool:
    """Deterministic head-sampling: hash the trace id into [0, 1) and
    keep when it lands under ``frac``. Same id -> same answer in every
    process, so healthy-traffic sampling agrees across hops for free."""
    if frac >= 1.0:
        return True
    if frac <= 0.0 or not trace_id:
        return False
    h = hashlib.sha256(trace_id.encode("utf-8", "replace")).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64) < frac


def should_keep(trace_id: str, frac: float, *, failed: bool = False,
                slow: bool = False, flagged: bool = False) -> bool:
    """Tail-biased retention: failed/slow/flagged (retried, hedged,
    replayed, or hop-hinted via ``X-Trace-Keep``) always keep; healthy
    traffic falls through to deterministic head-sampling."""
    if failed or slow or flagged:
        return True
    return keep_fraction(trace_id, frac)


def slow_threshold_ms(cfg) -> float:
    """Resolve the "slow request" wall threshold from a Config: explicit
    ``serve.trace_slow_ms`` wins, else the armed serve p95 SLO, else
    :data:`DEFAULT_SLOW_MS`."""
    sv = getattr(cfg, "serve", None)
    explicit = getattr(sv, "trace_slow_ms", None) if sv else None
    if explicit is not None:
        return float(explicit)
    o = getattr(cfg, "obs", None)
    slo = getattr(o, "slo_serve_p95_ms", None) if o else None
    if slo is not None:
        return float(slo)
    return DEFAULT_SLOW_MS


def observe_phases(phases: dict[str, float | None]) -> None:
    """Feed each non-null phase into its ``serve_phase_ms:<phase>``
    registry histogram (full traffic, independent of record retention)."""
    for name, ms in phases.items():
        if ms is None:
            continue
        obs_registry.observe(PHASE_HIST_PREFIX + name, float(ms))


def phase_summary(reg=None) -> dict[str, dict]:
    """Live per-phase aggregate from the registry's
    ``serve_phase_ms:*`` histograms: ``{phase: {count, p50, p95, max}}``.
    Reads only — never mints instruments (peek discipline)."""
    if reg is None:
        reg = obs_registry.current()
    out: dict[str, dict] = {}
    if reg is None:
        return out
    snap = reg.snapshot()
    for name, summ in sorted(snap.get("histograms", {}).items()):
        if not name.startswith(PHASE_HIST_PREFIX):
            continue
        phase = name[len(PHASE_HIST_PREFIX):]
        out[phase] = {"count": summ.get("count"), "p50": summ.get("p50"),
                      "p95": summ.get("p95"), "max": summ.get("max")}
    return out


def emit(logger, *, trace_id: str, where: str, status: int | None,
         wall_ms: float, phases: dict[str, float | None],
         sampled: bool, **fields: Any) -> None:
    """Log one ``serve_trace`` record (no-op without a logger). Extra
    fields ride verbatim: tenant/method/replica/cold on replica records,
    replica/retries/hedged/replay/attempts on router records."""
    if logger is None:
        return
    clean = {k: (round(float(v), 3) if v is not None else None)
             for k, v in phases.items()}
    logger.log("serve_trace", trace_id=trace_id, where=where, status=status,
               wall_ms=round(float(wall_ms), 3), phases=clean,
               sampled=bool(sampled), **fields)


# ---------------------------------------------------------------------------
# tail-latency attribution
# ---------------------------------------------------------------------------

def _percentile(vals: list[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]

def dominant_phase(rec: dict) -> str | None:
    """The phase a single serve_trace record spent the most time in."""
    phases = rec.get("phases") or {}
    best, best_ms = None, -1.0
    for name in ALL_PHASES:
        ms = phases.get(name)
        if ms is not None and float(ms) > best_ms:
            best, best_ms = name, float(ms)
    return best


def attribute(records: Iterable[dict], *, tail_q: float = 0.95,
              where: str | None = None, exemplars: int = 3) -> dict:
    """Tail-latency attribution over ``serve_trace`` records.

    Returns::

        {"requests": N, "where": ...,
         "phases": {phase: {"count", "p50_ms", "p95_ms", "max_ms"}},
         "tail": {"threshold_ms", "requests", "dominant_phase",
                  "phase_counts": {phase: n},
                  "exemplars": {phase: [{"trace_id", "wall_ms"}, ...]}}}

    ``dominant_phase`` is the modal dominant phase across tail requests
    (ties broken toward the larger total tail milliseconds), the named
    answer to "why is p99 slow"; ``exemplars`` lists the slowest trace
    ids per phase so the verdict is checkable against raw traces.
    """
    traces = [r for r in records if r.get("kind") == "serve_trace"
              and (where is None or r.get("where") == where)]
    per_phase: dict[str, list[float]] = {}
    walls: list[tuple[float, dict]] = []
    for r in traces:
        wall = float(r.get("wall_ms") or 0.0)
        walls.append((wall, r))
        for name, ms in (r.get("phases") or {}).items():
            if ms is not None:
                per_phase.setdefault(name, []).append(float(ms))
    phases = {name: {"count": len(vs),
                     "p50_ms": round(_percentile(vs, 0.50), 3),
                     "p95_ms": round(_percentile(vs, 0.95), 3),
                     "max_ms": round(max(vs), 3)}
              for name, vs in sorted(per_phase.items())}
    out: dict[str, Any] = {"requests": len(traces), "where": where,
                           "phases": phases}
    if not traces:
        out["tail"] = None
        return out
    thresh = _percentile([w for w, _ in walls], tail_q)
    tail = [(w, r) for w, r in walls if w >= thresh] or [max(walls,
                                                            key=lambda t: t[0])]
    counts: dict[str, int] = {}
    tail_ms: dict[str, float] = {}
    by_phase: dict[str, list[tuple[float, str]]] = {}
    for w, r in tail:
        dom = dominant_phase(r)
        if dom is None:
            continue
        counts[dom] = counts.get(dom, 0) + 1
        tail_ms[dom] = tail_ms.get(dom, 0.0) + float(
            (r.get("phases") or {}).get(dom) or 0.0)
        by_phase.setdefault(dom, []).append((w, r.get("trace_id") or ""))
    verdict = max(counts, key=lambda p: (counts[p], tail_ms.get(p, 0.0))) \
        if counts else None
    ex = {p: [{"trace_id": tid, "wall_ms": round(w, 3)}
              for w, tid in sorted(lst, reverse=True)[:exemplars]]
          for p, lst in sorted(by_phase.items())}
    out["tail"] = {"threshold_ms": round(thresh, 3), "requests": len(tail),
                   "dominant_phase": verdict, "phase_counts": counts,
                   "exemplars": ex}
    return out


# ---------------------------------------------------------------------------
# per-request span collector (replica side)
# ---------------------------------------------------------------------------

class RequestTrace:
    """Mutable per-request phase collector threaded from the HTTP handler
    through the batcher seam. The batcher/engine fill phase timings in
    place (single consumer: the request's own handler thread reads them
    only after ``done`` fires), the handler adds ``serialize`` and emits.
    """

    __slots__ = ("trace_id", "keep_hint", "start", "phases", "cold",
                 "batch_fill")

    def __init__(self, trace_id: str, *, keep_hint: bool = False):
        self.trace_id = trace_id
        self.keep_hint = bool(keep_hint)
        self.start = time.monotonic()
        self.phases: dict[str, float | None] = {}
        self.cold = False
        self.batch_fill: float | None = None

    def add_ms(self, phase: str, ms: float) -> None:
        self.phases[phase] = self.phases.get(phase, 0.0) + float(ms)

    def wall_ms(self) -> float:
        return (time.monotonic() - self.start) * 1e3
