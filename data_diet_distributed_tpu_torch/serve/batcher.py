"""Request batching/coalescing into padded score dispatches (copy of
``data_diet_distributed_tpu/serve/batcher.py``).

The serving hot path: HTTP handler threads ``submit()`` small example
batches; ONE worker thread drains them into padded ``B``-row dispatches
through the warm engine (``ServeEngine.score_batch``). Three contracts:

* **Coalescing, deadline-bounded** — requests for the same
  ``(tenant, method)`` pack into one dispatch; a partial batch waits at
  most ``coalesce_window_s`` past its OLDEST request's arrival (a full
  batch never waits). Requests larger than ``B`` split across dispatches
  and re-join transparently.
* **Admission control / backpressure** — each tenant's pending-request
  queue is bounded (``max_queue``); a submit past the bound raises
  ``Backpressure`` (the HTTP layer's 429 + Retry-After), recorded as a
  ``{"kind": "serve_admission"}`` event. Draining rejects with
  ``Draining`` (503) instead.
* **Multi-tenant fairness** — the worker drains tenants weighted
  round-robin: each cycle visits every tenant with pending work,
  ``weight`` dispatches each, so one tenant's flood cannot starve
  another's trickle.

Per-request latency (enqueue -> scores ready) lands in the
``serve_request_ms`` registry histogram (the p95 the serve SLO judges) and,
when ``request_log`` is on, as one ``{"kind": "serve_request"}`` record.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..obs import heartbeat as obs_heartbeat
from ..obs import registry as obs_registry
from ..obs import reqtrace as obs_reqtrace
from ..resilience import inject


class Backpressure(Exception):
    """Admission refused: the tenant's queue is full. Carries the 429
    Retry-After hint."""

    def __init__(self, tenant: str, depth: int, retry_after_s: float):
        self.tenant = tenant
        self.depth = depth
        self.retry_after_s = retry_after_s
        super().__init__(f"tenant {tenant!r} queue full ({depth} pending); "
                         f"retry after {retry_after_s:g}s")


class Draining(Exception):
    """Admission stopped: the service is draining for shutdown (503)."""


@dataclass
class _Request:
    tenant: str
    method: str
    images: np.ndarray
    labels: np.ndarray
    enqueued: float
    done: threading.Event = field(default_factory=threading.Event)
    scores: np.ndarray | None = None
    taken: int = 0          # rows already handed to a dispatch
    remaining: int = 0      # rows whose scores are still pending
    error: Exception | None = None
    wall_s: float | None = None
    # --- request-tracing seam (obs/reqtrace) ---------------------------
    trace: object | None = None      # RequestTrace the HTTP layer emits
    taken_ts: float | None = None    # monotonic first-taken-into-a-dispatch
    window_expired: bool = False     # first dispatch departed partial
    dispatch_ms: float = 0.0         # program execution (accumulated)
    fetch_ms: float = 0.0            # .cpu() of the scores
    cold: bool = False               # any dispatch paid a first call

    def __post_init__(self):
        self.scores = np.zeros(len(self.images), np.float32)
        self.remaining = len(self.images)


class ScoreBatcher:
    """Coalescing dispatcher over a ``ServeEngine`` (or any object with
    ``batch_size``, ``score_batch`` and optionally ``tenant_weight``)."""

    def __init__(self, engine, *, max_queue: int = 64,
                 coalesce_window_s: float = 0.005,
                 retry_after_s: float = 1.0, request_log: bool = True,
                 logger=None):
        self.engine = engine
        self.batch_size = int(engine.batch_size)
        self.max_queue = int(max_queue)
        self.window_s = float(coalesce_window_s)
        self.retry_after_s = float(retry_after_s)
        self.request_log = request_log
        self.logger = logger
        self._queues: dict[str, deque[_Request]] = {}
        self._rr: list[str] = []      # weighted round-robin drain order
        self._cursor = 0
        self._cv = threading.Condition()
        self._admitting = True
        self._stopping = False
        self._inflight = 0            # requests taken off a queue, not done
        self.accepted = 0
        self.rejected = 0
        self.completed = 0
        self.failed = 0
        self.dispatches = 0
        self.rows_dispatched = 0
        self.rows_padded = 0
        self._thread: threading.Thread | None = None
        # Serve-side watchdog evidence: monotonic start of the dispatch the
        # worker is INSIDE right now (None between dispatches). A wedged
        # dispatcher — engine hang, injected wedge — leaves this set, and
        # ``dispatch_age_s()`` is what /healthz judges against
        # serve.dispatch_stall_s.
        self._dispatch_started: float | None = None

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "ScoreBatcher":
        self._thread = threading.Thread(target=self._drain_loop,
                                        name="serve-batcher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cv:
            self._admitting = False
            self._stopping = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def stop_admission(self) -> None:
        """Drain phase 1: new submits raise ``Draining``; queued and
        in-flight work keeps completing."""
        with self._cv:
            self._admitting = False

    def drain(self, timeout_s: float) -> bool:
        """Block until every queued/in-flight request completed, bounded.
        Returns whether the drain finished inside the budget."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._pending_locked() or self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.1))
        return True

    # ------------------------------------------------------------- submit

    def submit(self, tenant: str, method: str, images, labels, *,
               timeout_s: float = 60.0, trace=None) -> np.ndarray:
        """Enqueue and wait; returns ``scores[n]``. Raises ``Backpressure``
        (queue full), ``Draining`` (shutdown), ``TimeoutError``, or the
        dispatch's own failure. ``trace`` (a ``reqtrace.RequestTrace``) is
        filled in place with the queue/coalesce/dispatch/fetch phase
        breakdown; the caller owns emission."""
        images = np.asarray(images, np.float32)
        labels = np.asarray(labels, np.int32)
        if len(images) != len(labels):
            raise ValueError("images and labels must align")
        if len(images) == 0:
            return np.zeros(0, np.float32)
        req = _Request(tenant=tenant, method=method, images=images,
                       labels=labels, enqueued=time.monotonic(), trace=trace)
        with self._cv:
            if not self._admitting:
                raise Draining("service is draining; admission stopped")
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._rebuild_rr_locked()
            if len(q) >= self.max_queue:
                self.rejected += 1
                obs_registry.inc("serve_rejected")
                if self.logger is not None:
                    self.logger.log("serve_admission", tenant=tenant,
                                    action="reject", queue_depth=len(q),
                                    retry_after_s=self.retry_after_s)
                raise Backpressure(tenant, len(q), self.retry_after_s)
            q.append(req)
            self.accepted += 1
            self._cv.notify_all()
        if not req.done.wait(timeout_s):
            # Cancel what can still be cancelled: a request the worker has
            # not touched leaves the queue NOW (it must not keep holding a
            # max_queue admission slot or burn a future dispatch nobody is
            # waiting for). Rows already handed to a dispatch cannot be
            # recalled — that request completes off-thread and is dropped.
            with self._cv:
                if req.taken == 0:
                    try:
                        self._queues[tenant].remove(req)
                        self.failed += 1
                    except (KeyError, ValueError):
                        pass   # dispatched between the wait and the lock
            raise TimeoutError(
                f"serve request timed out after {timeout_s:g}s "
                f"(tenant {tenant!r}, method {method!r}, n={len(images)})")
        if req.error is not None:
            raise req.error
        return req.scores

    # ----------------------------------------------------------- accounting

    def _pending_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def dispatch_age_s(self) -> float | None:
        """Seconds the in-flight dispatch has been running, or None when the
        worker is between dispatches. Read without the lock on purpose: the
        wedged dispatcher this exists to expose may be holding nothing OR
        anything, and a float read is atomic enough for a watchdog."""
        started = self._dispatch_started
        return None if started is None else time.monotonic() - started

    def stats(self) -> dict:
        with self._cv:
            return {
                "accepted": self.accepted, "rejected": self.rejected,
                "completed": self.completed, "failed": self.failed,
                "dispatches": self.dispatches,
                "rows_dispatched": self.rows_dispatched,
                "batch_fill": round(
                    self.rows_dispatched
                    / max(1, self.dispatches * self.batch_size), 4),
                "inflight": self._inflight,
                "queued": {t: len(q) for t, q in self._queues.items()},
                "admitting": self._admitting,
            }

    # ------------------------------------------------------------ draining

    def _rebuild_rr_locked(self) -> None:
        """The weighted round-robin cycle: each tenant appears ``weight``
        times, so a cycle over tenants with pending work gives weight-
        proportional dispatch slots."""
        weight_of = getattr(self.engine, "tenant_weight", lambda name: 1)
        self._rr = [name for name in sorted(self._queues)
                    for _ in range(max(1, int(weight_of(name))))]

    def _next_batch_locked(self):
        """Pick the next dispatch under the fairness + coalescing policy.

        Returns ``(tenant, method, parts)`` with ``parts`` a list of
        ``(request, offset, take)``; or a float — seconds the worker should
        wait for the oldest partial batch's window to close; or None when
        nothing is pending."""
        if not self._rr:
            return None
        now = time.monotonic()
        best_wait = None
        for i in range(len(self._rr)):
            name = self._rr[(self._cursor + i) % len(self._rr)]
            q = self._queues.get(name)
            if not q:
                continue
            method = q[0].method
            rows = 0
            for r in q:
                if r.method != method:
                    break   # coalesce only a same-method head run
                rows += len(r.images) - r.taken
                if rows >= self.batch_size:
                    break
            window_closed = (rows >= self.batch_size or self._stopping
                            or not self._admitting
                            or now - q[0].enqueued >= self.window_s)
            if not window_closed:
                wait = self.window_s - (now - q[0].enqueued)
                best_wait = wait if best_wait is None else min(best_wait,
                                                               wait)
                continue
            # Take up to B rows off the same-method head run; a partially
            # consumed request stays at the head for the next dispatch.
            self._cursor = (self._cursor + i + 1) % len(self._rr)
            parts, took = [], 0
            while q and took < self.batch_size and q[0].method == method:
                r = q[0]
                take = min(len(r.images) - r.taken, self.batch_size - took)
                parts.append((r, r.taken, take))
                r.taken += take
                took += take
                if r.taken == len(r.images):
                    q.popleft()
                    self._inflight += 1
            # Span boundary for tracing: the first time a request's rows
            # are taken ends its wait. A PARTIAL departure means the wait
            # was (at least partly) the coalescing window's doing; a full
            # batch never waited on the window, only on queue service.
            partial = took < self.batch_size
            for r, _, _ in parts:
                if r.taken_ts is None:
                    r.taken_ts = now
                    r.window_expired = partial
            return name, method, parts
        return best_wait

    def _drain_loop(self) -> None:
        while True:
            with self._cv:
                picked = self._next_batch_locked()
                while picked is None or isinstance(picked, float):
                    if self._stopping and not self._pending_locked():
                        return
                    self._cv.wait(picked if isinstance(picked, float)
                                  else 0.05)
                    picked = self._next_batch_locked()
            tenant, method, parts = picked
            self._dispatch(tenant, method, parts)
            # Serving liveness for /healthz + the fleet view (throttled
            # inside; no-op when no heartbeat is installed).
            obs_heartbeat.beat(stage="serve")

    def _dispatch(self, tenant: str, method: str, parts) -> None:
        images = np.concatenate([r.images[o:o + n] for r, o, n in parts])
        labels = np.concatenate([r.labels[o:o + n] for r, o, n in parts])
        self._dispatch_started = time.monotonic()
        try:
            # Serve fault site (kill_replica_after_requests /
            # wedge_dispatcher_after): fired with the dispatch in flight so
            # the parts' HTTP requests are exactly the in-flight work the
            # fault orphans.
            inject.fire("serve_dispatch", dispatch=self.dispatches + 1,
                        completed=self.completed)
            scores = self.engine.score_batch(tenant, method, images, labels)
            error = None
        except Exception as exc:   # noqa: BLE001 — the requester gets the failure
            scores, error = None, exc
        finally:
            started = self._dispatch_started
            self._dispatch_started = None
        now = time.monotonic()
        # Phase evidence for tracing: the engine's dispatch/fetch split
        # when it offers one, else the whole dispatch wall as "dispatch"
        # (fake engines in tests, failed dispatches).
        info = getattr(self.engine, "last_dispatch_info", None)
        if info is not None and error is None:
            disp_ms = float(info.get("dispatch_ms", 0.0)) \
                + float(info.get("compile_ms", 0.0))
            fetch_ms = float(info.get("fetch_ms", 0.0))
            cold = bool(info.get("cold", False))
        else:
            disp_ms = (now - started) * 1e3 if started is not None else 0.0
            fetch_ms, cold = 0.0, False
        done: list[_Request] = []
        with self._cv:
            self.dispatches += 1
            self.rows_dispatched += len(images)
            self.rows_padded += self.batch_size - len(images)
            pos = 0
            for r, o, n in parts:
                if error is not None:
                    r.error = error
                else:
                    r.scores[o:o + n] = scores[pos:pos + n]
                # Every rider waited for the whole dispatch (scores fan
                # out only after it lands), so each gets the full phase
                # cost; split requests accumulate across dispatches.
                r.dispatch_ms += disp_ms
                r.fetch_ms += fetch_ms
                r.cold = r.cold or cold
                pos += n
                r.remaining -= n
                if r.remaining == 0:
                    r.wall_s = now - r.enqueued
                    if r.taken == len(r.images):   # was counted in-flight
                        self._inflight -= 1
                    done.append(r)
                    # Judged by the REQUEST's error, not this dispatch's: a
                    # split request whose earlier dispatch failed is a
                    # failure even when its last slice scored fine.
                    if r.error is None:
                        self.completed += 1
                    else:
                        self.failed += 1
            self._cv.notify_all()
        fill = round(len(images) / self.batch_size, 4)
        for r in done:
            obs_registry.observe("serve_request_ms", r.wall_s * 1e3)
            phases = self._request_phases(r)
            obs_reqtrace.observe_phases(phases)
            if r.trace is not None:
                for name, ms in phases.items():
                    r.trace.add_ms(name, ms)
                r.trace.cold = r.trace.cold or r.cold
                r.trace.batch_fill = fill
            if self.request_log and self.logger is not None:
                rec = dict(tenant=r.tenant, method=r.method,
                           n=len(r.images), wall_ms=round(r.wall_s * 1e3, 3),
                           batch_fill=fill)
                if r.error is not None:
                    rec["error"] = repr(r.error)[:200]
                self.logger.log("serve_request", **rec)
            r.done.set()

    def _request_phases(self, r: _Request) -> dict[str, float]:
        """Decompose one completed request's wait into the traced phases.

        ``queue_wait``/``coalesce_wait`` split the enqueue->first-taken
        span: a request whose first dispatch departed window-expired
        (partial batch) charges up to ``window_s`` of that span to the
        coalescing window, the rest to queue service; a full-batch
        departure never waited on the window, so it is all queue."""
        wait_ms = max(0.0, ((r.taken_ts if r.taken_ts is not None
                             else r.enqueued) - r.enqueued) * 1e3)
        coalesce = min(wait_ms, self.window_s * 1e3) if r.window_expired \
            else 0.0
        return {"queue_wait": wait_ms - coalesce, "coalesce_wait": coalesce,
                "dispatch": r.dispatch_ms, "fetch": r.fetch_ms}
