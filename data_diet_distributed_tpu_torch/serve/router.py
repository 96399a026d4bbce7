"""Health-aware HTTP router over a fleet of serve replicas (copy of
``data_diet_distributed_tpu/serve/router.py``).

The single-process server (``server.py``) dies with its host; the fleet
(``fleet.py``) runs N of them — and this module is the one address clients
keep: a reverse proxy that load-balances ``/v1/score`` ``/v1/rank``
``/v1/topk`` across the replicas the health poller says are alive, and
turns a replica death into a retry instead of a client-visible failure.

Routing policy, in order:

* **candidates** — healthy (fleet health poller verdict) AND allowed by the
  replica's circuit breaker, rotated round-robin; no candidate -> 503 with
  ``Retry-After`` (the same backpressure vocabulary the replicas speak).
* **retry only what is idempotent** — a transport failure (connection
  refused/reset, torn response: the signature of a SIGKILLed replica) is
  retried on the next candidate ONLY for requests that are safe to replay:
  ``GET`` requests, and ``POST`` requests carrying an ``Idempotency-Key``
  header. A keyless POST gets an honest 502 — the router cannot know
  whether the dead replica dispatched it.
* **idempotency replay cache** — responses to keyed requests are cached
  (bounded LRU, ``serve.idempotency_cache`` entries) and the key is echoed
  back; a client retry of an already-answered request replays the cached
  response (``X-Idempotent-Replay: 1``) instead of double-dispatching, and
  concurrent duplicates single-flight behind the first.
* **circuit breaking** — ``breaker_failures`` consecutive transport
  failures open a replica's breaker; after ``breaker_reset_s`` one probe
  request is let through (half-open) and its success closes the circuit.
  Transitions land as ``{"kind": "replica_event"}`` records.
* **hedging** (optional) — an idempotent request still unanswered after
  ``hedge_ms`` is duplicated to a second replica; first answer wins and
  the loser's connection is closed.

``/healthz`` and ``/status`` are answered by the router itself (fleet
view); ``POST /v1/refresh`` triggers a one-replica-at-a-time refresh roll.
The router is stdlib only and touches no torch or CUDA state: it lives in the
fleet supervisor process, which shares the card with the replicas that own
it.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# reqtrace touches only the obs registry and logger, never the card.
from ..obs import reqtrace as obs_reqtrace

#: Transport-level failures: the request may not have reached the replica
#: (or its answer died with it). These — and only these — count against the
#: breaker and are retry-eligible. HTTP error STATUSES (429, 400, 409…) are
#: the replica speaking and pass through untouched.
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


def percentile(values, q: float) -> float:
    vals = sorted(values)
    if not vals:
        return 0.0
    idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
    return float(vals[idx])


class CircuitBreaker:
    """Per-replica circuit: closed -> (N consecutive transport failures) ->
    open -> (reset_s elapsed) -> half-open, one probe in flight -> closed on
    its success, re-open on its failure. ``allowing()`` is the non-mutating
    candidate filter; ``acquire()`` takes the half-open probe slot and must
    be paired with ``success()``/``failure()``."""

    def __init__(self, failures: int, reset_s: float):
        self.threshold = max(1, int(failures))
        self.reset_s = float(reset_s)
        self.state = "closed"
        self._consecutive = 0
        self._opened_mono: float | None = None
        self._probing = False
        self._lock = threading.Lock()

    def _maybe_half_open(self, now: float) -> None:
        if (self.state == "open" and self._opened_mono is not None
                and now - self._opened_mono >= self.reset_s):
            self.state = "half_open"
            self._probing = False

    def allowing(self) -> bool:
        with self._lock:
            self._maybe_half_open(time.monotonic())
            if self.state == "closed":
                return True
            return self.state == "half_open" and not self._probing

    def acquire(self) -> bool:
        with self._lock:
            self._maybe_half_open(time.monotonic())
            if self.state == "closed":
                return True
            if self.state == "half_open" and not self._probing:
                self._probing = True
                return True
            return False

    def success(self) -> bool:
        """Returns True when this success CLOSED a previously open circuit
        (so the caller can log the transition once)."""
        with self._lock:
            reopened = self.state != "closed"
            self.state = "closed"
            self._consecutive = 0
            self._probing = False
            return reopened

    def failure(self) -> bool:
        """Returns True when this failure OPENED the circuit."""
        with self._lock:
            self._probing = False
            self._consecutive += 1
            if self.state == "half_open" or (
                    self.state == "closed"
                    and self._consecutive >= self.threshold):
                self.state = "open"
                self._opened_mono = time.monotonic()
                return True
            if self.state == "open":
                self._opened_mono = time.monotonic()
            return False


class Replica:
    """One backend's routing view: address, the health poller's verdict,
    and the circuit breaker. ``healthy`` starts True (a freshly constructed
    router with no poller — the unit tests — routes everywhere); the fleet
    marks replicas down until their first reachable /healthz."""

    def __init__(self, index: int, host: str, port: int, *,
                 breaker_failures: int = 3, breaker_reset_s: float = 2.0):
        self.index = int(index)
        self.host = host
        self.port = int(port)
        self.healthy = True
        self.health: dict = {}
        self.generation = 0
        self.breaker = CircuitBreaker(breaker_failures, breaker_reset_s)
        # Scale-down tombstone: a retired slot keeps its index (set_health
        # and events address replicas positionally) but never routes and
        # never counts toward capacity. Slots are only ever appended.
        self.retired = False
        # Per-replica outcome window (router._stats_lock guards): the
        # canary hold resets it after an install and judges it against the
        # fleet SLO floors.
        self.window_served = 0
        self.window_errors = 0
        self.window_lat_ms: deque = deque(maxlen=1024)

    def routable(self) -> bool:
        return self.healthy and not self.retired and self.breaker.allowing()

    def view(self) -> dict:
        return {"replica": self.index, "port": self.port,
                "healthy": self.healthy, "breaker": self.breaker.state,
                "generation": self.generation, "retired": self.retired,
                "status": self.health.get("status")}


class _IdemEntry:
    __slots__ = ("event", "result")

    def __init__(self):
        self.event = threading.Event()
        self.result = None   # (status, body, headers) once cached


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # noqa: A002 — silence stderr chatter
        pass

    @property
    def router(self) -> "ServeRouter":
        return self.server.router   # type: ignore[attr-defined]

    def _reply(self, code: int, payload: dict | bytes,
               headers: dict | None = None) -> None:
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(code)
        sent = {k.lower() for k in (headers or {})}
        if "content-type" not in sent:
            self.send_header("Content-Type", "application/json")
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):   # noqa: N802 — BaseHTTPRequestHandler contract
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            verdict = self.router.health()
            self._reply(503 if verdict["status"] == "critical" else 200,
                        verdict)
            return
        if path == "/status":
            self._reply(200, self.router.status())
            return
        code, body, headers = self.router.handle(
            "GET", self.path, b"", dict(self.headers))
        self._reply(code, body, headers)

    def do_POST(self):   # noqa: N802
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        path = self.path.split("?", 1)[0]
        if path == "/v1/refresh":
            try:
                spec = json.loads(body.decode() or "{}")
            except ValueError:
                self._reply(400, {"error": "body is not JSON"})
                return
            code, payload = self.router.roll_refresh(spec)
            self._reply(code, payload)
            return
        code, out, headers = self.router.handle(
            "POST", self.path, body, dict(self.headers))
        self._reply(code, out, headers)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class ServeRouter:
    def __init__(self, replicas: list[Replica], *, host: str = "127.0.0.1",
                 port: int = 0, retries: int = 2, hedge_ms: float | None = None,
                 timeout_s: float = 60.0, idem_cache: int = 256,
                 retry_after_s: float = 1.0, logger=None, on_refresh=None,
                 canary_requests: int | None = None,
                 canary_timeout_s: float = 30.0,
                 canary_p95_floor_ms: float | None = None,
                 canary_error_frac: float | None = None,
                 trace_sample_frac: float = 0.0,
                 trace_slow_ms: float = obs_reqtrace.DEFAULT_SLOW_MS):
        self.replicas = list(replicas)
        self.host = host
        self.port = int(port)
        self.retries = max(0, int(retries))
        self.hedge_ms = hedge_ms
        self.timeout_s = float(timeout_s)
        self.retry_after_s = float(retry_after_s)
        self.logger = logger
        # Request-tracing retention at the router edge (obs/reqtrace):
        # 0.0 = tail-only (failed/slow/retried/hedged/replayed requests
        # still always keep their serve_trace record).
        self.trace_sample_frac = float(trace_sample_frac)
        self.trace_slow_ms = float(trace_slow_ms)
        # Refresh-roll delegate: fleet injects its own roll (which knows the
        # replica generation map); None = the router's built-in roll.
        self.on_refresh = on_refresh
        self._idem: OrderedDict[str, _IdemEntry] = OrderedDict()
        self._idem_cap = max(1, int(idem_cache))
        self._idem_lock = threading.Lock()
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._roll_lock = threading.Lock()
        self._draining = False
        self._latencies_ms: deque = deque(maxlen=4096)
        self._stats_lock = threading.Lock()
        self.counters = {"requests": 0, "proxied": 0, "retries": 0,
                         "replays": 0, "hedges": 0, "hedge_wins": 0,
                         "no_replica": 0, "transport_failures": 0}
        # Canary-first refresh roll: hold after the first replica installs
        # until it has answered canary_requests routed requests (bounded by
        # canary_timeout_s), judged against the fleet SLO floors. None =
        # the plain one-at-a-time roll.
        self.canary_requests = canary_requests
        self.canary_timeout_s = float(canary_timeout_s)
        self.canary_p95_floor_ms = canary_p95_floor_ms
        self.canary_error_frac = canary_error_frac
        #: {"dir":..., "step":...} of the last fully-rolled model — what a
        #: failed canary rolls BACK to.
        self._last_installed: dict | None = None
        # Per-stats-tick latency window (take_tick_stats drains it): the
        # autoscaler's pressure signal — unlike the rolling 4096-sample
        # deque, an idle tick reads empty instead of replaying stale spikes.
        self._tick_lat: list[float] = []
        #: Supervisor self-monitoring (serve/fleet.py): a dead supervisor
        #: thread appends its epitaph here and /healthz goes critical — a
        #: supervisor whose control loops died must stop LOOKING healthy.
        self.supervisor_faults: list[str] = []
        self._httpd: _Server | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def bind(self) -> int:
        self._httpd = _Server((self.host, self.port), _RouterHandler)
        self._httpd.router = self   # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serve-router", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def stop_admission(self) -> None:
        """Drain mode: every proxy request is refused with 503 (in-flight
        ones finish); /healthz goes critical so external pollers stop."""
        self._draining = True

    # -------------------------------------------------------------- plumbing

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.counters[key] += n

    def _event(self, replica: int, event: str, **fields) -> None:
        if self.logger is not None:
            self.logger.log("replica_event", replica=replica, event=event,
                            **fields)

    def set_health(self, index: int, healthy: bool,
                   verdict: dict | None = None) -> None:
        rep = self.replicas[index]
        rep.healthy = bool(healthy)
        if verdict is not None:
            rep.health = verdict

    def active_replicas(self) -> list[Replica]:
        """Non-retired slots — capacity denominators and roll targets.
        Snapshots the table, which only ever grows (append/retire)."""
        return [r for r in list(self.replicas) if not r.retired]

    def add_replica(self, host: str, port: int, *, breaker_failures: int = 3,
                    breaker_reset_s: float = 2.0) -> Replica:
        """Autoscale grow: append a new slot (index = table length),
        unhealthy until the fleet's poller sees its first /healthz."""
        rep = Replica(len(self.replicas), host, port,
                      breaker_failures=breaker_failures,
                      breaker_reset_s=breaker_reset_s)
        rep.healthy = False
        self.replicas.append(rep)
        return rep

    def retire(self, index: int) -> None:
        """Autoscale shrink: tombstone the slot (it keeps its index)."""
        rep = self.replicas[index]
        rep.retired = True
        rep.healthy = False

    def clear_quarantine(self, index: int) -> None:
        """Reconnect path (fleet probation): a successful supervisor probe
        closes the breaker immediately instead of waiting out reset_s +
        a live half-open probe."""
        rep = self.replicas[index]
        if rep.breaker.success():
            self._event(rep.index, "breaker_close", port=rep.port,
                        cause="reconnect")

    def _candidates(self, exclude: set[int]) -> list[Replica]:
        with self._rr_lock:
            start = self._rr
            self._rr += 1
        reps = list(self.replicas)
        n = len(reps)
        order = [reps[(start + i) % n] for i in range(n)]
        return [r for r in order
                if r.index not in exclude and r.routable()]

    def _proxy_once(self, rep: Replica, method: str, path: str, body: bytes,
                    headers: dict, deadline: float, conns: list | None = None):
        budget = max(0.05, deadline - time.monotonic())
        conn = http.client.HTTPConnection(rep.host, rep.port, timeout=budget)
        if conns is not None:
            conns.append(conn)
        try:
            fwd = {k: v for k, v in headers.items()
                   if k.lower() in ("content-type", "idempotency-key",
                                    "x-trace-id", "x-trace-keep")}
            if body and "content-type" not in {k.lower() for k in fwd}:
                fwd["Content-Type"] = "application/json"
            conn.request(method, path, body=body or None, headers=fwd)
            resp = conn.getresponse()
            data = resp.read()
            out_headers = {}
            for key in ("Content-Type", "Retry-After",
                        obs_reqtrace.TRACE_HEADER):
                val = resp.getheader(key)
                if val is not None:
                    out_headers[key] = val
            return resp.status, data, out_headers
        finally:
            conn.close()

    def _note_success(self, rep: Replica) -> None:
        if rep.breaker.success():
            self._event(rep.index, "breaker_close", port=rep.port)

    def _note_failure(self, rep: Replica, exc: BaseException) -> None:
        self._count("transport_failures")
        with self._stats_lock:
            rep.window_served += 1
            rep.window_errors += 1
        if rep.breaker.failure():
            self._event(rep.index, "breaker_open", port=rep.port,
                        error=repr(exc)[:200])

    def _record_outcome(self, rep: Replica, ms: float, status: int) -> None:
        """Per-replica window accounting (canary evidence) + the router's
        latency views. A 5xx is the replica failing a request it accepted;
        backpressure (429/503) and client errors are not regressions."""
        with self._stats_lock:
            self._latencies_ms.append(ms)
            self._tick_lat.append(ms)
            rep.window_served += 1
            rep.window_lat_ms.append(ms)
            if status >= 500:
                rep.window_errors += 1

    def take_tick_stats(self) -> dict:
        """Drain the per-tick latency window: ``{"n", "p95_ms"}`` for the
        requests routed since the previous call (p95_ms None on an idle
        tick). The autoscaler's pressure signal."""
        with self._stats_lock:
            lat = self._tick_lat
            self._tick_lat = []
        return {"n": len(lat),
                "p95_ms": round(percentile(lat, 0.95), 3) if lat else None}

    # ----------------------------------------------------------- idempotency

    def _idem_begin(self, key: str):
        """(entry, owner): owner dispatches and publishes; a non-owner waits
        on the entry and replays its cached response."""
        with self._idem_lock:
            entry = self._idem.get(key)
            if entry is not None:
                self._idem.move_to_end(key)
                return entry, False
            entry = _IdemEntry()
            self._idem[key] = entry
            while len(self._idem) > self._idem_cap:
                self._idem.popitem(last=False)
            return entry, True

    def _idem_publish(self, key: str, entry: _IdemEntry, result) -> None:
        entry.result = result
        entry.event.set()
        if result is None:
            # A failed dispatch must not poison the key: drop the entry so
            # the client's next retry becomes a fresh owner.
            with self._idem_lock:
                if self._idem.get(key) is entry:
                    del self._idem[key]

    # --------------------------------------------------------------- routing

    def _emit_trace(self, trace_id: str, *, status: int, wall_ms: float,
                    phases: dict, replay: bool = False, retries: int = 0,
                    hedged: bool = False, **fields) -> None:
        """Router-side ``serve_trace`` with the tail-biased retention
        policy: failed/slow requests and any request the router had to
        work for (retry, hedge, replay) always keep their record; healthy
        traffic head-samples by the trace-id hash — the same answer every
        replica computes for the same id."""
        obs_reqtrace.observe_phases(phases)
        failed = status >= 400
        slow = wall_ms >= self.trace_slow_ms
        flagged = replay or hedged or retries > 0
        if not obs_reqtrace.should_keep(trace_id, self.trace_sample_frac,
                                        failed=failed, slow=slow,
                                        flagged=flagged):
            return
        obs_reqtrace.emit(self.logger, trace_id=trace_id, where="router",
                          status=status, wall_ms=wall_ms, phases=phases,
                          sampled=not (failed or slow or flagged),
                          replay=replay, retries=retries, hedged=hedged,
                          **fields)

    def handle(self, method: str, path: str, body: bytes,
               headers: dict) -> tuple[int, bytes | dict, dict]:
        """Route one client request; returns (status, body, headers)."""
        self._count("requests")
        t_in = time.monotonic()
        # Trace identity: accept the client's id or mint at this edge; it
        # rides every hop (_proxy_once forwards it) and every response.
        trace_id = next((v for k, v in headers.items()
                         if k.lower() == "x-trace-id"), None)
        if trace_id is None:
            trace_id = obs_reqtrace.mint_trace_id()
            headers = dict(headers, **{obs_reqtrace.TRACE_HEADER: trace_id})
        techo = {obs_reqtrace.TRACE_HEADER: trace_id}
        if self._draining:
            return 503, {"error": "router draining"}, dict(
                techo, **{"Retry-After": f"{self.retry_after_s:g}"})
        idem_key = next((v for k, v in headers.items()
                         if k.lower() == "idempotency-key"), None)
        idempotent = method == "GET" or idem_key is not None
        echo = {} if idem_key is None else {"Idempotency-Key": idem_key}
        entry = None
        if idem_key is not None:
            entry, owner = self._idem_begin(idem_key)
            if not owner:
                budget = max(0.05, self.timeout_s)
                if entry.event.wait(timeout=budget) and entry.result:
                    status, data, hdrs = entry.result
                    self._count("replays")
                    wall_ms = (time.monotonic() - t_in) * 1e3
                    self._emit_trace(trace_id, status=status,
                                     wall_ms=wall_ms, replay=True,
                                     phases={"admission": wall_ms,
                                             "routing": 0.0, "proxy": 0.0},
                                     path=path, replica=None)
                    return status, data, dict(hdrs, **echo, **techo,
                                              **{"X-Idempotent-Replay": "1"})
                # Original owner failed (or timed out): dispatch ourselves,
                # publishing into the same entry on success.
        t0 = time.monotonic()
        deadline = t0 + self.timeout_s
        attempts: list[dict] = []
        try:
            result = self._dispatch(method, path, body, headers, idempotent,
                                    deadline, attempts=attempts)
        except BaseException:
            if entry is not None:
                self._idem_publish(idem_key, entry, None)
            raise
        status, data, hdrs, rep = result
        if rep is not None:
            self._record_outcome(rep, (time.monotonic() - t0) * 1000.0,
                                 status)
            hdrs = dict(hdrs, **{"X-Served-By": str(rep.index)})
        if entry is not None:
            self._idem_publish(idem_key, entry,
                               (status, data, hdrs) if status == 200 else None)
        # Phase decomposition: admission is everything before routing
        # started (drain gate + idempotency rendezvous), proxy is the
        # WINNING attempt's wire time, and routing is the remainder —
        # candidate selection, failed attempts, hedge wait. Failovers
        # therefore show up as routing time, annotated per attempt.
        wall_ms = (time.monotonic() - t_in) * 1e3
        admission_ms = (t0 - t_in) * 1e3
        win = next((a for a in attempts if a.get("outcome") == "ok"
                    and (rep is None or a.get("replica") == rep.index)),
                   None)
        proxy_ms = float(win["ms"]) if win else 0.0
        self._emit_trace(
            trace_id, status=status, wall_ms=wall_ms,
            phases={"admission": admission_ms, "proxy": proxy_ms,
                    "routing": max(0.0, wall_ms - admission_ms - proxy_ms)},
            retries=sum(1 for a in attempts if a.get("outcome") != "ok"),
            hedged=any(a.get("hedge") for a in attempts),
            path=path, replica=rep.index if rep is not None else None,
            attempts=[{"replica": a.get("replica"),
                       "outcome": a.get("outcome"),
                       "hedge": bool(a.get("hedge")),
                       "ms": round(float(a.get("ms") or 0.0), 3)}
                      for a in attempts])
        return status, data, dict(hdrs, **echo, **techo)

    def _dispatch(self, method, path, body, headers, idempotent, deadline,
                  attempts: list | None = None):
        """(status, body, headers, replica-or-None) after retry/hedge.
        ``attempts`` (when given) collects one
        ``{"replica", "outcome", "hedge", "ms"}`` row per attempt — the
        trace's failover evidence."""
        attempted: set[int] = set()
        last_exc: BaseException | None = None
        budget_tries = (self.retries + 1) if idempotent else 1
        tried = 0
        while tried < budget_tries and time.monotonic() < deadline:
            reps = self._candidates(attempted)
            if not reps:
                break
            if (self.hedge_ms is not None and idempotent and len(reps) >= 2
                    and tried == 0):
                result = self._hedged(reps, method, path, body, headers,
                                      deadline, attempted, attempts)
                if result is not None:
                    return result
                tried += 2
                self._count("retries")
                continue
            rep = next((r for r in reps if r.breaker.acquire()), None)
            if rep is None:
                break
            tried += 1
            t_att = time.monotonic()
            try:
                status, data, hdrs = self._proxy_once(
                    rep, method, path, body, headers, deadline)
            except TRANSPORT_ERRORS as exc:
                last_exc = exc
                self._note_failure(rep, exc)
                attempted.add(rep.index)
                if attempts is not None:
                    attempts.append({
                        "replica": rep.index, "outcome": "transport_error",
                        "ms": (time.monotonic() - t_att) * 1e3})
                if idempotent:
                    self._count("retries")
                    # The request just became tail-interesting: hint every
                    # later hop to keep its trace record so the failover
                    # lane stitches end to end.
                    headers = dict(headers,
                                   **{obs_reqtrace.KEEP_HEADER: "1"})
                    continue
                return 502, {"error": "upstream transport failure on a "
                                      "non-idempotent request (no "
                                      "Idempotency-Key); not retried",
                             "detail": repr(exc)[:200]}, {}, None
            self._note_success(rep)
            self._count("proxied")
            if attempts is not None:
                attempts.append({"replica": rep.index, "outcome": "ok",
                                 "ms": (time.monotonic() - t_att) * 1e3})
            return status, data, hdrs, rep
        if last_exc is not None and time.monotonic() >= deadline:
            return 504, {"error": "deadline exhausted retrying",
                         "detail": repr(last_exc)[:200]}, {}, None
        self._count("no_replica")
        return 503, {"error": "no routable replica",
                     "detail": (repr(last_exc)[:200] if last_exc else None)}, \
            {"Retry-After": f"{self.retry_after_s:g}"}, None

    def _hedged(self, reps, method, path, body, headers, deadline, attempted,
                attempts: list | None = None):
        """Primary + one hedge: first success wins, the loser's connection
        is closed (its blocked read tears down, the thread exits). Returns
        the winning (status, body, headers, replica) or None when both
        attempts fail (caller falls back to the sequential loop)."""
        primary, backup = reps[0], reps[1]
        lock = threading.Lock()
        done = threading.Event()
        state: dict = {"result": None, "finished": 0, "launched": 1}
        all_conns: dict[int, list] = {primary.index: [], backup.index: []}

        def attempt(rep: Replica, is_hedge: bool) -> None:
            if not rep.breaker.acquire():
                with lock:
                    state["finished"] += 1
                    if state["finished"] >= state["launched"]:
                        done.set()
                return
            # The hedge leg marks the request tail-interesting — hint the
            # replica to keep its trace record (the primary is already in
            # flight without the hint; the interesting answer is usually
            # the hedge's anyway).
            hd = dict(headers, **{obs_reqtrace.KEEP_HEADER: "1"}) \
                if is_hedge else headers
            t_att = time.monotonic()
            try:
                status, data, hdrs = self._proxy_once(
                    rep, method, path, body, hd, deadline,
                    conns=all_conns[rep.index])
            except TRANSPORT_ERRORS as exc:
                self._note_failure(rep, exc)
                with lock:
                    attempted.add(rep.index)
                    if attempts is not None:
                        attempts.append({
                            "replica": rep.index, "hedge": is_hedge,
                            "outcome": "transport_error",
                            "ms": (time.monotonic() - t_att) * 1e3})
                    state["finished"] += 1
                    if state["finished"] >= state["launched"]:
                        done.set()
                return
            self._note_success(rep)
            with lock:
                if attempts is not None:
                    attempts.append({
                        "replica": rep.index, "hedge": is_hedge,
                        "outcome": "ok",
                        "ms": (time.monotonic() - t_att) * 1e3})
                state["finished"] += 1
                if state["result"] is None:
                    state["result"] = (status, data, hdrs, rep, is_hedge)
                    done.set()
                    # Cancel the loser: closing its socket unblocks its read.
                    for idx, conns in all_conns.items():
                        if idx != rep.index:
                            for c in conns:
                                try:
                                    c.close()
                                except OSError:
                                    pass

        t1 = threading.Thread(target=attempt, args=(primary, False),
                              daemon=True)
        t1.start()
        if not done.wait(timeout=self.hedge_ms / 1000.0):
            with lock:
                state["launched"] = 2
            self._count("hedges")
            t2 = threading.Thread(target=attempt, args=(backup, True),
                                  daemon=True)
            t2.start()
        done.wait(timeout=max(0.05, deadline - time.monotonic()))
        with lock:
            result = state["result"]
        if result is None:
            return None
        status, data, hdrs, rep, was_hedge = result
        if was_hedge:
            self._count("hedge_wins")
        self._count("proxied")
        return status, data, hdrs, rep

    # -------------------------------------------------------------- refresh

    def roll_refresh(self, spec: dict) -> tuple[int, dict]:
        """Zero-downtime model refresh: POST /v1/refresh to one replica at a
        time (each installs atomically between dispatches, serving the old
        model until the swap — capacity never drops). Aborts on the first
        rejection, old model still serving everywhere not yet rolled."""
        if self.on_refresh is not None:
            return self.on_refresh(spec)
        return self.roll_refresh_direct(spec)

    def roll_refresh_direct(self, spec: dict) -> tuple[int, dict]:
        if not self._roll_lock.acquire(blocking=False):
            return 409, {"error": "a refresh roll is already in flight"}
        try:
            prior = self._last_installed
            canary_n = self.canary_requests
            if self.logger is not None:
                self.logger.log("model_refresh", status="roll_started",
                                tenant=spec.get("tenant"),
                                step=spec.get("step"),
                                canary_requests=canary_n)
            results: list[dict] = []
            canary_info = None
            body = json.dumps(spec).encode()
            for pos, rep in enumerate(self.active_replicas()):
                if not rep.healthy:
                    # An unroutable replica cannot install; rolling past it
                    # would leave a torn fleet once it heals. Abort loudly.
                    results.append({"replica": rep.index,
                                    "status": "unreachable"})
                    return self._roll_verdict(409, spec, results)
                err = self._refresh_one(rep, body, results)
                if err is not None:
                    return self._roll_verdict(err, spec, results)
                if pos == 0 and canary_n:
                    # Canary hold: the rest of the fleet still serves the
                    # prior model; only this replica runs the new one.
                    ok, canary_info = self._canary_hold(rep, canary_n)
                    if not ok:
                        rb = self._rollback_canary(rep, prior,
                                                   spec.get("tenant"))
                        if self.logger is not None:
                            self.logger.log(
                                "model_refresh", status="rolled_back",
                                tenant=spec.get("tenant"),
                                step=spec.get("step"), canary=canary_info,
                                prior=prior, rollback=rb)
                        return 409, {"status": "rolled_back",
                                     "canary": canary_info, "prior": prior,
                                     "rollback": rb, "replicas": results}
            # Remember what landed (the replicas' resolved step — a
            # stepless "newest durable" spec still pins a rollback target).
            used = next((r.get("step") for r in results
                         if r.get("step") is not None), None)
            if used is not None:
                self._last_installed = {"dir": spec.get("dir"), "step": used}
            return self._roll_verdict(200, spec, results, canary=canary_info)
        finally:
            self._roll_lock.release()

    def _refresh_one(self, rep: Replica, body: bytes,
                     results: list) -> int | None:
        """Install on one replica; appends its result and returns the abort
        status code, or None on a clean install."""
        try:
            status, data, _ = self._proxy_once(
                rep, "POST", "/v1/refresh", body,
                {"Content-Type": "application/json"},
                time.monotonic() + self.timeout_s)
        except TRANSPORT_ERRORS as exc:
            self._note_failure(rep, exc)
            results.append({"replica": rep.index,
                            "status": "transport_error",
                            "detail": repr(exc)[:200]})
            return 502
        try:
            payload = json.loads(data.decode() or "{}")
        except ValueError:
            payload = {}
        results.append({"replica": rep.index, "code": status, **payload})
        return None if status == 200 else status

    def _canary_hold(self, rep: Replica, canary_n: int) -> tuple[bool, dict]:
        """Hold the roll while the canary takes live traffic: wait for
        ``canary_n`` requests attributed to it (bounded by
        ``canary_timeout_s``), then judge its window against the fleet SLO
        floors (``obs.slo.judge_canary``). Zero routed traffic inside the
        bound is inconclusive — the roll proceeds, and says so."""
        from ..obs.slo import judge_canary
        with self._stats_lock:
            rep.window_served = 0
            rep.window_errors = 0
            rep.window_lat_ms.clear()
        deadline = time.monotonic() + self.canary_timeout_s
        while time.monotonic() < deadline:
            with self._stats_lock:
                if rep.window_served >= canary_n:
                    break
            time.sleep(0.05)
        with self._stats_lock:
            served = rep.window_served
            errors = rep.window_errors
            lat = list(rep.window_lat_ms)
        p95 = round(percentile(lat, 0.95), 3) if lat else None
        info = {"replica": rep.index, "requests": served, "errors": errors,
                "p95_ms": p95, "target_requests": canary_n,
                "p95_floor_ms": self.canary_p95_floor_ms}
        if served == 0:
            info["verdict"] = "inconclusive_no_traffic"
            return True, info
        ok, reasons = judge_canary(
            served=served, errors=errors, p95_ms=p95,
            p95_floor_ms=self.canary_p95_floor_ms,
            error_frac_floor=self.canary_error_frac)
        info["verdict"] = "pass" if ok else "fail"
        info["reasons"] = reasons
        return ok, info

    def _rollback_canary(self, rep: Replica, prior: dict | None,
                         tenant: str | None) -> dict:
        """Re-install the prior model on the failed canary. No known prior
        (a first-ever roll) leaves the canary as-is — recorded honestly."""
        if not prior or prior.get("step") is None:
            return {"status": "no_prior"}
        spec = {k: v for k, v in prior.items() if v is not None}
        if tenant:
            spec["tenant"] = tenant
        body = json.dumps(spec).encode()
        try:
            status, data, _ = self._proxy_once(
                rep, "POST", "/v1/refresh", body,
                {"Content-Type": "application/json"},
                time.monotonic() + self.timeout_s)
        except TRANSPORT_ERRORS as exc:
            self._note_failure(rep, exc)
            return {"status": "transport_error", "detail": repr(exc)[:200]}
        try:
            payload = json.loads(data.decode() or "{}")
        except ValueError:
            payload = {}
        return {"replica": rep.index, "code": status, **payload}

    def _roll_verdict(self, code: int, spec: dict, results: list,
                      canary: dict | None = None) -> tuple[int, dict]:
        ok = code == 200
        if self.logger is not None:
            self.logger.log("model_refresh",
                            status="roll_complete" if ok else "roll_aborted",
                            tenant=spec.get("tenant"), step=spec.get("step"),
                            replicas=len(results), canary=canary)
        out = {"status": "rolled" if ok else "roll_aborted",
               "replicas": results}
        if canary is not None:
            out["canary"] = canary
        return code, out

    # ---------------------------------------------------------------- views

    def p95_ms(self) -> float:
        with self._stats_lock:
            return percentile(self._latencies_ms, 0.95)

    def available(self) -> int:
        return sum(r.routable() for r in self.active_replicas())

    def health(self) -> dict:
        active = self.active_replicas()
        avail = sum(r.routable() for r in active)
        if self.supervisor_faults:
            status = "critical"
            reasons = list(self.supervisor_faults)
        elif self._draining:
            status, reasons = "critical", ["router draining"]
        elif avail == len(active):
            status, reasons = "ok", []
        else:
            status = "critical" if avail == 0 else "degraded"
            reasons = [f"{len(active) - avail} of "
                       f"{len(active)} replicas unroutable"]
        return {"status": status, "available": avail,
                "replicas": [r.view() for r in active],
                "draining": self._draining, "reasons": reasons}

    def stats(self) -> dict:
        with self._stats_lock:
            counters = dict(self.counters)
            lat = list(self._latencies_ms)
        return {**counters, "available": self.available(),
                "replicas": len(self.active_replicas()),
                "p50_ms": round(percentile(lat, 0.50), 3),
                "p95_ms": round(percentile(lat, 0.95), 3),
                "phases": obs_reqtrace.phase_summary()}

    def status(self) -> dict:
        return {"router": self.stats(),
                "replicas": [r.view() for r in self.active_replicas()]}
