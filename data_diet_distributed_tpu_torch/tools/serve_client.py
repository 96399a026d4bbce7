"""Stdlib client + load generator for the scoring service (``cli serve``).

The port's copy of ``tools/serve_client.py``: standard library only, the
same client, retry backoff, ``percentile``, ``load_generate`` and ``main``,
run as ``python -m data_diet_distributed_tpu_torch.tools.serve_client``.

Client (used by ``chip_smoke.py``'s fleet phase, the tests, and
operators)::

    from data_diet_distributed_tpu_torch.tools.serve_client import ServeClient
    c = ServeClient("http://127.0.0.1:8788")
    c = ServeClient(["http://hostA:8788", "http://hostB:8788"])  # failover
    c.score(indices=[3, 7, 10], method="el2n")      # -> {"scores": [...]}
    c.rank(indices=[0, 1, 2, 3])                    # hardest-first
    list(c.topk(k=10, method="grand"))              # streamed (index, score)
    c.healthz()

curl equivalents (documented in README "Scoring as a service")::

    curl -s localhost:8788/healthz
    curl -s -X POST localhost:8788/v1/score \
         -d '{"method": "el2n", "indices": [3, 7, 10]}'
    curl -s -X POST localhost:8788/v1/rank -d '{"indices": [0, 1, 2, 3]}'
    curl -sN 'localhost:8788/v1/topk?method=grand&k=10'

Load generator (CLI)::

    python -m data_diet_distributed_tpu_torch.tools.serve_client --url http://127.0.0.1:8788 \
        --rps 50 --duration 5 --batch 16 --max-index 255 --json

Open-loop at ``--rps`` (one request thread per tick, so a slow service
accumulates concurrency instead of silently lowering the offered rate);
reports p50/p95/max request latency, 429/error counts, the achieved
rate, and the slowest-N requests WITH their ``X-Trace-Id``s (every
request carries one; the service echoes it — feed an id to
``python -m data_diet_distributed_tpu_torch.tools.request_report`` or the
Perfetto timeline for the
server-side phase breakdown). Exit 0 when every non-rejected request
succeeded.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid

TRACE_HEADER = "X-Trace-Id"


class ServeError(Exception):
    """A non-2xx service response. Carries the HTTP status and, for 429,
    the Retry-After hint."""

    def __init__(self, status: int, payload, retry_after_s=None):
        self.status = status
        self.payload = payload
        self.retry_after_s = retry_after_s
        super().__init__(f"HTTP {status}: {payload}")


class ServeClient:
    """``retries > 0`` makes the client honest about a replicated service:
    429 waits out the server's own Retry-After hint; a refused/torn
    connection (a replica or router mid-respawn) backs off exponentially
    (``backoff_s`` doubling, capped at 5 s). Every POST carries an
    ``Idempotency-Key`` — minted once per logical call and REUSED across
    its retries, so the router's replay cache guarantees a retried
    ``/v1/score`` is never dispatched twice.

    ``base_url`` may also be a list of router endpoints (or one
    comma-separated string): the client pins to one endpoint and rotates
    to the next on a transport failure or 503 — a FREE failover that
    consumes no retry budget and sleeps nothing, because a sibling
    router is expected to be healthy right now. Only once every
    endpoint has been tried for the logical call does the normal
    retry/backoff schedule engage. The rotation is sticky: subsequent
    calls start from whichever endpoint last worked."""

    def __init__(self, base_url, timeout_s: float = 60.0,
                 retries: int = 0, backoff_s: float = 0.25):
        if isinstance(base_url, str):
            urls = [u for u in base_url.split(",") if u.strip()]
        else:
            urls = list(base_url)
        if not urls:
            raise ValueError("ServeClient needs at least one endpoint")
        self.endpoints = [u.strip().rstrip("/") for u in urls]
        self._ep = 0
        self.failovers = 0       # endpoint rotations performed (load report)
        self.timeout_s = timeout_s
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.retry_count = 0     # total retries performed (load report)
        self.last_trace_id: str | None = None   # echoed X-Trace-Id of the
        # last completed call — the handle that finds the request's spans
        # in the metrics stream / Perfetto timeline

    @property
    def base(self) -> str:
        """The endpoint current requests are pinned to."""
        return self.endpoints[self._ep]

    def _rotate(self) -> None:
        self._ep = (self._ep + 1) % len(self.endpoints)
        self.failovers += 1

    # ------------------------------------------------------------ plumbing

    def _request(self, path: str, payload: dict | None = None,
                 idempotency_key: str | None = None,
                 trace_id: str | None = None):
        data = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"} if data else {}
        if data is not None:
            headers["Idempotency-Key"] = idempotency_key or uuid.uuid4().hex
        # One trace id per LOGICAL call, reused across retries/failovers —
        # every attempt of this request shares one lane in the timeline.
        headers[TRACE_HEADER] = trace_id or uuid.uuid4().hex
        attempt = 0
        eps_tried = 1   # endpoints exercised since the last budgeted retry
        while True:
            req = urllib.request.Request(f"{self.base}{path}", data=data,
                                         headers=dict(headers))
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout_s) as resp:
                    self.last_trace_id = (resp.headers.get(TRACE_HEADER)
                                          or headers[TRACE_HEADER])
                    return json.load(resp)
            except urllib.error.HTTPError as err:
                try:
                    body = json.load(err)
                except Exception:   # noqa: BLE001 — a torn error body is still an error
                    body = {"error": str(err)}
                retry_after = err.headers.get("Retry-After")
                retry_after_s = float(retry_after) if retry_after else None
                if err.code == 503 and eps_tried < len(self.endpoints):
                    # This router is down/draining; a sibling may not be.
                    # Rotating is free — no budget, no sleep.
                    eps_tried += 1
                    self._rotate()
                    continue
                if err.code in (429, 503) and attempt < self.retries:
                    # Backpressure with a hint: honor the server's own
                    # Retry-After over our backoff schedule.
                    attempt += 1
                    self.retry_count += 1
                    eps_tried = 1
                    time.sleep(retry_after_s if retry_after_s is not None
                               else self._backoff(attempt))
                    continue
                raise ServeError(err.code, body, retry_after_s) from None
            except (urllib.error.URLError, OSError) as err:
                if eps_tried < len(self.endpoints):
                    eps_tried += 1
                    self._rotate()
                    continue
                if attempt < self.retries:
                    attempt += 1
                    self.retry_count += 1
                    eps_tried = 1
                    time.sleep(self._backoff(attempt))
                    continue
                raise ServeError(0, {"error": f"transport: {err}"}) from None

    def _backoff(self, attempt: int) -> float:
        return min(5.0, self.backoff_s * (2 ** (attempt - 1)))

    # ------------------------------------------------------------ endpoints

    def score(self, *, indices=None, images=None, labels=None,
              tenant: str | None = None, method: str | None = None,
              trace_id: str | None = None) -> dict:
        payload: dict = {}
        if tenant:
            payload["tenant"] = tenant
        if method:
            payload["method"] = method
        if indices is not None:
            payload["indices"] = [int(i) for i in indices]
        if images is not None:
            payload["images"] = images
            payload["labels"] = labels
        return self._request("/v1/score", payload, trace_id=trace_id)

    def rank(self, indices, *, tenant: str | None = None,
             method: str | None = None) -> dict:
        payload: dict = {"indices": [int(i) for i in indices]}
        if tenant:
            payload["tenant"] = tenant
        if method:
            payload["method"] = method
        return self._request("/v1/rank", payload)

    def topk(self, k: int = 10, *, tenant: str | None = None,
             method: str | None = None):
        """Streamed top-k: yields ``(index, score)`` as lines arrive —
        the full response never buffers client-side either. A transport
        failure BEFORE the first line retries like any idempotent GET;
        mid-stream failures surface (the caller has partial state)."""
        qs = f"k={int(k)}"
        if tenant:
            qs += f"&tenant={tenant}"
        if method:
            qs += f"&method={method}"
        attempt = 0
        eps_tried = 1
        tid = uuid.uuid4().hex
        while True:
            req = urllib.request.Request(f"{self.base}/v1/topk?{qs}",
                                         headers={TRACE_HEADER: tid})
            try:
                resp = urllib.request.urlopen(req, timeout=self.timeout_s)
                self.last_trace_id = resp.headers.get(TRACE_HEADER) or tid
            except urllib.error.HTTPError as err:
                try:
                    body = json.load(err)
                except Exception:   # noqa: BLE001
                    body = {"error": str(err)}
                if err.code == 503 and eps_tried < len(self.endpoints):
                    eps_tried += 1
                    self._rotate()
                    continue
                raise ServeError(err.code, body) from None
            except (urllib.error.URLError, OSError) as err:
                if eps_tried < len(self.endpoints):
                    eps_tried += 1
                    self._rotate()
                    continue
                if attempt < self.retries:
                    attempt += 1
                    self.retry_count += 1
                    eps_tried = 1
                    time.sleep(self._backoff(attempt))
                    continue
                raise ServeError(0, {"error": f"transport: {err}"}) from None
            with resp:
                for line in resp:
                    line = line.strip()
                    if line:
                        rec = json.loads(line)
                        yield rec["index"], rec["score"]
            return

    def refresh(self, *, tenant: str | None = None, directory: str | None = None,
                step: int | None = None) -> dict:
        """``POST /v1/refresh`` — against a replica it installs there;
        against the router it rolls the fleet one replica at a time."""
        payload: dict = {}
        if tenant:
            payload["tenant"] = tenant
        if directory:
            payload["dir"] = directory
        if step is not None:
            payload["step"] = int(step)
        return self._request("/v1/refresh", payload)

    def healthz(self) -> dict:
        try:
            return self._request("/healthz")
        except ServeError as err:
            if err.status == 503:   # critical verdict still carries its body
                return err.payload
            raise

    def status(self) -> dict:
        return self._request("/status")


# -------------------------------------------------------------- load driver

def percentile(values: list[float], q: float) -> float | None:
    if not values:
        return None
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, round(q * (len(vs) - 1))))
    return vs[idx]


def load_generate(url: str, *, rps: float, duration_s: float, batch: int = 16,
                  max_index: int = 255, tenant: str | None = None,
                  method: str | None = None, timeout_s: float = 60.0,
                  seed: int = 0, retries: int = 0,
                  backoff_s: float = 0.25, slowest_n: int = 5) -> dict:
    """Drive ``/v1/score`` open-loop at ``rps`` for ``duration_s``; returns
    the latency/outcome report dict ``main`` prints (and ``bench.py --task
    serve`` embeds). ``retries`` makes each request survive backpressure
    and replica churn (the fleet drills drive with retries > 0 and assert
    errors == 0). Every request carries its own ``X-Trace-Id``; the report's
    ``slowest`` block names the ``slowest_n`` worst client-observed
    latencies WITH their trace ids — paste one into
    ``tools/request_report.py`` / the Perfetto timeline to see where the
    time went server-side."""
    client = ServeClient(url, timeout_s=timeout_s, retries=retries,
                         backoff_s=backoff_s)
    rng = random.Random(seed)
    lock = threading.Lock()
    lat_ms: list[float] = []
    per_request: list[dict] = []   # {trace_id, ms, ok} per completed request
    outcomes = {"ok": 0, "rejected": 0, "errors": 0}
    threads: list[threading.Thread] = []

    def one():
        ids = [rng.randrange(max_index + 1) for _ in range(batch)]
        tid = uuid.uuid4().hex
        t0 = time.perf_counter()
        try:
            client.score(indices=ids, tenant=tenant, method=method,
                         trace_id=tid)
            wall = (time.perf_counter() - t0) * 1e3
            with lock:
                outcomes["ok"] += 1
                lat_ms.append(wall)
                per_request.append(
                    {"trace_id": tid, "ms": round(wall, 3), "ok": True})
        except ServeError as err:
            wall = (time.perf_counter() - t0) * 1e3
            with lock:
                outcomes["rejected" if err.status == 429 else "errors"] += 1
                per_request.append(
                    {"trace_id": tid, "ms": round(wall, 3), "ok": False,
                     "status": err.status})
        except Exception:   # noqa: BLE001 — a dead socket is an error outcome
            wall = (time.perf_counter() - t0) * 1e3
            with lock:
                outcomes["errors"] += 1
                per_request.append(
                    {"trace_id": tid, "ms": round(wall, 3), "ok": False})

    interval = 1.0 / max(rps, 1e-9)
    t_start = time.perf_counter()
    n_sent = 0
    while time.perf_counter() - t_start < duration_s:
        t = threading.Thread(target=one, daemon=True)
        t.start()
        threads.append(t)
        n_sent += 1
        next_tick = t_start + n_sent * interval
        delay = next_tick - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
    for t in threads:
        t.join(timeout=timeout_s)
    wall = time.perf_counter() - t_start
    return {
        "sent": n_sent, "ok": outcomes["ok"],
        "rejected": outcomes["rejected"], "errors": outcomes["errors"],
        "retried": client.retry_count, "failovers": client.failovers,
        "offered_rps": round(rps, 2),
        "achieved_rps": round(outcomes["ok"] / wall, 2) if wall else None,
        "batch": batch, "wall_s": round(wall, 3),
        "p50_ms": percentile(lat_ms, 0.50),
        "p95_ms": percentile(lat_ms, 0.95),
        "max_ms": max(lat_ms) if lat_ms else None,
        "slowest": sorted(per_request, key=lambda r: -r["ms"])[:slowest_n],
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Load generator / client for the scoring service")
    parser.add_argument("--url", required=True,
                        help="service base URL (http://host:port); "
                             "comma-separate several for failover")
    parser.add_argument("--rps", type=float, default=20.0,
                        help="offered request rate (open loop)")
    parser.add_argument("--duration", type=float, default=5.0,
                        help="load window in seconds")
    parser.add_argument("--batch", type=int, default=16,
                        help="examples per /v1/score request")
    parser.add_argument("--max-index", type=int, default=255,
                        help="request indices drawn from [0, max-index]")
    parser.add_argument("--tenant", default=None)
    parser.add_argument("--method", default=None)
    parser.add_argument("--timeout", type=float, default=60.0)
    parser.add_argument("--retries", type=int, default=0,
                        help="per-request retry budget (429 honors "
                             "Retry-After; refused connections back off "
                             "exponentially)")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as one JSON object")
    args = parser.parse_args(argv)
    report = load_generate(args.url, rps=args.rps, duration_s=args.duration,
                           batch=args.batch, max_index=args.max_index,
                           tenant=args.tenant, method=args.method,
                           timeout_s=args.timeout, retries=args.retries)
    if args.json:
        print(json.dumps(report))
    else:
        print(f"sent {report['sent']}  ok {report['ok']}  "
              f"rejected(429) {report['rejected']}  "
              f"errors {report['errors']}  retried {report['retried']}")
        print(f"latency ms: p50 {report['p50_ms']}  p95 {report['p95_ms']}  "
              f"max {report['max_ms']}")
        print(f"rate: offered {report['offered_rps']}/s  "
              f"achieved {report['achieved_rps']}/s")
        for r in report["slowest"]:
            flag = "" if r["ok"] else "  [failed]"
            print(f"slowest: {r['ms']:>9.3f} ms  trace {r['trace_id']}{flag}")
    return 0 if report["errors"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
