"""The serving HTTP surface + service lifecycle, on the obs server chassis
(counterpart of ``data_diet_distributed_tpu/serve/server.py``).

``ServeServer`` extends ``obs/server.StatusServer`` (same ThreadingHTTPServer
daemon-thread chassis, same bind-failure degrade contract) with the scoring
endpoints:

* ``POST /v1/score`` — score a batch of examples under a named tenant/method
  (``{"indices": [...]}`` for registered-dataset examples, or
  ``{"images": [...], "labels": [...]}`` for new ones); requests coalesce
  through the batcher into padded dispatches on the card. 429 + Retry-After
  past the admission bound, 503 while draining or once the serving group is
  lost (a peer rank died), 504 past the request budget, 500 when the
  dispatch itself failed (never a plain-route answer).
* ``POST /v1/rank`` — re-rank a slice hardest-first from resident scores.
* ``GET /v1/topk?tenant=&method=&k=`` — top-k hardest, streamed as
  newline-delimited JSON so a ``[N]``-sized response body never exists.
* ``POST /v1/refresh`` — install a checkpoint step's variables (200
  ``installed``; 409 ``rejected`` for a missing or corrupt step, the old model
  still serving).
* everything the obs chassis already serves — ``/healthz`` ``/metrics``
  ``/status`` ``/flightrec`` — with a ``serve`` block added to ``/status``.

``ServeService`` owns the engine + batcher + server trio, the serve_stats /
serve-SLO cadence, and the graceful-drain contract: SIGTERM (via the shared
``resilience/preemption`` handler) stops admission, drains in-flight
requests bounded by ``serve.drain_timeout_s``, and raises ``Preempted`` —
the CLI maps it to exit 75 like every preempted run. ``run_serve`` is the
``cli serve`` entry, on one device or on every rank of a process group. It
scores ``serve.methods`` on the main thread BEFORE the socket binds, which
builds the CUDA kernels there (``serve.warm=false`` builds them at the first
dispatch, on the dispatcher thread under the engine lock). Several replicas
behind the router are ``fleet.py``'s; each is this ``cli serve`` with
``DDT_SERVE_REPLICA`` set (in a fleet of meshes, each rank of the replica's
group; rank 0's ``/healthz`` turns critical once the group is lost).
``/status`` also carries the process's
``kernel_launches`` so far, the group's ``world`` and each rank's launches as
of the last stats point (``rank_kernel_launches``).

Across W ranks (``mesh.multihost``; ``ServeEngine`` runs every operation as a
collective) every rank loads the data, builds the engine, registers the
tenant and runs the warm passes together, so a rank whose warm pass fails
fails the boot of every rank. Then rank 0 alone binds ``serve.port`` and runs
the batcher, the routes, the refresh watcher, ``serve_stats`` and the serve
SLOs, and the other ranks bind nothing and ``follow`` its operations. A
SIGTERM to rank 0 drains it and then stops the peers; a SIGTERM to a peer
reaches rank 0 in the next operation's reply (an idle ``tick`` at the
latest) and drains the service the same way; either way every rank exits 75
with its own ``preempted`` record. A rank lost from the group ends every
other one non-zero within ``resilience.consensus_grace_s`` (the engine's
deadline).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..checkpoint import CheckpointManager
from ..config import SERVABLE_METHODS, Config
from ..device import resolve_device
from ..obs import heartbeat as obs_heartbeat
from ..obs import registry as obs_registry
from ..obs import reqtrace as obs_reqtrace
from ..obs import server as obs_server
from ..obs import slo as obs_slo
from ..ops import kernels
from ..resilience.preemption import Preempted, PreemptionHandler
from .batcher import Backpressure, Draining, ScoreBatcher
from .engine import GroupLost, ServeEngine


def default_methods(cfg: Config) -> tuple[str, ...]:
    """The methods the service warms at boot: ``serve.methods`` when set,
    else the configured ``score.method`` (falling back to el2n when that is
    a trajectory method, which cannot serve a warm checkpoint)."""
    if cfg.serve.methods:
        return tuple(cfg.serve.methods)
    if cfg.score.method in SERVABLE_METHODS:
        return (cfg.score.method,)
    return ("el2n",)


class _ServeHandler(obs_server._Handler):
    server_version = "ddt-serve/1"

    def _fault_gate(self) -> bool:
        """Injected network faults (``resilience/inject.py``): a
        partitioned replica drops the connection without writing a byte —
        /healthz included: a transport error, not an HTTP status — and a
        slow replica delays every response. Deliberately NOT a
        hold-the-socket black hole: the peer fails fast instead of eating
        its own request deadline. True = the request was eaten."""
        from ..resilience import inject
        if inject.serve_partitioned():
            self.close_connection = True
            with contextlib.suppress(OSError):
                self.connection.shutdown(socket.SHUT_RDWR)
            return True
        owner = self.server.owner   # type: ignore[attr-defined]
        service = getattr(owner, "service", None)
        step = (service.model_steps.get(service.default_tenant)
                if service is not None else None)
        delay_ms = inject.serve_slow_ms(step)
        if delay_ms:
            time.sleep(delay_ms / 1e3)
        return False

    def do_GET(self):   # noqa: N802 — http.server API
        if self._fault_gate():
            return
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/v1/topk":
            owner = self.server.owner   # type: ignore[attr-defined]
            t0 = time.perf_counter()
            try:
                self._stream_topk(owner)
            except Exception as exc:   # noqa: BLE001 — never into the socket
                self._respond(500, json.dumps(
                    {"error": repr(exc)[:300]}).encode(), "application/json")
            owner._note_request(time.perf_counter() - t0)
            return
        super().do_GET()

    def do_POST(self):   # noqa: N802 — http.server API
        if self._fault_gate():
            return
        owner = self.server.owner   # type: ignore[attr-defined]
        t0 = time.perf_counter()
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        # Trace identity: accept the upstream hop's id (router or client),
        # mint at this edge otherwise; every response echoes it back. The
        # keep header is the router's retention hint for an already-
        # interesting request (retry/hedge in flight).
        trace_id = (self.headers.get(obs_reqtrace.TRACE_HEADER)
                    or obs_reqtrace.mint_trace_id())
        trace = obs_reqtrace.RequestTrace(
            trace_id,
            keep_hint=self.headers.get(obs_reqtrace.KEEP_HEADER) == "1")
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
        except (ValueError, OSError) as exc:
            self._respond(400, json.dumps(
                {"error": f"bad request body: {exc}"[:300]}).encode(),
                "application/json",
                {obs_reqtrace.TRACE_HEADER: trace_id})
            owner._note_request(time.perf_counter() - t0)
            return
        try:
            service = owner.service
            with service.http_inflight():
                if path == "/v1/score":
                    code, payload, headers = service.handle_score(
                        body, trace=trace)
                elif path == "/v1/rank":
                    code, payload, headers = service.handle_rank(body)
                elif path == "/v1/refresh":
                    code, payload, headers = service.handle_refresh(body)
                else:
                    code, headers = 404, {}
                    payload = {"error": f"unknown path {path!r}",
                               "endpoints": owner.endpoint_names()}
        except Exception as exc:   # noqa: BLE001 — a failure is a payload
            code, payload, headers = 500, {"error": repr(exc)[:300]}, {}
        # An Idempotency-Key echoes on every response.
        idem = self.headers.get("Idempotency-Key")
        if idem:
            headers = dict(headers, **{"Idempotency-Key": idem})
        headers = dict(headers, **{obs_reqtrace.TRACE_HEADER: trace_id})
        t_ser = time.perf_counter()
        self._respond(code, json.dumps(payload).encode(), "application/json",
                      headers)
        trace.add_ms("serialize", (time.perf_counter() - t_ser) * 1e3)
        owner._note_request(time.perf_counter() - t0)
        owner.service.emit_trace(trace, status=code, path=path,
                                 tenant=body.get("tenant"),
                                 method=body.get("method"),
                                 wall_ms=(time.perf_counter() - t0) * 1e3)

    def _stream_topk(self, owner) -> None:
        service = owner.service
        qs = parse_qs(urlsplit(self.path).query)

        def q(name, default=None):
            vals = qs.get(name)
            return vals[0] if vals else default

        try:
            k = int(q("k", "10"))
            # Resolve the scores BEFORE the status line: an unknown
            # tenant/method must be a 400, not a torn 200 stream.
            tenant, method, items = service.topk_prepare(
                q("tenant"), q("method"), k)
        except (KeyError, ValueError) as exc:
            self._respond(400, json.dumps(
                {"error": str(exc)[:300]}).encode(), "application/json")
            return
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("X-Serve-Tenant", tenant)
            self.send_header("X-Serve-Method", method)
            self.send_header(obs_reqtrace.TRACE_HEADER,
                             self.headers.get(obs_reqtrace.TRACE_HEADER)
                             or obs_reqtrace.mint_trace_id())
            # Body-until-close framing: the item count is not known to be
            # small, and buffering it whole would defeat the streaming
            # contract ([N] never materializes as one response body).
            self.send_header("Connection", "close")
            self.end_headers()
            for index, score in items:
                self.wfile.write(json.dumps(
                    {"index": index, "score": score}).encode() + b"\n")
        except OSError:
            pass   # client went away mid-stream
        self.close_connection = True


class ServeServer(obs_server.StatusServer):
    """The obs StatusServer chassis + the /v1 scoring endpoints."""

    handler_class = _ServeHandler

    def __init__(self, service: "ServeService", **kwargs):
        super().__init__(**kwargs)
        self.service = service

    def endpoint_names(self) -> list[str]:
        return super().endpoint_names() + ["/v1/score", "/v1/rank",
                                           "/v1/topk", "/v1/refresh"]

    def status(self) -> dict:
        out = super().status()
        out["serve"] = self.service.stats_record()
        # A reader takes the delta across one request: its dispatch's launches.
        out["kernel_launches"] = kernels.launch_counts()
        # Every rank's, as of the last stats point (a gather at that cadence).
        out["world"] = self.service.engine.world
        out["rank_kernel_launches"] = self.service.engine.rank_launches
        return out

    def health(self) -> dict:
        """The obs chassis verdict + the serve-side watchdog: a score
        dispatch in flight past ``serve.dispatch_stall_s`` is a WEDGED
        dispatcher — requests queue behind a worker that will never answer
        them — and the verdict goes critical (503). A cold call (the first
        of its program: kernel loads, cuDNN plans and the chunk's CUDA-graph
        capture, 2-5 s for ResNet-18 GraNd on an H100) is held to
        ``serve.request_timeout_s`` instead, where the JAX package holds
        every call to the stall budget: otherwise every fresh replica's first
        request would read as a wedge and its respawn would be cold again. A
        hang inside a CUDA call is beyond the in-process watchdog; this only
        reports it."""
        out = super().health()
        # Load evidence: queue depth and admission counters (the signals
        # check_serve judges).
        b = self.service.batcher.stats()
        out["serve_load"] = {
            "queued": int(sum(b["queued"].values())),
            "inflight": int(b["inflight"]),
            "accepted": int(b["accepted"]),
            "rejected": int(b["rejected"]),
        }
        sv = self.service.cfg.serve
        budget = sv.dispatch_stall_s
        age = self.service.batcher.dispatch_age_s()
        cold = self.service.engine.cold_call
        out["serve_watchdog"] = {
            "dispatch_age_s": None if age is None else round(age, 3),
            "dispatch_stall_budget_s": budget,
            "cold": cold,
        }
        limit, name = ((max(budget, sv.request_timeout_s), "serve.request_timeout_s")
                       if cold and budget is not None else (budget, "serve.dispatch_stall_s"))
        if limit is not None and age is not None and age > limit:
            out["status"] = "critical"
            out.setdefault("reasons", []).append(
                f"serve dispatcher stalled: {'cold ' if cold else ''}dispatch in flight "
                f"{age:.1f}s > {name}={limit:g}")
        lost = self.service.engine.group_error
        if lost is not None:
            # A peer of the serving group is gone: no operation can run, so
            # a fleet's router stops routing here before its supervisor
            # has seen the death.
            out["status"] = "critical"
            out.setdefault("reasons", []).append(
                f"serving group lost: {lost!r}"[:300])
        return out


class ServeService:
    """Engine + batcher + server, with the stats/SLO cadence and the
    graceful-drain lifecycle."""

    def __init__(self, engine: ServeEngine, cfg: Config, logger=None):
        self.engine = engine
        self.cfg = cfg
        self.logger = logger
        sv = cfg.serve
        self.default_tenant = sv.tenant or cfg.data.dataset
        self.default_method = default_methods(cfg)[0]
        self.batcher = ScoreBatcher(
            engine, max_queue=sv.max_queue,
            coalesce_window_s=sv.coalesce_ms / 1e3,
            retry_after_s=sv.retry_after_s, request_log=sv.request_log,
            logger=logger)
        self.server = ServeServer(
            self, port=sv.port, host=sv.host,
            stale_after_s=cfg.obs.slo_heartbeat_stale_s, logger=logger)
        self._installed = False
        self._draining = False
        self._http_inflight = 0
        self._inflight_lock = threading.Lock()
        self._stats_seq = 0
        self._started_ts = time.time()
        # Refresh-vs-drain exclusion: a refresh holds this for its whole
        # restore+install; drain acquires it FIRST, so a SIGTERM landing
        # mid-refresh waits for the atomic install (or its loud rejection)
        # to finish before exit 75 — a tenant is never left half-registered.
        self._refresh_lock = threading.Lock()
        #: tenant -> checkpoint step its scoring variables came from (None =
        #: the boot-time config recipe). /status + model_refresh evidence.
        self.model_steps: dict[str, int | None] = {}
        # Replica identity (DDT_SERVE_REPLICA, the JAX fleet's variable):
        # rides every stats record so a shared metrics stream attributes lines.
        rep = os.environ.get("DDT_SERVE_REPLICA")
        self.replica = int(rep) if rep is not None else None
        # Request-tracing retention policy (obs/reqtrace): deterministic
        # head-sampling for healthy traffic, always-keep for the tail.
        self.trace_frac = float(sv.trace_sample_frac)
        self.trace_slow_ms = obs_reqtrace.slow_threshold_ms(cfg)
        self._watch_stop = threading.Event()
        self._watch_thread: threading.Thread | None = None

    # ----------------------------------------------------------- lifecycle

    @property
    def port(self) -> int | None:
        return self.server.port

    def start(self) -> bool:
        self.batcher.start()
        ok = self.server.start()
        if ok and obs_server.current() is None:
            # The module slot makes /healthz read the live instruments and
            # lets run_monitor/note_progress find THE server; an already-
            # installed one (an ObsSession's) keeps the slot.
            obs_server.install(self.server)
            self._installed = True
        return ok

    def stop(self) -> None:
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5.0)
            self._watch_thread = None
        self.batcher.stop()
        self.server.stop()
        if self._installed and obs_server.current() is self.server:
            obs_server.uninstall()
            self._installed = False

    @contextlib.contextmanager
    def http_inflight(self):
        """Active /v1 handler accounting — the drain waits for zero so a
        response already computed is always written before exit."""
        with self._inflight_lock:
            self._http_inflight += 1
        try:
            yield
        finally:
            with self._inflight_lock:
                self._http_inflight -= 1

    def drain(self) -> bool:
        """Graceful drain: stop admission, finish queued + in-flight work
        bounded by ``serve.drain_timeout_s``, wait for active handlers to
        write their responses. Returns whether everything drained in
        budget."""
        self._draining = True
        # A refresh in flight finishes (its install is one atomic swap) or
        # rejects loudly BEFORE the drain proceeds; a refresh arriving
        # after this sees _draining inside the lock and is refused. Without
        # this handshake a SIGTERM mid-refresh raced the swap out of exit
        # 75 with the tenant half-registered.
        got_refresh = self._refresh_lock.acquire(
            timeout=self.cfg.serve.drain_timeout_s)
        try:
            self.batcher.stop_admission()
            if self.logger is not None:
                self.logger.log("serve_admission", tenant="*", action="drain",
                                queue_depth=sum(
                                    self.batcher.stats()["queued"].values()))
            drained = self.batcher.drain(self.cfg.serve.drain_timeout_s)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                with self._inflight_lock:
                    if self._http_inflight == 0:
                        break
                time.sleep(0.01)
            return drained and got_refresh
        finally:
            if got_refresh:
                self._refresh_lock.release()

    def wait_until_preempted(self) -> None:
        """The serve loop: heartbeat + stats/SLO cadence until SIGTERM/
        SIGINT (the shared preemption handler) or a peer's agreed preemption,
        then drain, stop the group's peers and raise ``Preempted`` — the CLI
        maps it to exit 75. A failed collective of the group raises
        ``GroupLost`` instead."""
        preempt = PreemptionHandler(enabled=self.cfg.resilience.preemption)
        engine = self.engine
        last_stats = time.monotonic()
        with preempt:
            while not (preempt.requested or engine.preempt_agreed.is_set()):
                if engine.group_error is not None:
                    raise GroupLost(f"the serving group failed: {engine.group_error!r}"
                                    ) from engine.group_error
                time.sleep(0.05)
                obs_heartbeat.beat(stage="serve")
                if (time.monotonic() - last_stats
                        >= self.cfg.serve.stats_every_s):
                    self.emit_stats()
                    last_stats = time.monotonic()
        drained = self.drain()
        self.emit_stats()
        signame = preempt.signame if preempt.requested else "peer"
        engine.stop_group("preempted", signal=signame, drained=drained)
        if self.logger is not None:
            self.logger.log("preempted", signal=signame, tag="serve",
                            drained=drained)
        raise Preempted(signame)

    # ------------------------------------------------------------ handlers

    def handle_score(self, body: dict, trace=None) -> tuple[int, dict, dict]:
        tenant = body.get("tenant") or self.default_tenant
        method = body.get("method") or self.default_method
        try:
            ids = body.get("indices")
            if ids is not None:
                images, labels = self.engine.examples_for(tenant, ids)
            elif body.get("images") is not None:
                if body.get("labels") is None:
                    return 400, {"error": "scoring new examples needs "
                                          "\"labels\" next to \"images\""}, {}
                images = np.asarray(body["images"], np.float32)
                labels = np.asarray(body["labels"], np.int32)
            else:
                return 400, {"error": "need \"indices\" (registered "
                                      "examples) or \"images\"+\"labels\""}, {}
            scores = self.batcher.submit(
                tenant, method, images, labels,
                timeout_s=self.cfg.serve.request_timeout_s, trace=trace)
        except Backpressure as exc:
            return (429, {"error": str(exc),
                          "retry_after_s": exc.retry_after_s},
                    {"Retry-After": max(1, round(exc.retry_after_s))})
        except Draining:
            return 503, {"error": "service is draining; admission stopped"}, {}
        except GroupLost as exc:
            # A peer rank is gone and this replica with it: a keyed client
            # retries, and the fleet's router has stopped routing here.
            return (503, {"error": f"serving group lost: {exc}"[:300],
                          "retry_after_s": self.cfg.serve.retry_after_s},
                    {"Retry-After": max(1, round(self.cfg.serve.retry_after_s))})
        except TimeoutError as exc:
            return 504, {"error": str(exc)[:300]}, {}
        except (KeyError, ValueError) as exc:
            return 400, {"error": str(exc)[:300]}, {}
        payload = {"tenant": tenant, "method": method, "n": int(len(scores)),
                   "scores": [float(s) for s in scores]}
        if ids is not None:
            payload["indices"] = [int(i) for i in ids]
        return 200, payload, {}

    def handle_rank(self, body: dict) -> tuple[int, dict, dict]:
        tenant = body.get("tenant") or self.default_tenant
        method = body.get("method") or self.default_method
        ids = body.get("indices")
        if not ids:
            return 400, {"error": "rank needs a non-empty \"indices\""}, {}
        if self._draining:
            return 503, {"error": "service is draining"}, {}
        try:
            ranked, scores = self.engine.rank(tenant, method, ids)
        except (KeyError, ValueError) as exc:
            return 400, {"error": str(exc)[:300]}, {}
        return 200, {"tenant": tenant, "method": method,
                     "indices": [int(i) for i in ranked],
                     "scores": [float(s) for s in scores]}, {}

    def refresh_source(self) -> str | None:
        return self.cfg.serve.refresh_from or self.cfg.train.checkpoint_dir

    def handle_refresh(self, body: dict) -> tuple[int, dict, dict]:
        tenant = body.get("tenant") or self.default_tenant
        return self.refresh(tenant, directory=body.get("dir"),
                            step=body.get("step"))

    def refresh(self, tenant: str, *, directory: str | None = None,
                step: int | None = None) -> tuple[int, dict, dict]:
        """Zero-downtime model refresh: re-register ``tenant``'s scoring
        variables from a training checkpoint, digest-verified before
        install, swapped atomically between dispatches (``refresh_tenant``
        holds the engine's dispatch lock for one assignment). Serving never
        pauses: the restore runs outside every lock, and any request is
        answered entirely by the old or entirely by the new model. Returns
        the HTTP triple; every outcome is a ``model_refresh`` record."""
        directory = directory or self.refresh_source()
        if not directory:
            return 400, {"error": "no refresh source: set serve.refresh_from "
                                  "or train.checkpoint_dir (or pass "
                                  "\"dir\")"}, {}
        t0 = time.perf_counter()
        with self._refresh_lock:
            if self._draining:
                return 503, {"error": "service is draining; refresh "
                                      "refused"}, {}
            try:
                variables, used = self.engine.load_checkpoint_variables(
                    directory, step)
                self.engine.refresh_tenant(tenant, [variables],
                                           source=(directory, used))
            except KeyError as exc:
                # Unknown tenant: the caller's mistake, not the checkpoint's.
                return 400, {"error": str(exc)[:300]}, {}
            except Exception as exc:   # noqa: BLE001 — corrupt/missing ckpt
                # CheckpointCorrupt, FileNotFoundError, a torn payload:
                # rejected LOUDLY, old model untouched and still serving.
                if self.logger is not None:
                    self.logger.log("model_refresh", tenant=tenant,
                                    status="rejected", dir=directory,
                                    step=step, replica=self.replica,
                                    error=repr(exc)[:300])
                return 409, {"error": f"refresh rejected: {exc!r}"[:400],
                             "tenant": tenant, "dir": directory,
                             "status": "rejected"}, {}
            self.model_steps[tenant] = used
            wall_ms = round((time.perf_counter() - t0) * 1e3, 3)
            if self.logger is not None:
                self.logger.log("model_refresh", tenant=tenant,
                                status="installed", dir=directory, step=used,
                                replica=self.replica, wall_ms=wall_ms)
            return 200, {"tenant": tenant, "step": used,
                         "status": "installed", "wall_ms": wall_ms}, {}

    # ----------------------------------------------------- refresh watcher

    def start_refresh_watch(self) -> None:
        """The ``serve.refresh_poll_s`` watcher: poll the refresh source for
        a durable step newer than the installed one and refresh the default
        tenant when one lands. Manual ``POST /v1/refresh`` stays available
        either way."""
        poll = self.cfg.serve.refresh_poll_s
        if poll is None or self._watch_thread is not None:
            return
        self._watch_thread = threading.Thread(
            target=self._refresh_watch_loop, args=(float(poll),),
            name="serve-refresh-watch", daemon=True)
        self._watch_thread.start()

    def _refresh_watch_loop(self, poll_s: float) -> None:
        while not self._watch_stop.wait(poll_s):
            if self._draining:
                return
            directory = self.refresh_source()
            if not directory or not os.path.isdir(directory):
                continue
            try:
                steps = CheckpointManager(directory).all_steps()
            except OSError:
                continue
            if not steps:
                continue
            newest = steps[-1]
            installed = self.model_steps.get(self.default_tenant)
            if installed is not None and newest <= installed:
                continue
            self.refresh(self.default_tenant, step=newest)

    def topk_prepare(self, tenant: str | None, method: str | None, k: int):
        """Resolve + force the resident scores (errors surface BEFORE the
        response status line), returning the streamable item iterator."""
        tenant = tenant or self.default_tenant
        method = method or self.default_method
        if self._draining:
            raise ValueError("service is draining")
        self.engine.full_scores(tenant, method)
        return tenant, method, self.engine.topk(tenant, method, k)

    # ------------------------------------------------------ request tracing

    def emit_trace(self, trace, *, status: int, wall_ms: float,
                   path: str, tenant: str | None,
                   method: str | None) -> None:
        """Replica-side ``serve_trace`` emission with tail-biased
        retention: failed (>=400), slow (past the resolved threshold), or
        hop-flagged (``X-Trace-Keep``) requests always keep their record;
        healthy traffic head-samples by hashing the trace id. The
        serialize phase feeds its live histogram either way (the batcher
        already observed queue/coalesce/dispatch/fetch)."""
        ser = trace.phases.get("serialize")
        if ser is not None:
            obs_reqtrace.observe_phases({"serialize": ser})
        failed = status >= 400
        slow = wall_ms >= self.trace_slow_ms
        if not obs_reqtrace.should_keep(trace.trace_id, self.trace_frac,
                                        failed=failed, slow=slow,
                                        flagged=trace.keep_hint):
            return
        obs_reqtrace.emit(
            self.logger, trace_id=trace.trace_id, where="replica",
            status=status, wall_ms=wall_ms, phases=trace.phases,
            sampled=not (failed or slow or trace.keep_hint),
            path=path, tenant=tenant or self.default_tenant,
            method=method or self.default_method, replica=self.replica,
            cold=trace.cold, batch_fill=trace.batch_fill)

    # --------------------------------------------------------- stats / SLO

    def stats_record(self) -> dict:
        b = self.batcher.stats()
        p50 = p95 = None
        reg = obs_registry.current()
        if reg is not None:
            h = reg.snapshot()["histograms"].get("serve_request_ms")
            if h:
                p50, p95 = h.get("p50"), h.get("p95")
        return {
            "requests": b["accepted"], "completed": b["completed"],
            "rejected": b["rejected"], "failed": b["failed"],
            "dispatches": b["dispatches"], "batch_fill": b["batch_fill"],
            "queued": b["queued"], "inflight": b["inflight"],
            "admitting": b["admitting"],
            "p50_ms": p50, "p95_ms": p95,
            "tenants": sorted(self.engine.tenants),
            "model_steps": dict(self.model_steps),
            "replica": self.replica,
            "programs": self.engine.program_stats(),
            "phases": obs_reqtrace.phase_summary(reg),
            "uptime_s": round(time.time() - self._started_ts, 3),
        }

    def emit_stats(self) -> dict:
        """One ``{"kind": "serve_stats"}`` record + the serve-SLO evaluation
        point + the live gauges — the serve loop's cadence unit. The record
        also carries the group's ``world`` and each rank's kernel launches,
        gathered here."""
        launches = self.engine.gather_rank_launches()
        rec = self.stats_record()
        self._stats_seq += 1
        if self.logger is not None:
            self.logger.log("serve_stats", **rec, world=self.engine.world,
                            rank_kernel_launches=launches)
        queue_depth = sum(rec["queued"].values())
        submitted = rec["requests"] + rec["rejected"]
        reject_frac = rec["rejected"] / submitted if submitted else 0.0
        obs_registry.set_gauge("serve_queue_depth", float(queue_depth))
        obs_registry.set_gauge("serve_reject_frac", round(reject_frac, 6))
        if rec["p95_ms"] is not None:
            obs_registry.set_gauge("serve_p95_ms", rec["p95_ms"])
        obs_slo.check_serve(point=self._stats_seq, p95_ms=rec["p95_ms"],
                            queue_depth=queue_depth,
                            reject_frac=reject_frac, logger=self.logger,
                            phases=rec.get("phases"))
        return rec


def run_serve(cfg: Config, logger, device=None) -> dict | None:
    """The ``cli serve`` body: boot the engine on ``device`` (CUDA unless
    ``"cpu"``), register the configured tenant, score the configured methods
    on this thread (``serve.warm``: the kernels build here, before the socket
    binds), then bind and serve until preempted (SIGTERM -> drain ->
    ``Preempted`` -> CLI exit 75). In a process group every rank boots the
    same way, then rank 0 serves and the others follow (``_follow``)."""
    from ..train.loop import load_data_for
    device = resolve_device(device)   # without CUDA this raises before any work
    train_ds, _ = load_data_for(cfg)
    engine = ServeEngine(cfg, device=device, logger=logger)
    tenant = cfg.serve.tenant or cfg.data.dataset
    engine.register_tenant(tenant, train_ds)
    if cfg.serve.warm:
        for m in default_methods(cfg):
            t0 = time.perf_counter()
            engine.full_scores(tenant, m)   # across ranks: fails on every rank or none
            logger.log("serve_stats", requests=0, dispatches=0, p95_ms=None,
                       event="warm", tenant=tenant, method=m,
                       warm_s=round(time.perf_counter() - t0, 3))
    if engine.rank_index > 0:
        return _follow(engine, cfg, logger)
    service = ServeService(engine, cfg, logger=logger)
    engine.lead()   # before the batcher can dispatch
    try:
        if not service.start():
            # For the serve command serving IS the run: refuse loudly instead
            # of heartbeating behind a port nobody can reach.
            raise RuntimeError(
                f"serve: could not bind {cfg.serve.host}:{cfg.serve.port} — "
                "the service has no endpoint; pick a free serve.port (0 = auto)")
        service.emit_stats()
        service.start_refresh_watch()
        service.wait_until_preempted()   # raises Preempted on SIGTERM
        return {"serve": service.stats_record()}
    finally:
        engine.stop_group("error")   # a no-op after the preempted stop
        service.stop()


def _follow(engine: ServeEngine, cfg: Config, logger) -> None:
    """A rank above 0: run rank 0's operations until it stops the group, then
    raise ``Preempted`` (exit 75, after this rank's ``preempted`` record) when
    it stopped for a preemption, whichever rank received the signal, and
    ``RuntimeError`` otherwise. This rank's SIGTERM only sets the flag that
    the next operation's reply carries to rank 0."""
    preempt = PreemptionHandler(enabled=cfg.resilience.preemption)
    with preempt:
        stop = engine.follow(lambda: preempt.requested)
    if stop.get("reason") != "preempted":
        raise RuntimeError(f"rank 0 stopped the serving group: {stop.get('reason')!r}")
    signame = preempt.signame if preempt.requested else str(stop.get("signal") or "peer")
    logger.log("preempted", signal=signame, tag="serve", drained=stop.get("drained"),
               rank=engine.rank_index)
    raise Preempted(signame)
