"""Embedded status/health HTTP server (counterpart of
``data_diet_distributed_tpu/obs/server.py``): the chassis the serving layer
builds on.

Stdlib only (``http.server``), served from daemon threads that keep answering
while the main thread is busy:

* ``GET /healthz``: ok/degraded/critical from the attached watchdog's margin,
  the per-rank heartbeat staleness (the stale rank is named), the consensus
  poison side channel and the SLO engine's violations; 200 for ok/degraded,
  503 for critical.
* ``GET /metrics``: Prometheus text from the live registry (``obs/registry.py``).
* ``GET /status``: JSON progress (stage, seed, epoch, step, throughput,
  ``mfu``, the device-memory watermark, dispatch accounting, ETA) from
  ``note_progress`` and the live registry, with the run's lineage.
* ``GET /flightrec``: the flight recorder's live ring (``obs/flightrec.py``).

The training loop reports through the module-level ``note_progress`` and
attaches its watchdog and consensus for a fit's duration (``attach`` /
``detach``); all three are no-ops until a server is installed.

Port 0 auto-picks a free port, logged as an ``{"kind": "obs_server"}`` record.
A bind failure degrades to a disabled server with one warning. The handler
never raises into the socket: a failing probe answers 500 with the error. The
startup banner goes to stderr (stdout carries only a command's summary).
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["StatusServer", "install", "uninstall", "current", "note_progress",
           "attach", "detach", "DEFAULT_STALE_S"]

#: Heartbeat staleness budget of the verdict when ``obs.slo_heartbeat_stale_s``
#: is not set.
DEFAULT_STALE_S = 60.0

#: Watchdog margin fraction below which /healthz reports degraded.
WATCHDOG_MARGIN_FRAC = 0.10

_SEED_RE = re.compile(r"seed(\d+)$")


def _stage_seed(stage: str | None) -> int | None:
    """Seed parsed from the pipeline's tag convention (``score_pretrain_seed3``)."""
    if not stage:
        return None
    m = _SEED_RE.search(stage)
    return int(m.group(1)) if m else None


class _Handler(BaseHTTPRequestHandler):
    server_version = "ddt-obs/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):   # noqa: D102 — never pollute stdout
        pass

    def do_GET(self):   # noqa: N802 — http.server API
        owner: StatusServer = self.server.owner   # type: ignore[attr-defined]
        t0 = time.perf_counter()
        try:
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            code, body, ctype = self._get_payload(owner, path)
        except Exception as exc:   # noqa: BLE001 — a probe failure is a payload
            body = json.dumps({"error": repr(exc)[:300]}).encode()
            code, ctype = 500, "application/json"
        self._respond(code, body, ctype)
        owner._note_request(time.perf_counter() - t0)

    def _get_payload(self, owner: "StatusServer", path: str) -> tuple[int, bytes, str]:
        """GET dispatch as data, so a subclass can extend the path table."""
        if path == "/healthz":
            health = owner.health()
            code = 503 if health["status"] == "critical" else 200
            return code, json.dumps(health).encode(), "application/json"
        if path == "/metrics":
            text = owner.prometheus()
            code = 200 if text is not None else 503
            body = (text if text is not None
                    else "# no metrics registry installed\n").encode()
            return code, body, "text/plain; version=0.0.4"
        if path == "/status":
            return 200, json.dumps(owner.status()).encode(), "application/json"
        if path == "/flightrec":
            return 200, json.dumps(owner.flightrec()).encode(), "application/json"
        body = json.dumps({"error": f"unknown path {path!r}",
                           "endpoints": owner.endpoint_names()}).encode()
        return 404, body, "application/json"

    def _respond(self, code: int, body: bytes, ctype: str,
                 extra_headers: dict | None = None) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass   # the client went away mid-write


class StatusServer:
    """Threaded HTTP endpoint over the installed obs instruments."""

    #: The request-handler class ``start`` binds; the serving layer's
    #: ``ServeServer`` overrides it to add endpoints.
    handler_class: type = _Handler

    def __init__(self, port: int = 0, host: str = "127.0.0.1", *,
                 stale_after_s: float | None = None, logger=None):
        self.requested_port = int(port)
        self.host = host
        self.stale_after_s = float(stale_after_s) if stale_after_s else DEFAULT_STALE_S
        self.logger = logger
        self.port: int | None = None   # bound port; None = not serving
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._state: dict = {}          # note_progress fields
        self._attached: dict = {}       # watchdog / consensus objects
        self._requests = 0
        self._handle_s = 0.0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> bool:
        """Bind and serve on a daemon thread. Returns whether the server is
        live; a bind failure warns once and leaves a disabled server."""
        try:
            httpd = ThreadingHTTPServer((self.host, self.requested_port),
                                        self.handler_class)
        except OSError as exc:
            print(f"[obs] status server: bind {self.host}:{self.requested_port} "
                  f"failed ({exc}); live endpoints disabled for this run",
                  file=sys.stderr, flush=True)
            return False
        httpd.daemon_threads = True
        httpd.owner = self   # type: ignore[attr-defined]
        self._httpd = httpd
        self.port = int(httpd.server_address[1])
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        name="obs-status-server", daemon=True)
        self._thread.start()
        print(f"[obs] status server listening on http://{self.host}:{self.port} "
              f"({' '.join(self.endpoint_names())})", file=sys.stderr, flush=True)
        if self.logger is not None:
            try:
                self.logger.log("obs_server", event="started", host=self.host,
                                port=self.port)
            except Exception:   # noqa: BLE001 — logging must not kill the server
                pass
        return True

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.port = None

    def _note_request(self, wall_s: float) -> None:
        with self._lock:
            self._requests += 1
            self._handle_s += wall_s

    def stats(self) -> dict:
        with self._lock:
            return {"port": self.port, "requests": self._requests,
                    "handle_s": round(self._handle_s, 4)}

    def endpoint_names(self) -> list[str]:
        """The served paths (the 404 payload and the banner); subclasses extend."""
        return ["/healthz", "/metrics", "/status", "/flightrec"]

    # ------------------------------------------------------- progress inputs

    def note_progress(self, **fields) -> None:
        fields["updated_ts"] = time.time()
        fields["updated_mono"] = time.monotonic()
        with self._lock:
            self._state.update(fields)

    def attach(self, **objects) -> None:
        """Attach live resilience objects (``watchdog=``, ``consensus=``);
        /healthz reads them directly."""
        with self._lock:
            self._attached.update(objects)

    def detach(self, *names: str) -> None:
        with self._lock:
            if not names:
                self._attached.clear()
            for n in names:
                self._attached.pop(n, None)

    # ------------------------------------------------------------ endpoints

    def prometheus(self) -> str | None:
        from . import registry as obs_registry
        reg = obs_registry.current()
        return reg.to_prometheus() if reg is not None else None

    def flightrec(self) -> dict:
        from . import flightrec as obs_flightrec
        rec = obs_flightrec.current()
        if rec is None:
            return {"installed": False, "events": []}
        return {"installed": True, "rank": rec.rank, "capacity": rec.capacity,
                "events": rec.snapshot()}

    def _heartbeat_block(self, now: float) -> dict:
        from . import heartbeat as obs_heartbeat
        hb = obs_heartbeat.current()
        out: dict = {"ranks": 0, "budget_s": self.stale_after_s,
                     "stalest_rank": None, "stalest_age_s": None}
        if hb is None:
            return out
        beats = obs_heartbeat.read_heartbeats(hb.directory)
        out["ranks"] = len(beats)
        out["directory"] = hb.directory
        if beats:
            ages = {rank: now - float(rec.get("ts", now)) for rank, rec in beats.items()}
            stalest = max(ages, key=ages.get)   # type: ignore[arg-type]
            out["stalest_rank"] = int(stalest)
            out["stalest_age_s"] = round(ages[stalest], 3)
        return out

    def _consensus_block(self) -> dict:
        consensus = self._attached.get("consensus")
        out: dict = {"enabled": consensus is not None, "poisoned": False,
                     "poison": None}
        if consensus is None:
            return out
        try:
            directory = consensus.channel.directory
            for name in sorted(os.listdir(directory)):
                if name.startswith("poison.rank") and name.endswith(".json"):
                    out["poisoned"] = True
                    try:
                        with open(os.path.join(directory, name)) as fh:
                            out["poison"] = json.load(fh)
                    except (OSError, ValueError):
                        out["poison"] = {"file": name, "reason": "unreadable poison file"}
                    break
        except OSError:
            pass
        return out

    def health(self) -> dict:
        """The /healthz payload: critical when the watchdog fired or the
        side channel holds a poison record; degraded when a rank's heartbeat
        is past the budget (named), the watchdog margin is under
        ``WATCHDOG_MARGIN_FRAC`` of its deadline, or the SLO engine holds
        violations; ok otherwise."""
        now = time.time()
        reasons: list[str] = []
        status = "ok"

        def degrade(reason: str, *, critical: bool = False) -> None:
            nonlocal status
            reasons.append(reason)
            status = "critical" if (critical or status == "critical") else "degraded"

        wd = self._attached.get("watchdog")
        wd_block: dict = {"armed": wd is not None}
        if wd is not None:
            wd_block.update(wd.status())
            if wd_block.get("fired"):
                degrade(f"watchdog fired ({wd_block.get('label')})", critical=True)
            else:
                margin = wd_block.get("margin_s")
                if margin is not None and margin < WATCHDOG_MARGIN_FRAC * \
                        wd_block.get("timeout_s", 0.0):
                    degrade(f"watchdog margin {margin:.1f}s of "
                            f"{wd_block.get('timeout_s'):g}s deadline")

        hb_block = self._heartbeat_block(now)
        if (hb_block["stalest_age_s"] is not None
                and hb_block["stalest_age_s"] > self.stale_after_s):
            degrade(f"rank{hb_block['stalest_rank']} heartbeat stale "
                    f"{hb_block['stalest_age_s']:.1f}s (budget {self.stale_after_s:g}s)")

        consensus_block = self._consensus_block()
        if consensus_block["poisoned"]:
            poison = consensus_block["poison"] or {}
            degrade(f"consensus poison from rank {poison.get('rank')}: "
                    f"{str(poison.get('reason'))[:120]}", critical=True)

        from . import slo as obs_slo
        engine = obs_slo.current()
        slo_block: dict = {"enabled": engine is not None, "violations": 0, "recent": []}
        if engine is not None:
            v = engine.verdict()
            slo_block.update(violations=v["violations"], recent=v["recent"])
            if v["violations"]:
                names = sorted({r["slo"] for r in v["recent"]})
                degrade(f"slo violated: {', '.join(names)}")

        return {"status": status, "reasons": reasons, "ts": round(now, 3),
                "watchdog": wd_block, "heartbeats": hb_block,
                "consensus": consensus_block, "slo": slo_block}

    def status(self) -> dict:
        """The /status payload: progress and throughput from ``note_progress``
        and the live registry, plus the ETA (null until an epoch finished)."""
        with self._lock:
            st = dict(self._state)
        from . import registry as obs_registry
        reg = obs_registry.current()
        gauges: dict = {}
        hists: dict = {}
        if reg is not None:
            snap = reg.snapshot()
            gauges, hists = snap["gauges"], snap["histograms"]
        out: dict = {"ts": round(time.time(), 3)}
        from . import lineage as obs_lineage
        lin = obs_lineage.current()
        if lin is not None:
            out["lineage"] = {"run_id": lin.run_id, "attempt": lin.attempt,
                              "world": lin.world}
        for k in ("stage", "epoch", "step", "total_epochs", "steps_per_epoch",
                  "chunk_steps", "epochs_done", "dispatches_done",
                  "dispatches_per_epoch", "epoch_s"):
            out[k] = st.get(k)
        out["seed"] = st.get("seed", _stage_seed(st.get("stage")))
        out["examples_per_s"] = st.get("examples_per_s", gauges.get("examples_per_s"))
        out["mfu"] = gauges.get("mfu")
        out["hbm_peak_bytes"] = gauges.get("hbm_peak_bytes")
        if st.get("updated_mono") is not None:
            out["updated_s_ago"] = round(time.monotonic() - st["updated_mono"], 3)
        for name in ("chunk_dispatch_s", "step_dispatch_s"):
            if name in hists:
                out.setdefault("dispatch", {})[name] = {
                    "count": hists[name]["count"], "p50": hists[name]["p50"]}
        out["eta_s"] = self._eta(st, hists)
        return out

    @staticmethod
    def _eta(st: dict, hists: dict) -> float | None:
        total, done = st.get("total_epochs"), st.get("epochs_done")
        if not total or done is None or done <= 0:
            return None
        per = st.get("epoch_s")
        if per is None:
            h = hists.get("epoch_s") or {}
            per = h.get("p50") or h.get("mean")
        if not per:
            return None
        frac = 0.0
        d_done, d_per = st.get("dispatches_done"), st.get("dispatches_per_epoch")
        if d_done and d_per:
            frac = min(1.0, d_done / d_per)
        return round(max(0.0, (total - done - frac) * float(per)), 3)


# --------------------------------------------------------- module-level slot

_SERVER: StatusServer | None = None


def install(server: StatusServer) -> StatusServer:
    global _SERVER
    _SERVER = server
    return server


def uninstall() -> None:
    global _SERVER
    _SERVER = None


def current() -> StatusServer | None:
    return _SERVER



def note_progress(**fields) -> None:
    """Library-code entry: no-op until a server is installed."""
    if _SERVER is not None:
        _SERVER.note_progress(**fields)


def attach(**objects) -> None:
    if _SERVER is not None:
        _SERVER.attach(**{k: v for k, v in objects.items() if v is not None})


def detach(*names: str) -> None:
    if _SERVER is not None:
        _SERVER.detach(*names)
