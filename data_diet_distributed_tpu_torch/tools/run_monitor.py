"""Live terminal view of a training run, from its embedded status server.

The port's copy of ``tools/run_monitor.py``: the same arguments and output, built
on the port's own modules, so it runs on a host without JAX::

    python -m data_diet_distributed_tpu_torch.tools.run_monitor ...

Polls the ``obs/server.py`` endpoints of a running process and renders one
compact status screen: progress (stage/seed/epoch/step), throughput, MFU,
ETA, the health verdict with its reasons, the fleet view (straggler named),
and the SLO state. When the server is unreachable — the run is dead, or was
started without one — the monitor DEGRADES to the on-disk artifacts: the
per-rank heartbeat files (``obs/heartbeat.py``) and the metrics JSONL, which
answer the same questions one write behind.

Usage::

    python -m data_diet_distributed_tpu_torch.tools.run_monitor --port 8787                 # live, refreshing
    python -m data_diet_distributed_tpu_torch.tools.run_monitor --url http://host:8787 --once --json
    python -m data_diet_distributed_tpu_torch.tools.run_monitor --metrics metrics.jsonl \
        --heartbeat-dir ./checkpoints_heartbeats --once     # dead-run mode

CI exit contract (``--once``; pinned by tests/test_run_monitor.py)::

    0  healthy — verdict ok, no SLO violations
    1  SLO violated (or the run is degraded/critical for a non-staleness
       reason): the run is alive but out of contract. In files mode this
       also covers a broken LINEAGE: an attempt gap the supervisor's
       records do not explain (``obs/timeline.py``'s judgment)
    2  unreachable or stale: no server AND no readable artifacts, heartbeats
       past --stale-after with no terminal run_summary, or a critical
       verdict (poison / fired watchdog) — the run needs an operator, not a
       dashboard

A finished run (its stream ends with the ``run_summary`` terminal event) is
judged by its records, not by heartbeat age: 1 if it recorded SLO
violations, else 0 — so the same command works as a post-run gate. With
lineage-stamped streams (``obs/lineage.py``) the judgment covers the WHOLE
elastic lineage, not the last attempt: a run that lost a host, shrank, and
recovered is healthy (exit 0) as long as every attempt transition is
explained by the supervisor's records — while an attempt that appears with
no explaining launch/classification exits 1 even though its own records
look clean.
"""

from __future__ import annotations

import argparse
import json
import time
import urllib.error
import urllib.request

EXIT_HEALTHY, EXIT_SLO, EXIT_UNREACHABLE = 0, 1, 2

#: Heartbeat age past which a run with no terminal record counts as dead.
DEFAULT_STALE_AFTER_S = 60.0


def fetch_json(url: str, timeout: float = 2.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.load(resp)


def gather_live(base_url: str, timeout: float = 2.0) -> dict | None:
    """/healthz + /status from a live server, or None when unreachable.
    A 503 /healthz (critical verdict) still carries its JSON body — that is
    a reachable, answering server, not an unreachable one."""
    base = base_url.rstrip("/")
    try:
        try:
            health = fetch_json(f"{base}/healthz", timeout)
        except urllib.error.HTTPError as err:
            health = json.load(err)   # 503 critical: body is the payload
        status = fetch_json(f"{base}/status", timeout)
    except Exception as exc:   # noqa: BLE001 — unreachable is a verdict, not a crash
        return {"source": "server", "unreachable": True,
                "error": f"{type(exc).__name__}: {exc}"[:200]}
    return {"source": "server", "unreachable": False, "healthz": health,
            "status": status}


def tail_records(path: str, kinds: tuple[str, ...] | None = None,
                 limit: int = 5000) -> list[dict]:
    """The last ``limit`` JSONL records (optionally filtered by kind);
    partial trailing lines tolerated like every stream consumer."""
    records: list[dict] = []
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
                if not isinstance(rec, dict):
                    continue
                if kinds is None or rec.get("kind") in kinds:
                    records.append(rec)
                    del records[:-limit]
    except OSError:
        return []
    return records


def gather_files(metrics: str | None, heartbeat_dir: str | None,
                 stale_after_s: float, lineage: bool = True) -> dict:
    """The dead-run view from on-disk artifacts: fleet from heartbeats,
    progress/violations/terminal state from the metrics stream.

    ``lineage=False`` skips the whole-lineage judgment: it materializes the
    FULL stream (the judgment needs resume/fault/training records the
    display tail filters out), which is a per-tick O(stream) cost the watch
    loop must not pay — the judgment gates the ``--once`` CI verdict."""
    out: dict = {"source": "files", "unreachable": False}
    now = time.time()
    if heartbeat_dir:
        from ..obs.fleet import fleet_view
        view = fleet_view(heartbeat_dir, stale_budget_s=stale_after_s)
        if view is not None:   # an empty/cleaned-up dir must not mask the
            out["fleet"] = view   # stream's fleet_status fallback below
    if metrics:
        recs = tail_records(metrics, ("epoch", "run_summary", "slo_violation",
                                      "fleet_status", "summary",
                                      "elastic_event", "soak_report",
                                      "serve_fleet", "replica_event",
                                      "model_refresh", "autoscale_event",
                                      "data_plane", "data_fault",
                                      "shard_quarantine", "serve_trace"))
        view = None
        if lineage:
            from ..obs.timeline import (lineage_view,
                                                                read_records)
            view = lineage_view(read_records(metrics))
        if view is not None:
            # Headline counts exclude requested grow/resize transitions —
            # same semantics as the supervisor's run_summary lineage block
            # (a requested grow is not a failure recovery).
            failures = [c for c in view["recoveries"]
                        if not c.get("requested")]
            out["lineage"] = {
                "run_ids": view["run_ids"],
                "attempts": view["attempts"],
                "worlds": view["worlds"],
                "recoveries": len(failures),
                "recovery_walls_s": [c.get("recovery_wall_s")
                                     for c in failures],
                "unexplained": view["unexplained"],
                "lost_wall_s": view["lost_wall_s"],
            }
        ts = [r["ts"] for r in recs if isinstance(r.get("ts"), (int, float))]
        if ts:
            # Liveness of the STREAM itself: a run with no terminal record
            # whose newest line is old is dead, whatever that line said.
            out["last_record_age_s"] = round(now - max(ts), 3)
        epochs = [r for r in recs if r.get("kind") == "epoch"]
        if epochs:
            out["last_epoch"] = epochs[-1]
        out["violations"] = [r for r in recs
                             if r.get("kind") == "slo_violation"]
        terminal = [r for r in recs if r.get("kind") == "run_summary"]
        if terminal:
            out["run_summary"] = terminal[-1]
        elastic = [r for r in recs if r.get("kind") == "elastic_event"]
        if elastic:
            # Display-only: recoveries never flip the verdict (a shrunken
            # pod that finished healthy IS healthy — that's the point).
            out["elastic"] = {
                "events": len(elastic),
                "shrinks": sum(r.get("event") == "shrink" for r in elastic),
                "grows": sum(r.get("event") == "grow" for r in elastic),
                "restarts": sum(r.get("event") == "restart" for r in elastic),
                "last": elastic[-1].get("event"),
                "world": elastic[-1].get("world"),
            }
        serve_fleet = [r for r in recs if r.get("kind") == "serve_fleet"]
        replica_events = [r for r in recs if r.get("kind") == "replica_event"]
        if serve_fleet or replica_events:
            # Display-only, like the elastic block: replica churn the
            # fleet absorbed never flips the verdict — only SLO violations
            # and staleness do.
            stats = [r for r in serve_fleet if r.get("event") == "stats"]
            refresh = [r for r in recs if r.get("kind") == "model_refresh"]
            out["serve_fleet"] = {
                "events": len(serve_fleet) + len(replica_events),
                "respawns": sum(r.get("event") == "respawn"
                                for r in replica_events),
                "deaths": sum(r.get("event") in ("died", "exited")
                              for r in replica_events),
                "wedged": sum(r.get("event") == "wedged"
                              for r in replica_events),
                "partitioned": sum(r.get("event") == "partitioned"
                                   for r in replica_events),
                "reconnected": sum(r.get("event") == "reconnected"
                                   for r in replica_events),
                "refreshes": sum(r.get("status") == "installed"
                                 for r in refresh),
                "refresh_rejected": sum(r.get("status") == "rejected"
                                        for r in refresh),
                "refresh_rolled_back": sum(r.get("status") == "rolled_back"
                                           for r in refresh),
                "last": (serve_fleet[-1].get("event")
                         if serve_fleet else None),
                "available": (stats[-1].get("available")
                              if stats else None),
                "p95_ms": stats[-1].get("p95_ms") if stats else None,
            }
        autoscale = [r for r in recs if r.get("kind") == "autoscale_event"]
        if autoscale:
            # Display-only, like the elastic block: a fleet that resized
            # within its bounds is doing its job, not violating anything.
            last = autoscale[-1]
            out["autoscale"] = {
                "events": len(autoscale),
                "scale_ups": sum(r.get("action") == "scale_up"
                                 for r in autoscale),
                "scale_downs": sum(r.get("action") == "scale_down"
                                   for r in autoscale),
                "at_max": sum(r.get("action") == "at_max"
                              for r in autoscale),
                "last": last.get("action"),
                "replicas": last.get("replicas_to"),
                "last_reasons": last.get("reasons"),
            }
        planes = [r for r in recs if r.get("kind") == "data_plane"]
        faults = [r for r in recs if r.get("kind") == "data_fault"]
        quarantines = [r for r in recs
                       if r.get("kind") == "shard_quarantine"]
        if planes or faults or quarantines:
            # Unlike elastic/serve churn, a quarantine DOES gate the
            # verdict: a shard the data plane gave up on means rows were
            # dropped or a pass aborted. It clears only when a LATER
            # data_plane record shows a clean pass (fault null) — the
            # supervisor restarted and the plane recovered.
            last_q = max((i for i, r in enumerate(recs)
                          if r.get("kind") == "shard_quarantine"),
                         default=None)
            recovered = last_q is not None and any(
                r.get("kind") == "data_plane" and r.get("fault") is None
                for r in recs[last_q + 1:])
            last_plane = planes[-1] if planes else {}
            out["data_plane"] = {
                "engine": last_plane.get("engine"),
                "stall_frac": last_plane.get("stall_frac"),
                "faults": len(faults),
                "retried": sum(bool(r.get("recovered")) for r in faults),
                "quarantines": len(quarantines),
                "quarantined_shards": sorted({(r.get("split"), r.get("shard"))
                                              for r in quarantines},
                                             key=str),
                "last_fault": (faults[-1].get("error_class")
                               if faults else None),
                "recovered": recovered if quarantines else None,
            }
        traces = [r for r in recs if r.get("kind") == "serve_trace"]
        if traces:
            # Display-only request-latency breakdown: which PHASE the serve
            # path spends its tail in, with exemplar trace ids an operator
            # can paste into tools/request_report.py / the Perfetto view.
            from ..obs import reqtrace
            attr = reqtrace.attribute(traces)
            tail = attr.get("tail") or {}
            out["requests"] = {
                "traced": attr["requests"],
                "phases": {p: {"p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"]}
                           for p, s in (attr.get("phases") or {}).items()},
                "dominant_phase": tail.get("dominant_phase"),
                "tail_threshold_ms": tail.get("threshold_ms"),
                "exemplars": [e["trace_id"] for e in
                              (tail.get("exemplars") or {}).get(
                                  tail.get("dominant_phase"), [])],
            }
        soak = [r for r in recs if r.get("kind") == "soak_report"]
        if soak:
            out["soak_report"] = {k: soak[-1].get(k)
                                  for k in ("cycles", "ok", "faults",
                                            "recovered")}
        fleet_recs = [r for r in recs if r.get("kind") == "fleet_status"]
        if fleet_recs and out.get("fleet") is None:
            # A recorded snapshot's ages are as-of-WRITE: project them to
            # now, so a healthy-looking record from a dead run reads stale.
            rec = dict(fleet_recs[-1])
            offset = max(0.0, now - rec["ts"]) if "ts" in rec else 0.0
            if isinstance(rec.get("stalest_age_s"), (int, float)):
                rec["stalest_age_s"] = round(rec["stalest_age_s"] + offset, 3)
            rec["as_of_record"] = True
            out["fleet"] = rec
    if out.get("fleet") is None and not metrics:
        out["unreachable"] = True
        out["error"] = "no server URL, no readable artifacts"
    return out


def decide_exit(info: dict, stale_after_s: float) -> int:
    """The CI verdict (module docstring contract)."""
    if info.get("unreachable"):
        return EXIT_UNREACHABLE
    if info["source"] == "server":
        health = info.get("healthz") or {}
        slo = health.get("slo") or {}
        if health.get("status") == "critical":
            return EXIT_UNREACHABLE
        if slo.get("violations"):
            return EXIT_SLO
        hb = health.get("heartbeats") or {}
        age = hb.get("stalest_age_s")
        if age is not None and age > max(stale_after_s,
                                         hb.get("budget_s") or 0):
            return EXIT_UNREACHABLE
        return EXIT_SLO if health.get("status") != "ok" else EXIT_HEALTHY
    # files mode: a terminally-complete run is judged by its records; an
    # unterminated one by heartbeat AND stream freshness (a fleet snapshot
    # that looked healthy when written proves nothing hours later —
    # gather_files already projects recorded ages to now).
    if info.get("run_summary") is None:
        fleet = info.get("fleet")
        stream_age = info.get("last_record_age_s")
        if fleet is None and stream_age is None:
            return EXIT_UNREACHABLE
        if fleet is not None and fleet.get("stalest_age_s", 0) > stale_after_s:
            return EXIT_UNREACHABLE
        if stream_age is not None and stream_age > stale_after_s:
            return EXIT_UNREACHABLE
    if info.get("violations"):
        return EXIT_SLO
    if (info.get("lineage") or {}).get("unexplained"):
        # A recovered-within-contract lineage is healthy — that's the whole
        # point of elastic — but an attempt that exists with no supervisor
        # record explaining it means evidence was lost or something
        # relaunched outside the control plane: out of contract.
        return EXIT_SLO
    plane = info.get("data_plane")
    if plane and plane.get("quarantines") and not plane.get("recovered"):
        # A shard the data plane quarantined and never cleanly read past:
        # the stream's last word on storage is "rows missing or pass
        # aborted". Recovered-then-clean (a later fault-null data_plane
        # record) is healthy, same shape as the elastic lineage judgment.
        return EXIT_SLO
    return EXIT_HEALTHY


def _fmt(v, digits: int = 1) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{digits}f}"
    return str(v)


def render(info: dict) -> str:
    lines: list[str] = []
    if info.get("unreachable"):
        return f"unreachable: {info.get('error', 'no source')}"
    if info["source"] == "server":
        st = info.get("status") or {}
        h = info.get("healthz") or {}
        prog = (f"epoch {_fmt(st.get('epoch'))}/"
                f"{_fmt(st.get('total_epochs'))}"
                f"  step {_fmt(st.get('step'))}")
        lines.append(f"run: stage={st.get('stage') or '-'}"
                     + (f" seed={st['seed']}" if st.get("seed") is not None
                        else "")
                     + f"  {prog}"
                     f"  {_fmt(st.get('examples_per_s'))} ex/s"
                     + (f"  mfu {st['mfu']:.3f}" if st.get("mfu") else "")
                     + f"  eta {_fmt(st.get('eta_s'))}s")
        verdict = h.get("status", "?")
        reasons = "; ".join(h.get("reasons") or []) or "-"
        lines.append(f"health: {verdict}  ({reasons})")
        hb = h.get("heartbeats") or {}
        if hb.get("ranks"):
            lines.append(f"heartbeats: {hb['ranks']} rank(s), stalest "
                         f"rank{hb.get('stalest_rank')} "
                         f"{_fmt(hb.get('stalest_age_s'))}s "
                         f"(budget {_fmt(hb.get('budget_s'))}s)")
        slo = h.get("slo") or {}
        lines.append(f"slo: {slo.get('violations', 0)} violation(s)")
        for v in slo.get("recent") or []:
            lines.append(f"  [{v.get('slo')}] value {v.get('value')} vs "
                         f"threshold {v.get('threshold')}")
        return "\n".join(lines)
    # files mode
    ep = info.get("last_epoch")
    if ep:
        lines.append(f"last epoch record: epoch {ep.get('epoch')}  "
                     f"{_fmt(ep.get('examples_per_s'))} ex/s  "
                     f"loss {_fmt(ep.get('train_loss'), 4)}")
    rs = info.get("run_summary")
    lines.append("run: " + (f"COMPLETE (exit_class={rs.get('exit_class')}, "
                            f"wall {_fmt(rs.get('wall_s'))}s)" if rs
                            else "no terminal record (dead or still running)"))
    fleet = info.get("fleet")
    if fleet:
        lines.append(f"fleet: {fleet.get('n_ranks')} rank(s), stalest "
                     f"rank{fleet.get('stalest_rank')} "
                     f"{_fmt(fleet.get('stalest_age_s'))}s"
                     + (f"  STRAGGLER {fleet.get('straggler_reason')}"
                        if fleet.get("straggler_rank") is not None else ""))
    el = info.get("elastic")
    if el:
        lines.append(f"elastic: {el['events']} event(s) — "
                     f"{el['shrinks']} shrink / {el['grows']} grow / "
                     f"{el['restarts']} restart; last={el['last']} "
                     f"world={el['world']}")
    sf = info.get("serve_fleet")
    if sf:
        lines.append(f"serve fleet: {sf['events']} event(s) — "
                     f"{sf['deaths']} death(s) / {sf['wedged']} wedged / "
                     f"{sf['respawns']} respawn(s) / "
                     f"{sf.get('partitioned', 0)} partition(s) "
                     f"({sf.get('reconnected', 0)} reconnected); refreshes "
                     f"{sf['refreshes']} (+{sf['refresh_rejected']} "
                     f"rejected, {sf.get('refresh_rolled_back', 0)} rolled "
                     f"back) available={sf['available']} "
                     f"p95={_fmt(sf['p95_ms'])}ms")
    asc = info.get("autoscale")
    if asc:
        reasons = "; ".join(asc.get("last_reasons") or []) or "-"
        lines.append(f"autoscale: {asc['events']} decision(s) — "
                     f"{asc['scale_ups']} up / {asc['scale_downs']} down / "
                     f"{asc['at_max']} at-max; last={asc['last']} "
                     f"replicas={asc['replicas']} ({reasons})")
    lin = info.get("lineage")
    if lin:
        lines.append(f"lineage: {lin['attempts']} attempt(s), worlds "
                     f"{lin['worlds'] or '[?]'}, {lin['recoveries']} "
                     f"recovery(ies), lost wall {lin['lost_wall_s']}s")
        for u in lin["unexplained"]:
            lines.append(f"  UNEXPLAINED: {u}")
    dp = info.get("data_plane")
    if dp:
        q = dp.get("quarantines") or 0
        state = ("" if not q else
                 "  RECOVERED" if dp.get("recovered") else "  UNRECOVERED")
        lines.append(f"data plane: engine={dp.get('engine') or '-'} "
                     f"stall_frac={_fmt(dp.get('stall_frac'), 3)}  "
                     f"{dp['faults']} fault(s) ({dp['retried']} retried), "
                     f"{q} quarantine(s)"
                     + (f" shards={dp.get('quarantined_shards')}" if q else "")
                     + state)
    rq = info.get("requests")
    if rq:
        lines.append(f"requests: {rq['traced']} traced — dominant tail "
                     f"phase {rq.get('dominant_phase') or '-'}"
                     + (f" (>= {_fmt(rq.get('tail_threshold_ms'), 3)}ms)"
                        if rq.get("tail_threshold_ms") is not None else ""))
        for p, s in (rq.get("phases") or {}).items():
            lines.append(f"  {p:>14}: p50 {_fmt(s.get('p50_ms'), 3)}ms  "
                         f"p95 {_fmt(s.get('p95_ms'), 3)}ms")
        if rq.get("exemplars"):
            lines.append("  exemplars: "
                         + ", ".join(t[:12] for t in rq["exemplars"]))
    soak = info.get("soak_report")
    if soak:
        verdict = "ok" if soak.get("ok") else "NOT ok"
        lines.append(f"soak: {soak.get('recovered')}/{soak.get('cycles')} "
                     f"cycle(s) recovered ({verdict}) "
                     f"faults={soak.get('faults')}")
    viol = info.get("violations") or []
    lines.append(f"slo: {len(viol)} violation record(s)")
    for v in viol[-5:]:
        lines.append(f"  [{v.get('slo')}] value {v.get('value')} vs "
                     f"threshold {v.get('threshold')}")
    return "\n".join(lines)


def gather(args) -> dict:
    url = args.url or (f"http://{args.host}:{args.port}" if args.port
                       else None)
    info = gather_live(url, args.timeout) if url else None
    if info is not None and not info.get("unreachable"):
        return info
    if args.metrics or args.heartbeat_dir:
        files = gather_files(args.metrics, args.heartbeat_dir,
                             args.stale_after,
                             lineage=bool(getattr(args, "once", False)))
        if info is not None:
            files["server_error"] = info.get("error")
        return files
    return info if info is not None else {
        "source": "none", "unreachable": True,
        "error": "no --url/--port and no --metrics/--heartbeat-dir"}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Render a live (or post-mortem) view of a training run "
                    "from its obs status server, degrading to heartbeat/"
                    "metrics files")
    parser.add_argument("--url", default=None,
                        help="status-server base URL (http://host:port)")
    parser.add_argument("--port", type=int, default=None,
                        help="status-server port on --host")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--metrics", default=None,
                        help="metrics JSONL fallback for dead runs")
    parser.add_argument("--heartbeat-dir", default=None,
                        help="per-rank heartbeat directory fallback")
    parser.add_argument("--once", action="store_true",
                        help="one sample, then exit with the CI contract "
                             "(0 healthy / 1 SLO violated / 2 unreachable-"
                             "or-stale)")
    parser.add_argument("--json", action="store_true",
                        help="emit the gathered view as one JSON object")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="refresh cadence without --once")
    parser.add_argument("--timeout", type=float, default=2.0,
                        help="per-request HTTP timeout")
    parser.add_argument("--stale-after", type=float,
                        default=DEFAULT_STALE_AFTER_S,
                        help="heartbeat age past which an unterminated run "
                             "counts as dead (exit 2)")
    args = parser.parse_args(argv)

    while True:
        info = gather(args)
        code = decide_exit(info, args.stale_after)
        if args.json:
            info["exit_code"] = code
            print(json.dumps(info))
        else:
            print(render(info), flush=True)
        if args.once:
            return code
        try:
            time.sleep(args.interval)
            if not args.json:
                print("---", flush=True)
        except KeyboardInterrupt:
            return code


if __name__ == "__main__":
    raise SystemExit(main())
