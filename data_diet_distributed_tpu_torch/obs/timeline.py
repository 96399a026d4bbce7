"""Cross-attempt timeline (counterpart of ``data_diet_distributed_tpu/obs/timeline.py``):
merge one supervised run's artifacts into one story in time order, and name
every recovery's chain.

Under the elastic supervisor (``resilience/elastic.py``) "the run" spans
attempts: the metrics stream interleaves the supervisor's records and every
attempt's workers', the flight-recorder dumps and traces are files per
(attempt, rank), a departed rank's heartbeat lives on as archived residue,
and the stage and tier manifests record what survived. This module joins
them on the lineage stamps (``obs/lineage.py``) into:

* a **timeline**: every event of every source, sorted by wall clock, tagged
  with its source, attempt and rank;
* **recovery chains**: for every attempt transition, the triggering fault ->
  dead and reaped ranks -> the shrink / grow / restart decision -> the
  resume step and the world that saved it -> the first training step after
  it, with the recovery wall (classification to training again) from the
  records; in-process recoveries (NaN rollback, watchdog retry) chain the
  same way from their ``recovery`` records;
* a **lineage view**: attempts, worlds, recoveries, unexplained attempt
  gaps, lost wall, the dict ``obs/postmortem.py`` judges.

The record kinds and fields are the JAX package's, so these functions give
its answers on the same records. File reading only (no torch): it runs over
the artifacts of a run that is long dead.
"""

from __future__ import annotations

import glob
import json
import os

from . import flightrec as obs_flightrec
from . import heartbeat as obs_heartbeat
from . import reqtrace as obs_reqtrace
from . import tracing as obs_tracing

__all__ = ["read_records", "discover_artifacts", "build_timeline",
           "recoveries", "lineage_view", "merge_perfetto",
           "TRAINING_KINDS", "FAULT_KINDS"]

#: Record kinds that prove an attempt was TRAINING again — the end of a
#: recovery wall ("time to training again", not "time to process up").
TRAINING_KINDS = ("train_chunked", "train_step", "epoch")

#: Record kinds that name the failure a recovery recovered from.
FAULT_KINDS = ("fault", "preempted")


def _is_fault_evidence(rec: dict) -> bool:
    """Does this record name a failure? ``fault``/``preempted`` always; a
    ``consensus`` record only when it carries the poison verdict — on a
    host KILL the survivors' watchdog→poison escalation is often the only
    failure record the stream gets (the dead rank wrote nothing, and the
    bounded multi-host exit skips the in-process fault log)."""
    kind = rec.get("kind")
    if kind in FAULT_KINDS:
        return True
    return (kind == "consensus"
            and rec.get("event") in ("poison", "peer_poisoned"))

#: Supervisor decisions that explain why the next attempt exists.
DECISION_EVENTS = ("shrink", "grow", "resize", "restart")


def read_records(path: str) -> list[dict]:
    """The metrics stream, tolerantly: non-JSON/partial lines skipped (every
    stream consumer tolerates the killed-mid-write tail)."""
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
                if isinstance(rec, dict):
                    records.append(rec)
    except OSError:
        return []
    return records


# ------------------------------------------------------------- discovery

def discover_artifacts(metrics_path: str, *, workdir: str | None = None,
                       checkpoint_dir: str | None = None,
                       heartbeat_dir: str | None = None,
                       trace_base: str | None = None,
                       flightrec_dir: str | None = None) -> dict:
    """Locate every artifact of the run behind ``metrics_path`` by the
    port's path conventions (trace/flightrec next to the metrics JSONL,
    ``<ckpt>_stages.json`` / ``<ckpt>_heartbeats`` / ``<ckpt>_tiered``
    siblings of the checkpoint dir — discovered by globbing the workdir
    when not given). Returns a dict of what EXISTS; every key may be empty —
    a postmortem must work from whatever the crash left behind."""
    workdir = workdir or os.path.dirname(os.path.abspath(metrics_path)) or "."
    if checkpoint_dir is None:
        manifests = sorted(glob.glob(os.path.join(glob.escape(workdir),
                                                  "*_stages.json")))
        if manifests:
            checkpoint_dir = manifests[0][: -len("_stages.json")]
    if checkpoint_dir is None:
        # A plain `train` run writes no stage manifest — fall back to the
        # other sibling-dir conventions (elastic control plane, tier,
        # heartbeats, poison side-channel), any of which names the
        # checkpoint dir by prefix.
        for suffix in ("_elastic", "_tiered", "_heartbeats", "_sidechannel"):
            hits = sorted(p for p in glob.glob(os.path.join(
                glob.escape(workdir), f"*{suffix}")) if os.path.isdir(p))
            if hits:
                checkpoint_dir = hits[0][: -len(suffix)]
                break
    if heartbeat_dir is None and checkpoint_dir:
        candidate = f"{checkpoint_dir}_heartbeats"
        if os.path.isdir(candidate):
            heartbeat_dir = candidate
    out: dict = {
        "metrics_path": metrics_path,
        "workdir": workdir,
        "checkpoint_dir": checkpoint_dir,
        "records": read_records(metrics_path),
        # A run configured with obs.flightrec_dir dumps outside the workdir
        # — without the override the postmortem would silently lose every
        # ring (and with it the trigger fallback for rank-0-gated streams).
        "flightrec": obs_flightrec.read_dumps(flightrec_dir or workdir),
        "heartbeats": (obs_heartbeat.read_heartbeats(heartbeat_dir)
                       if heartbeat_dir else {}),
        "heartbeat_residue": (obs_heartbeat.read_heartbeat_residue(
            heartbeat_dir) if heartbeat_dir else []),
        "traces": obs_tracing.discover_traces(
            trace_base or os.path.join(workdir, "trace.json")),
        "stages": {},
        "tier_steps": [],
    }
    if checkpoint_dir:
        try:
            with open(f"{checkpoint_dir}_stages.json") as fh:
                manifest = json.load(fh)
            if isinstance(manifest, dict):
                out["stages"] = manifest.get("stages") or {}
        except (OSError, ValueError):
            pass
        for sdir in sorted(glob.glob(os.path.join(
                glob.escape(f"{checkpoint_dir}_tiered"), "step_*"))):
            # Durable-tier layout: per-rank manifests (rank<k>.manifest.json)
            # — any one names the step and the world that WROTE it, the
            # number an elastic restore's saved_world is checked against.
            ranks = sorted(glob.glob(os.path.join(glob.escape(sdir),
                                                  "rank*.manifest.json")))
            if not ranks:
                continue
            try:
                with open(ranks[0]) as fh:
                    m = json.load(fh)
                out["tier_steps"].append({"step": m.get("step"),
                                          "world": m.get("world"),
                                          "ranks_present": len(ranks)})
            except (OSError, ValueError):
                continue
        out["tier_steps"].sort(key=lambda t: t.get("step") or 0)
    return out


# --------------------------------------------------------------- timeline

def build_timeline(artifacts: dict) -> list[dict]:
    """Every timestamped event from every source, as ``{"ts", "source",
    "kind", "attempt", "rank", ...summary fields}``, sorted by wall clock.
    Flight-recorder rings repeat events the stream also has (rank 0 mirrors
    them); they are kept, tagged by source, because the other ranks' rings
    are the only record of their final moments."""
    events: list[dict] = []
    for rec in artifacts.get("records") or []:
        if not isinstance(rec.get("ts"), (int, float)):
            continue
        events.append({"ts": rec["ts"], "source": "metrics",
                       "kind": rec.get("kind"),
                       "attempt": rec.get("attempt"),
                       "rank": 0,
                       **{k: rec[k] for k in ("event", "fault", "stage",
                                              "status", "step", "epoch",
                                              "world", "saved_world", "slo",
                                              "signal", "cause", "exit_class",
                                              "replica", "action")
                          if k in rec}})
    for dumped in artifacts.get("flightrec") or []:
        rank, attempt = dumped.get("rank"), dumped.get("attempt")
        for ev in dumped.get("events") or []:
            if not isinstance(ev.get("ts"), (int, float)):
                continue
            events.append({"ts": ev["ts"], "source": f"flightrec_rank{rank}",
                           "kind": ev.get("kind"), "attempt": attempt,
                           "rank": rank,
                           **{k: ev[k] for k in ("event", "fault", "step",
                                                 "epoch", "signal")
                              if k in ev}})
    for rec in artifacts.get("heartbeat_residue") or []:
        if isinstance(rec.get("ts"), (int, float)):
            events.append({"ts": rec["ts"], "source": "heartbeat_residue",
                           "kind": "last_heartbeat",
                           "attempt": rec.get("attempt"),
                           "rank": rec.get("rank"),
                           **{k: rec[k] for k in ("step", "epoch", "stage")
                              if k in rec}})
    events.sort(key=lambda e: e["ts"])
    return events


# ------------------------------------------------------- recovery chains

def _supervisor_events(records: list[dict]) -> list[dict]:
    return [r for r in records if r.get("kind") == "elastic_event"]


def _first_training_ts(records: list[dict], attempt: int) -> float | None:
    for rec in records:
        if (rec.get("kind") in TRAINING_KINDS
                and rec.get("attempt") == attempt
                and isinstance(rec.get("ts"), (int, float))):
            return rec["ts"]
    return None


def recoveries(records: list[dict]) -> list[dict]:
    """Every recovery's named chain, in order.

    Supervisor relaunches (one chain per ``launch`` with attempt > 0):
    classification (``children_exited``) → decision (shrink/grow/resize/
    restart, with dead/reaped ranks and the new world) → the triggering
    fault record → the new attempt's ``resume`` (step, world, saved_world)
    → its first training record. ``recovery_wall_s`` is classification →
    training-again: the whole relaunch+restore+compile path, from record
    timestamps alone. In-process recoveries (``recovery`` records: NaN
    rollback, watchdog/step-exception retry) chain the same way within
    their attempt."""
    chains: list[dict] = []
    sup = _supervisor_events(records)
    launches = [r for r in sup if r.get("event") == "launch"]
    for launch in launches:
        attempt = launch.get("attempt")
        if not attempt:   # attempt 0 is the original launch, not a recovery
            continue
        prev = [r for r in sup
                if isinstance(r.get("attempt"), int)
                and r["attempt"] < attempt]
        classification = next(
            (r for r in reversed(prev) if r.get("event") == "children_exited"),
            None)
        decision = next(
            (r for r in reversed(prev) if r.get("event") in DECISION_EVENTS),
            None)
        from_attempt = (classification or decision or {}).get("attempt",
                                                              attempt - 1)
        # The fault the classification observed: the last fault-class record
        # (any rank, any kind) OF THE DYING ATTEMPT before the
        # classification's timestamp. The attempt filter matters: a fault an
        # older attempt logged would otherwise be misattributed here — and,
        # worse, its presence would suppress the flightrec fallback that
        # holds the real attempt's evidence.
        trigger = None
        if classification is not None:
            before = [r for r in records
                      if _is_fault_evidence(r)
                      and (r.get("attempt") or 0) == from_attempt
                      and isinstance(r.get("ts"), (int, float))
                      and r["ts"] <= classification["ts"]]
            trigger = before[-1] if before else None
        resume = next((r for r in records
                       if r.get("kind") == "resume"
                       and r.get("attempt") == attempt), None)
        trained_ts = _first_training_ts(records, attempt)
        anchor_ts = (classification or decision or launch).get("ts")
        chain: dict = {
            "type": "relaunch",
            "from_attempt": from_attempt,
            "to_attempt": attempt,
            "action": (decision or {}).get("event")
                      or (classification or {}).get("action"),
            "dead_ranks": (decision or {}).get("dead_ranks"),
            "reaped_ranks": (decision or {}).get("reaped_ranks"),
            "world": launch.get("world"),
            "new_world": (decision or {}).get("new_world"),
            "trigger": ({"kind": trigger.get("kind"),
                         "fault": trigger.get("fault"),
                         "event": trigger.get("event"),
                         "signal": trigger.get("signal"),
                         "rank": trigger.get("rank"),
                         "ts": trigger.get("ts")}
                        if trigger is not None else None),
            "classified_ts": (classification or {}).get("ts"),
            "resume_step": (resume or {}).get("step"),
            "saved_world": (resume or {}).get("saved_world"),
            "trained_ts": trained_ts,
            "recovery_wall_s": (round(trained_ts - anchor_ts, 3)
                                if trained_ts is not None
                                and isinstance(anchor_ts, (int, float))
                                else None),
            # A requested grow/resize is an attempt transition worth naming,
            # but NOT a failure recovery — the supervisor's lineage_block
            # excludes it from its recovery count and lost wall, and the
            # judgments here must agree with that terminal record.
            "requested": (decision or {}).get("event") in ("grow", "resize"),
            "explained": classification is not None,
        }
        chains.append(chain)
    for rec in records:
        if rec.get("kind") != "recovery":
            continue
        attempt = rec.get("attempt") or 0
        before = [r for r in records
                  if _is_fault_evidence(r)
                  and (r.get("attempt") or 0) == attempt
                  and isinstance(r.get("ts"), (int, float))
                  and isinstance(rec.get("ts"), (int, float))
                  and r["ts"] <= rec["ts"]]
        trigger = before[-1] if before else None
        after_train = next(
            (r["ts"] for r in records
             if r.get("kind") in TRAINING_KINDS
             and (r.get("attempt") or 0) == attempt
             and isinstance(r.get("ts"), (int, float))
             and isinstance(rec.get("ts"), (int, float))
             and r["ts"] >= rec["ts"]), None)
        anchor_ts = (trigger or rec).get("ts")
        chains.append({
            "type": "in_process",
            "from_attempt": attempt, "to_attempt": attempt,
            "action": rec.get("cause"),
            "trigger": ({"kind": trigger.get("kind"),
                         "fault": trigger.get("fault"),
                         "ts": trigger.get("ts")}
                        if trigger is not None else None),
            "classified_ts": rec.get("ts"),
            "resume_step": rec.get("resume_step"),
            "trained_ts": after_train,
            "recovery_wall_s": (round(after_train - anchor_ts, 3)
                                if after_train is not None
                                and isinstance(anchor_ts, (int, float))
                                else None),
            "explained": True,   # the recovery record IS the explanation
        })
    chains.sort(key=lambda c: c.get("classified_ts") or 0.0)
    return chains


def attach_flightrec_triggers(chains: list[dict],
                              dumps: list[dict]) -> list[dict]:
    """Fill a relaunch chain's missing trigger from the flight-recorder
    dumps: the metrics stream is rank 0's, and the CLI's bounded exit under a
    process group (``os._exit`` after a torn collective) skips the fault log,
    but each rank's ring was dumped on the way down, and the dump's reason
    and last fault event name what happened. In place; returns the chains."""
    for c in chains:
        if c.get("trigger") is not None or c.get("type") != "relaunch":
            continue
        for d in dumps:
            if (d.get("attempt") or 0) != c.get("from_attempt"):
                continue
            faults = [e for e in (d.get("events") or [])
                      if e.get("kind") in FAULT_KINDS]
            ev = faults[-1] if faults else {}
            c["trigger"] = {"kind": "flightrec", "rank": d.get("rank"),
                            "reason": d.get("reason"),
                            "fault": ev.get("fault"),
                            "signal": ev.get("signal"),
                            "ts": ev.get("ts") or d.get("dumped_ts")}
            break
    return chains


def lineage_view(records: list[dict]) -> dict | None:
    """The whole-lineage judgment over one metrics stream: which attempts
    left records, at which worlds, every recovery chain, and — the CI-facing
    part — the UNEXPLAINED attempt gaps: an attempt that wrote records with
    no supervisor ``launch`` naming it, or a relaunch whose predecessor was
    never classified. None when the stream carries no lineage at all (a
    pre-lineage stream: nothing to judge, nothing to flag)."""
    stamped = [r for r in records if isinstance(r.get("attempt"), int)]
    if not stamped:
        return None
    attempts = sorted({r["attempt"] for r in stamped})
    run_ids = sorted({r["run_id"] for r in records
                      if isinstance(r.get("run_id"), str)})
    sup = _supervisor_events(records)
    launched = {r.get("attempt") for r in sup if r.get("event") == "launch"}
    classified = {r.get("attempt") for r in sup
                  if r.get("event") == "children_exited"}
    chains = recoveries(records)
    unexplained: list[str] = []
    # Worker records from an attempt the supervisor never launched: either
    # records were lost, or something relaunched outside the control plane.
    worker_attempts = sorted({r["attempt"] for r in stamped
                              if r.get("kind") != "elastic_event"})
    for t in worker_attempts:
        if t > 0 and launched and t not in launched:
            unexplained.append(f"attempt {t} has records but no supervisor "
                               "launch event")
        if t > 0 and not launched:
            unexplained.append(f"attempt {t} has records but the stream has "
                               "no supervisor events at all")
    for t in sorted(launched):
        if t and t - 1 in launched and t - 1 not in classified:
            unexplained.append(f"attempt {t} was launched but attempt "
                               f"{t - 1} was never classified")
    # Non-contiguous attempts: evidence went missing in between.
    for a, b in zip(attempts, attempts[1:]):
        if b - a > 1:
            unexplained.append(f"attempt gap: {a} -> {b} with no records "
                               "in between")
    worlds: list[int] = []
    for r in sup:
        if r.get("event") == "launch" and isinstance(r.get("world"), int):
            worlds.append(r["world"])
    lost = [c["recovery_wall_s"] for c in chains
            if isinstance(c.get("recovery_wall_s"), (int, float))
            and not c.get("requested")]
    terminal = next((r for r in reversed(records)
                     if r.get("kind") == "run_summary"), None)
    return {
        "run_ids": run_ids,
        "attempts": len(attempts),
        "attempt_ids": attempts,
        "worlds": worlds,
        "recoveries": chains,
        "unexplained": unexplained,
        "lost_wall_s": round(sum(lost), 3) if lost else 0.0,
        "slo_violations": sum(r.get("kind") == "slo_violation"
                              for r in records),
        "terminal": ({"exit_class": terminal.get("exit_class"),
                      "attempt": terminal.get("attempt")}
                     if terminal is not None else None),
    }


# ------------------------------------------------------- merged Perfetto

def merge_perfetto(traces: list[dict], out_path: str,
                   records: list[dict] | None = None) -> dict:
    """One Perfetto/Chrome trace for the WHOLE run: each per-(attempt, rank)
    trace file the port writes (``obs/tracing.py``) becomes its own lane
    (pid remapped; named ``attempt<k>/rank<r>``), and the metrics stream's
    fault / elastic / resume records become instant markers on the matching
    attempt's rank-0 lane — the flame chart and the fault story in one
    viewer. ``serve_trace`` records additionally stitch into one lane PER REQUEST
    (keyed by trace id): the router's admission/routing/proxy spans and
    each replica's queue/coalesce/dispatch/fetch/serialize spans, from
    whichever processes emitted them, laid out on the request's own wall
    interval — with hedged / retried / replayed / failed requests marked
    in the lane name and as instant events. Returns
    ``{"events", "lanes", "request_lanes"}`` counts."""
    merged: list[dict] = []
    lane_of: dict[tuple[int, int], int] = {}
    req_lane_of: dict[str, int] = {}

    def lane(attempt: int, rank: int) -> int:
        key = (int(attempt or 0), int(rank or 0))
        if key not in lane_of:
            pid = 1_000_000 + len(lane_of)
            lane_of[key] = pid
            merged.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0,
                           "args": {"name": f"attempt{key[0]}/rank{key[1]}"}})
            merged.append({"ph": "M", "name": "process_sort_index",
                           "pid": pid, "tid": 0,
                           "args": {"sort_index": key[0] * 1000 + key[1]}})
        return lane_of[key]

    for row in traces:
        pid = lane(row["attempt"], row["rank"])
        for ev in obs_tracing.read_trace(row["path"]):
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue   # lane names are ours now
            ev = dict(ev, pid=pid)
            merged.append(ev)
    marker_kinds = {"fault", "preempted", "resume", "recovery",
                    "elastic_event", "slo_violation", "autoscale_event"}
    for rec in records or []:
        if rec.get("kind") not in marker_kinds:
            continue
        if not isinstance(rec.get("ts"), (int, float)):
            continue
        name = rec["kind"]
        if rec.get("fault"):
            name = f"fault:{rec['fault']}"
        elif rec.get("event"):
            name = f"elastic:{rec['event']}"
        elif rec.get("slo"):
            name = f"slo:{rec['slo']}"
        merged.append({
            "ph": "i", "s": "g", "name": name, "cat": "lineage",
            "ts": round(rec["ts"] * 1e6, 1),
            "pid": lane(rec.get("attempt") or 0, 0), "tid": 0,
            "args": {k: v for k, v in rec.items()
                     if k not in ("kind", "ts")
                     and isinstance(v, (str, int, float, bool))},
        })
    _merge_request_lanes(merged, req_lane_of, records or [])
    d = os.path.dirname(os.path.abspath(out_path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(merged, fh)
    return {"events": len(merged), "lanes": len(lane_of),
            "request_lanes": len(req_lane_of)}


def _merge_request_lanes(merged: list[dict], req_lane_of: dict[str, int],
                         records: list[dict]) -> None:
    """Stitch every kept ``serve_trace`` record into one Perfetto lane per
    trace id: the router's spans on tid 0, each replica's on its own tid,
    laid sequentially over the record's own wall interval (emission ``ts``
    minus ``wall_ms``). Hedged / retried / replayed / failed requests are
    marked both in the lane name and as instant events, so the tail is
    findable by eye in a fleet-sized merge."""
    by_trace: dict[str, list[dict]] = {}
    for rec in records:
        if rec.get("kind") != "serve_trace":
            continue
        tid = rec.get("trace_id")
        if isinstance(tid, str) and isinstance(rec.get("ts"), (int, float)):
            by_trace.setdefault(tid, []).append(rec)
    for n, (trace_id, recs) in enumerate(sorted(by_trace.items())):
        pid = 2_000_000 + n
        req_lane_of[trace_id] = pid
        marks = sorted({m for r in recs for m in (
            ("hedged",) if r.get("hedged") else ())
            + (("retried",) if r.get("retries") else ())
            + (("replay",) if r.get("replay") else ())
            + (("failed",) if (r.get("status") or 0) >= 400 else ())})
        suffix = f" [{','.join(marks)}]" if marks else ""
        merged.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"request {trace_id[:12]}{suffix}"}})
        merged.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                       "tid": 0, "args": {"sort_index": pid}})
        for rec in sorted(recs, key=lambda r: 0 if r.get("where") == "router"
                          else 1):
            where = rec.get("where") or "?"
            tid = 0 if where == "router" else 1 + int(rec.get("replica") or 0)
            tname = where if where == "router" \
                else f"replica{rec.get('replica')}"
            merged.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
            wall_ms = float(rec.get("wall_ms") or 0.0)
            cursor_us = (rec["ts"] - wall_ms / 1e3) * 1e6
            order = obs_reqtrace.ROUTER_PHASES if where == "router" \
                else obs_reqtrace.REPLICA_PHASES
            phases = rec.get("phases") or {}
            for phase in order:
                ms = phases.get(phase)
                if not ms:
                    continue
                merged.append({"ph": "X", "name": phase, "cat": "serve_trace",
                               "ts": round(cursor_us, 1),
                               "dur": round(float(ms) * 1e3, 1),
                               "pid": pid, "tid": tid,
                               "args": {"trace_id": trace_id,
                                        "status": rec.get("status"),
                                        "replica": rec.get("replica")}})
                cursor_us += float(ms) * 1e3
            for mark in marks if where == "router" else ():
                merged.append({"ph": "i", "s": "p", "name": mark,
                               "cat": "serve_trace",
                               "ts": round(rec["ts"] * 1e6, 1),
                               "pid": pid, "tid": tid,
                               "args": {"trace_id": trace_id}})
            for a in rec.get("attempts") or []:
                if not isinstance(a, dict):
                    continue
                merged.append({"ph": "i", "s": "t",
                               "name": f"attempt:replica{a.get('replica')}:"
                                       f"{a.get('outcome')}",
                               "cat": "serve_trace",
                               "ts": round(rec["ts"] * 1e6, 1),
                               "pid": pid, "tid": tid,
                               "args": {k: v for k, v in a.items()
                                        if isinstance(v, (str, int, float,
                                                          bool))}})
