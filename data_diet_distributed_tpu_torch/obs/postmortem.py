"""Post-mortem of a run from its files (counterpart of ``tools/postmortem.py``,
over the port's own artifacts; it imports no JAX and no torch).

It merges the run directory's artifacts (the lineage-stamped metrics stream,
the flight-recorder dumps and traces per (attempt, rank), the archived
heartbeats of departed ranks, the stage and tier manifests) into a timeline
(``obs/timeline.py``), names every recovery's chain (triggering fault ->
dead and reaped ranks -> shrink / grow decision -> resume step and the
world that saved it -> time to training again), and prints a report, a
``--json`` record, and on request a merged Perfetto trace with one lane per
(attempt, rank)::

    python -m data_diet_distributed_tpu_torch.obs.postmortem <workdir>
    python -m data_diet_distributed_tpu_torch.obs.postmortem run/metrics.jsonl --json
    python -m data_diet_distributed_tpu_torch.obs.postmortem run/ --perfetto run/merged.json
    python -m data_diet_distributed_tpu_torch.obs.postmortem run/ --recovery-budget-s 30

Exit codes::

    0  clean: every attempt transition is explained by the supervisor's
       records, no SLO violation, every recovery within --recovery-budget-s
       (when given), and the run reached a terminal ok/preempted summary
    1  an unexplained recovery or an SLO violation: an attempt gap with no
       launch or classification explaining it, slo_violation records, a
       recovery wall over budget, or a run that never terminated cleanly
    2  unreadable: no parseable records at the given path

The ``--json`` line is a ``{"kind": "postmortem_report"}`` record, the one
``tools/validate_metrics.py`` knows.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from . import reqtrace, timeline

EXIT_CLEAN, EXIT_SUSPECT, EXIT_UNREADABLE = 0, 1, 2


def build_report(artifacts: dict, *,
                 recovery_budget_s: float | None = None) -> dict:
    """The postmortem verdict over discovered artifacts: the lineage view
    plus the judgment fields (``problems`` naming everything that keeps the
    run from "clean", ``ok``, ``exit_code``)."""
    records = artifacts.get("records") or []
    view = timeline.lineage_view(records)
    report: dict = {"kind": "postmortem_report",
                    "ts": round(time.time(), 3),
                    "metrics_path": artifacts.get("metrics_path")}
    if not records:
        report.update(attempts=0, recoveries=[], unexplained=[],
                      problems=["no readable records"], ok=False,
                      exit_code=EXIT_UNREADABLE)
        return report
    problems: list[str] = []
    if view is not None:
        # A chain whose trigger the (rank-0-gated) stream never recorded:
        # the flight-recorder dumps are the other ranks' only testimony.
        timeline.attach_flightrec_triggers(view["recoveries"],
                                           artifacts.get("flightrec") or [])
    if view is None:
        # Pre-lineage stream: records exist but carry no attempt stamps —
        # readable, judgeable only as a single anonymous attempt.
        view = {"run_ids": [], "attempts": 1, "attempt_ids": [0],
                "worlds": [], "recoveries": [], "unexplained": [],
                "lost_wall_s": 0.0,
                "slo_violations": sum(r.get("kind") == "slo_violation"
                                      for r in records),
                "terminal": None}
        terminal = next((r for r in reversed(records)
                         if r.get("kind") == "run_summary"), None)
        if terminal is not None:
            view["terminal"] = {"exit_class": terminal.get("exit_class"),
                                "attempt": None}
    report.update(run_id=(view["run_ids"][0] if view["run_ids"] else None),
                  attempts=view["attempts"],
                  attempt_ids=view["attempt_ids"],
                  worlds=view["worlds"],
                  recoveries=view["recoveries"],
                  unexplained=view["unexplained"],
                  lost_wall_s=view["lost_wall_s"],
                  slo_violations=view["slo_violations"],
                  terminal=view["terminal"],
                  n_flightrec_dumps=len(artifacts.get("flightrec") or []),
                  n_traces=len(artifacts.get("traces") or []),
                  heartbeat_residue=[
                      {k: r.get(k) for k in ("rank", "attempt", "step",
                                             "epoch", "stage")}
                      for r in artifacts.get("heartbeat_residue") or []],
                  tier_steps=artifacts.get("tier_steps") or [])
    traces = [r for r in records if r.get("kind") == "serve_trace"]
    if traces:
        # Request-latency breakdown over the run's serve_trace records —
        # which phase the tail lived in, with exemplar trace ids. Display
        # evidence, never a problem: slow requests already surface as
        # slo_violation records when out of contract.
        attr = reqtrace.attribute(traces)
        tail = attr.get("tail") or {}
        report["requests"] = {
            "traced": attr["requests"],
            "phases": {p: {"p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"]}
                       for p, s in (attr.get("phases") or {}).items()},
            "dominant_phase": tail.get("dominant_phase"),
            "tail_threshold_ms": tail.get("threshold_ms"),
            "exemplars": [e["trace_id"] for e in
                          (tail.get("exemplars") or {}).get(
                              tail.get("dominant_phase"), [])],
        }
    problems += [f"unexplained: {u}" for u in view["unexplained"]]
    if view["slo_violations"]:
        problems.append(f"{view['slo_violations']} slo_violation record(s)")
    if recovery_budget_s is not None:
        for c in view["recoveries"]:
            if c.get("requested"):
                # An operator-requested grow/resize is not a failure
                # recovery — the budget judges recoveries only (same
                # exclusion as lineage_view's lost_wall_s).
                continue
            wall = c.get("recovery_wall_s")
            if wall is not None and wall > recovery_budget_s:
                problems.append(
                    f"recovery to attempt {c['to_attempt']} took {wall}s "
                    f"(> budget {recovery_budget_s}s)")
            if wall is None and c.get("type") == "relaunch":
                problems.append(
                    f"recovery to attempt {c['to_attempt']} never reached a "
                    "training step (wall unmeasurable)")
    terminal = view["terminal"]
    if terminal is None:
        problems.append("no terminal run_summary (crashed, killed, or "
                        "still running)")
    elif terminal.get("exit_class") not in ("ok", "preempted"):
        problems.append(f"terminal exit_class {terminal.get('exit_class')!r}")
    report["recovery_budget_s"] = recovery_budget_s
    report["problems"] = problems
    report["ok"] = not problems
    report["exit_code"] = EXIT_CLEAN if not problems else EXIT_SUSPECT
    return report


def _fmt_ranks(ranks) -> str:
    return str(ranks) if ranks else "[]"


def render(report: dict, timeline_events: list[dict] | None = None,
           tail: int = 0) -> str:
    if report["exit_code"] == EXIT_UNREADABLE:
        return (f"postmortem: UNREADABLE — {report['problems'][0]} at "
                f"{report.get('metrics_path')}")
    lines = [f"postmortem: run {report.get('run_id') or '<unstamped>'} — "
             f"{report['attempts']} attempt(s), worlds "
             f"{report.get('worlds') or '[?]'}, "
             f"{len(report['recoveries'])} recovery(ies), "
             f"lost wall {report.get('lost_wall_s', 0.0)}s"]
    for i, c in enumerate(report["recoveries"]):
        if c["type"] == "relaunch":
            lines.append(f"recovery {i + 1}: attempt {c['from_attempt']} -> "
                         f"{c['to_attempt']} ({c.get('action') or '?'})"
                         + (" [requested]" if c.get("requested") else ""))
            trig = c.get("trigger")
            if trig:
                what = (trig.get("fault") or trig.get("signal")
                        or trig.get("event") or trig.get("reason")
                        or trig["kind"])
                who = (f" (rank {trig['rank']})"
                       if trig.get("rank") is not None else "")
                via = (" [flightrec]" if trig.get("kind") == "flightrec"
                       else "")
                lines.append(f"  fault: {what}{who}{via}")
            if c.get("dead_ranks") is not None:
                lines.append(f"  dead ranks {_fmt_ranks(c['dead_ranks'])}, "
                             f"reaped {_fmt_ranks(c.get('reaped_ranks'))}, "
                             f"world -> {c.get('new_world')}")
            if c.get("resume_step") is not None:
                lines.append(f"  resume: step {c['resume_step']} "
                             f"(saved_world={c.get('saved_world')} -> "
                             f"world {c.get('world')})")
            lines.append("  training again: "
                         + (f"+{c['recovery_wall_s']}s after classification"
                            if c.get("recovery_wall_s") is not None
                            else "NEVER"))
        else:
            lines.append(f"recovery {i + 1}: in-process "
                         f"({c.get('action') or '?'}) in attempt "
                         f"{c['from_attempt']}"
                         + (f", training again +{c['recovery_wall_s']}s"
                            if c.get("recovery_wall_s") is not None else ""))
    for r in report.get("heartbeat_residue") or []:
        lines.append(f"residue: rank {r.get('rank')} last heartbeat in "
                     f"attempt {r.get('attempt')} at step {r.get('step')} "
                     f"(stage {r.get('stage')})")
    rq = report.get("requests")
    if rq:
        lines.append(f"requests: {rq['traced']} traced — dominant tail "
                     f"phase {rq.get('dominant_phase') or '-'}")
        for p, s in (rq.get("phases") or {}).items():
            lines.append(f"  {p:>14}: p50 {s.get('p50_ms')}ms  "
                         f"p95 {s.get('p95_ms')}ms")
        if rq.get("exemplars"):
            lines.append("  exemplars: "
                         + ", ".join(t[:12] for t in rq["exemplars"]))
    lines.append(f"slo: {report.get('slo_violations', 0)} violation "
                 "record(s)")
    term = report.get("terminal")
    lines.append("terminal: "
                 + (f"exit_class={term['exit_class']} "
                    f"(attempt {term.get('attempt')})" if term else "MISSING"))
    if timeline_events and tail:
        lines.append(f"timeline (last {tail} of {len(timeline_events)} "
                     "events):")
        for ev in timeline_events[-tail:]:
            what = (ev.get("fault") or ev.get("event") or ev.get("status")
                    or ev.get("kind"))
            where = f"a{ev.get('attempt')}/r{ev.get('rank')}"
            lines.append(f"  {ev['ts']:.3f} [{ev['source']}] {where} {what}")
    verdict = ("clean" if report["ok"]
               else "; ".join(report["problems"]))
    lines.append(f"verdict: {verdict} (exit {report['exit_code']})")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m data_diet_distributed_tpu_torch.obs.postmortem",
        description="Reconstruct what a supervised run did, across every "
                    "attempt, from its on-disk artifacts")
    parser.add_argument("path", help="run workdir (metrics.jsonl inside) or "
                                     "the metrics JSONL itself")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="checkpoint dir (default: discovered from the "
                             "workdir's *_stages.json)")
    parser.add_argument("--heartbeat-dir", default=None,
                        help="heartbeat dir (default: "
                             "<checkpoint_dir>_heartbeats when present)")
    parser.add_argument("--trace", default=None,
                        help="trace base path (default: <workdir>/trace.json;"
                             " per-attempt/rank variants are discovered)")
    parser.add_argument("--flightrec-dir", default=None,
                        help="flight-recorder dump dir (default: the "
                             "workdir; set when the run used "
                             "obs.flightrec_dir)")
    parser.add_argument("--recovery-budget-s", type=float, default=None,
                        help="recovery SLO: classification -> first training "
                             "step must beat this (exit 1 past it)")
    parser.add_argument("--perfetto", default=None,
                        help="write the merged Perfetto trace (one lane per "
                             "(attempt, rank), fault/elastic markers) here")
    parser.add_argument("--timeline", type=int, default=0, metavar="N",
                        help="print the last N merged timeline events")
    parser.add_argument("--json", action="store_true",
                        help="emit the postmortem_report record as one JSON "
                             "line instead of the terminal rendering")
    args = parser.parse_args(argv)

    metrics = (os.path.join(args.path, "metrics.jsonl")
               if os.path.isdir(args.path) else args.path)
    artifacts = timeline.discover_artifacts(
        metrics, checkpoint_dir=args.checkpoint_dir,
        heartbeat_dir=args.heartbeat_dir, trace_base=args.trace,
        flightrec_dir=args.flightrec_dir)
    report = build_report(artifacts,
                          recovery_budget_s=args.recovery_budget_s)
    events = timeline.build_timeline(artifacts) if args.timeline else None
    if args.perfetto and report["exit_code"] != EXIT_UNREADABLE:
        merged = timeline.merge_perfetto(artifacts.get("traces") or [],
                                         args.perfetto,
                                         records=artifacts.get("records"))
        report["perfetto"] = {"path": args.perfetto, **merged}
    if args.json:
        print(json.dumps(report))
    else:
        print(render(report, timeline_events=events, tail=args.timeline))
    return report["exit_code"]


if __name__ == "__main__":
    raise SystemExit(main())
