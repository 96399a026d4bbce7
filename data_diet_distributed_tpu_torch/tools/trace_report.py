"""Summarize a Chrome-trace JSON written by ``obs/tracing.py``.

The port's copy of ``tools/trace_report.py``: the same arguments and output, built
on the port's own modules, so it runs on a host without JAX::

    python -m data_diet_distributed_tpu_torch.tools.trace_report ...

What a human asks after a run (or a crash): where did the time go, per stage
and per epoch; which chunks were slow; were there gaps where nothing made
progress; and how fresh is each rank's heartbeat. One command answers all
four without opening a trace viewer::

    python -m data_diet_distributed_tpu_torch.tools.trace_report <workdir>/trace.json
    python -m data_diet_distributed_tpu_torch.tools.trace_report trace.json trace_rank1.json   # merged view
    python -m data_diet_distributed_tpu_torch.tools.trace_report <workdir>            # ALL attempts + ranks
    python -m data_diet_distributed_tpu_torch.tools.trace_report trace.json --heartbeats ./ckpt_heartbeats
    python -m data_diet_distributed_tpu_torch.tools.trace_report trace.json --metrics metrics.jsonl  # + XLA
    python -m data_diet_distributed_tpu_torch.tools.trace_report trace.json --json             # machine-readable

A directory argument discovers and merges every per-(attempt, rank) trace
of the run (``trace.json``, ``trace_a1.json``, ``trace_a1_rank1.json``, … —
the elastic supervisor's relaunches write attempt-suffixed traces instead
of clobbering the crashed attempt's, ``obs/lineage.py``), so one command
summarizes the whole lineage.

Reads crashed-run traces too (the streamed format tolerates a missing
terminating ``]`` — ``obs.tracing.read_trace``). The per-stage breakdown uses
the SAME stage names as the resilience stage manifest (``score``,
``prune:<tag>``, ``retrain:<tag>``, ``dense:final``), so a trace summary and
a resume manifest describe the run in one vocabulary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..obs.heartbeat import (describe_beats,
                                                     read_heartbeats)
from ..obs.registry import percentile
from ..obs.tracing import (discover_traces,
                                                   read_trace)

#: Inter-event gaps shorter than this are loop bookkeeping, not stalls.
DEFAULT_GAP_S = 1.0


def _spans(events: list[dict]) -> list[dict]:
    return [e for e in events if e.get("ph") == "X"]


def _dur_summary(durs_us: list[float]) -> dict:
    s = [d / 1e6 for d in durs_us]
    return {"count": len(s), "total_s": round(sum(s), 3),
            "mean_s": round(sum(s) / len(s), 4) if s else None,
            "p50_s": round(percentile(s, 0.50), 4) if s else None,
            "p95_s": round(percentile(s, 0.95), 4) if s else None,
            "max_s": round(max(s), 4) if s else None}


def summarize(events: list[dict], *, top_chunks: int = 5,
              gap_threshold_s: float = DEFAULT_GAP_S) -> dict:
    """The report dict: per-stage totals, per-epoch stats, slowest chunks,
    largest inter-event gaps (the trace-side heartbeat-gap signal: an
    interval where NO span ended is an interval where nothing completed)."""
    spans = _spans(events)
    by_cat: dict[str, list[dict]] = {}
    for e in spans:
        by_cat.setdefault(e.get("cat", "span"), []).append(e)

    stages = {}
    for e in by_cat.get("stage", []):
        stages.setdefault(e["name"], []).append(e["dur"])
    stage_report = {name: _dur_summary(durs)
                    for name, durs in sorted(stages.items())}

    epochs: dict[str, list[float]] = {}
    epoch_seq: dict[str, list[tuple[int, float]]] = {}
    for e in by_cat.get("epoch", []):
        args = e.get("args") or {}
        tag = args.get("tag", "")
        epochs.setdefault(tag, []).append(e["dur"])
        epoch_seq.setdefault(tag, []).append((int(args.get("epoch", 0)),
                                              e["dur"]))
    epoch_report = {tag: _dur_summary(durs)
                    for tag, durs in sorted(epochs.items())}

    # Compile vs steady-state split: per fit tag, the FIRST epoch carries the
    # stage's compiles (trace+lower+XLA) while the rest are steady state —
    # the ratio says how much of a short stage's wall was compile tax.
    # Merged per-rank traces contribute one epoch-0 span PER RANK, so the
    # split averages every min-epoch span (not just the first after sorting —
    # that would count one rank's compile and fold the others into steady).
    compile_split = {}
    for tag, seq in sorted(epoch_seq.items()):
        min_ep = min(e for e, _ in seq)
        first = [d / 1e6 for e, d in seq if e == min_ep]
        steady = [d / 1e6 for e, d in seq if e != min_ep]
        if not steady:
            continue
        first_s = sum(first) / len(first)
        steady_mean = sum(steady) / len(steady)
        compile_split[tag] = {
            "compile_epoch_s": round(first_s, 4),
            "steady_epoch_mean_s": round(steady_mean, 4),
            "compile_overhead_s": round(max(first_s - steady_mean, 0.0), 4),
            "ratio": round(first_s / steady_mean, 2) if steady_mean else None}

    # Prefetch stalls (data/pipeline.PrefetchIterator): one cat="prefetch"
    # span per consumer wait on the assembler thread, tagged with the stage
    # that stalled. p50/p95 per stage says whether the data plane kept up
    # with dispatch or the loop ran input-bound.
    prefetch: dict[str, list[float]] = {}
    for e in by_cat.get("prefetch", []):
        stage = (e.get("args") or {}).get("stage", "?")
        prefetch.setdefault(stage, []).append(e["dur"])
    prefetch_report = {stage: _dur_summary(durs)
                       for stage, durs in sorted(prefetch.items())}

    chunk_spans = sorted(by_cat.get("chunk", []), key=lambda e: -e["dur"])
    slowest = [{"dur_s": round(e["dur"] / 1e6, 4), "pid": e.get("pid"),
                **(e.get("args") or {})} for e in chunk_spans[:top_chunks]]
    chunk_report = (_dur_summary([e["dur"] for e in chunk_spans])
                    if chunk_spans else None)

    # Progress gaps: sort every event endpoint; a long interval with no
    # endpoint means nothing finished — a stall, a hang, or legitimate
    # long-compile. Only X/i events carry timestamps worth ordering.
    points = sorted(e["ts"] + e.get("dur", 0.0) for e in events
                    if e.get("ph") in ("X", "i") and "ts" in e)
    gaps = []
    for a, b in zip(points, points[1:]):
        gap_s = (b - a) / 1e6
        if gap_s >= gap_threshold_s:
            gaps.append({"gap_s": round(gap_s, 3),
                         "at_s": round((a - points[0]) / 1e6, 3)})
    gaps.sort(key=lambda g: -g["gap_s"])

    total_s = (points[-1] - points[0]) / 1e6 if len(points) > 1 else 0.0
    return {"events": len(events), "spans": len(spans),
            "trace_total_s": round(total_s, 3), "stages": stage_report,
            "epochs": epoch_report, "compile_split": compile_split,
            "prefetch_stalls": prefetch_report,
            "chunks": chunk_report,
            "slowest_chunks": slowest, "gaps": gaps[:5],
            "ranks": sorted({e.get("pid", 0) for e in spans})}


def xla_section(metrics_path: str) -> dict:
    """The XLA block from a run's metrics JSONL: the terminal run_summary's
    per-program introspection harvest (flops, bytes, compile wall, peak-bytes
    estimate) plus the registry's MFU / HBM / peak-flops gauges from the last
    metrics snapshot — the compiled-program numbers next to the wall-clock
    ones this tool derives from the trace."""
    programs: dict = {}
    gauges: dict = {}
    try:
        with open(metrics_path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                kind = rec.get("kind")
                if kind == "xla_program":
                    programs[rec.get("program", "?")] = {
                        k: rec.get(k) for k in
                        ("geometry", "flops", "bytes_accessed", "compile_s",
                         "peak_bytes", "arith_intensity")}
                elif kind == "run_summary" and rec.get("xla"):
                    programs.update(rec["xla"])
                elif kind == "metrics":
                    for g, v in (rec.get("gauges") or {}).items():
                        if g == "mfu" or g.startswith(("mfu:", "hbm_",
                                                       "xla_peak_flops")):
                            gauges[g] = v
    except OSError:
        pass
    return {"programs": programs, "gauges": gauges}


def _fmt_summary(name: str, s: dict, width: int = 24) -> str:
    return (f"  {name:<{width}} total {s['total_s']:>9.3f}s  "
            f"n={s['count']:<4d} mean {s['mean_s']}s  "
            f"p95 {s['p95_s']}s  max {s['max_s']}s")


def render(report: dict, heartbeats: dict[int, dict] | None = None,
           now: float | None = None) -> str:
    lines = [f"trace: {report['events']} events, {report['spans']} spans, "
             f"{report['trace_total_s']}s span, "
             f"ranks {report['ranks']}"
             + (f", attempts {report['attempts']}"
                if report.get("attempts") else "")]
    if report["stages"]:
        lines.append("per-stage breakdown:")
        lines += [_fmt_summary(n, s) for n, s in report["stages"].items()]
    if report["epochs"]:
        lines.append("per-epoch (by fit tag):")
        lines += [_fmt_summary(t or "<untagged>", s)
                  for t, s in report["epochs"].items()]
    if report.get("compile_split"):
        lines.append("compile vs steady-state (first epoch vs rest):")
        for tag, s in report["compile_split"].items():
            lines.append(
                f"  {tag or '<untagged>':<24} compile epoch "
                f"{s['compile_epoch_s']}s vs steady {s['steady_epoch_mean_s']}s"
                f"  (+{s['compile_overhead_s']}s, x{s['ratio']})")
    if report.get("xla"):
        progs, gauges = report["xla"]["programs"], report["xla"]["gauges"]
        if progs or gauges:
            lines.append("XLA compiled programs (obs/xla.py harvest):")
        for name, p in sorted(progs.items()):
            flops = p.get("flops")
            parts = [f"flops {flops:.3e}" if flops else "flops n/a"]
            if p.get("bytes_accessed"):
                parts.append(f"bytes {p['bytes_accessed']:.3e}")
            if p.get("arith_intensity"):
                parts.append(f"AI {p['arith_intensity']}")
            if p.get("compile_s") is not None:
                parts.append(f"compile {p['compile_s']}s")
            if p.get("peak_bytes"):
                parts.append(f"peak~{p['peak_bytes'] / 1e6:.1f}MB")
            lines.append(f"  {name:<24} " + "  ".join(parts))
        for g, v in sorted(gauges.items()):
            lines.append(f"  {g:<24} {v}")
    if report.get("prefetch_stalls"):
        lines.append("prefetch stalls (consumer waited on the assembler):")
        lines += [_fmt_summary(stage, s)
                  for stage, s in report["prefetch_stalls"].items()]
    if report["chunks"]:
        lines.append("chunk dispatches:")
        lines.append(_fmt_summary("all chunks", report["chunks"]))
        for c in report["slowest_chunks"]:
            where = ", ".join(f"{k}={v}" for k, v in c.items() if k != "dur_s")
            lines.append(f"    slow chunk {c['dur_s']}s ({where})")
    if report["gaps"]:
        lines.append("largest progress gaps (no event completed):")
        for g in report["gaps"]:
            lines.append(f"  {g['gap_s']}s at t+{g['at_s']}s")
    if heartbeats is not None:
        if heartbeats:
            # Same formatting as WatchdogTimeout messages / poison reasons
            # (obs/heartbeat.describe_beats) — one vocabulary everywhere.
            lines.append("heartbeats:")
            lines += [f"  {line}" for line in describe_beats(heartbeats, now)]
        else:
            lines.append("heartbeats: none found")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Summarize obs/tracing.py Chrome-trace JSON")
    parser.add_argument("trace", nargs="+", help="trace JSON file(s); "
                        "multiple files (per-rank traces) are merged")
    parser.add_argument("--heartbeats", default=None,
                        help="heartbeat directory to report rank ages from")
    parser.add_argument("--metrics", default=None,
                        help="metrics JSONL to source the XLA section from "
                             "(per-program flops/bytes/compile-time from the "
                             "xla_program records, MFU/HBM gauges from the "
                             "registry snapshots)")
    parser.add_argument("--top-chunks", type=int, default=5)
    parser.add_argument("--gap-threshold", type=float, default=DEFAULT_GAP_S,
                        help="report inter-event gaps at least this long (s)")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as one JSON object")
    args = parser.parse_args(argv)

    events: list[dict] = []
    attempts: set[int] = set()
    for path in args.trace:
        if os.path.isdir(path):
            # A run directory: merge EVERY per-(attempt, rank) trace it
            # holds. Attempts share pid=rank lanes in the summary; the
            # attempt set is reported so a multi-attempt merge is explicit.
            rows = discover_traces(os.path.join(path, "trace.json"))
            if not rows:
                print(f"no trace*.json in directory {path}",
                      file=sys.stderr)
            for row in rows:
                events.extend(read_trace(row["path"]))
                attempts.add(row["attempt"])
        else:
            events.extend(read_trace(path))
    if not events:
        print(f"no events in {args.trace}", file=sys.stderr)
        return 1
    report = summarize(events, top_chunks=args.top_chunks,
                       gap_threshold_s=args.gap_threshold)
    if attempts:
        report["attempts"] = sorted(attempts)
    if args.metrics is not None:
        report["xla"] = xla_section(args.metrics)
    beats = (read_heartbeats(args.heartbeats)
             if args.heartbeats is not None else None)
    if args.json:
        if beats is not None:
            report["heartbeats"] = beats
        print(json.dumps(report))
    else:
        print(render(report, heartbeats=beats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
