"""Tail-latency attribution over ``serve_trace`` records: why is p99 slow?

The port's copy of ``tools/request_report.py``: the same arguments and output, built
on the port's own modules, so it runs on a host without JAX::

    python -m data_diet_distributed_tpu_torch.tools.request_report ...

The request observatory (``obs/reqtrace.py``) leaves per-request phase
breakdowns in the metrics stream — router admission/routing/proxy spans
and replica queue/coalesce/dispatch/fetch/serialize spans, stitched by
``X-Trace-Id``. This tool turns a stream into the answer a human asks::

    python -m data_diet_distributed_tpu_torch.tools.request_report <workdir>/metrics.jsonl
    python -m data_diet_distributed_tpu_torch.tools.request_report metrics.jsonl --where replica
    python -m data_diet_distributed_tpu_torch.tools.request_report metrics.jsonl --tail-q 0.99 --json

It names the DOMINANT PHASE of the latency tail (the modal worst phase
across tail requests) with exemplar trace ids per phase, plus per-phase
p50/p95 over every traced request — the evidence `serve_soak.py` demands
per cycle and `run_monitor`/`postmortem` embed.

Exit codes: 0 = report produced; 2 = the stream holds no serve_trace
records (nothing to attribute — a soak cycle treats that as a failure).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..obs import reqtrace
from ..obs import timeline


def build_report(records: list[dict], *, tail_q: float = 0.95,
                 where: str | None = None, exemplars: int = 3) -> dict:
    """The attribution verdict plus per-side sub-reports: the combined
    view answers "which phase", the router/replica splits answer "which
    process"."""
    report = reqtrace.attribute(records, tail_q=tail_q, where=where,
                                exemplars=exemplars)
    if where is None:
        report["by_side"] = {
            side: reqtrace.attribute(records, tail_q=tail_q, where=side,
                                     exemplars=exemplars)
            for side in ("router", "replica")}
    return report


def render(report: dict) -> str:
    lines = [f"request traces: {report['requests']}"
             + (f" (where={report['where']})" if report.get("where") else "")]
    for phase, s in (report.get("phases") or {}).items():
        lines.append(f"  {phase:>14}: p50 {s['p50_ms']:>9.3f} ms   "
                     f"p95 {s['p95_ms']:>9.3f} ms   max {s['max_ms']:>9.3f} ms"
                     f"   (n={s['count']})")
    tail = report.get("tail")
    if tail:
        lines.append(f"tail (>= {tail['threshold_ms']:.3f} ms, "
                     f"{tail['requests']} requests): dominant phase = "
                     f"{tail['dominant_phase']}")
        for phase, n in sorted((tail.get("phase_counts") or {}).items(),
                               key=lambda kv: -kv[1]):
            ex = ", ".join(e["trace_id"][:12] for e in
                           (tail.get("exemplars") or {}).get(phase, []))
            lines.append(f"  {phase:>14}: {n} tail request(s)"
                         + (f"   exemplars: {ex}" if ex else ""))
    for side, sub in (report.get("by_side") or {}).items():
        st = sub.get("tail")
        if sub.get("requests"):
            lines.append(f"{side}: {sub['requests']} traces, dominant phase "
                         f"= {st['dominant_phase'] if st else None}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("metrics", help="metrics JSONL holding serve_trace "
                                    "records")
    ap.add_argument("--tail-q", type=float, default=0.95,
                    help="tail quantile over request walls (default 0.95)")
    ap.add_argument("--where", choices=("router", "replica"), default=None,
                    help="restrict to one emitting side")
    ap.add_argument("--exemplars", type=int, default=3,
                    help="exemplar trace ids per phase (default 3)")
    ap.add_argument("--json", action="store_true", help="machine-readable")
    args = ap.parse_args(argv)
    records = timeline.read_records(args.metrics)
    report = build_report(records, tail_q=args.tail_q, where=args.where,
                          exemplars=args.exemplars)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render(report))
    if not report["requests"]:
        print(f"no serve_trace records in {args.metrics}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
