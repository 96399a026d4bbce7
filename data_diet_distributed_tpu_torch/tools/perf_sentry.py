"""Perf-regression sentry over an append-only run-history ledger.

The port's copy of ``tools/perf_sentry.py``: the same arguments, verdicts,
output and exit codes, built on the port's own modules, so it runs on a host
without JAX::

    python -m data_diet_distributed_tpu_torch.tools.perf_sentry artifacts/torch_perf_history.jsonl
    python -m data_diet_distributed_tpu_torch.tools.perf_sentry ledger.jsonl --threshold 0.15 --json

The ledger holds one ``{"kind": "perf_history"}`` record per measured run:
the port's autotuner (``tools/autotune.py``) and any CLI run with
``obs.perf_ledger`` set append to it. Per (metric, backend, geometry) group,
the NEWEST record is compared against the trailing median of the last
``--window`` CLEAN records before it. Wedge-shaped records (an ``error``
field, a non-ok ``exit_class``, a missing/zero/negative value) are
classified ``capture-error`` and can NEVER enter a baseline or count as a
regression. ``unit`` decides direction ("seconds" = lower-better; everything
else = higher-better). The port's records name ``backend`` ``cuda`` or
``cpu`` and ``device_kind`` the card, both part of the group key, so a card's
record is never judged against a TPU's, a CPU's or another card's.

``--import-bench`` (the JAX tool's one-shot backfill of the driver's
``BENCH_rNN.json`` rounds) refuses: those rounds were measured on a TPU, and
no TPU number carries over to the port's trail.

Exit-code contract (the JAX tool's)::

    0  every group ok / improved (or has no baseline yet)
    1  at least one regression past --threshold
    2  no regression, but the newest record of some group is capture-error
       (the capture path is blind again — fix it before trusting the trail)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_THRESHOLD = 0.10
DEFAULT_WINDOW = 5

#: Classification vocabulary for individual ledger records.
CLEAN, CAPTURE_ERROR = "clean", "capture-error"

#: Group statuses, most severe first (the run's exit code keys off these).
REGRESSION, NEWEST_CAPTURE_ERROR = "regression", "newest-capture-error"
IMPROVEMENT, OK, NO_BASELINE = "improvement", "ok", "no-baseline"

EXIT_OK, EXIT_REGRESSION, EXIT_CAPTURE_ERROR = 0, 1, 2

#: Why ``--import-bench`` refuses.
NO_TPU_BACKFILL = ("--import-bench refuses: the BENCH_rNN.json rounds were "
                   "measured on a TPU, and no TPU number carries over to the "
                   "port's ledger")


def classify_record(rec: dict) -> str:
    """``capture-error`` for wedge-shaped records: an error string, a non-ok
    exit class, or a value that cannot be a measurement (None/NaN/<=0 — both
    throughputs and wall-seconds are strictly positive when real)."""
    if rec.get("error"):
        return CAPTURE_ERROR
    if rec.get("exit_class") not in (None, "ok"):
        return CAPTURE_ERROR
    v = rec.get("value")
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return CAPTURE_ERROR
    if v != v or v <= 0:
        return CAPTURE_ERROR
    return CLEAN


def lower_is_better(rec: dict) -> bool:
    return str(rec.get("unit", "")).lower() in ("seconds", "s", "ms")


def comm_bytes_per_step(rec: dict) -> float | None:
    """The record's per-step collective-byte estimate (a ``comm`` block), or
    None when absent/zero — zero bytes means a geometry with no data-axis
    collectives (single device), which has no comm to regress."""
    comm = rec.get("comm")
    if not isinstance(comm, dict):
        return None
    v = comm.get("bytes_per_step")
    if isinstance(v, (int, float)) and not isinstance(v, bool) and v > 0:
        return float(v)
    return None


#: Serve-phase p95s are MEASURED latencies (scheduler noise, CI load),
#: unlike the analytic comm bytes — the per-phase check therefore fires
#: only past ``threshold * PHASE_SLACK`` AND an absolute floor, so a
#: 0.1 ms serialize phase tripling never fails a run.
PHASE_SLACK = 3.0
PHASE_MIN_DELTA_MS = 5.0


def phase_p95s(rec: dict) -> dict[str, float]:
    """``{phase: p95_ms}`` from the record's serve-phase breakdown (a
    ``phases`` block, the request observatory's per-phase aggregate), or
    ``{}`` when absent."""
    phases = rec.get("phases")
    if not isinstance(phases, dict):
        return {}
    out: dict[str, float] = {}
    for name, s in phases.items():
        v = s.get("p95_ms") if isinstance(s, dict) else None
        if isinstance(v, (int, float)) and not isinstance(v, bool) and v > 0:
            out[str(name)] = float(v)
    return out


def group_key(rec: dict) -> str:
    """Records are only comparable within the same (metric, backend,
    geometry) shape, and, when the record names one, the same
    ``device_kind`` (two kinds of card never share a baseline); geometry
    dicts canonicalize by sorted keys. Records without backend or geometry
    are identified by their metric name. A record without ``device_kind``
    keys as the JAX tool's does."""
    geom = rec.get("geometry")
    if isinstance(geom, dict):
        geom = json.dumps(geom, sort_keys=True)
    key = [rec.get("metric", ""), rec.get("backend", ""), geom or ""]
    if rec.get("device_kind"):
        key.append(rec["device_kind"])
    return json.dumps(key)


def load_ledger(path: str) -> list[dict]:
    """Ledger records in APPEND order (the sentry's notion of time — every
    writer appends atomically, so file order is run order). Non-JSON or
    non-perf_history lines are skipped: the ledger may share a stream with
    other record kinds."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and rec.get("kind") == "perf_history":
                records.append(rec)
    return records


def median(values: list[float]) -> float:
    """Plain median (shared with ``tools/autotune.py``'s ledger-negative
    pruning — the same statistic the sentry baselines on)."""
    s = sorted(values)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def autotune_combo(rec: dict) -> str | None:
    """The autotune combo name when ``rec`` is a candidate sample
    (``autotune.<name>.<metric>`` or an ``autotune`` rider), else None. Lets
    ledger consumers separate sweep samples from the headline trail without
    re-parsing metric strings."""
    rider = rec.get("autotune")
    if isinstance(rider, dict) and rider.get("combo"):
        return str(rider["combo"])
    metric = str(rec.get("metric", ""))
    if metric.startswith("autotune."):
        rest = metric[len("autotune."):]
        if "." in rest:
            return rest.split(".", 1)[0]
    return None


def check_group(records: list[dict], *, threshold: float,
                window: int) -> dict:
    """Verdict for one group's records (append order): the newest record vs
    the trailing median of the last ``window`` clean records before it."""
    newest = records[-1]
    out = {"metric": newest.get("metric"), "n_records": len(records),
           "newest_value": newest.get("value"),
           "classification": classify_record(newest)}
    if out["classification"] == CAPTURE_ERROR:
        out["status"] = NEWEST_CAPTURE_ERROR
        out["error"] = str(newest.get("error", ""))[:200]
        return out
    clean = [r["value"] for r in records[:-1] if classify_record(r) == CLEAN]
    if not clean:
        out["status"] = NO_BASELINE
        return out
    baseline = median(clean[-window:])
    out["baseline_median"] = baseline
    delta = (newest["value"] - baseline) / baseline
    if lower_is_better(newest):
        delta = -delta   # normalize: positive delta = better, either unit
    out["delta_frac"] = round(delta, 4)
    if delta < -threshold:
        out["status"] = REGRESSION
    elif delta > threshold:
        out["status"] = IMPROVEMENT
    else:
        out["status"] = OK
    # Comm sub-metric: per-step collective bytes are lower-better and
    # ANALYTIC, so a jump past the threshold is a structural regression, not
    # noise — it fails the group even when throughput still looks ok.
    nb = comm_bytes_per_step(newest)
    if nb is not None:
        comm_clean = [comm_bytes_per_step(r) for r in records[:-1]
                      if classify_record(r) == CLEAN]
        comm_clean = [v for v in comm_clean if v is not None][-window:]
        if comm_clean:
            cb = median(comm_clean)
            cdelta = -(nb - cb) / cb   # lower-better: positive = better
            out["comm_bytes_per_step"] = nb
            out["comm_baseline_median"] = cb
            out["comm_delta_frac"] = round(cdelta, 4)
            if cdelta < -threshold:
                out["status"] = REGRESSION
                out["comm_regression"] = True
    # Serve-phase sub-metrics: a regression hiding inside ONE phase can leave
    # total p95 inside its threshold. Phases are noisy, so the bar is
    # threshold * PHASE_SLACK plus an absolute floor, and the baseline needs
    # >= 2 clean samples of that phase.
    new_phases = phase_p95s(newest)
    if new_phases:
        regressed: dict[str, dict] = {}
        for name, nv in sorted(new_phases.items()):
            hist = [phase_p95s(r).get(name) for r in records[:-1]
                    if classify_record(r) == CLEAN]
            hist = [v for v in hist if v is not None][-window:]
            if len(hist) < 2:
                continue
            pb = median(hist)
            pdelta = -(nv - pb) / pb   # lower-better: positive = better
            if (pdelta < -(threshold * PHASE_SLACK)
                    and nv - pb >= PHASE_MIN_DELTA_MS):
                regressed[name] = {"p95_ms": nv,
                                   "baseline_median": round(pb, 3),
                                   "delta_frac": round(pdelta, 4)}
        if regressed:
            out["status"] = REGRESSION
            out["phase_regressions"] = regressed
    return out


def check_ledger(records: list[dict], *, threshold: float = DEFAULT_THRESHOLD,
                 window: int = DEFAULT_WINDOW,
                 metric: str | None = None) -> dict:
    groups: dict[str, list[dict]] = {}
    for rec in records:
        if metric is not None and rec.get("metric") != metric:
            continue
        groups.setdefault(group_key(rec), []).append(rec)
    results = [check_group(g, threshold=threshold, window=window)
               for g in groups.values()]
    capture_errors = sum(1 for r in records if classify_record(r)
                         == CAPTURE_ERROR)
    considered = [r for r in records
                  if metric is None or r.get("metric") == metric]
    if any(r["status"] == REGRESSION for r in results):
        exit_code = EXIT_REGRESSION
    elif considered and classify_record(considered[-1]) == CAPTURE_ERROR:
        # The LAST appended record (not any group's newest — a group that
        # stopped receiving records is stale, not blind) is wedge-shaped:
        # the capture path is blind RIGHT NOW.
        exit_code = EXIT_CAPTURE_ERROR
    else:
        exit_code = EXIT_OK
    return {"groups": results, "records": len(records),
            "capture_errors": capture_errors, "threshold": threshold,
            "window": window, "exit_code": exit_code}


# ------------------------------------------------------------------ CLI

def render(report: dict) -> str:
    lines = [f"perf sentry: {report['records']} ledger records, "
             f"{len(report['groups'])} group(s), "
             f"{report['capture_errors']} capture-error record(s), "
             f"threshold {report['threshold'] * 100:.0f}%"]
    for g in sorted(report["groups"], key=lambda g: g["metric"] or ""):
        line = f"  [{g['status']:>21}] {g['metric']}: {g['newest_value']}"
        if g.get("baseline_median") is not None:
            line += (f" vs median {round(g['baseline_median'], 2)}"
                     f" ({g['delta_frac'] * 100:+.1f}%)")
        if g.get("comm_regression"):
            line += (f" — COMM {g['comm_bytes_per_step']:.0f} B/step vs "
                     f"median {g['comm_baseline_median']:.0f} "
                     f"({g['comm_delta_frac'] * 100:+.1f}%)")
        for name, p in (g.get("phase_regressions") or {}).items():
            line += (f" — PHASE {name} {p['p95_ms']} ms vs median "
                     f"{p['baseline_median']} "
                     f"({p['delta_frac'] * 100:+.1f}%)")
        if g.get("error"):
            line += f" — {g['error']}"
        lines.append(line)
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Compare the newest perf-history record per "
                    "(metric, backend, geometry) against its trailing median")
    parser.add_argument("ledger", nargs="?", default=None,
                        help="perf-history JSONL ledger to check")
    parser.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                        help="regression fraction that fails the check "
                             f"(default {DEFAULT_THRESHOLD})")
    parser.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                        help="trailing clean records in the baseline median "
                             f"(default {DEFAULT_WINDOW})")
    parser.add_argument("--metric", default=None,
                        help="check only this metric")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as one JSON object")
    parser.add_argument("--import-bench", nargs="+", default=None,
                        metavar="BENCH.json",
                        help="refused: the BENCH_rNN.json rounds are TPU "
                             "measurements")
    parser.add_argument("--ledger", dest="ledger_out", default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.import_bench:
        parser.error(NO_TPU_BACKFILL)
    if not args.ledger:
        parser.error("ledger path required")
    if not os.path.exists(args.ledger):
        print(f"{args.ledger}: no ledger (no runs recorded yet)",
              file=sys.stderr)
        return EXIT_OK
    report = check_ledger(load_ledger(args.ledger), threshold=args.threshold,
                          window=args.window, metric=args.metric)
    print(json.dumps(report) if args.json else render(report))
    return report["exit_code"]


if __name__ == "__main__":
    raise SystemExit(main())
