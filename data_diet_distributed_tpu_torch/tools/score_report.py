"""Render the Score Observatory's story from a run directory.

The port's copy of ``tools/score_report.py``: the same arguments and output, built
on the port's own modules, so it runs on a host without JAX::

    python -m data_diet_distributed_tpu_torch.tools.score_report ...

What a human asks after a scoring run: what did the score distributions look
like, per method and per seed; did the seeds AGREE on the ranking (the
Spearman/overlap@k evidence Paul et al. 2021 rest on, and the statistic the
contested reproduction arXiv 2303.14753 found missing); which examples did
the prune actually keep/drop, and can the retrained checkpoint be audited
back to them; and — across two runs — did the scores drift. One command
answers all four without opening a notebook::

    python -m data_diet_distributed_tpu_torch.tools.score_report <run_dir>                    # or metrics.jsonl
    python -m data_diet_distributed_tpu_torch.tools.score_report <run_dir> --b <other_run>    # + drift section
    python -m data_diet_distributed_tpu_torch.tools.score_report <run_dir> --json             # machine-readable

A run argument is either a metrics JSONL file or a directory holding one
(``metrics.jsonl``) plus any ``*_scores.npz`` artifacts (with their
provenance sidecars) the run wrote. Partial trailing lines from crashed runs
are tolerated, same as every other stream consumer; the drift section joins
artifacts by GLOBAL example index, so runs over reordered subsets compare
correctly. Shares the trace-report toolbox: the ``obs/profiler.percentile``
quantile helper and the same tolerant JSONL reader.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from ..obs.plots import _read_jsonl
from ..obs.registry import percentile
from ..obs.scoreboard import overlap_at_k
from ..utils.io import (provenance_path,
                                                read_prune_manifest)
from ..utils.stats import spearman

#: Keep fraction the cross-artifact / cross-run overlap defaults to when no
#: prune decision pinned one (the repo's default sparsity is 0.5).
DEFAULT_KEEP_FRACTION = 0.5


def collect(run: str) -> dict:
    """Everything the report reads, from one run argument: the metrics
    records and every scores artifact (scores/indices/kept/method + its
    provenance sidecar when present)."""
    if os.path.isdir(run):
        metrics = os.path.join(run, "metrics.jsonl")
        npzs = sorted(glob.glob(os.path.join(run, "**", "*_scores.npz"),
                                recursive=True))
    else:
        metrics = run
        npzs = sorted(glob.glob(os.path.join(os.path.dirname(run) or ".",
                                             "**", "*_scores.npz"),
                                recursive=True))
    records = _read_jsonl(metrics) if os.path.exists(metrics) else []
    artifacts = {}
    for path in npzs:
        try:
            with np.load(path, allow_pickle=False) as d:
                if "scores" not in d.files or "indices" not in d.files:
                    continue
                art = {"scores": np.asarray(d["scores"]),
                       "indices": np.asarray(d["indices"]),
                       "kept": (np.asarray(d["kept"])
                                if "kept" in d.files else None),
                       "method": (str(d["method"])
                                  if "method" in d.files else None)}
        except Exception:   # noqa: BLE001 — a foreign/corrupt npz is skipped,
            continue        # not fatal to the report
        try:
            art["manifest"] = read_prune_manifest(path)
        except ValueError as err:
            # The audit paths refuse a corrupt sidecar loudly; the REPORT
            # names it and keeps going — one damaged artifact in a scanned
            # tree must not take down the whole post-mortem.
            print(f"[score_report] {err}", file=sys.stderr)
            art["manifest"] = None
        artifacts[path] = art
    return {"metrics_path": metrics, "records": records,
            "artifacts": artifacts}


# ------------------------------------------------------------- sections


def stats_section(records: list[dict]) -> dict:
    """Per-method score-distribution table: one row per seed (latest record
    per (method, seed) wins — appended logs can span runs)."""
    latest: dict[tuple, dict] = {}
    for r in records:
        if r.get("kind") == "score_stats":
            latest[(str(r.get("method")), r.get("seed"))] = r
    out: dict = {}
    for (method, seed), r in sorted(latest.items(),
                                    key=lambda kv: (kv[0][0], str(kv[0][1]))):
        row = {"seed": seed,
               **{k: r.get(k) for k in ("n", "mean", "std", "p5", "p50",
                                        "p95", "max")},
               "nonfinite": (r.get("nan_count", 0) or 0)
               + (r.get("inf_count", 0) or 0)}
        if r.get("resumed"):
            row["resumed"] = True
        out.setdefault(method, []).append(row)
    return out


def stability_section(records: list[dict]) -> dict:
    """The latest score_stability record per method — the seed-agreement
    matrix this tool exists to surface."""
    out: dict = {}
    for r in records:
        if r.get("kind") == "score_stability":
            out[str(r.get("method"))] = {
                k: r.get(k) for k in
                ("seeds", "n_seeds", "n", "spearman_pairwise",
                 "spearman_pairwise_mean", "spearman_pairwise_min",
                 "spearman_vs_mean", "spearman_vs_mean_mean",
                 "overlap_at_keep", "dropped_seeds")
                if r.get(k) is not None}
    return out


def decisions_section(records: list[dict], artifacts: dict) -> list[dict]:
    """Prune decisions, from the stream's prune_decision records merged with
    the on-disk provenance sidecars (a crashed run may have one without the
    other; the sidecar wins on conflict — it is what the retrain verified).
    Joined by ``kept_digest`` — the decision's IDENTITY — not by path: the
    stream may record a relative manifest path while the glob found an
    absolute one, and the same decision must render once, not twice."""
    merged: dict[str, dict] = {}
    fields = ("method", "sparsity", "keep", "n_total", "n_kept", "n_dropped",
              "threshold_score", "kept_digest", "nonfinite_scores",
              "fingerprint")

    def key_of(d: dict) -> str:
        return str(d.get("kept_digest") or d.get("manifest"))

    for r in records:
        if r.get("kind") == "prune_decision":
            entry = merged.setdefault(key_of(r), {})
            entry.update({k: r.get(k) for k in fields})
            entry["manifest"] = r.get("manifest")
    for path, art in artifacts.items():
        man = art.get("manifest")
        if not man:
            continue
        entry = merged.setdefault(key_of(man), {})
        entry.update({k: man.get(k) for k in fields})
        entry["manifest"] = provenance_path(path)
        entry["top_k"] = man.get("top_k")
        entry["bottom_k"] = man.get("bottom_k")
    return [merged[k] for k in sorted(merged)]


def method_overlap_section(artifacts: dict,
                           frac: float = DEFAULT_KEEP_FRACTION) -> list[dict]:
    """Keep-set agreement ACROSS artifacts (different methods, or different
    runs' copies of one method): for each pair, the overlap of their kept
    sets (when both recorded one) and the overlap@k of their keep-hardest
    top-k, joined by global index over the shared examples."""
    items = sorted(artifacts.items())
    out = []
    for i in range(len(items)):
        for j in range(i + 1, len(items)):
            (pa, a), (pb, b) = items[i], items[j]
            shared, ia, ib = np.intersect1d(a["indices"], b["indices"],
                                            return_indices=True)
            if len(shared) == 0:
                continue
            sa, sb = a["scores"][ia], b["scores"][ib]
            k = int(frac * len(shared))
            pair = {"a": os.path.basename(pa), "b": os.path.basename(pb),
                    "method_a": a["method"], "method_b": b["method"],
                    "n_shared": int(len(shared)),
                    "spearman": round(spearman(sa, sb), 6),
                    "overlap_at_k": (round(overlap_at_k(sa, sb, k), 6)
                                     if k > 0 else None),
                    "keep_fraction": frac}
            if a["kept"] is not None and b["kept"] is not None:
                ka, kb = set(a["kept"].tolist()), set(b["kept"].tolist())
                denom = min(len(ka), len(kb))
                if denom:
                    pair["kept_set_overlap"] = round(
                        len(ka & kb) / denom, 6)
            out.append(pair)
    return out


def drift_section(run_a: dict, run_b: dict,
                  frac: float = DEFAULT_KEEP_FRACTION) -> list[dict]:
    """Between-run drift: for each (method_a, method_b) artifact pair across
    the two runs that share examples, Spearman ρ and overlap@k of the score
    vectors joined by global index — the GraNd-at-init vs GraNd-early /
    re-scored-after-E-epochs comparison in one section."""
    out = []
    for pa, a in sorted(run_a["artifacts"].items()):
        for pb, b in sorted(run_b["artifacts"].items()):
            pair = method_overlap_section({f"A:{pa}": a, f"B:{pb}": b}, frac)
            out.extend(pair)
    return out


def seed_percentile_spread(stats: dict) -> dict:
    """Across-seed spread of each method's central tendency (how much the
    per-seed means wander): p50/p95 of the per-seed means via the shared
    percentile helper — a one-line 'are the seeds even in the same regime'
    check above the full matrix."""
    out = {}
    for method, rows in stats.items():
        means = [r["mean"] for r in rows if isinstance(r.get("mean"),
                                                       (int, float))]
        if means:
            out[method] = {"n_seeds": len(means),
                           "mean_p50": round(percentile(means, 0.5), 6),
                           "mean_p95": round(percentile(means, 0.95), 6),
                           "mean_spread": round(max(means) - min(means), 6)}
    return out


def build_report(run_a: dict, run_b: dict | None = None,
                 frac: float = DEFAULT_KEEP_FRACTION) -> dict:
    stats = stats_section(run_a["records"])
    report = {
        "metrics_path": run_a["metrics_path"],
        "score_stats": stats,
        "seed_mean_spread": seed_percentile_spread(stats),
        "score_stability": stability_section(run_a["records"]),
        "prune_decisions": decisions_section(run_a["records"],
                                             run_a["artifacts"]),
        "method_overlap": method_overlap_section(run_a["artifacts"], frac),
    }
    if run_b is not None:
        report["drift"] = drift_section(run_a, run_b, frac)
        report["drift_b_metrics_path"] = run_b["metrics_path"]
    return report


# --------------------------------------------------------------- rendering


def _fmt(v, digits: int = 4) -> str:
    if v is None:
        return "n/a"
    if isinstance(v, float):
        return f"{v:.{digits}f}"
    return str(v)


def render(report: dict) -> str:
    lines = [f"score report: {report['metrics_path']}"]
    for method, rows in report["score_stats"].items():
        lines.append(f"score distributions [{method}]:")
        lines.append("  seed       n      mean       std        p5       p50"
                     "       p95       max  nonfinite")
        for r in rows:
            tag = " (resumed)" if r.get("resumed") else ""
            lines.append(
                f"  {str(r['seed']):>4} {_fmt(r['n'], 0):>7} "
                + " ".join(f"{_fmt(r[k]):>9}"
                           for k in ("mean", "std", "p5", "p50", "p95",
                                     "max"))
                + f" {r['nonfinite']:>10}{tag}")
    for method, spread in report.get("seed_mean_spread", {}).items():
        lines.append(f"  [{method}] per-seed mean spread: "
                     f"{_fmt(spread['mean_spread'])} "
                     f"(p50 {_fmt(spread['mean_p50'])}, "
                     f"p95 {_fmt(spread['mean_p95'])})")
    for method, st in report["score_stability"].items():
        lines.append(f"cross-seed stability [{method}] "
                     f"({st.get('n_seeds')} seeds, n={st.get('n')}):")
        seeds = st.get("seeds") or []
        matrix = st.get("spearman_pairwise") or []
        if matrix:
            lines.append("  Spearman ρ matrix (seed × seed):")
            lines.append("        " + " ".join(f"{s:>7}" for s in seeds))
            for s, row in zip(seeds, matrix):
                lines.append(f"  {s:>5} " + " ".join(
                    f"{_fmt(v):>7}" for v in row))
        lines.append(f"  pairwise ρ mean {_fmt(st.get('spearman_pairwise_mean'))}"
                     f"  min {_fmt(st.get('spearman_pairwise_min'))}"
                     f"  vs-mean ρ {_fmt(st.get('spearman_vs_mean_mean'))}")
        for f, ov in (st.get("overlap_at_keep") or {}).items():
            lines.append(f"  overlap@keep={f}: {_fmt(ov)}")
        if st.get("dropped_seeds"):
            lines.append(f"  (seeds past retention bound, excluded: "
                         f"{st['dropped_seeds']})")
    if report["prune_decisions"]:
        lines.append("prune decisions:")
        for d in report["prune_decisions"]:
            lines.append(
                f"  {d.get('method')} sparsity={_fmt(d.get('sparsity'), 3)} "
                f"keep={d.get('keep')} kept {d.get('n_kept')}/"
                f"{d.get('n_total')} threshold "
                f"{_fmt(d.get('threshold_score'))} "
                f"digest {d.get('kept_digest')}")
            for label, key in (("hardest", "top_k"), ("easiest", "bottom_k")):
                if d.get(key):
                    # Scores may be null (legacy sidecars whose extremes
                    # included nulled non-finite values) — render, not crash.
                    ex = ", ".join(
                        f"{e['index']}:"
                        + (f"{e['score']:.4g}" if isinstance(
                            e.get("score"), (int, float)) else "n/a")
                        for e in d[key][:5])
                    lines.append(f"    {label}: {ex}")
    if report["method_overlap"]:
        lines.append("keep/drop agreement across artifacts:")
        for p in report["method_overlap"]:
            lines.append(
                f"  {p['method_a']}({p['a']}) vs {p['method_b']}({p['b']}): "
                f"ρ {_fmt(p['spearman'])}  overlap@"
                f"{p['keep_fraction']:g} {_fmt(p['overlap_at_k'])}"
                + (f"  kept∩ {_fmt(p['kept_set_overlap'])}"
                   if "kept_set_overlap" in p else ""))
    if report.get("drift"):
        lines.append(f"drift vs {report.get('drift_b_metrics_path')}:")
        for p in report["drift"]:
            lines.append(
                f"  {p['method_a']}({p['a']}) vs {p['method_b']}({p['b']}): "
                f"ρ {_fmt(p['spearman'])}  overlap@"
                f"{p['keep_fraction']:g} {_fmt(p['overlap_at_k'])}")
    if len(lines) == 1:
        lines.append("  (no Score Observatory records or artifacts found)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Render score distributions, cross-seed rank stability, "
                    "and prune-decision provenance from a run directory")
    parser.add_argument("run", help="run directory (metrics.jsonl + "
                        "*_scores.npz) or a metrics JSONL path")
    parser.add_argument("--b", default=None,
                        help="second run to compute score drift against")
    parser.add_argument("--keep-fraction", type=float,
                        default=DEFAULT_KEEP_FRACTION,
                        help="keep fraction for the overlap@k sections")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as one JSON object")
    args = parser.parse_args(argv)

    run_a = collect(args.run)
    run_b = collect(args.b) if args.b else None
    if not run_a["records"] and not run_a["artifacts"]:
        print(f"no metrics records or scores artifacts under {args.run}",
              file=sys.stderr)
        return 1
    report = build_report(run_a, run_b, frac=args.keep_fraction)
    if args.json:
        print(json.dumps(report))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
