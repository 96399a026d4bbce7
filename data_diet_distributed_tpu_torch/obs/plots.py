"""Render the utilization and metrics JSON lines into PNG plots (the port's
copy of ``data_diet_distributed_tpu/obs/plots.py``: the same functions, file
names and filters).

The monitor (``obs/monitor.py``) and the metrics logger already write one JSON
record per line, so plotting is a straight read; malformed lines (a crashed
run's partial last line) are skipped, not fatal. ``cli.py`` calls these after
a command that was not preempted when ``obs.plots_dir`` is set, on rank 0.

matplotlib is imported lazily and every function is a no-op returning ``[]``
when it is unavailable, so the package carries no plotting dependency.
"""

from __future__ import annotations

import json
import os


def _read_jsonl(path: str) -> list[dict]:
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # partial last line from a crashed run is fine
    return records


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:
        return None


def plot_utilization(monitor_path: str, out_dir: str = "./plots",
                     since_ts: float = 0.0) -> list[str]:
    """Render host-CPU%% and per-device HBM-use plots from the ResourceMonitor log.

    ``since_ts`` filters out records from earlier runs (both loggers append, so the
    file may span several runs). Returns the list of files written (empty if
    matplotlib is missing or the log holds no samples).
    """
    plt = _mpl()
    if plt is None or not os.path.exists(monitor_path):
        return []
    records = [r for r in _read_jsonl(monitor_path)
               if "cpu_pct" in r and r.get("ts", 0.0) >= since_ts]
    if not records:
        return []
    os.makedirs(out_dir, exist_ok=True)
    t0 = records[0].get("ts", 0.0)
    times = [r.get("ts", t0) - t0 for r in records]
    written: list[str] = []

    fig, ax = plt.subplots(figsize=(8, 3))
    ax.plot(times, [r.get("cpu_pct", 0.0) for r in records], lw=1.0)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("host CPU %")
    ax.set_ylim(0, 100)
    ax.set_title("Host CPU utilization")
    fig.tight_layout()
    path = os.path.join(out_dir, "cpu_utilization.png")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    written.append(path)

    # Device duty cycle (the monitor's probe-latency busy fraction), one line
    # per device when the records carry per-device duty, plus the mean.
    duty = [(t, r["duty_cycle"]) for t, r in zip(times, records)
            if isinstance(r.get("duty_cycle"), (int, float))]
    if duty:
        fig, ax = plt.subplots(figsize=(8, 3))
        per_dev: dict[str, list[tuple[float, float]]] = {}
        for t, r in zip(times, records):
            for d in r.get("devices", []):
                if isinstance(d.get("duty_cycle"), (int, float)):
                    per_dev.setdefault(d["device"], []).append(
                        (t, d["duty_cycle"]))
        for name, pts in sorted(per_dev.items()):
            ax.plot([p[0] for p in pts], [100.0 * p[1] for p in pts],
                    lw=0.8, alpha=0.6, label=name)
        ax.plot([p[0] for p in duty], [100.0 * p[1] for p in duty], lw=1.4,
                color="k", label="mean" if per_dev else None)
        if per_dev and len(per_dev) <= 8:
            ax.legend(fontsize=6, ncol=2)
        ax.set_xlabel("time (s)")
        ax.set_ylabel("device busy %")
        ax.set_ylim(0, 105)
        ax.set_title("Device duty cycle (probe estimate)")
        fig.tight_layout()
        path = os.path.join(out_dir, "device_duty_cycle.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)

    # One HBM trace per device; devices discovered from the samples themselves.
    # One unit for the whole axis: percent only when EVERY sample carries a limit,
    # GiB otherwise (mixing per-point units would render a quantitatively wrong
    # chart with no warning).
    samples = [(t, dev) for t, r in zip(times, records)
               for dev in r.get("devices", []) if dev.get("bytes_in_use") is not None]
    as_pct = bool(samples) and all(dev.get("bytes_limit") for _, dev in samples)
    series: dict[str, tuple[list[float], list[float]]] = {}
    for t, dev in samples:
        used = dev["bytes_in_use"]
        val = 100.0 * used / dev["bytes_limit"] if as_pct else used / 2**30
        xs, ys = series.setdefault(str(dev.get("device")), ([], []))
        xs.append(t)
        ys.append(val)
    if series:
        fig, ax = plt.subplots(figsize=(8, 3))
        for name, (xs, ys) in sorted(series.items()):
            ax.plot(xs, ys, lw=1.0, label=name)
        ax.set_xlabel("time (s)")
        ax.set_ylabel("HBM in use %" if as_pct else "HBM in use (GiB)")
        ax.legend(fontsize=7)
        ax.set_title("Device memory")
        fig.tight_layout()
        path = os.path.join(out_dir, "device_memory.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)
    return written


def plot_scores(npz_path: str, out_dir: str = "./plots",
                name: str = "score_distribution.png") -> list[str]:
    """Histogram of the saved per-example scores, with the kept/dropped cut
    marked when the npz carries a ``kept`` set."""
    plt = _mpl()
    if plt is None or not os.path.exists(npz_path):
        return []
    import numpy as np
    with np.load(npz_path) as data:
        if "scores" not in data:
            return []
        scores = data["scores"]
        kept = data["kept"] if "kept" in data else None
        indices = data["indices"] if "indices" in data else None
        keep = str(data["keep"]) if "keep" in data else None
        class_balance = bool(data["class_balance"]) if "class_balance" in data \
            else False
    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(scores, bins=min(80, max(10, len(scores) // 50)))
    if (kept is not None and indices is not None
            and 0 < len(kept) < len(scores)
            # The cut line is only meaningful for GLOBAL threshold policies:
            # hardest cuts at min(kept), easiest at max(kept); random has no
            # cut, and class-balanced pruning uses per-class thresholds — a
            # single global line there would be misleading, so the kept count
            # is annotated without one.
            and keep in ("hardest", "easiest")):
        kept_mask = np.isin(indices, kept)
        if kept_mask.any():
            if class_balance:
                ax.plot([], [], " ",
                        label=(f"kept {kept_mask.sum()}/{len(scores)} "
                               f"({keep}, per-class cuts)"))
            else:
                cut = (scores[kept_mask].min() if keep == "hardest"
                       else scores[kept_mask].max())
                ax.axvline(float(cut), color="C3", lw=1.2,
                           label=f"kept {kept_mask.sum()}/{len(scores)} ({keep})")
            ax.legend()
    ax.set_xlabel("score")
    ax.set_ylabel("examples")
    ax.set_title(os.path.basename(npz_path))
    fig.tight_layout()
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return [path]


def score_hist_series(records: list[dict]) -> dict[str, list[tuple]]:
    """The score-histogram data a ``plot_score_stats`` chart draws, extracted
    pure (the direct-test seam): ``{method: [(seed, edges, counts), ...]}``
    from the stream's ``score_stats`` records — latest record per (method,
    seed) wins (appended logs may span runs), records without a histogram
    (all-NaN vectors) are skipped."""
    latest: dict[tuple, tuple] = {}
    for r in records:
        if r.get("kind") != "score_stats":
            continue
        hist = r.get("hist")
        if not isinstance(hist, dict) or not hist.get("counts"):
            continue
        latest[(str(r.get("method")), r.get("seed"))] = (
            hist["edges"], hist["counts"])
    series: dict[str, list[tuple]] = {}
    for (method, seed), (edges, counts) in sorted(
            latest.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        series.setdefault(method, []).append((seed, edges, counts))
    return series


def plot_score_stats(metrics_path: str, out_dir: str = "./plots",
                     since_ts: float = 0.0) -> list[str]:
    """Render the Score Observatory's per-seed score distributions — one PNG
    per method, every seed's bounded histogram (from the ``score_stats``
    records' exact bin edges/counts, NOT re-binned) as a step outline.

    Unlike ``plot_scores`` this needs no npz: crashed runs that never reached
    the prune stage still have their per-seed distributions in the stream.
    """
    plt = _mpl()
    if plt is None or not os.path.exists(metrics_path):
        return []
    records = [r for r in _read_jsonl(metrics_path)
               if r.get("ts", 0.0) >= since_ts]
    series = score_hist_series(records)
    if not series:
        return []
    os.makedirs(out_dir, exist_ok=True)
    written: list[str] = []
    for method, seeds in series.items():
        fig, ax = plt.subplots(figsize=(6, 4))
        for seed, edges, counts in seeds:
            # The record's exact bins: drawsteps between consecutive edges.
            ax.stairs(counts, edges, label=f"seed {seed}")
        if len(seeds) <= 10:
            ax.legend(fontsize=7)
        ax.set_xlabel("score")
        ax.set_ylabel("examples")
        ax.set_title(f"score distribution per seed ({method})")
        fig.tight_layout()
        path = os.path.join(out_dir, f"score_stats_{method}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)
    return written


def plot_metrics(metrics_path: str, out_dir: str = "./plots",
                 since_ts: float = 0.0) -> list[str]:
    """Render loss / accuracy / throughput curves from the MetricsLogger JSONL.

    ``since_ts`` keeps only the current run's records (the logger appends).
    """
    plt = _mpl()
    if plt is None or not os.path.exists(metrics_path):
        return []
    records = [r for r in _read_jsonl(metrics_path) if r.get("ts", 0.0) >= since_ts]
    os.makedirs(out_dir, exist_ok=True)
    written: list[str] = []

    def curve(kind: str, field: str, fname: str, ylabel: str):
        matching = [r for r in records if r.get("kind") == kind
                    and isinstance(r.get(field), (int, float))]
        # x-axis: the record's own epoch when present (fit tags restart epoch
        # numbering, so fall back to series position for mixed-tag logs).
        epochs = [r.get("epoch") for r in matching]
        use_epoch = (all(isinstance(e, int) for e in epochs)
                     and len(set(epochs)) == len(epochs))
        pts = [(epochs[i] if use_epoch else i, r[field])
               for i, r in enumerate(matching)]
        if not pts:
            return
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot([p[0] for p in pts], [p[1] for p in pts], lw=1.0)
        ax.set_xlabel("epoch" if use_epoch else "event")
        ax.set_ylabel(ylabel)
        ax.set_title(f"{kind}: {field}")
        fig.tight_layout()
        path = os.path.join(out_dir, fname)
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)

    curve("epoch", "train_loss", "train_loss.png", "loss")
    curve("epoch", "test_accuracy", "eval_accuracy.png", "accuracy")
    curve("epoch", "examples_per_s", "throughput.png", "examples/sec")

    # Sweep runs emit one summary per sparsity level: the accuracy-vs-sparsity
    # trade-off curve is the sweep's headline result.
    summaries = [r for r in records if r.get("kind") == "summary"
                 and isinstance(r.get("sparsity"), (int, float))
                 and isinstance(r.get("final_test_accuracy"), (int, float))]
    # Only a real sweep (distinct sparsity levels) gets the trade-off chart,
    # and appended logs keep only the LATEST summary per level — repeated
    # runs would otherwise render run-to-run variance as a sparsity curve.
    latest_per_level: dict[float, float] = {
        r["sparsity"]: r["final_test_accuracy"] for r in summaries}
    sweep_pts = sorted(latest_per_level.items())
    if len(sweep_pts) >= 2:
        method = summaries[-1].get("score_method", "")
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot([p[0] for p in sweep_pts], [p[1] for p in sweep_pts],
                marker="o", lw=1.2)
        ax.set_xlabel("sparsity (fraction of train set dropped)")
        ax.set_ylabel("final test accuracy")
        ax.set_title(f"Accuracy vs sparsity ({method})")
        ax.set_xlim(0, 1)
        fig.tight_layout()
        path = os.path.join(out_dir, "accuracy_vs_sparsity.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)
    return written
