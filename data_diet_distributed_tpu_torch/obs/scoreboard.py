"""Score telemetry and cross-seed rank stability (counterpart of
``data_diet_distributed_tpu/obs/scoreboard.py``).

Host math over score vectors the pipeline has already fetched, once per
completed seed pass (no device work, nothing per step):

* ``{"kind": "score_stats"}``: one per (method, seed) pass: moments,
  percentiles, a bounded fixed-bin histogram, NaN/inf counts, mirrored into
  ``score_*`` gauges;
* ``{"kind": "score_stability"}``: after a multi-seed pass: pairwise
  Spearman rho between seeds, each seed against the mean vector, and the
  overlap@k of the keep-hardest top-k sets at the run's keep fractions; its
  headline numbers go into ``run_summary.score_stability``.

The module-level helpers are no-ops until a ``Scoreboard`` is installed
(``ObsSession`` installs one under ``obs.score_telemetry``). Imports no
torch.
"""

from __future__ import annotations

import numpy as np

from . import registry as obs_registry
from ..utils.stats import _rank, pearson

__all__ = ["Scoreboard", "score_stats", "rank_stability", "top_k_positions",
           "overlap_at_k", "install", "uninstall", "current",
           "note_seed_scores", "note_stability", "summary",
           "DEFAULT_HIST_BINS", "MAX_RETAINED_SEEDS"]

#: Fixed bin count for the score-distribution histogram embedded in each
#: ``score_stats`` record — bounded by construction (the record must stay a
#: few hundred bytes no matter the dataset size), computed over the finite
#: values' observed range.
DEFAULT_HIST_BINS = 32

#: Hard cap on per-seed vectors a Scoreboard retains for the stability pass:
#: the paper's protocol is ~10 seeds; 64 × a 50k float32 vector is ~13 MB —
#: a generous bound that still can't grow without limit under a pathological
#: seed list. Overflow drops the newest vector from stability (stats still
#: emit) and is recorded in the stability record's ``dropped_seeds``.
MAX_RETAINED_SEEDS = 64


def _finite_or_none(v) -> float | None:
    """Record fields must be strict-JSON safe: NaN/inf become null (the
    validator and every stream consumer parse strictly)."""
    v = float(v)
    return v if np.isfinite(v) else None


def score_stats(scores, bins: int = DEFAULT_HIST_BINS) -> dict:
    """Host-side distribution summary of one score vector.

    Moments and percentiles are computed over the FINITE values only, with
    the non-finite counts reported separately — a single NaN must show up as
    ``nan_count=1``, not poison every statistic into null. An all-non-finite
    vector degrades to null stats (keys present, values None), never raises.
    """
    a = np.asarray(scores, np.float64).ravel()
    finite = a[np.isfinite(a)]
    out: dict = {"n": int(a.size),
                 "nan_count": int(np.isnan(a).sum()),
                 "inf_count": int(np.isinf(a).sum())}
    if finite.size == 0:
        out.update(mean=None, std=None, min=None, max=None,
                   p5=None, p50=None, p95=None, hist=None)
        return out
    p5, p50, p95 = np.percentile(finite, [5.0, 50.0, 95.0])
    counts, edges = np.histogram(finite, bins=bins)
    out.update(mean=_finite_or_none(finite.mean()),
               std=_finite_or_none(finite.std()),
               min=_finite_or_none(finite.min()),
               max=_finite_or_none(finite.max()),
               p5=_finite_or_none(p5), p50=_finite_or_none(p50),
               p95=_finite_or_none(p95),
               hist={"edges": [float(e) for e in edges],
                     "counts": [int(c) for c in counts]})
    return out


def top_k_positions(scores, k: int) -> np.ndarray:
    """Positions of the ``k`` highest scores, deterministic tie-break by
    position — the same (score desc, id asc) ordering ``pruning._choose``
    uses, so overlap@k measures the sets a keep-hardest prune would keep.
    Non-finite scores sort LAST (they are never 'hardest')."""
    a = np.asarray(scores, np.float64).copy()
    a[~np.isfinite(a)] = -np.inf
    return np.lexsort((np.arange(len(a)), -a))[:k]


def overlap_at_k(a, b, k: int) -> float | None:
    """|top-k(a) ∩ top-k(b)| / k — the fraction of the kept set two score
    vectors agree on at keep size ``k``."""
    if k <= 0:
        return None
    ka = set(top_k_positions(a, k).tolist())
    kb = set(top_k_positions(b, k).tolist())
    return len(ka & kb) / float(k)


def rank_stability(seed_scores: dict[int, np.ndarray],
                   keep_fractions=(0.5,)) -> dict | None:
    """Cross-seed rank-agreement statistics from per-seed score vectors.

    Returns None with fewer than two seeds. ``spearman_pairwise`` is the
    full symmetric ρ matrix (seed order = sorted seed ids — small: n_seeds²
    floats); ``spearman_vs_mean`` correlates each seed against the mean
    score vector (the vector pruning actually consumes); ``overlap_at_keep``
    maps each keep fraction to the mean pairwise overlap@k of the
    keep-hardest top-k sets (k = int(frac * n), matching
    ``pruning.num_kept``'s truncation).
    """
    seeds = sorted(seed_scores)
    if len(seeds) < 2:
        return None
    vecs = [np.asarray(seed_scores[s], np.float64) for s in seeds]
    n = len(vecs[0])
    m = len(seeds)
    # Rank each vector ONCE (the tie-averaging rank is the expensive part);
    # every pairwise ρ is then a cheap Pearson on ranks — O(m) ranks instead
    # of O(m²), same result as utils.stats.spearman by definition.
    ranks = [_rank(v) for v in vecs]
    rho = np.ones((m, m))
    for i in range(m):
        for j in range(i + 1, m):
            rho[i, j] = rho[j, i] = pearson(ranks[i], ranks[j])
    off = rho[~np.eye(m, dtype=bool)]
    mean_vec = np.mean(np.stack(vecs), axis=0)
    mean_rank = _rank(mean_vec)
    vs_mean = [pearson(mean_rank, r) for r in ranks]
    overlap: dict[str, float | None] = {}
    for frac in keep_fractions:
        k = int(float(frac) * n)
        if k <= 0:
            overlap[f"{float(frac):g}"] = None
            continue
        # Top-k sets computed once per seed, compared pairwise.
        tops = [set(top_k_positions(v, k).tolist()) for v in vecs]
        pair_overlaps = [len(tops[i] & tops[j]) / float(k)
                         for i in range(m) for j in range(i + 1, m)]
        overlap[f"{float(frac):g}"] = round(
            float(np.mean(pair_overlaps)), 6)
    return {
        "seeds": [int(s) for s in seeds],
        "n_seeds": m,
        "n": int(n),
        "spearman_pairwise": [[_finite_or_none(round(v, 6)) for v in row]
                              for row in rho],
        "spearman_pairwise_mean": _finite_or_none(round(float(off.mean()), 6)),
        "spearman_pairwise_min": _finite_or_none(round(float(off.min()), 6)),
        "spearman_vs_mean": [_finite_or_none(round(v, 6)) for v in vs_mean],
        "spearman_vs_mean_mean": _finite_or_none(
            round(float(np.mean(vs_mean)), 6)),
        "overlap_at_keep": overlap,
    }


class Scoreboard:
    """Per-run score telemetry: collects one stats record per (method, seed)
    pass, retains the per-seed vectors (bounded), and computes the
    cross-seed stability block once a method's multi-seed pass completes.

    ``logger`` (a MetricsLogger, or None) receives the JSONL records; the
    registry gauges land through the module-level registry slot either way.
    """

    def __init__(self, logger=None, bins: int = DEFAULT_HIST_BINS,
                 max_seeds: int = MAX_RETAINED_SEEDS):
        self.logger = logger
        self.bins = int(bins)
        self.max_seeds = int(max_seeds)
        self._seed_scores: dict[str, dict[int, np.ndarray]] = {}
        self._dropped: dict[str, list[int]] = {}
        self._stability: dict[str, dict] = {}

    # ------------------------------------------------------------- telemetry

    def note_seed_scores(self, method: str, seed: int, scores, *,
                         resumed: bool = False) -> dict:
        """One completed seed pass: emit its ``score_stats`` record, refresh
        the ``score_*`` gauges, and retain the vector for the stability pass.
        Stats math is O(n log n) host work per SEED (percentiles/histogram
        on the already-fetched array) — never on a step hot path."""
        stats = score_stats(scores, self.bins)
        retained = self._seed_scores.setdefault(method, {})
        if len(retained) < self.max_seeds:
            # float32 copy: exact for the f32 scores the engines produce,
            # half the retention footprint for the f64 partials.
            retained[int(seed)] = np.asarray(scores, np.float32).copy()
        else:
            self._dropped.setdefault(method, []).append(int(seed))
        for key, field in (("mean", "mean"), ("std", "std"), ("p95", "p95")):
            if stats[field] is not None:
                obs_registry.set_gauge(f"score_{key}:{method}", stats[field])
        obs_registry.set_gauge(f"score_nonfinite:{method}",
                               stats["nan_count"] + stats["inf_count"])
        obs_registry.inc("score_seed_passes")
        if self.logger is not None:
            self.logger.log("score_stats", method=method, seed=int(seed),
                            resumed=bool(resumed), **stats)
        return stats

    def note_stability(self, method: str, keep_fractions=(0.5,)) -> dict | None:
        """Compute + emit the cross-seed stability block for ``method`` from
        the retained per-seed vectors (None when fewer than two seeds were
        noted — single-seed scoring has no cross-seed statistic)."""
        stab = rank_stability(self._seed_scores.get(method, {}),
                              keep_fractions)
        if stab is None:
            return None
        dropped = self._dropped.get(method)
        if dropped:
            # No silent caps: seeds past the retention bound are named, so
            # the stability block can never quietly describe a subset.
            stab["dropped_seeds"] = sorted(dropped)
        self._stability[method] = stab
        if stab["spearman_pairwise_mean"] is not None:
            obs_registry.set_gauge(f"score_stability_rho:{method}",
                                   stab["spearman_pairwise_mean"])
        for frac, ov in stab["overlap_at_keep"].items():
            if ov is not None:
                obs_registry.set_gauge(f"score_overlap:{method}:{frac}", ov)
        if self.logger is not None:
            self.logger.log("score_stability", method=method, **stab)
        return stab

    # --------------------------------------------------------------- summary

    def summary(self) -> dict:
        """Compact per-method stability block for the terminal
        ``run_summary`` event (matrix elided — the full record is in the
        stream; the summary carries the headline numbers a parity sentence
        would cite)."""
        return {method: {k: stab[k] for k in
                         ("n_seeds", "spearman_pairwise_mean",
                          "spearman_pairwise_min", "spearman_vs_mean_mean",
                          "overlap_at_keep")}
                for method, stab in self._stability.items()}

    def seed_stats(self, method: str) -> dict[int, np.ndarray]:
        """The retained per-seed vectors (read-only use: bench embedding)."""
        return dict(self._seed_scores.get(method, {}))


# --------------------------------------------------------- module-level slot

_SCOREBOARD: Scoreboard | None = None


def install(board: Scoreboard) -> Scoreboard:
    global _SCOREBOARD
    _SCOREBOARD = board
    return board


def uninstall() -> None:
    global _SCOREBOARD
    _SCOREBOARD = None


def current() -> Scoreboard | None:
    return _SCOREBOARD


def note_seed_scores(method: str, seed: int, scores, *,
                     resumed: bool = False) -> None:
    if _SCOREBOARD is not None:
        _SCOREBOARD.note_seed_scores(method, seed, scores, resumed=resumed)


def note_stability(method: str, keep_fractions=(0.5,)) -> None:
    if _SCOREBOARD is not None:
        _SCOREBOARD.note_stability(method, keep_fractions)


def summary() -> dict:
    return _SCOREBOARD.summary() if _SCOREBOARD is not None else {}
