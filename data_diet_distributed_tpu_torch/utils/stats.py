"""Score-comparison statistics (counterpart of
``data_diet_distributed_tpu/utils/stats.py``): average-rank Spearman rho with
ties, as the score telemetry (``obs/scoreboard.py``) and the parity checks
use it."""

from __future__ import annotations

import numpy as np


def _rank(a: np.ndarray) -> np.ndarray:
    """Average ranks (ties get the mean of their positions), matching the standard
    Spearman definition."""
    order = np.argsort(a, kind="stable")
    ranks = np.empty(len(a), np.float64)
    ranks[order] = np.arange(len(a), dtype=np.float64)
    # average tied groups
    sorted_vals = a[order]
    i = 0
    while i < len(a):
        j = i
        while j + 1 < len(a) and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64) - np.mean(a)
    b = np.asarray(b, np.float64) - np.mean(b)
    denom = np.sqrt(np.sum(a * a) * np.sum(b * b))
    return float(np.sum(a * b) / denom) if denom > 0 else 0.0


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation with proper tie handling."""
    if len(a) != len(b):
        raise ValueError("arrays must align")
    return pearson(_rank(np.asarray(a)), _rank(np.asarray(b)))
