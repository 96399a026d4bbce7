"""Keep-hardest subset selection (copy of ``data_diet_distributed_tpu/pruning.py:25-100``).

Keeps the top ``int((1 - sparsity) * N)`` examples by score, descending, ties
broken by global index ascending; ``easiest`` and ``random`` are the paper's
ablations, and ``class_balance`` apportions the kept budget per class. Output
is a sorted array of GLOBAL example ids.
"""

from __future__ import annotations

import numpy as np


def num_kept(n: int, sparsity: float) -> int:
    return int((1.0 - sparsity) * n)


def _choose(scores: np.ndarray, indices: np.ndarray, k: int, keep: str,
            rng: np.random.Generator) -> np.ndarray:
    """Positions of the ``k`` selected rows under the given policy."""
    if keep == "random":
        return rng.permutation(len(scores))[:k]
    key = -scores if keep == "hardest" else scores
    # lexsort: primary = score direction, secondary = global index
    return np.lexsort((indices, key))[:k]


def _class_quotas(labels: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-class kept budgets summing exactly to ``k``, proportional to class
    frequency (largest-remainder apportionment; ties broken by class id)."""
    classes, counts = np.unique(labels, return_counts=True)
    quotas = counts * (k / len(labels))
    base = np.floor(quotas).astype(np.int64)
    frac_order = np.lexsort((classes, -(quotas - base)))
    base[frac_order[:k - int(base.sum())]] += 1
    if int(base.sum()) != k or (base > counts).any():
        raise AssertionError("class quotas do not apportion the kept budget")
    return classes, base


def select_indices(scores: np.ndarray, indices: np.ndarray, sparsity: float,
                   keep: str = "hardest", seed: int = 0,
                   labels: np.ndarray | None = None,
                   class_balance: bool = False) -> np.ndarray:
    """Global ids of the kept subset, sorted ascending. ``scores[i]`` belongs
    to example ``indices[i]``; ``sparsity`` is the fraction DROPPED."""
    if len(scores) != len(indices):
        raise ValueError("scores and indices must align")
    if keep not in ("hardest", "easiest", "random"):
        raise ValueError(f"unknown keep policy {keep!r}")
    n = len(scores)
    k = num_kept(n, sparsity)
    rng = np.random.default_rng(seed)
    if class_balance:
        if labels is None or len(labels) != n:
            raise ValueError("class_balance=True needs labels aligned with scores")
        labels = np.asarray(labels)
        chosen_parts = []
        for cls, kc in zip(*_class_quotas(labels, k)):
            rows = np.flatnonzero(labels == cls)
            chosen_parts.append(rows[_choose(scores[rows], indices[rows],
                                             int(kc), keep, rng)])
        chosen = (np.concatenate(chosen_parts) if chosen_parts
                  else np.empty(0, np.int64))
    else:
        chosen = _choose(scores, indices, k, keep, rng)
    kept = np.sort(indices[chosen])
    if len(kept) != k:
        raise AssertionError(f"kept {len(kept)} examples, expected {k}")
    return kept
