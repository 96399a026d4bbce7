"""Keep-hardest subset selection and its provenance (copy of
``data_diet_distributed_tpu/pruning.py``).

Keeps the top ``int((1 - sparsity) * N)`` examples by score, descending, ties
broken by global index ascending; ``easiest`` and ``random`` are the paper's
ablations, and ``class_balance`` apportions the kept budget per class. Output
is a sorted array of GLOBAL example ids. Each prune decision is recorded in a
JSON sidecar beside the scores npz (``build_prune_manifest``), which the
retrain verifies before it trains (``verify_prune_manifest``).
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from .utils.io import atomic_write_json, provenance_path

#: Schema version of the prune-provenance sidecar.
PRUNE_MANIFEST_VERSION = 1
#: Hardest and easiest examples listed in the sidecar.
MANIFEST_EXTREMES_K = 10


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


def index_digest(ids) -> str:
    """Order-independent digest of a global-id set (sha256 of the sorted int64
    bytes, 16 hex chars)."""
    arr = np.sort(np.asarray(ids, np.int64))
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def build_prune_manifest(scores: np.ndarray, indices: np.ndarray,
                         kept: np.ndarray, *, method: str, sparsity: float,
                         keep: str = "hardest", class_balance: bool = False,
                         seed: int = 0, fingerprint: str | None = None,
                         extremes_k: int = MANIFEST_EXTREMES_K) -> dict:
    """The provenance record of one prune decision: counts, the digests of the
    kept and dropped id sets and of the scores, the decision threshold (None
    for random and class-balanced pruning) and the ``extremes_k`` hardest and
    easiest finite-scored examples."""
    scores = np.asarray(scores)
    indices = np.asarray(indices)
    kept = np.asarray(kept)
    kept_mask = np.isin(indices, kept)
    dropped = np.sort(indices[~kept_mask])
    threshold = None
    if keep in ("hardest", "easiest") and not class_balance and kept_mask.any():
        cut = (scores[kept_mask].min() if keep == "hardest"
               else scores[kept_mask].max())
        threshold = float(cut) if np.isfinite(cut) else None
    finite = np.isfinite(scores)
    hard_order = np.lexsort((indices, np.where(finite, -scores, np.inf)))
    easy_order = np.lexsort((indices, np.where(finite, scores, np.inf)))
    n_finite = int(finite.sum())
    top = [{"index": int(indices[i]), "score": float(scores[i])}
           for i in hard_order[:min(extremes_k, n_finite)]]
    bottom = [{"index": int(indices[i]), "score": float(scores[i])}
              for i in easy_order[:min(extremes_k, n_finite)]]
    return {
        "version": PRUNE_MANIFEST_VERSION,
        "fingerprint": fingerprint,
        "method": method,
        "sparsity": float(sparsity),
        "keep": keep,
        "class_balance": bool(class_balance),
        "seed": int(seed),
        "n_total": int(len(scores)),
        "n_kept": int(len(kept)),
        "n_dropped": int(len(dropped)),
        "nonfinite_scores": int((~finite).sum()),
        "threshold_score": threshold,
        "kept_digest": index_digest(kept),
        "dropped_digest": index_digest(dropped),
        "scores_digest": hashlib.sha256(
            np.ascontiguousarray(np.asarray(scores, np.float32))
            .tobytes()).hexdigest()[:16],
        "top_k": top,
        "bottom_k": bottom,
    }


def write_prune_manifest(npz_path: str, manifest: dict) -> str:
    """Write the sidecar next to the scores npz, atomically; returns its path."""
    path = provenance_path(npz_path)
    atomic_write_json(path, manifest)
    return path


def verify_prune_manifest(npz_path: str, kept: np.ndarray) -> dict:
    """The retrain's audit: ``kept`` must be exactly the set the sidecar
    records, else ``ValueError`` naming both digests. Returns the manifest."""
    path = provenance_path(npz_path)
    with open(path) as fh:
        manifest = json.load(fh)
    got = index_digest(kept)
    want = manifest.get("kept_digest")
    if got != want or int(len(kept)) != manifest.get("n_kept"):
        raise ValueError(
            f"{path}: prune-provenance mismatch: the retrain was handed "
            f"{len(kept)} kept examples (digest {got}) but the manifest records "
            f"n_kept={manifest.get('n_kept')} (digest {want}); recompute the "
            "prune rather than train on an unaudited subset")
    return manifest
