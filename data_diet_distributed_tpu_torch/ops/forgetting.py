"""Trajectory score trackers (counterpart of ``data_diet_distributed_tpu/ops/forgetting.py``).

Forgetting events (Toneva et al. 2019): a forgetting event for example ``i``
is a transition from classified correctly at one observation to
misclassified at the next; examples with few events can be dropped with
least damage, and never-learned ones rank hardest. Area under the margin
(Pleiss et al. 2020): the mean probability margin over the trajectory. Both
accumulate on the host, in numpy, from one ``[N]`` vector per epoch (the
correctness or margin pass of ``train/loop.py::trajectory_scores``).
"""

from __future__ import annotations

import numpy as np


class ForgettingTracker:
    """Accumulates forgetting events from one correctness vector per epoch.

    ``update`` is called once per observation (epoch) with ``correct[N]`` in
    dataset row order; ``scores`` returns the per-example event counts with
    never-learned examples pinned above every possible count.
    """

    def __init__(self, n: int):
        self.counts = np.zeros(n, np.int64)
        self.prev = np.zeros(n, bool)
        self.learned = np.zeros(n, bool)
        self.updates = 0

    def update(self, correct: np.ndarray) -> None:
        correct = np.asarray(correct, dtype=bool)
        if correct.shape != self.prev.shape:
            raise ValueError(
                f"correctness vector has shape {correct.shape}, expected "
                f"{self.prev.shape}")
        self.counts += self.prev & ~correct
        self.learned |= correct
        self.prev = correct
        self.updates += 1

    def scores(self) -> np.ndarray:
        """[N] float32 — event counts; never-learned = ``updates + 1`` (strictly
        above any achievable count, so keep-hardest retains them first)."""
        out = self.counts.astype(np.float32)
        out[~self.learned] = float(self.updates + 1)
        return out


class AUMTracker:
    """Average probability margin across the training trajectory — the
    area-under-the-margin identification score (Pleiss et al. 2020, "Identifying
    Mislabeled Data using the Area Under the Margin Ranking"), accumulated from
    the same per-epoch observations as ``ForgettingTracker``.

    Sign convention matches the framework's one-checkpoint ``margin`` method
    (``ops/scores.margin_from_logits``): each observation is
    ``max_{k≠y} p_k − p_y``, so HIGHER average = harder/likely-mislabeled and
    keep-hardest pruning composes unchanged. (The paper's logit-margin AUM is
    this quantity's sign-flip in logit space; the probability form keeps one
    margin definition across the framework.)
    """

    def __init__(self, n: int):
        self.total = np.zeros(n, np.float64)
        self.updates = 0

    def update(self, margin: np.ndarray) -> None:
        margin = np.asarray(margin, np.float64)
        if margin.shape != self.total.shape:
            raise ValueError(
                f"margin vector has shape {margin.shape}, expected "
                f"{self.total.shape}")
        self.total += margin
        self.updates += 1

    def scores(self) -> np.ndarray:
        """[N] float32 — mean margin over the observed epochs."""
        return (self.total / max(1, self.updates)).astype(np.float32)
