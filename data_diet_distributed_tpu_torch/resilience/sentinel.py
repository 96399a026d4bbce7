"""NaN/inf loss sentinel: divergence detection with a rollback contract (copy of
``data_diet_distributed_tpu/resilience/sentinel.py``).

A diverged run keeps training and keeps CHECKPOINTING the poisoned state. The
sentinel checks the host-side epoch loss the moment it is aggregated, BEFORE
the epoch's eval and checkpoint, so a diverged state is never made durable,
and raises ``DivergenceError``. Recovery (``fit_with_recovery``) rolls back to
the last good checkpoint and retries with a reduced LR under its own budget
(``resilience.nan_retry_budget`` / ``nan_lr_factor``).

The check reads the loss the epoch record already fetched: no device work.
Single process: the JAX package's ``agree=`` argument (a verdict OR-reduced
across hosts) is dropped, so ``check`` decides on the local loss alone.
"""

from __future__ import annotations

import math


class DivergenceError(RuntimeError):
    """Training loss went NaN/inf; carries where, so the recovery event and
    the rollback target are exact."""

    def __init__(self, value: float, epoch: int, tag: str):
        self.value = value
        self.epoch = epoch
        self.tag = tag
        super().__init__(
            f"{tag}: non-finite train loss ({value!r}) at epoch {epoch} — "
            "divergence; rolling back to the last good checkpoint with a reduced "
            "LR is the recovery path (resilience.nan_retry_budget)")


class LossSentinel:
    """Per-epoch finiteness gate over the aggregated train loss."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled

    def check(self, value: float, *, epoch: int, tag: str) -> None:
        if self.enabled and not math.isfinite(value):
            raise DivergenceError(float(value), epoch, tag)
