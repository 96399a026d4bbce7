"""NaN/inf loss sentinel: divergence detection with a rollback contract (copy of
``data_diet_distributed_tpu/resilience/sentinel.py``).

A diverged run keeps training and keeps CHECKPOINTING the poisoned state. The
sentinel checks the host-side epoch loss the moment it is aggregated, BEFORE
the epoch's eval and checkpoint, so a diverged state is never made durable,
and raises ``DivergenceError``. Recovery (``fit_with_recovery``) rolls back to
the last good checkpoint and retries with a reduced LR under its own budget
(``resilience.nan_retry_budget`` / ``nan_lr_factor``).

The check reads the loss the epoch record already fetched: no device work.
Across ranks ``check(agree=...)`` takes the consensus OR-reduce, so a NaN on
one rank fails every rank at the same epoch (``remote=True`` on a rank whose
own loss was finite).
"""

from __future__ import annotations

import math


class DivergenceError(RuntimeError):
    """Training loss went NaN/inf; carries where, so the recovery event and
    the rollback target are exact. ``remote=True`` marks an agreed divergence
    on a rank whose own loss was finite."""

    def __init__(self, value: float, epoch: int, tag: str, remote: bool = False):
        self.value = value
        self.epoch = epoch
        self.tag = tag
        self.remote = remote
        where = ("agreed across ranks: a peer reported a non-finite loss; "
                 f"local loss {value!r}" if remote
                 else f"non-finite train loss ({value!r})")
        super().__init__(
            f"{tag}: {where} at epoch {epoch} — divergence; rolling back to the "
            "last good checkpoint with a reduced LR is the recovery path "
            "(resilience.nan_retry_budget)")


class LossSentinel:
    """Per-epoch finiteness gate over the aggregated train loss; ``agree`` (the
    consensus OR-reduce, a collective every rank reaches) makes the verdict
    global."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled

    def check(self, value: float, *, epoch: int, tag: str, agree=None) -> None:
        if not self.enabled:
            return
        bad = not math.isfinite(value)
        if bad:
            # The rank-local verdict, before any agreement: the ring says which
            # rank's own loss was non-finite.
            from ..obs import flightrec
            flightrec.record("divergence_local", tag=tag, epoch=epoch, loss=str(value))
        if agree is not None:
            agreed_bad = agree(bad)
            if agreed_bad and not bad:
                raise DivergenceError(float(value), epoch, tag, remote=True)
            bad = agreed_bad
        if bad:
            raise DivergenceError(float(value), epoch, tag)
