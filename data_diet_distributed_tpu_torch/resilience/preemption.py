"""Preemption handling: SIGTERM/SIGINT -> final checkpoint -> clean exit (copy of
``data_diet_distributed_tpu/resilience/preemption.py``).

Preemptible capacity and wall-clock-limited batch schedulers deliver SIGTERM
with a grace window. The handler turns the signal into a POLLED FLAG: the
training loop checks it between steps, saves a final synchronous checkpoint
and raises ``Preempted``, which recovery deliberately does NOT retry (the
process is being evicted). The CLI maps ``Preempted`` to exit status
``EXIT_PREEMPTED`` so a supervisor can tell "resubmit with train.resume=true"
from a real failure.

Signal handlers can only be installed from the main thread; anywhere else the
handler is an inert no-op (``active`` False): a fit on a worker thread still
trains, it just cannot intercept signals.
"""

from __future__ import annotations

import signal
import threading

#: Exit status of a preemption-triggered clean exit (BSD EX_TEMPFAIL: the
#: failure is transient; resubmit with ``train.resume=true``).
EXIT_PREEMPTED = 75


class Preempted(Exception):
    """Raised by the training loop after a preemption signal was honored.

    Carries where training stopped and which checkpoint step (if any) was made
    durable, so callers can report an exact resume point."""

    def __init__(self, signame: str, step: int | None = None,
                 epoch: int | None = None, durable_step: int | None = None):
        self.signame = signame
        self.step = step
        self.epoch = epoch
        self.durable_step = durable_step
        where = f" at step {step}" if step is not None else ""
        ckpt = (f"; checkpoint durable at step {durable_step}"
                if durable_step is not None else "; no checkpoint saved")
        super().__init__(f"preempted by {signame}{where}{ckpt} — "
                         "resume with train.resume=true")


class PreemptionHandler:
    """Context manager installing flag-setting SIGTERM/SIGINT handlers.

    ``requested`` flips on the first signal; a SECOND delivery of the same
    signal restores the saved handler and re-raises it, so an operator
    repeating Ctrl-C is never trapped behind a slow final checkpoint. Mixed
    signals (a Ctrl-C after a scheduler's SIGTERM) only set the flag. On exit
    the previous handlers are restored.
    """

    def __init__(self, enabled: bool = True,
                 signals: tuple = (signal.SIGTERM, signal.SIGINT)):
        self.enabled = enabled
        self.signals = signals
        self.active = False
        self._requested = threading.Event()
        self._signame: str | None = None
        self._saved: dict = {}
        self._seen: set[int] = set()

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    @property
    def signame(self) -> str:
        return self._signame or "signal"

    def _handle(self, signum, frame):
        if signum in self._seen:
            saved = self._saved.get(signum, signal.SIG_DFL)
            signal.signal(signum, saved)
            signal.raise_signal(signum)
            return
        self._seen.add(signum)
        self._signame = signal.Signals(signum).name
        self._requested.set()

    def __enter__(self) -> "PreemptionHandler":
        if not self.enabled:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self  # signal.signal would raise ValueError; stay inert
        for s in self.signals:
            self._saved[s] = signal.signal(s, self._handle)
        self.active = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.active:
            for s, saved in self._saved.items():
                signal.signal(s, saved)
            self.active = False
        return False
