"""Heartbeat watchdog and bounded device-init probe (counterpart of
``data_diet_distributed_tpu/resilience/watchdog.py``).

Both turn a SILENT HANG into a loud, retriable failure:

* ``probe_devices`` initializes CUDA through ``torch`` in a KILLABLE
  SUBPROCESS with a bounded timeout and retry with exponential backoff. An
  in-process hang in native code cannot be timed out; a subprocess can always
  be killed.
* ``Watchdog`` guards an in-process section with a heartbeat deadline: the
  guarded loop calls ``beat()`` on each unit of progress, and a monitor thread
  that sees the deadline pass sends SIGUSR1 to the main thread
  (``signal.pthread_kill``), whose handler (installed for the guard's
  duration) raises ``WatchdogTimeout``, an ordinary exception that
  ``fit_with_recovery`` retries. A dedicated signal, not SIGINT: the
  preemption handler turns SIGINT into a flag, and the interrupted wait would
  resume (PEP 475).

Limits. A raising signal handler runs at the next Python bytecode boundary,
so it reaches host-side stalls only: a sleep, a lock or queue wait, a data
pipeline that stopped producing. A main thread blocked inside a CUDA call
(the epoch-end ``_fetch``, an ``.item()``, a ``.cpu()`` copy, a
``torch.cuda.synchronize``) runs no Python until that call returns, so a hang
on the device is seen only once the call comes back, or never; that class is
what the subprocess probe, or a supervisor's wall-clock limit, is for. The
injected hang (``inject.FaultPlan.hang_at``) is a ``time.sleep``, which the
handler does reach, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

#: Exit status of a retriable failure before any work (EX_UNAVAILABLE): the
#: CLI's answer to a failed ``probe_devices``, and the watchdog's default
#: ``escalate_code``.
EXIT_RETRIABLE = 69


class WatchdogTimeout(RuntimeError):
    """A guarded section missed its heartbeat deadline. Subclasses
    ``RuntimeError`` so restart-based recovery retries it like a raised step
    failure."""


class Watchdog:
    """Heartbeat deadline over a code section, entered from the MAIN thread.

    Usage::

        with Watchdog(timeout_s=120, label="train_step") as wd:
            for batch in batches:
                wd.beat()          # progress -> push the deadline out
                step(batch)        # a host-side hang here raises WatchdogTimeout

    The monitor thread polls at timeout/10, bounded to [50 ms, 1 s].
    """

    #: Signal owned by the watchdog while a guard is active.
    SIGNAL = signal.SIGUSR1

    def __init__(self, timeout_s: float, label: str = "section", *,
                 escalate_s: float | None = None,
                 escalate_code: int = EXIT_RETRIABLE):
        """``escalate_s``: after firing, if the guarded section is still
        running this much later (the main thread is stuck in a native call the
        handler cannot reach), ``os._exit(escalate_code)``. None = never. The
        JAX package's consensus hooks (``on_fire``, ``peer_check``,
        ``diagnose``) wait for the multi-host port."""
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.label = label
        self._escalate_s = escalate_s
        self._escalate_code = escalate_code
        self._poll_s = max(0.05, min(1.0, self.timeout_s / 10.0))
        self._deadline = 0.0
        self._fired = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._saved = None

    @property
    def fired(self) -> bool:
        return self._fired

    def beat(self) -> None:
        self._deadline = time.monotonic() + self.timeout_s

    def suspend(self) -> None:
        """Push the deadline out indefinitely, for a section that may block
        longer than any step deadline: the preemption path's final synchronous
        checkpoint, where a firing would turn the clean ``Preempted`` exit into
        a retriable timeout on a host that is being evicted."""
        self._deadline = float("inf")

    def _timeout_error(self) -> WatchdogTimeout:
        return WatchdogTimeout(f"{self.label}: no heartbeat within {self.timeout_s:g}s "
                               "(silent hang converted to a retriable failure)")

    def _on_signal(self, signum, frame):
        raise self._timeout_error()

    def _watch(self) -> None:
        while not self._stop.wait(self._poll_s):
            if time.monotonic() <= self._deadline:
                continue
            self._fired = True
            # To the MAIN thread: raise_signal would deliver to this thread and
            # leave the main thread's blocking call (sleep, lock) running.
            signal.pthread_kill(threading.main_thread().ident, self.SIGNAL)
            if self._escalate_s is not None and not self._stop.wait(self._escalate_s):
                os._exit(self._escalate_code)
            return

    def __enter__(self) -> "Watchdog":
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("Watchdog must be entered from the main thread")
        self._saved = signal.signal(self.SIGNAL, self._on_signal)
        self.beat()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name=f"watchdog:{self.label}")
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        if self._fired and not isinstance(exc, WatchdogTimeout):
            # Fired, but the raise has not surfaced in the main thread yet.
            # Drain it while OUR handler is still installed: restoring first
            # could hand a pending SIGUSR1 to SIG_DFL, which kills the process.
            deadline = time.monotonic() + 10 * self._poll_s
            try:
                while time.monotonic() < deadline:
                    time.sleep(self._poll_s / 10)
            except WatchdogTimeout:
                pass
        signal.signal(self.SIGNAL, self._saved)
        if self._fired and exc_type is None:
            raise self._timeout_error() from None
        return False


PROBE_SNIPPET = (
    "import json, torch; torch.cuda.init(); n = torch.cuda.device_count(); "
    "print(json.dumps({'n': n, 'platform': 'cuda', "
    "'kind': torch.cuda.get_device_name(0)}))"
)

#: Operator-supplied reset command (shell), run between timed-out probes.
CLAIM_RESET_CMD_ENV = "DDT_CLAIM_RESET_CMD"


def reset_claim(timeout_s: float = 30.0) -> bool:
    """Best-effort device reset between probe attempts: ``DDT_CLAIM_RESET_CMD``
    when set (bounded), else one more short probe child whose point is a clean
    init and exit. Returns whether the reset itself completed in budget; the
    next probe is the real verdict."""
    cmd = os.environ.get(CLAIM_RESET_CMD_ENV)
    try:
        if cmd:
            return subprocess.run(cmd, shell=True, capture_output=True,
                                  timeout=timeout_s).returncode == 0
        return subprocess.run([sys.executable, "-c", PROBE_SNIPPET], capture_output=True,
                               timeout=timeout_s).returncode == 0
    except subprocess.TimeoutExpired:
        return False


def probe_devices(attempts: int = 3, timeout_s: float = 150.0,
                  backoff_s: float = 20.0, on_retry=None) -> dict:
    """Check that CUDA initializes in a bounded subprocess.

    Returns the probe's dict (``{"n", "platform", "kind"}``) on success, or a
    dict with an ``"error"`` key after ``attempts`` tries; either way with
    ``attempts``, ``wall_s`` and ``resets``. Retries back off exponentially
    (``backoff_s``, ``2*backoff_s``, ...); after a TIMED-OUT attempt a
    ``reset_claim`` runs before the next. ``on_retry(attempt, error)`` is
    called before each back-off sleep. A crashed child's last stderr line is
    the reported error."""
    t0 = time.monotonic()
    last_err = "unknown"
    resets = 0
    attempt = 0

    def _info(base: dict) -> dict:
        base.update(attempts=attempt + 1, resets=resets,
                    wall_s=round(time.monotonic() - t0, 3))
        return base

    for attempt in range(attempts):
        if attempt:
            if on_retry is not None:
                on_retry(attempt, last_err)
            time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            proc = subprocess.run([sys.executable, "-c", PROBE_SNIPPET], capture_output=True,
                                  text=True, timeout=timeout_s)
        except subprocess.TimeoutExpired:
            last_err = f"device probe hung >{timeout_s:.0f}s (device-init wedge)"
            if attempt + 1 < attempts:
                resets += 1
                reset_claim(max(1.0, timeout_s / 5.0))
            continue
        if proc.returncode == 0:
            try:
                return _info(json.loads(proc.stdout.strip().splitlines()[-1]))
            except (ValueError, IndexError):
                last_err = f"probe emitted unparseable output: {proc.stdout[-200:]}"
                continue
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()
        last_err = tail[-1][:300] if tail else f"probe rc={proc.returncode}"
    return _info({"error": f"device init failed after {attempts} attempts: {last_err}"})
