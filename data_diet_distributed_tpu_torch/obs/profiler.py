"""``torch.profiler`` captures (counterpart of
``data_diet_distributed_tpu/obs/profiler.py``).

``trace(profile_dir)`` profiles a whole region. ``ProfileWindow`` is the
automatic version the epoch loop wires from ``obs.profile_dir``: instead of
a whole run (the warm-up epoch drowning the steady state), it captures
``obs.profile_window_chunks`` dispatches of the first steady epoch of each
pipeline stage, one capture per stage tag and process (``fit`` drops a seed
suffix from its tag, so a multi-seed pretrain is one stage, ``score_pretrain``,
where the JAX package spends a capture per seed). The JAX package's unit
is a chunk dispatch of its chunked engine; the port runs the per-step path,
so here a dispatch is one training step, and in a scoring pass one scoring
batch (the pass's seeds play the epochs: with several seeds the second is
captured, with one its batches after the first). An epoch or seed that held
a capture is left out of the MFU (``train/loop.py``): its wall holds the
capture and its export.

A capture is ``torch.profiler.profile`` over the CPU and, on a CUDA device,
the CUDA activities (CUPTI: the hand-written kernels appear by name beside
cuDNN's), written with ``export_chrome_trace`` to
``<profile_dir>/<tag>/trace.json``. Each capture leaves a
``profile_capture`` flight-recorder entry with its path and the count of
device-kernel events it holds (null when the run is not on CUDA, or when a
CUDA capture holds none: no CPU number is reported under a device name).

``percentile`` and ``StepTimer`` (wall-clock step timing with warm-up
discard) are the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import re

from . import flightrec
from .registry import percentile

__all__ = ["trace", "ProfileWindow", "StepTimer", "percentile", "count_device_events"]


def _activities(device_type: str) -> list:
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def count_device_events(prof) -> int:
    """Kernel events on the device in a finished ``torch.profiler`` run."""
    from torch.autograd import DeviceType
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def _export(prof, directory: str, device_type: str, tag: str) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    n = count_device_events(prof) if device_type == "cuda" else 0
    flightrec.record("profile_capture", tag=tag, path=path,
                     device_events=n if n > 0 else None)
    return path


def _start_capture(device_type: str):
    """Start a ``torch.profiler`` capture; returns its handle."""
    import torch
    prof = torch.profiler.profile(activities=_activities(device_type))
    prof.start()
    return prof


def _stop_capture(prof, directory: str, device_type: str, tag: str) -> str:
    """Stop a capture (after the device's queued work) and export it."""
    if device_type == "cuda":
        import torch
        torch.cuda.synchronize()   # the window's kernels end inside it
    prof.stop()
    return _export(prof, directory, device_type, tag)


@contextlib.contextmanager
def trace(profile_dir: str | None, device_type: str = "cuda"):
    """Profile the body into ``<profile_dir>/trace.json`` (no-op when
    ``profile_dir`` is falsy)."""
    if not profile_dir:
        yield
        return
    import torch
    with torch.profiler.profile(activities=_activities(device_type)) as prof:
        yield
    _export(prof, profile_dir, device_type, "trace")


class ProfileWindow:
    """Steady-state ``torch.profiler`` window over one fit's steps (or one
    scoring pass's batches).

    The loop calls ``tick(epoch)`` before each dispatch and
    ``epoch_end(epoch)`` / ``close()`` on the way out. The window targets the
    first epoch past the warm-up one (``start_epoch + 1``; a single-epoch fit
    captures epoch 0 but skips its first dispatch), starts the profiler at the
    target's first eligible tick, and stops after ``window_chunks``
    dispatches.

    Process-wide guards (class state, cleared by ``reset()``): one capture
    per stage tag, at most ``MAX_CAPTURES`` in all, never two at once."""

    MAX_CAPTURES = 4
    _captured_tags: set[str] = set()
    _active: "ProfileWindow | None" = None

    def __init__(self, profile_dir: str, tag: str, *, start_epoch: int,
                 num_epochs: int, window_chunks: int = 8, device_type: str = "cuda"):
        self.dir = os.path.join(profile_dir,
                                re.sub(r"[^a-zA-Z0-9_.-]", "_", tag) or "run")
        self.tag = tag
        self.device_type = device_type
        self.window_chunks = max(1, int(window_chunks))
        single = num_epochs - start_epoch <= 1
        self.target_epoch = start_epoch if single else start_epoch + 1
        self._skip = 1 if single else 0   # a single epoch's first dispatch warms up
        self._started = False
        self._done = tag in ProfileWindow._captured_tags
        self._ticks = 0
        self._prof = None
        self.path: str | None = None
        self.captured_epoch: int | None = None   # the epoch a capture started in

    @classmethod
    def reset(cls) -> None:
        """Clear the process-wide bookkeeping (a new session); stop first, so
        an active window cannot re-add its tag to the fresh set."""
        if cls._active is not None:
            cls._active._stop()
        cls._captured_tags = set()

    def tick(self, epoch: int) -> None:
        if self._done or epoch != self.target_epoch:
            return
        if not self._started:
            if self._ticks < self._skip:
                self._ticks += 1
                return
            if (ProfileWindow._active is not None
                    or len(ProfileWindow._captured_tags) >= ProfileWindow.MAX_CAPTURES):
                self._done = True   # another capture is open, or the budget is spent
                return
            try:
                self._prof = _start_capture(self.device_type)
            except Exception:   # noqa: BLE001 — profiling must not kill the run
                self._prof = None
                self._done = True
                ProfileWindow._captured_tags.add(self.tag)
                return
            ProfileWindow._active = self
            self._started = True
            self.captured_epoch = epoch
            self._ticks = 0
            return
        self._ticks += 1
        if self._ticks >= self.window_chunks:
            self._stop()

    def epoch_end(self, epoch: int) -> None:
        if self._started and epoch == self.target_epoch:
            self._stop()

    def close(self) -> None:
        self._stop()

    def _stop(self) -> None:
        if self._started:
            self._started = False
            try:
                self.path = _stop_capture(self._prof, self.dir, self.device_type,
                                          self.tag)
            except Exception as exc:   # noqa: BLE001
                flightrec.record("profile_capture", tag=self.tag, path=None,
                                 device_events=None, error=repr(exc)[:200])
            self._prof = None
        if ProfileWindow._active is self:
            ProfileWindow._active = None
        if not self._done:
            self._done = True
            ProfileWindow._captured_tags.add(self.tag)


class StepTimer:
    """Wall-clock per-step timing with warm-up discard: mean, p50, p95, max
    and the retained sample count (``summary()``; NaN becomes None)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._count = 0

    def record(self, seconds: float) -> None:
        self._count += 1
        if self._count > self.warmup:
            self.times.append(seconds)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def count(self) -> int:
        return len(self.times)

    @property
    def p50(self) -> float:
        return percentile(self.times, 0.50)

    @property
    def p95(self) -> float:
        return percentile(self.times, 0.95)

    @property
    def max(self) -> float:
        return max(self.times) if self.times else float("nan")

    def summary(self, digits: int = 6) -> dict:
        def _r(v: float):
            return round(v, digits) if v == v else None

        return {"mean": _r(self.mean), "p50": _r(self.p50),
                "p95": _r(self.p95), "max": _r(self.max), "count": self.count}
