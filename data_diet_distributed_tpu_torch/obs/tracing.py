"""Nested trace spans as a Chrome-trace / Perfetto JSON array (counterpart
of ``data_diet_distributed_tpu/obs/tracing.py``).

Every pipeline layer wraps its unit of work in a ``span``: run -> stage
(``score``, ``prune:<tag>``, ``retrain:<tag>``, ``dense:final``) -> seed ->
fit -> epoch -> eval, plus ``checkpoint_save`` / ``checkpoint_restore``. Each
span is one complete event (``"ph": "X"``), so ``chrome://tracing`` or
https://ui.perfetto.dev shows the pipeline as a flame chart and
``tools/trace_report.py`` summarizes it. The JAX package's per-chunk
``chunk`` span has no counterpart: the port runs the per-step path.

* The file is a bare JSON array streamed one event per line (the Chrome
  format tolerates a missing ``]``), so a killed run's trace still opens;
  ``close()`` terminates it.
* ``ts``/``dur`` are microseconds: ``ts`` from the wall clock, so traces of
  different ranks align, ``dur`` from the monotonic clock.
* ``pid`` is the rank, ``tid`` a small per-thread ordinal.

The module-level ``span``/``instant``/``complete`` are no-ops until a
``Tracer`` is installed. Device-op timing is ``torch.profiler``'s
(``obs/profiler.py``); spans stay pipeline-grained. Imports no torch.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import socket
import threading
import time
from typing import IO

from . import lineage

__all__ = ["Tracer", "span", "instant", "install", "uninstall", "current",
           "trace_path_for", "discover_traces", "trace_coords"]


def trace_path_for(base: str, rank: int, attempt: int = 0) -> str:
    """Per-(attempt, rank) trace file path: attempt 0 / rank 0 keeps
    ``base`` (the common single-process case stays ``trace.json``); other
    coordinates get ``_a<attempt>`` / ``_rank<k>`` suffixes so neither
    multi-host ranks nor elastic relaunches ever clobber each other —
    the crashed attempt's trace is postmortem evidence."""
    suffix = lineage.attempt_suffix(attempt)
    if rank != 0:
        suffix += f"_rank{rank}"
    if not suffix:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}{suffix}{ext or '.json'}"


_COORD_RE = re.compile(r"^(?:_a(\d+))?(?:_rank(\d+))?$")


def trace_coords(base: str, path: str) -> tuple[int, int] | None:
    """``(attempt, rank)`` encoded in a trace filename relative to ``base``
    (the reverse of ``trace_path_for``), or None when ``path`` is not one of
    base's per-(attempt, rank) variants."""
    root, ext = os.path.splitext(base)
    stem = os.path.splitext(path)[0]
    if not stem.startswith(root):
        return None
    m = _COORD_RE.match(stem[len(root):])
    if m is None:
        return None
    return int(m.group(1) or 0), int(m.group(2) or 0)


def discover_traces(base: str) -> list[dict]:
    """Every existing per-(attempt, rank) trace sharing ``base``'s stem,
    as ``{"path", "attempt", "rank"}`` rows sorted by (attempt, rank) —
    how ``tools/trace_report.py`` merges a run's traces from the
    configured base path."""
    root, ext = os.path.splitext(base)
    found = []
    for path in sorted(glob.glob(f"{glob.escape(root)}*{ext or '.json'}")):
        coords = trace_coords(base, path)
        if coords is not None:
            found.append({"path": path, "attempt": coords[0],
                          "rank": coords[1]})
    found.sort(key=lambda r: (r["attempt"], r["rank"]))
    return found


class Tracer:
    """Streaming Chrome-trace writer. Thread-safe; cheap enough to leave on
    (one dict + one ``write`` per span; spans are chunk/epoch-grained, never
    per-device-op: ``torch.profiler`` owns that granularity)."""

    def __init__(self, path: str, *, rank: int = 0, enabled: bool = True):
        self.path = path
        self.rank = rank
        self.enabled = enabled
        self._fh: IO[str] | None = None
        # RLock: _tid() emits the thread-name metadata event while already
        # holding the lock (first span on a new thread).
        self._lock = threading.RLock()
        self._tids: dict[int, int] = {}
        # Anchor: wall-clock ts derived from one (wall, monotonic) pair so
        # every event's ts is consistent within the run even if the wall
        # clock steps mid-run.
        self._wall0 = time.time()
        self._mono0 = time.perf_counter()

    # ------------------------------------------------------------- plumbing

    def _now_us(self) -> float:
        return (self._wall0 + (time.perf_counter() - self._mono0)) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
                name = threading.current_thread().name
                self._emit({"ph": "M", "name": "thread_name", "pid": self.rank,
                            "tid": tid, "args": {"name": name}})
        return tid

    def _emit(self, event: dict) -> None:
        with self._lock:
            if self._fh is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._fh = open(self.path, "w", buffering=1)
                self._fh.write("[\n")
                self._fh.write(json.dumps({
                    "ph": "M", "name": "process_name", "pid": self.rank,
                    "tid": 0, "args": {
                        "name": f"rank{self.rank}@{socket.gethostname()}"},
                }) + ",\n")
            self._fh.write(json.dumps(event, default=str) + ",\n")

    # ------------------------------------------------------------------ API

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "span", **args):
        """One complete event around the body. ``args`` land in the event's
        ``args`` (visible in the trace viewer's detail pane)."""
        if not self.enabled:
            yield
            return
        ts = self._now_us()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = (time.perf_counter() - t0) * 1e6
            event = {"name": name, "cat": cat or "span", "ph": "X",
                     "ts": round(ts, 1), "dur": round(dur, 1),
                     "pid": self.rank, "tid": self._tid()}
            if args:
                event["args"] = args
            self._emit(event)

    def complete(self, name: str, start_mono: float, cat: str = "span",
                 **args) -> None:
        """Emit a finished span from a caller-held ``time.perf_counter()``
        start — for long bodies (an epoch) where wrapping the whole block in
        a ``with`` would obscure the control flow, and where an abandoned
        span (preemption raising mid-epoch) should simply not appear."""
        if not self.enabled:
            return
        now = time.perf_counter()
        dur = (now - start_mono) * 1e6
        event = {"name": name, "cat": cat, "ph": "X",
                 "ts": round(self._now_us() - dur, 1), "dur": round(dur, 1),
                 "pid": self.rank, "tid": self._tid()}
        if args:
            event["args"] = args
        self._emit(event)

    def instant(self, name: str, cat: str = "event", **args) -> None:
        """A zero-duration marker (``ph: "i"``) — faults, signals, beats."""
        if not self.enabled:
            return
        event = {"name": name, "cat": cat, "ph": "i", "s": "t",
                 "ts": round(self._now_us(), 1), "pid": self.rank,
                 "tid": self._tid()}
        if args:
            event["args"] = args
        self._emit(event)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                # Terminate the array: the streamed trailing comma is legal
                # inside the tolerant readers, but a proper ']' makes the
                # file strict JSON for everything else. '{}' absorbs the
                # trailing comma.
                self._fh.write("{}]\n")
                self._fh.close()
                self._fh = None


# --------------------------------------------------------- module-level slot

_TRACER: Tracer | None = None
_NULL = contextlib.nullcontext()


def install(tracer: Tracer) -> Tracer:
    global _TRACER
    _TRACER = tracer
    return tracer


def uninstall() -> None:
    global _TRACER
    if _TRACER is not None:
        _TRACER.close()
    _TRACER = None


def current() -> Tracer | None:
    return _TRACER


def span(name: str, cat: str = "span", **args):
    """The library-code entry: a span on the installed tracer, or an inert
    null context when none is installed (one global check, no allocation)."""
    if _TRACER is None:
        return _NULL
    return _TRACER.span(name, cat, **args)


def instant(name: str, cat: str = "event", **args) -> None:
    if _TRACER is not None:
        _TRACER.instant(name, cat, **args)


def complete(name: str, start_mono: float, cat: str = "span", **args) -> None:
    if _TRACER is not None:
        _TRACER.complete(name, start_mono, cat, **args)


def read_trace(path: str) -> list[dict]:
    """Load a trace written by ``Tracer`` — including one from a crashed run
    (missing ``]``): falls back to line-wise parsing of the streamed events.
    Shared by ``tools/trace_report.py`` and the tests."""
    with open(path) as fh:
        content = fh.read()
    try:
        return [e for e in json.loads(content) if e]
    except json.JSONDecodeError:
        events = []
        for line in content.splitlines():
            line = line.strip().rstrip(",")
            if not line or line in ("[", "]", "{}]"):
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue   # partial last line from the crash
            if ev:
                events.append(ev)
        return events
