"""Fault flight recorder (counterpart of
``data_diet_distributed_tpu/obs/flightrec.py``): the last N events on every
rank, dumped on faults.

The metrics stream is rank-0 gated, so when rank 3 hangs or throws its final
moments are invisible there. Every rank keeps a bounded in-memory ring of the
events it logged (``MetricsLogger.log`` mirrors each record into it BEFORE
its rank-0 gate) plus rank-local observations the stream never carries
(signal receipt, the local NaN verdict, a watchdog firing). The fault paths
dump the ring to ``<dir>/flightrec_rank<k>.json`` with the JAX package's
reasons: ``preempted:<sig>``, ``divergence:epoch<k>``, ``<fault>:attempt<k>``
(a retried fault), ``watchdog:<label>`` (from the watchdog's monitor thread)
and ``exception:<Type>`` (``ObsSession`` on an uncaught exception).

Recording is a deque append under a reentrant lock (safe from signal
handlers and the watchdog's thread); values are made JSON-safe when recorded,
so the ring never holds a device tensor. A repeated dump overwrites: the file
holds the latest final moments. The module-level helpers are no-ops until a
recorder is installed. Imports no torch (a tensor is summarized through its
own ``tolist``/``item``).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

import numpy as np

from . import lineage

__all__ = ["FlightRecorder", "flightrec_path", "read_dumps", "json_safe",
           "install", "uninstall", "current", "record", "dump"]


def flightrec_path(directory: str, rank: int, attempt: int = 0) -> str:
    """``flightrec_rank<k>.json``; attempts after the first are suffixed
    (``flightrec_rank<k>_a<attempt>.json``) so a relaunch keeps the crashed
    attempt's dump."""
    return os.path.join(
        directory, f"flightrec_rank{rank}{lineage.attempt_suffix(attempt)}.json")


def read_dumps(directory: str) -> list[dict]:
    """Every flight-recorder dump in ``directory``, across ranks and
    attempts; unreadable files are skipped."""
    out: list[dict] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("flightrec_rank") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as fh:
                payload = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(payload, dict):
            payload.setdefault("attempt", lineage.attempt_of(name))
            out.append(payload)
    return out


def json_safe(v):
    """Best-effort JSON form of an event field: numpy and torch scalars
    become Python numbers, small arrays lists, anything else its ``str``; a
    flight-recorder entry must never be the thing that raises. A torch
    tensor is read through ``tolist`` only when it is small (a device tensor
    then costs one small copy, as a jax array does in the JAX package)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): json_safe(x) for k, x in v.items()}
    if type(v).__module__.startswith("torch") and hasattr(v, "numel"):
        try:
            if v.numel() <= 32:
                return json_safe(np.asarray(v.detach().cpu().tolist()))
            return f"<tensor shape={tuple(v.shape)} dtype={v.dtype}>"
        except Exception:   # noqa: BLE001
            return str(v)
    try:
        arr = np.asarray(v)
    except Exception:   # noqa: BLE001
        return str(v)
    if arr.ndim == 0:
        return arr.item() if arr.dtype.kind in "bifu" else str(arr)
    if arr.size <= 32 and arr.dtype.kind in "bifu":
        return arr.tolist()
    return f"<array shape={arr.shape} dtype={arr.dtype}>"


class FlightRecorder:
    def __init__(self, directory: str = ".", rank: int = 0,
                 capacity: int = 256, attempt: int = 0):
        self.directory = os.path.abspath(directory)
        self.rank = rank
        self.attempt = int(attempt)
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        # Reentrant: record() runs from signal handlers on the main thread,
        # which may interrupt a frame that already holds the lock.
        self._lock = threading.RLock()

    def record(self, kind: str, **fields) -> None:
        event = {"ts": round(time.time(), 3), "kind": kind}
        for k, v in fields.items():
            event[k] = json_safe(v)
        with self._lock:
            self._ring.append(event)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str) -> str | None:
        """Write the ring to ``flightrec_rank<k>.json`` (atomically; a later
        dump overwrites). Returns the path, or None when the write failed (a
        dying disk must not mask the fault being recorded)."""
        path = flightrec_path(self.directory, self.rank, self.attempt)
        try:
            os.makedirs(self.directory, exist_ok=True)
            lin = lineage.current()
            payload = {"rank": self.rank, "attempt": self.attempt,
                       "run_id": lin.run_id if lin is not None else None,
                       "reason": str(reason)[:500],
                       "dumped_ts": round(time.time(), 3), "pid": os.getpid(),
                       "capacity": self.capacity, "events": self.snapshot()}
            tmp = f"{path}.tmp{threading.get_ident()}"
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, path)
            return path
        except OSError:
            return None


# --------------------------------------------------------- module-level slot

_RECORDER: FlightRecorder | None = None


def install(rec: FlightRecorder) -> FlightRecorder:
    global _RECORDER
    _RECORDER = rec
    return rec


def uninstall() -> None:
    global _RECORDER
    _RECORDER = None


def current() -> FlightRecorder | None:
    return _RECORDER


def record(kind: str, **fields) -> None:
    """Library-code entry: no-op until a recorder is installed."""
    if _RECORDER is not None:
        _RECORDER.record(kind, **fields)


def dump(reason: str) -> str | None:
    if _RECORDER is not None:
        return _RECORDER.dump(reason)
    return None
