"""Structured JSON-lines records (counterpart of
``data_diet_distributed_tpu/obs/metrics.py::MetricsLogger``).

One record per event, ``{"ts", "kind", **fields}``, appended to
``obs.metrics_path`` (line-buffered, so a killed process keeps its history)
and, with ``echo``, printed as the same JSON line on stderr, where the CLI's
records go: a parent process reads the ``obs_server`` record there to find a
``serve.port=0`` service. Rank 0 writes and echoes. ``tools/validate_metrics.py``
checks a stream of these against its known kinds and required fields.

``log`` must never crash the caller: numpy and torch scalars become Python
numbers and anything else unserializable its ``repr``. No flight recorder and
no lineage stamp (not ported; the validator treats those fields as optional).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import IO, Any

from ..parallel.mesh import is_primary


def _json_default(v: Any):
    """``json.dumps`` fallback: numpy/torch scalars, then small arrays as
    lists, then ``repr``."""
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", 1) == 0:
        try:
            return item()
        except (TypeError, ValueError, RuntimeError):
            pass
    tolist = getattr(v, "tolist", None)
    if tolist is not None and getattr(v, "size", 1 << 30) <= 64:
        return tolist()
    return repr(v)[:200]


class MetricsLogger:
    def __init__(self, path: str | None, echo: bool = True):
        self.echo = echo
        self.path = path
        self._fh: IO[str] | None = None
        # Handler threads, the dispatcher and the serve loop all log: one line
        # at a time.
        self._lock = threading.Lock()
        if path and is_primary():
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, kind: str, **fields: Any) -> None:
        if not is_primary():
            return
        line = json.dumps({"ts": round(time.time(), 3), "kind": kind, **fields},
                          default=_json_default)
        with self._lock:
            if self._fh is not None:
                self._fh.write(line + "\n")
            if self.echo:
                print(line, file=sys.stderr, flush=True)

    def __call__(self, kind: str, **fields: Any) -> None:
        """A logger is also a ``log(kind, **fields)`` callable, the form the
        training entry points take."""
        self.log(kind, **fields)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
