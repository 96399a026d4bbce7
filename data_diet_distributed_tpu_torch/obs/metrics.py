"""Structured JSON-lines records (counterpart of
``data_diet_distributed_tpu/obs/metrics.py``).

One record per event, ``{"ts", "kind", **fields}``, appended to
``obs.metrics_path`` (line-buffered, so a killed process keeps its history)
and, with ``echo``, printed as the same JSON line on stderr, where the CLI's
records go: a parent process reads the ``obs_server`` record there to find a
``serve.port=0`` service. Rank 0 writes and echoes; with ``every_rank`` (the
ranks of ``cli serve`` across a group, each of which ends in its own
``preempted`` record and ``run_summary``) rank ``k > 0`` writes its own
stream, ``rank_stream_path(path, k)``, and echoes it on its own stderr.
``tools/validate_metrics.py`` checks a stream of these against its known
kinds and required fields.

Every record is mirrored into the fault flight recorder (``obs/flightrec.py``)
BEFORE the rank-0 gate, so each rank's ring holds its own final moments, and
every written record carries the run's lineage (``run_id``, ``attempt``,
``world`` when set; ``obs/lineage.py``), never overwriting a field the caller
set. ``log`` must never crash the caller: numpy and torch scalars become
Python numbers and anything else unserializable a short summary.

``emit_run_summary`` writes the terminal ``run_summary`` record.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import IO, Any

from ..parallel.mesh import is_primary, process_index
from . import flightrec, lineage


def rank_stream_path(path: str, rank: int) -> str:
    """Rank ``rank``'s metrics stream beside ``path``: ``path`` itself for
    rank 0, ``<root>.rank<k><ext>`` for the others."""
    if not rank:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{rank}{ext}"


def _json_default(v: Any):
    """``json.dumps`` fallback: numpy/torch scalars, then small arrays as
    lists, then a summary."""
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", 1) == 0:
        try:
            return item()
        except (TypeError, ValueError, RuntimeError):
            pass
    return flightrec.json_safe(v)


class MetricsLogger:
    def __init__(self, path: str | None, echo: bool = True, every_rank: bool = False):
        self.echo = echo
        self._writes = every_rank or is_primary()
        if path and every_rank:
            path = rank_stream_path(path, process_index())
        self.path = path
        self._fh: IO[str] | None = None
        # Handler threads, the dispatcher, the serve loop and the monitor
        # threads all log: one line at a time.
        self._lock = threading.Lock()
        if path and self._writes:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, kind: str, **fields: Any) -> None:
        # The ring is the other ranks' only event history.
        flightrec.record(kind, **fields)
        if not self._writes:
            return
        record = lineage.stamp({"ts": round(time.time(), 3), "kind": kind, **fields})
        line = json.dumps(record, default=_json_default)
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


def emit_run_summary(logger, *, wall_s: float, exit_class: str,
                     command: str | None = None, final: dict[str, Any] | None = None,
                     registry=None) -> dict[str, Any]:
    """The terminal event of a run, emitted as the last record: the total
    wall, the per-stage seconds (the registry's ``stage_s:<stage>``
    histograms), the introspected programs (``xla``) and the run-level
    ``mfu``, the status server's port, the SLO verdict, the cross-seed score
    stability, the run's final metrics, and the exit class (``ok`` /
    ``preempted`` / ``fatal:<Type>``). Returns the record."""
    record: dict[str, Any] = {"wall_s": round(wall_s, 3), "exit_class": exit_class}
    if command is not None:
        record["command"] = command
    if registry is not None:
        stage_s = registry.stage_seconds()
        if stage_s:
            record["stage_s"] = stage_s
    from . import introspect
    intro = introspect.current()
    if intro is not None and intro.programs:
        record["xla"] = intro.summary()
        if registry is not None:
            mfu = registry.snapshot()["gauges"].get("mfu")
            if mfu is not None:
                record["mfu"] = mfu
                record["peak_flops_source"] = intro.peak_flops_per_device()[1]
    from . import server as obs_server
    srv = obs_server.current()
    if srv is not None and srv.port is not None:
        record["server_port"] = srv.port
    from . import slo as obs_slo
    engine = obs_slo.current()
    if engine is not None:
        record["slo"] = engine.verdict()
    from . import scoreboard
    stability = scoreboard.summary()
    if stability:
        record["score_stability"] = stability
    if final:
        record["final"] = {k: v for k, v in final.items() if v is not None}
    logger.log("run_summary", **record)
    return record
