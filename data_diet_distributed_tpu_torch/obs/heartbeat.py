"""Per-rank heartbeat files (counterpart of
``data_diet_distributed_tpu/obs/heartbeat.py``).

Each rank atomically rewrites one small JSON
(``<dir>/heartbeat_rank<k>.json``: rank, timestamp, pid, host and the
step/epoch/stage it passed) on every unit of progress; the serving loop and
the batcher's dispatcher beat with ``stage="serve"``. ``/healthz`` reads the
directory and names the stalest rank.

The directory defaults to a sibling of the checkpoint dir
(``<train.checkpoint_dir>_heartbeats``). Writes are atomic (temp + rename) and
throttled to one per ``min_interval_s`` unless forced. Each beat carries the
run id and attempt of the installed lineage (``obs/lineage.py``), as the JAX
package's does.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import time

from . import lineage

__all__ = ["Heartbeat", "default_dir", "dir_from_cfg", "heartbeat_path",
           "read_heartbeats", "describe_beats", "describe_stale", "archive_heartbeat",
           "read_heartbeat_residue", "install", "uninstall", "current", "beat",
           "describe"]


def default_dir(checkpoint_dir: str) -> str:
    """Sibling of the checkpoint dir, never inside it."""
    return f"{checkpoint_dir}_heartbeats"


def dir_from_cfg(cfg) -> str | None:
    """The heartbeat directory of a Config (None = heartbeats off)."""
    if not cfg.obs.heartbeat:
        return None
    return cfg.obs.heartbeat_dir or default_dir(cfg.train.checkpoint_dir)


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"heartbeat_rank{rank}.json")


class Heartbeat:
    def __init__(self, directory: str, rank: int = 0, *,
                 min_interval_s: float = 0.5):
        self.directory = os.path.abspath(directory)
        self.rank = rank
        self.min_interval_s = float(min_interval_s)
        self.path = heartbeat_path(self.directory, rank)
        self._last_write = 0.0
        self._made_dir = False

    def beat(self, *, step: int | None = None, epoch: int | None = None,
             stage: str | None = None, force: bool = False, **extra) -> bool:
        """Rewrite this rank's heartbeat; returns whether a write happened
        (throttled beats return False). Never raises: a full or read-only disk
        degrades observability, not the service."""
        now = time.monotonic()
        if not force and now - self._last_write < self.min_interval_s:
            return False
        try:
            if not self._made_dir:
                os.makedirs(self.directory, exist_ok=True)
                self._made_dir = True
            payload = {"rank": self.rank, "ts": round(time.time(), 3),
                       "pid": os.getpid(), "host": socket.gethostname()}
            lin = lineage.current()
            if lin is not None:
                payload["attempt"] = lin.attempt
                payload["run_id"] = lin.run_id
            if step is not None:
                payload["step"] = int(step)
            if epoch is not None:
                payload["epoch"] = int(epoch)
            if stage is not None:
                payload["stage"] = str(stage)
            payload.update(extra)
            # Per-thread temp name: the serve loop and the dispatcher both beat.
            tmp = f"{self.path}.tmp{os.getpid()}_{threading.get_ident()}"
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, self.path)
            self._last_write = now
            return True
        except OSError:
            return False


def read_heartbeats(directory: str) -> dict[int, dict]:
    """Every rank's latest heartbeat, keyed by rank; unreadable or torn files
    are skipped."""
    out: dict[int, dict] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("heartbeat_rank") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as fh:
                rec = json.load(fh)
            out[int(rec["rank"])] = rec
        except (OSError, ValueError, KeyError):
            continue
    return out


def residue_path(directory: str, rank: int, attempt: int) -> str:
    """A departed rank's archived heartbeat: ``.a<attempt>`` after ``.json``,
    so ``read_heartbeats`` never reads it as a live rank."""
    return f"{heartbeat_path(directory, rank)}.a{int(attempt)}"


def archive_heartbeat(directory: str, rank: int, attempt: int) -> bool:
    """Move a rank's heartbeat aside (its last recorded progress); returns
    whether a file moved."""
    try:
        os.replace(heartbeat_path(directory, rank), residue_path(directory, rank, attempt))
        return True
    except OSError:
        return False


def read_heartbeat_residue(directory: str) -> list[dict]:
    """Archived heartbeats, each with its ``rank`` and ``attempt``."""
    out: list[dict] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        m = re.match(r"heartbeat_rank(\d+)\.json\.a(\d+)$", name)
        if m is None:
            continue
        try:
            with open(os.path.join(directory, name)) as fh:
                rec = json.load(fh)
        except (OSError, ValueError):
            continue
        rec["rank"] = int(m.group(1))
        rec["attempt"] = int(m.group(2))
        out.append(rec)
    return out


def describe_beats(beats: dict[int, dict], now: float | None = None) -> list[str]:
    """One line per rank naming its last progress, stalest first."""
    now = time.time() if now is None else now
    lines = []
    for rank, rec in sorted(beats.items(), key=lambda kv: kv[1].get("ts", 0.0)):
        age = now - float(rec.get("ts", now))
        where = ", ".join(f"{k}={rec[k]}" for k in ("stage", "epoch", "step") if k in rec)
        lines.append(f"rank{rank} last progress {age:.1f}s ago"
                     + (f" ({where})" if where else ""))
    return lines


def describe_stale(directory: str, now: float | None = None) -> str:
    """The per-rank summary as one line (empty without heartbeats): appended
    to watchdog timeout messages."""
    return "; ".join(describe_beats(read_heartbeats(directory), now))


# --------------------------------------------------------- module-level slot

_HEARTBEAT: Heartbeat | None = None


def install(hb: Heartbeat) -> Heartbeat:
    global _HEARTBEAT
    _HEARTBEAT = hb
    return hb


def uninstall() -> None:
    global _HEARTBEAT
    _HEARTBEAT = None


def current() -> Heartbeat | None:
    return _HEARTBEAT


def beat(**kwargs) -> None:
    """Library-code entry: no-op until a Heartbeat is installed."""
    if _HEARTBEAT is not None:
        _HEARTBEAT.beat(**kwargs)


def describe() -> str:
    """Staleness summary of the installed heartbeat's directory (the
    watchdog's ``diagnose``); empty when none is installed."""
    if _HEARTBEAT is None:
        return ""
    return describe_stale(_HEARTBEAT.directory)
