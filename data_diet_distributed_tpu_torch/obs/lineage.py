"""Run lineage (counterpart of ``data_diet_distributed_tpu/obs/lineage.py``):
one ``run_id``, the attempt and the world size of the process, stamped on
every record.

* **run_id**: one identifier for the whole run, from ``DDT_RUN_ID`` when a
  supervisor set it, else generated at first use (a single process is
  attempt 0 with a fresh ``run_id``);
* **attempt**: ``DDT_ELASTIC_ATTEMPT`` (0 when unset);
* **world**: ``DDT_ELASTIC_WORLD`` (absent when unset).

``stamp()`` writes them into every JSON-lines record ``obs.MetricsLogger``
emits and into every heartbeat, never overwriting a field the caller set;
``attempt_suffix`` / ``suffixed_path`` name per-attempt artifacts (flight
recorder dumps, traces) so a relaunch never overwrites the evidence of the
failure it recovers from. The variables are set by the elastic supervisor
(``resilience/elastic.py``); the names are the JAX package's, so a
supervisor of either package can drive the port. Imports no torch.
"""

from __future__ import annotations

import os
import re
import time
import uuid
from dataclasses import dataclass

__all__ = ["Lineage", "RUN_ID_ENV", "ATTEMPT_ENV", "WORLD_ENV",
           "new_run_id", "from_env", "child_env", "install", "uninstall",
           "current", "ensure", "stamp", "attempt_suffix", "suffixed_path"]

RUN_ID_ENV = "DDT_RUN_ID"
#: The JAX package's elastic supervisor sets these on every worker it spawns.
ATTEMPT_ENV = "DDT_ELASTIC_ATTEMPT"
WORLD_ENV = "DDT_ELASTIC_WORLD"


@dataclass
class Lineage:
    run_id: str
    attempt: int = 0
    world: int | None = None


def new_run_id() -> str:
    """Sortable-by-start-time and collision-safe: UTC stamp + random hex.
    Short enough to ride every JSONL record without dominating it."""
    return (time.strftime("%Y%m%d-%H%M%S", time.gmtime())
            + "-" + uuid.uuid4().hex[:6])


def _int_env(env, key) -> int | None:
    raw = env.get(key)
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def from_env(environ=None) -> Lineage:
    """The lineage a supervisor threaded into this process — or a fresh
    attempt-0 identity when none did (plain single-process runs)."""
    env = os.environ if environ is None else environ
    return Lineage(run_id=env.get(RUN_ID_ENV) or new_run_id(),
                   attempt=_int_env(env, ATTEMPT_ENV) or 0,
                   world=_int_env(env, WORLD_ENV))


def child_env(run_id: str, attempt: int, world: int) -> dict[str, str]:
    """The env block a supervisor sets on every spawned worker."""
    return {RUN_ID_ENV: str(run_id), ATTEMPT_ENV: str(int(attempt)),
            WORLD_ENV: str(int(world))}


# --------------------------------------------------------- module-level slot

_LINEAGE: Lineage | None = None


def install(lin: Lineage) -> Lineage:
    global _LINEAGE
    _LINEAGE = lin
    return lin


def uninstall() -> None:
    global _LINEAGE
    _LINEAGE = None


def current() -> Lineage | None:
    return _LINEAGE


def ensure() -> Lineage:
    """The process's lineage, resolved ONCE: env (supervisor-assigned) wins,
    else a fresh attempt-0 identity is generated and installed — so every
    record a process writes carries the same run_id."""
    global _LINEAGE
    if _LINEAGE is None:
        _LINEAGE = from_env()
    return _LINEAGE


def stamp(record: dict) -> dict:
    """Ambient lineage into one JSONL record, in place. Never overwrites a
    field the emitter set explicitly."""
    lin = ensure()
    record.setdefault("run_id", lin.run_id)
    record.setdefault("attempt", lin.attempt)
    if lin.world is not None:
        record.setdefault("world", lin.world)
    return record


# -------------------------------------------------- per-attempt artifact names

def attempt_suffix(attempt: int | None) -> str:
    """``""`` for attempt 0 (the historical single-attempt names stay
    byte-identical), ``"_a<k>"`` after — so a relaunch writes NEXT TO the
    crashed attempt's artifacts instead of over them."""
    return "" if not attempt else f"_a{int(attempt)}"


def suffixed_path(path: str, attempt: int | None) -> str:
    """Insert the attempt suffix before the extension:
    ``trace.json`` -> ``trace_a2.json``."""
    suffix = attempt_suffix(attempt)
    if not suffix:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}{suffix}{ext}"


_ATTEMPT_RE = re.compile(r"_a(\d+)(?=[_.]|$)")


def attempt_of(filename: str) -> int:
    """The attempt encoded in an artifact filename (0 when unsuffixed) —
    the reverse of ``attempt_suffix``, for the postmortem's readers."""
    m = _ATTEMPT_RE.search(os.path.basename(filename))
    return int(m.group(1)) if m else 0
