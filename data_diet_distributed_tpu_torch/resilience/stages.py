"""Durable stage manifest and per-seed score partials: ``run``/``sweep``/``score``
re-enter at the exact stage (copy of
``data_diet_distributed_tpu/resilience/stages.py``).

* ``StageManifest``: an atomic JSON record (``<checkpoint_dir>_stages.json``)
  of completed and started stages, keyed by a config fingerprint, so a
  re-invoked pipeline skips completed stages, resumes a started retrain from
  its checkpoints, and a CHANGED config invalidates the record instead of
  silently reusing it.
* ``ScorePartialStore``: one npz per completed scoring seed
  (``<checkpoint_dir>_score_partials/seed<k>.npz``, float64, so a resumed mean
  is bitwise an uninterrupted one), validated on load: a truncated, corrupt or
  mismatched file is recomputed, never trusted.

Writes are atomic (temp + ``os.replace``) and rank 0's alone. The JSON
layout (``version``, ``fingerprint``, ``stages``) and the partials' validation
(method, seed, indices, fingerprint, shape, finite) are the JAX package's.
Across ranks the loaded manifest is rank 0's, broadcast
(``consensus.broadcast_json``), so every rank makes the same skip and resume
decisions, and the usable partials are those every rank can load
(``consensus.agree_common``).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..parallel.mesh import is_primary, world_size
from ..utils.io import atomic_savez
from .consensus import agree_common, broadcast_json

MANIFEST_VERSION = 1


def stage_manifest_path(checkpoint_dir: str) -> str:
    """A sibling of the checkpoint dir, like the scores npz."""
    return f"{checkpoint_dir}_stages.json"


def score_partials_dir(checkpoint_dir: str) -> str:
    return f"{checkpoint_dir}_score_partials"


class StageManifest:
    """Atomic record of pipeline stage status, keyed by config fingerprint.

    ``enabled=False`` is inert (``completed``/``started`` are False, marks do
    nothing), so callers thread it unconditionally. ``log(kind, **fields)``
    gets a ``stage`` event for each mark and reset."""

    def __init__(self, path: str, fingerprint: str, *, enabled: bool = True,
                 log=None):
        self.path = path
        self.fingerprint = fingerprint
        self.enabled = enabled
        self.log = log
        self._data = {"version": MANIFEST_VERSION, "fingerprint": fingerprint,
                      "stages": {}}
        if enabled:
            self._load()

    def _log(self, stage: str, status: str, **fields) -> None:
        if self.log is not None:
            self.log("stage", stage=stage, status=status, **fields)

    def _load(self) -> None:
        data = None
        try:
            with open(self.path) as fh:
                data = json.load(fh)
            if not isinstance(data.get("stages"), dict):
                raise ValueError("no stages table")
        except FileNotFoundError:
            data = None
        except (OSError, ValueError) as err:
            self._log("manifest", "reset", reason=f"unreadable: {err!r}"[:200],
                      path=self.path)
            data = None
        if data is not None and data.get("fingerprint") != self.fingerprint:
            self._log("manifest", "reset", reason="config fingerprint changed",
                      path=self.path)
            data = None
        data = broadcast_json(data)   # rank 0's view on every rank
        if data is not None:
            self._data = data

    def _write(self) -> None:
        if not self.enabled or not is_primary():
            return
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self._data, fh, indent=1)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    def status(self, stage: str) -> str | None:
        entry = self._data["stages"].get(stage)
        return entry.get("status") if entry else None

    def completed(self, stage: str) -> bool:
        return self.enabled and self.status(stage) == "done"

    def started(self, stage: str) -> bool:
        return self.enabled and self.status(stage) == "started"

    def info(self, stage: str) -> dict | None:
        return self._data["stages"].get(stage)

    def start(self, stage: str, **info) -> None:
        self._mark(stage, "started", info)

    def complete(self, stage: str, **info) -> None:
        self._mark(stage, "done", info)

    def _mark(self, stage: str, status: str, info: dict) -> None:
        if not self.enabled:
            return
        entry = dict(self._data["stages"].get(stage) or {})
        entry.update(info)
        entry["status"] = status
        entry["ts"] = round(time.time(), 3)
        self._data["stages"][stage] = entry
        self._write()
        self._log(stage, status)


class ScorePartialStore:
    """Durable per-seed score vectors, joined to a dataset by global index.

    Each completed seed's float64 vector is written atomically with enough
    provenance to refuse reuse across a different method, dataset, row order
    or scoring recipe (``fingerprint``, the score-relevant config hash).
    Invalid files load as None (with a ``stage`` event ``invalid``) and are
    recomputed."""

    def __init__(self, directory: str, *, method: str, indices: np.ndarray,
                 fingerprint: str = "", log=None):
        self.directory = directory
        self.method = method
        self.indices = np.asarray(indices)
        self.fingerprint = fingerprint
        self.log = log

    def path(self, seed: int) -> str:
        return os.path.join(self.directory, f"seed{int(seed)}.npz")

    def _invalid(self, seed: int, error: str) -> None:
        if self.log is not None:
            self.log("stage", stage=f"score_seed:{seed}", status="invalid",
                     path=self.path(seed), error=error[:200])

    def save(self, seed: int, scores: np.ndarray) -> None:
        if not is_primary():
            return
        os.makedirs(self.directory, exist_ok=True)
        atomic_savez(self.path(seed), scores=np.asarray(scores, np.float64),
                     indices=self.indices, method=self.method, seed=int(seed),
                     fingerprint=self.fingerprint)

    def load(self, seed: int) -> np.ndarray | None:
        try:
            with np.load(self.path(seed), allow_pickle=False) as d:
                if not {"scores", "indices", "method", "seed"} <= set(d.files):
                    raise ValueError("missing arrays")
                if str(d["method"]) != self.method or int(d["seed"]) != int(seed):
                    raise ValueError(f"method/seed mismatch ({d['method']}/{d['seed']})")
                stored_fp = str(d["fingerprint"]) if "fingerprint" in d.files else ""
                if stored_fp != self.fingerprint:
                    raise ValueError("scoring-config fingerprint changed")
                if not np.array_equal(np.asarray(d["indices"]), self.indices):
                    raise ValueError("dataset indices changed")
                scores = np.asarray(d["scores"], np.float64)
        except FileNotFoundError:
            return None
        except Exception as err:  # noqa: BLE001 — any invalid partial recomputes
            self._invalid(seed, repr(err))
            return None
        if scores.shape != self.indices.shape or not np.isfinite(scores).all():
            self._invalid(seed, "wrong shape or non-finite scores")
            return None
        return scores

    def load_all(self, seeds) -> dict[int, np.ndarray]:
        """Every seed with a valid partial, in ``seeds`` order; across ranks
        those valid on every rank (a collective)."""
        loaded = {int(s): arr for s in seeds if (arr := self.load(int(s))) is not None}
        if world_size() > 1:
            agreed = agree_common(list(loaded))
            loaded = {s: arr for s, arr in loaded.items() if s in agreed}
        return loaded
