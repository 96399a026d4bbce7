"""Training checkpoints (counterpart of ``data_diet_distributed_tpu/checkpoint.py``'s
single-tier ``CheckpointManager``).

The port's own on-disk format; it does not read the JAX package's Orbax
checkpoints, nor they its. One directory per step, ``<dir>/step_<N>/``:

* ``arrays.npz``: every ``TrainState`` tensor as float32, keyed
  ``params/<name>``, ``batch_stats/<name>`` and ``momentum/<name>``;
* ``manifest.json`` (``resilience/integrity.py::build_manifest``): the format
  tag, the step, whether the params were finite, per array its shape, dtype
  and the sha256 of its bytes, and ``metrics`` (``epoch``,
  ``steps_per_epoch``, the epoch record's numbers, and ``preempted`` for a
  preemption's final save).

A step is written into a temporary directory and renamed into place, so a
kill mid-save leaves no half-written step. ``max_to_keep`` newest steps are
kept. A restore verifies the arrays against the manifest
(``integrity.verify_restored``) and refuses with ``CheckpointCorrupt``
naming the array; ``restore_verified`` falls back past refused steps to the
newest one that verifies.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zipfile
from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .resilience.integrity import (FORMAT, CheckpointCorrupt, build_manifest,
                                   verify_restored)
from .train.state import TrainState
from .weights import variables_to

_STEP_DIR = re.compile(r"^step_(\d+)$")
_GROUPS = ("params", "batch_stats", "momentum")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 20):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             metrics: dict[str, Any] | None = None) -> str:
        """Write ``state`` as step ``step``; returns its directory."""
        arrays = {f"{group}/{k}": v.detach().float().cpu().numpy()
                  for group in _GROUPS for k, v in getattr(state, group).items()}
        manifest = build_manifest(arrays, step, state.step, metrics)
        final = self._step_dir(step)
        tmp = f"{final}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        steps = self.all_steps()
        if self.max_to_keep and len(steps) > self.max_to_keep:
            for old in steps[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return final

    def manifest(self, step: int | None = None) -> dict[str, Any]:
        step = self._resolve(step)
        with open(os.path.join(self._step_dir(step), "manifest.json")) as fh:
            manifest = json.load(fh)
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{self._step_dir(step)}: not a checkpoint of this "
                             f"format ({manifest.get('format')!r})")
        return manifest

    def metrics(self, step: int | None = None) -> dict[str, Any]:
        return self.manifest(step).get("metrics", {})

    def _resolve(self, step: int | None) -> int:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"{self.directory}: no checkpoint to restore")
        elif int(step) not in self.all_steps():
            raise FileNotFoundError(
                f"{self.directory}: no checkpoint at step {step} "
                f"(have {self.all_steps()})")
        return int(step)

    def _load(self, step: int | None) -> tuple[dict, dict[str, dict]]:
        """The manifest and the verified arrays by group."""
        step = self._resolve(step)
        manifest = self.manifest(step)
        path = os.path.join(self._step_dir(step), "arrays.npz")
        try:
            with np.load(path) as f:
                arrays = {k: f[k] for k in f.files}
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as err:
            raise CheckpointCorrupt(f"{path} does not read ({err!r}): truncated or "
                                    "corrupt payload") from err
        verify_restored(arrays, manifest, step, where=self._step_dir(step))
        out: dict[str, dict] = {g: {} for g in _GROUPS}
        for key, arr in arrays.items():
            group, name = key.split("/", 1)
            out[group][name] = torch.from_numpy(arr)
        return manifest, out

    def restore(self, step: int | None = None, device=None) -> TrainState:
        """The ``TrainState`` of ``step`` (None = latest) on ``device``:
        params, statistics, momentum and step, for a true resume."""
        device = resolve_device(device)
        manifest, groups = self._load(step)
        return TrainState(params=variables_to(groups["params"], device),
                          batch_stats=variables_to(groups["batch_stats"], device),
                          momentum=variables_to(groups["momentum"], device),
                          step=int(manifest["state_step"]))

    def restore_variables(self, step: int | None = None, device=None) -> dict:
        """Params and statistics of ``step`` (None = latest), as the models
        and ``score_dataset`` take them."""
        device = resolve_device(device)
        _, groups = self._load(step)
        return variables_to({**groups["params"], **groups["batch_stats"]}, device)

    def restore_verified(self, step: int | None = None, device=None,
                         on_fallback=None) -> tuple[TrainState, int]:
        """Restore the newest step (``<= step`` when one is given) whose
        payload reads and verifies; returns ``(state, restored_step)``. Each
        refused step is reported through ``on_fallback(step=, error=)`` before
        the next older one is tried; ``CheckpointCorrupt`` when none verifies."""
        candidates = [s for s in sorted(self.all_steps(), reverse=True)
                      if step is None or s <= step]
        if not candidates:
            raise FileNotFoundError(f"{self.directory}: no checkpoint to restore")
        last_err: Exception | None = None
        for s in candidates:
            try:
                return self.restore(s, device), s
            except Exception as err:  # noqa: BLE001 — any failed candidate falls back
                last_err = err
                if on_fallback is not None:
                    on_fallback(step=s, error=repr(err)[:300])
        raise CheckpointCorrupt(
            f"all {len(candidates)} checkpoint(s) {candidates} in {self.directory} "
            f"failed restore/verification; last error: {last_err!r}") from last_err
