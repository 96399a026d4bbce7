"""Training checkpoints (counterpart of ``data_diet_distributed_tpu/checkpoint.py``'s
single-tier ``CheckpointManager``).

The port's own on-disk format; it does not read the JAX package's Orbax
checkpoints, nor they its. One directory per step, ``<dir>/step_<N>/``:

* ``arrays.npz``: every ``TrainState`` tensor as float32, keyed
  ``params/<name>``, ``batch_stats/<name>`` and ``momentum/<name>``;
* ``manifest.json``: the format tag, the step, per array its shape, dtype
  and the sha256 of its bytes, and ``metrics`` (``epoch``,
  ``steps_per_epoch`` and the epoch record's numbers).

A step is written into a temporary directory and renamed into place, so a
kill mid-save leaves no half-written step. ``max_to_keep`` newest steps are
kept. A restore checks every array against its digest and refuses on a
mismatch, naming the array.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .train.state import TrainState
from .weights import variables_to

FORMAT = "data_diet_distributed_tpu_torch/checkpoint/1"
_STEP_DIR = re.compile(r"^step_(\d+)$")
_GROUPS = ("params", "batch_stats", "momentum")


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


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
        manifest = {
            "format": FORMAT, "step": int(step), "state_step": int(state.step),
            "arrays": {k: {"shape": list(a.shape), "dtype": str(a.dtype),
                           "sha256": _digest(a)} for k, a in arrays.items()},
            "metrics": metrics or {},
        }
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
        """The manifest and the digest-checked arrays by group."""
        step = self._resolve(step)
        manifest = self.manifest(step)
        out: dict[str, dict] = {g: {} for g in _GROUPS}
        with np.load(os.path.join(self._step_dir(step), "arrays.npz")) as f:
            if set(f.files) != set(manifest["arrays"]):
                raise ValueError(f"{self._step_dir(step)}: the arrays do not match "
                                 "the manifest")
            for key, meta in manifest["arrays"].items():
                arr = f[key]
                if _digest(arr) != meta["sha256"] or list(arr.shape) != meta["shape"]:
                    raise ValueError(f"{self._step_dir(step)}: array {key!r} fails its "
                                     "sha256 digest (corrupt checkpoint)")
                group, name = key.split("/", 1)
                out[group][name] = torch.from_numpy(arr.copy())
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
