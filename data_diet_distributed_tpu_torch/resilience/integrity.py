"""Checkpoint integrity: a save-time manifest, verified at restore (counterpart of
``data_diet_distributed_tpu/resilience/integrity.py``, for the port's own
checkpoint format).

A checkpoint step's ``manifest.json`` records, per array, its shape, dtype
and the sha256 of its bytes, plus the step and whether every params array was
finite (``build_manifest``). ``verify_restored`` re-derives the same table
from the arrays read back and refuses on any drift with ``CheckpointCorrupt``;
``CheckpointManager.restore_verified`` turns a refusal, or an unreadable
payload, into a fallback to the newest earlier step.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np

FORMAT = "data_diet_distributed_tpu_torch/checkpoint/1"


class CheckpointCorrupt(ValueError):
    """A restored checkpoint failed verification (or every candidate step
    did). A ``ValueError``, as the digest refusals of ``CheckpointManager``
    have always been; ``fit_with_recovery`` retries it like any exception."""


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _params_finite(arrays: dict[str, np.ndarray]) -> bool:
    return all(bool(np.isfinite(a).all()) for k, a in arrays.items()
               if k.startswith("params/"))


def build_manifest(arrays: dict[str, np.ndarray], step: int, state_step: int,
                   metrics: dict[str, Any] | None = None) -> dict[str, Any]:
    """The JSON manifest of a checkpoint's ``arrays`` (``<group>/<name>``)."""
    return {
        "format": FORMAT, "step": int(step), "state_step": int(state_step),
        "params_finite": _params_finite(arrays),
        "arrays": {k: {"shape": list(a.shape), "dtype": str(a.dtype),
                       "sha256": digest(a)} for k, a in arrays.items()},
        "metrics": metrics or {},
    }


def verify_restored(arrays: dict[str, np.ndarray], manifest: dict[str, Any],
                    step: int, where: str = "checkpoint") -> None:
    """Refuse (``CheckpointCorrupt``) when the arrays read back for ``step``
    drift from their manifest, checked in the JAX package's order: the step
    it records, the set of arrays, each array's shape and dtype, the params'
    finiteness when they were finite at save; then each array's sha256."""
    if int(manifest["step"]) != int(step):
        raise CheckpointCorrupt(
            f"{where}: manifest records step {manifest['step']}, not {step} — "
            "mislabeled or spliced checkpoint")
    want = manifest["arrays"]
    if set(arrays) != set(want):
        missing = sorted(set(want) - set(arrays))[:3]
        extra = sorted(set(arrays) - set(want))[:3]
        raise CheckpointCorrupt(f"{where}: the arrays do not match the manifest "
                                f"(missing {missing}, extra {extra})")
    for key, meta in want.items():
        arr = arrays[key]
        for field, got in (("shape", list(arr.shape)), ("dtype", str(arr.dtype))):
            if got != meta[field]:
                raise CheckpointCorrupt(f"{where}: array {key!r} {field} {got} != "
                                        f"manifest {meta[field]}")
    if manifest.get("params_finite") and not _params_finite(arrays):
        raise CheckpointCorrupt(f"{where}: params contain non-finite values but were "
                                "finite at save time — corrupted payload")
    for key, meta in want.items():
        if digest(arrays[key]) != meta["sha256"]:
            raise CheckpointCorrupt(f"{where}: array {key!r} fails its sha256 digest "
                                    "(corrupt checkpoint)")
