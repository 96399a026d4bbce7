"""Artifact I/O (copy of the part of ``data_diet_distributed_tpu/utils/io.py`` the
port uses): atomic npz and JSON writes, the prune-provenance sidecar path, and
scores-artifact reuse (``load_scores_npz``)."""

from __future__ import annotations

import json
import os
import warnings
import zipfile
import zlib

import numpy as np

from ..data.datasets import make_position_joiner


def atomic_savez(path: str, **arrays) -> None:
    """``np.savez`` to ``path`` through a temporary file in the same directory
    and a rename: a kill mid-write never leaves a truncated artifact."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _finite(v):
    """Non-finite floats as None, recursively (JSON has no NaN)."""
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_finite(x) for x in v]
    if isinstance(v, float) and (v != v or v in (float("inf"), float("-inf"))):
        return None
    return v


def atomic_write_json(path: str, obj: dict) -> None:
    """One JSON document written through a temporary file and a rename, with
    non-finite floats as null."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(_finite(obj), fh, indent=1)
    os.replace(tmp, path)


def provenance_path(npz_path: str) -> str:
    """The prune-decision sidecar of a scores npz: a JSON manifest beside it."""
    return f"{npz_path}.provenance.json"


def read_prune_manifest(npz_path: str) -> dict | None:
    """The sidecar of ``npz_path``, or None when there is none; a corrupt one
    raises."""
    path = provenance_path(npz_path)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        try:
            return json.load(fh)
        except json.JSONDecodeError as err:
            raise ValueError(f"{path}: corrupt prune-provenance sidecar ({err})") from err


_WARNED_NO_PROVENANCE: set[str] = set()


def load_scores_npz(path: str, train_ds, expect_method: str | None = None) -> np.ndarray:
    """Scores from a saved artifact, joined to ``train_ds``'s row order by
    global index (an example the artifact lacks raises ``KeyError``). A
    truncated or corrupt file raises ``ValueError`` naming the path; so does
    an artifact whose recorded method differs from ``expect_method`` (unless
    it is a ``reused:`` record). An artifact without a provenance sidecar
    loads, with one warning per path."""
    try:
        with np.load(path, allow_pickle=False) as d:
            present = set(d.files)
            scores = np.asarray(d["scores"]) if "scores" in present else None
            indices = np.asarray(d["indices"]) if "indices" in present else None
            method = str(d["method"]) if "method" in present else None
    except FileNotFoundError:
        raise
    except (OSError, EOFError, ValueError, zipfile.BadZipFile, zlib.error) as err:
        raise ValueError(
            f"{path}: truncated or corrupt scores artifact ({err!r}); recompute "
            "the scores (unset score.scores_npz) or point at an intact artifact"
        ) from err
    if scores is None or indices is None:
        raise ValueError(f"{path} is not a scores artifact (needs 'scores' and "
                         "'indices' arrays, as the run/score/sweep commands write)")
    if scores.shape != indices.shape:
        raise ValueError(f"{path}: scores shape {scores.shape} does not match "
                         f"indices shape {indices.shape}")
    if (expect_method is not None and method is not None
            and not method.startswith("reused:") and method != expect_method):
        raise ValueError(
            f"{path} holds {method!r} scores but this run is configured for "
            f"score.method={expect_method!r}; set score.method={method} or recompute")
    if read_prune_manifest(path) is None and path not in _WARNED_NO_PROVENANCE:
        _WARNED_NO_PROVENANCE.add(path)
        warnings.warn(f"{path}: no prune-decision provenance sidecar "
                      f"({os.path.basename(provenance_path(path))})", stacklevel=2)
    pos = make_position_joiner(indices)(train_ds.indices)
    return scores[pos].astype(np.float32)


def atomic_append_jsonl(path: str, record: dict) -> None:
    """Append one JSON record to an append-only ledger: serialized to one line
    first, then one ``write`` on an ``O_APPEND`` descriptor, so concurrent
    writers interleave whole records. Non-finite floats become null; parent
    directories are created."""
    line = json.dumps(_finite(record)) + "\n"
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode())
    finally:
        os.close(fd)


def _finite(v):
    """Non-finite floats replaced by None, recursively (JSON has no NaN)."""
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_finite(x) for x in v]
    if isinstance(v, float) and (v != v or v in (float("inf"), float("-inf"))):
        return None
    return v
