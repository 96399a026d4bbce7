"""Training checkpoints (counterpart of ``data_diet_distributed_tpu/checkpoint.py``):
one step directory per save, and the local tier.

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

Across ranks the format does not change: the caller hands ``save`` the whole
state (``train.state.gather_slots`` joins ZeRO-1's momentum slices first),
rank 0 writes, and every rank waits at a barrier after the write, then reads
the same directory. A checkpoint written at W ranks restores at any other.
``verified_steps`` (steps whose manifest reads and names its step) is what a
rank contributes to the consensus restore, which then restores exactly the
agreed step with no fallback.

THE LOCAL TIER (``checkpoint.local_tier``, ``LocalTier``): each rank writes
only what it owns, with no collective and no barrier: rank 0 the replicated
arrays (params, statistics, the momentum of every leaf ZeRO-1 keeps whole),
and under ZeRO-1 each rank its own momentum slice with its index in the
whole leaf. The save is one npz and a manifest of per-array digests on local
disk (``<dir>_local/rank<k>/step_<N>/``); a background thread promotes it to
the durable tier (``<dir>_tiered/step_<N>/rank<k>.npz``), re-reads the copy
against the digests, and only then writes the rank's
``promoted.rank<k>.json``. A tier step counts (``tier_steps``) once every
rank of the world that saved it has its marker, so a save a SIGKILL cut off
mid-promotion is never restored. A restore assembles the whole state from
every rank's files, whatever the world that restores it (``fit`` then
re-slices the momentum for its own world), and the preemption path drains
the promotions in flight and waits for the peers' markers (``await_step``)
before it claims a durable step. Readers need no config: tier steps are
found by the path convention and served by ``all_steps``, ``restore``,
``manifest`` and ``metrics`` beside the plain steps.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
import zipfile
from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .obs import registry as obs_registry
from .obs import tracing
from .parallel.mesh import UpdateSharding, is_primary, process_index, sync_hosts, world_size
from .resilience.integrity import (FORMAT, CheckpointCorrupt, build_manifest,
                                   verify_restored)
from .train.state import TrainState
from .utils.io import atomic_write_json
from .weights import variables_to

_STEP_DIR = re.compile(r"^step_(\d+)$")
_GROUPS = ("params", "batch_stats", "momentum")


def tiered_dir(directory: str) -> str:
    """The durable tier (a sibling of the checkpoint dir, like
    ``_stages.json``): readers find promoted tier steps here with no config."""
    return f"{os.path.abspath(directory)}_tiered"


def local_tier_dir(directory: str, configured: str | None = None) -> str:
    """The local tier's root. A configured root (``checkpoint.local_dir``) is
    namespaced by the checkpoint directory's basename and a hash of its path:
    jobs sharing one local disk never collide on ``rank<k>/step_<n>``, where
    one run's promoter could copy the other's shards with passing digests."""
    directory = os.path.abspath(directory)
    if configured is None:
        return f"{directory}_local"
    slug = (f"{os.path.basename(directory)}-"
            f"{hashlib.sha256(directory.encode()).hexdigest()[:10]}")
    return os.path.join(os.path.abspath(configured), slug)


def _sha(data: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(data).tobytes()).hexdigest()[:16]


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{int(step)}")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _owned(state: TrainState, slots: UpdateSharding | None, rank: int):
    """``(leaf, full_shape, host_array, index)`` of every piece of ``state``
    this rank saves: rank 0 every whole leaf, and under ``slots`` (ZeRO-1)
    each rank its slice of each sharded momentum leaf; ``index`` is the
    slice's ``[[start, stop], ...]`` in the whole leaf (None: the whole)."""
    for group in ("params", "batch_stats"):
        for k, v in getattr(state, group).items():
            yield f"{group}/{k}", tuple(v.shape), (_host(v) if rank == 0 else None), None
    for k, v in state.momentum.items():
        shape = tuple(state.params[k].shape)
        d = slots.spec_for(shape) if slots is not None else None
        if d is None:
            yield f"momentum/{k}", shape, (_host(v) if rank == 0 else None), None
            continue
        chunk = shape[d] // slots.data_size
        index = [[0, n] for n in shape]
        index[d] = [slots.rank * chunk, (slots.rank + 1) * chunk]
        yield f"momentum/{k}", shape, _host(v), index


def tier_steps(directory: str) -> list[int]:
    """Steps fully promoted to the durable tier: every rank of the world
    rank 0's marker names has its marker. Sorted ascending."""
    root = tiered_dir(directory)
    out = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return out
    for name in names:
        m = _STEP_DIR.match(name)
        if m is None:
            continue
        sdir = os.path.join(root, name)
        try:
            with open(os.path.join(sdir, "promoted.rank0.json")) as fh:
                world = int(json.load(fh).get("world", 1))
        except (OSError, ValueError):
            continue
        if all(os.path.exists(os.path.join(sdir, f"promoted.rank{r}.json"))
               for r in range(world)):
            out.append(int(m.group(1)))
    return sorted(out)


class LocalTier:
    """Per-rank local-disk saves and their background promotion.

    ``save_local`` is what the step loop pays: the owned arrays to the host,
    one npz and a digest manifest on local disk, an enqueue. The promoter
    thread copies each save to ``tiered_dir(directory)``, re-reads the copy
    against every digest, then writes this rank's atomic
    ``promoted.rank<k>.json``: the durable commit. ``drain`` (the preemption
    path, through ``CheckpointManager.all_steps``) bounds the wait on the
    promotions in flight. A failed promotion is logged (``{"kind":
    "ckpt_tier", "tier": "error"}``) and reported by ``drain``, never raised
    from the thread."""

    def __init__(self, directory: str, *, local_dir: str | None = None,
                 promote: bool = True, drain_timeout_s: float = 120.0,
                 promote_delay_s: float = 0.0, max_to_keep: int = 20, log=None,
                 rank: int | None = None, world: int | None = None):
        self.rank = process_index() if rank is None else int(rank)
        self.world = world_size() if world is None else int(world)
        self.durable_root = tiered_dir(directory)
        self.local_root = os.path.join(local_tier_dir(directory, local_dir),
                                       f"rank{self.rank}")
        self.promote = promote
        self.drain_timeout_s = float(drain_timeout_s)
        self.promote_delay_s = float(promote_delay_s)
        self.max_to_keep = int(max_to_keep)
        self.log = log
        self.errors: list[str] = []
        #: The last drain that waited: {"ok", "wait_s", "budget_s",
        #: "timed_out", "errors"} (``CheckpointManager.drain_info``).
        self.last_drain: dict[str, Any] | None = None
        self._pending: list[int] = []
        self._cond = threading.Condition()
        self._stop = False
        self._thread: threading.Thread | None = None
        os.makedirs(self.local_root, exist_ok=True)
        os.makedirs(self.durable_root, exist_ok=True)

    def save_local(self, step: int, state: TrainState,
                   metrics: dict[str, Any] | None = None,
                   slots: UpdateSharding | None = None) -> None:
        """Save this rank's part of ``state`` (its own momentum slices under
        ``slots``) as ``step`` on local disk, then enqueue its promotion.
        Rank 0's manifest also holds the optimizer step, the params'
        finiteness and the epoch ``metrics`` a resume reads."""
        t0 = time.perf_counter()
        sdir = _step_dir(self.local_root, step)
        os.makedirs(sdir, exist_ok=True)
        arrays: dict[str, np.ndarray] = {}
        entries, leaves = [], {}
        finite = True
        for leaf, shape, data, index in _owned(state, slots, self.rank):
            leaves[leaf] = {"shape": list(shape), "dtype": "float32"}
            if data is None:
                continue
            if leaf.startswith("params/"):
                finite = finite and bool(np.isfinite(data).all())
            key = f"a{len(arrays)}"
            arrays[key] = data
            entries.append({"key": key, "leaf": leaf, "index": index, "sha": _sha(data)})
        manifest: dict[str, Any] = {"version": 1, "step": int(step), "rank": self.rank,
                                    "world": self.world, "arrays": entries,
                                    "leaves": leaves}
        if self.rank == 0:
            manifest.update(state_step=int(state.step), params_finite=finite,
                            metrics=metrics or {})
        # Temp + rename: a kill mid-save never leaves a shard file a
        # promotion could trust.
        tmp = os.path.join(sdir, "shards.tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, os.path.join(sdir, "shards.npz"))
        atomic_write_json(os.path.join(sdir, "manifest.json"), manifest)
        self._log(step, "local", wall_s=round(time.perf_counter() - t0, 4),
                  n_arrays=len(arrays))
        if self.promote:
            with self._cond:
                self._pending.append(int(step))
                self._cond.notify_all()
            self._ensure_thread()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="ckpt-tier-promoter")
            self._thread.start()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait(0.2)
                if self._stop and not self._pending:
                    return
                step = self._pending[0]
            try:
                if self.promote_delay_s:
                    time.sleep(self.promote_delay_s)
                self._promote(step)
            except Exception as exc:   # noqa: BLE001 — surfaced, never lost
                self.errors.append(f"step {step}: {exc!r}"[:300])
                self._log(step, "error", error=repr(exc)[:300])
            finally:
                with self._cond:
                    self._pending.remove(step)
                    self._cond.notify_all()

    def _promote(self, step: int) -> None:
        t0 = time.perf_counter()
        src = _step_dir(self.local_root, step)
        dst = _step_dir(self.durable_root, step)
        os.makedirs(dst, exist_ok=True)
        with open(os.path.join(src, "manifest.json")) as fh:
            manifest = json.load(fh)
        for name, out in (("shards.npz", f"rank{self.rank}.npz"),
                          ("manifest.json", f"rank{self.rank}.manifest.json")):
            tmp = os.path.join(dst, f".{out}.tmp")
            shutil.copyfile(os.path.join(src, name), tmp)
            os.replace(tmp, os.path.join(dst, out))
        # The DURABLE copy against the save-time digests, before the marker
        # makes it count: a torn copy stays invisible to restore and consensus.
        with np.load(os.path.join(dst, f"rank{self.rank}.npz"), allow_pickle=False) as d:
            for entry in manifest["arrays"]:
                got = _sha(d[entry["key"]])
                if got != entry["sha"]:
                    raise CheckpointCorrupt(
                        f"tier promotion of step {step}: array {entry['leaf']} "
                        f"digest {got} != saved {entry['sha']}")
        atomic_write_json(os.path.join(dst, f"promoted.rank{self.rank}.json"),
                          {"step": int(step), "rank": self.rank, "world": self.world,
                           "ts": round(time.time(), 3)})
        shutil.rmtree(src, ignore_errors=True)   # promoted: the scratch goes
        self._log(step, "durable", wall_s=round(time.perf_counter() - t0, 4))
        self._retain()

    def _retain(self) -> None:
        """Durable-tier retention: each rank removes ITS files of the steps
        past ``max_to_keep``; the directory goes with the last rank's."""
        steps = []
        try:
            for name in os.listdir(self.durable_root):
                m = _STEP_DIR.match(name)
                if m is not None:
                    steps.append(int(m.group(1)))
        except FileNotFoundError:
            return
        for step in sorted(steps)[:-self.max_to_keep] if len(steps) > self.max_to_keep else []:
            sdir = _step_dir(self.durable_root, step)
            for name in (f"promoted.rank{self.rank}.json", f"rank{self.rank}.npz",
                         f"rank{self.rank}.manifest.json"):
                try:
                    os.remove(os.path.join(sdir, name))
                except FileNotFoundError:
                    pass
            try:
                os.rmdir(sdir)
            except OSError:
                pass   # other ranks' files remain: theirs to remove

    def drain(self, timeout_s: float | None = None) -> bool:
        """Wait until every enqueued promotion has finished (the durability
        barrier of the preemption path). False on a timeout or when a
        promotion FAILED; either way a step whose promotion did not land is
        not in ``tier_steps``, so nothing restores it."""
        budget = self.drain_timeout_s if timeout_s is None else timeout_s
        t0 = time.perf_counter()
        with self._cond:
            meaningful = bool(self._pending)
            ok = self._cond.wait_for(lambda: not self._pending, budget)
        if meaningful or (self.errors and self.last_drain is None):
            # Only a drain that waited (or the first failed one) is recorded:
            # the read paths drain on every listing, and an instant no-op
            # must not overwrite the numbers of the wait that mattered.
            self.last_drain = {"ok": bool(ok and not self.errors),
                               "wait_s": round(time.perf_counter() - t0, 3),
                               "budget_s": float(budget), "timed_out": not ok,
                               "errors": len(self.errors)}
        if not ok:
            self._log(-1, "error", wait_s=self.last_drain["wait_s"], budget_s=float(budget),
                      error=f"drain timed out after {budget}s with "
                            f"{len(self._pending)} promotion(s) in flight")
        return ok and not self.errors

    def close(self) -> None:
        self.drain()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _log(self, step: int, tier: str, **fields) -> None:
        obs_registry.inc(f"ckpt_tier_{tier}")
        if self.log is not None:
            self.log("ckpt_tier", step=int(step), tier=tier, rank=self.rank, **fields)


def _read_tier_manifests(directory: str, step: int) -> list[dict]:
    sdir = _step_dir(tiered_dir(directory), step)
    with open(os.path.join(sdir, "promoted.rank0.json")) as fh:
        world = int(json.load(fh).get("world", 1))
    out = []
    for r in range(world):
        with open(os.path.join(sdir, f"rank{r}.manifest.json")) as fh:
            out.append(json.load(fh))
    return out


def restore_tier_payload(directory: str, step: int) -> dict[str, np.ndarray]:
    """The whole host payload ``{"<group>/<name>": array}`` of a promoted tier
    step, assembled from every rank's shard file, each array checked against
    its digest as it is read (``CheckpointCorrupt`` on a mismatch or an
    unreadable file)."""
    sdir = _step_dir(tiered_dir(directory), step)
    manifests = _read_tier_manifests(directory, step)
    meta: dict[str, dict] = {}
    for m in manifests:
        meta.update(m["leaves"])
    leaves = {k: np.zeros(tuple(i["shape"]), np.dtype(i["dtype"])) for k, i in meta.items()}
    filled = dict.fromkeys(leaves, 0)
    for m in manifests:
        path = os.path.join(sdir, f"rank{m['rank']}.npz")
        try:
            with np.load(path, allow_pickle=False) as d:
                for entry in m["arrays"]:
                    data = d[entry["key"]]
                    if _sha(data) != entry["sha"]:
                        raise CheckpointCorrupt(
                            f"tier step {step}: array {entry['leaf']} (rank "
                            f"{m['rank']}) failed digest verification")
                    if entry["index"] is None:
                        leaves[entry["leaf"]] = data.reshape(leaves[entry["leaf"]].shape)
                    else:
                        leaves[entry["leaf"]][tuple(slice(s, e) for s, e in entry["index"])] = data
                    filled[entry["leaf"]] += data.size
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as err:
            if isinstance(err, CheckpointCorrupt):
                raise
            raise CheckpointCorrupt(f"{path} does not read ({err!r})") from err
    short = [k for k, n in filled.items() if n != leaves[k].size]
    if short:
        raise CheckpointCorrupt(f"tier step {step}: the ranks' shards do not cover "
                                f"{short[:3]}")
    return leaves


def tier_map(directory: str, local_dir: str | None = None) -> dict[str, str]:
    """``{step: tier}`` of every step under ``directory``, the provenance the
    stage manifest records: ``"durable"`` (a promoted tier step), ``"local"``
    (saved, never promoted; rank 0's view), ``"plain"`` (a step directory).
    ``local_dir`` is the configured ``checkpoint.local_dir``, if any."""
    out: dict[str, str] = {}
    for s in _plain_steps(os.path.abspath(directory)):
        out[str(s)] = "plain"
    for s in tier_steps(directory):
        out[str(s)] = "durable"
    try:
        for name in os.listdir(os.path.join(local_tier_dir(directory, local_dir), "rank0")):
            if _STEP_DIR.match(name):
                out.setdefault(name[len("step_"):], "local")
    except FileNotFoundError:
        pass
    return out


def restorable_steps(directory: str) -> list[int]:
    """Every restorable step under ``directory``, sorted: the plain
    ``step_N`` directories holding their manifest and the fully promoted tier
    steps. Reads the disk only (no tier drain)."""
    return sorted(set(_plain_steps(os.path.abspath(directory))) | set(tier_steps(directory)))


def _plain_steps(directory: str) -> list[int]:
    steps = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return steps
    for name in names:
        m = _STEP_DIR.match(name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 20, tier=None, log=None):
        """``tier`` (a ``config.CheckpointConfig`` with ``local_tier`` set, or
        None) arms the tier's WRITE path: saves go through ``LocalTier``.
        Readers never need it: tier steps are listed and restored beside the
        plain ones. ``log`` gets the tier's ``ckpt_tier`` records."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._tier: LocalTier | None = None
        if tier is not None and getattr(tier, "local_tier", False):
            self._tier = LocalTier(self.directory, local_dir=tier.local_dir,
                                   promote=tier.promote,
                                   drain_timeout_s=tier.drain_timeout_s,
                                   promote_delay_s=tier.promote_delay_s,
                                   max_to_keep=max_to_keep, log=log)

    @property
    def tiered(self) -> bool:
        """Whether saves go through the local tier (each rank its own part)."""
        return self._tier is not None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}")

    def all_steps(self) -> list[int]:
        """Every restorable step, plain and promoted; with a tier this first
        drains the promotions in flight (the durability barrier)."""
        if self._tier is not None:
            self._tier.drain()
        return restorable_steps(self.directory)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, metrics: dict[str, Any] | None = None,
             slots: UpdateSharding | None = None) -> str:
        """Write ``state`` as step ``step``; returns its directory. Plain: the
        caller hands the whole state, rank 0 writes and every rank returns
        after it has (a barrier). Tiered: each rank hands its own state
        (``slots``: its ZeRO-1 layout) and saves its own part, no barrier."""
        if self._tier is not None:
            # The span is the local write, the stall the step loop pays; the
            # promotion's wall rides the ckpt_tier records.
            with tracing.span("checkpoint_save", cat="checkpoint", step=int(step),
                              tier="local"), obs_registry.timed("checkpoint_save_s"):
                self._tier.save_local(step, state, metrics, slots)
            return _step_dir(tiered_dir(self.directory), step)
        final = self._step_dir(step)
        with tracing.span("checkpoint_save", cat="checkpoint", step=int(step)), \
                obs_registry.timed("checkpoint_save_s"):
            if is_primary():
                self._write(step, state, metrics, final)
            sync_hosts(f"checkpoint_saved:{step}")
        return final

    def _write(self, step: int, state: TrainState, metrics: dict[str, Any] | None,
               final: str) -> None:
        arrays = {f"{group}/{k}": _host(v)
                  for group in _GROUPS for k, v in getattr(state, group).items()}
        manifest = build_manifest(arrays, step, state.step, metrics)
        tmp = f"{final}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        steps = _plain_steps(self.directory)
        if self.max_to_keep and len(steps) > self.max_to_keep:
            for old in steps[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def verified_steps(self, max_step: int | None = None) -> list[int]:
        """Steps (``<= max_step`` when given) whose manifest reads, is of this
        format and names its own step: a rank's candidates for the consensus
        restore (no array is read; ``restore`` verifies the agreed one)."""
        out = []
        for s in self.all_steps():
            if max_step is not None and s > max_step:
                continue
            try:
                m = self.manifest(s)
            except (OSError, ValueError, KeyError):
                continue
            if int(m.get("step", s)) == s:
                out.append(s)
        return out

    def _is_tier_step(self, step: int) -> bool:
        return (int(step) in tier_steps(self.directory)
                and int(step) not in _plain_steps(self.directory))

    def manifest(self, step: int | None = None) -> dict[str, Any]:
        step = self._resolve(step)
        if self._is_tier_step(step):
            m = _read_tier_manifests(self.directory, step)[0]
            # A tier step's manifest in the plain one's terms (its arrays'
            # digests are per shard, checked by restore_tier_payload).
            return {"format": FORMAT, "step": int(m["step"]),
                    "state_step": int(m["state_step"]),
                    "params_finite": bool(m.get("params_finite", True)),
                    "metrics": m.get("metrics") or {}, "world": int(m["world"]),
                    "tier": "durable"}
        with open(os.path.join(self._step_dir(step), "manifest.json")) as fh:
            manifest = json.load(fh)
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{self._step_dir(step)}: not a checkpoint of this "
                             f"format ({manifest.get('format')!r})")
        return manifest

    def metrics(self, step: int | None = None) -> dict[str, Any]:
        return self.manifest(step).get("metrics", {})

    def saved_world(self, step: int) -> int | None:
        """The world that SAVED ``step`` (tier steps record it; None for a
        plain step): the ``resume`` record carries it beside its own world."""
        try:
            if self._is_tier_step(step):
                return int(_read_tier_manifests(self.directory, int(step))[0]["world"])
        except (OSError, TypeError, ValueError, KeyError):
            return None
        return None

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
        """The manifest and the verified arrays by group (a
        ``checkpoint_restore`` span and ``checkpoint_restore_s`` wall)."""
        step = self._resolve(step)
        tier = self._is_tier_step(step)
        with tracing.span("checkpoint_restore", cat="checkpoint", step=step,
                          **({"tier": "durable"} if tier else {})), \
                obs_registry.timed("checkpoint_restore_s"):
            return self._load_tier(step) if tier else self._load_step(step)

    def _load_step(self, step: int) -> tuple[dict, dict[str, dict]]:
        manifest = self.manifest(step)
        path = os.path.join(self._step_dir(step), "arrays.npz")
        try:
            with np.load(path) as f:
                arrays = {k: f[k] for k in f.files}
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as err:
            raise CheckpointCorrupt(f"{path} does not read ({err!r}): truncated or "
                                    "corrupt payload") from err
        verify_restored(arrays, manifest, step, where=self._step_dir(step))
        return manifest, _by_group(arrays)

    def _load_tier(self, step: int) -> tuple[dict, dict[str, dict]]:
        manifest = self.manifest(step)
        where = _step_dir(tiered_dir(self.directory), step)
        if manifest["step"] != step:
            raise CheckpointCorrupt(f"{where}: manifest records step {manifest['step']}, "
                                    f"not {step}")
        arrays = restore_tier_payload(self.directory, step)
        if manifest["params_finite"] and not all(
                np.isfinite(a).all() for k, a in arrays.items() if k.startswith("params/")):
            raise CheckpointCorrupt(f"{where}: params contain non-finite values but were "
                                    "finite at save time")
        return manifest, _by_group(arrays)

    def restore(self, step: int | None = None, device=None) -> TrainState:
        """The ``TrainState`` of ``step`` (None = latest) on ``device``:
        params, statistics, the whole momentum and the step, for a true
        resume (``fit`` shards the momentum for its own world)."""
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

    def await_step(self, step: int, timeout_s: float | None = None) -> list[int]:
        """Bounded wait for ``step`` to appear in the listing: this rank's
        drain covers its own promotions, but a tier step counts only once
        every peer's marker lands. File polling only (no collective: peers
        may be tearing down), bounded by the drain budget; returns the last
        listing. Without a tier, or at W = 1, the listing at once."""
        steps = self.all_steps()
        if self._tier is None or step in steps or self._tier.world <= 1:
            return steps
        own = os.path.join(_step_dir(tiered_dir(self.directory), step),
                           f"promoted.rank{self._tier.rank}.json")
        if not os.path.exists(own):
            return steps   # this rank's own promotion failed: no peer completes it
        budget = self._tier.drain_timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + budget
        while step not in steps and time.monotonic() < deadline:
            time.sleep(0.1)
            steps = self.all_steps()
        return steps

    def drain_info(self) -> dict[str, Any] | None:
        """The last tier drain that waited (None without a tier or before
        one): its wait against its budget, so a lost durable step reads as a
        slow disk (budget spent, timed out) or a dead promotion (fast)."""
        return self._tier.last_drain if self._tier is not None else None

    def close(self) -> None:
        """Drain the tier's promotions and stop its thread (nothing without a
        tier)."""
        if self._tier is not None:
            self._tier.close()


def _by_group(arrays: dict[str, np.ndarray]) -> dict[str, dict]:
    out: dict[str, dict] = {g: {} for g in _GROUPS}
    for key, arr in arrays.items():
        group, name = key.split("/", 1)
        out[group][name] = torch.from_numpy(arr)
    return out
