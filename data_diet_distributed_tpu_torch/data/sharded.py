"""On-disk sharded dataset format: npy shards plus a digested JSON manifest
(the port's copy of ``data_diet_distributed_tpu/data/sharded.py``; the format,
``ddt-shards-v1``, is shared, so shards written by either package load in the
other).

Each split is a directory of fixed-size ``.npy`` image shards plus a global
label array, described by ``manifest.json`` with per-shard row counts, dtypes
and sha256 digests. Decoded shards live in an LRU ``ShardCache`` capped at
``data.host_cache_bytes``; a gather groups its rows by shard and loads each
needed shard once. Every read goes through ``_read_verified``: the injection
seam, the digest check, bounded retry with exponential backoff and, for a
shard that never verifies, quarantine (``ShardReadError``, or zeros under
``skip_quarantined``).

The port has no flight recorder: the ``data_fault`` and ``shard_quarantine``
records wait in a queue until the next ``data_plane`` record (the end of a fit
or a scoring pass) drains them into the caller's ``log(kind, **fields)``.
Under several processes rank ``r`` owns ``shards[r::world]``
(``owned_shards``); the port runs one process, rank 0.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import threading
from collections import OrderedDict

import numpy as np

MANIFEST_NAME = "manifest.json"
FORMAT = "ddt-shards-v1"

#: Default per-shard row count (4096 rows of 96x96x3 uint8 is ~110 MiB
#: decoded — a few shards fit any sane budget).
DEFAULT_SHARD_SIZE = 4096

#: Default decoded-shard LRU budget (``data.host_cache_bytes``).
DEFAULT_HOST_CACHE_BYTES = 1 << 30

#: Hardened read path defaults (``data.read_retries`` / ``data.read_backoff_s``).
DEFAULT_READ_RETRIES = 2
DEFAULT_READ_BACKOFF_S = 0.05


class ShardReadError(RuntimeError):
    """A shard read exhausted its retries (or hit a quarantined shard).

    Carries the failure's coordinates so the prefetch layer and the fault
    records can name exactly what broke: ``split``/``shard``,
    ``error_class`` (``transient_io`` | ``digest_mismatch`` |
    ``interrupted`` | ``quarantined``), and ``retries`` consumed."""

    def __init__(self, msg: str, *, split: str, shard: int,
                 error_class: str, retries: int = 0):
        super().__init__(msg)
        self.split = split
        self.shard = int(shard)
        self.error_class = error_class
        self.retries = int(retries)


#: Event set when a preemption/drain path wants in-flight retry backoffs to
#: stop NOW (``PrefetchIterator.close`` arms it before joining the assembler
#: thread): the backoff wait is an ``Event.wait``, so a wedged retry loop
#: raises ``ShardReadError(error_class="interrupted")`` within one poll
#: instead of sleeping out its exponential schedule.
_READ_INTERRUPT = threading.Event()


def interrupt_reads() -> None:
    """Break any in-flight shard-read retry backoff promptly."""
    _READ_INTERRUPT.set()


def resume_reads() -> None:
    """Re-arm the retry path after a drain (idempotent)."""
    _READ_INTERRUPT.clear()


#: Fault records waiting for the next ``data_plane`` emission point (the end
#: of a fit or a scoring pass), which drains them into its ``log``.
_PENDING_FAULTS: list[dict] = []
_PENDING_LOCK = threading.Lock()


def _note_fault(kind: str, **fields) -> None:
    with _PENDING_LOCK:
        _PENDING_FAULTS.append({"kind": kind, **fields})


def drain_fault_records() -> list[dict]:
    """Pop every pending ``data_fault``/``shard_quarantine`` record (each a
    dict with its ``kind`` inside) for the caller's ``log``."""
    with _PENDING_LOCK:
        out, _PENDING_FAULTS[:] = list(_PENDING_FAULTS), []
    return out


def _rank() -> int:
    """This process's rank for fault records: the port runs one process."""
    return 0


def manifest_path(data_dir: str) -> str:
    return os.path.join(data_dir, MANIFEST_NAME)


def is_sharded_dir(data_dir: str) -> bool:
    return os.path.exists(manifest_path(data_dir))


def owned_shards(num_shards: int, rank: int, world: int) -> list[int]:
    """The shard ids rank ``rank`` of ``world`` owns: ``shards[rank::world]``."""
    return list(range(num_shards))[rank::world]


def _sha256_file(path: str, chunk_bytes: int = 1 << 22) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk_bytes)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _save_atomic(path: str, array: np.ndarray) -> None:
    """Write-then-rename so a killed converter never leaves a torn shard
    under the final name (the manifest digests catch torn bytes anyway; this
    keeps partial files from even looking like shards)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.save(fh, array)
    os.replace(tmp, path)


def write_split(out_dir: str, split: str, images, labels: np.ndarray,
                shard_size: int = DEFAULT_SHARD_SIZE,
                prior: dict | None = None,
                reused: list[str] | None = None) -> dict:
    """Write one split's shards + labels file; returns the split manifest dict.

    ``images`` may be any row-sliceable array (ndarray or ``np.memmap``) —
    each shard is materialized one slice at a time, so converting a dataset
    never needs the whole decoded split in RAM.

    ``prior`` (a previous run's split manifest dict) makes the conversion
    RESUMABLE: a shard whose on-disk digest already matches the prior
    manifest's entry (same file name, same row span) is reused instead of
    rewritten — a killed converter resumes instead of restarting from zero,
    the same promote-verify discipline the checkpoint tiers use. Reused
    file names are appended to ``reused`` when the caller passes a list.
    """
    os.makedirs(out_dir, exist_ok=True)
    n = len(labels)
    if len(images) != n:
        raise ValueError(f"{split}: {len(images)} images vs {n} labels")
    if shard_size <= 0:
        raise ValueError(f"shard_size must be positive, got {shard_size}")
    prior_shards = {s["file"]: s for s in (prior or {}).get("shards", ())}
    shards = []
    for i, start in enumerate(range(0, n, shard_size)):
        stop = min(start + shard_size, n)
        fname = f"{split}-shard-{i:05d}.npy"
        path = os.path.join(out_dir, fname)
        have = prior_shards.get(fname)
        if (have is not None and have.get("start") == start
                and have.get("count") == stop - start
                and os.path.exists(path)
                and _sha256_file(path) == have.get("sha256")):
            # Digest-verified reuse: the bytes on disk ARE the manifest's —
            # the source rows never need materializing.
            shards.append({"file": fname, "start": start,
                           "count": stop - start, "sha256": have["sha256"]})
            if reused is not None:
                reused.append(fname)
            continue
        data = np.ascontiguousarray(images[start:stop])
        if have is None and os.path.exists(path):
            # No prior manifest (the converter died before writing one), but
            # a shard file exists under the final name — ``_save_atomic``
            # guarantees it is COMPLETE from some run. Reuse it iff its
            # bytes are exactly what this conversion would write.
            buf = io.BytesIO()
            np.save(buf, data)
            want = hashlib.sha256(buf.getvalue()).hexdigest()
            if _sha256_file(path) == want:
                shards.append({"file": fname, "start": start,
                               "count": stop - start, "sha256": want})
                if reused is not None:
                    reused.append(fname)
                continue
        _save_atomic(path, data)
        shards.append({"file": fname, "start": start, "count": stop - start,
                       "sha256": _sha256_file(path)})
    labels_file = f"{split}-labels.npy"
    labels_path = os.path.join(out_dir, labels_file)
    _save_atomic(labels_path, np.ascontiguousarray(labels, np.int32))
    return {
        "n": n,
        "image_shape": [int(d) for d in np.shape(images)[1:]],
        "image_dtype": str(np.asarray(images[:0]).dtype),
        "label_dtype": "int32",
        "shard_size": int(shard_size),
        "shards": shards,
        "labels": {"file": labels_file, "sha256": _sha256_file(labels_path)},
    }


def write_manifest(out_dir: str, splits: dict, num_classes: int,
                   norm: tuple | None) -> str:
    """Write ``manifest.json`` (atomically) tying the split dicts together.

    ``norm=(mean, std)`` in [0,1] units for uint8 shards (lazy per-batch
    normalization, the ``.npy`` ingestion convention); None for float32
    shards already in model units."""
    from ..utils.io import atomic_write_json
    manifest = {
        "format": FORMAT,
        "num_classes": int(num_classes),
        "norm": (None if norm is None else
                 {"mean": [float(v) for v in np.asarray(norm[0]).ravel()],
                  "std": [float(v) for v in np.asarray(norm[1]).ravel()]}),
        "splits": splits,
    }
    path = manifest_path(out_dir)
    atomic_write_json(path, manifest)
    return path


def read_manifest(data_dir: str) -> dict:
    with open(manifest_path(data_dir)) as fh:
        manifest = json.load(fh)
    if manifest.get("format") != FORMAT:
        raise ValueError(
            f"{manifest_path(data_dir)}: unknown format "
            f"{manifest.get('format')!r} (expected {FORMAT!r})")
    return manifest


def verify_manifest(data_dir: str) -> list[str]:
    """Re-hash every file against the manifest; problems as strings (empty =
    intact). The checkpoint-tier digest discipline applied to data: a torn or
    bit-flipped shard is a LOUD error before it can feed garbage scores."""
    problems: list[str] = []
    try:
        manifest = read_manifest(data_dir)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        return [f"{manifest_path(data_dir)}: {e}"]
    for split, meta in manifest.get("splits", {}).items():
        expect_next = 0
        for shard in meta.get("shards", ()):
            path = os.path.join(data_dir, shard["file"])
            if shard["start"] != expect_next:
                problems.append(
                    f"{split}: shard {shard['file']} starts at "
                    f"{shard['start']}, expected {expect_next} (gap/overlap)")
            expect_next = shard["start"] + shard["count"]
            if not os.path.exists(path):
                problems.append(f"{split}: missing shard file {shard['file']}")
                continue
            digest = _sha256_file(path)
            if digest != shard["sha256"]:
                problems.append(
                    f"{split}: shard {shard['file']} digest mismatch "
                    f"(manifest {shard['sha256'][:12]}…, file {digest[:12]}…)"
                    " — torn or corrupted shard")
        if expect_next != meta["n"]:
            problems.append(
                f"{split}: shards cover {expect_next} rows, manifest says "
                f"n={meta['n']}")
        labels = meta.get("labels")
        if labels:
            path = os.path.join(data_dir, labels["file"])
            if not os.path.exists(path):
                problems.append(f"{split}: missing labels file "
                                f"{labels['file']}")
            elif _sha256_file(path) != labels["sha256"]:
                problems.append(
                    f"{split}: labels file {labels['file']} digest mismatch")
    return problems


class ShardCache:
    """LRU over decoded shards with a HARD byte budget — the
    ``data.host_cache_bytes`` bound. ``get`` loads through ``loader`` on a
    miss and evicts coldest-first until the budget holds again; the entry
    just loaded is never evicted (a budget smaller than one shard degrades
    to load-per-touch, it does not livelock or OOM)."""

    def __init__(self, budget_bytes: int = DEFAULT_HOST_CACHE_BYTES):
        if budget_bytes <= 0:
            raise ValueError(
                f"host cache budget must be positive, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.bytes_in_use = 0
        self.loads = 0
        self.hits = 0
        self.evictions = 0
        self._entries: OrderedDict[object, np.ndarray] = OrderedDict()

    def get(self, key, loader) -> np.ndarray:
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry
        entry = loader()
        self.loads += 1
        self._entries[key] = entry
        self.bytes_in_use += entry.nbytes
        while self.bytes_in_use > self.budget_bytes and len(self._entries) > 1:
            _, evicted = self._entries.popitem(last=False)
            self.bytes_in_use -= evicted.nbytes
            self.evictions += 1
        return entry

    def stats(self) -> dict:
        return {"bytes_in_use": self.bytes_in_use,
                "budget_bytes": self.budget_bytes, "loads": self.loads,
                "hits": self.hits, "evictions": self.evictions}


class ShardedImages:
    """A virtual image array backed by on-disk shards through a bounded cache.

    Quacks enough like the ``[N, H, W, C]`` ndarray every data-layer consumer
    indexes (``shape``/``dtype``/``size``/``nbytes``/``len``/fancy
    ``__getitem__``) that ``ArrayDataset`` carries it unchanged: batch
    assembly gathers rows through the LRU shard cache, residency predicates
    read the logical shape, and ``dense()``/``np.asarray`` materialize
    explicitly via ``__array__``. A gather sorts its rows by shard id and
    loads each needed shard once, so per-batch disk traffic is bounded by the
    batch's shard span even when the cache holds a single shard."""

    def __init__(self, data_dir: str, split: str, meta: dict,
                 cache: ShardCache, *,
                 read_retries: int = DEFAULT_READ_RETRIES,
                 read_backoff_s: float = DEFAULT_READ_BACKOFF_S,
                 skip_quarantined: bool = False):
        self._dir = data_dir
        self._split = split
        self._cache = cache
        self._files = [s["file"] for s in meta["shards"]]
        #: per-shard manifest digests: EVERY read re-verifies against these
        #: (the checkpoint-tier discipline applied at read time, not just by
        #: the offline ``verify_manifest`` pass) — torn bytes can never
        #: become rows.
        self._digests = [s["sha256"] for s in meta["shards"]]
        self._starts = np.array([s["start"] for s in meta["shards"]]
                                + [meta["n"]], np.int64)
        self.shape = (int(meta["n"]), *(int(d) for d in meta["image_shape"]))
        self.dtype = np.dtype(meta["image_dtype"])
        self.ndim = len(self.shape)
        self.num_shards = len(self._files)
        self.read_retries = max(0, int(read_retries))
        self.read_backoff_s = float(read_backoff_s)
        self.skip_quarantined = bool(skip_quarantined)
        #: shard ids this process has actually read — the ownership invariant
        #: ("no rank reads another rank's bytes") is pinned against this.
        self.shards_read: set[int] = set()
        #: shard ids that exhausted their read retries — loads raise (or,
        #: under ``skip_quarantined``, return a zero placeholder whose rows
        #: the prune path drops and records).
        self.quarantined: set[int] = set()
        #: retries consumed across all reads (the in-place-recovery ledger
        #: the data_plane record and run_monitor surface).
        self.retries_used = 0
        self._read_counts: dict[int, int] = {}

    @property
    def cache(self) -> ShardCache:
        return self._cache

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def __len__(self) -> int:
        return self.shape[0]

    def _load_shard(self, sid: int) -> np.ndarray:
        if sid in self.quarantined:
            if self.skip_quarantined:
                # Degraded mode: a deterministic zero placeholder, NEVER the
                # corrupt bytes — the prune path drops these rows from the
                # keep decision and records the drop in the provenance
                # sidecar (quarantined_rows names them).
                count = int(self._starts[sid + 1] - self._starts[sid])
                return np.zeros((count, *self.shape[1:]), self.dtype)
            raise ShardReadError(
                f"{self._split} shard {sid} ({self._files[sid]}) is "
                "quarantined — refusing to serve rows from it",
                split=self._split, shard=sid, error_class="quarantined")
        self.shards_read.add(sid)
        return self._cache.get((self._split, sid),
                               lambda: self._read_verified(sid))

    def _read_verified(self, sid: int) -> np.ndarray:
        """The hardened read: raw bytes -> injection seam -> digest check ->
        decode, under bounded retry with exponential backoff.

        Failure classes: an ``OSError`` (EIO/ENOENT — flaky storage) is
        TRANSIENT and retried; a digest mismatch (torn/corrupted bytes) is
        verified per attempt and retried in case the tear was in the read
        rather than on disk. A shard that exhausts its retries is
        QUARANTINED with a ``data_fault`` + ``shard_quarantine`` record
        (logged at the next ``data_plane`` drain) and the pass aborts with ``ShardReadError`` —
        garbage bytes never become rows. The backoff wait is interruptible
        (``interrupt_reads``) so a drain/preemption never waits out the
        schedule."""
        from ..resilience import inject
        path = os.path.join(self._dir, self._files[sid])
        expect = self._digests[sid]
        retries = self.read_retries
        last: tuple[str, str] | None = None   # (error_class, detail)
        for attempt in range(retries + 1):
            if attempt:
                self.retries_used += 1
                delay = self.read_backoff_s * (2 ** (attempt - 1))
                if delay > 0 and _READ_INTERRUPT.wait(delay):
                    raise ShardReadError(
                        f"{self._split} shard {sid}: retry backoff "
                        "interrupted by drain/preemption",
                        split=self._split, shard=sid,
                        error_class="interrupted", retries=attempt - 1)
            self._read_counts[sid] = k = self._read_counts.get(sid, 0) + 1
            try:
                inject.fire("shard_read", shard=sid, split=self._split,
                            read=k)
                with open(path, "rb") as fh:
                    raw = fh.read()
            except OSError as e:
                last = ("transient_io", repr(e)[:200])
                continue
            raw = inject.transform("shard_read", raw, shard=sid,
                                   split=self._split, read=k)
            got = hashlib.sha256(raw).hexdigest()
            if got != expect:
                last = ("digest_mismatch",
                        f"manifest {expect[:12]}…, read {got[:12]}…")
                continue
            if attempt:
                # Recovered in place: no restart, no quarantine — but the
                # retries and their cause are on the record.
                _note_fault("data_fault", split=self._split, shard=sid,
                            rank=_rank(), error_class=last[0] if last
                            else "transient_io", retries=attempt,
                            recovered=True, detail=last[1] if last else None)
            return np.load(io.BytesIO(raw), allow_pickle=False)
        error_class, detail = last if last is not None else ("unknown", "")
        self.quarantined.add(sid)
        _note_fault("data_fault", split=self._split, shard=sid, rank=_rank(),
                    error_class=error_class, retries=retries, recovered=False,
                    detail=detail)
        _note_fault("shard_quarantine", split=self._split, shard=sid,
                    rank=_rank(), error_class=error_class,
                    file=self._files[sid])
        if self.skip_quarantined:
            # Opt-in degraded mode: the pass continues on a zero placeholder;
            # the quarantined rows are dropped from the prune decision and
            # the drop recorded in the provenance sidecar (quarantined_rows).
            count = int(self._starts[sid + 1] - self._starts[sid])
            return np.zeros((count, *self.shape[1:]), self.dtype)
        raise ShardReadError(
            f"{self._split} shard {sid} ({self._files[sid]}): "
            f"{error_class} after {retries} retries ({detail}) — shard "
            "quarantined; rows were NOT served",
            split=self._split, shard=sid, error_class=error_class,
            retries=retries)

    def quarantined_rows(self) -> np.ndarray:
        """Row indices covered by quarantined shards (the set the degraded
        ``skip_quarantined`` prune path drops and records)."""
        if not self.quarantined:
            return np.empty(0, np.int64)
        return np.concatenate([
            np.arange(self._starts[sid], self._starts[sid + 1])
            for sid in sorted(self.quarantined)])

    def __getitem__(self, rows):
        if isinstance(rows, (int, np.integer)):
            return self[np.array([int(rows)])][0]
        if isinstance(rows, slice):
            rows = np.arange(*rows.indices(self.shape[0]))
        rows = np.asarray(rows)
        if rows.ndim != 1:
            raise IndexError("ShardedImages supports 1-D row gathers only")
        out = np.empty((len(rows), *self.shape[1:]), self.dtype)
        sids = np.searchsorted(self._starts, rows, side="right") - 1
        if len(rows) and (rows.min() < 0 or rows.max() >= self.shape[0]):
            raise IndexError(
                f"row index out of range for {self.shape[0]} rows")
        for sid in np.unique(sids):
            data = self._load_shard(int(sid))
            sel = sids == sid
            out[sel] = data[rows[sel] - self._starts[sid]]
        return out

    def __array__(self, dtype=None, copy=None):
        # Explicit whole-array materialization (ds.dense(), np.asarray):
        # bypasses the cache budget by design — callers asking for the dense
        # copy have already decided it fits (fits_residency / maybe_resident).
        out = self[np.arange(self.shape[0])]
        return out if dtype is None else out.astype(dtype)


def load_sharded(data_dir: str,
                 host_cache_bytes: int = DEFAULT_HOST_CACHE_BYTES, *,
                 read_retries: int = DEFAULT_READ_RETRIES,
                 read_backoff_s: float = DEFAULT_READ_BACKOFF_S,
                 skip_quarantined: bool = False):
    """Open a sharded dataset directory: ``(train, test)`` ``ArrayDataset``s
    whose images are shard-backed virtual arrays sharing ONE decoded-shard
    cache bounded by ``host_cache_bytes``. uint8 shards stay raw and
    normalize per batch at assembly (the lazy ``.npy`` convention); float32
    shards are already in model units. ``read_retries``/``read_backoff_s``/
    ``skip_quarantined`` parameterize the hardened digest-verifying read
    path (``data.read_retries`` etc.)."""
    from .datasets import ArrayDataset
    manifest = read_manifest(data_dir)
    norm = None
    if manifest.get("norm") is not None:
        norm = (np.asarray(manifest["norm"]["mean"], np.float32),
                np.asarray(manifest["norm"]["std"], np.float32))
    cache = ShardCache(host_cache_bytes)
    out = []
    for split in ("train", "test"):
        meta = manifest["splits"].get(split)
        if meta is None:
            raise ValueError(f"{manifest_path(data_dir)}: missing split "
                             f"{split!r}")
        labels = np.load(os.path.join(data_dir, meta["labels"]["file"]))
        images = ShardedImages(data_dir, split, meta, cache,
                               read_retries=read_retries,
                               read_backoff_s=read_backoff_s,
                               skip_quarantined=skip_quarantined)
        ds_norm = norm if images.dtype == np.uint8 else None
        out.append(ArrayDataset(
            images=images, labels=np.ascontiguousarray(labels, np.int32),
            indices=np.arange(meta["n"], dtype=np.int32),
            num_classes=int(manifest["num_classes"]), norm=ds_norm))
    return tuple(out)
