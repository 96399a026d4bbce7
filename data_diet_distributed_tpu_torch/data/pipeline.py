"""Batch assembly and the data planes (counterpart of
``data_diet_distributed_tpu/data/pipeline.py``).

Every batch is a dict ``{image, label, index, mask}`` of the one geometry
``[B, ...]``: the tail batch is padded with dataset row 0, label and index 0
and mask 0, exactly as the JAX package's assembler does. The padded rows are
real inputs (they enter BatchNorm's batch statistics in training); the mask
only weights losses, counts and scores.

Shuffling is a pure function of ``(seed, epoch)`` (``epoch_permutation``).
``iterate_batches`` assembles batches on the host (``data/native.py``,
normalizing a lazy dataset's rows); ``ResidentBatches`` uploads the set once
and gathers each batch on the device by the same permutation;
``prefetch_stream`` is the streaming plane: an assembler thread runs
``depth`` batches ahead and, on a CUDA device, uploads each from a ring of
pinned buffers on a copy stream of its own. All three give the same batches.

Across P slices (``image_slice=(r, P)``: ``parallel.mesh.batch_slice()``
for training and eval, P the data ranks; ``flat_slice()`` for scoring, P
every rank) the global batch of ``B`` rows (a multiple of P) splits into P
contiguous slices and slice r holds rows ``[r·B/P, (r+1)·B/P)`` of every
batch, as the JAX package's ``BatchSharder`` places them: ``iterate_batches`` then gathers the
images of those rows only, and ``ResidentBatches`` and ``prefetch_stream``
yield the rank's rows of every key.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections.abc import Iterator

import numpy as np
import torch

from . import sharded
from .datasets import ArrayDataset
from .native import BatchAssembler

#: Auto device-residency cap (bytes of images in the upload dtype), as the JAX
#: package's ``RESIDENT_MAX_BYTES``; CIFAR-10 in bf16 is 0.3 GiB.
RESIDENT_MAX_BYTES = 2 << 30


def num_batches(n: int, batch_size: int) -> int:
    return (n + batch_size - 1) // batch_size


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """Deterministic per-epoch shuffle (``pipeline.py:38-40`` of the JAX package)."""
    return np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(n)


def pad_batch(images: np.ndarray, labels: np.ndarray, batch_size: int,
              pad_image: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(images[B], labels[B], mask[B])`` from ``n <= B`` rows: the tail is
    ``pad_image`` (the dataset's row 0), label 0, mask 0."""
    n = len(images)
    if n > batch_size:
        raise ValueError(f"{n} rows exceed the batch geometry B={batch_size}")
    imgs = np.empty((batch_size, *pad_image.shape), np.float32)
    imgs[:n] = images
    imgs[n:] = pad_image
    labs = np.zeros(batch_size, np.int32)
    labs[:n] = labels
    mask = np.zeros(batch_size, np.float32)
    mask[:n] = 1.0
    return imgs, labs, mask


def _order(n: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    return epoch_permutation(n, seed, epoch) if shuffle else np.arange(n)


def iterate_batches(ds: ArrayDataset, batch_size: int, *, shuffle: bool = False,
                    seed: int = 0, epoch: int = 0,
                    image_slice: tuple[int, int] | None = None) -> Iterator[dict]:
    """Yield padded, masked batches as host numpy dicts ``{image, label,
    index, mask}``, in dataset order or in ``epoch_permutation(n, seed,
    epoch)`` order with ``shuffle``; a lazy dataset's rows are normalized as
    they are gathered.

    ``image_slice=(p, P)``: gather only the ``p``-th of ``P`` contiguous row
    slices of each batch's images (padded with row 0 where the slice runs
    past the data); label, index and mask stay global, as in the JAX
    package (``local_rows`` cuts them)."""
    asm = BatchAssembler()
    n = len(ds)
    order = _order(n, shuffle, seed, epoch)
    for start in range(0, n, batch_size):
        take = order[start:start + batch_size].astype(np.int64)
        if image_slice is None:
            image, label, index, mask = asm.assemble(ds.images, ds.labels, ds.indices,
                                                     take, batch_size, norm=ds.norm)
        else:
            p, nprocs = image_slice
            if batch_size % nprocs:
                raise ValueError(
                    f"batch of {batch_size} rows does not divide over {nprocs} "
                    "processes; use parallel.mesh.global_batch_size_for")
            loc = batch_size // nprocs
            mask = np.zeros(batch_size, np.float32)
            mask[:len(take)] = 1.0
            full = np.concatenate([take, np.zeros(batch_size - len(take), np.int64)])
            label = np.asarray(ds.labels[full], np.int32).copy()
            index = np.asarray(ds.indices[full], np.int32).copy()
            label[len(take):] = 0
            index[len(take):] = 0
            image = asm.assemble_images(ds.images, take[p * loc:(p + 1) * loc], loc,
                                        norm=ds.norm)
        yield {"image": image, "label": label, "index": index, "mask": mask}


def local_rows(batch: dict, image_slice: tuple[int, int] | None) -> dict:
    """A host batch of ``iterate_batches(..., image_slice=...)`` with its
    global label, index and mask cut to the rank's rows (the image already
    is); the batch itself when ``image_slice`` is None."""
    if image_slice is None:
        return batch
    p, nprocs = image_slice
    loc = len(batch["mask"]) // nprocs
    return {k: (v if k == "image" else v[p * loc:(p + 1) * loc])
            for k, v in batch.items()}


def to_device(batch: dict, device) -> dict:
    """A host batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class ResidentBatches:
    """The set uploaded to the device once (images in ``image_dtype``, the
    model's compute dtype: it casts its input anyway), then each batch an
    on-device gather by the epoch's permutation: per epoch only the
    permutation crosses to the device. Batches equal ``iterate_batches``'
    (order, row-0 tail padding, zeroed label and index, mask); with
    ``image_slice`` each is the rank's rows of the global batch of
    ``batch_size``."""

    def __init__(self, ds: ArrayDataset, batch_size: int, device,
                 image_dtype: torch.dtype = torch.float32,
                 image_slice: tuple[int, int] | None = None):
        ds = ds.dense()   # a lazy dataset uploads its normalized rows
        self.n = len(ds)
        self.batch_size = batch_size
        self.image_slice = image_slice
        if image_slice is not None and batch_size % image_slice[1]:
            raise ValueError(f"batch of {batch_size} rows does not divide over "
                             f"{image_slice[1]} processes")
        self.device = torch.device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(ds.images)).to(
            self.device, image_dtype)
        self.labels = torch.from_numpy(np.ascontiguousarray(ds.labels, np.int32)).to(
            self.device)
        self.indices = torch.from_numpy(np.ascontiguousarray(ds.indices, np.int32)).to(
            self.device)

    def __call__(self, *, shuffle: bool = False, seed: int = 0,
                 epoch: int = 0) -> Iterator[dict]:
        nb = num_batches(self.n, self.batch_size)
        take = np.zeros(nb * self.batch_size, np.int64)
        take[:self.n] = _order(self.n, shuffle, seed, epoch)
        mask = np.zeros(nb * self.batch_size, np.float32)
        mask[:self.n] = 1.0
        # One upload an epoch: a copy from pageable host memory waits for the
        # device's queue to drain, so a copy a batch would serialize the steps.
        take, mask = take.reshape(nb, -1), mask.reshape(nb, -1)
        if self.image_slice is not None:
            p, nprocs = self.image_slice
            loc = self.batch_size // nprocs
            take, mask = take[:, p * loc:(p + 1) * loc], mask[:, p * loc:(p + 1) * loc]
        take_d = torch.from_numpy(np.ascontiguousarray(take)).to(self.device)
        mask_d = torch.from_numpy(np.ascontiguousarray(mask)).to(self.device)
        for rows, m in zip(take_d, mask_d):
            valid = m.to(torch.int32)
            yield {"image": self.images.index_select(0, rows),
                   "label": self.labels.index_select(0, rows) * valid,
                   "index": self.indices.index_select(0, rows) * valid,
                   "mask": m}


def maybe_resident(ds: ArrayDataset, batch_size: int, device,
                   image_dtype: torch.dtype = torch.float32,
                   enabled: bool | None = None,
                   image_slice: tuple[int, int] | None = None) -> ResidentBatches | None:
    """``ResidentBatches`` when ``enabled`` is True, or when it is None and
    the images fit ``RESIDENT_MAX_BYTES`` in ``image_dtype`` (the logical
    shape: a lazy dataset uploads normalized rows); else None (the caller
    streams)."""
    if enabled is False:
        return None
    nbytes = (int(np.prod(ds.images.shape))
              * torch.empty((), dtype=image_dtype).element_size())
    if enabled is None and nbytes > RESIDENT_MAX_BYTES:
        return None
    return ResidentBatches(ds, batch_size, device, image_dtype, image_slice)


class PrefetchIterator:
    """Run a producer iterator ``depth`` items ahead on an assembler thread
    (``data.prefetch_depth``), so the consumer's dispatch loop does not wait
    on host assembly while the device is busy.

    The consumer waits in bounded ``queue.get`` polls, so the watchdog's
    signal and SIGTERM still land in the main thread. ``close()`` (``fit``
    calls it when an epoch ends, however it ends) stops the thread and
    drains the queue, waking a shard read parked in its retry backoff. A
    producer exception re-raises in the consumer with its coordinates
    (``data_plane_coords``: stage, item, split, shard, error class). Every
    wait after the first item is a stall (``stats()``; ``stall_frac`` over the
    elapsed time); the first is warm-up. ``depth <= 0`` runs the producer
    inline on the consumer thread, with the same accounting."""

    _SENTINEL = object()
    _POLL_S = 0.5

    def __init__(self, producer, depth: int = 2, stage: str = "stream"):
        self.stage = stage
        self.depth = max(0, int(depth))
        self.stall_s = 0.0
        self.warmup_s = 0.0
        self.items = 0
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._exhausted = False
        self._t_first: float | None = None
        self._t_last: float | None = None
        self._thread: threading.Thread | None = None
        if self.depth > 0:
            self._q: queue.Queue = queue.Queue(maxsize=self.depth)
            self._thread = threading.Thread(target=self._run, args=(producer,),
                                            name=f"prefetch:{stage}", daemon=True)
            self._thread.start()
        else:
            self._producer = iter(producer)

    def _run(self, producer) -> None:
        try:
            for item in producer:
                if not self._put(item):
                    return   # closed mid-epoch: drop the in-flight item
        except BaseException as e:   # noqa: BLE001 — re-raised in the consumer
            self._exc = e
        finally:
            self._put(self._SENTINEL)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        t0 = time.perf_counter()
        if self._thread is None:
            try:
                item = next(self._producer)
            except StopIteration:
                self._exhausted = True
                raise
        else:
            while True:
                try:
                    item = self._q.get(timeout=self._POLL_S)
                    break
                except queue.Empty:
                    continue   # a bounded poll: signals land between them
        now = time.perf_counter()
        if item is self._SENTINEL:
            self._exhausted = True
            if self._exc is not None:
                exc, self._exc = self._exc, None
                coords = {"stage": self.stage, "batch_index": self.items,
                          "split": getattr(exc, "split", None),
                          "shard": getattr(exc, "shard", None),
                          "error_class": getattr(exc, "error_class", None)}
                try:
                    exc.data_plane_coords = coords
                except AttributeError:   # an exception class with __slots__
                    pass
                shard = ("" if coords["shard"] is None else
                         f", {coords['split']} shard {coords['shard']}"
                         f" [{coords['error_class']}]")
                exc.add_note(f"[prefetch:{self.stage}] raised in the assembler "
                             f"thread while producing item {self.items}{shard}")
                raise exc
            raise StopIteration
        if self.items == 0:
            self.warmup_s = now - t0
            self._t_first = now
        else:
            self.stall_s += now - t0
        self.items += 1
        self._t_last = now
        return item

    def close(self) -> None:
        """Stop the assembler and drain the queue (idempotent); a producer
        parked in a shard read's retry backoff is woken (the read raises
        ``interrupted``)."""
        self._stop.set()
        if self._thread is None:
            return
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            sharded.interrupt_reads()
            try:
                self._thread.join(timeout=10.0)
            finally:
                sharded.resume_reads()
        else:
            self._thread.join(timeout=10.0)

    def stats(self) -> dict:
        elapsed = ((self._t_last - self._t_first)
                   if self._t_first is not None and self.items > 1 else 0.0)
        return {"stage": self.stage, "prefetch_depth": self.depth,
                "items": self.items, "stall_s": self.stall_s,
                "warmup_s": self.warmup_s, "elapsed_s": elapsed,
                "stall_frac": self.stall_s / elapsed if elapsed > 0 else 0.0}


class _CudaPrefetch(PrefetchIterator):
    """The consumer's half of the pinned upload: its stream waits for the
    batch's copy event, and the batch's memory is marked in use by that
    stream (``record_stream``), so the allocator frees it only after the work
    queued on it."""

    def __init__(self, producer, depth: int, stage: str, device: torch.device):
        self.device = device
        super().__init__(producer, depth, stage)

    def __next__(self) -> dict:
        batch, copied = super().__next__()
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(copied)
        for t in batch.values():
            t.record_stream(stream)
        return batch


def _pinned_uploads(host_batches, device: torch.device, slots: int):
    """Each host batch copied into one of ``slots`` pinned buffers and
    uploaded from it with ``non_blocking=True`` on a copy stream of this
    thread's own; yields ``(device batch, copy event)``. A slot is refilled
    only once its last copy has completed: a slot reused earlier would send
    the next batch's bytes in place of the last one's."""
    torch.cuda.set_device(device)   # the current device and stream are per thread
    copy_stream = torch.cuda.Stream(device)
    ring: list[dict] = []
    for i, hb in enumerate(host_batches):
        if len(ring) < slots:
            ring.append({"event": None, **{
                k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype,
                               pin_memory=True) for k, v in hb.items()}})
        slot = ring[i % slots]
        if slot["event"] is not None:
            slot["event"].synchronize()
        for k, v in hb.items():
            slot[k].numpy()[...] = v
        with torch.cuda.stream(copy_stream):
            batch = {k: slot[k].to(device, non_blocking=True) for k in hb}
            copied = torch.cuda.Event()
            copied.record(copy_stream)
        slot["event"] = copied
        yield batch, copied


def prefetch_stream(ds: ArrayDataset, batch_size: int, device, *, shuffle: bool = False,
                    seed: int = 0, epoch: int = 0, depth: int = 2,
                    stage: str = "train",
                    image_slice: tuple[int, int] | None = None) -> PrefetchIterator:
    """The streaming plane: ``iterate_batches``' batches as tensors on
    ``device``, assembled ``depth`` batches ahead on a thread (``depth <= 0``:
    inline); with ``image_slice`` the rank's rows of each (``local_rows``).
    On a CUDA device each is uploaded from a ring of ``depth + 1`` pinned
    buffers on a copy stream of its own, and the consumer's stream waits for
    its copy; on the CPU the host arrays are the tensors."""
    device = torch.device(device)
    host = (local_rows(hb, image_slice)
            for hb in iterate_batches(ds, batch_size, shuffle=shuffle, seed=seed,
                                      epoch=epoch, image_slice=image_slice))
    if device.type != "cuda":
        return PrefetchIterator((to_device(hb, device) for hb in host), depth, stage)
    if device.index is None:   # the assembler thread has a current device of its own
        device = torch.device("cuda", torch.cuda.current_device())
    return _CudaPrefetch(_pinned_uploads(host, device, max(0, depth) + 1), depth,
                         stage, device)


def host_cache_of(ds: ArrayDataset):
    """The dataset's decoded-shard cache (``sharded.ShardCache``) when its
    images are shard-backed; None otherwise."""
    return getattr(getattr(ds, "images", None), "cache", None)


def data_plane_record(stage: str, engine: str, stats: dict | None,
                      ds: ArrayDataset | None = None) -> dict:
    """The ``data_plane`` record's fields, one shape for every stage: the
    engine, the prefetch stall accounting (``PrefetchIterator.stats()`` or a
    ``merge_stall_stats`` total; None when nothing was prefetched) and the
    shard cache's bytes in use, budget and evictions."""
    stats = stats or {}
    cache = host_cache_of(ds) if ds is not None else None
    rec = {"stage": stage, "engine": engine,
           "prefetch_depth": int(stats.get("prefetch_depth", 0)),
           "stall_s": round(float(stats.get("stall_s", 0.0)), 6),
           "stall_frac": round(float(stats.get("stall_frac", 0.0)), 6),
           "host_cache_bytes_in_use": int(cache.bytes_in_use) if cache else 0}
    if stats.get("items"):
        rec["items"] = int(stats["items"])
        rec["warmup_s"] = round(float(stats.get("warmup_s", 0.0)), 6)
    if cache is not None:
        rec["host_cache_evictions"] = cache.evictions
        rec["host_cache_budget_bytes"] = cache.budget_bytes
    return rec


@contextlib.contextmanager
def logging_data_plane(log, stage: str, engine: str, stats: dict,
                       ds: ArrayDataset | None, tag: str | None = None):
    """Around one pass (a fit, a scoring pass): when it ends, however it ends,
    drain the pending shard-read fault records into ``log(kind, **fields)``
    and log one ``data_plane`` record from ``stats`` (filled during the pass),
    with ``fault`` naming the exception that ended it (None when none did)
    and, for a fit, its ``tag``. ``log`` None logs nothing."""
    fault = None
    try:
        yield
    except BaseException as err:   # named in the record, then re-raised
        fault = f"{type(err).__name__}: {err}"[:300]
        raise
    finally:
        if log is not None:
            for rec in sharded.drain_fault_records():
                log(rec.pop("kind"), **rec)
            record = data_plane_record(stage, engine, stats, ds)
            images = getattr(ds, "images", None)
            if getattr(images, "retries_used", 0):
                record["read_retries_used"] = int(images.retries_used)
            if getattr(images, "quarantined", None):
                record["quarantined_shards"] = sorted(int(s) for s in images.quarantined)
            log("data_plane", **({"tag": tag} if tag is not None else {}), **record,
                fault=fault)


def merge_stall_stats(total: dict, stats: dict) -> dict:
    """Fold one pass's ``PrefetchIterator.stats()`` into a running total, in
    place (the same shape, so ``data_plane_record`` takes either)."""
    if not total:
        total.update(stats)
        return total
    total["items"] += stats.get("items", 0)
    total["stall_s"] += stats.get("stall_s", 0.0)
    total["warmup_s"] += stats.get("warmup_s", 0.0)
    total["elapsed_s"] += stats.get("elapsed_s", 0.0)
    total["stall_frac"] = (total["stall_s"] / total["elapsed_s"]
                           if total["elapsed_s"] > 0 else 0.0)
    return total


class EvalBatchCache:
    """The test set's device batches kept across evals while the geometry is
    unchanged, up to ``max_bytes`` of float32 images; a larger set streams
    afresh each eval."""

    def __init__(self, max_bytes: int = RESIDENT_MAX_BYTES):
        self.max_bytes = max_bytes
        self._key = None
        self._batches: list | None = None

    def stream(self, ds: ArrayDataset, batch_size: int, device,
               image_slice: tuple[int, int] | None = None):
        key = (id(ds), len(ds), batch_size, str(device), image_slice)
        if self._batches is not None and self._key == key:
            return iter(self._batches)
        batches = prefetch_stream(ds, batch_size, device, depth=0, stage="eval",
                                  image_slice=image_slice)
        if int(np.prod(ds.images.shape)) * 4 > self.max_bytes:
            return batches
        self._key, self._batches = key, list(batches)
        return iter(self._batches)
