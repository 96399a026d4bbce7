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
from typing import NamedTuple

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


def gather_resident_batch(images: torch.Tensor, labels: torch.Tensor,
                          indices: torch.Tensor, idx: torch.Tensor,
                          mask: torch.Tensor) -> dict:
    """THE device-side batch composition (the JAX package's
    ``gather_resident_batch``): rows ``idx`` of the resident arrays, the
    padded rows' label and index zeroed by ``mask``. One definition for the
    per-step ``ResidentBatches`` gather and the chunk bodies
    (``train/steps.py::make_train_chunk``), so the two cannot drift."""
    valid = mask.to(torch.int32)
    return {"image": images.index_select(0, idx),
            "label": labels.index_select(0, idx) * valid,
            "index": indices.index_select(0, idx) * valid,
            "mask": mask}


def _epoch_blocks(n: int, batch_size: int, shuffle: bool, seed: int,
                  epoch: int) -> tuple[np.ndarray, np.ndarray]:
    """The epoch's ``[nb, B]`` row indices and mask: the order of
    ``epoch_permutation``, the tail padded with row 0 and mask 0."""
    nb = num_batches(n, batch_size)
    take = np.zeros(nb * batch_size, np.int64)
    take[:n] = _order(n, shuffle, seed, epoch)
    mask = np.zeros(nb * batch_size, np.float32)
    mask[:n] = 1.0
    return take.reshape(nb, -1), mask.reshape(nb, -1)


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

    @property
    def image_shape(self) -> tuple:
        return tuple(self.images.shape[1:])

    @property
    def image_dtype(self) -> torch.dtype:
        return self.images.dtype

    def __call__(self, *, shuffle: bool = False, seed: int = 0,
                 epoch: int = 0) -> Iterator[dict]:
        # One upload an epoch: a copy from pageable host memory waits for the
        # device's queue to drain, so a copy a batch would serialize the steps.
        take, mask = _epoch_blocks(self.n, self.batch_size, shuffle, seed, epoch)
        if self.image_slice is not None:
            p, nprocs = self.image_slice
            loc = self.batch_size // nprocs
            take, mask = take[:, p * loc:(p + 1) * loc], mask[:, p * loc:(p + 1) * loc]
        take_d = torch.from_numpy(np.ascontiguousarray(take)).to(self.device)
        mask_d = torch.from_numpy(np.ascontiguousarray(mask)).to(self.device)
        for rows, m in zip(take_d, mask_d):
            yield gather_resident_batch(self.images, self.labels, self.indices, rows, m)

    def chunk_indices(self, chunk_steps: int, *, shuffle: bool = False, seed: int = 0,
                      epoch: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """``(idx, mask)`` host blocks ``[K, B]`` for the chunked engine: the
        epoch composition of ``__call__`` (order, row-0 tail padding, mask),
        ``chunk_steps`` steps at a time; the last block carries the remainder
        (its own chunk length, never a padded dispatch that would run extra
        optimizer steps). Single process, as the chunked engine is."""
        if self.image_slice is not None:
            raise ValueError("chunk_indices: the chunked engine is single-process")
        take, mask = _epoch_blocks(self.n, self.batch_size, shuffle, seed, epoch)
        for start in range(0, len(take), chunk_steps):
            yield take[start:start + chunk_steps], mask[start:start + chunk_steps]


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


def _tensors(item) -> list[torch.Tensor]:
    """The tensors of a batch dict or a ``ChunkBlock``."""
    vals = item.values() if isinstance(item, dict) else item
    return [t for t in vals if isinstance(t, torch.Tensor)]


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
        for t in _tensors(batch):
            t.record_stream(stream)
        return batch


def _pinned_uploads(host_batches, device: torch.device, slots: int,
                    keep_host: tuple = ()):
    """Each host batch copied into one of ``slots`` pinned buffers and
    uploaded from it with ``non_blocking=True`` on a copy stream of this
    thread's own; yields ``(device batch, copy event)``. A slot is refilled
    only once its last copy has completed: a slot reused earlier would send
    the next batch's bytes in place of the last one's. Keys in ``keep_host``
    pass through as host arrays. A slot is sized by its first batch: a
    shorter one (an epoch's tail block) gets a ring slot of its own shape."""
    torch.cuda.set_device(device)   # the current device and stream are per thread
    copy_stream = torch.cuda.Stream(device)
    ring: list[dict] = []
    for i, hb in enumerate(host_batches):
        up = {k: v for k, v in hb.items() if k not in keep_host}
        shapes = {k: v.shape for k, v in up.items()}
        if len(ring) < slots or any(ring[i % slots][k].shape != s
                                    for k, s in shapes.items()):
            new = {"event": None, **{
                k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype,
                               pin_memory=True) for k, v in up.items()}}
            if len(ring) < slots:
                ring.append(new)
            else:
                if ring[i % slots]["event"] is not None:
                    ring[i % slots]["event"].synchronize()
                ring[i % slots] = new
        slot = ring[i % slots]
        if slot["event"] is not None:
            slot["event"].synchronize()
        for k, v in up.items():
            slot[k].numpy()[...] = v
        with torch.cuda.stream(copy_stream):
            batch = {k: (hb[k] if k in keep_host else slot[k].to(device, non_blocking=True))
                     for k in hb}
            copied = torch.cuda.Event()
            copied.record(copy_stream)
        slot["event"] = copied
        yield batch, copied


def prefetch_host(host_items, device, depth: int, stage: str) -> PrefetchIterator:
    """Host dicts of arrays as dicts of tensors on ``device``, ``depth``
    ahead on an assembler thread: on a CUDA device through the pinned ring
    of ``depth + 1`` buffers on a copy stream, the consumer's stream waiting
    for each copy; on the CPU the host arrays are the tensors."""
    device = torch.device(device)
    if device.type != "cuda":
        return PrefetchIterator((to_device(hb, device) for hb in host_items), depth, stage)
    if device.index is None:   # the assembler thread has a current device of its own
        device = torch.device("cuda", torch.cuda.current_device())
    return _CudaPrefetch(_pinned_uploads(host_items, device, max(0, depth) + 1), depth,
                         stage, device)


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
    host = (local_rows(hb, image_slice)
            for hb in iterate_batches(ds, batch_size, shuffle=shuffle, seed=seed,
                                      epoch=epoch, image_slice=image_slice))
    return prefetch_host(host, device, depth, stage)


class ChunkBlock(NamedTuple):
    """One prefetched block of the chunked stream (the JAX package's
    ``ChunkBlock``): ``images`` ``[K·B, ...]`` float32 (the chunk's copy into
    its static block casts them to ``image_dtype`` as the resident upload
    does), ``labels`` and ``indices`` ``[K·B]`` int32 (padded rows zeroed) on the
    device; ``idx`` (``arange(K·B)`` as ``[K, B]``: the identity gather) and
    ``mask`` ``[K, B]`` on the host, staged with the chunk's other inputs."""

    images: torch.Tensor
    labels: torch.Tensor
    indices: torch.Tensor
    idx: np.ndarray
    mask: np.ndarray


class StreamingBatches:
    """The streaming twin of ``ResidentBatches`` for the chunked engine
    (``data.data_plane=streaming``): nothing stays on the device; an
    assembler thread gathers the next block of ``chunk_steps`` batches from
    ``iterate_batches`` (the same permutation, row-0 tail padding and zeroed
    labels and indices) and uploads it while the current chunk runs, so the
    chunk reads exactly the batches the resident gather makes. Device memory
    holds about ``prefetch_depth + 1`` blocks. Single process."""

    def __init__(self, ds: ArrayDataset, batch_size: int, device,
                 image_dtype: torch.dtype = torch.float32, *, prefetch_depth: int = 2):
        self.ds = ds
        self.n = len(ds)
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.image_dtype = image_dtype
        self.image_shape = tuple(ds.images.shape[1:])
        self.prefetch_depth = prefetch_depth

    def _host_block(self, pend: list[dict]) -> dict:
        k, b = len(pend), self.batch_size
        images = np.concatenate([hb["image"] for hb in pend])
        return {"images": images, "labels": np.concatenate([hb["label"] for hb in pend]),
                "indices": np.concatenate([hb["index"] for hb in pend]),
                "idx": np.arange(k * b, dtype=np.int64).reshape(k, b),
                "mask": np.stack([hb["mask"] for hb in pend])}

    def chunk_blocks(self, chunk_steps: int, *, shuffle: bool = False, seed: int = 0,
                     epoch: int = 0) -> PrefetchIterator:
        """One epoch of ``ChunkBlock``s, assembled and uploaded
        ``prefetch_depth`` blocks ahead; the tail block is shorter."""
        def host_blocks():
            pend: list[dict] = []
            for hb in iterate_batches(self.ds, self.batch_size, shuffle=shuffle,
                                      seed=seed, epoch=epoch):
                pend.append(hb)
                if len(pend) == chunk_steps:
                    yield self._host_block(pend)
                    pend = []
            if pend:
                yield self._host_block(pend)

        if self.device.type != "cuda":
            blocks = (ChunkBlock(torch.from_numpy(hb["images"]),
                                 torch.from_numpy(hb["labels"]),
                                 torch.from_numpy(hb["indices"]), hb["idx"], hb["mask"])
                      for hb in host_blocks())
            return PrefetchIterator(blocks, self.prefetch_depth, "train")
        device = self.device
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        uploads = ((ChunkBlock(d["images"], d["labels"], d["indices"], d["idx"], d["mask"]),
                    ev)
                   for d, ev in _pinned_uploads(host_blocks(), device,
                                                max(0, self.prefetch_depth) + 1,
                                                keep_host=("idx", "mask")))
        return _CudaPrefetch(uploads, self.prefetch_depth, "train", device)


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
