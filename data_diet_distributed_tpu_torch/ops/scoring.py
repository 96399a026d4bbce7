"""Whole-dataset scoring with multi-seed averaging (counterpart of
``data_diet_distributed_tpu/ops/scoring.py::score_dataset``), single process.

Each seed's pass accumulates into a float64 vector joined by global example
index; the result is the float64 mean over seeds cast to float32. The
resident plane uploads the dataset once as ``[nb, B, ...]`` batch tensors (the
``ScoreResident`` layout) and reuses them for every seed; the streaming plane
(``ScoreStream``) assembles and uploads the same batches per seed through
``prefetch_stream``, so its scores are bitwise the resident plane's.

Across W ranks each rank scores its rows of every global batch (the batch
rounded up to a multiple of W), as the JAX package's ``shard_map`` over the
flattened mesh does, so train-mode scoring normalizes by the rank's rows.
Per seed each rank fills the positions it owns in a float64 ``[N]`` vector,
and one float64 SUM across the ranks joins them (``collectives.sum_float64``):
each position has one owner, so every rank holds the same vector bitwise.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Sequence

import numpy as np
import torch

from ..data.datasets import ArrayDataset, make_position_joiner
from ..data.pipeline import (logging_data_plane, merge_stall_stats, num_batches,
                             pad_batch, prefetch_stream)
from ..device import resolve_device, set_scoring_determinism
from ..parallel.collectives import sum_float64
from ..parallel.mesh import global_batch_size_for, image_slice, world_size
from ..weights import variables_to
from .scores import make_local_scores, resolve_score_method, resolve_use_kernels

# Keep the dataset on the device across seeds up to this many bytes of float32
# images (CIFAR-10's 50k x 32x32x3 is 0.6 GB).
_DEVICE_RESIDENT_MAX_BYTES = 4 << 30


class ScoreResident:
    """The dataset pre-batched on the device: ``images`` [nb, B, H, W, C],
    ``labels`` and ``mask`` [nb, B], in dataset order with the tail batch
    padded by row-0 images, zeroed labels and mask 0. ``index`` and
    ``valid`` stay on the host for the score join. With ``image_slice=(r,
    W)`` only the rank's ``B/W`` rows of each batch are held."""

    def __init__(self, ds: ArrayDataset, batch_size: int, device,
                 image_slice: tuple[int, int] | None = None):
        ds = ds.dense()   # a lazy dataset uploads its normalized rows
        self.n = len(ds)
        self.nb = num_batches(self.n, batch_size)
        self.batch_size = batch_size
        total = self.nb * batch_size
        imgs, labels, mask = pad_batch(ds.images, ds.labels, total, ds.images[0])
        index = np.zeros(total, np.int32)
        index[:self.n] = ds.indices
        shape = (self.nb, batch_size)
        imgs = imgs.reshape(*shape, *imgs.shape[1:])
        labels, mask, index = labels.reshape(shape), mask.reshape(shape), index.reshape(shape)
        if image_slice is not None:
            p, nprocs = image_slice
            loc = batch_size // nprocs
            cut = slice(p * loc, (p + 1) * loc)
            imgs, labels, mask, index = (np.ascontiguousarray(a[:, cut])
                                         for a in (imgs, labels, mask, index))
        self.images = torch.from_numpy(imgs).to(device)
        self.labels = torch.from_numpy(labels).to(device)
        self.mask = torch.from_numpy(mask).to(device)
        self.index = index
        self.valid = mask.astype(bool)

    def batches(self):
        for i in range(self.nb):
            yield (self.index[i], self.valid[i],
                   (self.images[i], self.labels[i], self.mask[i]))


def fits_residency(ds: ArrayDataset) -> bool:
    """Whether the dataset's uploaded footprint (float32, however it is held on
    the host) fits ``_DEVICE_RESIDENT_MAX_BYTES``."""
    return int(np.prod(ds.images.shape)) * 4 <= _DEVICE_RESIDENT_MAX_BYTES


def resident_by_default(n_seeds: int, ds: ArrayDataset) -> bool:
    """``score_dataset``'s automatic residency rule: several seeds and a
    dataset that ``fits_residency``."""
    return n_seeds > 1 and fits_residency(ds)


class ScoreStream:
    """The streaming twin of ``ScoreResident``: each seed's pass assembles the
    batches in dataset order on the prefetch thread and uploads them through
    ``prefetch_stream`` (``prefetch_depth`` ahead), so nothing dataset-sized
    is held on the device. ``stall_stats`` totals the passes' prefetch
    accounting. With ``image_slice`` each batch is the rank's rows."""

    def __init__(self, ds: ArrayDataset, batch_size: int, device, prefetch_depth: int = 2,
                 image_slice: tuple[int, int] | None = None):
        self.ds = ds
        self.batch_size = batch_size
        self.device = device
        self.prefetch_depth = prefetch_depth
        self.image_slice = image_slice
        self.stall_stats: dict = {}

    def batches(self):
        it = prefetch_stream(self.ds, self.batch_size, self.device,
                             depth=self.prefetch_depth, stage="score",
                             image_slice=self.image_slice)
        n, bs = len(self.ds), self.batch_size
        p, nprocs = self.image_slice or (0, 1)
        loc = bs // nprocs
        try:
            for start, b in zip(range(0, n, bs), it):
                # The join's index and validity on the host, without a fetch.
                pos = start + p * loc + np.arange(loc)
                valid = pos < n
                index = np.zeros(loc, np.int32)
                index[valid] = self.ds.indices[pos[valid]]
                yield (index, valid, (b["image"], b["label"], b["mask"]))
        finally:
            it.close()
            merge_stall_stats(self.stall_stats, it.stats())


def score_pass(local_scores: Callable, variables: dict, batches: Iterable,
               n: int, pos_of: Callable) -> np.ndarray:
    """One seed's pass: ``local_scores`` over every batch, then ONE fetch of
    the stacked scores; returns the float64 ``[n]`` vector in dataset order
    (joined by global index). Shared by ``score_dataset`` and the serving
    engine so the two cannot drift."""
    metas, outs = [], []
    for idx, valid, (image, label, mask) in batches:
        metas.append((idx, valid))
        outs.append(local_scores(variables, image, label, mask))
    seed_scores = np.zeros(n, np.float64)
    if not outs:
        return seed_scores
    fetched = torch.stack(outs).cpu().numpy()
    for (idx, valid), scores in zip(metas, fetched):
        seed_scores[pos_of(idx[valid])] += scores[valid]
    return seed_scores


def score_dataset(model, variables_seeds: Sequence[dict], ds: ArrayDataset, *,
                  method: str = "el2n", batch_size: int = 512, chunk: int = 32,
                  eval_mode: bool = True, use_kernels: bool | None = None,
                  device_resident: bool | None = None, on_seed_done=None,
                  data_plane: str = "auto", prefetch_depth: int = 2, log=None,
                  device=None) -> np.ndarray:
    """Score every example; returns ``scores[N]`` float32 aligned with ``ds``.

    ``variables_seeds`` holds one variables mapping per scoring seed; the
    result is the per-example mean over seeds (float64 sums, cast last).
    ``device`` defaults to CUDA and raises without it (pass ``"cpu"`` for the
    CPU); ``model`` is moved there. ``chunk`` is ``grand_vmap``'s examples per
    ``vmap`` (``score.grand_chunk``). ``use_kernels`` (None = on) routes through
    the hand-written kernels on the card.

    The data plane (``data.data_plane``), by the JAX package's rules:
    ``"streaming"`` never holds the dataset on the device (``ScoreStream``,
    ``prefetch_depth`` batches ahead); ``"resident"`` uploads it once for every
    seed (``ScoreResident``) unless ``device_resident`` is False; ``"auto"``
    follows ``device_resident``, which None leaves to ``resident_by_default``.
    A streamed pass logs one ``data_plane`` record to ``log(kind, **fields)``,
    after the shard-read fault records it drains, even when it fails.
    ``on_seed_done(k, seed_scores)`` fires after seed ``k``'s pass with its
    float64 vector (the whole ``[N]`` one on every rank).

    In a process group of W ranks the call is a collective: ``batch_size``
    rounds up to a multiple of W and each rank scores its rows of every
    batch."""
    device = resolve_device(device)
    if device.type == "cuda":
        set_scoring_determinism()
    model = model.to(device).eval()
    local = make_local_scores(model, resolve_score_method(method, eval_mode),
                              chunk=chunk, eval_mode=eval_mode,
                              use_kernels=resolve_use_kernels(use_kernels))
    variables_seeds = [variables_to(v, device) for v in variables_seeds]
    batch_size = global_batch_size_for(batch_size)
    rows = image_slice()
    n = len(ds)
    pos_of = make_position_joiner(ds.indices)
    if data_plane == "streaming":
        device_resident = False
    elif data_plane == "resident" and device_resident is None:
        device_resident = True
    if device_resident is None:
        device_resident = resident_by_default(len(variables_seeds), ds)
    feed = (ScoreResident(ds, batch_size, device, rows) if device_resident
            else ScoreStream(ds, batch_size, device, prefetch_depth, rows))
    total = np.zeros(n, np.float64)
    with logging_data_plane(None if device_resident else log, "score", "stream",
                            getattr(feed, "stall_stats", {}), ds):
        for k, variables in enumerate(variables_seeds):
            seed_scores = score_pass(local, variables, feed.batches(), n, pos_of)
            if world_size() > 1:
                seed_scores = sum_float64(seed_scores)
            total += seed_scores
            if on_seed_done is not None:
                on_seed_done(k, seed_scores)
    return (total / len(variables_seeds)).astype(np.float32)
