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
flattened mesh does, so train-mode scoring normalizes by the rank's rows. A
``{data: D, model: M}`` run scores on all W = D x M ranks (``flat_slice``)
with whole variables: the caller gathers a tensor-parallel head first
(``train/state.py::gather_head``), once per pass, as the JAX package
replicates them.
Per seed each rank fills the positions it owns in a float64 ``[N]`` vector,
and one float64 SUM across the ranks joins them (``collectives.sum_float64``):
each position has one owner, so every rank holds the same vector bitwise.

The chunked score engine (the JAX package's, ``ops/scoring.py:36-58`` and
``:342-480``): ``score.chunk_steps`` (null = auto: the whole epoch, up to
``MAX_SCORE_CHUNK_STEPS`` batches a dispatch; 0 or 1 = per batch; K > 1 =
requested) runs K batches of a single-process pass as one dispatch
(``scores.py::make_score_chunk``: on the card one CUDA-graph replay) over
the blocks of ``ScoreResident`` or, streaming, ``ScoreStream``; each seed's
pass fetches its stacked scores once (``score_resident_pass``), bitwise the
per-batch pass. Each chunk counts a ``dispatches_score_chunk`` dispatch and
is harvested as the ``score_chunk`` program.

Observability, as in the JAX package: each batch counts a
``dispatches_score_batch`` dispatch, the first batch of each geometry is the
introspector's ``score_batch`` program (``obs/introspect.py``), the fetch is
timed into ``score_fetch_s``, each completed seed goes to the scoreboard
(``score_stats``) before ``on_seed_done``, and a ``ProfileWindow`` may
capture the pass's steady batches.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Sequence

import numpy as np
import torch

from ..data.datasets import ArrayDataset, make_position_joiner
from ..data.pipeline import (iterate_batches, logging_data_plane, merge_stall_stats,
                             num_batches, pad_batch, prefetch_host, prefetch_stream)
from ..device import resolve_device, set_scoring_determinism
from ..graphs import GraphCache
from ..obs import introspect, scoreboard
from ..obs import registry as obs_registry
from ..parallel.collectives import sum_float64
from ..parallel.mesh import flat_slice, global_batch_size_for, world_size
from ..weights import variables_to
from .scores import (make_local_scores, make_score_chunk, make_warmup_scores,
                     resolve_score_method, resolve_use_kernels)

#: Clamp on the score chunk (batches a dispatch), the JAX package's: a chunk
#: is the granularity a signal can interleave at, and a capture records every
#: batch. 32 batches of 2048 cover CIFAR's 50k examples in one dispatch a seed.
MAX_SCORE_CHUNK_STEPS = 32


def resolve_score_chunk_steps(chunk_steps: int | None, n_batches: int,
                              resident: bool) -> int:
    """The chunked score engine's selection policy (the JAX package's): 1 for
    the per-batch path. None = auto: the whole epoch per dispatch up to the
    clamp, on a single-process pass over a block feed (``resident``: the
    resident blocks or the streamed ones); 0 or 1 = per batch; K > 1 =
    requested, clamped to the epoch and to ``MAX_SCORE_CHUNK_STEPS``."""
    if chunk_steps is not None and chunk_steps <= 1:
        return 1
    if not resident or world_size() > 1:
        return 1
    k = n_batches if chunk_steps is None else int(chunk_steps)
    return max(1, min(k, n_batches, MAX_SCORE_CHUNK_STEPS))

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

    def blocks(self, k_chunk: int):
        """``(images, labels, mask)`` blocks of at most ``k_chunk`` batches,
        views of the resident arrays (the chunk copies them into its static
        block)."""
        for s in range(0, self.nb, k_chunk):
            yield self.images[s:s + k_chunk], self.labels[s:s + k_chunk], self.mask[s:s + k_chunk]


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
        self.n = len(ds)
        self.nb = num_batches(self.n, batch_size)
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

    def blocks(self, k_chunk: int):
        """Prefetched ``(images, labels, mask)`` blocks of at most ``k_chunk``
        batches, ``ScoreResident.blocks``' contract: assembled from
        ``iterate_batches`` (dataset order, row-0 tail images, zeroed labels,
        mask 0) and uploaded ``prefetch_depth`` blocks ahead. One process."""
        def stacked(pend: list[dict]) -> dict:
            return {k: np.stack([p[k] for p in pend]) for k in ("image", "label", "mask")}

        def host_blocks():
            pend: list[dict] = []
            for hb in iterate_batches(self.ds, self.batch_size):
                pend.append(hb)
                if len(pend) == k_chunk:
                    yield stacked(pend)
                    pend = []
            if pend:
                yield stacked(pend)

        it = prefetch_host(host_blocks(), self.device, self.prefetch_depth, "score")
        try:
            for b in it:
                yield b["image"], b["label"], b["mask"]
        finally:
            it.close()
            merge_stall_stats(self.stall_stats, it.stats())


def score_batch(local_scores: Callable, variables: dict, image, label, mask):
    """One batch's scores: counted (``dispatches_score_batch``) and, the first
    time a geometry is seen, harvested as the ``score_batch`` program."""
    obs_registry.inc("dispatches_score_batch")
    shape = tuple(image.shape)
    return introspect.call("score_batch", local_scores, (variables, image, label, mask),
                           key=shape, examples=shape[0])


def score_pass(local_scores: Callable, variables: dict, batches: Iterable,
               n: int, pos_of: Callable, profile=None, unit: int = 0) -> np.ndarray:
    """One seed's pass: ``local_scores`` over every batch, then ONE fetch of
    the stacked scores; returns the float64 ``[n]`` vector in dataset order
    (joined by global index). Shared by ``score_dataset`` and the serving
    engine so the two cannot drift. ``profile`` (a ``ProfileWindow``) ticks
    before each batch with ``unit`` as its epoch."""
    metas, outs = [], []
    for idx, valid, (image, label, mask) in batches:
        metas.append((idx, valid))
        if profile is not None:
            profile.tick(unit)
        outs.append(score_batch(local_scores, variables, image, label, mask))
    seed_scores = np.zeros(n, np.float64)
    if not outs:
        return seed_scores
    with obs_registry.timed("score_fetch_s"):
        fetched = torch.stack(outs).cpu().numpy()
    for (idx, valid), scores in zip(metas, fetched):
        seed_scores[pos_of(idx[valid])] += scores[valid]
    return seed_scores


def _dispatch_score_chunk(program, variables: dict, images, labels, mask) -> torch.Tensor:
    """One chunked score dispatch: K batches, counted
    (``dispatches_score_chunk``). A module-level seam so tests can count and
    interpose at chunk boundaries."""
    obs_registry.inc("dispatches_score_chunk")
    copied = {f"var:{n}": t for n, t in variables.items()}
    copied.update(images=images, labels=labels, mask=mask)
    return program(None, copied)["scores"]


class ScoreChunks:
    """The score chunk programs of one scoring function, by chunk length, in
    a ``GraphCache``: one capture per method, block length and geometry.
    ``warm_scores`` is the function's plain route, the captures' warm-up;
    ``harvest=False`` keeps the programs out of the introspector."""

    def __init__(self, local_scores: Callable, graphs: GraphCache, device, tag: str = "",
                 warm_scores: Callable | None = None, harvest: bool = True):
        self.local = local_scores
        self.warm = warm_scores
        self.harvest = harvest
        self.graphs = graphs
        self.device = torch.device(device)
        self.tag = tag

    def _key(self, images: torch.Tensor) -> tuple:
        k, b = images.shape[:2]
        return ("score_chunk", self.tag, k, (b, *images.shape[2:]), str(images.dtype))

    def program(self, variables: dict, images: torch.Tensor):
        k, b = images.shape[:2]
        return self.graphs.get(self._key(images), lambda: make_score_chunk(
            self.local, variables, k, b, tuple(images.shape[2:]), self.device, self.warm,
            self.harvest))

    def captured(self, images: torch.Tensor) -> bool:
        """Whether the program of ``images``' block shape exists already."""
        return self._key(images) in self.graphs.programs

    def dispatch(self, variables: dict, images, labels, mask) -> torch.Tensor:
        """The ``[K, B]`` scores of one ``[K, B, ...]`` block."""
        return _dispatch_score_chunk(self.program(variables, images), variables, images,
                                     labels, mask)


def score_resident_pass(chunks: ScoreChunks, feed, variables: dict, k_chunk: int,
                        profile=None, unit: int = 0) -> np.ndarray:
    """ONE seed's pass over a block feed (``ScoreResident`` or
    ``ScoreStream``): ``ceil(nb / K)`` chunked dispatches and ONE fetch of the
    stacked score blocks. Returns the float64 ``[n]`` vector in dataset order
    (both feeds are in dataset order; float64 holds every float32, so a
    resumed partial's mean stays bitwise). Shared by ``score_dataset`` and the
    serving engine's warm pass. ``profile`` ticks before each dispatch."""
    outs = []
    for blk in feed.blocks(k_chunk):
        if profile is not None:
            profile.tick(unit)
        outs.append(chunks.dispatch(variables, *blk))
    if not outs:
        return np.zeros(feed.n, np.float64)
    with obs_registry.timed("score_fetch_s"):
        fetched = torch.cat(outs).cpu().numpy()
    return fetched.reshape(-1)[:feed.n].astype(np.float64)


def score_dataset(model, variables_seeds: Sequence[dict], ds: ArrayDataset, *,
                  method: str = "el2n", batch_size: int = 512, chunk: int = 32,
                  eval_mode: bool = True, use_kernels: bool | None = None,
                  device_resident: bool | None = None, on_seed_done=None,
                  data_plane: str = "auto", prefetch_depth: int = 2, log=None,
                  device=None, seed_ids: Sequence[int] | None = None,
                  profile=None, chunk_steps: int | None = None,
                  graphs: GraphCache | None = None) -> np.ndarray:
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
    float64 vector (the whole ``[N]`` one on every rank), after the
    scoreboard noted it under ``seed_ids[k]`` (default ``k``). ``profile``
    (a ``ProfileWindow`` whose epochs are the seeds) captures steady batches.

    ``chunk_steps`` (``score.chunk_steps``; ``resolve_score_chunk_steps``)
    arms the chunked engine on a single-process pass over the resident blocks
    or, under ``data_plane="streaming"``, the streamed ones; its programs go
    to ``graphs`` (a cache of this call's own when None, released at the
    end). With ``chunk_steps`` set and ``device_resident`` None the dataset
    is resident when it fits, as for several seeds.

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
    batch_size = global_batch_size_for(batch_size, flat=True)
    rows = flat_slice()
    n = len(ds)
    pos_of = make_position_joiner(ds.indices)
    if data_plane == "streaming":
        device_resident = False
    elif data_plane == "resident" and device_resident is None:
        device_resident = True
    if device_resident is None:
        device_resident = ((len(variables_seeds) > 1 or bool(chunk_steps))
                           and fits_residency(ds))
    k_chunk = resolve_score_chunk_steps(
        chunk_steps, num_batches(n, batch_size),
        bool(device_resident) or data_plane == "streaming")
    feed = (ScoreResident(ds, batch_size, device, rows) if device_resident
            else ScoreStream(ds, batch_size, device, prefetch_depth, rows))
    own = GraphCache() if graphs is None and k_chunk > 1 else None
    chunks = (ScoreChunks(local, graphs if graphs is not None else own, device, method,
                          warm_scores=make_warmup_scores(
                              model, resolve_score_method(method, eval_mode), chunk=chunk,
                              eval_mode=eval_mode))
              if k_chunk > 1 else None)
    total = np.zeros(n, np.float64)
    try:
        with logging_data_plane(None if device_resident else log, "score",
                                "chunked_stream" if chunks is not None else "stream",
                                getattr(feed, "stall_stats", {}), ds):
            for k, variables in enumerate(variables_seeds):
                seed_scores = (score_resident_pass(chunks, feed, variables, k_chunk,
                                                   profile=profile, unit=k)
                               if chunks is not None else
                               score_pass(local, variables, feed.batches(), n, pos_of,
                                          profile=profile, unit=k))
                if profile is not None:
                    profile.epoch_end(k)
                if world_size() > 1:
                    with obs_registry.timed("score_fetch_s"):
                        seed_scores = sum_float64(seed_scores)
                total += seed_scores
                # Before the caller's hook, which may raise at a seed boundary.
                scoreboard.note_seed_scores(
                    method, seed_ids[k] if seed_ids is not None else k, seed_scores)
                if on_seed_done is not None:
                    on_seed_done(k, seed_scores)
    finally:
        if own is not None:
            own.release()
    return (total / len(variables_seeds)).astype(np.float32)
