"""Whole-dataset scoring with multi-seed averaging (counterpart of
``data_diet_distributed_tpu/ops/scoring.py::score_dataset``), single process.

Each seed's pass accumulates into a float64 vector joined by global example
index; the result is the float64 mean over seeds cast to float32. The
resident mode uploads the dataset once as ``[nb, B, ...]`` batch tensors (the
``ScoreResident`` layout) and reuses them for every seed.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Sequence

import numpy as np
import torch

from ..data.datasets import ArrayDataset, make_position_joiner
from ..data.pipeline import iterate_batches, num_batches, pad_batch
from ..device import resolve_device, set_scoring_determinism
from ..weights import variables_to
from .scores import make_local_scores, resolve_score_method, resolve_use_kernels

# Keep the dataset on the device across seeds up to this many bytes of float32
# images (CIFAR-10's 50k x 32x32x3 is 0.6 GB).
_DEVICE_RESIDENT_MAX_BYTES = 4 << 30


class ScoreResident:
    """The dataset pre-batched on the device: ``images`` [nb, B, H, W, C],
    ``labels`` and ``mask`` [nb, B], in dataset order with the tail batch
    padded by row-0 images, zeroed labels and mask 0. ``index`` and
    ``valid`` stay on the host for the score join."""

    def __init__(self, ds: ArrayDataset, batch_size: int, device):
        self.n = len(ds)
        self.nb = num_batches(self.n, batch_size)
        self.batch_size = batch_size
        total = self.nb * batch_size
        imgs, labels, mask = pad_batch(ds.images, ds.labels, total, ds.images[0])
        index = np.zeros(total, np.int32)
        index[:self.n] = ds.indices
        shape = (self.nb, batch_size)
        self.images = torch.from_numpy(imgs.reshape(*shape, *imgs.shape[1:])).to(device)
        self.labels = torch.from_numpy(labels.reshape(shape)).to(device)
        self.mask = torch.from_numpy(mask.reshape(shape)).to(device)
        self.index = index.reshape(shape)
        self.valid = mask.reshape(shape).astype(bool)

    def batches(self):
        for i in range(self.nb):
            yield (self.index[i], self.valid[i],
                   (self.images[i], self.labels[i], self.mask[i]))


def resident_by_default(n_seeds: int, ds: ArrayDataset) -> bool:
    """``score_dataset``'s residency rule: several seeds and a dataset under
    ``_DEVICE_RESIDENT_MAX_BYTES`` of float32 images."""
    return n_seeds > 1 and ds.images.size * 4 <= _DEVICE_RESIDENT_MAX_BYTES


def _streamed_batches(ds: ArrayDataset, batch_size: int, device):
    for hb in iterate_batches(ds, batch_size):
        yield (hb["index"], hb["mask"].astype(bool),
               tuple(torch.from_numpy(hb[k]).to(device)
                     for k in ("image", "label", "mask")))


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
                  device=None) -> np.ndarray:
    """Score every example; returns ``scores[N]`` float32 aligned with ``ds``.

    ``variables_seeds`` holds one variables mapping per scoring seed; the
    result is the per-example mean over seeds (float64 sums, cast last).
    ``device`` defaults to CUDA and raises without it (pass ``"cpu"`` for the
    CPU); ``model`` is moved there. ``chunk`` is ``grand_vmap``'s examples per
    ``vmap`` (``score.grand_chunk``). ``use_kernels`` (None = on) routes through
    the hand-written kernels on the card. ``device_resident`` (None = auto:
    several seeds and a dataset under 4 GB) uploads the batches once for every
    seed.
    ``on_seed_done(k, seed_scores)`` fires after seed ``k``'s pass with its
    float64 vector."""
    device = resolve_device(device)
    if device.type == "cuda":
        set_scoring_determinism()
    model = model.to(device).eval()
    local = make_local_scores(model, resolve_score_method(method, eval_mode),
                              chunk=chunk, eval_mode=eval_mode,
                              use_kernels=resolve_use_kernels(use_kernels))
    variables_seeds = [variables_to(v, device) for v in variables_seeds]
    n = len(ds)
    pos_of = make_position_joiner(ds.indices)
    if device_resident is None:
        device_resident = resident_by_default(len(variables_seeds), ds)
    resident = ScoreResident(ds, batch_size, device) if device_resident else None
    total = np.zeros(n, np.float64)
    for k, variables in enumerate(variables_seeds):
        batches = (resident.batches() if resident is not None
                   else _streamed_batches(ds, batch_size, device))
        seed_scores = score_pass(local, variables, batches, n, pos_of)
        total += seed_scores
        if on_seed_done is not None:
            on_seed_done(k, seed_scores)
    return (total / len(variables_seeds)).astype(np.float32)
