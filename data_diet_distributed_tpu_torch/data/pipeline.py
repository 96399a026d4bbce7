"""Batch assembly (counterpart of ``data_diet_distributed_tpu/data/pipeline.py``).

Every batch is a dict ``{image, label, index, mask}`` of the one geometry
``[B, ...]``: the tail batch is padded with dataset row 0, label and index 0
and mask 0, exactly as the JAX package's assembler does. The padded rows are
real inputs (they enter BatchNorm's batch statistics in training); the mask
only weights losses, counts and scores.

Shuffling is a pure function of ``(seed, epoch)`` (``epoch_permutation``).
``iterate_batches`` assembles batches on the host; ``ResidentBatches`` uploads
the set once and gathers each batch on the device by the same permutation,
so the two give identical batches.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from .datasets import ArrayDataset

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
                    seed: int = 0, epoch: int = 0) -> Iterator[dict]:
    """Yield padded, masked batches as host numpy dicts ``{image, label,
    index, mask}``, in dataset order or in ``epoch_permutation(n, seed,
    epoch)`` order with ``shuffle``."""
    n = len(ds)
    order = _order(n, shuffle, seed, epoch)
    for start in range(0, n, batch_size):
        take = order[start:start + batch_size]
        image, label, mask = pad_batch(ds.images[take], ds.labels[take], batch_size,
                                       ds.images[0])
        index = np.zeros(batch_size, np.int32)
        index[:len(take)] = ds.indices[take]
        yield {"image": image, "label": label, "index": index, "mask": mask}


def to_device(batch: dict, device) -> dict:
    """A host batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class ResidentBatches:
    """The set uploaded to the device once (images in ``image_dtype``, the
    model's compute dtype: it casts its input anyway), then each batch an
    on-device gather by the epoch's permutation: per epoch only the
    permutation crosses to the device. Batches equal ``iterate_batches``'
    (order, row-0 tail padding, zeroed label and index, mask)."""

    def __init__(self, ds: ArrayDataset, batch_size: int, device,
                 image_dtype: torch.dtype = torch.float32):
        self.n = len(ds)
        self.batch_size = batch_size
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
        take_d = torch.from_numpy(take.reshape(nb, -1)).to(self.device)
        mask_d = torch.from_numpy(mask.reshape(nb, -1)).to(self.device)
        for rows, m in zip(take_d, mask_d):
            valid = m.to(torch.int32)
            yield {"image": self.images.index_select(0, rows),
                   "label": self.labels.index_select(0, rows) * valid,
                   "index": self.indices.index_select(0, rows) * valid,
                   "mask": m}


def maybe_resident(ds: ArrayDataset, batch_size: int, device,
                   image_dtype: torch.dtype = torch.float32,
                   enabled: bool | None = None) -> ResidentBatches | None:
    """``ResidentBatches`` when ``enabled`` is True, or when it is None and
    the images fit ``RESIDENT_MAX_BYTES`` in ``image_dtype``; else None (the
    caller assembles batches on the host)."""
    if enabled is False:
        return None
    nbytes = ds.images.size * torch.empty((), dtype=image_dtype).element_size()
    if enabled is None and nbytes > RESIDENT_MAX_BYTES:
        return None
    return ResidentBatches(ds, batch_size, device, image_dtype)
