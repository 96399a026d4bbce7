"""Host batch assembly (counterpart of ``data_diet_distributed_tpu/data/pipeline.py``).

Scoring iterates the dataset in order; the tail batch is padded to full size with
row-0 images, zeroed labels and indices, and mask 0, exactly as the JAX package's
assembler does, so every batch has the one geometry ``[B, ...]``.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from .datasets import ArrayDataset


def num_batches(n: int, batch_size: int) -> int:
    return (n + batch_size - 1) // batch_size


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


def iterate_batches(ds: ArrayDataset, batch_size: int) -> Iterator[dict]:
    """Yield padded, masked batches in dataset order (no shuffle) as host numpy
    dicts ``{image, label, index, mask}``."""
    n = len(ds)
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        image, label, mask = pad_batch(ds.images[start:stop], ds.labels[start:stop],
                                       batch_size, ds.images[0])
        index = np.zeros(batch_size, np.int32)
        index[:stop - start] = ds.indices[start:stop]
        yield {"image": image, "label": label, "index": index, "mask": mask}
