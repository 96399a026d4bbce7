"""Datasets as host numpy arrays with explicit global indices.

A copy of the part of ``data_diet_distributed_tpu/data/datasets.py`` the scoring
slice needs: ``ArrayDataset``, ``make_position_joiner``, the synthetic
generator (bit-identical to the JAX package's for the same seed — it is numpy
there too) and the local CIFAR-10/100 pickle loader. No network download.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from dataclasses import dataclass, replace

import numpy as np

# The reference transform's channel statistics, folklore stds included.
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)


@dataclass(frozen=True)
class ArrayDataset:
    """Images in NHWC (normalized float32), integer labels, and GLOBAL indices:
    ``indices[i]`` is the example's identity in the full dataset and survives
    subsetting, so a score can always be joined back to its example."""

    images: np.ndarray    # [N, H, W, C] float32
    labels: np.ndarray    # [N] int32
    indices: np.ndarray   # [N] int32, global example ids
    num_classes: int

    def __len__(self) -> int:
        return len(self.labels)

    def subset(self, keep: np.ndarray) -> "ArrayDataset":
        """Rows whose GLOBAL ids are in ``keep`` (as pruning produces them)."""
        pos = make_position_joiner(self.indices)(keep)
        return replace(self, images=self.images[pos], labels=self.labels[pos],
                       indices=self.indices[pos])


def make_position_joiner(index_arr: np.ndarray):
    """A reusable ``global ids -> positions in index_arr`` mapper: an
    O(max_id) lookup table for dense id spaces, a sorted join for sparse ones.
    Unknown ids raise ``KeyError``."""
    n = len(index_arr)
    max_id = int(index_arr.max()) if n else 0
    if max_id + 1 <= 4 * n + 1024:
        lookup = np.full(max_id + 1, -1, np.int64)
        lookup[index_arr] = np.arange(n)

        def join(wanted: np.ndarray) -> np.ndarray:
            wanted = np.asarray(wanted)
            if wanted.size and ((wanted < 0).any() or (wanted > max_id).any()):
                raise KeyError("requested global indices not present in dataset")
            pos = lookup[wanted]
            if (pos < 0).any():
                raise KeyError("requested global indices not present in dataset")
            return pos
        return join

    order = np.argsort(index_arr, kind="stable")
    sorted_ids = index_arr[order]

    def join(wanted: np.ndarray) -> np.ndarray:
        slot = np.searchsorted(sorted_ids, wanted)
        ok = (slot < n) & (sorted_ids[np.minimum(slot, n - 1)] == wanted)
        if not ok.all():
            raise KeyError("requested global indices not present in dataset")
        return order[slot]
    return join


def _load_cifar_batches(data_dir: str, name: str):
    """The standard CIFAR python-pickle batches from a local directory or tarball."""
    sub = {"cifar10": "cifar-10-batches-py", "cifar100": "cifar-100-python"}[name]
    root = os.path.join(data_dir, sub)
    tar = os.path.join(data_dir, {"cifar10": "cifar-10-python.tar.gz",
                                  "cifar100": "cifar-100-python.tar.gz"}[name])
    if not os.path.isdir(root) and os.path.exists(tar):
        with tarfile.open(tar) as tf:
            tf.extractall(data_dir, filter="data")
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"no local {name} at {root} (and no tarball at {tar}); "
            "place the standard python-pickle batches there, or use dataset=synthetic")
    if name == "cifar10":
        train_files = [os.path.join(root, f"data_batch_{i}") for i in range(1, 6)]
        test_files = [os.path.join(root, "test_batch")]
        label_key = b"labels"
    else:
        train_files = [os.path.join(root, "train")]
        test_files = [os.path.join(root, "test")]
        label_key = b"fine_labels"

    def read(files):
        xs, ys = [], []
        for f in files:
            with open(f, "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.uint8))
            ys.append(np.asarray(d[label_key], np.int32))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x, np.concatenate(ys)

    return read(train_files), read(test_files)


def _normalize(x_uint8: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return ((x_uint8.astype(np.float32) / 255.0) - mean) / std


def _synthetic(size: int, num_classes: int, seed: int, split: str,
               image_size: int = 32, noise: float = 0.4, clusters: int = 1):
    """Deterministic class-structured fake data (``datasets.py:178-225`` of the
    JAX package, bit-identical): each class gets a fixed template plus noise;
    ``clusters > 1`` makes each class a Zipf-weighted mixture of templates."""
    template_rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD1E7]))
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, 1 if split == "train" else 2]))
    if clusters == 1:
        templates = template_rng.normal(
            0.0, 0.5, size=(num_classes, image_size, image_size, 3)).astype(np.float32)
        channel_sig = template_rng.normal(
            0.0, 1.0, size=(num_classes, 1, 1, 3)).astype(np.float32)
        labels = rng.integers(0, num_classes, size=size).astype(np.int32)
        pixel_noise = rng.normal(
            0.0, noise, size=(size, image_size, image_size, 3)).astype(np.float32)
        images = templates[labels] + channel_sig[labels] + pixel_noise
        return images, labels
    templates = template_rng.normal(
        0.0, 0.5,
        size=(num_classes, clusters, image_size, image_size, 3)).astype(np.float32)
    channel_sig = template_rng.normal(
        0.0, 1.0, size=(clusters, 1, 1, 3)).astype(np.float32)
    weights = 1.0 / np.arange(1, clusters + 1) ** 1.1
    weights /= weights.sum()
    labels = rng.integers(0, num_classes, size=size).astype(np.int32)
    cluster_of = rng.choice(clusters, size=size, p=weights).astype(np.int32)
    pixel_noise = rng.normal(
        0.0, noise, size=(size, image_size, image_size, 3)).astype(np.float32)
    images = templates[labels, cluster_of] + channel_sig[cluster_of] + pixel_noise
    return images, labels


def load_dataset(dataset: str, data_dir: str = "./data", synthetic_size: int = 2048,
                 seed: int = 0, synthetic_noise: float = 0.4,
                 synthetic_clusters: int = 1) -> tuple[ArrayDataset, ArrayDataset]:
    """``(train, test)`` for ``synthetic``, ``cifar10`` or ``cifar100``."""
    if dataset == "synthetic":
        train_x, train_y = _synthetic(synthetic_size, 10, seed, "train",
                                      noise=synthetic_noise,
                                      clusters=synthetic_clusters)
        test_x, test_y = _synthetic(max(synthetic_size // 4, 64), 10, seed, "test",
                                    noise=synthetic_noise,
                                    clusters=synthetic_clusters)
        num_classes = 10
    elif dataset in ("cifar10", "cifar100"):
        (train_raw, train_y), (test_raw, test_y) = _load_cifar_batches(data_dir,
                                                                       dataset)
        mean, std = ((CIFAR10_MEAN, CIFAR10_STD) if dataset == "cifar10"
                     else (CIFAR100_MEAN, CIFAR100_STD))
        train_x = _normalize(train_raw, mean, std)
        test_x = _normalize(test_raw, mean, std)
        num_classes = 10 if dataset == "cifar10" else 100
    else:
        raise NotImplementedError(
            f"dataset {dataset!r} is not ported yet (synthetic | cifar10 | cifar100)")

    def make(x, y):
        return ArrayDataset(images=np.ascontiguousarray(x),
                            labels=y.astype(np.int32),
                            indices=np.arange(len(y), dtype=np.int32),
                            num_classes=num_classes)

    return make(train_x, train_y), make(test_x, test_y)
