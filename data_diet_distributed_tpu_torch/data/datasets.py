"""Datasets as host numpy arrays with explicit global indices.

A copy of ``data_diet_distributed_tpu/data/datasets.py``: ``ArrayDataset``
(eager normalized float32, or lazy raw images plus ``norm`` normalized per
batch at assembly), ``make_position_joiner``, the synthetic generators
(bit-identical to the JAX package's for the same seed — numpy on both sides),
the local CIFAR-10/100 pickles, the bring-your-own ``npz`` splits, their
memory-mapped ``.npy`` conversions and the sharded on-disk format
(``data/sharded.py``). No network download.
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
    """Images in NHWC, integer labels, and GLOBAL indices: ``indices[i]`` is the
    example's identity in the full dataset and survives subsetting, so a score
    can always be joined back to its example.

    Two image layouts, as in the JAX package:

    * eager (``norm is None``): ``images`` is normalized float32 in host RAM;
    * lazy (``norm = (mean, std)``): ``images`` holds raw uint8 (or float32 in
      its own units) — a ``np.memmap`` of the ``.npy`` splits or the
      shard-backed ``ShardedImages`` — and each batch is normalized when it is
      assembled (``data/native.py``)."""

    images: np.ndarray    # [N, H, W, C]; float32 (eager) or uint8 (lazy)
    labels: np.ndarray    # [N] int32
    indices: np.ndarray   # [N] int32, global example ids
    num_classes: int
    # Lazy-normalization stats (uint8: in [0, 1] units); None = eager.
    norm: tuple[np.ndarray, np.ndarray] | None = None

    def __len__(self) -> int:
        return len(self.labels)

    def subset(self, keep: np.ndarray) -> "ArrayDataset":
        """Rows whose GLOBAL ids are in ``keep`` (as pruning produces them). On
        a lazy dataset the selected raw rows come into RAM and the result
        stays lazy."""
        pos = make_position_joiner(self.indices)(keep)
        return replace(self, images=self.images[pos], labels=self.labels[pos],
                       indices=self.indices[pos])

    def dense(self) -> "ArrayDataset":
        """An eager copy of a lazy dataset (identity for an eager one), by the
        JAX package's division ``(x / 255 - mean) / std``. The per-batch
        gather multiplies by ``1 / std`` instead, so the two can differ in the
        last ulp, as they do in the JAX package."""
        if self.norm is None:
            return self
        mean, std = self.norm
        if self.images.dtype == np.uint8:
            images = _normalize(np.asarray(self.images), mean, std)
        else:   # float32 with explicit stats: normalized in its own units
            images = (np.asarray(self.images, np.float32) - mean) / std
        return replace(self, images=images, norm=None)


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


def _chunked_channel_stats(x_uint8: np.ndarray, chunk: int = 4096):
    """Per-channel mean and std of uint8 images in [0, 1] units, in float64
    chunks, so a multi-GB array never gets a whole float copy."""
    n = 0
    s = np.zeros(x_uint8.shape[-1], np.float64)
    s2 = np.zeros(x_uint8.shape[-1], np.float64)
    for i in range(0, len(x_uint8), chunk):
        c = x_uint8[i:i + chunk].astype(np.float64) / 255.0
        s += c.sum(axis=(0, 1, 2))
        s2 += np.square(c).sum(axis=(0, 1, 2))
        n += c.shape[0] * c.shape[1] * c.shape[2]
    mean = s / n
    std = np.sqrt(np.maximum(s2 / n - mean**2, 0.0)) + 1e-8
    return mean.astype(np.float32), std.astype(np.float32)


def _load_npz(data_dir: str):
    """``{data_dir}/train.npz`` and ``test.npz`` with ``images`` (NHWC uint8 or
    float32) and ``labels``: uint8 is scaled to [0, 1] and normalized with the
    train split's channel statistics, or with explicit ``mean``/``std`` from
    train.npz; float32 with explicit stats is normalized in its own units,
    float32 without is taken as normalized."""
    paths = {s: os.path.join(data_dir, f"{s}.npz") for s in ("train", "test")}
    for p in paths.values():
        if not os.path.exists(p):
            raise FileNotFoundError(f"npz dataset missing {p}")
    # Each member read once (every [] on an NpzFile decompresses again).
    with np.load(paths["train"]) as f:
        train_x = np.asarray(f["images"])
        train_y = np.asarray(f["labels"], np.int32)
        explicit = "mean" in f and "std" in f
        mean = np.asarray(f["mean"], np.float32) if explicit else None
        std = np.asarray(f["std"], np.float32) if explicit else None
    with np.load(paths["test"]) as f:
        test_x = np.asarray(f["images"])
        test_y = np.asarray(f["labels"], np.int32)
    if train_x.dtype != test_x.dtype:
        # The splits would be normalized on different scales: refuse.
        raise ValueError(
            f"npz splits have mixed image dtypes (train {train_x.dtype}, test "
            f"{test_x.dtype}); make both splits the same dtype")
    derived = None
    if not explicit and train_x.dtype == np.uint8:
        derived = _chunked_channel_stats(train_x)

    def prep(x):
        if x.dtype == np.uint8:
            return _normalize(x, mean, std) if explicit else _normalize(x, *derived)
        x = x.astype(np.float32, copy=False)
        return (x - mean) / std if explicit else x

    return (prep(train_x), train_y), (prep(test_x), test_y)


def _npy_paths(data_dir: str) -> dict[str, dict[str, str]]:
    return {s: {"images": os.path.join(data_dir, f"{s}_images.npy"),
                "labels": os.path.join(data_dir, f"{s}_labels.npy")}
            for s in ("train", "test")}


def has_npy_splits(data_dir: str) -> bool:
    return all(os.path.exists(p) for split in _npy_paths(data_dir).values()
               for p in split.values())


def _load_npy_mmap(data_dir: str):
    """``{split}_images.npy`` + ``{split}_labels.npy`` opened with
    ``mmap_mode="r"``: the OS pages rows in as batches touch them. Lazy
    normalization stats come from ``stats.npz`` (``mean``/``std``; uint8 in
    [0, 1] units, float32 in its own) or, for uint8, one chunked pass over the
    train split; float32 without stats is taken as normalized. A ``.npz``
    newer than its ``.npy`` conversion is refused (stale data)."""
    paths = _npy_paths(data_dir)
    for split, p in paths.items():
        npz = os.path.join(data_dir, f"{split}.npz")
        if (os.path.exists(npz)
                and os.path.getmtime(npz) > os.path.getmtime(p["images"])):
            raise ValueError(
                f"{npz} is newer than its converted {p['images']}; re-run "
                "tools/npz_to_npy.py (or delete the .npy files to load the "
                "npz directly)")
    arrays = {split: (np.load(p["images"], mmap_mode="r"),
                      np.asarray(np.load(p["labels"]), np.int32))
              for split, p in paths.items()}
    train_x, test_x = arrays["train"][0], arrays["test"][0]
    if train_x.dtype != test_x.dtype:
        raise ValueError(
            f"npy splits have mixed image dtypes (train {train_x.dtype}, test "
            f"{test_x.dtype}); make both splits the same dtype")
    if train_x.dtype not in (np.uint8, np.float32):
        raise ValueError(f"npy images must be uint8 or float32, got {train_x.dtype}")
    norm = None
    stats_path = os.path.join(data_dir, "stats.npz")
    if os.path.exists(stats_path):
        with np.load(stats_path) as f:
            norm = (np.asarray(f["mean"], np.float32),
                    np.asarray(f["std"], np.float32))
    elif train_x.dtype == np.uint8:
        norm = _chunked_channel_stats(train_x)
    return arrays, norm


def load_dataset(dataset: str, data_dir: str = "./data", synthetic_size: int = 2048,
                 seed: int = 0, synthetic_noise: float = 0.4,
                 synthetic_clusters: int = 1, host_cache_bytes: int | None = None,
                 read_retries: int | None = None, read_backoff_s: float | None = None,
                 skip_quarantined: bool = False) -> tuple[ArrayDataset, ArrayDataset]:
    """``(train, test)`` for ``synthetic``, ``synthetic_imagenet`` (96x96, 100
    classes), ``cifar10``, ``cifar100``, ``npz`` (the ``.npy`` splits, memory
    mapped and lazy, when present) or ``sharded`` (images through a decoded-
    shard LRU cache of ``host_cache_bytes``, read with ``read_retries``
    retries ``read_backoff_s`` apart; ``skip_quarantined`` serves zeros for a
    shard that never verifies)."""
    if dataset == "sharded":
        from .sharded import (DEFAULT_HOST_CACHE_BYTES, DEFAULT_READ_BACKOFF_S,
                              DEFAULT_READ_RETRIES, load_sharded)
        return load_sharded(
            data_dir,
            host_cache_bytes if host_cache_bytes is not None
            else DEFAULT_HOST_CACHE_BYTES,
            read_retries=(read_retries if read_retries is not None
                          else DEFAULT_READ_RETRIES),
            read_backoff_s=(read_backoff_s if read_backoff_s is not None
                            else DEFAULT_READ_BACKOFF_S),
            skip_quarantined=skip_quarantined)
    if dataset == "npz" and has_npy_splits(data_dir):
        arrays, norm = _load_npy_mmap(data_dir)
        # Both splits count: a test-only class id must still fit the classifier.
        num_classes = int(max(arrays["train"][1].max(), arrays["test"][1].max())) + 1
        return tuple(ArrayDataset(images=x, labels=y,
                                  indices=np.arange(len(y), dtype=np.int32),
                                  num_classes=num_classes, norm=norm)
                     for x, y in (arrays["train"], arrays["test"]))
    if dataset == "synthetic":
        train_x, train_y = _synthetic(synthetic_size, 10, seed, "train",
                                      noise=synthetic_noise,
                                      clusters=synthetic_clusters)
        test_x, test_y = _synthetic(max(synthetic_size // 4, 64), 10, seed, "test",
                                    noise=synthetic_noise,
                                    clusters=synthetic_clusters)
        num_classes = 10
    elif dataset == "synthetic_imagenet":
        # ImageNet-geometry stand-in for BASELINE config 5: 96x96, 100 classes.
        train_x, train_y = _synthetic(synthetic_size, 100, seed, "train", 96,
                                      noise=synthetic_noise,
                                      clusters=synthetic_clusters)
        test_x, test_y = _synthetic(max(synthetic_size // 4, 100), 100, seed,
                                    "test", 96, noise=synthetic_noise,
                                    clusters=synthetic_clusters)
        num_classes = 100
    elif dataset == "npz":
        (train_x, train_y), (test_x, test_y) = _load_npz(data_dir)
        num_classes = int(max(train_y.max(), test_y.max())) + 1
    elif dataset in ("cifar10", "cifar100"):
        (train_raw, train_y), (test_raw, test_y) = _load_cifar_batches(data_dir,
                                                                       dataset)
        mean, std = ((CIFAR10_MEAN, CIFAR10_STD) if dataset == "cifar10"
                     else (CIFAR100_MEAN, CIFAR100_STD))
        train_x = _normalize(train_raw, mean, std)
        test_x = _normalize(test_raw, mean, std)
        num_classes = 10 if dataset == "cifar10" else 100
    else:
        raise ValueError(f"unknown dataset {dataset!r}")

    def make(x, y):
        return ArrayDataset(images=np.ascontiguousarray(x),
                            labels=y.astype(np.int32),
                            indices=np.arange(len(y), dtype=np.int32),
                            num_classes=num_classes)

    return make(train_x, train_y), make(test_x, test_y)
