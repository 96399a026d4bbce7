"""Convert a dataset into the sharded on-disk format (data/sharded.py).

The port's copy of ``tools/make_shards.py``: the same arguments and output, built
on the port's own modules, so it runs on a host without JAX::

    python -m data_diet_distributed_tpu_torch.tools.make_shards ...

Sources:

* an npz dir (``{src}/train.npz`` + ``test.npz``, keys ``images``/``labels`` —
  the bring-your-own ImageNet-subset convention) or its ``npz_to_npy.py``
  conversion (``{split}_images.npy`` mmaps; preferred for multi-GB sets: rows
  stream straight from the mmap into shards, no decoded copy in RAM);
* a CIFAR python-batches dir (``--dataset cifar10|cifar100``);
* the synthetic generators (``--dataset synthetic|synthetic_imagenet``) for
  fixtures and CPU-lane benchmarking.

uint8 images are sharded RAW with per-channel train-split stats recorded in
the manifest (in [0,1] units — normalization stays per-batch at assembly,
bit-identical to the npz/npy lazy path); float32 images are sharded as-is.

``--verify`` re-hashes an existing manifest instead of converting: every
shard and label file is digested against the manifest (the checkpoint-tier
discipline) and a torn shard is a loud nonzero exit, never silent garbage.

Usage::

    python -m data_diet_distributed_tpu_torch.tools.make_shards SRC_DIR --out SHARD_DIR [--shard-size 4096]
    python -m data_diet_distributed_tpu_torch.tools.make_shards --dataset cifar10 SRC_DIR --out SHARD_DIR
    python -m data_diet_distributed_tpu_torch.tools.make_shards --verify SHARD_DIR
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..data import sharded
from ..data.datasets import (
    CIFAR10_MEAN, CIFAR10_STD, CIFAR100_MEAN, CIFAR100_STD,
    _chunked_channel_stats, _load_cifar_batches, _load_npy_mmap, _synthetic,
    has_npy_splits)


def _load_source(args):
    """``(splits {name: (images, labels)}, num_classes, norm)`` — images stay
    raw (uint8 where the source is uint8; mmap-backed when possible)."""
    if args.dataset in ("cifar10", "cifar100"):
        (train_x, train_y), (test_x, test_y) = _load_cifar_batches(
            args.src, args.dataset)
        norm = ((CIFAR10_MEAN, CIFAR10_STD) if args.dataset == "cifar10"
                else (CIFAR100_MEAN, CIFAR100_STD))
        return ({"train": (train_x, train_y), "test": (test_x, test_y)},
                10 if args.dataset == "cifar10" else 100, norm)
    if args.dataset in ("synthetic", "synthetic_imagenet"):
        hw, classes = ((96, 100) if args.dataset == "synthetic_imagenet"
                       else (32, 10))
        train_x, train_y = _synthetic(args.size, classes, args.seed, "train",
                                      hw)
        test_x, test_y = _synthetic(max(args.size // 4, classes), classes,
                                    args.seed, "test", hw)
        return ({"train": (train_x, train_y), "test": (test_x, test_y)},
                classes, None)   # float32 in model units: no lazy stats
    # npz / converted-npy dir
    if has_npy_splits(args.src):
        arrays, norm = _load_npy_mmap(args.src)
        splits = {s: (x, y) for s, (x, y) in arrays.items()}
    else:
        splits = {}
        for split in ("train", "test"):
            path = os.path.join(args.src, f"{split}.npz")
            if not os.path.exists(path):
                raise FileNotFoundError(f"npz dataset missing {path}")
            with np.load(path) as f:
                splits[split] = (np.asarray(f["images"]),
                                 np.asarray(f["labels"], np.int32))
        train_x = splits["train"][0]
        norm = (_chunked_channel_stats(train_x)
                if train_x.dtype == np.uint8 else None)
    num_classes = int(max(y.max() for _, y in splits.values())) + 1
    if splits["train"][0].dtype != np.uint8:
        norm = None   # float32 source: already in model units
    return splits, num_classes, norm


def convert(args) -> int:
    splits_src, num_classes, norm = _load_source(args)
    # Resumable conversion: a prior manifest in --out (an interrupted or
    # repeated run) lets write_split reuse any shard whose on-disk digest
    # already matches — only missing/divergent shards are rewritten.
    prior_splits: dict = {}
    if sharded.is_sharded_dir(args.out):
        try:
            prior_splits = sharded.read_manifest(args.out).get("splits", {})
        except (OSError, ValueError, json.JSONDecodeError):
            prior_splits = {}   # unreadable prior: full rewrite
    split_meta = {}
    reused: dict[str, list[str]] = {}
    for split, (images, labels) in splits_src.items():
        reused[split] = []
        split_meta[split] = sharded.write_split(
            args.out, split, images, np.asarray(labels, np.int32),
            shard_size=args.shard_size, prior=prior_splits.get(split),
            reused=reused[split])
    path = sharded.write_manifest(args.out, split_meta, num_classes, norm)
    # Record the reuse in the manifest so --verify can report it later.
    from ..utils.io import atomic_write_json
    manifest = sharded.read_manifest(args.out)
    manifest["conversion"] = {
        "resumed": any(reused.values()),
        "reused": {s: names for s, names in reused.items() if names},
        "rewritten": {s: len(m["shards"]) - len(reused[s])
                      for s, m in split_meta.items()},
    }
    atomic_write_json(path, manifest)
    print(json.dumps({
        "manifest": path,
        "splits": {s: {"n": m["n"], "shards": len(m["shards"]),
                       "reused": len(reused[s]),
                       "image_dtype": m["image_dtype"]}
                   for s, m in split_meta.items()},
        "num_classes": num_classes,
        "norm": norm is not None,
    }))
    return 0


def verify(target: str) -> int:
    problems = sharded.verify_manifest(target)
    for p in problems:
        print(f"VERIFY FAIL: {p}", file=sys.stderr)
    if problems:
        print(f"{target}: {len(problems)} problem(s) — shard set is NOT "
              "intact", file=sys.stderr)
        return 1
    manifest = sharded.read_manifest(target)
    print(f"OK: {target}: "
          + ", ".join(f"{s}[n={m['n']}, {len(m['shards'])} shards]"
                      for s, m in manifest["splits"].items()))
    conv = manifest.get("conversion") or {}
    if conv.get("resumed"):
        for split, names in sorted((conv.get("reused") or {}).items()):
            print(f"resumed conversion reused {len(names)} {split} "
                  f"shard(s): {', '.join(names)}")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert a dataset to sharded .npy + digested manifest, "
                    "or --verify an existing shard dir")
    parser.add_argument("src", help="source dir (npz/npy/CIFAR batches), or "
                                    "the shard dir with --verify")
    parser.add_argument("--out", help="output shard directory")
    parser.add_argument("--dataset", default="npz",
                        choices=["npz", "cifar10", "cifar100", "synthetic",
                                 "synthetic_imagenet"])
    parser.add_argument("--shard-size", type=int,
                        default=sharded.DEFAULT_SHARD_SIZE,
                        help="rows per shard; for multi-process runs set to "
                             "global_batch/world so each rank's batch slice "
                             "falls entirely in its owned shards")
    parser.add_argument("--size", type=int, default=2048,
                        help="train rows for the synthetic datasets")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--verify", action="store_true",
                        help="re-hash SRC's manifest instead of converting")
    args = parser.parse_args(argv)
    if args.verify:
        return verify(args.src)
    if not args.out:
        parser.error("--out is required when converting")
    return convert(args)


if __name__ == "__main__":
    raise SystemExit(main())
