"""Convert the bring-your-own ``train.npz``/``test.npz`` dataset into the
memory-mapped ``.npy`` ingestion layout (the npz path materializes the whole
dataset in every host's RAM).

The port's copy of ``tools/npz_to_npy.py``: the same arguments and output, built
on the port's own modules, so it runs on a host without JAX::

    python -m data_diet_distributed_tpu_torch.tools.npz_to_npy ...

Output layout in ``--out`` (default: alongside the input):

    train_images.npy  train_labels.npy
    test_images.npy   test_labels.npy
    stats.npz         (uint8 inputs only: mean/std in [0,1] units)

``load_dataset("npz", data_dir)`` auto-detects these files and opens images
with ``mmap_mode="r"`` — batches then page in from disk and normalize at
assembly time, so host RAM holds batch buffers, not the dataset.

The conversion itself streams: npz members are decompressed once and written
straight to .npy via ``np.lib.format.open_memmap`` in chunks.

Run: ``python -m data_diet_distributed_tpu_torch.tools.npz_to_npy --data-dir
./data [--out ./data]``
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def convert_split(npz_path: str, out_dir: str, split: str,
                  chunk: int = 4096) -> tuple[tuple, np.dtype]:
    with np.load(npz_path) as f:
        images, labels = f["images"], f["labels"]
        out = np.lib.format.open_memmap(
            os.path.join(out_dir, f"{split}_images.npy"), mode="w+",
            dtype=images.dtype, shape=images.shape)
        for i in range(0, len(images), chunk):
            out[i:i + chunk] = images[i:i + chunk]
        out.flush()
        np.save(os.path.join(out_dir, f"{split}_labels.npy"),
                np.asarray(labels, np.int32))
        return images.shape, images.dtype


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", required=True,
                        help="directory holding train.npz and test.npz")
    parser.add_argument("--out", default=None,
                        help="output directory (default: --data-dir)")
    args = parser.parse_args(argv)
    out_dir = args.out or args.data_dir
    os.makedirs(out_dir, exist_ok=True)

    info = {}
    for split in ("train", "test"):
        npz_path = os.path.join(args.data_dir, f"{split}.npz")
        if not os.path.exists(npz_path):
            raise FileNotFoundError(npz_path)
        shape, dtype = convert_split(npz_path, out_dir, split)
        info[split] = {"shape": list(shape), "dtype": str(dtype)}

    # Normalization stats: preserve explicit ones from train.npz; else compute
    # once here (chunked) so load time never needs a full stats pass.
    from ..data.datasets import _chunked_channel_stats
    with np.load(os.path.join(args.data_dir, "train.npz")) as f:
        if "mean" in f and "std" in f:
            mean = np.asarray(f["mean"], np.float32)
            std = np.asarray(f["std"], np.float32)
        elif np.dtype(info["train"]["dtype"]) == np.uint8:
            train_mm = np.load(os.path.join(out_dir, "train_images.npy"),
                               mmap_mode="r")
            mean, std = _chunked_channel_stats(train_mm)
        else:
            mean = std = None
    if mean is not None:
        np.savez(os.path.join(out_dir, "stats.npz"), mean=mean, std=std)
        info["stats"] = {"mean": mean.tolist(), "std": std.tolist()}

    print(json.dumps({"out": out_dir, **info}))


if __name__ == "__main__":
    main()
