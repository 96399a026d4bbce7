"""Command line of the PyTorch port (counterpart of ``data_diet_distributed_tpu/cli.py``).

Only ``score`` is ported::

    python -m data_diet_distributed_tpu_torch.cli score --config configs/x.yaml \\
        score.pretrain_epochs=0 [key=value ...] [--device cpu]

It scores the training set at initialization (``score.pretrain_epochs=0``,
GraNd/EL2N at init, one model per ``score.seeds`` entry) and writes
``<train.checkpoint_dir>_scores.npz`` with ``scores``, ``indices`` and ``method``.
``train``, ``run``, ``sweep`` and ``serve``, and scoring after a pretrain or
from a checkpoint, need the training slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .config import Config, load_config
from .data.datasets import load_dataset
from .device import resolve_device
from .models import create_model_from_cfg
from .ops.scoring import score_dataset
from .weights import init_variables

_TRAINING_SLICE = "needs the training slice of the PyTorch port, not ported yet"


def _atomic_savez(path: str, **arrays) -> None:
    """Write the npz next to its final name, then rename: a kill mid-write
    never leaves a truncated artifact."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def score(cfg: Config, device=None) -> dict:
    """The ``score`` command: score, save the npz, return a summary."""
    sc = cfg.score
    if sc.pretrain_epochs > 0:
        raise NotImplementedError(
            f"score.pretrain_epochs={sc.pretrain_epochs} {_TRAINING_SLICE}; "
            "set score.pretrain_epochs=0 to score at initialization")
    if sc.score_ckpt_step is not None:
        raise NotImplementedError(f"score.score_ckpt_step {_TRAINING_SLICE}")
    if sc.scores_npz:
        raise NotImplementedError("score.scores_npz reuse is not ported yet")
    device = resolve_device(device)
    train_ds, _ = load_dataset(cfg.data.dataset, cfg.data.data_dir,
                               cfg.data.synthetic_size, seed=cfg.train.seed,
                               synthetic_noise=cfg.data.synthetic_noise,
                               synthetic_clusters=cfg.data.synthetic_clusters)
    cfg.model.num_classes = train_ds.num_classes
    model = create_model_from_cfg(cfg)
    seeds_vars = [init_variables(cfg.model.arch, int(s), device,
                                 num_classes=cfg.model.num_classes,
                                 stem=cfg.model.stem) for s in sc.seeds]
    t0 = time.perf_counter()
    scores = score_dataset(model, seeds_vars, train_ds, method=sc.method,
                           batch_size=sc.batch_size, chunk=sc.grand_chunk,
                           eval_mode=sc.eval_mode,
                           use_kernels=sc.use_pallas, device=device)
    score_s = time.perf_counter() - t0
    out = f"{cfg.train.checkpoint_dir}_scores.npz"
    _atomic_savez(out, scores=scores, indices=train_ds.indices, method=sc.method)
    return {"n_scores": int(len(scores)), "scores_npz": out,
            "score_s": round(score_s, 3), "device": str(device),
            "mean": float(scores.mean()), "std": float(scores.std())}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="data_diet_distributed_tpu_torch.cli")
    parser.add_argument("command", choices=("score", "train", "run", "sweep", "serve"))
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without CUDA) or cpu")
    parser.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    args = parser.parse_args(argv)
    if args.command != "score":
        raise NotImplementedError(f"the {args.command!r} command {_TRAINING_SLICE}")
    cfg = load_config(args.config, args.overrides)
    print(json.dumps({"event": "scores_saved", **score(cfg, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
