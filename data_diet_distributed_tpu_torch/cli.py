"""Command line of the PyTorch port (counterpart of ``data_diet_distributed_tpu/cli.py``)::

    python -m data_diet_distributed_tpu_torch.cli {train|run|sweep|score} \\
        --config configs/x.yaml [key=value ...] [--device cpu]

* ``train``: dense training, checkpoints in ``train.checkpoint_dir``;
* ``run``: (pretrain ->) score -> prune -> retrain -> eval, writing
  ``<train.checkpoint_dir>_scores.npz`` and its provenance sidecar;
* ``sweep``: one scoring pass, then prune and retrain per ``prune.sweep``
  level;
* ``score``: score only (after ``score.pretrain_epochs`` epochs per seed, from
  ``score.score_ckpt_step``, or reused from ``score.scores_npz``) and write
  ``<train.checkpoint_dir>_scores.npz`` with ``scores``, ``indices`` and
  ``method``.

Each command prints its summary as one JSON line on stdout; the event records
along the way (epochs, prune decisions) go to stderr as JSON lines. The
device is CUDA unless ``--device cpu``; without CUDA the command raises.
``serve`` is not ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import Config, load_config
from .device import resolve_device
from .train.loop import (compute_scores, fit, load_data_for, run_datadiet, run_sweep,
                         scores_npz_path)
from .utils.io import atomic_savez


def _log(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, **fields}, default=str), file=sys.stderr,
          flush=True)


def score(cfg: Config, device=None) -> dict:
    """The ``score`` command: score, save the npz, return a summary."""
    device = resolve_device(device)
    train_ds, _ = load_data_for(cfg)
    scores, timings = compute_scores(cfg, train_ds, device=device, log=_log)
    out = scores_npz_path(cfg.train.checkpoint_dir)
    method = (f"reused:{timings['loaded_from']}" if timings.get("loaded_from")
              else cfg.score.method)
    atomic_savez(out, scores=scores, indices=train_ds.indices, method=method)
    return {"n_scores": int(len(scores)), "scores_npz": out,
            "score_s": round(timings["score_s"], 3),
            "pretrain_s": round(timings["pretrain_s"], 3), "device": str(device),
            "mean": float(scores.mean()), "std": float(scores.std())}


def train(cfg: Config, device=None) -> dict:
    """The ``train`` command: a dense fit with checkpoints."""
    device = resolve_device(device)
    train_ds, test_ds = load_data_for(cfg)
    res = fit(cfg, train_ds, test_ds, device=device, log=_log,
              checkpoint_dir=cfg.train.checkpoint_dir, tag="dense")
    return {**res.throughput_summary(), "train_wall_s": round(res.wall_s, 3),
            "device": str(device)}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="data_diet_distributed_tpu_torch.cli")
    parser.add_argument("command", choices=("score", "train", "run", "sweep", "serve"))
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without CUDA) or cpu")
    parser.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    args = parser.parse_intermixed_args(argv)
    if args.command == "serve":
        raise NotImplementedError(
            "the 'serve' command (batcher, HTTP server, router) is not ported yet")
    cfg = load_config(args.config, args.overrides)
    if args.command == "score":
        out = {"event": "scores_saved", **score(cfg, args.device)}
    elif args.command == "train":
        out = {"event": "train_done", **train(cfg, args.device)}
    elif args.command == "run":
        out = {"event": "run_done", **run_datadiet(cfg, device=args.device, log=_log)}
    else:
        out = {"event": "sweep_done",
               "levels": run_sweep(cfg, device=args.device, log=_log)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
