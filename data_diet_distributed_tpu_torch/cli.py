"""Command line of the PyTorch port (counterpart of ``data_diet_distributed_tpu/cli.py``)::

    python -m data_diet_distributed_tpu_torch.cli {train|run|sweep|score} \\
        --config configs/x.yaml [key=value ...] [--device cpu]

* ``train``: dense training through ``fit_with_recovery``, checkpoints in
  ``train.checkpoint_dir``;
* ``run``: (pretrain ->) score -> prune -> retrain -> eval, writing
  ``<train.checkpoint_dir>_scores.npz`` and its provenance sidecar;
* ``sweep``: one scoring pass, then prune and retrain per ``prune.sweep``
  level;
* ``score``: score only (after ``score.pretrain_epochs`` epochs per seed, from
  ``score.score_ckpt_step``, or reused from ``score.scores_npz``) and write
  ``<train.checkpoint_dir>_scores.npz`` with ``scores``, ``indices`` and
  ``method``.

Each command prints its summary as one JSON line on stdout; the event records
along the way (epochs, prune decisions, faults, recoveries, stages) go to
stderr as JSON lines. The device is CUDA unless ``--device cpu``; without
CUDA the command raises. ``serve`` is not ported yet and raises
``NotImplementedError``.

Resilience as in the JAX package: a SIGTERM/SIGINT ends the command after a
final checkpoint with ``[preempted] ...`` on stdout and exit status 75;
``run``, ``sweep`` and ``score`` re-invoked with the same arguments re-enter
at their stage (``train`` resumes with ``train.resume=true``). A JSON fault
plan in ``DDT_FAULT_PLAN`` (``resilience/inject.py``) arms a drill, and
``resilience.init_probe=true`` first initializes CUDA in a bounded
subprocess (exit 69 when it fails).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .config import Config, load_config
from .device import resolve_device
from .resilience import inject
from .resilience.preemption import EXIT_PREEMPTED, Preempted
from .resilience.watchdog import EXIT_RETRIABLE, probe_devices
from .train.loop import (compute_scores, fit_with_recovery, load_data_for,
                         pipeline_stages, run_datadiet, run_sweep, scores_npz_path)
from .utils.io import atomic_savez


def _log(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, **fields}, default=str), file=sys.stderr,
          flush=True)


def score(cfg: Config, device=None) -> dict:
    """The ``score`` command: score (stage-resumable, like ``run``), save the
    npz, return a summary."""
    device = resolve_device(device)
    train_ds, _ = load_data_for(cfg)
    scores, timings = compute_scores(cfg, train_ds, device=device, log=_log,
                                     stages=pipeline_stages(cfg, _log))
    out = scores_npz_path(cfg.train.checkpoint_dir)
    method = (f"reused:{timings['loaded_from']}" if timings.get("loaded_from")
              else cfg.score.method)
    atomic_savez(out, scores=scores, indices=train_ds.indices, method=method)
    return {"n_scores": int(len(scores)), "scores_npz": out,
            "score_s": round(timings["score_s"], 3),
            "pretrain_s": round(timings["pretrain_s"], 3), "device": str(device),
            "mean": float(scores.mean()), "std": float(scores.std())}


def train(cfg: Config, device=None) -> dict:
    """The ``train`` command: a dense fit with checkpoints and recovery."""
    device = resolve_device(device)
    train_ds, test_ds = load_data_for(cfg)
    res = fit_with_recovery(cfg, train_ds, test_ds, device=device, log=_log,
                            checkpoint_dir=cfg.train.checkpoint_dir, tag="dense")
    return {**res.throughput_summary(), "train_wall_s": round(res.wall_s, 3),
            "device": str(device)}


def _dispatch(command: str, cfg: Config, device) -> dict:
    if command == "score":
        return {"event": "scores_saved", **score(cfg, device)}
    if command == "train":
        return {"event": "train_done", **train(cfg, device)}
    if command == "run":
        return {"event": "run_done", **run_datadiet(cfg, device=device, log=_log)}
    return {"event": "sweep_done", "levels": run_sweep(cfg, device=device, log=_log)}


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
    plan = inject.activate_from_env()
    if plan is not None:
        print(f"[resilience] fault plan armed from DDT_FAULT_PLAN: {plan}",
              file=sys.stderr, flush=True)
    try:
        # Before this process touches CUDA (resolve_device's is_available()
        # would): a wedged driver then hangs the killable child, not us.
        if cfg.resilience.init_probe and torch.device(args.device or "cuda").type == "cuda":
            info = probe_devices(cfg.resilience.probe_attempts,
                                 cfg.resilience.probe_timeout_s,
                                 cfg.resilience.probe_backoff_s)
            if "error" in info:
                print(f"[resilience] {info['error']}", file=sys.stderr, flush=True)
                return EXIT_RETRIABLE
        try:
            out = _dispatch(args.command, cfg, args.device)
        except Preempted as p:
            # The final checkpoint (or the seed's partial) is durable and the
            # "preempted" event is already logged: report the resume point
            # with a status a supervisor can branch on.
            print(f"[preempted] {p}", flush=True)
            return EXIT_PREEMPTED
    finally:
        if plan is not None:
            inject.deactivate()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
