"""Epoch loop and the Data Diet pipeline (counterpart of
``data_diet_distributed_tpu/train/loop.py``).

1. ``fit``: train a fresh model (or resume one) for exactly
   ``train.num_epochs`` epochs: the batch order is ``epoch_permutation(seed,
   epoch)``, eval runs every ``train.eval_every`` epochs and after the last,
   a checkpoint is written every ``train.checkpoint_every`` epochs and after
   the last, a ``train_step`` event marks every ``train.log_every_steps``
   steps, and each epoch leaves the JAX package's record ``{epoch,
   epoch_s, examples_per_s, train_loss, train_accuracy, test_accuracy,
   test_loss}``.
2. ``compute_scores``: per seed, pretrain ``score.pretrain_epochs`` epochs
   (or load ``score.score_ckpt_step``, or take the init), then
   ``score_dataset`` over every seed; or reuse ``score.scores_npz``.
3. ``_retrain_level``: keep ``1 - sparsity`` of the examples, write the
   scores npz and its provenance sidecar, verify the sidecar against the
   kept set, and retrain a fresh model on the kept set.

``run_datadiet`` chains them once; ``run_sweep`` scores once and retrains
per ``prune.sweep`` level. Entry points take ``device`` (CUDA by default;
raises without it) and ``log``, a callable ``log(kind, **fields)`` that gets
the JAX package's event records (``epoch``, ``resume``, ``prune``,
``summary``, ...).

Not ported here: the chunked engine, the observability, consensus, elastic,
fault-injection and stage-manifest hooks, score partials, the NaN sentinel,
preemption, the watchdog, ``fit_with_recovery`` and the trajectory scores
(forgetting, AUM).
"""

from __future__ import annotations

import copy
import hashlib
import json
import time
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..config import Config
from ..data.datasets import ArrayDataset, load_dataset
from ..data.pipeline import (ResidentBatches, iterate_batches, maybe_resident,
                             num_batches, to_device)
from ..device import resolve_device, set_scoring_determinism
from ..models import create_model_from_cfg
from ..ops.scoring import score_dataset
from ..pruning import (build_prune_manifest, select_indices, verify_prune_manifest,
                       write_prune_manifest)
from ..utils.io import atomic_savez, load_scores_npz, provenance_path
from ..weights import init_variables
from .state import TrainState, create_train_state, make_optimizer
from .steps import eval_step, train_step

Log = Callable[..., None]


def _no_log(kind: str, **fields) -> None:
    del kind, fields


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile (NaN when empty), as the JAX package's."""
    if not values:
        return float("nan")
    s = sorted(values)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


@dataclass
class FitResult:
    state: TrainState
    history: list[dict[str, Any]] = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def final_test_accuracy(self) -> float | None:
        for rec in reversed(self.history):
            if "test_accuracy" in rec:
                return rec["test_accuracy"]
        return None

    def throughput_summary(self) -> dict[str, Any]:
        """Steady-state throughput and epoch-wall quantiles: epoch 0 (warm-up)
        is left out when there are more epochs."""
        steady = self.history[1:] if len(self.history) > 1 else self.history
        times = [h["epoch_s"] for h in steady]

        def r(v: float):
            return round(v, 6) if v == v else None

        out: dict[str, Any] = {"epochs": len(self.history), "epoch_s": {
            "mean": r(sum(times) / len(times)) if times else None,
            "p50": r(percentile(times, 0.5)), "p95": r(percentile(times, 0.95)),
            "max": r(max(times)) if times else None, "count": len(times)}}
        if steady:
            out["examples_per_s"] = round(
                sum(h["examples_per_s"] for h in steady) / len(steady), 1)
        if self.final_test_accuracy is not None:
            out["final_test_accuracy"] = self.final_test_accuracy
        return out


def image_dtype(cfg: Config) -> torch.dtype:
    """Upload dtype of device-resident images: the model's compute dtype."""
    return torch.bfloat16 if cfg.train.half_precision else torch.float32


def train_resident(cfg: Config, ds: ArrayDataset, device) -> ResidentBatches | None:
    """The train-set residency policy, shared by ``fit`` and the multi-seed
    scoring pretrain: ``data.data_plane=streaming`` assembles on the host,
    ``resident`` forces residency, ``auto`` follows
    ``train.device_resident_data`` (None = when it fits)."""
    if cfg.data.data_plane == "streaming":
        return None
    enabled = cfg.train.device_resident_data
    if cfg.data.data_plane == "resident" and enabled is None:
        enabled = True
    return maybe_resident(ds, cfg.data.batch_size, device, image_dtype(cfg), enabled)


def _with_epochs(cfg: Config, num_epochs: int | None, seed: int | None) -> Config:
    if num_epochs is None and seed is None:
        return cfg
    cfg = copy.deepcopy(cfg)
    if num_epochs is not None:
        cfg.train.num_epochs = num_epochs
    if seed is not None:
        cfg.train.seed = seed
    return cfg


def _batches(ds: ArrayDataset, batch_size: int, device, resident, *,
             shuffle: bool = False, seed: int = 0, epoch: int = 0):
    if resident is not None:
        return resident(shuffle=shuffle, seed=seed, epoch=epoch)
    return (to_device(b, device) for b in iterate_batches(
        ds, batch_size, shuffle=shuffle, seed=seed, epoch=epoch))


def _fetch(metrics: list[dict], keys: tuple[str, ...]) -> list[dict[str, float]]:
    """Per-step device scalars to host floats, in one transfer."""
    if not metrics:
        return []
    rows = torch.stack([torch.stack([m[k].float() for k in keys])
                        for m in metrics]).cpu().tolist()
    return [dict(zip(keys, row)) for row in rows]


def evaluate(model, state: TrainState, ds: ArrayDataset, batch_size: int, *,
             device=None, resident: ResidentBatches | None = None) -> dict[str, float]:
    """Masked loss and accuracy over ``ds``: ``{loss, accuracy, examples}``."""
    device = resolve_device(device)
    if resident is not None and resident.batch_size != batch_size:
        raise ValueError(
            f"evaluate: resident batches were built at batch size "
            f"{resident.batch_size} but batch_size={batch_size} was requested")
    outs = [eval_step(model, state, b)
            for b in _batches(ds, batch_size, device, resident)]
    totals = {"loss_sum": 0.0, "correct": 0.0, "examples": 0.0}
    for m in _fetch(outs, tuple(totals)):
        for k in totals:
            totals[k] += m[k]
    n = max(totals["examples"], 1.0)
    return {"loss": totals["loss_sum"] / n, "accuracy": totals["correct"] / n,
            "examples": int(n)}


def fit(cfg: Config, train_ds: ArrayDataset, test_ds: ArrayDataset | None = None, *,
        device=None, log: Log | None = None, num_epochs: int | None = None,
        seed: int | None = None, checkpoint_dir: str | None = None,
        tag: str = "train", train_batches: ResidentBatches | None = None) -> FitResult:
    """Train a fresh model from ``train.seed`` (or resume from
    ``checkpoint_dir`` under ``train.resume``) for exactly ``num_epochs``
    (default ``train.num_epochs``) epochs. ``train_batches`` is a resident
    upload of ``train_ds`` to use (the multi-seed pretrain shares one).
    On CUDA the cuDNN algorithms are the deterministic ones
    (``set_scoring_determinism``), so a fit is reproducible bit for bit."""
    cfg = _with_epochs(cfg, num_epochs, seed)
    device = resolve_device(device)
    if device.type == "cuda":
        set_scoring_determinism()
    log = log or _no_log
    batch_size = cfg.data.batch_size
    steps_per_epoch = num_batches(len(train_ds), batch_size)
    model = create_model_from_cfg(cfg).to(device)
    state = create_train_state(cfg, cfg.train.seed, device, model)
    optimizer = make_optimizer(cfg, steps_per_epoch)

    ckpt = None
    start_epoch = 0
    if checkpoint_dir:
        ckpt = CheckpointManager(checkpoint_dir, max_to_keep=cfg.train.keep_checkpoints)
        step = ckpt.latest_step() if cfg.train.resume else None
        if step is not None:
            meta = ckpt.metrics(step)
            saved_spe = meta.get("steps_per_epoch")
            if saved_spe is not None and int(saved_spe) != steps_per_epoch:
                raise ValueError(
                    f"resume: this run has steps_per_epoch={steps_per_epoch} but the "
                    f"checkpoint was saved with {saved_spe} (different batch size or "
                    "dataset). The cosine LR schedule is step-indexed, so continuing "
                    "would silently change the learning-rate trajectory; resume with "
                    "the saving run's data.batch_size, or train fresh with resume=false")
            state = ckpt.restore(step, device)
            start_epoch = (int(meta["epoch"]) + 1 if "epoch" in meta
                           else state.step // steps_per_epoch)
            log("resume", tag=tag, step=state.step, epoch=start_epoch)

    augment = ((cfg.data.crop_pad, cfg.data.flip, cfg.train.seed)
               if cfg.data.augment else None)
    if train_batches is None:
        train_batches = train_resident(cfg, train_ds, device)
    test_batches = None
    if test_ds is not None:
        test_batches = maybe_resident(
            test_ds, cfg.data.eval_batch_size, device, image_dtype(cfg),
            enabled=(False if cfg.data.data_plane == "streaming"
                     else cfg.train.device_resident_data))

    result = FitResult(state=state)
    t_start = time.perf_counter()
    for epoch in range(start_epoch, cfg.train.num_epochs):
        epoch_t0 = time.perf_counter()
        batches = _batches(train_ds, batch_size, device, train_batches,
                           shuffle=cfg.data.shuffle_each_epoch, seed=cfg.train.seed,
                           epoch=epoch)
        metrics = []
        for b in batches:
            metrics.append(train_step(model, optimizer, state, b, augment))
            if len(metrics) % cfg.train.log_every_steps == 0:
                # Host arithmetic only: the loss waits for the epoch's one fetch.
                log("train_step", tag=tag, epoch=epoch, step=state.step)
        steps = _fetch(metrics, ("loss", "correct", "examples"))
        epoch_s = time.perf_counter() - epoch_t0
        examples = sum(m["examples"] for m in steps)
        record: dict[str, Any] = {
            "epoch": epoch, "epoch_s": round(epoch_s, 3),
            "examples_per_s": len(train_ds) / epoch_s if epoch_s > 0 else 0.0,
            "train_loss": (sum(m["loss"] * m["examples"] for m in steps)
                           / max(examples, 1.0)),
            "train_accuracy": sum(m["correct"] for m in steps) / max(examples, 1.0),
        }
        if test_ds is not None and ((epoch + 1) % cfg.train.eval_every == 0
                                    or epoch + 1 == cfg.train.num_epochs):
            ev = evaluate(model, state, test_ds, cfg.data.eval_batch_size,
                          device=device, resident=test_batches)
            record["test_accuracy"] = ev["accuracy"]
            record["test_loss"] = ev["loss"]
        log("epoch", tag=tag, **record)
        result.history.append(record)
        if ckpt is not None and ((epoch + 1) % cfg.train.checkpoint_every == 0
                                 or epoch + 1 == cfg.train.num_epochs):
            ckpt.save(state.step, state, metrics={
                "epoch": epoch, "steps_per_epoch": steps_per_epoch,
                **{k: v for k, v in record.items() if isinstance(v, (int, float))}})
    result.state = state
    result.wall_s = time.perf_counter() - t_start
    return result


def load_data_for(cfg: Config) -> tuple[ArrayDataset, ArrayDataset]:
    """The configured dataset; syncs ``model.num_classes`` to it."""
    train_ds, test_ds = load_dataset(cfg.data.dataset, cfg.data.data_dir,
                                     cfg.data.synthetic_size, seed=cfg.train.seed,
                                     synthetic_noise=cfg.data.synthetic_noise,
                                     synthetic_clusters=cfg.data.synthetic_clusters)
    cfg.model.num_classes = train_ds.num_classes
    return train_ds, test_ds


def score_variables_for_seeds(cfg: Config, train_ds: ArrayDataset, *, device=None,
                              log: Log | None = None, seeds=None) -> list[dict]:
    """One scoring model's variables per seed (default ``score.seeds``): each
    seed pretrains a fresh model for ``score.pretrain_epochs`` epochs (one
    resident upload shared by every seed), or is taken at initialization when
    that is 0. With ``score.score_ckpt_step`` the one checkpoint of that step
    in ``train.checkpoint_dir`` is loaded instead (one scoring pass)."""
    device = resolve_device(device)
    log = log or _no_log
    if seeds is None:
        seeds = cfg.score.seeds
    if cfg.score.score_ckpt_step is not None:
        mngr = CheckpointManager(cfg.train.checkpoint_dir,
                                 max_to_keep=cfg.train.keep_checkpoints)
        variables = mngr.restore_variables(cfg.score.score_ckpt_step, device)
        log("score_ckpt_loaded", step=cfg.score.score_ckpt_step,
            dir=cfg.train.checkpoint_dir)
        return [variables]
    if cfg.score.pretrain_epochs <= 0:
        return [init_variables(cfg.model.arch, int(s), device,
                               num_classes=cfg.model.num_classes, stem=cfg.model.stem)
                for s in seeds]
    shared = train_resident(cfg, train_ds, device)
    return [fit(cfg, train_ds, None, device=device, log=log,
                num_epochs=cfg.score.pretrain_epochs, seed=int(s),
                tag=f"score_pretrain_seed{s}", train_batches=shared).state.variables
            for s in seeds]


def keep_fractions(cfg: Config) -> tuple[float, ...]:
    """The keep fractions of this config's prune decisions (sweep levels, else
    the single sparsity; 0.5 when the run never prunes)."""
    levels = cfg.prune.sweep or (
        (cfg.prune.sparsity,) if 0.0 < cfg.prune.sparsity < 1.0 else ())
    fracs = sorted({round(1.0 - float(s), 6) for s in levels})
    return tuple(fracs) or (0.5,)


def compute_scores(cfg: Config, train_ds: ArrayDataset, *, device=None,
                   log: Log | None = None) -> tuple[np.ndarray, dict[str, Any]]:
    """The configured scores of ``train_ds`` and their timings
    ``{pretrain_s, score_s, passes}`` (``loaded_from`` when
    ``score.scores_npz`` was reused)."""
    device = resolve_device(device)
    log = log or _no_log
    t0 = time.perf_counter()
    if cfg.score.scores_npz:
        scores = load_scores_npz(cfg.score.scores_npz, train_ds,
                                 expect_method=cfg.score.method)
        log("scores_loaded", path=cfg.score.scores_npz, n=len(scores))
        return scores, {"pretrain_s": 0.0, "score_s": time.perf_counter() - t0,
                        "passes": 0, "loaded_from": cfg.score.scores_npz}
    if cfg.score.method in ("forgetting", "aum"):
        raise NotImplementedError(
            f"score.method={cfg.score.method} (trajectory scores) is not ported yet")
    seeds_vars = score_variables_for_seeds(cfg, train_ds, device=device, log=log)
    pretrain_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    scores = score_dataset(create_model_from_cfg(cfg), seeds_vars, train_ds,
                           method=cfg.score.method, batch_size=cfg.score.batch_size,
                           chunk=cfg.score.grand_chunk, eval_mode=cfg.score.eval_mode,
                           use_kernels=cfg.score.use_pallas, device=device)
    return scores, {"pretrain_s": pretrain_s, "score_s": time.perf_counter() - t1,
                    "passes": len(seeds_vars)}


def scores_npz_path(checkpoint_dir: str) -> str:
    return f"{checkpoint_dir}_scores.npz"


def _hash_key(key: dict) -> str:
    return hashlib.sha256(json.dumps(key, sort_keys=True).encode()).hexdigest()[:16]


def pipeline_fingerprint(cfg: Config) -> str:
    """Hash of every config field that decides what run/sweep computes (the
    JAX package's ``pipeline_fingerprint`` key), recorded in the prune
    sidecar."""
    return _hash_key({
        "data": [cfg.data.dataset, cfg.data.data_dir, cfg.data.batch_size,
                 cfg.data.synthetic_size, cfg.data.synthetic_noise,
                 cfg.data.synthetic_clusters, cfg.data.augment,
                 cfg.data.shuffle_each_epoch],
        "model": [cfg.model.arch, cfg.model.stem],
        "optim": [cfg.optim.lr, cfg.optim.momentum, cfg.optim.weight_decay,
                  cfg.optim.warmup_epochs, cfg.optim.cosine_t_max_epochs],
        "score": [cfg.score.method, cfg.score.pretrain_epochs,
                  cfg.score.score_ckpt_step, cfg.score.scores_npz,
                  cfg.score.eval_mode],
        "half_precision": cfg.train.half_precision,
        "seeds": [int(s) for s in cfg.score.seeds],
        "prune": [cfg.prune.sparsity, cfg.prune.keep, cfg.prune.class_balance,
                  list(cfg.prune.sweep)],
        "train": [cfg.train.num_epochs, cfg.train.seed],
    })


def _retrain_level(cfg: Config, train_ds: ArrayDataset, test_ds: ArrayDataset,
                   scores: np.ndarray, sparsity: float, *, device, log: Log,
                   ckpt_dir: str, tag: str, score_t: dict[str, Any],
                   scoring_shared: bool = False) -> dict[str, Any]:
    """Prune at ``sparsity``, write the scores npz and its sidecar, verify the
    sidecar, retrain a fresh model on the kept set; returns the summary (with
    each stage's wall: ``pretrain_wall_s``, ``score_wall_s``,
    ``prune_wall_s``, ``train_wall_s``)."""
    t0 = time.perf_counter()
    kept = select_indices(scores, train_ds.indices, sparsity, keep=cfg.prune.keep,
                          seed=cfg.train.seed, labels=train_ds.labels,
                          class_balance=cfg.prune.class_balance)
    loaded_from = score_t.get("loaded_from")
    method = f"reused:{loaded_from}" if loaded_from else cfg.score.method
    manifest = build_prune_manifest(
        scores, train_ds.indices, kept, method=method, sparsity=float(sparsity),
        keep=cfg.prune.keep, class_balance=cfg.prune.class_balance,
        seed=cfg.train.seed, fingerprint=pipeline_fingerprint(cfg))
    npz = scores_npz_path(ckpt_dir)
    atomic_savez(npz, scores=scores, indices=train_ds.indices, kept=kept,
                 keep=cfg.prune.keep, class_balance=cfg.prune.class_balance,
                 method=method)
    write_prune_manifest(npz, manifest)
    log("prune_decision", manifest=provenance_path(npz),
        **{k: manifest[k] for k in ("fingerprint", "method", "sparsity", "keep",
                                    "class_balance", "n_total", "n_kept", "n_dropped",
                                    "nonfinite_scores", "threshold_score",
                                    "kept_digest", "dropped_digest")})
    score_s, pretrain_s = score_t["score_s"], score_t["pretrain_s"]
    prune_rec = {"n_total": len(train_ds), "n_kept": len(kept),
                 "score_s": round(score_s, 3), "pretrain_s": round(pretrain_s, 3)}
    if not loaded_from and score_t.get("passes") and score_s > 0:
        prune_rec["score_examples_per_s"] = len(train_ds) * score_t["passes"] / score_s
    log("prune", **prune_rec)
    verify_prune_manifest(npz, kept)
    prune_s = time.perf_counter() - t0
    res = fit(cfg, train_ds.subset(kept), test_ds, device=device, log=log,
              checkpoint_dir=ckpt_dir, tag=tag)
    summary = {
        "dataset": cfg.data.dataset, "n_train": len(train_ds),
        "sparsity": float(sparsity), "score_method": method,
        "n_kept": int(len(kept)), "score_wall_s": score_s,
        "pretrain_wall_s": pretrain_s, "prune_wall_s": prune_s,
        "final_test_accuracy": res.final_test_accuracy,
        "train_wall_s": res.wall_s,
        "total_wall_s": (res.wall_s if scoring_shared
                         else pretrain_s + score_s + prune_s + res.wall_s),
        "prune_manifest": provenance_path(npz),
    }
    if scoring_shared:
        summary["scoring_shared"] = True
    log("summary", **{k: v for k, v in summary.items() if v is not None})
    return summary


def sweep_suffix(sparsity: float) -> str:
    """Collision-free suffix for a level: 0.333 -> s0p333."""
    return f"s{float(sparsity):g}".replace(".", "p")


def sweep_level_dir(checkpoint_dir: str, sparsity: float) -> str:
    return f"{checkpoint_dir}_{sweep_suffix(sparsity)}"


def sweep_levels(cfg: Config) -> tuple[float, ...]:
    if cfg.prune.sweep:
        return tuple(float(s) for s in cfg.prune.sweep)
    if not 0.0 < cfg.prune.sparsity < 1.0:
        raise ValueError("cli sweep needs prune.sweep levels (or a single "
                         "prune.sparsity in (0, 1))")
    return (float(cfg.prune.sparsity),)


def run_sweep(cfg: Config, *, device=None, log: Log | None = None) -> list[dict[str, Any]]:
    """One scoring pass, then prune and retrain per level, each level into its
    own checkpoint directory (``sweep_level_dir``)."""
    device = resolve_device(device)
    log = log or _no_log
    levels = sweep_levels(cfg)
    train_ds, test_ds = load_data_for(cfg)
    scores, score_t = compute_scores(cfg, train_ds, device=device, log=log)
    log("sweep_scored", n=len(train_ds), score_s=round(score_t["score_s"], 3),
        pretrain_s=round(score_t["pretrain_s"], 3), levels=list(levels))
    summaries = [_retrain_level(cfg, train_ds, test_ds, scores, sparsity, device=device,
                                log=log,
                                ckpt_dir=sweep_level_dir(cfg.train.checkpoint_dir,
                                                         sparsity),
                                tag=f"final_{sweep_suffix(sparsity)}", score_t=score_t,
                                scoring_shared=True)
                 for sparsity in levels]
    log("sweep_done", levels=list(levels),
        total_wall_s=round(score_t["pretrain_s"] + score_t["score_s"]
                           + sum(s["train_wall_s"] for s in summaries), 3))
    return summaries


def run_datadiet(cfg: Config, *, device=None, log: Log | None = None) -> dict[str, Any]:
    """(Pretrain ->) score -> prune -> retrain from scratch -> eval; at
    ``prune.sparsity=0`` a dense fit."""
    device = resolve_device(device)
    log = log or _no_log
    train_ds, test_ds = load_data_for(cfg)
    t0 = time.perf_counter()
    if cfg.prune.sparsity > 0.0:
        scores, score_t = compute_scores(cfg, train_ds, device=device, log=log)
        return _retrain_level(cfg, train_ds, test_ds, scores, cfg.prune.sparsity,
                              device=device, log=log, ckpt_dir=cfg.train.checkpoint_dir,
                              tag="final", score_t=score_t)
    res = fit(cfg, train_ds, test_ds, device=device, log=log,
              checkpoint_dir=cfg.train.checkpoint_dir, tag="final")
    summary = {"dataset": cfg.data.dataset, "n_train": len(train_ds),
               "sparsity": cfg.prune.sparsity, "score_method": cfg.score.method,
               "final_test_accuracy": res.final_test_accuracy,
               "train_wall_s": res.wall_s, "total_wall_s": time.perf_counter() - t0}
    log("summary", **{k: v for k, v in summary.items() if v is not None})
    return summary
