"""Epoch loop and the Data Diet pipeline (counterpart of
``data_diet_distributed_tpu/train/loop.py``).

1. ``fit``: train a fresh model (or resume one) for exactly
   ``train.num_epochs`` epochs: the batch order is ``epoch_permutation(seed,
   epoch)``, eval runs every ``train.eval_every`` epochs and after the last,
   a checkpoint is written every ``train.checkpoint_every`` epochs and after
   the last, a ``train_step`` event marks every ``train.log_every_steps``
   steps, and each epoch leaves the JAX package's record ``{epoch,
   epoch_s, examples_per_s, train_loss, train_accuracy, test_accuracy,
   test_loss}``. Around the epochs sit the JAX package's resilience hooks in
   its order: a ``PreemptionHandler`` (SIGTERM -> a final synchronous
   checkpoint -> ``Preempted``), a ``Watchdog`` when
   ``resilience.step_timeout_s`` is set, the fault-injection sites, and the
   NaN sentinel before each epoch's eval and checkpoint. A resume restores
   the newest checkpoint that verifies (``resilience.verify_restore``).
2. ``fit_with_recovery``: ``fit`` that retries an exception (a watchdog
   timeout included) from the newest checkpoint the call wrote, under
   ``train.auto_resume_retries``, and rolls a divergence back at
   ``lr × resilience.nan_lr_factor`` under ``resilience.nan_retry_budget``.
3. ``compute_scores``: per seed, pretrain ``score.pretrain_epochs`` epochs
   (or load ``score.score_ckpt_step``, or take the init), then
   ``score_dataset`` over every seed; or reuse ``score.scores_npz``. With a
   stage manifest, each seed's float64 vector is saved as a partial, an
   interrupted pass resumes with only the seeds still to do, and a SIGTERM
   exits at the next seed boundary. The trajectory scores (``forgetting``,
   ``aum``) go to ``trajectory_scores``: per seed, a fit whose
   ``epoch_hook`` runs a correctness or margin pass over the train set after
   every epoch.
4. ``_retrain_level``: keep ``1 - sparsity`` of the examples, write the
   scores npz and its provenance sidecar, verify the sidecar against the
   kept set, and retrain a fresh model on the kept set.

``run_datadiet`` chains them once; ``run_sweep`` scores once and retrains
per ``prune.sweep`` level. Both keep a stage manifest
(``resilience.stage_resume``), so a re-invoked run skips what completed and
re-enters a started retrain from its checkpoints. Entry points take
``device`` (CUDA by default; raises without it) and ``log``, a callable
``log(kind, **fields)`` that gets the JAX package's event records
(``epoch``, ``resume``, ``prune``, ``summary``, ``fault``, ``recovery``,
``preempted``, ``stage``, ``score_seeds_resumed``, ...).

Across W ranks (a ``torch.distributed`` group, ``parallel/mesh.py``) every
entry point is a collective that computes what the JAX package computes on a
``{data: D, model: M}`` mesh (W = D x M): each rank trains and evaluates its
data index's rows of every global batch (``batch_slice``; at M > 1 with its
rows of the classifier head, ``train/state.py::shard_slots``), scores its
rows of every batch over the flattened mesh (``flat_slice``, with the head
gathered whole once per pass), the sums cross the ranks, rank 0 alone writes
files (after which every rank waits at a barrier and reads them), and
``fit`` runs the consensus hooks (``resilience/consensus.py``): the agreed
preemption poll, the peer check, the agreed NaN verdict and the min-agreed
restore. The trajectory scores run on the training layout, as the JAX
package's hook does.
``fit_with_recovery`` refuses to retry in process across ranks.

Observability, at the JAX package's points (each a no-op until
``obs/session.py::ObsSession`` installs its instrument): spans ``fit``,
``epoch``, ``eval``, ``seed`` and the stages (``score``, ``prune:<tag>``,
``retrain:<tag>``, ``dense:final``, each also a ``stage_s:<stage>``
histogram); the registry's ``epoch_s``, ``eval_s``, ``step_dispatch_s``,
``score_s`` and ``score_pretrain_s``; per-step and per-epoch heartbeats; the
status server's progress and the fit's watchdog and consensus; the profile
window (``obs.profile_dir``: a fit's steady steps, the scoring pass's steady
batches); the memory polls and the MFU at steady epochs and after scoring;
the SLO checks; ``fleet_status`` on rank 0; one ``comm_stats`` record per
fit; score telemetry; flight-recorder dumps on preemption
(``preempted:<sig>``), divergence (``divergence:epoch<k>``) and a retried
fault (``<fault>:attempt<k>``).

The elastic hooks (``resilience/elastic.py``): with ``checkpoint.local_tier``
each rank saves its own part of the state through the local tier (no
gather, no barrier) and a preemption drains the promotions in flight and
waits for the peers' markers before it claims a durable step (the
``preempted`` record carries the drain's wait and budget); the ``resume``
record carries the world and the world that saved the step; under
``elastic.enabled`` the mesh's ``data_axis`` follows the relaunched world
and ``stage_barrier`` runs at the score -> retrain boundary and between
sweep levels; ``obs.slo_recovery_s`` is armed at resume and read at the
first training step.

The chunked engine (the JAX package's, ``train/loop.py:67-118`` and
``:640-760``): ``train.chunk_steps`` (null = auto, 16 on a single-process
run with a chunk-capable feed; 0 or 1 = per step; K > 1 = requested,
clamped to the epoch and to ``MAX_CHUNK_STEPS``) runs K steps as one
dispatch (``train/steps.py::make_train_chunk``): on the card one CUDA-graph
replay (``graphs.py``), on the CPU the same bodies eagerly. The feed is the
resident set (``ResidentBatches.chunk_indices``: the gather runs inside the
chunk) or, under ``data.data_plane=streaming``, prefetched blocks
(``StreamingBatches``, the ``chunked_stream`` engine); a chunk never crosses
an epoch boundary (the tail is a chunk of its own length). Per chunk the host
stages the index and mask block, the K learning rates and the K steps'
augmentation draws in one upload; the stacked ``[K]`` metrics are fetched
once an epoch and unstacked (``_flatten_step_metrics``), so the epoch record
sums the same scalars in the same order: the chunked fit is bitwise the
per-step fit. Eval rides the same engine (``make_eval_chunk``). The
heartbeat, the preemption poll, the ``train_step`` liveness event and the
profile window's ticks move to chunk boundaries; the watchdog deadline is
``resilience.step_timeout_s × K``; the NaN sentinel stays at the epoch end.
Across ranks, under consensus, or with an armed fault plan that names an
exact step, the fit runs per step (``resolve_chunk_steps``); ``FitResult.
chunk_steps`` and the ``train_chunked`` record say which engine ran.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import re
import time
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..checkpoint import CheckpointManager, tier_map
from ..config import Config
from ..data.datasets import ArrayDataset, load_dataset
from ..data.pipeline import (EvalBatchCache, PrefetchIterator, ResidentBatches,
                             StreamingBatches, logging_data_plane, maybe_resident,
                             merge_stall_stats, num_batches, prefetch_stream)
from ..device import resolve_device, set_scoring_determinism
from ..graphs import GraphCache
from ..models import create_model_from_cfg
from ..obs import comm as obs_comm
from ..obs import fleet as obs_fleet
from ..obs import flightrec, introspect, scoreboard, tracing
from ..obs import heartbeat as obs_heartbeat
from ..obs import registry as obs_registry
from ..obs import server as obs_server
from ..obs import slo as obs_slo
from ..obs.profiler import ProfileWindow
from ..obs.registry import percentile
from ..ops.forgetting import AUMTracker, ForgettingTracker
from ..ops.scores import make_local_scores
from ..ops.scoring import resident_by_default, score_dataset
from ..parallel.collectives import sum_float64
from ..parallel.mesh import (batch_slice, global_batch_size_for, is_primary, model_index,
                             process_index, resolve_update_sharding, run_mesh, sync_hosts,
                             world_size)
from ..pruning import (build_prune_manifest, select_indices, verify_prune_manifest,
                       write_prune_manifest)
from ..resilience import inject
from ..resilience.consensus import Consensus, agree_any
from ..resilience.elastic import stage_barrier
from ..resilience.preemption import Preempted, PreemptionHandler
from ..resilience.sentinel import DivergenceError, LossSentinel
from ..resilience.stages import (ScorePartialStore, StageManifest,
                                 score_partials_dir, stage_manifest_path)
from ..resilience.watchdog import Watchdog, WatchdogTimeout
from ..utils.io import atomic_savez, load_scores_npz, provenance_path
from ..weights import init_variables
from .state import (TrainState, create_train_state, gather_head, gather_slots,
                    make_optimizer, shard_slots)
from .steps import (chunk_inputs, chunk_key, dispatch_eval_chunk, dispatch_eval_step,
                    dispatch_train_chunk, dispatch_train_step, make_eval_chunk,
                    make_train_chunk)

Log = Callable[..., None]

#: Auto chunk size of the chunked engine (K train steps a dispatch), the JAX
#: package's constant; the card's own choice waits for a benchmark.
DEFAULT_CHUNK_STEPS = 16

#: Clamp on ``train.chunk_steps``: a chunk is the granularity at which a
#: preemption or the watchdog is honoured, and a capture records every step.
MAX_CHUNK_STEPS = 64


def _step_targeted_injection() -> bool:
    """An armed fault plan with an exact-step coordinate (step exception,
    hang, mid-epoch SIGTERM) needs the per-step loop: the chunked engine only
    visits chunk boundaries."""
    plan = inject.active_plan()
    return plan is not None and any(
        getattr(plan, f) is not None
        for f in ("step_exception_at", "hang_at", "sigterm_at_step"))


def resolve_chunk_steps(cfg: Config, steps_per_epoch: int, train_source,
                        consensus) -> int:
    """The chunked engine's selection policy (the JAX package's): the chunk
    size, 1 for the per-step path.

    ``train.chunk_steps``: None = auto (``DEFAULT_CHUNK_STEPS``), 0 or 1 =
    per step, K > 1 = requested. ``train_source`` is the chunk-capable feed
    (a ``ResidentBatches`` or a ``StreamingBatches`` of a single-process
    run; None otherwise). Per step, even when requested: no chunk-capable
    feed, consensus (its per-step polls are collectives), an armed
    step-targeted fault. Clamped to the epoch and to ``MAX_CHUNK_STEPS``."""
    k = cfg.train.chunk_steps
    if k is not None and k <= 1:
        return 1
    if train_source is None or consensus is not None or _step_targeted_injection():
        return 1
    if k is None:
        k = DEFAULT_CHUNK_STEPS
    return max(1, min(int(k), steps_per_epoch, MAX_CHUNK_STEPS))


def _train_stream(cfg: Config, ds: ArrayDataset, device, consensus) -> StreamingBatches | None:
    """The chunked stream's gate: ``data.data_plane=streaming``, one process,
    no consensus, no step-targeted fault."""
    if (cfg.data.data_plane != "streaming" or world_size() > 1
            or consensus is not None or _step_targeted_injection()):
        return None
    return StreamingBatches(ds, global_batch_size_for(cfg.data.batch_size), device,
                            image_dtype(cfg), prefetch_depth=cfg.data.prefetch_depth)


def _dispatch_chunk(program, state: TrainState, host: dict) -> dict:
    """One resident train chunk: K steps, one dispatch. A module-level seam
    so tests can interpose at chunk boundaries."""
    return dispatch_train_chunk(program, state, host)


def _dispatch_stream_chunk(program, state: TrainState, host: dict, block) -> dict:
    """The streaming twin of ``_dispatch_chunk``: the block's rows are copied
    into the program's static block and gathered by the identity index."""
    return dispatch_train_chunk(program, state, host, block)


def _flatten_step_metrics(fetched: list[dict], key: str = "examples") -> list[dict]:
    """Fetched step metrics in step order: a chunk's entry holds ``[K]``
    arrays (``key`` names one) and is unstacked, a step's passes through, so
    the epoch record and the eval totals sum the same scalars in the same
    order under either engine."""
    flat: list[dict] = []
    for m in fetched:
        if np.ndim(m[key]):
            flat.extend({k: v[j] for k, v in m.items()} for j in range(len(m[key])))
        else:
            flat.append(m)
    return flat


def _no_log(kind: str, **fields) -> None:
    del kind, fields


@contextlib.contextmanager
def _stage_span(name: str):
    """A pipeline stage's trace span and ``stage_s:<name>`` histogram, named
    as the stage manifest names it."""
    t0 = time.perf_counter()
    with tracing.span(name, cat="stage"):
        try:
            yield
        finally:
            obs_registry.observe(f"stage_s:{name}", time.perf_counter() - t0)


@dataclass
class FitResult:
    state: TrainState
    history: list[dict[str, Any]] = field(default_factory=list)
    wall_s: float = 0.0
    chunk_steps: int = 1

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
    scoring pretrain: ``data.data_plane=streaming`` streams (None),
    ``resident`` forces residency, ``auto`` follows
    ``train.device_resident_data`` (None = when it fits)."""
    if cfg.data.data_plane == "streaming":
        return None
    enabled = cfg.train.device_resident_data
    if cfg.data.data_plane == "resident" and enabled is None:
        enabled = True
    return maybe_resident(ds, global_batch_size_for(cfg.data.batch_size), device,
                          image_dtype(cfg), enabled, batch_slice())


def _with_epochs(cfg: Config, num_epochs: int | None, seed: int | None) -> Config:
    if num_epochs is None and seed is None:
        return cfg
    cfg = copy.deepcopy(cfg)
    if num_epochs is not None:
        cfg.train.num_epochs = num_epochs
    if seed is not None:
        cfg.train.seed = seed
    return cfg


def _quarantined_rows(ds: ArrayDataset) -> np.ndarray:
    """Rows of ``ds`` served from quarantined shards (empty unless sharded)."""
    fn = getattr(ds.images, "quarantined_rows", None)
    return fn() if fn is not None else np.empty(0, np.int64)


def _fetch(metrics: list[dict], keys: tuple[str, ...]) -> list[dict[str, float]]:
    """Per-step device scalars and per-chunk ``[K]`` stacks to host floats
    in step order (``_flatten_step_metrics``), in one transfer."""
    if not metrics:
        return []
    sizes = [m[keys[0]].numel() for m in metrics]
    host = torch.cat([torch.stack([m[k].float().reshape(-1) for k in keys])
                      for m in metrics], dim=1).cpu().numpy()
    fetched, at = [], 0
    for m, n in zip(metrics, sizes):
        cols = host[:, at:at + n] if m[keys[0]].dim() else host[:, at]
        fetched.append(dict(zip(keys, cols)))
        at += n
    return [{k: float(v) for k, v in m.items()}
            for m in _flatten_step_metrics(fetched, key="examples")]


def evaluate(model, state: TrainState, ds: ArrayDataset, batch_size: int, *,
             device=None, resident: ResidentBatches | None = None,
             cache: EvalBatchCache | None = None, chunk_steps: int = 1,
             graphs: GraphCache | None = None) -> dict[str, float]:
    """Masked loss and accuracy over ``ds``: ``{loss, accuracy, examples}``,
    from ``resident`` batches, or streamed (through ``cache`` when given).
    With ``resident`` and ``chunk_steps`` > 1 (one process) K batches run as
    one dispatch (``make_eval_chunk``; its programs kept in ``graphs``, or in
    a cache of this call's own), bitwise the per-batch sums.
    Across ranks ``batch_size`` rounds up to a multiple of D, each rank
    evaluates its data index's rows and the sums are the data ranks' sums
    (64 examples at ``{data: 4, model: 2}``, not 128)."""
    device = resolve_device(device)
    batch_size = global_batch_size_for(batch_size)
    rows = batch_slice()
    if resident is not None and resident.batch_size != batch_size:
        raise ValueError(
            f"evaluate: resident batches were built at batch size "
            f"{resident.batch_size} but batch_size={batch_size} was requested")
    totals = {"loss_sum": 0.0, "correct": 0.0, "examples": 0.0}
    own = None
    if resident is not None and chunk_steps > 1 and rows is None:
        own = GraphCache() if graphs is None else None
        cache_of = graphs if graphs is not None else own
        outs = []
        for idx, mask in resident.chunk_indices(chunk_steps):
            k = len(idx)
            program = cache_of.get(
                chunk_key("eval_chunk", k, resident.image_shape, resident.batch_size,
                          resident.image_dtype),
                lambda k=k: make_eval_chunk(model, state.variables, resident, k))
            outs.append(dispatch_eval_chunk(program, state, idx, mask))
    else:
        batches = (resident() if resident is not None
                   else cache.stream(ds, batch_size, device, rows) if cache is not None
                   else prefetch_stream(ds, batch_size, device, depth=0, stage="eval",
                                        image_slice=rows))
        outs = [dispatch_eval_step(model, state, b) for b in batches]
    try:
        for m in _fetch(outs, tuple(totals)):
            for k in totals:
                totals[k] += m[k]
    finally:
        if own is not None:
            own.release()
    if rows:
        summed = sum_float64(_one_per_data_rank(
            np.array([totals[k] for k in totals], np.float64)))
        totals = dict(zip(totals, summed.tolist()))
    n = max(totals["examples"], 1.0)
    return {"loss": totals["loss_sum"] / n, "accuracy": totals["correct"] / n,
            "examples": int(n)}


def _one_per_data_rank(vec: np.ndarray) -> np.ndarray:
    """``vec`` on model index 0, zeros on the other ranks of its model group
    (which hold the same rows): a host sum then counts each data rank once."""
    return vec if model_index() == 0 else np.zeros_like(vec)


def fit(cfg: Config, train_ds: ArrayDataset, test_ds: ArrayDataset | None = None, *,
        device=None, log: Log | None = None, num_epochs: int | None = None,
        seed: int | None = None, checkpoint_dir: str | None = None,
        resume_step: int | None = None, saved_steps: list[int] | None = None,
        tag: str = "train", train_batches: ResidentBatches | None = None,
        epoch_hook: Callable[[Any, TrainState, int], None] | None = None) -> FitResult:
    """Train a fresh model from ``train.seed`` (or resume from
    ``checkpoint_dir`` under ``train.resume``, from the newest step, or the
    newest at or before ``resume_step``) for exactly ``num_epochs`` (default
    ``train.num_epochs``) epochs. ``train_batches`` is a resident upload of
    ``train_ds`` to use (the multi-seed pretrain shares one). The steps this
    call saves are appended to ``saved_steps``. ``epoch_hook(model, state,
    epoch)``, when given, runs after each epoch's eval (the trajectory scores'
    per-epoch pass). On CUDA the cuDNN algorithms
    are the deterministic ones (``set_scoring_determinism``), so a fit is
    reproducible bit for bit.

    A train set that is not resident streams through ``prefetch_stream``
    (``data.prefetch_depth`` batches ahead), bitwise the resident batches; a
    test set that is not resident is cached on the device across evals while
    it fits (``EvalBatchCache``). One ``data_plane`` record per fit goes to
    ``log`` when it ends, however it ends.

    A preemption signal ends the fit with ``Preempted`` after a final
    synchronous checkpoint; a mid-epoch one records ``epoch`` as the last
    completed epoch (-1 when none), so a resume replays the interrupted epoch
    from its start while the step counter continues (at least once, as in the
    JAX package).

    Across ranks the batch rounds up to a multiple of D and each rank holds
    its data index's rows (``train_batches`` included); at M > 1 each holds
    its rows of the head; the momentum is sharded under ZeRO-1 and the
    sharded update, and the state gathered whole into each checkpoint, which
    rank 0 writes (every restore places it in the rank's layout again). With ``resilience.consensus`` the ranks agree on the
    preemption step, on a NaN epoch and on the restore step (the newest every
    rank verified, restored exactly), and a peer's poison aborts the fit
    before the next collective."""
    cfg = _with_epochs(cfg, num_epochs, seed)
    device = resolve_device(device)
    if device.type == "cuda":
        set_scoring_determinism()
    log = log or _no_log
    mesh = run_mesh(cfg.mesh, elastic=cfg.elastic.enabled)   # the geometry check
    rows = batch_slice()
    batch_size = global_batch_size_for(cfg.data.batch_size)
    steps_per_epoch = num_batches(len(train_ds), batch_size)
    model = create_model_from_cfg(cfg).to(device)
    state = create_train_state(cfg, cfg.train.seed, device, model)
    optimizer = make_optimizer(cfg, steps_per_epoch)
    consensus = Consensus.create(cfg, log=log, tag=tag)

    ckpt = None
    start_epoch = 0
    try:
        if checkpoint_dir:
            # checkpoint.local_tier arms the tier's write path; every reader
            # finds tier steps with no config.
            ckpt = CheckpointManager(checkpoint_dir, max_to_keep=cfg.train.keep_checkpoints,
                                     tier=cfg.checkpoint if cfg.checkpoint.local_tier
                                     else None, log=log)
            if cfg.train.resume and (resume_step is not None
                                     or ckpt.latest_step() is not None):
                state, start_epoch = _resume(cfg, ckpt, consensus, resume_step,
                                             steps_per_epoch, tag, log, device)
        # The recovery SLO's clock, on a relaunched attempt: from the previous
        # attempt's classification in the shared stream to the first step.
        obs_slo.arm_recovery(cfg.obs.metrics_path)
        state = shard_slots(state, optimizer)
        return _fit_run(cfg, train_ds, test_ds, model, optimizer, state, log, ckpt,
                        start_epoch, batch_size, steps_per_epoch, tag, saved_steps,
                        train_batches, epoch_hook, device, rows, mesh, consensus)
    finally:
        if ckpt is not None:
            ckpt.close()   # the tier's promotions land before the fit returns


def _resume(cfg, ckpt: CheckpointManager, consensus, resume_step, steps_per_epoch: int,
            tag: str, log: Log, device) -> tuple[TrainState, int]:
    """The restored state and the epoch to start at (``fit``'s resume)."""
    if consensus is not None:
        # The newest step every rank verified, restored exactly: a
        # per-rank fallback would resume the ranks at different steps.
        candidates = inject.transform(
            "durable_candidates", ckpt.verified_steps(max_step=resume_step))
        used_step = consensus.agree_restore_step(candidates)
        if used_step is None:
            raise FileNotFoundError(
                f"{ckpt.directory}: no checkpoint step is durable on every "
                f"rank — nothing all {consensus.world} ranks can resume from")
        state = ckpt.restore(used_step, device)
    elif cfg.resilience.verify_restore:
        # A truncated or drifted newest step falls back to the newest
        # earlier one that verifies, each refusal logged.
        state, used_step = ckpt.restore_verified(
            resume_step, device,
            on_fallback=lambda **kw: log("fault", fault="checkpoint_corrupt",
                                         tag=tag, **kw))
    else:
        state = ckpt.restore(resume_step, device)
        used_step = resume_step if resume_step is not None else ckpt.latest_step()
    meta = ckpt.metrics(used_step)
    saved_spe = meta.get("steps_per_epoch")
    if saved_spe is not None and int(saved_spe) != steps_per_epoch:
        raise ValueError(
            f"resume: this run has steps_per_epoch={steps_per_epoch} but the "
            f"checkpoint was saved with {saved_spe} (different batch size or "
            "dataset). The cosine LR schedule is step-indexed, so continuing "
            "would silently change the learning-rate trajectory; resume with "
            "the saving run's data.batch_size, or train fresh with resume=false")
    start_epoch = (int(meta["epoch"]) + 1 if "epoch" in meta
                   else state.step // steps_per_epoch)
    # saved_world: the world that WROTE the step (tier steps record it), so
    # a recovery onto another world is pinned in the stream.
    log("resume", tag=tag, step=state.step, epoch=start_epoch, world=world_size(),
        saved_world=ckpt.saved_world(used_step))
    return state, start_epoch


def _fit_run(cfg, train_ds, test_ds, model, optimizer, state, log, ckpt, start_epoch,
             batch_size, steps_per_epoch, tag, saved_steps, train_batches, epoch_hook,
             device, rows, mesh, consensus) -> FitResult:
    """``fit`` after its resume: the data, the resilience envelope and the
    epochs."""
    augment = ((cfg.data.crop_pad, cfg.data.flip, cfg.train.seed)
               if cfg.data.augment else None)
    if train_batches is None:
        train_batches = train_resident(cfg, train_ds, device)
    train_stream = (_train_stream(cfg, train_ds, device, consensus)
                    if train_batches is None else None)
    # The chunked engine, resolved before the watchdog: K scales its deadline.
    chunk_steps = resolve_chunk_steps(
        cfg, steps_per_epoch,
        (train_batches or train_stream) if world_size() == 1 else None, consensus)
    if chunk_steps <= 1:
        train_stream = None   # per-step streaming prefetches batch by batch
    else:
        log("train_chunked", tag=tag, chunk_steps=chunk_steps,
            steps_per_epoch=steps_per_epoch,
            engine="stream" if train_stream is not None else "resident")
    test_batches = eval_cache = None
    if test_ds is not None:
        test_batches = maybe_resident(
            test_ds, global_batch_size_for(cfg.data.eval_batch_size), device,
            image_dtype(cfg),
            enabled=(False if cfg.data.data_plane == "streaming"
                     else cfg.train.device_resident_data), image_slice=rows)
        if test_batches is None:
            eval_cache = EvalBatchCache()
    plane_stats: dict = {}

    result = FitResult(state=state, chunk_steps=chunk_steps)
    t_start = time.perf_counter()
    # The resilience envelope, as in the JAX package: SIGTERM/SIGINT set a
    # polled flag, a missed heartbeat raises a retriable WatchdogTimeout, and
    # a NaN/inf epoch loss raises DivergenceError before the state is saved.
    # Chunked, one heartbeat covers K steps: the deadline scales by K.
    timeout = cfg.resilience.step_timeout_s
    if timeout and chunk_steps > 1:
        timeout *= chunk_steps
    watchdog = (Watchdog(timeout, label=f"{tag} step loop",
                         # A timeout names the rank that last progressed.
                         diagnose=obs_heartbeat.describe,
                         **(consensus.watchdog_kwargs() if consensus is not None else {}))
                if timeout else None)
    preempt = PreemptionHandler(enabled=cfg.resilience.preemption)
    sentinel = LossSentinel(enabled=cfg.resilience.nan_check)
    # One capture for a stage's seeds (score_pretrain_seed<k> -> score_pretrain):
    # the window's budget of captures then reaches the scoring pass and the
    # retrain however many seeds there are.
    profile = (ProfileWindow(cfg.obs.profile_dir, re.sub(r"_seed\d+$", "", tag),
                             start_epoch=start_epoch,
                             num_epochs=cfg.train.num_epochs,
                             window_chunks=cfg.obs.profile_window_chunks,
                             device_type=device.type)
               if cfg.obs.profile_dir and process_index() == 0 else None)
    obs_server.attach(watchdog=watchdog, consensus=consensus)
    obs_server.note_progress(stage=tag, total_epochs=cfg.train.num_epochs,
                             steps_per_epoch=steps_per_epoch, chunk_steps=chunk_steps,
                             epochs_done=start_epoch, epoch=start_epoch, dispatches_done=0,
                             dispatches_per_epoch=-(-steps_per_epoch // chunk_steps))
    engine = ("resident" if train_batches is not None
              else "chunked_stream" if train_stream is not None else "stream")
    chunks = _Chunks(chunk_steps, train_stream, GraphCache())
    try:
        with logging_data_plane(log, tag, engine, plane_stats, train_ds, tag=tag), \
                preempt, (watchdog or contextlib.nullcontext()), \
                tracing.span("fit", cat="fit", tag=tag, epochs=cfg.train.num_epochs):
            _fit_epochs(cfg, train_ds, test_ds, model, optimizer, state, log, ckpt,
                        start_epoch, batch_size, steps_per_epoch, tag, result,
                        saved_steps, train_batches, test_batches, eval_cache,
                        plane_stats, augment, epoch_hook, device, rows,
                        watchdog=watchdog, preempt=preempt, sentinel=sentinel,
                        consensus=consensus, profile=profile, chunks=chunks)
        # After the epochs, so the overlap estimate reads the harvested flops.
        obs_comm.note_update_comm(result.state.params, mesh,
                                  resolve_update_sharding(cfg.mesh), logger=log,
                                  program=chunks.program, tag=tag, device=device)
    finally:
        chunks.graphs.release()   # the fit's captures and their pools
        if profile is not None:
            profile.close()   # a capture a fault left open stops here
        obs_server.detach("watchdog", "consensus")
    result.wall_s = time.perf_counter() - t_start
    return result


@dataclass
class _Chunks:
    """A fit's engine: the chunk size (1 = per step), the chunked stream's
    feed (None on the resident engine) and the fit's chunk programs."""

    steps: int
    stream: StreamingBatches | None
    graphs: GraphCache

    @property
    def program(self) -> str:
        """The training program the introspector harvests."""
        return "train_chunk" if self.steps > 1 else "train_step"


def _train_chunks(cfg, model, optimizer, state, log, ckpt, epoch, steps_per_epoch, tag,
                  saved_steps, train_batches, plane_stats, augment, chunks: _Chunks, *,
                  watchdog, preempt, consensus, profile) -> list[dict]:
    """One epoch of the chunked engine: ``ceil(steps / K)`` dispatches, each
    staging its block and running K steps; every per-step hook moves to the
    chunk boundary. Returns the chunks' stacked metrics."""
    k_steps, stream = chunks.steps, chunks.stream
    shuffle, seed = cfg.data.shuffle_each_epoch, cfg.train.seed
    source = stream if stream is not None else train_batches
    items = (stream.chunk_blocks(k_steps, shuffle=shuffle, seed=seed, epoch=epoch)
             if stream is not None else
             train_batches.chunk_indices(k_steps, shuffle=shuffle, seed=seed, epoch=epoch))
    metrics: list[dict] = []
    done = 0
    try:
        for item in items:
            idx, mask = (item.idx, item.mask) if stream is not None else item
            k = len(idx)
            if watchdog is not None:
                watchdog.beat()
            unit = epoch * steps_per_epoch + done
            obs_heartbeat.beat(step=unit, epoch=epoch, stage=tag)
            inject.fire("step", epoch=epoch, step=unit)
            if profile is not None:
                profile.tick(epoch)
            program = chunks.graphs.get(
                chunk_key("train_chunk", k, source.image_shape, source.batch_size,
                          source.image_dtype),
                lambda: make_train_chunk(model, optimizer, state, source, k, augment))
            # The span is the host's dispatch: staging and the enqueue (or, on
            # the CPU, the chunk itself).
            with tracing.span("chunk", cat="chunk", step=unit, k=k), \
                    obs_registry.timed("chunk_dispatch_s"):
                host = chunk_inputs(optimizer, state.step, idx, mask, augment)
                metrics.append(_dispatch_stream_chunk(program, state, host, item)
                               if stream is not None else
                               _dispatch_chunk(program, state, host))
            obs_slo.note_training_step()
            introspect.poll_memory()
            prev, done = done, done + k
            obs_server.note_progress(step=epoch * steps_per_epoch + done,
                                     dispatches_done=-(-done // k_steps))
            every = cfg.train.log_every_steps
            if done // every > prev // every:
                # The liveness event at the first chunk boundary past each
                # multiple: host arithmetic, the loss waits for the epoch.
                log("train_step", tag=tag, epoch=epoch, step=state.step)
            if _preempt_due(preempt, consensus, unit):
                _preempt_exit(preempt, ckpt, optimizer, state, log, tag, epoch - 1,
                              steps_per_epoch, saved_steps, watchdog=watchdog)
    finally:
        if stream is not None:
            items.close()   # the assembler thread stops here, however the epoch ends
            merge_stall_stats(plane_stats, items.stats())
    chunks.graphs.note_pool()
    return metrics


def _fit_epochs(cfg, train_ds, test_ds, model, optimizer, state, log, ckpt, start_epoch,
                batch_size, steps_per_epoch, tag, result, saved_steps, train_batches,
                test_batches, eval_cache, plane_stats, augment, epoch_hook, device, rows,
                *, watchdog, preempt, sentinel, consensus, profile, chunks: _Chunks) -> None:
    """``fit``'s epochs (inside its resilience envelope and ``fit`` span)."""
    for epoch in range(start_epoch, cfg.train.num_epochs):
        epoch_t0 = time.perf_counter()
        obs_heartbeat.beat(epoch=epoch, stage=tag, force=True)
        if chunks.steps > 1:
            metrics = _train_chunks(
                cfg, model, optimizer, state, log, ckpt, epoch, steps_per_epoch, tag,
                saved_steps, train_batches, plane_stats, augment, chunks,
                watchdog=watchdog, preempt=preempt, consensus=consensus, profile=profile)
        else:
            metrics = _train_steps(
                cfg, train_ds, model, optimizer, state, log, ckpt, epoch, batch_size,
                steps_per_epoch, tag, saved_steps, train_batches, plane_stats, augment,
                device, rows, watchdog=watchdog, preempt=preempt, consensus=consensus,
                profile=profile)
        _end_epoch(cfg, train_ds, test_ds, model, optimizer, state, log, ckpt, start_epoch,
                   steps_per_epoch, tag, result, saved_steps, test_batches, eval_cache,
                   epoch_hook, device, epoch, epoch_t0, metrics, watchdog=watchdog,
                   preempt=preempt, sentinel=sentinel, consensus=consensus,
                   profile=profile, chunks=chunks)
    result.state = state


def _train_steps(cfg, train_ds, model, optimizer, state, log, ckpt, epoch, batch_size,
                 steps_per_epoch, tag, saved_steps, train_batches, plane_stats, augment,
                 device, rows, *, watchdog, preempt, consensus, profile) -> list[dict]:
    """One epoch of the per-step engine; returns the steps' metrics."""
    shuffle, seed = cfg.data.shuffle_each_epoch, cfg.train.seed
    batches = (train_batches(shuffle=shuffle, seed=seed, epoch=epoch)
               if train_batches is not None else
               prefetch_stream(train_ds, batch_size, device, shuffle=shuffle,
                               seed=seed, epoch=epoch,
                               depth=cfg.data.prefetch_depth, stage=tag,
                               image_slice=rows))
    metrics = []
    try:
        for i, b in enumerate(batches):
            if watchdog is not None:
                watchdog.beat()
            unit = epoch * steps_per_epoch + i
            # Throttled (obs.heartbeat_interval_s): progress without a
            # write per step.
            obs_heartbeat.beat(step=unit, epoch=epoch, stage=tag)
            if consensus is not None:
                # A peer's poison aborts here, before a collective the
                # poisoned peer will never join.
                consensus.check_peers(unit)
            inject.fire("step", epoch=epoch, step=unit)
            if profile is not None:
                profile.tick(epoch)
            t_disp = time.perf_counter()
            metrics.append(dispatch_train_step(model, optimizer, state, b,
                                               augment))
            obs_registry.observe("step_dispatch_s", time.perf_counter() - t_disp)
            # The recovery SLO's far end: the first step after an armed
            # resume (one attribute check otherwise).
            obs_slo.note_training_step()
            if (i + 1) % cfg.train.log_every_steps == 0:
                # Host arithmetic only: the loss waits for the epoch's one fetch.
                obs_server.note_progress(step=unit + 1, dispatches_done=i + 1)
                log("train_step", tag=tag, epoch=epoch, step=state.step)
            # One rank: a host flag, no device sync per step. Across
            # ranks: the flags OR-reduced over the host group.
            if _preempt_due(preempt, consensus, unit):
                _preempt_exit(preempt, ckpt, optimizer, state, log, tag,
                              epoch - 1, steps_per_epoch, saved_steps,
                              watchdog=watchdog)
    finally:
        # Preempted or failed mid-epoch, the assembler thread stops here.
        batches.close()
        if isinstance(batches, PrefetchIterator):
            merge_stall_stats(plane_stats, batches.stats())
    return metrics


def _end_epoch(cfg, train_ds, test_ds, model, optimizer, state, log, ckpt, start_epoch,
               steps_per_epoch, tag, result, saved_steps, test_batches, eval_cache,
               epoch_hook, device, epoch, epoch_t0, metrics, *, watchdog, preempt,
               sentinel, consensus, profile, chunks: _Chunks) -> None:
    """The epoch boundary, either engine: the one fetch, the record, the NaN
    sentinel, eval, the hook, observability, the checkpoint and the forced
    preemption poll."""
    steps = _fetch(metrics, ("loss", "correct", "examples"))
    if watchdog is not None:
        watchdog.beat()   # the epoch fetch, eval and save are progress too
    epoch_s = time.perf_counter() - epoch_t0
    examples = sum(m["examples"] for m in steps)
    record: dict[str, Any] = {
        "epoch": epoch, "epoch_s": round(epoch_s, 3),
        "examples_per_s": len(train_ds) / epoch_s if epoch_s > 0 else 0.0,
        "train_loss": (sum(m["loss"] * m["examples"] for m in steps)
                       / max(examples, 1.0)),
        "train_accuracy": sum(m["correct"] for m in steps) / max(examples, 1.0),
    }
    record["train_loss"] = inject.transform("epoch_loss", record["train_loss"],
                                            epoch=epoch)
    try:
        sentinel.check(record["train_loss"], epoch=epoch, tag=tag,
                       agree=consensus.agree if consensus is not None else None)
    except DivergenceError:
        # Before eval and checkpoint: the diverged state is never made
        # durable. (The loss as a string: NaN is not JSON.)
        log("fault", fault="divergence", tag=tag, epoch=epoch, step=state.step,
            loss=str(record["train_loss"]))
        # Every rank dumps its ring, which ends with this fault.
        flightrec.dump(f"divergence:epoch{epoch}")
        raise
    if test_ds is not None and ((epoch + 1) % cfg.train.eval_every == 0
                                or epoch + 1 == cfg.train.num_epochs):
        with tracing.span("eval", cat="eval", epoch=epoch, tag=tag), \
                obs_registry.timed("eval_s"):
            ev = evaluate(model, state, test_ds, cfg.data.eval_batch_size,
                          device=device, resident=test_batches, cache=eval_cache,
                          chunk_steps=chunks.steps, graphs=chunks.graphs)
        record["test_accuracy"] = ev["accuracy"]
        record["test_loss"] = ev["loss"]
        if watchdog is not None:
            watchdog.beat()
    if epoch_hook is not None:
        epoch_hook(model, state, epoch)
        if watchdog is not None:
            watchdog.beat()
    log("epoch", tag=tag, **record)
    result.history.append(record)
    _epoch_obs(cfg, log, tag, epoch, start_epoch, steps_per_epoch, epoch_s,
               record, profile, epoch_t0, chunks.program)
    save_now = ckpt is not None and (
        (epoch + 1) % cfg.train.checkpoint_every == 0
        or epoch + 1 == cfg.train.num_epochs)
    if save_now:
        _save(ckpt, state, optimizer, {
            "epoch": epoch, "steps_per_epoch": steps_per_epoch,
            **{k: v for k, v in record.items() if isinstance(v, (int, float))}})
        if saved_steps is not None:
            saved_steps.append(state.step)
        inject.fire("checkpoint_saved", step=state.step,
                    directory=ckpt.directory)
        if watchdog is not None:
            watchdog.beat()
    inject.fire("epoch_end", epoch=epoch)
    if _preempt_due(preempt, consensus):   # an epoch end: a forced poll
        _preempt_exit(preempt, ckpt, optimizer, state, log, tag, epoch,
                      steps_per_epoch, saved_steps,
                      already_durable=state.step if save_now else None,
                      watchdog=watchdog)


def _epoch_obs(cfg, log, tag, epoch, start_epoch, steps_per_epoch, epoch_s, record,
               profile, epoch_t0, program: str = "train_step") -> None:
    """The epoch boundary's observability, in the JAX package's order: the
    registry, the status server's progress, the SLO point, ``fleet_status``,
    the MFU of a steady epoch (the first folds warm-up into its wall), the
    memory poll, the profile window, the ``epoch`` span and a cadenced
    ``metrics`` snapshot."""
    obs_registry.inc("epochs")
    obs_registry.inc("steps", steps_per_epoch)
    obs_registry.observe("epoch_s", epoch_s)
    obs_registry.set_gauge("examples_per_s", record["examples_per_s"])
    obs_server.note_progress(epoch=epoch, epochs_done=epoch + 1, epoch_s=epoch_s,
                             dispatches_done=0, examples_per_s=record["examples_per_s"])
    obs_slo.check_epoch(tag=tag, epoch=epoch, examples_per_s=record["examples_per_s"],
                        eval_accuracy=record.get("test_accuracy"),
                        steady=epoch > start_epoch)
    obs_fleet.maybe_emit()
    if epoch > start_epoch and (profile is None or profile.captured_epoch != epoch):
        # A steady epoch: not the first (warm-up, the harvest), nor one that
        # held a profile capture (the capture and its export are in its wall).
        introspect.note_throughput(program, record["examples_per_s"])
    introspect.poll_memory()
    if profile is not None:
        profile.epoch_end(epoch)
    tracing.complete("epoch", epoch_t0, cat="epoch", epoch=epoch, tag=tag)
    obs_registry.maybe_snapshot(log, cfg.obs.snapshot_every_s)


def _save(ckpt: CheckpointManager, state: TrainState, optimizer, metrics: dict) -> None:
    """Checkpoint ``state`` at its step: through the tier each rank its own
    part (its ZeRO-1 slices included, the head gathered whole over the model
    group), else the whole state gathered for rank 0's write."""
    if ckpt.tiered:
        whole_head = TrainState(gather_head(state.params), state.batch_stats,
                                gather_head(state.momentum), state.step)
        ckpt.save(state.step, whole_head, metrics, slots=optimizer.slots)
    else:
        ckpt.save(state.step, gather_slots(state, optimizer), metrics)


def _preempt_due(preempt: PreemptionHandler, consensus: Consensus | None,
                 unit: int | None = None) -> bool:
    """The preemption poll: the local flag, or under consensus the flags
    OR-reduced across the ranks on the poll cadence (``unit=None`` forces a
    poll), so a SIGTERM to one rank ends every rank at the same step."""
    if consensus is not None:
        return consensus.agree_preempt(preempt.requested, unit=unit)
    return preempt.requested


def _preempt_exit(preempt: PreemptionHandler, ckpt: CheckpointManager | None,
                  optimizer, state: TrainState, log: Log, tag: str, epoch: int,
                  steps_per_epoch: int, saved_steps: list[int] | None,
                  already_durable: int | None = None,
                  watchdog: Watchdog | None = None) -> None:
    """Honor a preemption signal: a final SYNCHRONOUS checkpoint (unless this
    exact step was just saved), a ``preempted`` event and a ``Preempted``
    raise that recovery does not retry. ``epoch`` is the last COMPLETED epoch
    (mid-epoch callers pass ``epoch - 1``); the save's ``preempted`` flag
    records the provenance."""
    if watchdog is not None:
        # The final save may block past any step deadline; a WatchdogTimeout
        # here would masquerade as a retriable hang on an evicted host.
        watchdog.suspend()
    step = state.step
    durable = already_durable
    drain: dict = {}
    if ckpt is not None:
        if durable is None:
            _save(ckpt, state, optimizer, {"epoch": epoch,
                                           "steps_per_epoch": steps_per_epoch,
                                           "preempted": True})
            if saved_steps is not None:
                saved_steps.append(step)
            durable = step
        # The durability barrier: the tier's promotions drain, then a bounded
        # wait for the peers' markers (a tier step counts once every rank's
        # lands). The claim must match the LISTING: a promotion that failed
        # or timed out leaves the step off it.
        landed = ckpt.await_step(durable)
        info = ckpt.drain_info() or {}
        if info:
            drain = {"drain_wait_s": info.get("wait_s"),
                     "drain_budget_s": info.get("budget_s"),
                     "drain_timed_out": info.get("timed_out")}
        if durable not in landed:
            log("fault", fault="checkpoint_not_durable", tag=tag, step=durable,
                durable_steps=landed[-3:], **drain)
            durable = None
    log("preempted", tag=tag, signal=preempt.signame, step=step, epoch=epoch,
        durable_step=durable, **drain)
    # Every rank's final moments (the signal receipt, this record) on disk.
    flightrec.dump(f"preempted:{preempt.signame}")
    raise Preempted(preempt.signame, step=step, epoch=epoch, durable_step=durable)


def fit_with_recovery(cfg: Config, train_ds: ArrayDataset,
                      test_ds: ArrayDataset | None = None, *,
                      checkpoint_dir: str | None = None, log: Log | None = None,
                      **kwargs) -> FitResult:
    """``fit`` with restart-based recovery (the JAX package's
    ``fit_with_recovery``).

    * ``Preempted`` propagates: the final checkpoint is durable and the
      process is being evicted.
    * ``DivergenceError`` rolls back to the newest step THIS call saved and
      retries with ``optim.lr *= resilience.nan_lr_factor`` (compounding), up
      to ``resilience.nan_retry_budget`` times.
    * Any other exception, ``WatchdogTimeout`` included, retries from the
      newest step this call saved (from scratch when there is none), up to
      ``train.auto_resume_retries`` times, with a ``fault`` event ``hang`` or
      ``step_exception``.

    Only this call's checkpoints are resumed from: a stale checkpoint left in
    the directory by an earlier run would otherwise make the retry skip every
    epoch. With no ``checkpoint_dir`` it is exactly ``fit``.

    Across ranks there is no retry in process (one rank re-entering ``fit``
    while its peers do not would desync every collective): a failure is
    logged as ``recovery_refused`` (``reason=multihost``) and raised; the job
    restarts with ``train.resume=true``."""
    log = log or _no_log

    def _refuse_if_multihost(err: Exception, attempt_no: int) -> None:
        if world_size() > 1:
            log("recovery_refused", reason="multihost", retry=attempt_no,
                error=repr(err)[:300])
            raise err
    attempt = nan_attempts = 0
    cfg_try = cfg
    resume_step = None
    saved_steps: list[int] = []

    def _latest_durable() -> int | None:
        if not saved_steps:
            return None
        on_disk = CheckpointManager(checkpoint_dir,
                                    max_to_keep=cfg.train.keep_checkpoints).all_steps()
        durable = set(on_disk) & set(saved_steps)
        return max(durable) if durable else None

    while True:
        try:
            return fit(cfg_try, train_ds, test_ds, checkpoint_dir=checkpoint_dir,
                       log=log, resume_step=resume_step, saved_steps=saved_steps,
                       **kwargs)
        except Preempted:
            raise
        except DivergenceError as err:
            nan_attempts += 1
            _refuse_if_multihost(err, nan_attempts)
            if nan_attempts > cfg.resilience.nan_retry_budget or checkpoint_dir is None:
                raise
            resume_step = _latest_durable()
            cfg_try = copy.deepcopy(cfg_try)   # compounds across divergence retries
            cfg_try.optim.lr *= cfg.resilience.nan_lr_factor
            cfg_try.train.resume = cfg.train.resume or resume_step is not None
            log("recovery", cause="divergence", retry=nan_attempts,
                retries_left=cfg.resilience.nan_retry_budget - nan_attempts,
                resume=cfg_try.train.resume, resume_step=resume_step,
                lr=cfg_try.optim.lr, error=repr(err)[:300])
        except Exception as err:  # noqa: BLE001 — any step failure is recoverable
            attempt += 1
            _refuse_if_multihost(err, attempt)
            if attempt > cfg.train.auto_resume_retries or checkpoint_dir is None:
                raise
            fault = "hang" if isinstance(err, WatchdogTimeout) else "step_exception"
            log("fault", fault=fault, retry=attempt, error=repr(err)[:300])
            # The final moments, before the retry refills the ring.
            flightrec.dump(f"{fault}:attempt{attempt}")
            resume_step = _latest_durable()
            log("recovery", cause="exception", retry=attempt,
                retries_left=cfg.train.auto_resume_retries - attempt,
                resume=cfg.train.resume or resume_step is not None,
                error=repr(err)[:300])
            cfg_try = copy.deepcopy(cfg_try)
            cfg_try.train.resume = cfg.train.resume or resume_step is not None


def load_data_for(cfg: Config) -> tuple[ArrayDataset, ArrayDataset]:
    """The configured dataset, with the sharded format's cache budget and read
    policy; syncs ``model.num_classes`` to it (npz and sharded datasets know
    it only from their labels)."""
    train_ds, test_ds = load_dataset(cfg.data.dataset, cfg.data.data_dir,
                                     cfg.data.synthetic_size, seed=cfg.train.seed,
                                     synthetic_noise=cfg.data.synthetic_noise,
                                     synthetic_clusters=cfg.data.synthetic_clusters,
                                     host_cache_bytes=cfg.data.host_cache_bytes,
                                     read_retries=cfg.data.read_retries,
                                     read_backoff_s=cfg.data.read_backoff_s,
                                     skip_quarantined=cfg.data.skip_quarantined)
    cfg.model.num_classes = train_ds.num_classes
    return train_ds, test_ds


def score_variables_for_seeds(cfg: Config, train_ds: ArrayDataset, *, device=None,
                              log: Log | None = None, seeds=None) -> list[dict]:
    """One scoring model's variables per seed of ``seeds`` (default
    ``score.seeds``; stage resume passes the seeds still to score): each
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
    out = []
    for s in seeds:
        with tracing.span("seed", cat="seed", seed=int(s), role="score_pretrain"):
            out.append(fit(cfg, train_ds, None, device=device, log=log,
                           num_epochs=cfg.score.pretrain_epochs, seed=int(s),
                           tag=f"score_pretrain_seed{s}",
                           train_batches=shared).state.variables)
    # The scoring pass takes whole variables: a split head joins once per seed.
    return [gather_head(v) for v in out]


def keep_fractions(cfg: Config) -> tuple[float, ...]:
    """The keep fractions of this config's prune decisions (sweep levels, else
    the single sparsity; 0.5 when the run never prunes)."""
    levels = cfg.prune.sweep or (
        (cfg.prune.sparsity,) if 0.0 < cfg.prune.sparsity < 1.0 else ())
    fracs = sorted({round(1.0 - float(s), 6) for s in levels})
    return tuple(fracs) or (0.5,)


def compute_scores(cfg: Config, train_ds: ArrayDataset, *, device=None,
                   log: Log | None = None,
                   stages: StageManifest | None = None) -> tuple[np.ndarray, dict[str, Any]]:
    """``_compute_scores`` under the ``score`` stage span, then the pass's
    observability: cross-seed stability at this run's keep fractions, the
    nonfinite-score SLO, the ``score_s`` and ``score_pretrain_s`` walls, the
    ``score_batch`` MFU at the pass's rate and a memory poll."""
    with _stage_span("score"):
        scores, timings = _compute_scores(cfg, train_ds, device=device, log=log,
                                          stages=stages)
    scoreboard.note_stability(cfg.score.method, keep_fractions=keep_fractions(cfg))
    obs_slo.check_scores(cfg.score.method, scores)
    obs_registry.observe("score_s", timings["score_s"])
    obs_registry.observe("score_pretrain_s", timings["pretrain_s"])
    steady = timings.get("steady_walls")
    if steady and sum(steady) > 0:
        rate = len(train_ds) * len(steady) / sum(steady)
        # The program the pass ran: the chunk's, else the batch's.
        if introspect.note_throughput("score_chunk", rate) is None:
            introspect.note_throughput("score_batch", rate)
    introspect.poll_memory()
    return scores, timings


def _compute_scores(cfg: Config, train_ds: ArrayDataset, *, device=None,
                    log: Log | None = None,
                    stages: StageManifest | None = None) -> tuple[np.ndarray, dict[str, Any]]:
    """The configured scores of ``train_ds`` and their timings
    ``{pretrain_s, score_s, passes}`` (``loaded_from`` when
    ``score.scores_npz`` was reused).

    ``stages`` (a ``StageManifest``) arms stage resume: each seed's float64
    score vector is saved as a partial (``<checkpoint_dir>_score_partials/``)
    as soon as its pass ends, a SIGTERM during the pass exits with
    ``Preempted`` at the next seed boundary, and a re-invocation pretrains and
    scores only the seeds without a valid partial. The result is the float64
    sum of the per-seed vectors in ``score.seeds`` order over the number of
    seeds, cast to float32, so a resumed pass is bitwise an uninterrupted
    one."""
    device = resolve_device(device)
    log = log or _no_log
    t0 = time.perf_counter()
    if cfg.score.scores_npz:
        scores = load_scores_npz(cfg.score.scores_npz, train_ds,
                                 expect_method=cfg.score.method)
        log("scores_loaded", path=cfg.score.scores_npz, n=len(scores))
        return scores, {"pretrain_s": 0.0, "score_s": time.perf_counter() - t0,
                        "passes": 0, "loaded_from": cfg.score.scores_npz}
    partials = _score_partial_store(cfg, train_ds, log, stages)
    seeds = [int(s) for s in cfg.score.seeds]
    done = partials.load_all(seeds) if partials is not None else {}
    if cfg.score.method in ("forgetting", "aum"):
        scores = trajectory_scores(cfg, train_ds, device=device, log=log,
                                   partials=partials, preloaded=done)
        # The fits are the scoring pass: the whole wall is score_s, over the
        # seeds computed here (not those resumed from partials).
        return scores, {"pretrain_s": 0.0, "score_s": time.perf_counter() - t0,
                        "passes": len([s for s in seeds if s not in done])}
    todo = [s for s in seeds if s not in done]
    if done:
        log("score_seeds_resumed", method=cfg.score.method, done=sorted(done), todo=todo)
    for s, arr in done.items():
        # The stream describes every seed the mean holds, resumed ones too.
        scoreboard.note_seed_scores(cfg.score.method, s, arr, resumed=True)
    vectors: dict[int, np.ndarray] = dict(done)   # by seed
    pretrain_s = score_s = 0.0
    passes = 0
    scores = None
    steady_walls: list[float] = []
    if todo:
        preempt = PreemptionHandler(enabled=(partials is not None
                                             and cfg.resilience.preemption))
        with preempt:
            seeds_vars = score_variables_for_seeds(
                cfg, train_ds, device=device, log=log,
                seeds=todo if partials is not None else None)
            pretrain_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            seed_walls: list[float] = []   # each seed's pass, for the MFU
            profile = (ProfileWindow(cfg.obs.profile_dir, "score", start_epoch=0,
                                     num_epochs=len(seeds_vars),
                                     window_chunks=cfg.obs.profile_window_chunks,
                                     device_type=device.type)
                       if cfg.obs.profile_dir and process_index() == 0 else None)

            def on_seed_done(k: int, seed_scores: np.ndarray) -> None:
                seed_walls.append(time.perf_counter() - t1 - sum(seed_walls))
                vectors[todo[k]] = seed_scores
                tracing.instant("seed_scored", cat="seed", seed=todo[k])
                if partials is None:
                    return
                partials.save(todo[k], seed_scores)
                inject.fire("seed_scored", seed=todo[k], completed=len(done) + k + 1)
                # Agreed across ranks, so every rank leaves at this boundary.
                if agree_any(preempt.requested):
                    # The finished seed's partial is durable: the clean exit
                    # (CLI 75) loses at most the next seed's work.
                    raise Preempted(preempt.signame)

            scores = score_dataset(
                create_model_from_cfg(cfg), seeds_vars, train_ds,
                method=cfg.score.method, batch_size=cfg.score.batch_size,
                chunk=cfg.score.grand_chunk, eval_mode=cfg.score.eval_mode,
                use_kernels=cfg.score.use_pallas,
                # As for every seed at once, however many are left: a resumed
                # pass runs the same batches.
                device_resident=(resident_by_default(len(seeds), train_ds)
                                 if partials is not None and cfg.data.data_plane == "auto"
                                 else None),
                on_seed_done=on_seed_done,
                data_plane=cfg.data.data_plane, prefetch_depth=cfg.data.prefetch_depth,
                log=log, device=device, seed_ids=todo[:len(seeds_vars)], profile=profile,
                chunk_steps=cfg.score.chunk_steps)
            score_s = time.perf_counter() - t1
            steady_walls = _steady(seed_walls, profile)
        passes = len(seeds_vars)
    if partials is not None:
        # The done seeds join the new ones: the float64 sum in seed order.
        total = np.zeros(len(train_ds), np.float64)
        for seed in seeds:
            total += vectors[seed]
        scores = (total / len(seeds)).astype(np.float32)
    if stages is not None:
        stages.complete("score", method=cfg.score.method, n=int(len(scores)),
                        reused_seeds=sorted(done))
    return scores, {"pretrain_s": pretrain_s, "score_s": score_s, "passes": passes,
                    "steady_walls": steady_walls}


def _steady(walls: list[float], profile: ProfileWindow | None) -> list[float]:
    """The walls of a fit's epochs or a pass's seeds that are steady, for the
    MFU: not the one a profile window captured (its capture and export are in
    its wall), nor the first, which holds the warm-up and the program harvest,
    when another remains."""
    captured = profile.captured_epoch if profile is not None else None
    clean = [(k, w) for k, w in enumerate(walls) if k != captured]
    if len(clean) > 1:
        clean = clean[1:]
    return [w for _, w in clean]


def trajectory_scores(cfg: Config, train_ds: ArrayDataset, *, device=None,
                      log: Log | None = None, partials: ScorePartialStore | None = None,
                      preloaded: dict | None = None) -> np.ndarray:
    """Trajectory scores (the JAX package's ``trajectory_scores``): forgetting
    events (``score.method=forgetting``) or the area under the margin
    (``aum``), ``ops/forgetting.py``.

    Per seed of ``score.seeds``: a fresh model fits ``score.pretrain_epochs``
    epochs, and after each epoch a correctness (``forgetting``) or margin
    (``aum``) pass runs over the train set in dataset order on the fit's
    variables, through the fit's resident upload when there is one (else
    streamed); the tracker accumulates on the host. Scores are the float64
    sum of the per-seed vectors in ``score.seeds`` order over their number,
    cast to float32.

    ``partials`` (a ``ScorePartialStore``) arms stage resume: the seeds in
    ``preloaded`` (the partials the caller loaded; loaded here when None) are
    not refit, each finished seed's vector is saved before the next starts,
    and a SIGTERM loses at most the seed in flight (``Preempted``: from the
    fit it lands in, or at the boundary after a seed's save)."""
    method = cfg.score.method
    if cfg.score.pretrain_epochs < 1:
        raise ValueError(
            f"score.method={method} tracks the training trajectory; set "
            "score.pretrain_epochs >= 1")
    if method == "forgetting":
        kind, make_tracker, to_obs = "correctness", ForgettingTracker, (lambda v: v > 0.5)
    elif method == "aum":
        kind, make_tracker, to_obs = "margin", AUMTracker, (lambda v: v)
    else:
        # The forgetting_scores alias must not return AUM scores for a config
        # of another method.
        raise ValueError(f"trajectory_scores handles forgetting/aum, got {method!r}")
    device = resolve_device(device)
    log = log or _no_log
    seeds = [int(s) for s in cfg.score.seeds]
    n = len(train_ds)
    batch_size = global_batch_size_for(cfg.data.batch_size)
    rows = batch_slice()
    # Dataset position of each row this rank holds in each batch of the pass.
    p, nprocs = rows or (0, 1)
    loc = batch_size // nprocs
    pos = (np.arange(num_batches(n, batch_size))[:, None] * batch_size + p * loc
           + np.arange(loc)).reshape(-1)
    local = make_local_scores(create_model_from_cfg(cfg).to(device), kind,
                              eval_mode=cfg.score.eval_mode)
    shared = train_resident(cfg, train_ds, device)
    done = preloaded if preloaded is not None else (
        partials.load_all(seeds) if partials is not None else {})
    if done:
        log("score_seeds_resumed", method=method, done=sorted(done),
            todo=[s for s in seeds if s not in done])
    total = np.zeros(n, np.float64)
    completed = len(done)
    preempt = PreemptionHandler(enabled=(partials is not None
                                         and cfg.resilience.preemption))
    with preempt:
        for seed in seeds:
            if seed in done:
                total += done[seed]
                scoreboard.note_seed_scores(method, seed, done[seed], resumed=True)
                continue
            tracker = make_tracker(n)

            def hook(model, state, epoch, tracker=tracker):
                del model, epoch
                batches = (shared(shuffle=False) if shared is not None else
                           prefetch_stream(train_ds, batch_size, device,
                                           depth=cfg.data.prefetch_depth,
                                           stage=f"{method}_pass", image_slice=rows))
                try:
                    outs = [local(state.variables, b["image"], b["label"], b["mask"])
                            for b in batches]
                finally:
                    batches.close()
                vals = torch.cat(outs).cpu().numpy()
                if rows:
                    # Each position has one owner: the float64 sum joins the ranks.
                    vec = np.zeros(n, np.float64)
                    vec[pos[pos < n]] = vals[pos < n]
                    vals = sum_float64(_one_per_data_rank(vec)).astype(vals.dtype)
                tracker.update(to_obs(vals[:n]))

            with tracing.span("seed", cat="seed", seed=seed, role=method):
                fit(cfg, train_ds, None, device=device, log=log,
                    num_epochs=cfg.score.pretrain_epochs, seed=seed,
                    tag=f"{method}_seed{seed}", train_batches=shared, epoch_hook=hook)
            rec: dict[str, Any] = {"seed": seed, "epochs": tracker.updates}
            if method == "forgetting":
                rec.update(never_learned=int((~tracker.learned).sum()),
                           mean_events=float(tracker.counts.mean()))
            else:
                rec.update(mean_margin=float(tracker.scores().mean()))
            log(f"{method}_seed_done", **rec)
            seed_scores = np.asarray(tracker.scores(), np.float64)
            scoreboard.note_seed_scores(method, seed, seed_scores)
            total += seed_scores
            completed += 1
            if partials is not None:
                partials.save(seed, seed_scores)
                inject.fire("seed_scored", seed=seed, completed=completed)
                if agree_any(preempt.requested):
                    # The finished seed's partial is durable: the clean exit
                    # (CLI 75) loses nothing, and a resume starts at the next seed.
                    raise Preempted(preempt.signame)
    return (total / len(seeds)).astype(np.float32)


#: The JAX package's other name for ``trajectory_scores``.
forgetting_scores = trajectory_scores


def scores_npz_path(checkpoint_dir: str) -> str:
    return f"{checkpoint_dir}_scores.npz"


def _score_fingerprint_key(cfg: Config) -> dict:
    """The config fields a per-example SCORE depends on (the JAX package's
    key): the scoring pretrain's recipe and the score math, not the prune or
    retrain knobs."""
    return {
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
    }


def _hash_key(key: dict) -> str:
    return hashlib.sha256(json.dumps(key, sort_keys=True).encode()).hexdigest()[:16]


def score_fingerprint(cfg: Config) -> str:
    """Provenance hash stored in each per-seed score partial; the seed list is
    left out, so adding seeds reuses the ones already computed."""
    return _hash_key(_score_fingerprint_key(cfg))


def pipeline_fingerprint(cfg: Config) -> str:
    """Hash of every config field that decides what run/sweep computes (the
    JAX package's ``pipeline_fingerprint`` key), recorded in the stage
    manifest and the prune sidecar."""
    return _hash_key(dict(
        _score_fingerprint_key(cfg),
        seeds=[int(s) for s in cfg.score.seeds],
        prune=[cfg.prune.sparsity, cfg.prune.keep, cfg.prune.class_balance,
               list(cfg.prune.sweep)],
        train=[cfg.train.num_epochs, cfg.train.seed],
    ))


def pipeline_stages(cfg: Config, log: Log | None = None) -> StageManifest:
    """The run/sweep/score stage manifest (``<train.checkpoint_dir>_stages.json``,
    keyed by ``pipeline_fingerprint``; inert when ``resilience.stage_resume``
    is off)."""
    return StageManifest(stage_manifest_path(cfg.train.checkpoint_dir),
                         pipeline_fingerprint(cfg), enabled=cfg.resilience.stage_resume,
                         log=log)


def _score_partial_store(cfg: Config, train_ds: ArrayDataset, log: Log,
                         stages: StageManifest | None) -> ScorePartialStore | None:
    """The per-seed partial store when stage resume applies: on, not a
    fixed-checkpoint pass (one cheap unit), and no duplicate seeds (partials
    key by seed value)."""
    seeds = [int(s) for s in cfg.score.seeds]
    if (stages is None or not stages.enabled or cfg.score.score_ckpt_step is not None
            or len(seeds) != len(set(seeds))):
        return None
    return ScorePartialStore(score_partials_dir(cfg.train.checkpoint_dir),
                             method=cfg.score.method, indices=train_ds.indices,
                             fingerprint=score_fingerprint(cfg), log=log)


def _retrain_level(cfg: Config, train_ds: ArrayDataset, test_ds: ArrayDataset,
                   scores: np.ndarray, sparsity: float, *, device, log: Log,
                   ckpt_dir: str, tag: str, score_t: dict[str, Any],
                   scoring_shared: bool = False,
                   stages: StageManifest | None = None) -> dict[str, Any]:
    """Prune at ``sparsity``, write the scores npz and its sidecar, verify the
    sidecar, retrain a fresh model on the kept set through
    ``fit_with_recovery``; returns the summary (with each stage's wall:
    ``pretrain_wall_s``, ``score_wall_s``, ``prune_wall_s``,
    ``train_wall_s``).

    ``stages``: a completed ``retrain:<tag>`` returns its recorded summary
    without retraining; a STARTED one resumes the retrain from its own
    checkpoints instead of restarting at epoch 0."""
    stage = f"retrain:{tag}"
    if stages is not None and stages.completed(stage):
        summary = stages.info(stage).get("summary") or {}
        log("stage", stage=stage, status="skipped", sparsity=float(sparsity),
            final_test_accuracy=summary.get("final_test_accuracy"))
        return summary
    t0 = time.perf_counter()
    with _stage_span(f"prune:{tag}"):
        kept, npz = _prune(cfg, train_ds, scores, sparsity, tag, log, score_t, ckpt_dir)
    score_s, pretrain_s = score_t["score_s"], score_t["pretrain_s"]
    loaded_from = score_t.get("loaded_from")
    method = f"reused:{loaded_from}" if loaded_from else cfg.score.method
    prune_rec = {"n_total": len(train_ds), "n_kept": len(kept),
                 "score_s": round(score_s, 3), "pretrain_s": round(pretrain_s, 3)}
    if not loaded_from and score_t.get("passes") and score_s > 0:
        prune_rec["score_examples_per_s"] = len(train_ds) * score_t["passes"] / score_s
    log("prune", **prune_rec)
    if stages is not None:
        stages.complete(f"prune:{tag}", n_kept=int(len(kept)), sparsity=float(sparsity))
    cfg_retrain = cfg
    if stages is not None and stages.started(stage) and not cfg.train.resume:
        # This stage was interrupted mid-retrain: re-enter from its own
        # checkpoints (never on a fresh stage, whose directory may hold an
        # invalidated earlier config's checkpoints).
        cfg_retrain = copy.deepcopy(cfg)
        cfg_retrain.train.resume = True
        log("stage", stage=stage, status="resuming", ckpt_dir=ckpt_dir)
    if stages is not None:
        stages.start(stage, ckpt_dir=ckpt_dir)
    verify_prune_manifest(npz, kept)
    prune_s = time.perf_counter() - t0
    with _stage_span(stage):
        res = fit_with_recovery(cfg_retrain, train_ds.subset(kept), test_ds,
                                device=device, log=log, checkpoint_dir=ckpt_dir, tag=tag)
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
    if stages is not None:
        # Which tier each of the stage's steps lives in ("durable", "local",
        # "plain"): what a resume of it would trust.
        stages.complete(stage, summary=summary,
                        ckpt_tiers=tier_map(ckpt_dir, cfg.checkpoint.local_dir))
    return summary


def _prune(cfg: Config, train_ds: ArrayDataset, scores: np.ndarray, sparsity: float,
           tag: str, log: Log, score_t: dict[str, Any],
           ckpt_dir: str) -> tuple[np.ndarray, str]:
    """The kept set at ``sparsity`` and the scores npz written with it (its
    provenance sidecar beside it; ``prune_decision`` logged)."""
    kept = select_indices(scores, train_ds.indices, sparsity, keep=cfg.prune.keep,
                          seed=cfg.train.seed, labels=train_ds.labels,
                          class_balance=cfg.prune.class_balance)
    # Rows served as zeros by a quarantined shard (data.skip_quarantined) were
    # scored on meaningless bytes: they leave the kept set, and the manifest
    # says so.
    q_rows = _quarantined_rows(train_ds)
    q_dropped = 0
    if len(q_rows):
        before = len(kept)
        kept = kept[~np.isin(kept, np.asarray(train_ds.indices)[q_rows])]
        q_dropped = before - len(kept)
    loaded_from = score_t.get("loaded_from")
    method = f"reused:{loaded_from}" if loaded_from else cfg.score.method
    manifest = build_prune_manifest(
        scores, train_ds.indices, kept, method=method, sparsity=float(sparsity),
        keep=cfg.prune.keep, class_balance=cfg.prune.class_balance,
        seed=cfg.train.seed, fingerprint=pipeline_fingerprint(cfg))
    if len(q_rows):
        manifest["quarantined_shards"] = sorted(int(s) for s in train_ds.images.quarantined)
        manifest["quarantined_rows"] = int(len(q_rows))
        manifest["quarantined_dropped_from_kept"] = int(q_dropped)
    npz = scores_npz_path(ckpt_dir)
    if is_primary():   # every rank holds the same scores and kept set; one writes
        atomic_savez(npz, scores=scores, indices=train_ds.indices, kept=kept,
                     keep=cfg.prune.keep, class_balance=cfg.prune.class_balance,
                     method=method)
        write_prune_manifest(npz, manifest)
    sync_hosts(f"prune:{tag}")
    log("prune_decision", manifest=provenance_path(npz),
        **{k: manifest[k] for k in ("fingerprint", "method", "sparsity", "keep",
                                    "class_balance", "n_total", "n_kept", "n_dropped",
                                    "nonfinite_scores", "threshold_score",
                                    "kept_digest", "dropped_digest", "top_k",
                                    "bottom_k")})
    return kept, npz


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
    own checkpoint directory (``sweep_level_dir``). Stage-resumable: finished
    levels are skipped and a started one resumes from its checkpoints."""
    device = resolve_device(device)
    log = log or _no_log
    levels = sweep_levels(cfg)
    train_ds, test_ds = load_data_for(cfg)
    stages = pipeline_stages(cfg, log)
    scores, score_t = compute_scores(cfg, train_ds, device=device, log=log,
                                     stages=stages)
    log("sweep_scored", n=len(train_ds), score_s=round(score_t["score_s"], 3),
        pretrain_s=round(score_t["pretrain_s"], 3), levels=list(levels))
    summaries = []
    for sparsity in levels:
        # Elastic: a pending resize (a join) is honoured here, between levels;
        # the relaunched world's stage resume skips the finished ones.
        stage_barrier(cfg, log, boundary=f"retrain:final_{sweep_suffix(sparsity)}")
        summaries.append(_retrain_level(
            cfg, train_ds, test_ds, scores, sparsity, device=device, log=log,
            ckpt_dir=sweep_level_dir(cfg.train.checkpoint_dir, sparsity),
            tag=f"final_{sweep_suffix(sparsity)}", score_t=score_t,
            scoring_shared=True, stages=stages))
    log("sweep_done", levels=list(levels),
        total_wall_s=round(score_t["pretrain_s"] + score_t["score_s"]
                           + sum(s["train_wall_s"] for s in summaries), 3))
    return summaries


def run_datadiet(cfg: Config, *, device=None, log: Log | None = None) -> dict[str, Any]:
    """(Pretrain ->) score -> prune -> retrain from scratch -> eval; at
    ``prune.sparsity=0`` a dense fit (stage ``dense:final``). Stage-resumable
    (``resilience.stage_resume``): a preempted (exit 75) or crashed run
    re-invoked with the same config re-enters at its stage."""
    device = resolve_device(device)
    log = log or _no_log
    train_ds, test_ds = load_data_for(cfg)
    stages = pipeline_stages(cfg, log)
    t0 = time.perf_counter()
    if cfg.prune.sparsity > 0.0:
        scores, score_t = compute_scores(cfg, train_ds, device=device, log=log,
                                         stages=stages)
        # Elastic: the score -> retrain boundary (see run_sweep).
        stage_barrier(cfg, log, boundary="retrain:final")
        return _retrain_level(cfg, train_ds, test_ds, scores, cfg.prune.sparsity,
                              device=device, log=log, ckpt_dir=cfg.train.checkpoint_dir,
                              tag="final", score_t=score_t, stages=stages)
    stage = "dense:final"
    if stages.completed(stage):
        summary = stages.info(stage).get("summary") or {}
        log("stage", stage=stage, status="skipped",
            final_test_accuracy=summary.get("final_test_accuracy"))
        return summary
    cfg_dense = cfg
    if stages.started(stage) and not cfg.train.resume:
        cfg_dense = copy.deepcopy(cfg)
        cfg_dense.train.resume = True
        log("stage", stage=stage, status="resuming", ckpt_dir=cfg.train.checkpoint_dir)
    stages.start(stage, ckpt_dir=cfg.train.checkpoint_dir)
    with _stage_span(stage):
        res = fit_with_recovery(cfg_dense, train_ds, test_ds, device=device, log=log,
                                checkpoint_dir=cfg.train.checkpoint_dir, tag="final")
    summary = {"dataset": cfg.data.dataset, "n_train": len(train_ds),
               "sparsity": cfg.prune.sparsity, "score_method": cfg.score.method,
               "final_test_accuracy": res.final_test_accuracy,
               "train_wall_s": res.wall_s, "total_wall_s": time.perf_counter() - t0}
    log("summary", **{k: v for k, v in summary.items() if v is not None})
    stages.complete(stage, summary=summary,
                    ckpt_tiers=tier_map(cfg.train.checkpoint_dir, cfg.checkpoint.local_dir))
    return summary
