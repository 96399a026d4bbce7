"""Typed configuration: the part of ``data_diet_distributed_tpu/config.py`` the
port reads.

``DataConfig``, ``ModelConfig``, ``OptimConfig``, ``ScoreConfig``,
``PruneConfig``, ``TrainConfig``, ``ResilienceConfig``, ``MeshConfig``,
``CheckpointConfig`` and ``ElasticConfig`` are copied whole, with the JAX
package's validations. ``train.chunk_steps`` and ``score.chunk_steps`` take
effect with the JAX package's meaning (null = auto, 0 or 1 = per step or per
batch, K > 1 = requested): the chunked engine runs K steps or K score
batches as one dispatch, one CUDA-graph replay on the card
(``train/loop.py::resolve_chunk_steps``,
``ops/scoring.py::resolve_score_chunk_steps``), and ``data.data_plane=
streaming`` feeds it prefetched blocks (the ``chunked_stream`` engine). Of
``resilience``, the port honours ``step_timeout_s``, ``preemption``,
``verify_restore``, ``nan_check``, ``nan_retry_budget``, ``nan_lr_factor``,
``stage_resume``, the ``init_probe`` settings and, across processes, the
consensus keys (``consensus``, ``consensus_poll_steps``,
``consensus_grace_s``, ``sidechannel_dir``). Of ``mesh`` every key takes
effect (``parallel/mesh.py``): ``model_axis`` > 1 splits the classifier head
over a model group of that many ranks. ``checkpoint`` arms the local tier
(``checkpoint.py::LocalTier``: per-rank saves promoted in the background to
``<train.checkpoint_dir>_tiered``), and ``elastic`` makes the CLI a restart
supervisor over its own workers (``resilience/elastic.py``); every key of
both takes effect.

``ServeConfig`` is copied whole with its validation; ``cli serve`` reads the
single-process keys (on one rank or, with ``mesh.multihost``, on every rank of
a group), and ``replicas > 1`` or ``max_replicas`` make it the serving fleet
(``serve/fleet.py``: the router, autoscaler, probation and canary keys); with
``mesh.multihost`` each replica of the fleet is a group of
``mesh.num_processes`` ranks, whose ``coordinator_address`` and ``process_id``
the fleet sets. ``ObsConfig`` is copied whole with its validation; every key
takes effect (``plots_dir``: the post-run plots, ``obs/plots.py``); ``slo_recovery_s``
is the cross-attempt recovery objective of a supervised run and
``slo_fleet_*`` the serving fleet's (``obs/slo.py``). ``TuningConfig`` is
copied whole with its validation (``tuning.py``: the signed manifest the CLI
applies at startup). The one section the port does not have (parallel) is
accepted key by key and ignored, so every ``configs/*.yaml`` loads unchanged,
while an unknown key anywhere still raises ``KeyError`` as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any

import yaml


@dataclass
class DataConfig:
    """Dataset selection and host-side pipeline knobs."""

    # cifar10 | cifar100 | synthetic | synthetic_imagenet | npz | sharded
    dataset: str = "cifar10"
    data_dir: str = "./data"
    batch_size: int = 128
    eval_batch_size: int = 500
    synthetic_size: int = 2048
    synthetic_noise: float = 0.4
    synthetic_clusters: int = 1
    shuffle_each_epoch: bool = True
    augment: bool = False
    crop_pad: int = 4
    flip: bool = True
    data_plane: str = "auto"
    prefetch_depth: int = 2
    host_cache_bytes: int = 1 << 30
    read_retries: int = 2
    read_backoff_s: float = 0.05
    skip_quarantined: bool = False

    @property
    def num_classes(self) -> int | None:
        """Class count when statically known; None for npz (inferred at load)."""
        return {"cifar10": 10, "cifar100": 100, "synthetic": 10,
                "synthetic_imagenet": 100, "npz": None, "sharded": None}[self.dataset]


@dataclass
class ModelConfig:
    arch: str = "resnet18"
    num_classes: int = 10
    stem: str = "cifar"
    remat: bool = False


@dataclass
class OptimConfig:
    """SGD + momentum + weight decay + cosine schedule (``train/state.py``)."""

    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = False
    cosine_t_max_epochs: int | None = None   # None -> train.num_epochs
    warmup_epochs: int = 0                   # linear warmup into the cosine
    grad_clip_norm: float | None = None


@dataclass
class ScoreConfig:
    # el2n | margin | grand | grand_vmap | grand_last_layer | forgetting | aum
    method: str = "el2n"
    score_ckpt_step: int | None = None
    pretrain_epochs: int = 2
    seeds: tuple[int, ...] = (0,)
    batch_size: int = 512
    grand_chunk: int = 32
    eval_mode: bool = True
    # Hand-written kernels on the card: None or True = on (CPU tensors always
    # take the plain versions), False = the plain route everywhere.
    use_pallas: bool | None = None
    # Score batches a dispatch: None = auto (the epoch, up to 32), 0/1 = per batch.
    chunk_steps: int | None = None
    scores_npz: str | None = None


@dataclass
class PruneConfig:
    sparsity: float = 0.5
    keep: str = "hardest"
    class_balance: bool = False
    sweep: tuple[float, ...] = ()


@dataclass
class TrainConfig:
    num_epochs: int = 10
    seed: int = 0
    eval_every: int = 1
    checkpoint_every: int = 5
    checkpoint_dir: str = "./checkpoints"
    keep_checkpoints: int = 20
    resume: bool = False
    auto_resume_retries: int = 0             # fit_with_recovery retries
    half_precision: bool = True              # bf16 compute, fp32 parameters
    # Upload the train/test sets to the device once and gather batches there.
    # None = auto: on when the set fits data/pipeline.RESIDENT_MAX_BYTES.
    device_resident_data: bool | None = None
    # Train steps a dispatch: None = auto (16), 0/1 = per step, K > 1 = K.
    chunk_steps: int | None = None
    log_every_steps: int = 50


@dataclass
class ResilienceConfig:
    """Fault tolerance (``resilience/``): watchdog, preemption handling,
    checkpoint integrity, NaN sentinel, stage resume."""

    # Heartbeat deadline over training progress units: each step, the epoch
    # metrics fetch, the eval pass and the checkpoint save each get a fresh
    # deadline; a unit that makes no host-side progress for this long raises
    # a retriable WatchdogTimeout. None = off.
    step_timeout_s: float | None = None
    # SIGTERM/SIGINT -> final synchronous checkpoint -> Preempted (CLI exit
    # 75); rerun with train.resume=true (or the same run/sweep) to continue.
    preemption: bool = True
    # Verify restored checkpoints against their manifest and fall back to the
    # newest earlier step when the latest is corrupt. False: resume from the
    # newest (or the given) step with no fallback; the port's format still
    # checks what it reads, so a corrupt step raises CheckpointCorrupt (the
    # JAX package loads it unverified).
    verify_restore: bool = True
    # Raise on NaN/inf epoch loss BEFORE the diverged state is checkpointed...
    nan_check: bool = True
    # ...then roll back to the last good checkpoint and retry with
    # lr *= nan_lr_factor, up to nan_retry_budget times.
    nan_retry_budget: int = 1
    nan_lr_factor: float = 0.5
    # Subprocess-bounded CUDA-init probe with retry and backoff before the
    # CLI touches the card (exit 69 when it fails).
    init_probe: bool = False
    probe_attempts: int = 3
    probe_timeout_s: float = 150.0
    probe_backoff_s: float = 20.0
    # Multi-host consensus (resilience/consensus.py): agreed preemption and
    # divergence, the min-agreed restore and the poison side channel; no
    # effect in one process.
    consensus: bool = True
    consensus_poll_steps: int = 1
    consensus_grace_s: float = 15.0
    sidechannel_dir: str | None = None
    # Durable stage manifest + per-seed score partials: an interrupted
    # run/sweep/score re-enters at the exact pipeline stage.
    stage_resume: bool = True


@dataclass
class MeshConfig:
    """Process geometry (``parallel/mesh.py``): W processes, one device each,
    compute what the JAX package computes on a mesh ``{data: W / M, model:
    M}``."""

    data_axis: int | None = None     # None -> num_processes // model_axis
    model_axis: int = 1              # M > 1: the classifier head split over M ranks
    # ZeRO-1: each rank holds the momentum only for its shard of each leaf.
    shard_opt_state: bool = False
    # The cross-replica sharded weight update (implies shard_opt_state):
    # gradients reduce-scatter, each rank updates its shard, the parameters
    # all-gather. None = armed by DDT_SHARDED_UPDATE=1.
    shard_weight_update: bool | None = None
    # Join a torch.distributed group (tcp://coordinator_address) before the
    # data loads: NCCL for CUDA, gloo for the CPU.
    multihost: bool = False
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None


#: Checkpoint-based score methods the serving layer can hold warm (trajectory
#: methods score a training run, not a checkpoint). ONE definition:
#: ``Config.validate`` checks ``serve.methods`` against it and the serve
#: engine dispatches on it.
SERVABLE_METHODS = ("el2n", "margin", "grand", "grand_vmap", "grand_last_layer")


@dataclass
class ObsConfig:
    """Observability (``obs/``), the JAX package's keys and defaults: the
    metrics stream, the trace, the registry snapshots and Prometheus
    textfile, the heartbeat, the flight recorder, program introspection and
    the memory watermark, the ``torch.profiler`` window, score telemetry, the
    perf-history ledger, the status server, the fleet view, the resource
    monitor and the training, serving, fleet and recovery SLOs
    (``slo_recovery_s``: a supervised relaunch's wall from the fault's
    classification to its first training step; ``slo_fleet_*``: the serving
    fleet's router p95 and routable fraction) and ``plots_dir`` (the post-run
    plots, rendered by rank 0 after a command that was not preempted)."""

    # JSON lines {"ts", "kind", ...} of the command's records; None = none.
    metrics_path: str | None = "./metrics.jsonl"
    # Host/device utilization sampled by a thread into monitor_path.
    monitor: bool = False
    monitor_path: str = "./utilization.jsonl"
    # torch.profiler captures: one steady window per stage under this dir.
    profile_dir: str | None = None
    profile_window_chunks: int = 8
    plots_dir: str | None = None
    # Chrome-trace spans; None path -> trace.json next to the metrics stream.
    trace: bool = True
    trace_path: str | None = None
    # A {"kind": "metrics"} snapshot at most every this-many seconds (epoch
    # boundaries; 0 = only the final one), and a Prometheus textfile.
    snapshot_every_s: float = 60.0
    prom_path: str | None = None
    # Per-rank heartbeat file; None dir -> <train.checkpoint_dir>_heartbeats.
    heartbeat: bool = True
    heartbeat_dir: str | None = None
    heartbeat_interval_s: float = 0.5
    # Flight recorder: a ring of the last events, dumped on faults to
    # <dir>/flightrec_rank<k>.json (None dir -> next to the metrics stream).
    flightrec: bool = True
    flightrec_capacity: int = 256
    flightrec_dir: str | None = None
    # Program introspection (FLOPs, compile wall, memory, MFU) and the
    # device-memory watermark trail (a record per peak jump of this fraction).
    xla_introspect: bool = True
    hbm_jump_frac: float = 0.10
    # Score telemetry: score_stats per seed pass, score_stability per pass.
    score_telemetry: bool = True
    score_hist_bins: int = 32
    # Append-only perf-history ledger: one perf_history record per command.
    perf_ledger: str | None = None
    # Status server (/healthz /metrics /status /flightrec); 0 = a free port.
    server_port: int | None = None
    server_host: str = "127.0.0.1"
    # fleet_status records from the merged heartbeats (multi-rank runs).
    fleet: bool = True
    # Training SLOs: throughput floor (absolute, and/or a fraction of the
    # perf ledger's baseline), heartbeat staleness budget (also /healthz's),
    # nonfinite-score budget, eval-accuracy floor.
    slo_throughput_floor: float | None = None
    slo_throughput_frac: float | None = None
    slo_heartbeat_stale_s: float | None = None
    slo_nonfinite_frac: float | None = None
    slo_eval_accuracy_floor: float | None = None
    # Serving SLOs, judged at every serve_stats point: p95 request latency
    # (ms), pending queue depth, and the tolerated rejected fraction.
    slo_serve_p95_ms: float | None = None
    slo_serve_queue_depth: int | None = None
    slo_serve_reject_frac: float | None = None
    # Serving-fleet SLOs, judged at every serve_fleet stats point: the
    # router's p95 (ms; also the canary's floor and the autoscaler's) and the
    # routable fraction of the replicas.
    slo_fleet_p95_ms: float | None = None
    slo_fleet_available_frac: float | None = None
    slo_recovery_s: float | None = None


@dataclass
class ServeConfig:
    """Scoring as a service (``serve/``, ``cli serve``): one process keeps the
    dataset and the score functions warm on the card and answers
    ``POST /v1/score``, ``POST /v1/rank``, ``GET /v1/topk`` and
    ``POST /v1/refresh`` over HTTP, plus /healthz /metrics /status /flightrec.
    Requests coalesce into padded batches (``serve/batcher.py``), with 429 +
    Retry-After past ``max_queue`` and weighted round-robin across tenants;
    SIGTERM drains bounded by ``drain_timeout_s`` and exits 75. The fleet keys
    (``replicas`` onwards) drive ``serve/fleet.py`` and ``serve/router.py``
    when ``replicas > 1`` or ``max_replicas`` is set."""

    port: int = 0                    # 0 = auto-pick; logged as obs_server
    host: str = "127.0.0.1"
    tenant: str | None = None        # default tenant; None -> data.dataset
    # Methods scored at boot; () -> score.method (el2n when not servable).
    methods: tuple[str, ...] = ()
    batch_size: int | None = None    # request geometry B; None -> score.batch_size
    max_queue: int = 64              # per-tenant pending requests before 429
    retry_after_s: float = 1.0       # the 429 Retry-After hint
    coalesce_ms: float = 5.0         # a partial batch waits at most this long
    request_timeout_s: float = 60.0  # per-request completion bound
    drain_timeout_s: float = 30.0    # SIGTERM drain bound
    stats_every_s: float = 10.0      # serve_stats + serve-SLO cadence
    warm: bool = True                # score serve.methods at boot
    request_log: bool = True         # one serve_request record per request
    # --- serving fleet (serve/fleet.py + serve/router.py) ----------------
    replicas: int = 1
    router_port: int = 0
    # A dispatch in flight longer than this makes /healthz critical.
    dispatch_stall_s: float | None = 30.0
    # Poll the refresh source for a newer step this often (None = manual).
    refresh_poll_s: float | None = None
    # Checkpoint dir refreshes restore from; None -> train.checkpoint_dir.
    refresh_from: str | None = None
    route_retries: int = 2
    breaker_failures: int = 3
    breaker_reset_s: float = 2.0
    hedge_ms: float | None = None
    health_poll_s: float = 0.5
    idempotency_cache: int = 256
    hosts: tuple[str, ...] = ()
    remote_launch: str | None = None
    min_replicas: int | None = None
    max_replicas: int | None = None
    scale_up_after: int = 2
    scale_down_after: int = 5
    scale_cooldown_s: float = 10.0
    partition_after_misses: int = 3
    probe_backoff_s: float = 0.5
    probe_backoff_max_s: float = 8.0
    canary_requests: int | None = None
    canary_timeout_s: float = 30.0
    # --- request tracing (obs/reqtrace.py) --------------------------------
    # Head-sampled fraction of healthy requests' serve_trace records (failed
    # and slow ones are always kept).
    trace_sample_frac: float = 0.02
    # "Slow" wall threshold; None -> obs.slo_serve_p95_ms, else 250 ms.
    trace_slow_ms: float | None = None


@dataclass
class CheckpointConfig:
    """The local checkpoint tier (``checkpoint.py::LocalTier``): each rank
    saves the arrays it owns to local disk at the step cadence, and a
    background thread promotes each save to the durable tier
    (``<train.checkpoint_dir>_tiered``), re-verifying its digests. A step is
    restorable only once every rank's part is promoted and verified;
    preemption drains the promotions in flight before exit 75."""

    local_tier: bool = False
    # Per-rank local (fast) tier ROOT; None -> <checkpoint_dir>_local. A
    # configured root is namespaced by the checkpoint directory
    # (checkpoint.local_tier_dir), so jobs may share one.
    local_dir: str | None = None
    promote: bool = True             # background promotion to the durable tier
    drain_timeout_s: float = 120.0   # preemption-path bound on the drain
    # Seconds each promotion waits before it copies: a drill's hook to land a
    # SIGTERM while a promotion is in flight.
    promote_delay_s: float = 0.0


@dataclass
class ElasticConfig:
    """Elastic supervision (``resilience/elastic.py``): with ``enabled`` the
    CLI spawns ``world`` workers of the same command and relaunches them with
    ``train.resume=true`` after a worker's death (on the survivors), a
    retriable failure (in place), a preemption (``resume_preempted``) or a
    join request (at the next stage boundary, on the grown world). Every
    decision is an ``{"kind": "elastic_event"}`` record."""

    enabled: bool = False
    # Initial worker count; None -> mesh.num_processes or 1. All ranks run on
    # this host (one card each under CUDA).
    world: int | None = None
    min_world: int = 1               # never shrink below this many ranks
    max_world: int | None = None     # grow ceiling; None -> initial world
    max_restarts: int = 5            # failure-relaunch budget (grows are free)
    backoff_s: float = 2.0           # exponential between failure relaunches
    # After an uncoordinated exit, how long the other workers get to exit on
    # their own before the supervisor terminates them (then kills them).
    reap_timeout_s: float = 60.0
    # Heartbeat age past which a rank is reported stale.
    heartbeat_stale_s: float = 30.0
    # Relaunch (with resume) after a clean preemption exit 75.
    resume_preempted: bool = True


@dataclass
class TuningConfig:
    """Autotuner manifest consumption (``tuning.py``): ``manifest`` is the
    path of a sha256-digest-signed ``tuning_manifest.json`` (null = the
    default ``artifacts/tuning_manifest.json`` if present); ``apply`` is the
    stale-manifest policy: ``auto`` applies a matching manifest and skips a
    mismatched one with a logged reason, ``off`` never reads it, ``strict``
    turns every skip (missing file, geometry or hardware mismatch) into a
    startup error (exit 2). Explicit user config and already-set env gates
    always win over manifest knobs, in every mode."""

    manifest: str | None = None
    apply: str = "auto"


#: Keys the port does not have: accepted, ignored.
_IGNORED_SECTIONS: dict[str, Any] = {
    "parallel": {"overlap": {"enabled", "latency_hiding_scheduler",
                             "async_all_gather", "async_reduce_scatter",
                             "async_all_reduce", "async_collective_permute",
                             "extra_flags"}},
}


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    score: ScoreConfig = field(default_factory=ScoreConfig)
    prune: PruneConfig = field(default_factory=PruneConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    elastic: ElasticConfig = field(default_factory=ElasticConfig)
    tuning: TuningConfig = field(default_factory=TuningConfig)

    def validate(self) -> "Config":
        if self.tuning.apply not in ("auto", "off", "strict"):
            raise ValueError(
                f"tuning.apply must be auto | off | strict, got "
                f"{self.tuning.apply!r}")
        if self.data.dataset not in ("cifar10", "cifar100", "synthetic",
                                     "synthetic_imagenet", "npz", "sharded"):
            raise ValueError(f"unknown dataset {self.data.dataset!r}")
        if self.data.data_plane not in ("auto", "streaming", "resident"):
            raise ValueError(
                f"data.data_plane must be auto | streaming | resident, got "
                f"{self.data.data_plane!r}")
        if not 0.0 <= self.prune.sparsity < 1.0:
            raise ValueError(f"sparsity must be in [0, 1), got {self.prune.sparsity}")
        for s in self.prune.sweep:
            if not 0.0 < s < 1.0:
                raise ValueError(f"prune.sweep entries must be in (0, 1), got {s}")
        if self.score.method not in ("el2n", "margin", "grand", "grand_vmap",
                                     "grand_last_layer", "forgetting", "aum"):
            raise ValueError(f"unknown score method {self.score.method!r}")
        if (self.score.method in ("forgetting", "aum")
                and self.score.pretrain_epochs < 1):
            raise ValueError(f"score.method={self.score.method} tracks the "
                             "training trajectory; set score.pretrain_epochs >= 1")
        if (self.score.method in ("forgetting", "aum")
                and self.score.score_ckpt_step is not None):
            raise ValueError(
                f"score.method={self.score.method} scores a training TRAJECTORY "
                "and cannot start from score.score_ckpt_step; unset one of them")
        if self.data.crop_pad < 0:
            raise ValueError(f"data.crop_pad must be >= 0, got {self.data.crop_pad}")
        if self.data.synthetic_noise <= 0:
            raise ValueError(
                f"data.synthetic_noise must be > 0, got {self.data.synthetic_noise}")
        if self.data.synthetic_clusters < 1:
            raise ValueError(
                f"data.synthetic_clusters must be >= 1, got "
                f"{self.data.synthetic_clusters}")
        if self.optim.warmup_epochs < 0:
            raise ValueError(
                f"optim.warmup_epochs must be >= 0, got {self.optim.warmup_epochs}")
        t_max = self.optim.cosine_t_max_epochs or self.train.num_epochs
        if self.optim.warmup_epochs and self.optim.warmup_epochs >= t_max:
            raise ValueError(
                f"optim.warmup_epochs ({self.optim.warmup_epochs}) must be "
                f"less than the cosine horizon ({t_max} epochs); raise "
                "optim.cosine_t_max_epochs or lower the warmup")
        if self.model.stem not in ("cifar", "imagenet"):
            raise ValueError(f"unknown stem {self.model.stem!r}")
        if self.prune.keep not in ("hardest", "easiest", "random"):
            raise ValueError(f"unknown keep policy {self.prune.keep!r}")
        if (self.data.num_classes is not None
                and self.model.num_classes != self.data.num_classes):
            self.model.num_classes = self.data.num_classes
        if self.data.batch_size <= 0 or self.train.num_epochs < 0:
            raise ValueError("batch_size must be positive, num_epochs non-negative")
        if self.train.chunk_steps is not None and self.train.chunk_steps < 0:
            raise ValueError(
                f"train.chunk_steps must be >= 0 (0/1 = per-step, null = "
                f"auto), got {self.train.chunk_steps}")
        if self.score.batch_size <= 0:
            raise ValueError(f"score.batch_size must be positive, got "
                             f"{self.score.batch_size}")
        if self.score.chunk_steps is not None and self.score.chunk_steps < 0:
            raise ValueError(
                f"score.chunk_steps must be >= 0 (0/1 = per-batch, null = "
                f"auto), got {self.score.chunk_steps}")
        r = self.resilience
        if r.step_timeout_s is not None and r.step_timeout_s <= 0:
            raise ValueError(
                f"resilience.step_timeout_s must be > 0 (or null to disable "
                f"the watchdog), got {r.step_timeout_s}")
        if r.nan_retry_budget < 0:
            raise ValueError(
                f"resilience.nan_retry_budget must be >= 0, got {r.nan_retry_budget}")
        if not 0.0 < r.nan_lr_factor <= 1.0:
            raise ValueError(
                f"resilience.nan_lr_factor must be in (0, 1], got {r.nan_lr_factor}")
        if r.probe_attempts < 1 or r.probe_timeout_s <= 0 or r.probe_backoff_s < 0:
            raise ValueError(
                "resilience probe settings need probe_attempts >= 1, "
                "probe_timeout_s > 0, probe_backoff_s >= 0; got "
                f"{r.probe_attempts}/{r.probe_timeout_s}/{r.probe_backoff_s}")
        if r.consensus_poll_steps < 1:
            raise ValueError(
                f"resilience.consensus_poll_steps must be >= 1, got "
                f"{r.consensus_poll_steps}")
        if r.consensus_grace_s <= 0:
            raise ValueError(
                f"resilience.consensus_grace_s must be > 0, got "
                f"{r.consensus_grace_s}")
        m = self.mesh
        if m.model_axis < 1:
            raise ValueError(f"mesh.model_axis must be >= 1, got {m.model_axis}")
        # A fleet of meshes: the fleet sets each rank's coordinator and id.
        fleet = self.serve.replicas > 1 or self.serve.max_replicas is not None
        if m.multihost:
            if not m.num_processes or m.num_processes < 1:
                raise ValueError("mesh.multihost=true needs mesh.num_processes >= 1")
            if not fleet and (not m.coordinator_address or m.process_id is None):
                raise ValueError(
                    "mesh.multihost=true needs mesh.coordinator_address (host:port), "
                    "mesh.num_processes and mesh.process_id")
            if m.process_id is not None and not 0 <= m.process_id < m.num_processes:
                raise ValueError(
                    f"mesh.process_id={m.process_id} is not in [0, "
                    f"{m.num_processes})")
            if m.num_processes % m.model_axis:
                raise ValueError(
                    f"mesh.model_axis={m.model_axis} does not tile mesh.num_processes="
                    f"{m.num_processes} (one device per rank)")
            # Under elastic supervision a relaunch at another world keeps the
            # pin of the first: parallel.mesh.run_mesh recomputes it.
            if (m.data_axis is not None and m.data_axis * m.model_axis != m.num_processes
                    and not self.elastic.enabled):
                raise ValueError(
                    f"mesh.data_axis={m.data_axis} x mesh.model_axis={m.model_axis} "
                    f"must equal mesh.num_processes={m.num_processes} (one device "
                    "per rank)")
        self._validate_checkpoint_elastic()
        self._validate_obs_serve()
        return self

    def _validate_checkpoint_elastic(self) -> None:
        c = self.checkpoint
        if c.drain_timeout_s <= 0:
            raise ValueError(
                f"checkpoint.drain_timeout_s must be > 0, got {c.drain_timeout_s}")
        if c.promote_delay_s < 0:
            raise ValueError(
                f"checkpoint.promote_delay_s must be >= 0, got {c.promote_delay_s}")
        e = self.elastic
        if e.world is not None and e.world < 1:
            raise ValueError(f"elastic.world must be >= 1, got {e.world}")
        if e.min_world < 1:
            raise ValueError(f"elastic.min_world must be >= 1, got {e.min_world}")
        if e.max_world is not None and e.max_world < e.min_world:
            raise ValueError(
                f"elastic.max_world ({e.max_world}) must be >= "
                f"elastic.min_world ({e.min_world})")
        if e.world is not None and e.world < e.min_world:
            raise ValueError(
                f"elastic.world ({e.world}) must be >= elastic.min_world "
                f"({e.min_world}) — the supervisor never shrinks below the "
                "floor, so it cannot start there either")
        if e.world is not None and e.max_world is not None and e.world > e.max_world:
            raise ValueError(
                f"elastic.world ({e.world}) must be <= elastic.max_world "
                f"({e.max_world})")
        model = self.mesh.model_axis
        for name, value in (("world", e.world), ("max_world", e.max_world)):
            if value is not None and model > 1 and value % model:
                raise ValueError(
                    f"elastic.{name}={value} is not a multiple of mesh.model_axis="
                    f"{model}: every world of the run keeps whole model groups")
        if e.max_restarts < 0:
            raise ValueError(f"elastic.max_restarts must be >= 0, got {e.max_restarts}")
        if e.backoff_s < 0:
            raise ValueError(f"elastic.backoff_s must be >= 0, got {e.backoff_s}")
        if e.reap_timeout_s <= 0 or e.heartbeat_stale_s <= 0:
            raise ValueError(
                "elastic.reap_timeout_s and elastic.heartbeat_stale_s must "
                f"be > 0; got {e.reap_timeout_s}/{e.heartbeat_stale_s}")
        if self.obs.slo_recovery_s is not None and self.obs.slo_recovery_s <= 0:
            raise ValueError(
                f"obs.slo_recovery_s must be > 0, got {self.obs.slo_recovery_s}")

    def _validate_obs_serve(self) -> None:
        o = self.obs
        if o.snapshot_every_s < 0:
            raise ValueError(
                f"obs.snapshot_every_s must be >= 0 (0 disables periodic "
                f"snapshots), got {o.snapshot_every_s}")
        if o.heartbeat_interval_s < 0:
            raise ValueError(
                f"obs.heartbeat_interval_s must be >= 0, got {o.heartbeat_interval_s}")
        if o.flightrec_capacity < 1:
            raise ValueError(
                f"obs.flightrec_capacity must be >= 1, got {o.flightrec_capacity}")
        if o.profile_window_chunks < 1:
            raise ValueError(
                f"obs.profile_window_chunks must be >= 1, got {o.profile_window_chunks}")
        if o.hbm_jump_frac <= 0:
            raise ValueError(f"obs.hbm_jump_frac must be > 0, got {o.hbm_jump_frac}")
        if o.score_hist_bins < 1:
            raise ValueError(f"obs.score_hist_bins must be >= 1, got {o.score_hist_bins}")
        if o.server_port is not None and not 0 <= o.server_port <= 65535:
            raise ValueError(
                f"obs.server_port must be in [0, 65535] (0 = auto-pick, "
                f"null = off), got {o.server_port}")
        if o.slo_throughput_floor is not None and o.slo_throughput_floor <= 0:
            raise ValueError(
                f"obs.slo_throughput_floor must be > 0, got {o.slo_throughput_floor}")
        if o.slo_throughput_frac is not None and not 0.0 < o.slo_throughput_frac <= 1.0:
            raise ValueError(
                f"obs.slo_throughput_frac must be in (0, 1], got {o.slo_throughput_frac}")
        if o.slo_heartbeat_stale_s is not None and o.slo_heartbeat_stale_s <= 0:
            raise ValueError(
                f"obs.slo_heartbeat_stale_s must be > 0, got {o.slo_heartbeat_stale_s}")
        if o.slo_nonfinite_frac is not None and not 0.0 <= o.slo_nonfinite_frac < 1.0:
            raise ValueError(
                f"obs.slo_nonfinite_frac must be in [0, 1), got {o.slo_nonfinite_frac}")
        if (o.slo_eval_accuracy_floor is not None
                and not 0.0 <= o.slo_eval_accuracy_floor <= 1.0):
            raise ValueError(
                f"obs.slo_eval_accuracy_floor must be in [0, 1], got "
                f"{o.slo_eval_accuracy_floor}")
        if o.slo_serve_p95_ms is not None and o.slo_serve_p95_ms <= 0:
            raise ValueError(f"obs.slo_serve_p95_ms must be > 0, got {o.slo_serve_p95_ms}")
        if o.slo_serve_queue_depth is not None and o.slo_serve_queue_depth < 1:
            raise ValueError(
                f"obs.slo_serve_queue_depth must be >= 1, got {o.slo_serve_queue_depth}")
        if (o.slo_serve_reject_frac is not None
                and not 0.0 <= o.slo_serve_reject_frac < 1.0):
            raise ValueError(
                f"obs.slo_serve_reject_frac must be in [0, 1), got "
                f"{o.slo_serve_reject_frac}")
        if o.slo_fleet_p95_ms is not None and o.slo_fleet_p95_ms <= 0:
            raise ValueError(f"obs.slo_fleet_p95_ms must be > 0, got {o.slo_fleet_p95_ms}")
        if (o.slo_fleet_available_frac is not None
                and not 0.0 < o.slo_fleet_available_frac <= 1.0):
            raise ValueError(
                f"obs.slo_fleet_available_frac must be in (0, 1], got "
                f"{o.slo_fleet_available_frac}")
        sv = self.serve
        if not 0 <= sv.port <= 65535:
            raise ValueError(
                f"serve.port must be in [0, 65535] (0 = auto-pick), got {sv.port}")
        for m in sv.methods:
            if m not in SERVABLE_METHODS:
                raise ValueError(
                    f"serve.methods entries must be checkpoint-based score "
                    f"methods (trajectory methods cannot serve a warm "
                    f"checkpoint), got {m!r}")
        if sv.batch_size is not None and sv.batch_size < 1:
            raise ValueError(
                f"serve.batch_size must be >= 1 (or null for score.batch_size), "
                f"got {sv.batch_size}")
        if sv.max_queue < 1:
            raise ValueError(f"serve.max_queue must be >= 1, got {sv.max_queue}")
        if sv.coalesce_ms < 0:
            raise ValueError(f"serve.coalesce_ms must be >= 0, got {sv.coalesce_ms}")
        if (sv.retry_after_s <= 0 or sv.request_timeout_s <= 0
                or sv.drain_timeout_s <= 0 or sv.stats_every_s <= 0):
            raise ValueError(
                "serve timings need retry_after_s/request_timeout_s/"
                "drain_timeout_s/stats_every_s > 0; got "
                f"{sv.retry_after_s}/{sv.request_timeout_s}/"
                f"{sv.drain_timeout_s}/{sv.stats_every_s}")
        if sv.replicas < 1:
            raise ValueError(f"serve.replicas must be >= 1, got {sv.replicas}")
        if not 0 <= sv.router_port <= 65535:
            raise ValueError(
                f"serve.router_port must be in [0, 65535] (0 = auto-pick), "
                f"got {sv.router_port}")
        if sv.dispatch_stall_s is not None and sv.dispatch_stall_s <= 0:
            raise ValueError(
                f"serve.dispatch_stall_s must be > 0 (or null for no "
                f"watchdog), got {sv.dispatch_stall_s}")
        if sv.refresh_poll_s is not None and sv.refresh_poll_s <= 0:
            raise ValueError(
                f"serve.refresh_poll_s must be > 0 (or null for manual "
                f"refresh only), got {sv.refresh_poll_s}")
        if sv.route_retries < 0:
            raise ValueError(f"serve.route_retries must be >= 0, got {sv.route_retries}")
        if sv.breaker_failures < 1:
            raise ValueError(
                f"serve.breaker_failures must be >= 1, got {sv.breaker_failures}")
        if sv.breaker_reset_s <= 0:
            raise ValueError(f"serve.breaker_reset_s must be > 0, got {sv.breaker_reset_s}")
        if sv.hedge_ms is not None and sv.hedge_ms <= 0:
            raise ValueError(
                f"serve.hedge_ms must be > 0 (or null for no hedging), got {sv.hedge_ms}")
        if sv.health_poll_s <= 0:
            raise ValueError(f"serve.health_poll_s must be > 0, got {sv.health_poll_s}")
        if sv.idempotency_cache < 1:
            raise ValueError(
                f"serve.idempotency_cache must be >= 1, got {sv.idempotency_cache}")
        if sv.hosts and sv.remote_launch is None:
            raise ValueError(
                "serve.hosts names remote placements but serve.remote_launch "
                "is null — every listed host is spawned through the launch "
                "template")
        if sv.remote_launch is not None and "{host}" not in sv.remote_launch:
            raise ValueError(
                f"serve.remote_launch must contain a {{host}} placeholder, "
                f"got {sv.remote_launch!r}")
        if sv.min_replicas is not None and sv.max_replicas is None:
            raise ValueError(
                "serve.min_replicas without serve.max_replicas — the "
                "autoscaler is enabled by setting max_replicas")
        if sv.max_replicas is not None:
            min_eff = sv.min_replicas if sv.min_replicas is not None else sv.replicas
            if not 1 <= min_eff <= sv.replicas <= sv.max_replicas:
                raise ValueError(
                    f"autoscaler bounds need 1 <= min_replicas ({min_eff}) <= "
                    f"replicas ({sv.replicas}) <= max_replicas ({sv.max_replicas})")
        if sv.scale_up_after < 1 or sv.scale_down_after < 1:
            raise ValueError(
                f"serve.scale_up_after/scale_down_after must be >= 1 "
                f"(hysteresis windows in stats ticks), got "
                f"{sv.scale_up_after}/{sv.scale_down_after}")
        if sv.scale_cooldown_s < 0:
            raise ValueError(
                f"serve.scale_cooldown_s must be >= 0, got {sv.scale_cooldown_s}")
        if sv.partition_after_misses < 1:
            raise ValueError(
                f"serve.partition_after_misses must be >= 1, got "
                f"{sv.partition_after_misses}")
        if not 0 < sv.probe_backoff_s <= sv.probe_backoff_max_s:
            raise ValueError(
                f"probation backoff needs 0 < probe_backoff_s <= "
                f"probe_backoff_max_s, got {sv.probe_backoff_s}/"
                f"{sv.probe_backoff_max_s}")
        if sv.canary_requests is not None and sv.canary_requests < 1:
            raise ValueError(
                f"serve.canary_requests must be >= 1 (or null for no canary "
                f"hold), got {sv.canary_requests}")
        if sv.canary_timeout_s <= 0:
            raise ValueError(f"serve.canary_timeout_s must be > 0, got {sv.canary_timeout_s}")
        if not 0.0 <= sv.trace_sample_frac <= 1.0:
            raise ValueError(
                f"serve.trace_sample_frac must be in [0, 1], got {sv.trace_sample_frac}")
        if sv.trace_slow_ms is not None and sv.trace_slow_ms <= 0:
            raise ValueError(
                f"serve.trace_slow_ms must be > 0 (or null to follow "
                f"obs.slo_serve_p95_ms), got {sv.trace_slow_ms}")


_SECTIONS = {"data": DataConfig, "model": ModelConfig, "optim": OptimConfig,
             "score": ScoreConfig,
             "prune": PruneConfig, "train": TrainConfig,
             "resilience": ResilienceConfig, "mesh": MeshConfig,
             "obs": ObsConfig, "serve": ServeConfig,
             "checkpoint": CheckpointConfig, "elastic": ElasticConfig,
             "tuning": TuningConfig}


def _check_ignored(keys: Any, value: Any, where: str) -> None:
    """Raise KeyError for a key the unported section does not have. ``keys`` is
    a set of leaf names or a dict of nested sections."""
    if not isinstance(value, dict):
        raise KeyError(f"config key {where!r} is a section")
    for k, v in value.items():
        if k not in keys:
            raise KeyError(f"unknown config key {where}.{k}")
        if isinstance(keys, dict):
            _check_ignored(keys[k], v, f"{where}.{k}")


def _section_from_dict(cls, d: dict[str, Any], where: str):
    valid = {f.name: f for f in fields(cls)}
    ignored = _IGNORED_SECTIONS.get(where, set())
    kwargs = {}
    for key, value in d.items():
        if key in ignored:
            continue
        if key not in valid:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        if isinstance(value, list) and isinstance(valid[key].default, tuple):
            value = tuple(value)
        kwargs[key] = value
    return cls(**kwargs)


def _from_dict(raw: dict[str, Any]) -> Config:
    cfg = Config()
    for section, value in raw.items():
        if section in _SECTIONS:
            setattr(cfg, section,
                    _section_from_dict(_SECTIONS[section], value or {}, section))
        elif section in _IGNORED_SECTIONS:
            _check_ignored(_IGNORED_SECTIONS[section], value or {}, section)
        else:
            raise KeyError(f"unknown config key {section!r} for Config")
    return cfg


def _ignored_leaf(parts: list[str]) -> bool:
    """Whether a dotted key names a known key of an unported section."""
    node: Any = _IGNORED_SECTIONS
    for i, part in enumerate(parts):
        if part not in node:
            return False
        if isinstance(node, set):
            return i == len(parts) - 1
        node = node[part]
    return False   # names a section, not a key


def load_config(path: str | None = None, overrides: list[str] | None = None) -> Config:
    """Build a Config from an optional YAML file plus ``dotted.key=value``
    overrides (values YAML-parsed: ``score.seeds=[0,1]``, ``train.half_precision=false``)."""
    cfg = Config()
    if path is not None:
        with open(path) as fh:
            raw = yaml.safe_load(fh) or {}
        cfg = _from_dict(raw)
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        dotted, _, raw_value = item.partition("=")
        value = yaml.safe_load(raw_value)
        *parents, leaf = dotted.split(".")
        if parents and parents[0] in _IGNORED_SECTIONS:
            if _ignored_leaf(dotted.split(".")):
                continue
            if parents[0] not in _SECTIONS:
                raise KeyError(f"unknown config key {dotted!r}")
        node: Any = cfg
        for part in parents:
            if not hasattr(node, part):
                raise KeyError(f"unknown config key {dotted!r}")
            node = getattr(node, part)
        if not hasattr(node, leaf) or not parents:
            raise KeyError(f"unknown config key {dotted!r}")
        if isinstance(value, list) and isinstance(getattr(node, leaf), tuple):
            value = tuple(value)
        setattr(node, leaf, value)
    return cfg.validate()
