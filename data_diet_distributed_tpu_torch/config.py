"""Typed configuration: the part of ``data_diet_distributed_tpu/config.py`` the
port reads.

``DataConfig``, ``ModelConfig``, ``OptimConfig``, ``ScoreConfig``,
``PruneConfig``, ``TrainConfig``, ``ResilienceConfig`` and ``MeshConfig`` are
copied whole, with the JAX package's validations. ``train.chunk_steps`` is accepted and
ignored (the JAX package's dispatch-amortising engine, whose results are by
contract those of the per-step path, which is the one the port runs). Of
``resilience``, the port honours ``step_timeout_s``, ``preemption``,
``verify_restore``, ``nan_check``, ``nan_retry_budget``, ``nan_lr_factor``,
``stage_resume``, the ``init_probe`` settings and, across processes, the
consensus keys (``consensus``, ``consensus_poll_steps``,
``consensus_grace_s``, ``sidechannel_dir``). Of ``mesh`` every key takes
effect (``parallel/mesh.py``) but ``model_axis``, which must be 1 (the
tensor-parallel classifier is not ported). The sections the port does not
have (parallel, checkpoint, obs, elastic, serve, tuning) are accepted key by
key and ignored, so every
``configs/*.yaml`` loads unchanged, while an unknown key anywhere still raises
``KeyError`` as in JAX.
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
    chunk_steps: int | None = None           # accepted, ignored (per-step path)
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
    compute what the JAX package computes on a mesh ``{data: W, model: 1}``."""

    data_axis: int | None = None     # None -> the process count; else must equal it
    model_axis: int = 1              # the tensor-parallel classifier: not ported
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


#: Keys of the sections the port does not have: accepted, ignored.
_IGNORED_SECTIONS: dict[str, Any] = {
    "parallel": {"overlap": {"enabled", "latency_hiding_scheduler",
                             "async_all_gather", "async_reduce_scatter",
                             "async_all_reduce", "async_collective_permute",
                             "extra_flags"}},
    "checkpoint": {"local_tier", "local_dir", "promote", "drain_timeout_s",
                   "promote_delay_s"},
    "obs": {"metrics_path", "monitor", "monitor_path", "profile_dir", "plots_dir",
            "trace", "trace_path", "snapshot_every_s", "prom_path", "heartbeat",
            "heartbeat_dir", "heartbeat_interval_s", "flightrec",
            "flightrec_capacity", "flightrec_dir", "xla_introspect",
            "hbm_jump_frac", "profile_window_chunks", "score_telemetry",
            "score_hist_bins", "perf_ledger", "server_port", "server_host",
            "fleet", "slo_throughput_floor", "slo_throughput_frac",
            "slo_heartbeat_stale_s", "slo_nonfinite_frac",
            "slo_eval_accuracy_floor", "slo_serve_p95_ms", "slo_serve_queue_depth",
            "slo_serve_reject_frac", "slo_fleet_p95_ms",
            "slo_fleet_available_frac", "slo_recovery_s"},
    "elastic": {"enabled", "world", "min_world", "max_world", "max_restarts",
                "backoff_s", "reap_timeout_s", "heartbeat_stale_s",
                "resume_preempted"},
    "serve": {"port", "host", "tenant", "methods", "batch_size", "max_queue",
              "retry_after_s", "coalesce_ms", "request_timeout_s",
              "drain_timeout_s", "stats_every_s", "warm", "request_log",
              "replicas", "router_port", "dispatch_stall_s", "refresh_poll_s",
              "refresh_from", "route_retries", "breaker_failures",
              "breaker_reset_s", "hedge_ms", "health_poll_s", "idempotency_cache",
              "hosts", "remote_launch", "min_replicas", "max_replicas",
              "scale_up_after", "scale_down_after", "scale_cooldown_s",
              "partition_after_misses", "probe_backoff_s", "probe_backoff_max_s",
              "canary_requests", "canary_timeout_s", "trace_sample_frac",
              "trace_slow_ms"},
    "tuning": {"manifest", "apply"},
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

    def validate(self) -> "Config":
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
        if m.model_axis != 1:
            raise ValueError(
                f"mesh.model_axis={m.model_axis}: the tensor-parallel classifier is "
                "not ported to the PyTorch package (ROADMAP.md Queue 1 item 2); "
                "use model_axis=1")
        if m.multihost:
            if not m.coordinator_address or not m.num_processes or m.process_id is None:
                raise ValueError(
                    "mesh.multihost=true needs mesh.coordinator_address (host:port), "
                    "mesh.num_processes and mesh.process_id")
            if not 0 <= m.process_id < m.num_processes:
                raise ValueError(
                    f"mesh.process_id={m.process_id} is not in [0, "
                    f"{m.num_processes})")
            if m.data_axis is not None and m.data_axis != m.num_processes:
                raise ValueError(
                    f"mesh.data_axis={m.data_axis} must equal mesh.num_processes="
                    f"{m.num_processes} (one device per rank)")
        return self


_SECTIONS = {"data": DataConfig, "model": ModelConfig, "optim": OptimConfig,
             "score": ScoreConfig,
             "prune": PruneConfig, "train": TrainConfig,
             "resilience": ResilienceConfig, "mesh": MeshConfig}


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
    kwargs = {}
    for key, value in d.items():
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
            if not _ignored_leaf(dotted.split(".")):
                raise KeyError(f"unknown config key {dotted!r}")
            continue
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
