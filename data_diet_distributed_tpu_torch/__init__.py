"""PyTorch/CUDA port of ``data_diet_distributed_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports nothing of it (nor
JAX), keeping its own copy of what it needs. Public functions take NHWC
tensors; models run channels_last inside. Entry points (``cli``,
``ServeEngine``, ``score_dataset``, ``fit``, ``run_datadiet``,
``init_variables``) default to CUDA and raise without it unless the caller
passes ``device="cpu"``.

Port map (this package -> its JAX counterpart, ``data_diet_distributed_tpu/...``):

* ``device.py`` -> (new) device resolution, TF32 parity mode, cuDNN determinism
* ``graphs.py`` -> the device half of ``jax.jit`` over the chunked engine's
  unrolled scans (``train/steps.py:159-230``, ``ops/scores.py:343-400``):
  ``ChunkProgram`` (K steps in fixed storage, one staged upload, a CUDA graph
  captured once per chunk length and geometry and replayed; the bodies
  eagerly on the CPU) and ``GraphCache``
* ``config.py`` -> ``config.py`` (data/model/optim/score/prune/train/
  resilience/mesh/obs/serve/checkpoint/elastic/tuning, every key in
  effect; the parallel section's keys accepted and ignored, see below)
* ``tuning.py`` -> ``tuning.py`` (the signed tuning manifest: build, write,
  read and verify, match on geometry and hardware (backend ``cuda``/``cpu``,
  ``device_kind`` the card's name), apply with user precedence;
  ``maybe_apply_manifest``, the CLI's startup hook)
* ``parallel/mesh.py`` + ``parallel/collectives.py`` -> ``parallel/mesh.py``
  (``initialize_multihost`` over ``torch.distributed``: NCCL for CUDA, gloo
  for the CPU, a gloo host group beside NCCL, and at ``mesh.model_axis > 1``
  the data and model groups; rank and world, ``is_primary``, ``sync_hosts``,
  the ``{data, model}`` layout (``batch_slice`` and ``flat_slice`` for JAX's
  two sharders), the geometry check, ``run_mesh``/``remap_mesh`` (a stale
  ``data_axis`` recomputed under elastic, the model axis kept),
  ``param_layout`` (``_param_spec_for``: the head split by rows),
  ``_zero1_spec``, ``UpdateSharding``, ``resolve_update_sharding``; the
  all-reduces, reduce-scatter, all-gather and float64 score sum XLA inserts
  in the JAX package, and the head's ``copy_to_model`` and
  ``gather_from_model``)
* ``data/datasets.py`` -> ``data/datasets.py`` (synthetic, synthetic_imagenet,
  CIFAR pickles, npz, the memory-mapped ``.npy`` splits, lazy normalization)
* ``data/native.py`` -> ``data/native.py`` (``native/datadiet_native.cpp``
  built with ``g++`` into ``data/_build/``; ``BatchAssembler`` and a NumPy
  version of its arithmetic)
* ``data/sharded.py`` -> ``data/sharded.py`` (the ``ddt-shards-v1`` format, the
  LRU ``ShardCache``, the digest-verified retrying read with quarantine)
* ``data/pipeline.py`` -> ``data/pipeline.py`` (``epoch_permutation``,
  ``iterate_batches``, ``ResidentBatches`` with ``chunk_indices``,
  ``gather_resident_batch``, ``maybe_resident``, ``PrefetchIterator``,
  ``prefetch_stream`` from pinned buffers on a copy stream, ``ChunkBlock``
  and ``StreamingBatches`` (the chunked stream), ``EvalBatchCache``, the
  ``data_plane`` record)
* ``data/augment.py`` -> ``data/augment.py`` (flip and crop, draws split from
  the pixel moves; across ranks the global batch's draws, each rank's rows)
* ``models/`` -> ``models/resnet.py``, ``models/wideresnet.py``,
  ``models/tiny.py``, ``models/__init__.py`` (BatchNorm in train mode with
  Flax's semantics; ``model.remat`` as ``torch.utils.checkpoint`` around each
  ResNet and WideResNet block in training; across ranks the training
  step's BatchNorm statistics are the global batch's, over the data group;
  the classifier is a ``Head`` that runs split over the model group when it
  holds only its rank's rows)
* ``weights.py`` -> (new) Flax weight port, seeded init (``resnet.py:29-32,57``)
* ``ops/kernels.py`` + ``ops/csrc/*.cu`` + ``ops/build.py`` ->
  ``ops/pallas_kernels.py`` (and ``kernel_work``, each kernel's FLOPs and
  bytes, which the MFU harvest and the on-card bounds share), every Pallas
  kernel: ``conv_grad_norm_direct`` (v1
  ``:327`` and v2 ``:683``), ``conv_grad_norm_gram`` (``:797``), ``el2n``
  (``:100``), ``grand_last_layer`` (``:933``), ``bn_grad_norm`` (``:883``),
  ``conv_grad_norm_catdot`` (``:156``) and ``conv_bwd_grad_norm`` (the
  megakernel, ``:488``)
* ``ops/scores.py`` -> ``ops/scores.py`` (local scores in eval and train mode,
  ``grand_vmap``, method resolution)
* ``ops/forgetting.py`` -> ``ops/forgetting.py`` (``ForgettingTracker``,
  ``AUMTracker``)
* ``ops/grand_batched.py`` -> ``ops/grand_batched.py`` (``batched_grand_scores``
  with same-geometry grouping and the stacked-BN and cat-dot routes,
  ``batched_grand_scores_fused`` with the megakernel route, the ``DDT_GRAND_*``
  toggles under the JAX names)
* ``ops/scoring.py`` -> ``ops/scoring.py`` (``score_dataset`` with the data
  planes, ``ScoreResident``, ``ScoreStream`` and their ``blocks``; the
  chunked score engine: ``resolve_score_chunk_steps``,
  ``score_resident_pass``, ``_dispatch_score_chunk``; the ``score_batch`` and
  ``score_chunk`` programs, ``score_fetch_s``, the scoreboard's seed notes,
  the scoring profile window)
* ``pruning.py`` -> ``pruning.py`` (``select_indices``, the prune-provenance
  manifest)
* ``train/state.py`` -> ``train/state.py`` (``TrainState``, the LR schedule,
  the SGD chain; across ranks the gradient sum over the data group, ZeRO-1
  and the sharded weight update, the global clip norm over both groups;
  ``shard_slots``/``gather_slots``/``gather_head``, ``place_state``'s
  tensor-parallel layout and its inverse)
* ``train/steps.py`` -> ``train/steps.py`` (``train_step``, ``eval_step``; the
  per-step path; across ranks the global-count loss and global metrics;
  ``dispatch_train_step``/``dispatch_eval_step``: the dispatch counters and
  the ``train_step`` harvest, as JAX's ``_counted``; ``make_train_chunk`` and
  ``make_eval_chunk`` over the same step math, ``dispatch_train_chunk`` and
  ``dispatch_eval_chunk``: the chunked engine's programs ``train_chunk`` and
  ``eval_chunk``)
* ``train/loop.py`` -> ``train/loop.py`` (``fit`` with the resilience hooks
  and the chunked engine (``DEFAULT_CHUNK_STEPS``, ``MAX_CHUNK_STEPS``,
  ``resolve_chunk_steps``, ``_dispatch_chunk``/``_dispatch_stream_chunk``,
  ``_flatten_step_metrics``, the ``train_chunked`` record,
  ``FitResult.chunk_steps``), ``fit_with_recovery``, ``evaluate`` (chunked
  over a resident set), ``score_variables_for_seeds``,
  ``compute_scores`` with per-seed partials, ``trajectory_scores`` (forgetting,
  AUM) through ``fit``'s ``epoch_hook``, ``run_datadiet`` and
  ``run_sweep`` with the stage manifest, the fingerprints; the observability
  hooks: spans, registry timers, heartbeats, profile windows, memory polls,
  MFU, SLO checks, ``fleet_status``, ``comm_stats``, flight-recorder dumps;
  the elastic hooks: tier saves, the drain and ``await_step`` on preemption,
  ``resume`` with ``world``/``saved_world``, the recovery SLO's clock,
  ``stage_barrier`` at the score -> retrain boundary and between levels)
* ``checkpoint.py`` -> ``checkpoint.py`` (``CheckpointManager`` in the port's
  own format; ``restore_verified`` falls back past corrupt steps; across
  ranks rank 0 writes, then a barrier; ``verified_steps``;
  ``checkpoint_save``/``checkpoint_restore`` spans and walls; the local tier:
  ``LocalTier`` (each rank its own part, ZeRO-1 slices with their index,
  background promotion with digest checks, retention, a bounded ``drain``),
  ``tier_steps``, ``restore_tier_payload`` (the whole state at any world),
  ``tier_map``, ``await_step``, ``drain_info``, ``saved_world``)
* ``resilience/`` -> ``resilience/`` (``preemption.py``, ``sentinel.py``
  with the agreed verdict, ``watchdog.py`` with ``probe_devices`` through
  torch and the consensus hooks, ``integrity.py`` for the port's manifest,
  ``stages.py`` with the broadcast manifest and the agreed partials,
  ``consensus.py`` (``agree_any``, ``agree_common``, ``broadcast_json``,
  ``SideChannel``, ``Consensus``), ``elastic.py`` (``ElasticSupervisor``,
  the join and resize requests, ``stage_barrier``, ``survivors``,
  ``classify_rc``, ``RestartBudget``, ``JsonlLogger``), and ``inject.py``
  with every fault class, ``rank`` targeting included)
* ``utils/io.py`` -> ``utils/io.py`` (atomic writes, ``load_scores_npz``,
  ``atomic_append_jsonl``)
* ``utils/stats.py`` -> ``utils/stats.py`` (Spearman rho with ties)
* ``utils/trees.py`` -> ``utils/trees.py`` (``param_count``, ``tree_bytes``
  over a state dict or any nesting of tensors and arrays)
* ``tools/`` -> ``tools/make_shards.py``, ``npz_to_npy.py``,
  ``score_report.py``, ``trace_report.py``, ``request_report.py``,
  ``run_monitor.py``, and the tuning tools ``autotune.py``,
  ``bisect_grand.py``, ``profile_dispatch.py``, ``perf_sentry.py``,
  ``validate_duty.py``, the drivers ``e2e_demo.py``,
  ``imagenet_soak.py`` and ``serve_soak.py``, and the stdlib
  ``validate_metrics.py`` and ``serve_client.py`` (the same arguments and
  output on the port's modules, for a host without JAX: ``python -m
  data_diet_distributed_tpu_torch.tools.<name>``; the tuning tools and the
  drivers run on ``--device cuda`` unless told ``--device cpu``)
* ``examples/walkthrough.py`` -> the repo's ``examples/walkthrough.py`` (the
  same notebook cells on the port: ``python -m
  data_diet_distributed_tpu_torch.examples.walkthrough``, ``--device cuda``
  unless ``--device cpu``)
* ``serve/`` -> ``serve/engine.py``, ``batcher.py``, ``server.py``
  (``ServeEngine`` with ``fit``/``evaluate``/``score``, tenants and weights,
  the verified checkpoint refresh and the program cache; the coalescing
  ``ScoreBatcher`` with 429 backpressure and weighted round-robin;
  ``ServeServer``/``ServeService`` with ``/v1/score``, ``/v1/rank``, streamed
  ``/v1/topk``, ``/v1/refresh``, the SIGTERM drain and the refresh watcher;
  ``run_serve``), ``router.py`` (``ServeRouter``: ``CircuitBreaker``,
  failover of idempotent requests, the replay cache, hedging, 503 +
  Retry-After, the refresh roll with the canary hold and rollback) and
  ``fleet.py`` (``ServeFleet``: local and templated remote replicas,
  respawn under ``RestartBudget``, probation, the ``Autoscaler``, the
  refresh and tuning-manifest rolls, ``discover_steps`` over the port's
  checkpoint layouts; with ``mesh.multihost`` each replica a
  ``ReplicaGroup`` of W ranks, respawned whole when any rank dies; replicas
  placed on cards through ``CUDA_VISIBLE_DEVICES``)
* ``obs/`` -> ``obs/``: ``lineage.py``, ``flightrec.py``, ``metrics.py``
  (``MetricsLogger`` with the ring mirror and the lineage stamp,
  ``emit_run_summary``), ``registry.py`` (snapshots, Prometheus textfile,
  stage seconds), ``tracing.py``, ``profiler.py`` (``ProfileWindow`` over
  ``torch.profiler``, ``StepTimer``), ``introspect.py`` -> ``xla.py``
  (``FlopCounterMode`` plus the kernels' analytic work on a program's first
  real call, MFU against the peak table or a calibration,
  ``HbmMonitor`` over ``torch.cuda.memory_stats``), ``monitor.py`` (host
  CPU, device memory, the latency-probe duty cycle), ``scoreboard.py``,
  ``comm.py``, ``slo.py`` (training, serve, fleet and recovery objectives,
  ``judge_canary``, ``ledger_baseline`` by ``cuda``/``cpu`` backend),
  ``fleet.py``,
  ``heartbeat.py`` (with lineage, ``describe_stale``, the residue files),
  ``reqtrace.py``, ``server.py`` (/healthz, /metrics, /status with MFU,
  watermark, ETA and lineage, the live /flightrec), ``session.py`` (every
  instrument), ``timeline.py`` (the cross-attempt timeline, recovery chains,
  lineage view, merged Perfetto trace), ``plots.py`` (the post-run PNGs of
  ``obs.plots_dir``); ``postmortem.py`` ->
  ``tools/postmortem.py``
  (``python -m data_diet_distributed_tpu_torch.obs.postmortem``)
* ``cli.py`` -> ``cli.py`` (``train``, ``run``, ``sweep``, ``score``,
  ``serve``, each under ``ObsSession`` and a ``run`` span, its records in
  ``obs.metrics_path`` and on stderr ending in ``metrics`` and
  ``run_summary``, ``obs.monitor`` and the ``perf_history`` ledger line;
  exit 75 on preemption or a serve drain, ``DDT_FAULT_PLAN`` drills;
  ``mesh.multihost`` joins the group first, rank 0 prints and writes, a
  failure under the group exits 69 or 1 at once; ``elastic.enabled``: the
  restart supervisor, which touches no CUDA; ``serve.replicas > 1``: the
  serving fleet's supervisor (of plain replicas or, with ``mesh.multihost``,
  of meshes), which touches no CUDA either; the tuning manifest applied
  before the gated ops modules import; ``obs.plots_dir``'s PNGs after a
  command on rank 0)

Across W processes (``mesh.multihost``), one device each, every entry point
computes what the JAX package computes on a ``{data: W / M, model: M}`` mesh
(``mesh.model_axis`` = M, default 1): rank rows in both data planes,
BatchNorm on the global batch, the global-count loss with summed gradients,
at M > 1 the classifier head split by rows over each model group (training,
eval and the trajectory scores), per-rank scoring over all W ranks joined
by one float64 sum per seed, primary-only writes with the head gathered
whole, and the consensus drills; ``cli serve`` answers on rank 0 while
every rank scores its rows of each request (``serve/engine.py``'s
operations over the host group).

Not ported: ``parallel/overlap.py`` alone. It sets XLA's latency-hiding
scheduler flags for the TPU so that XLA overlaps collectives with compute;
PyTorch has no such scheduler to configure (NCCL runs on its own stream and
the port's collectives are explicit calls), so the module has no meaning
here, and ``parallel.overlap`` is accepted and ignored.
"""
