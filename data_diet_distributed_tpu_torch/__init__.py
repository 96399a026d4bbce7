"""PyTorch/CUDA port of ``data_diet_distributed_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports nothing of it (nor
JAX), keeping its own copy of what it needs. Public functions take NHWC
tensors; models run channels_last inside. Entry points (``cli``,
``ServeEngine``, ``score_dataset``, ``fit``, ``run_datadiet``,
``init_variables``) default to CUDA and raise without it unless the caller
passes ``device="cpu"``.

Port map (this package -> its JAX counterpart, ``data_diet_distributed_tpu/...``):

* ``device.py`` -> (new) device resolution, TF32 parity mode, cuDNN determinism
* ``config.py`` -> ``config.py`` (data/model/optim/score/prune/train; other
  sections accepted and ignored)
* ``data/datasets.py`` -> ``data/datasets.py`` (synthetic, synthetic_imagenet,
  CIFAR pickles, npz, the memory-mapped ``.npy`` splits, lazy normalization)
* ``data/native.py`` -> ``data/native.py`` (``native/datadiet_native.cpp``
  built with ``g++`` into ``data/_build/``; ``BatchAssembler`` and a NumPy
  version of its arithmetic)
* ``data/sharded.py`` -> ``data/sharded.py`` (the ``ddt-shards-v1`` format, the
  LRU ``ShardCache``, the digest-verified retrying read with quarantine)
* ``data/pipeline.py`` -> ``data/pipeline.py`` (``epoch_permutation``,
  ``iterate_batches``, ``ResidentBatches``, ``maybe_resident``,
  ``PrefetchIterator``, ``prefetch_stream`` from pinned buffers on a copy
  stream, ``EvalBatchCache``, the ``data_plane`` record)
* ``data/augment.py`` -> ``data/augment.py`` (flip and crop, draws split from
  the pixel moves)
* ``models/`` -> ``models/resnet.py``, ``models/wideresnet.py``,
  ``models/tiny.py``, ``models/__init__.py`` (BatchNorm in train mode with
  Flax's semantics; ``model.remat`` as ``torch.utils.checkpoint`` around each
  ResNet and WideResNet block in training)
* ``weights.py`` -> (new) Flax weight port, seeded init (``resnet.py:29-32,57``)
* ``ops/kernels.py`` + ``ops/csrc/*.cu`` + ``ops/build.py`` ->
  ``ops/pallas_kernels.py``, every Pallas kernel: ``conv_grad_norm_direct`` (v1
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
  planes, ``ScoreResident``, ``ScoreStream``)
* ``pruning.py`` -> ``pruning.py`` (``select_indices``, the prune-provenance
  manifest)
* ``train/state.py`` -> ``train/state.py`` (``TrainState``, the LR schedule,
  the SGD chain)
* ``train/steps.py`` -> ``train/steps.py`` (``train_step``, ``eval_step``; the
  per-step path)
* ``train/loop.py`` -> ``train/loop.py`` (``fit`` with the resilience hooks,
  ``fit_with_recovery``, ``evaluate``, ``score_variables_for_seeds``,
  ``compute_scores`` with per-seed partials, ``trajectory_scores`` (forgetting,
  AUM) through ``fit``'s ``epoch_hook``, ``run_datadiet`` and
  ``run_sweep`` with the stage manifest, the fingerprints)
* ``checkpoint.py`` -> ``checkpoint.py`` (the single-tier ``CheckpointManager``,
  in the port's own format; ``restore_verified`` falls back past corrupt
  steps)
* ``resilience/`` -> ``resilience/`` (single process: ``preemption.py``,
  ``sentinel.py``, ``watchdog.py`` with ``probe_devices`` through torch,
  ``integrity.py`` for the port's manifest, ``stages.py``, and ``inject.py``
  with the training and storage fault classes)
* ``utils/io.py`` -> ``utils/io.py`` (atomic writes, ``load_scores_npz``)
* ``serve/engine.py`` -> ``serve/engine.py`` (``ServeEngine`` scoring units)
* ``cli.py`` -> ``cli.py`` (``train``, ``run``, ``sweep``, ``score``; exit 75
  on preemption, ``DDT_FAULT_PLAN`` drills)

Not ported yet: multi-host consensus, elastic supervision, the checkpoint
tiers and the rank, host and serve fault classes of ``resilience/``, the
chunked training engine and its ``StreamingBatches``, multi-device training and
scoring (the per-rank image slices of ``iterate_batches``), the serving
batcher/server/router/fleet (``cli serve``), observability (the flight
recorder: shard-fault records go to the caller's ``log``) and the tools
(``tools/make_shards.py``, ``tools/npz_to_npy.py``; their formats are the
port's too).
"""
