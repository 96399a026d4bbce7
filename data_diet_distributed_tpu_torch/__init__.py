"""PyTorch/CUDA port of ``data_diet_distributed_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports nothing of it (nor
JAX), keeping its own copy of what it needs. Public functions take NHWC
tensors; models run channels_last inside. Entry points (``cli``,
``ServeEngine``, ``score_dataset``, ``init_variables``) default to CUDA and
raise without it unless the caller passes ``device="cpu"``.

Port map (this package -> its JAX counterpart, ``data_diet_distributed_tpu/...``):

* ``device.py`` -> (new) device resolution, TF32 parity mode, cuDNN determinism
* ``config.py`` -> ``config.py`` (data/model/score/prune; train keys; other
  sections accepted and ignored)
* ``data/datasets.py`` -> ``data/datasets.py`` (synthetic, CIFAR pickles)
* ``data/pipeline.py`` -> ``data/pipeline.py`` (``iterate_batches``, ``num_batches``)
* ``models/`` -> ``models/resnet.py``, ``models/tiny.py``, ``models/__init__.py``
* ``weights.py`` -> (new) Flax weight port, seeded init (``resnet.py:29-32,57``)
* ``ops/kernels.py`` + ``ops/csrc/*.cu`` + ``ops/build.py`` ->
  ``ops/pallas_kernels.py``, every Pallas kernel: ``conv_grad_norm_direct`` (v1
  ``:327`` and v2 ``:683``), ``conv_grad_norm_gram`` (``:797``), ``el2n``
  (``:100``), ``grand_last_layer`` (``:933``), ``bn_grad_norm`` (``:883``),
  ``conv_grad_norm_catdot`` (``:156``) and ``conv_bwd_grad_norm`` (the
  megakernel, ``:488``)
* ``ops/scores.py`` -> ``ops/scores.py`` (local scores, ``grand_vmap``, method
  resolution)
* ``ops/grand_batched.py`` -> ``ops/grand_batched.py`` (``batched_grand_scores``
  with same-geometry grouping and the stacked-BN and cat-dot routes,
  ``batched_grand_scores_fused`` with the megakernel route, the ``DDT_GRAND_*``
  toggles under the JAX names)
* ``ops/scoring.py`` -> ``ops/scoring.py`` (``score_dataset``, ``ScoreResident``)
* ``pruning.py`` -> ``pruning.py`` (``select_indices``)
* ``serve/engine.py`` -> ``serve/engine.py`` (``ServeEngine`` scoring units)
* ``cli.py`` -> ``cli.py`` (``score`` only)

Not ported yet: training (``train/``, pretrained scoring variables,
checkpoints, ``cli train|run|sweep``), train-mode scoring
(``score.eval_mode=false``), WideResNet, the npz/sharded/streaming data
planes, multi-device scoring, the serving batcher/server/router/fleet,
observability and resilience.
"""
