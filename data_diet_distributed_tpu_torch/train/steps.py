"""Training and evaluation steps (counterpart of
``data_diet_distributed_tpu/train/steps.py``, the per-step path).

``train_step`` is the JAX package's ``_train_step_math``: optional
augmentation keyed by ``(seed, step)``, a train-mode forward whose BatchNorm
normalizes by the batch's statistics (padded rows included), the loss
``Σ(CE · mask) / max(Σ mask, 1)``, its gradient, the optimizer update and the
running-statistics update ``m · running + (1 − m) · batch``. Compute runs in
the model's dtype (bf16 under ``train.half_precision``) with fp32 parameters:
the layers cast their weights per call, so gradients land in fp32; there is
no autocast and no loss scaling. ``eval_step`` returns the masked sums
``loss_sum``, ``correct`` and ``examples``. Both return device scalars, which
the caller fetches once per epoch.

Across W ranks (a process group) each rank holds its rows of the global
batch, and the step computes what the JAX package's data-sharded step does:
the augmentation draws are the global batch's, BatchNorm normalizes by the
global batch's statistics (``global_batch_stats``), each rank differentiates
its masked sum over the all-reduced mask count, the optimizer sums the
gradients, and the returned loss, ``correct`` and ``examples`` are the global
batch's. (Not DDP's mean of per-rank means, which is wrong on the padded
last batch.) ``eval_step`` stays per rank; ``evaluate`` sums the ranks.
"""

from __future__ import annotations

import contextlib

import torch
from torch.func import functional_call

from ..data.augment import augment_batch
from ..models.resnet import collect_batch_stats, global_batch_stats
from ..ops.scores import cross_entropy
from ..parallel.collectives import all_reduce_sum_
from ..parallel.mesh import image_slice
from .state import SGD, TrainState


def _stat_names(model: torch.nn.Module) -> dict:
    """BatchNorm module -> its ``(running_mean, running_var)`` variable names."""
    return {mod: (f"{name}.running_mean", f"{name}.running_var")
            for name, mod in model.named_modules()
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm)}


def train_step(model: torch.nn.Module, optimizer: SGD, state: TrainState, batch: dict,
               augment: tuple[int, bool, int] | None = None) -> dict:
    """One optimizer step on ``batch`` (device tensors ``image, label, mask``),
    updating ``state`` in place; returns ``{loss, correct, examples}``.
    ``augment`` is ``(crop_pad, flip, seed)`` or None."""
    image, label, mask = batch["image"], batch["label"], batch["mask"]
    rows = image_slice()
    if augment is not None:
        crop_pad, flip, seed = augment
        image = augment_batch(image, seed, state.step, crop_pad, flip, image_slice=rows)
    model.train()
    params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
    with collect_batch_stats() as batch_stats, \
            (global_batch_stats() if rows else contextlib.nullcontext()):
        logits = functional_call(model, {**params, **state.batch_stats}, (image,))
    per_ex = cross_entropy(logits, label) * mask
    count = mask.sum()
    if rows:
        count = all_reduce_sum_(count.clone())
    loss = per_ex.sum() / torch.clamp(count, min=1.0)
    grads = torch.autograd.grad(loss, list(params.values()))
    optimizer.update(state, dict(zip(params, grads)))
    with torch.no_grad():
        for mod, (mean_key, var_key) in _stat_names(model).items():
            mean, var = batch_stats[mod]
            m = mod.flax_momentum
            state.batch_stats[mean_key] = m * state.batch_stats[mean_key] + (1 - m) * mean
            state.batch_stats[var_key] = m * state.batch_stats[var_key] + (1 - m) * var
        correct = ((logits.argmax(dim=-1) == label) * mask).sum()
        if rows:
            # Each rank's loss is its share of the global one: the sum is it.
            summed = all_reduce_sum_(torch.stack([loss.detach(), correct.float()]))
            return {"loss": summed[0], "correct": summed[1], "examples": count}
    return {"loss": loss.detach(), "correct": correct, "examples": mask.sum()}


def eval_step(model: torch.nn.Module, state: TrainState, batch: dict) -> dict:
    """Masked ``{loss_sum, correct, examples}`` of an eval-mode forward."""
    model.eval()
    label, mask = batch["label"], batch["mask"]
    with torch.no_grad():
        logits = functional_call(model, state.variables, (batch["image"],))
        per_ex = cross_entropy(logits, label) * mask
        correct = ((logits.argmax(dim=-1) == label) * mask).sum()
    return {"loss_sum": per_ex.sum(), "correct": correct, "examples": mask.sum()}
