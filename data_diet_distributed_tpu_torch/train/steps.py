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

Across D data ranks (a process group, ``{data: D, model: M}``) each rank
holds its data index's rows of the global batch (``batch_slice``: the ranks
of one model group hold the same rows), and the step computes what the JAX
package's data-sharded step does: the augmentation draws are the global
batch's, BatchNorm normalizes by the global batch's statistics
(``global_batch_stats``, over the data group), each rank differentiates its
masked sum over the mask count all-reduced over the data group, the
optimizer sums the gradients over the data group, and the returned loss,
``correct`` and ``examples`` are the global batch's. (Not DDP's mean of
per-rank means, which is wrong on the padded last batch.) At M > 1 the
head's rows are the rank's (``models/resnet.py::Head``): its forward
gathers the logits over the model group, so the loss and ``argmax`` see
them whole. ``eval_step`` stays per rank; ``evaluate`` sums the data ranks.

``dispatch_train_step`` and ``dispatch_eval_step`` are what the epoch loop
calls, as the JAX package's ``_counted``: a ``dispatches_<name>`` registry
count per call and, for ``train_step``, the introspector's harvest of the
first call of each batch geometry (``obs/introspect.py``); both no-ops when
nothing is installed, and neither touches the arithmetic.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.func import functional_call

from ..data.augment import apply_augment, augment_batch, draw_augment
from ..data.pipeline import gather_resident_batch
from ..graphs import ChunkProgram
from ..models.resnet import collect_batch_stats, global_batch_stats
from ..obs import introspect
from ..obs import registry as obs_registry
from ..ops.scores import cross_entropy
from ..parallel.collectives import all_reduce_sum_
from ..parallel.mesh import batch_slice, data_group
from .state import SGD, TrainState


def _stat_names(model: torch.nn.Module) -> dict:
    """BatchNorm module -> its ``(running_mean, running_var)`` variable names."""
    return {mod: (f"{name}.running_mean", f"{name}.running_var")
            for name, mod in model.named_modules()
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm)}


def train_step(model: torch.nn.Module, optimizer: SGD, state: TrainState, batch: dict,
               augment: tuple[int, bool, int] | None = None, *, draws=None,
               lr: torch.Tensor | None = None) -> dict:
    """One optimizer step on ``batch`` (device tensors ``image, label, mask``),
    updating ``state`` in place; returns ``{loss, correct, examples}``.
    ``augment`` is ``(crop_pad, flip, seed)`` or None.

    Every tensor of ``state`` is written in place. The per-step path passes
    neither keyword: the step draws its augmentation for ``(seed,
    state.step)``, reads the learning rate from the schedule and advances
    ``state.step``. A chunk body (``make_train_chunk``) passes ``draws``
    (``(flips, offsets)``, the step's staged draws on the device) and ``lr``
    (a 0-dim fp32 device tensor from the same schedule), leaving the step
    count to the chunk: nothing the body reads comes from the host."""
    image, label, mask = batch["image"], batch["label"], batch["mask"]
    rows = batch_slice()
    if augment is not None:
        crop_pad, flip, seed = augment
        if draws is None:
            image = augment_batch(image, seed, state.step, crop_pad, flip,
                                  image_slice=rows)
        else:
            image = apply_augment(image, *draws, crop_pad)
    model.train()
    params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
    with collect_batch_stats() as batch_stats, \
            (global_batch_stats() if rows else contextlib.nullcontext()):
        logits = functional_call(model, {**params, **state.batch_stats}, (image,))
    per_ex = cross_entropy(logits, label) * mask
    count = mask.sum()
    if rows:
        count = all_reduce_sum_(count.clone(), data_group())
    loss = per_ex.sum() / torch.clamp(count, min=1.0)
    grads = torch.autograd.grad(loss, list(params.values()))
    optimizer.update(state, dict(zip(params, grads)), lr=lr)
    with torch.no_grad():
        for mod, (mean_key, var_key) in _stat_names(model).items():
            mean, var = batch_stats[mod]
            m = mod.flax_momentum
            # In place: a chunk's captured storage is the state's own.
            for key, batch_stat in ((mean_key, mean), (var_key, var)):
                state.batch_stats[key].copy_(m * state.batch_stats[key] + (1 - m) * batch_stat)
        correct = ((logits.argmax(dim=-1) == label) * mask).sum()
        if rows:
            # Each rank's loss is its share of the global one: the sum is it.
            summed = all_reduce_sum_(torch.stack([loss.detach(), correct.float()]),
                                     data_group())
            return {"loss": summed[0], "correct": summed[1], "examples": count}
    return {"loss": loss.detach(), "correct": correct, "examples": mask.sum()}


def eval_step(model: torch.nn.Module, state: TrainState, batch: dict) -> dict:
    """Masked ``{loss_sum, correct, examples}`` of an eval-mode forward on the
    rank's rows (whole logits: the head gathers them at M > 1)."""
    model.eval()
    label, mask = batch["label"], batch["mask"]
    with torch.no_grad():
        logits = functional_call(model, state.variables, (batch["image"],))
        per_ex = cross_entropy(logits, label) * mask
        correct = ((logits.argmax(dim=-1) == label) * mask).sum()
    return {"loss_sum": per_ex.sum(), "correct": correct, "examples": mask.sum()}


def dispatch_train_step(model: torch.nn.Module, optimizer: SGD, state: TrainState,
                        batch: dict, augment: tuple[int, bool, int] | None = None) -> dict:
    """``train_step``, counted (``dispatches_train_step``) and harvested once
    per batch geometry as the ``train_step`` program."""
    obs_registry.inc("dispatches_train_step")
    shape = tuple(batch["image"].shape)
    return introspect.call("train_step", train_step,
                           (model, optimizer, state, batch, augment),
                           key=shape, examples=shape[0])


def dispatch_eval_step(model: torch.nn.Module, state: TrainState, batch: dict) -> dict:
    """``eval_step``, counted (``dispatches_eval_step``)."""
    obs_registry.inc("dispatches_eval_step")
    return eval_step(model, state, batch)


def chunk_key(program: str, k: int, image_shape: tuple, batch: int,
              dtype: torch.dtype) -> tuple:
    """A chunk program's cache key: program, K, batch geometry and dtype."""
    return (program, k, (batch, *image_shape), str(dtype))


def make_train_chunk(model: torch.nn.Module, optimizer: SGD, state: TrainState,
                     source, k: int, augment: tuple[int, bool, int] | None = None
                     ) -> ChunkProgram:
    """K consecutive ``train_step``s as ONE dispatch, bound to ``state`` (the
    JAX package's ``make_train_chunk``, ``train/steps.py:159-209``): the
    state's tensors are the graph's, updated in place.

    ``source`` is the chunk feed: a ``ResidentBatches`` (the gather from its
    arrays runs inside the chunk, ``gather_resident_batch``) or a
    ``StreamingBatches`` (each ``ChunkBlock``'s rows are copied into the
    program's static block, gathered by an identity index). Each dispatch
    stages the ``[K, B]`` ``idx`` and ``mask``, the K learning rates ``lr``
    and, under ``augment``, the K steps' ``flips`` and ``offsets``
    (``chunk_inputs``); the per-step metrics come back stacked ``[K]``. The
    step count advances by K per dispatch (``dispatch_train_chunk``)."""
    device = next(iter(state.params.values())).device
    b = source.batch_size
    staged = {"idx": ((k, b), torch.int64), "mask": ((k, b), torch.float32),
              "lr": ((k,), torch.float32)}
    if augment is not None:
        crop_pad, flip, _ = augment
        if flip:
            staged["flips"] = ((k, b), torch.bool)
        if crop_pad:
            staged["offsets"] = ((k, b, 2), torch.int64)
    streamed = not hasattr(source, "images")
    copied = ({"images": ((k * b, *source.image_shape), source.image_dtype),
               "labels": ((k * b,), torch.int32), "indices": ((k * b,), torch.int32)}
              if streamed else {})

    def arrays(inputs):
        return ((inputs["images"], inputs["labels"], inputs["indices"]) if streamed
                else (source.images, source.labels, source.indices))

    def body(st: TrainState, inputs: dict, j: int) -> dict:
        batch = gather_resident_batch(*arrays(inputs), inputs["idx"][j], inputs["mask"][j])
        draws = None
        if augment is not None:
            draws = (inputs["flips"][j] if "flips" in inputs else None,
                     inputs["offsets"][j] if "offsets" in inputs else None)
        return train_step(model, optimizer, st, batch, augment, draws=draws,
                          lr=inputs["lr"][j])

    def run(inputs: dict) -> dict:
        outs = [body(state, inputs, j) for j in range(k)]
        return {key: torch.stack([o[key].float() for o in outs])
                for key in ("loss", "correct", "examples")}

    def warmup(inputs: dict) -> dict:
        # One body on a clone: the real state moves only in the replays.
        clone = TrainState({n: t.clone() for n, t in state.params.items()},
                           {n: t.clone() for n, t in state.batch_stats.items()},
                           {n: t.clone() for n, t in state.momentum.items()}, state.step)
        return body(clone, inputs, 0)

    return ChunkProgram("train_chunk", run, device, k=k, staged=staged, copied=copied,
                        warmup=warmup, examples=b,
                        key=chunk_key("train_chunk", k, source.image_shape, b,
                                      source.image_dtype))


def chunk_inputs(optimizer: SGD, step: int, idx, mask,
                 augment: tuple[int, bool, int] | None) -> dict:
    """The host half of one train chunk starting at optimizer step ``step``:
    ``idx`` and ``mask`` ``[K, B]``, the K learning rates from the schedule
    (np.float32, as the per-step path reads them) and, under ``augment``, the
    K steps' draws from ``draw_augment`` keyed by ``(seed, step + j)``: the
    draws the per-step path makes at those steps."""
    k, b = idx.shape
    host = {"idx": np.asarray(idx, np.int64), "mask": np.asarray(mask, np.float32),
            "lr": np.array([optimizer.schedule(step + j) for j in range(k)], np.float32)}
    if augment is not None:
        crop_pad, flip, seed = augment
        draws = [draw_augment(seed, step + j, b, crop_pad, flip) for j in range(k)]
        if flip:
            host["flips"] = np.stack([f.numpy() for f, _ in draws])
        if crop_pad:
            host["offsets"] = np.stack([o.numpy() for _, o in draws])
    return host


def dispatch_train_chunk(program: ChunkProgram, state: TrainState, host: dict,
                         block=None) -> dict:
    """One train chunk: counted (``dispatches_train_chunk``), staged and run;
    ``state.step`` advances by K. ``block`` is a streamed ``ChunkBlock``."""
    obs_registry.inc("dispatches_train_chunk")
    device = None
    if block is not None:
        device = {"images": block.images, "labels": block.labels,
                  "indices": block.indices}
    out = program(host, device)
    state.step += program.k
    return out


def make_eval_chunk(model: torch.nn.Module, variables: dict, source, k: int) -> ChunkProgram:
    """K ``eval_step``s as ONE dispatch over a ``ResidentBatches`` (the JAX
    package's ``make_eval_chunk``, ``train/steps.py:213-230``): the variables
    are copied into the program's static buffers each dispatch (one capture
    serves every state), the ``[K, B]`` ``idx`` and ``mask`` are staged, and
    the per-batch sums come back stacked ``[K]``."""
    device = source.images.device
    b = source.batch_size
    copied = dict(variables)

    def body(inputs: dict, j: int) -> dict:
        batch = gather_resident_batch(source.images, source.labels, source.indices,
                                      inputs["idx"][j], inputs["mask"][j])
        return eval_step(model, TrainState({n: inputs[n] for n in variables}, {}, {}),
                         batch)

    def run(inputs: dict) -> dict:
        outs = [body(inputs, j) for j in range(k)]
        return {key: torch.stack([o[key].float() for o in outs])
                for key in ("loss_sum", "correct", "examples")}

    return ChunkProgram("eval_chunk", run, device, k=k,
                        staged={"idx": ((k, b), torch.int64), "mask": ((k, b), torch.float32)},
                        copied=copied, warmup=lambda inputs: body(inputs, 0), examples=b,
                        key=chunk_key("eval_chunk", k, source.image_shape, b,
                                      source.images.dtype))


def dispatch_eval_chunk(program: ChunkProgram, state: TrainState, idx, mask) -> dict:
    """One eval chunk: counted (``dispatches_eval_chunk``), the state's
    variables copied in, ``idx``/``mask`` staged, run."""
    obs_registry.inc("dispatches_eval_chunk")
    return program({"idx": np.asarray(idx, np.int64), "mask": np.asarray(mask, np.float32)},
                   state.variables)
