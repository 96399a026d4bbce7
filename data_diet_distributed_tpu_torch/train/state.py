"""Train state, learning-rate schedule and optimizer (counterpart of
``data_diet_distributed_tpu/train/state.py``).

One schema, ``TrainState`` {params, batch_stats, momentum, step}, is both what
a training step updates and what a checkpoint holds, so a resume is exact.

The optimizer is the JAX package's optax chain written as plain tensor
functions, in optax's order and arithmetic: ``clip_by_global_norm`` (when
``optim.grad_clip_norm`` is set), then ``add_decayed_weights`` on every
parameter (BatchNorm scale and bias and the classifier bias included), then
``sgd``: the momentum trace ``t = g + m·t``, the update ``t`` (or
``g + m·t`` with Nesterov) scaled by ``-lr(step)``, where the schedule is read
at the step count before the update. The schedule is optax's, evaluated in
float32 as optax evaluates it.

Across W ranks the update takes each rank's partial gradients (of its
share of the global loss) and sums them, as the JAX package's data-sharded
step does: replicated, one all-reduce of every gradient, then the same
update on every rank. Under ZeRO-1 (``mesh.shard_opt_state``) each rank keeps
the momentum only for its slice of each leaf ``UpdateSharding`` shards,
updates that slice of the parameters, and the slices all-gather; the
sharded weight update (``mesh.shard_weight_update``) reduce-scatters the
gradients of those leaves instead of all-reducing them. Every step is
elementwise on the same sums, so both are bitwise the replicated update;
``optim.grad_clip_norm`` clips by the norm of the whole gradient, whose
squares then sum in another order.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models import create_model_from_cfg
from ..parallel import collectives
from ..parallel.mesh import (UpdateSharding, resolve_slot_sharding,
                             resolve_update_sharding, world_size)
from ..weights import init_variables


@dataclass
class TrainState:
    """Parameters, BatchNorm running statistics and the momentum trace (each a
    ``state_dict``-named mapping of fp32 tensors) and the optimizer step."""

    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    momentum: dict[str, torch.Tensor]
    step: int = 0

    @property
    def variables(self) -> dict[str, torch.Tensor]:
        """Params and statistics in one mapping, as the models take them."""
        return {**self.params, **self.batch_stats}


def _f32(x) -> np.float32:
    return np.float32(x)


def _cosine_decay(init_value: float, decay_steps: int) -> Callable[[int], np.float32]:
    """optax ``cosine_decay_schedule(init_value, decay_steps)`` (alpha 0)."""
    def schedule(count: int) -> np.float32:
        c = _f32(min(count, decay_steps))
        cosine = _f32(0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * c / _f32(decay_steps)))
        return _f32(init_value) * cosine
    return schedule


def _warmup_cosine_decay(peak: float, warmup_steps: int,
                         decay_steps: int) -> Callable[[int], np.float32]:
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)``: a linear ramp from 0, then a cosine over
    ``decay_steps - warmup_steps`` (``decay_steps`` includes the warmup)."""
    cosine = _cosine_decay(peak, decay_steps - warmup_steps)

    def schedule(count: int) -> np.float32:
        if count >= warmup_steps:
            return cosine(count - warmup_steps)
        frac = _f32(1.0) - _f32(max(count, 0)) / _f32(warmup_steps)
        return _f32(-peak) * frac + _f32(peak)
    return schedule


def make_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], np.float32]:
    """The learning rate at each optimizer step: cosine over
    ``optim.cosine_t_max_epochs`` (or ``train.num_epochs``) epochs, after a
    linear warmup of ``optim.warmup_epochs`` when set."""
    t_max_epochs = cfg.optim.cosine_t_max_epochs or cfg.train.num_epochs
    if cfg.optim.warmup_epochs > 0:
        if cfg.optim.warmup_epochs >= t_max_epochs:
            # Reachable past config validation: a scoring pretrain shortens
            # num_epochs to score.pretrain_epochs.
            raise ValueError(
                f"optim.warmup_epochs ({cfg.optim.warmup_epochs}) >= cosine "
                f"horizon ({t_max_epochs} epochs) for this fit; set "
                "optim.cosine_t_max_epochs explicitly (it also fixes the "
                "horizon for short scoring pretrains) or lower the warmup")
        return _warmup_cosine_decay(
            cfg.optim.lr, max(1, cfg.optim.warmup_epochs * steps_per_epoch),
            max(1, t_max_epochs * steps_per_epoch))
    return _cosine_decay(cfg.optim.lr, max(1, t_max_epochs * steps_per_epoch))


@dataclass(frozen=True)
class SGD:
    """The optax chain of ``make_optimizer``; ``update`` applies one step.

    ``world`` ranks sum their gradients in ``update`` (1: none); ``slots``
    shards the momentum (ZeRO-1), and ``scatter`` reduce-scatters the
    gradients of the sharded leaves (the sharded weight update)."""

    schedule: Callable[[int], np.float32]
    momentum: float
    weight_decay: float
    nesterov: bool = False
    grad_clip_norm: float | None = None
    world: int = 1
    slots: UpdateSharding | None = None
    scatter: bool = False

    @torch.no_grad()
    def update(self, state: TrainState, grads: dict[str, torch.Tensor]) -> None:
        """Update ``state.params`` and ``state.momentum`` in place from the
        fp32 ``grads`` (named like the params; at W ranks each rank's partial
        gradients, summed here), and advance ``state.step``."""
        names = list(state.params)
        sh = self.slots
        if sh is None:
            g = [grads[k] for k in names]
            if self.world > 1:
                g = collectives.all_reduce_flat(g)
            self._apply(state, [state.params[k] for k in names], g, names, None)
            return
        split = [k for k in names if sh.spec_for(state.params[k].shape) is not None]
        whole = [k for k in names if k not in split]
        if self.scatter:
            per_rank = [list(r) for r in zip(*(sh.slices(grads[k]) for k in split))]
            g = (collectives.reduce_scatter_flat(per_rank)
                 + collectives.all_reduce_flat([grads[k] for k in whole]))
        else:
            full = collectives.all_reduce_flat([grads[k] for k in split + whole])
            g = [sh.shard(t) for t in full[:len(split)]] + full[len(split):]
        # The rank's slices of the sharded parameters are views: updated in place.
        self._apply(state, [sh.shard(state.params[k]) for k in split]
                    + [state.params[k] for k in whole], g, split + whole, len(split))
        gathered = collectives.all_gather_flat([sh.shard(state.params[k]) for k in split])
        for i, k in enumerate(split):
            d = sh.spec_for(state.params[k].shape)
            state.params[k].copy_(torch.cat([rank[i] for rank in gathered], dim=d))

    def _apply(self, state: TrainState, params: list, g: list, names: list,
               n_split: int | None) -> None:
        """The chain on ``params`` (tensors updated in place) from gradients
        ``g`` and the momentum of ``names``; the first ``n_split`` are slices
        whose squares the global clip norm sums across the ranks."""
        if self.grad_clip_norm:
            if n_split is None:
                sq = sum(torch.sum(t * t) for t in g)
            else:
                zero = torch.zeros((), dtype=torch.float32, device=g[0].device)
                parts = torch.stack([sum((torch.sum(t * t) for t in g[:n_split]), zero),
                                     sum((torch.sum(t * t) for t in g[n_split:]), zero)])
                collectives.all_reduce_sum_(parts[:1])
                sq = parts[0] + parts[1]
            norm = torch.sqrt(sq)
            keep = norm < self.grad_clip_norm
            g = [torch.where(keep, t, t / norm * self.grad_clip_norm) for t in g]
        g = torch._foreach_add(g, torch._foreach_mul(params, self.weight_decay))
        trace = [state.momentum[k] for k in names]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, g)
        upd = (torch._foreach_add(g, torch._foreach_mul(trace, self.momentum))
               if self.nesterov else trace)
        lr = float(self.schedule(state.step))
        torch._foreach_add_(params, torch._foreach_mul(upd, -lr))
        state.step += 1


def make_optimizer(cfg: Config, steps_per_epoch: int) -> SGD:
    """The configured chain, across the process group's ranks with the ``mesh``
    config's ZeRO-1 and sharded update."""
    return SGD(make_schedule(cfg, steps_per_epoch), cfg.optim.momentum,
               cfg.optim.weight_decay, cfg.optim.nesterov, cfg.optim.grad_clip_norm,
               world=world_size(), slots=resolve_slot_sharding(cfg.mesh),
               scatter=resolve_update_sharding(cfg.mesh) is not None)


def shard_slots(state: TrainState, optimizer: SGD) -> TrainState:
    """``state`` with each sharded leaf's momentum cut to this rank's slice
    (a copy) when the optimizer shards its slots; ``state`` itself otherwise."""
    sh = optimizer.slots
    if sh is None:
        return state
    momentum = {k: sh.shard(v).clone() for k, v in state.momentum.items()}
    return TrainState(state.params, state.batch_stats, momentum, state.step)


def gather_slots(state: TrainState, optimizer: SGD) -> TrainState:
    """``state`` with every rank's momentum slices joined into whole leaves (a
    collective when the optimizer shards its slots): what a checkpoint holds,
    whatever W wrote it."""
    sh = optimizer.slots
    if sh is None:
        return state
    split = [k for k, v in state.params.items() if sh.spec_for(v.shape) is not None]
    gathered = collectives.all_gather_flat([state.momentum[k] for k in split])
    momentum = dict(state.momentum)
    for i, k in enumerate(split):
        momentum[k] = torch.cat([rank[i] for rank in gathered],
                                dim=sh.spec_for(state.params[k].shape))
    return TrainState(state.params, state.batch_stats, momentum, state.step)


def optimizer_bytes(state: TrainState) -> int:
    """Bytes of momentum this rank holds."""
    return sum(t.numel() * t.element_size() for t in state.momentum.values())


def state_from_variables(variables: dict[str, torch.Tensor],
                         model: torch.nn.Module) -> TrainState:
    """A fresh ``TrainState`` (zero momentum, step 0) from copies of
    ``variables`` (training updates its tensors in place)."""
    names = {n for n, _ in model.named_parameters()}
    params = {k: v.clone() for k, v in variables.items() if k in names}
    if set(params) != names:
        raise KeyError(f"variables lack parameters {sorted(names - set(params))}")
    stats = {k: v.clone() for k, v in variables.items() if k not in names}
    return TrainState(params=params, batch_stats=stats,
                      momentum={k: torch.zeros_like(v) for k, v in params.items()})


def create_train_state(cfg: Config, seed: int, device=None,
                       model: torch.nn.Module | None = None) -> TrainState:
    """Freshly initialized variables for ``cfg.model`` from ``seed`` (see
    ``weights.init_variables``), zero momentum, step 0. The retrain after a
    prune calls this again: it trains from scratch, as the reference does."""
    device = resolve_device(device)
    model = model if model is not None else create_model_from_cfg(cfg)
    variables = init_variables(cfg.model.arch, int(seed), device,
                               num_classes=cfg.model.num_classes, stem=cfg.model.stem)
    return state_from_variables(variables, model)
