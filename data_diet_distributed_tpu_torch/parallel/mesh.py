"""The process group and its ``{data, model}`` layout (counterpart of
``data_diet_distributed_tpu/parallel/mesh.py``).

A port run of W = D x M processes, one device per rank, computes what the
JAX package computes on a mesh ``{data: D, model: M}``. Rank r sits at data
index ``r // M`` and model index ``r % M``: the row-major
``reshape(data, model)`` of JAX ``make_mesh``.

* ``initialize_multihost`` joins the group from the ``mesh`` config
  (``tcp://{coordinator_address}``, ``process_id``, ``num_processes``). The
  backend follows the device asked for: NCCL for CUDA (after
  ``torch.cuda.set_device`` of the local rank), gloo for the CPU. Host-side
  agreement (``resilience/consensus.py``) runs over a gloo group made beside
  an NCCL group, so it never waits behind the device's stream. With
  ``model_axis = M > 1`` every rank then makes, in the same order, the
  ``data`` groups (the ranks of one model index: D ranks each) and the
  ``model`` groups (the ranks of one data index: M ranks each).
* ``world_size``, ``process_index``, ``is_primary`` and ``sync_hosts`` read
  the group (1, 0, True and nothing without one); ``model_size``,
  ``data_size``, ``model_index``, ``data_index``, ``data_group`` and
  ``model_group`` read its layout (the data group is the world's, None, at
  M = 1). The two sharders of the JAX package become two slices:
  ``batch_slice`` ``(data_index, D)`` for training and eval, which split the
  batch over ``data`` only (the ranks of one model group hold the same rows),
  and ``flat_slice`` ``(rank, W)`` for scoring and serving, which flatten
  the mesh (``BatchSharder.flat``); each is None where it covers one rank.
  ``global_batch_size_for`` rounds to D, or to W with ``flat``.
* ``make_mesh`` checks the geometry: ``data_axis x model_axis`` must tile W.
  Under elastic supervision ``run_mesh`` goes through ``remap_mesh``
  instead, which recomputes a ``data_axis`` pinned for the world of an
  earlier attempt and never changes the model axis.
* ``param_layout`` is ``_param_spec_for``: at M > 1 the classifier head is
  split over the model group, by its output features. The port's ``Linear``
  weight is ``[out, in]``, so that is dim 0 (Flax's ``[in, out]`` kernel
  splits dim 1); the bias splits dim 0 too. Every other leaf is whole.
* ZeRO-1 (``mesh.shard_opt_state``) and the cross-replica sharded weight
  update (``mesh.shard_weight_update`` or ``DDT_SHARDED_UPDATE=1``) share one
  layout over the data group, ``UpdateSharding``: each leaf that
  ``_zero1_spec`` shards keeps only its data rank's slice of the momentum.
  The rule is the JAX package's applied to the port's OIHW shapes, so a conv
  kernel shards its output channels where Flax's HWIO kernel shards its
  input channels; the values do not change. On a head leaf it shards the
  first dim the model group does not split, as ``_zero1_spec`` does on a
  tensor-parallel spec.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: The leaves the model group splits at M > 1 (``_param_spec_for``'s
#: ``"classifier"`` path): the head's weight and bias.
HEAD_LEAVES = ("classifier.weight", "classifier.bias")

_HOST_GROUP = None
_MODEL = 1
_DATA_GROUP = None
_MODEL_GROUP = None


def world_size() -> int:
    """The number of ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0 writes checkpoints, manifests, score files and the JSON lines."""
    return process_index() == 0


def host_group():
    """The group for host-side (CPU tensor) collectives: the world group under
    gloo, a gloo group made at join time under NCCL."""
    return _HOST_GROUP


def model_size() -> int:
    """M: the ranks one classifier head is split over (1 without a model axis)."""
    return _MODEL


def data_size() -> int:
    """D = W / M: the ranks one training batch is split over."""
    return world_size() // _MODEL


def model_index() -> int:
    """This rank's place in its model group, ``rank % M``."""
    return process_index() % _MODEL


def data_index() -> int:
    """This rank's place in its data group, ``rank // M``."""
    return process_index() // _MODEL


def data_group():
    """The ranks of this rank's model index (None: the world, at M = 1)."""
    return _DATA_GROUP


def model_group():
    """The ranks of this rank's data index (None at M = 1)."""
    return _MODEL_GROUP


def sync_hosts(name: str) -> None:
    """Barrier over the host group; nothing without a group. ``name`` names the
    point every rank reaches (the JAX package keys its barrier by it; a torch
    barrier has no key, so here it only documents the call site)."""
    del name
    if world_size() > 1:
        dist.barrier(group=host_group())


def batch_slice() -> tuple[int, int] | None:
    """``(data_index, D)``: which contiguous rows of every global training or
    eval batch this process holds (``data/pipeline.py``; the JAX package's
    ``BatchSharder(mesh)``); None at D = 1."""
    d = data_size()
    return (data_index(), d) if d > 1 else None


def flat_slice() -> tuple[int, int] | None:
    """``(rank, W)``: the rows of every scoring or serving batch this process
    holds, over the flattened mesh (``BatchSharder.flat``); None at W = 1."""
    w = world_size()
    return (process_index(), w) if w > 1 else None


def global_batch_size_for(requested: int, world: int | None = None, *,
                          flat: bool = False) -> int:
    """``requested`` rounded up to a multiple of ``world`` ranks: by default D,
    the training layout's ranks, and with ``flat`` W (the JAX package's
    ``BatchSharder.global_batch_size_for``: 60 -> 64 at 8 ranks)."""
    w = (world_size() if flat else data_size()) if world is None else int(world)
    return ((int(requested) + w - 1) // w) * w


def _check_tiling(world: int, model: int) -> None:
    if model < 1 or world % model:
        raise ValueError(f"mesh.model_axis={model} does not tile {world} processes "
                         "(one device per rank)")


def initialize_multihost(cfg_mesh, device=None, backend: str | None = None) -> None:
    """Join the process group when ``mesh.multihost`` is set; nothing otherwise.

    ``device`` is the device the caller asked for (None = CUDA). The backend
    follows it, NCCL for CUDA and gloo for the CPU, unless ``backend`` names
    one (gloo with CUDA tensors lets several ranks share one card, which NCCL
    refuses). Under CUDA the rank's device is set first: the index given in
    ``device``, else ``process_id`` modulo the visible cards. With
    ``mesh.model_axis > 1`` the data and model groups follow, on the same
    backend. Init failures propagate."""
    global _HOST_GROUP, _MODEL, _DATA_GROUP, _MODEL_GROUP
    if not cfg_mesh.multihost:
        return
    world, model = int(cfg_mesh.num_processes), int(cfg_mesh.model_axis)
    _check_tiling(world, model)
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else int(cfg_mesh.process_id) % torch.cuda.device_count())
        torch.cuda.set_device(index)
    dist.init_process_group(backend, init_method=f"tcp://{cfg_mesh.coordinator_address}",
                            rank=int(cfg_mesh.process_id), world_size=world)
    _HOST_GROUP = dist.new_group(backend="gloo") if backend != "gloo" else None
    _MODEL = model
    if model > 1:
        # Every rank makes every group, in one order: new_group is collective.
        rank = int(cfg_mesh.process_id)
        for m in range(model):
            g = dist.new_group(list(range(m, world, model)))
            if rank % model == m:
                _DATA_GROUP = g
        for d in range(world // model):
            g = dist.new_group(list(range(d * model, (d + 1) * model)))
            if rank // model == d:
                _MODEL_GROUP = g


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _HOST_GROUP, _MODEL, _DATA_GROUP, _MODEL_GROUP
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = _DATA_GROUP = _MODEL_GROUP = None
    _MODEL = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The run's geometry, ``data x model`` ranks, and this rank's place in it."""

    data: int
    model: int = 1
    data_index: int = 0
    model_index: int = 0

    @property
    def size(self) -> int:
        return self.data * self.model


def make_mesh(cfg_mesh=None, world: int | None = None) -> Mesh:
    """The ``{data: D, model: M}`` mesh of this run: ``mesh.model_axis`` = M
    (default 1) and ``mesh.data_axis`` = D (default W / M), which must tile the
    W ranks. In a joined group the model axis must be the one it joined with
    (its groups are made at join time)."""
    w = world_size() if world is None else int(world)
    model = cfg_mesh.model_axis if cfg_mesh is not None else 1
    data = cfg_mesh.data_axis if cfg_mesh is not None and cfg_mesh.data_axis else w // model
    if data * model != w:
        raise ValueError(f"mesh {data}x{model} does not tile {w} processes "
                         "(one device per rank)")
    if world is None and w > 1 and model != model_size():
        raise ValueError(f"mesh.model_axis={model}, but the group joined with a "
                         f"model axis of {model_size()}")
    rank = process_index() if w == world_size() else 0
    return Mesh(data, model, rank // model, rank % model)


def run_mesh(cfg_mesh=None, elastic: bool = False, world: int | None = None) -> Mesh:
    """The run's mesh: ``make_mesh``, except under elastic supervision, where
    a relaunch after a shrink or a grow arrives with the ``data_axis`` pinned
    for the first world and ``remap_mesh`` recomputes it."""
    return remap_mesh(cfg_mesh, world) if elastic else make_mesh(cfg_mesh, world)


def remap_mesh(cfg_mesh=None, world: int | None = None) -> Mesh:
    """The mesh of a CHANGED world (elastic shrink or grow): ``make_mesh``,
    but a pinned ``data_axis`` that no longer tiles the W ranks becomes W / M.
    The ``model`` axis is never changed: a world it cannot tile raises (a
    tensor-parallel head cannot lose a shard-holder)."""
    w = world_size() if world is None else int(world)
    model = cfg_mesh.model_axis if cfg_mesh is not None else 1
    if w % model:
        raise ValueError(
            f"remap_mesh: {w} surviving ranks cannot tile model_axis={model}")
    data = cfg_mesh.data_axis if cfg_mesh is not None else None
    if data is None or data * model != w:
        data = w // model
    pinned = dataclasses.replace(cfg_mesh, data_axis=data) if cfg_mesh is not None else None
    return make_mesh(pinned, world)


def param_layout(name: str, model: int | None = None) -> int | None:
    """The dim of leaf ``name`` that the model group splits over ``model``
    ranks (default the joined M): dim 0 of the classifier's weight and bias
    at M > 1; None (whole on every rank) otherwise."""
    model = model_size() if model is None else int(model)
    return 0 if model > 1 and name in HEAD_LEAVES else None


def _zero1_spec(shape, data_size: int, skip: int | None = None) -> int | None:
    """The dim of a leaf of ``shape`` that ZeRO-1 shards over ``data_size``
    ranks: the first one other than ``skip`` (the dim the model group splits)
    divisible by it (and at least as long); None keeps the leaf whole (the
    JAX package's rule)."""
    for d, n in enumerate(shape):
        if d != skip and n % data_size == 0 and n >= data_size:
            return d
    return None


@dataclasses.dataclass(frozen=True)
class UpdateSharding:
    """The per-leaf layout of ZeRO-1 and the sharded weight update over the
    ``data_size`` ranks of the data group: a leaf of ``shape`` keeps slice
    ``rank`` (the data index) of dim ``spec_for(shape, name)`` (None: the
    whole leaf, updated on every rank). ``model_size`` > 1 makes the head's
    leaves tensor-parallel: they shard another dim than the model group's,
    and count M times in the bytes of the whole tree."""

    data_size: int
    rank: int
    model_size: int = 1

    def spec_for(self, shape, name: str | None = None) -> int | None:
        return _zero1_spec(tuple(shape), self.data_size,
                           param_layout(name, self.model_size) if name else None)

    def slices(self, t: torch.Tensor, name: str | None = None) -> tuple[torch.Tensor, ...]:
        """Every rank's slice of ``t``, by rank (views; ``(t,)`` when unsharded)."""
        d = self.spec_for(t.shape, name)
        return (t,) if d is None else t.chunk(self.data_size, dim=d)

    def shard(self, t: torch.Tensor, name: str | None = None) -> torch.Tensor:
        """This rank's slice of ``t`` (a view; ``t`` itself when unsharded)."""
        parts = self.slices(t, name)
        return parts[self.rank] if len(parts) > 1 else t

    def sharded_fraction(self, params: dict) -> float:
        """The share of the whole tree's parameter bytes the layout shards
        (``params`` may hold the head's rows only: they count M times)."""
        total = sharded = 0
        for k, t in params.items():
            n = t.numel() * t.element_size()
            if param_layout(k, self.model_size) is not None:
                n *= self.model_size
            total += n
            if self.spec_for(t.shape, k) is not None:
                sharded += n
        return sharded / total if total else 0.0


def _data_layout(cfg_mesh, world: int | None) -> tuple[int, int, int]:
    """``(D, data_index, M)`` of the W ranks (default the group's)."""
    w = world_size() if world is None else int(world)
    model = max(int(cfg_mesh.model_axis), 1)
    return w // model, (process_index() // model if w == world_size() else 0), model


def resolve_update_sharding(cfg_mesh, world: int | None = None) -> UpdateSharding | None:
    """The sharded weight update (None = replicated): ``mesh.shard_weight_update``
    True/False, or None = armed by ``DDT_SHARDED_UPDATE=1``; disarmed at D = 1."""
    d, rank, model = _data_layout(cfg_mesh, world)
    armed = cfg_mesh.shard_weight_update
    if armed is None:
        armed = os.environ.get("DDT_SHARDED_UPDATE", "") not in ("", "0")
    if not armed or d <= 1:
        return None
    return UpdateSharding(d, rank, model)


def resolve_slot_sharding(cfg_mesh, world: int | None = None) -> UpdateSharding | None:
    """The layout of the momentum: sharded over the data group under ZeRO-1
    (``mesh.shard_opt_state``) or the sharded update (which implies it), None
    otherwise and at D = 1."""
    d, rank, model = _data_layout(cfg_mesh, world)
    if d <= 1:
        return None
    if cfg_mesh.shard_opt_state or resolve_update_sharding(cfg_mesh, world) is not None:
        return UpdateSharding(d, rank, model)
    return None
