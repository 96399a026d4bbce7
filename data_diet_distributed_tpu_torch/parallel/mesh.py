"""The process group and the data-parallel layout (counterpart of
``data_diet_distributed_tpu/parallel/mesh.py``).

A port run of W processes, one device per rank, computes what the JAX
package computes on a mesh ``{data: W, model: 1}``:

* ``initialize_multihost`` joins the group from the ``mesh`` config
  (``tcp://{coordinator_address}``, ``process_id``, ``num_processes``). The
  backend follows the device asked for: NCCL for CUDA (after
  ``torch.cuda.set_device`` of the local rank), gloo for the CPU. Host-side
  agreement (``resilience/consensus.py``) runs over a gloo group made beside
  an NCCL group, so it never waits behind the device's stream.
* ``world_size``, ``process_index``, ``is_primary`` and ``sync_hosts`` read
  the group (1, 0, True and nothing without one); ``image_slice`` is the
  ``(rank, W)`` the data planes take, None at W = 1.
* ``make_mesh`` checks the geometry: ``mesh.data_axis`` must equal W, and a
  tensor-parallel ``model`` axis is refused.
* ZeRO-1 (``mesh.shard_opt_state``) and the cross-replica sharded weight
  update (``mesh.shard_weight_update`` or ``DDT_SHARDED_UPDATE=1``) share one
  layout, ``UpdateSharding``: each leaf that ``_zero1_spec`` shards keeps only
  its rank's slice of the momentum. The rule is the JAX package's applied to
  the port's OIHW shapes, so a conv kernel shards its output channels where
  Flax's HWIO kernel shards its input channels; the values do not change.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_HOST_GROUP = None


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


def sync_hosts(name: str) -> None:
    """Barrier over the host group; nothing without a group. ``name`` names the
    point every rank reaches (the JAX package keys its barrier by it; a torch
    barrier has no key, so here it only documents the call site)."""
    del name
    if world_size() > 1:
        dist.barrier(group=host_group())


def image_slice() -> tuple[int, int] | None:
    """``(rank, W)``: which contiguous rows of every global batch this process
    holds (``data/pipeline.py``); None at W = 1."""
    w = world_size()
    return (process_index(), w) if w > 1 else None


def global_batch_size_for(requested: int, world: int | None = None) -> int:
    """``requested`` rounded up to a multiple of W (the JAX package's
    ``BatchSharder.global_batch_size_for`` at ``{data: W}``: 60 -> 64 at W = 8)."""
    w = world_size() if world is None else int(world)
    return ((int(requested) + w - 1) // w) * w


def initialize_multihost(cfg_mesh, device=None, backend: str | None = None) -> None:
    """Join the process group when ``mesh.multihost`` is set; nothing otherwise.

    ``device`` is the device the caller asked for (None = CUDA). The backend
    follows it, NCCL for CUDA and gloo for the CPU, unless ``backend`` names
    one (gloo with CUDA tensors lets several ranks share one card, which NCCL
    refuses). Under CUDA the rank's device is set first: the index given in
    ``device``, else ``process_id`` modulo the visible cards. Init failures
    propagate."""
    global _HOST_GROUP
    if not cfg_mesh.multihost:
        return
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else int(cfg_mesh.process_id) % torch.cuda.device_count())
        torch.cuda.set_device(index)
    dist.init_process_group(backend, init_method=f"tcp://{cfg_mesh.coordinator_address}",
                            rank=int(cfg_mesh.process_id),
                            world_size=int(cfg_mesh.num_processes))
    _HOST_GROUP = dist.new_group(backend="gloo") if backend != "gloo" else None


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _HOST_GROUP
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The run's geometry: ``data`` ranks, ``model`` 1."""

    data: int
    model: int = 1

    @property
    def size(self) -> int:
        return self.data * self.model


def make_mesh(cfg_mesh=None, world: int | None = None) -> Mesh:
    """The ``{data: W, model: 1}`` mesh of this run. A pinned ``data_axis`` must
    equal W; ``model_axis > 1`` raises (the tensor-parallel classifier is not
    ported: ROADMAP.md Queue 1 item 2)."""
    w = world_size() if world is None else int(world)
    model = cfg_mesh.model_axis if cfg_mesh is not None else 1
    if model != 1:
        raise NotImplementedError(
            f"mesh.model_axis={model}: the tensor-parallel classifier is not ported "
            "to the PyTorch package (ROADMAP.md Queue 1 item 2); use model_axis=1")
    data = cfg_mesh.data_axis if cfg_mesh is not None and cfg_mesh.data_axis else w
    if data * model != w:
        raise ValueError(f"mesh {data}x{model} does not tile {w} processes "
                         "(one device per rank)")
    return Mesh(data, model)


def _zero1_spec(shape, data_size: int) -> int | None:
    """The dim of a leaf of ``shape`` that ZeRO-1 shards over ``data_size``
    ranks: the first one divisible by it (and at least as long); None keeps the
    leaf whole (the JAX package's rule)."""
    for d, n in enumerate(shape):
        if n % data_size == 0 and n >= data_size:
            return d
    return None


@dataclasses.dataclass(frozen=True)
class UpdateSharding:
    """The per-leaf layout of ZeRO-1 and the sharded weight update over
    ``data_size`` ranks: a leaf of ``shape`` keeps slice ``rank`` of
    dim ``spec_for(shape)`` (None: the whole leaf, updated on every rank)."""

    data_size: int
    rank: int

    def spec_for(self, shape) -> int | None:
        return _zero1_spec(tuple(shape), self.data_size)

    def slices(self, t: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Every rank's slice of ``t``, by rank (views; ``(t,)`` when unsharded)."""
        d = self.spec_for(t.shape)
        return (t,) if d is None else t.chunk(self.data_size, dim=d)

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t`` (a view; ``t`` itself when unsharded)."""
        parts = self.slices(t)
        return parts[self.rank] if len(parts) > 1 else t

    def sharded_fraction(self, params: dict) -> float:
        """The share of parameter bytes the layout shards."""
        total = sharded = 0
        for t in params.values():
            n = t.numel() * t.element_size()
            total += n
            if self.spec_for(t.shape) is not None:
                sharded += n
        return sharded / total if total else 0.0


def resolve_update_sharding(cfg_mesh, world: int | None = None) -> UpdateSharding | None:
    """The sharded weight update (None = replicated): ``mesh.shard_weight_update``
    True/False, or None = armed by ``DDT_SHARDED_UPDATE=1``; disarmed at W = 1."""
    w = world_size() if world is None else int(world)
    armed = cfg_mesh.shard_weight_update
    if armed is None:
        armed = os.environ.get("DDT_SHARDED_UPDATE", "") not in ("", "0")
    if not armed or w <= 1:
        return None
    return UpdateSharding(w, process_index())


def resolve_slot_sharding(cfg_mesh, world: int | None = None) -> UpdateSharding | None:
    """The layout of the momentum: sharded under ZeRO-1 (``mesh.shard_opt_state``)
    or the sharded update (which implies it), None otherwise and at W = 1."""
    w = world_size() if world is None else int(world)
    if w <= 1:
        return None
    if cfg_mesh.shard_opt_state or resolve_update_sharding(cfg_mesh, w) is not None:
        return UpdateSharding(w, process_index())
    return None
