"""The collectives the port runs across ranks (the all-reduces, reduce-scatters
and all-gathers that XLA inserts from sharding annotations in the JAX package).

Every function sums or gathers over ``group`` (default the world group) and
is a collective: every rank of the group calls it at the same point with
tensors of the same shapes. Under gloo a CUDA tensor is copied to the host,
reduced there and copied back; the choice is made by the backend's name, so
NCCL always takes the device tensors and a gloo build that lacks a
collective on CUDA tensors is never asked for one.

* ``all_reduce_with_grad``: a SUM whose backward is the SUM of the
  cotangents (the global BatchNorm statistics of ``models/resnet.py``, over
  the data group);
* ``copy_to_model`` and ``gather_from_model``: the tensor-parallel head's
  pair over the model group (Megatron's). The first is the identity whose
  backward sums the cotangents of the head's input over the model group
  (each rank's ``∂L/∂h`` holds only its rows' share ``∂L/∂z_m W_m``); the
  second all-gathers the rank's logit columns and takes back only its own
  columns of the cotangent (the loss is the same on every rank of the group,
  so nothing sums);
* ``all_reduce_flat``, ``reduce_scatter_flat``, ``all_gather_flat``: one
  collective over a flat buffer of many tensors (the gradients and the
  sharded parameters of ``train/state.py``);
* ``sum_float64``: a host float64 vector summed over the host group (the
  per-seed score join of ``ops/scoring.py``);
* ``all_gather_host`` and ``broadcast_json``: small host arrays from every
  rank, and a JSON object from rank 0 (the agreements of
  ``resilience/consensus.py`` and the serving operation records);
* ``scatter_rows``, ``gather_rows`` and ``gather_json``: the serving
  collectives of ``serve/engine.py``, over the host group. Rank 0 cuts a
  padded request block into W contiguous row slices and each rank receives
  its own slice only; each rank's scores for those rows go back to rank 0;
  each rank's small record (its kernel launches) goes to rank 0.

Every host collective is the identity at W = 1 and then runs no
``torch.distributed`` call.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.distributed as dist

from . import mesh


def _staged(t: torch.Tensor, group=None) -> bool:
    """Whether ``t`` goes through the host: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _size(group) -> int:
    return mesh.world_size() if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return mesh.process_index() if group is None else dist.get_rank(group)


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """SUM ``t`` over the ranks of ``group`` in place; returns ``t``."""
    if _staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.clone(), ctx.group), None


def all_reduce_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """``Σ_r x_r`` on every rank of ``group``, differentiable: each rank's
    cotangent of its ``x_r`` is the sum of every rank's cotangent of the
    result."""
    return _AllReduceSum.apply(x, group)


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) stacked ``[n, *t.shape]``."""
    n = _size(group)
    flat = t.reshape(-1)
    out = torch.empty(n * flat.numel(), dtype=t.dtype, device=t.device)
    if _staged(t, group):
        h = torch.empty(out.shape, dtype=t.dtype)
        dist.all_gather_into_tensor(h, flat.cpu(), group=group)
        out.copy_(h)
    else:
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, flat, group=group)
    return out.view(n, *t.shape)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        # In fp32 whatever the compute dtype: the M partial products sum once
        # (into a copy: autograd may hold the incoming cotangent elsewhere).
        total = all_reduce_sum_(grad.to(torch.float32, copy=True), mesh.model_group())
        return total.to(grad.dtype)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z):
        ctx.cols = z.shape[-1]
        parts = _gather(z, mesh.model_group())          # [M, ..., C/M]
        return torch.cat(parts.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        m = mesh.model_index()
        return grad[..., m * ctx.cols:(m + 1) * ctx.cols].contiguous()


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; its cotangent is summed over the model group."""
    return _CopyToModel.apply(x)


def gather_from_model(z: torch.Tensor) -> torch.Tensor:
    """The model group's column blocks of ``z`` joined in model-index order
    (the whole logits on every rank); the cotangent's own block comes back."""
    return _GatherFromModel.apply(z)


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(buf: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    out, o = [], 0
    for t in like:
        out.append(buf[o:o + t.numel()].view(t.shape))
        o += t.numel()
    return out


def all_reduce_flat(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """The elementwise SUM over the ranks of ``group`` of each of ``tensors``
    (new tensors), in one collective."""
    if not tensors:
        return []
    return _unflat(all_reduce_sum_(_flat(tensors), group), tensors)


def reduce_scatter_flat(per_rank: list[list[torch.Tensor]], group=None) -> list[torch.Tensor]:
    """``per_rank[r]`` lists the slices destined for rank r of ``group`` (the
    same shapes on every rank); returns this rank's slices summed over the
    ranks, in one collective."""
    if not per_rank[0]:
        return []
    w, r = len(per_rank), _rank(group)
    buf = torch.cat([_flat(chunks) for chunks in per_rank])
    n = buf.numel() // w
    if _staged(buf, group):
        # gloo: the reduce-scatter as an all-reduce of the host buffer and the
        # rank's slice of it (the same sums).
        h = buf.cpu()
        dist.all_reduce(h, group=group)
        own = h[r * n:(r + 1) * n].to(buf.device)
    else:
        own = torch.empty(n, dtype=buf.dtype, device=buf.device)
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        scatter(own, buf, group=group)
    return _unflat(own, per_rank[r])


def all_gather_flat(own: list[torch.Tensor], group=None) -> list[list[torch.Tensor]]:
    """Every rank's ``own`` tensors (the same shapes on every rank of
    ``group``), by rank, in one collective."""
    if not own:
        return [[] for _ in range(_size(group))]
    return [_unflat(chunk, own) for chunk in _gather(_flat(own), group)]


def sum_float64(vec: np.ndarray) -> np.ndarray:
    """``vec`` (float64) summed over the ranks, on every rank: one collective
    over the host group. Where each position is nonzero on one rank only, the
    result is bitwise that rank's value whatever the rank order."""
    if mesh.world_size() <= 1:
        return vec
    t = torch.from_numpy(np.ascontiguousarray(vec, np.float64).copy())
    dist.all_reduce(t, group=mesh.host_group())
    return t.numpy()


def all_gather_host(arr: np.ndarray) -> np.ndarray:
    """``arr`` from every rank, stacked ``[W, ...]`` (a host collective;
    ``arr[None]`` at W = 1)."""
    if mesh.world_size() <= 1:
        return np.asarray(arr)[None]
    w = mesh.world_size()
    t = torch.from_numpy(np.ascontiguousarray(arr)).reshape(-1)
    out = torch.empty(w * t.numel(), dtype=t.dtype)
    dist.all_gather_into_tensor(out, t, group=mesh.host_group())
    return out.numpy().reshape(w, *np.shape(arr))


def broadcast_json(obj):
    """A JSON-serializable object from rank 0 on every rank (identity with one
    rank): the single view of a file only rank 0 writes, or an operation
    record only rank 0 makes."""
    if mesh.world_size() <= 1:
        return obj
    primary = mesh.process_index() == 0
    payload = json.dumps(obj).encode() if primary else b""
    size = torch.tensor([len(payload)], dtype=torch.int64)
    dist.broadcast(size, src=0, group=mesh.host_group())
    buf = torch.zeros(int(size[0]), dtype=torch.uint8)
    if primary:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    dist.broadcast(buf, src=0, group=mesh.host_group())
    return json.loads(buf.numpy().tobytes().decode())


def scatter_rows(block: list[np.ndarray] | None, rows: int,
                 like: list[tuple[tuple, np.dtype]]) -> list[np.ndarray]:
    """This rank's rows of a block that rank 0 holds: ``block`` (rank 0 only;
    None elsewhere) is a list of arrays of ``W·rows`` rows each, and rank
    ``r`` receives rows ``[r·rows, (r+1)·rows)`` of every one, never the whole
    block. ``like`` gives, on every rank, each array's ``(row shape,
    dtype)``. One scatter per array over the host group; ``block`` itself at
    W = 1."""
    w = mesh.world_size()
    if w <= 1:
        return list(block)
    primary = mesh.process_index() == 0
    out = []
    for k, (row_shape, dtype) in enumerate(like):
        own = torch.from_numpy(np.empty((rows, *row_shape), dtype))
        parts = None
        if primary:
            whole = torch.from_numpy(np.ascontiguousarray(block[k], dtype))
            parts = [p.contiguous() for p in whole.reshape(w, rows, *row_shape).unbind(0)]
        dist.scatter(own, parts, src=0, group=mesh.host_group())
        out.append(own.numpy())
    return out


def gather_rows(own: np.ndarray) -> np.ndarray | None:
    """Every rank's ``own`` rows (the same shape on every rank) joined in rank
    order on rank 0, ``[W·rows, ...]``; None on the other ranks (one gather
    over the host group; ``own`` itself at W = 1)."""
    w = mesh.world_size()
    if w <= 1:
        return own
    t = torch.from_numpy(np.ascontiguousarray(own))
    parts = [torch.empty_like(t) for _ in range(w)] if mesh.process_index() == 0 else None
    dist.gather(t, parts, dst=0, group=mesh.host_group())
    return None if parts is None else torch.cat(parts).numpy()


def gather_json(obj) -> list | None:
    """Every rank's JSON-serializable ``obj`` on rank 0, by rank; None on the
    other ranks (``[obj]`` at W = 1)."""
    w = mesh.world_size()
    if w <= 1:
        return [obj]
    payload = np.frombuffer(json.dumps(obj).encode(), np.uint8)
    sizes = all_gather_host(np.asarray([payload.size], np.int64))[:, 0]
    padded = np.zeros(int(sizes.max()), np.uint8)
    padded[:payload.size] = payload
    joined = gather_rows(padded[None])
    if joined is None:
        return None
    return [json.loads(row[:n].tobytes().decode()) for row, n in zip(joined, sizes)]
