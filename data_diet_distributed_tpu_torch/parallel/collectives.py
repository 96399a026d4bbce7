"""The collectives the port runs across ranks (the all-reduces, reduce-scatters
and all-gathers that XLA inserts from sharding annotations in the JAX package).

Every function sums or gathers over the world group and is a collective:
every rank calls it at the same point with tensors of the same shapes.
Under gloo a CUDA tensor is copied to the host, reduced there and copied
back; the choice is made by the backend's name, so NCCL always takes the
device tensors and a gloo build that lacks a collective on CUDA tensors is
never asked for one.

* ``all_reduce_with_grad``: a SUM whose backward is the SUM of the
  cotangents (the global BatchNorm statistics of ``models/resnet.py``);
* ``all_reduce_flat``, ``reduce_scatter_flat``, ``all_gather_flat``: one
  collective over a flat buffer of many tensors (the gradients and the
  sharded parameters of ``train/state.py``);
* ``sum_float64``: a host float64 vector summed over the host group (the
  per-seed score join of ``ops/scoring.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import mesh


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` goes through the host: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """SUM ``t`` over the ranks in place; returns ``t``."""
    if _staged(t):
        h = t.cpu()
        dist.all_reduce(h)
        t.copy_(h)
    else:
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.clone())


def all_reduce_with_grad(x: torch.Tensor) -> torch.Tensor:
    """``Σ_r x_r`` on every rank, differentiable: each rank's cotangent of its
    ``x_r`` is the sum of every rank's cotangent of the result."""
    return _AllReduceSum.apply(x)


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(buf: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    out, o = [], 0
    for t in like:
        out.append(buf[o:o + t.numel()].view(t.shape))
        o += t.numel()
    return out


def all_reduce_flat(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise SUM over the ranks of each of ``tensors`` (new tensors),
    in one collective."""
    if not tensors:
        return []
    return _unflat(all_reduce_sum_(_flat(tensors)), tensors)


def reduce_scatter_flat(per_rank: list[list[torch.Tensor]]) -> list[torch.Tensor]:
    """``per_rank[r]`` lists the slices destined for rank r (the same shapes on
    every rank); returns this rank's slices summed over the ranks, in one
    collective."""
    if not per_rank[0]:
        return []
    w, r = len(per_rank), mesh.process_index()
    buf = torch.cat([_flat(chunks) for chunks in per_rank])
    n = buf.numel() // w
    if _staged(buf):
        # gloo: the reduce-scatter as an all-reduce of the host buffer and the
        # rank's slice of it (the same sums).
        h = buf.cpu()
        dist.all_reduce(h)
        own = h[r * n:(r + 1) * n].to(buf.device)
    else:
        own = torch.empty(n, dtype=buf.dtype, device=buf.device)
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        scatter(own, buf)
    return _unflat(own, per_rank[r])


def all_gather_flat(own: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    """Every rank's ``own`` tensors (the same shapes on every rank), by rank,
    in one collective."""
    if not own:
        return [[] for _ in range(mesh.world_size())]
    w = mesh.world_size()
    buf = _flat(own)
    out = torch.empty(w * buf.numel(), dtype=buf.dtype, device=buf.device)
    if _staged(buf):
        h = torch.empty(out.shape, dtype=buf.dtype)
        dist.all_gather_into_tensor(h, buf.cpu())
        out.copy_(h)
    else:
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, buf)
    return [_unflat(chunk, own) for chunk in out.view(w, -1)]


def sum_float64(vec: np.ndarray) -> np.ndarray:
    """``vec`` (float64) summed over the ranks, on every rank: one collective
    over the host group. Where each position is nonzero on one rank only, the
    result is bitwise that rank's value whatever the rank order."""
    if mesh.world_size() <= 1:
        return vec
    t = torch.from_numpy(np.ascontiguousarray(vec, np.float64).copy())
    dist.all_reduce(t, group=mesh.host_group())
    return t.numpy()
