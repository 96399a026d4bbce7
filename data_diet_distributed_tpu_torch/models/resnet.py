"""CIFAR-geometry ResNets (counterpart of ``data_diet_distributed_tpu/models/resnet.py``).

The exact geometry of the Flax models: 3x3 stem with no pool (or the 7x7/s2 +
max-pool ImageNet stem), stage widths ``width·2^i`` with strides 1/2/2/2,
symmetric 1-pixel padding on every 3x3 conv (``PAD1``), 1x1 projections with
SAME padding (zero for a 1x1 kernel at any stride), global mean pooling.
Submodules carry the Flax parameter paths (``stem_conv``, ``BasicBlock_3.Conv_1``,
``proj_norm``, ``classifier``), so weights port by name.

``forward`` takes NHWC images and runs channels_last inside. Compute runs in
``dtype`` (bf16 under half precision) while parameters and BatchNorm
statistics stay fp32, as Flax's ``dtype``/``param_dtype``. No op works in
place: the batched-GraNd hooks keep references to layer inputs and outputs.
In train mode BatchNorm follows Flax (``BatchNorm2d``); inside
``global_batch_stats`` its statistics are those of the global batch across
the ranks of the process group. With ``remat`` each block's activations are
recomputed in the backward pass (``remat_block``).
"""

from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Iterator, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import all_reduce_with_grad
from ..parallel.mesh import world_size


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype with fp32 parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype with fp32 parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


_STATS_SINK: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "batch_stats_sink", default=None)


@contextlib.contextmanager
def collect_batch_stats() -> Iterator[dict]:
    """Within the block, every train-mode ``BatchNorm2d`` forward records its
    batch ``(mean, var)`` (fp32, detached) in the yielded dict under the
    module; the running statistics themselves are never written."""
    sink: dict = {}
    token = _STATS_SINK.set(sink)
    try:
        yield sink
    finally:
        _STATS_SINK.reset(token)


@contextlib.contextmanager
def _no_stats_sink() -> Iterator[None]:
    token = _STATS_SINK.set(None)
    try:
        yield
    finally:
        _STATS_SINK.reset(token)


def _remat_contexts():
    """Checkpoint's (forward, recompute) contexts: the recomputed forward
    records no batch statistics, so each layer's reach the sink once."""
    return contextlib.nullcontext(), _no_stats_sink()


_GLOBAL_STATS: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "global_batch_stats", default=False)


@contextlib.contextmanager
def global_batch_stats() -> Iterator[None]:
    """Within the block, train-mode ``BatchNorm2d`` normalizes by the statistics
    of the global batch across the ranks (the JAX package's BatchNorm under a
    data-sharded ``jit``): the training step sets it at W > 1. Train-mode
    scoring does not, so it normalizes by the rank's own rows, as the JAX
    package's ``shard_map`` does."""
    token = _GLOBAL_STATS.set(True)
    try:
        yield
    finally:
        _GLOBAL_STATS.reset(token)


_REMAT_OFF: contextvars.ContextVar[bool] = contextvars.ContextVar("remat_off",
                                                                  default=False)


@contextlib.contextmanager
def no_remat() -> Iterator[None]:
    """Within the block no model rematerializes: ``torch.func`` transforms
    (``grand_vmap``) do not support checkpoint's saved-tensor hooks."""
    token = _REMAT_OFF.set(True)
    try:
        yield
    finally:
        _REMAT_OFF.reset(token)


def remat_block(block: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``block(x)``, with its activations recomputed in the backward pass
    when ``remat`` is on and the call trains with autograd (Flax's
    ``nn.remat``: the same parameters, outputs and gradients, less activation
    memory). Eval-mode and no-grad calls (every scoring pass) run the block
    as it is, so batched GraNd's hooks see each layer once.

    The block runs on the tensors bound to it now, passed to the checkpoint
    as inputs: under ``functional_call`` the recompute happens after the
    call has restored the module's own parameters, which a plain
    ``checkpoint(block, x)`` would silently use."""
    if not (remat and block.training and torch.is_grad_enabled()
            and not _REMAT_OFF.get()):
        return block(x)
    bound = {**dict(block.named_parameters()), **dict(block.named_buffers())}
    names = list(bound)

    def run(x, *tensors):
        return functional_call(block, dict(zip(names, tensors)), (x,))
    return checkpoint(run, x, *bound.values(), use_reentrant=False,
                      preserve_rng_state=False, context_fn=_remat_contexts)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode is Flax's ``BatchNorm``.

    Eval mode is ``nn.BatchNorm2d``'s. In train mode the batch statistics are
    reduced in at least fp32 whatever the input dtype, the variance the biased
    ``E[x²] − E[x]²`` clipped at 0, the output ``(x − mean) · (rsqrt(var + eps)
    · scale) + bias`` in fp32 cast to the input dtype, and gradients flow
    through the statistics. The running statistics are not touched (torch
    would update them in place with the unbiased variance): inside
    ``collect_batch_stats`` the batch statistics go to the sink, from which
    the training step forms Flax's ``m · running + (1 − m) · batch``
    (``flax_momentum``). Outside it (train-mode scoring, ``vmap``) they are
    dropped, as the JAX package drops them.

    Inside ``global_batch_stats`` at W ranks, each rank's per-channel fp32
    ``Σx`` and ``Σx²`` are summed across the ranks (a differentiable
    all-reduce, whose backward sums the cotangents) and divided by the global
    count; the same formula then follows, so every rank normalizes, and
    records, the global batch's statistics."""

    @property
    def flax_momentum(self) -> float:
        """Flax's ``momentum`` (the weight of the old running value)."""
        return 1.0 - self.momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if _GLOBAL_STATS.get() and world_size() > 1:
            n = xf.shape[0] * xf.shape[2] * xf.shape[3] * world_size()
            sums = all_reduce_with_grad(torch.stack([xf.sum(dim=(0, 2, 3)),
                                                     (xf * xf).sum(dim=(0, 2, 3))]))
            mean, mean2 = sums[0] / n, sums[1] / n
        else:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = (xf * xf).mean(dim=(0, 2, 3))
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        sink = _STATS_SINK.get()
        if sink is not None:
            sink[self] = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def batch_norm(channels: int, momentum: float = 0.1) -> BatchNorm2d:
    """Flax ``BatchNorm(momentum=m, epsilon=1e-5)`` is torch momentum ``1 - m``."""
    return BatchNorm2d(channels, eps=1e-5, momentum=momentum)


class BasicBlock(nn.Module):
    """Two 3x3 convs with identity/projection shortcut (expansion 1)."""

    expansion = 1
    #: Name of the BatchNorm closing the residual branch (zero-initialized scale).
    closing_norm = "BatchNorm_1"

    def __init__(self, c_in: int, filters: int, stride: int):
        super().__init__()
        self.Conv_0 = Conv2d(c_in, filters, 3, stride=stride, padding=1, bias=False)
        self.BatchNorm_0 = batch_norm(filters)
        self.Conv_1 = Conv2d(filters, filters, 3, padding=1, bias=False)
        self.BatchNorm_1 = batch_norm(filters)
        self.has_proj = stride != 1 or c_in != filters
        if self.has_proj:
            self.proj_conv = Conv2d(c_in, filters, 1, stride=stride, bias=False)
            self.proj_norm = batch_norm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.proj_norm(self.proj_conv(x)) if self.has_proj else x
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (expansion 4)."""

    expansion = 4
    closing_norm = "BatchNorm_2"

    def __init__(self, c_in: int, filters: int, stride: int):
        super().__init__()
        out = filters * self.expansion
        self.Conv_0 = Conv2d(c_in, filters, 1, bias=False)
        self.BatchNorm_0 = batch_norm(filters)
        self.Conv_1 = Conv2d(filters, filters, 3, stride=stride, padding=1, bias=False)
        self.BatchNorm_1 = batch_norm(filters)
        self.Conv_2 = Conv2d(filters, out, 1, bias=False)
        self.BatchNorm_2 = batch_norm(out)
        self.has_proj = stride != 1 or c_in != out
        if self.has_proj:
            self.proj_conv = Conv2d(c_in, out, 1, stride=stride, bias=False)
            self.proj_norm = batch_norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.proj_norm(self.proj_conv(x)) if self.has_proj else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """CIFAR-style ResNet over NHWC inputs; ``forward`` returns fp32 logits, or
    ``(logits, features)`` with ``capture_features=True``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type,
                 num_classes: int = 10, width: int = 64,
                 dtype: torch.dtype = torch.float32, stem: str = "cifar",
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.stem = stem
        self.remat = remat
        if stem == "imagenet":
            self.stem_conv = Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        elif stem == "cifar":
            self.stem_conv = Conv2d(3, width, 3, padding=1, bias=False)
        else:
            raise ValueError(f"unknown stem {stem!r} (cifar | imagenet)")
        self.stem_norm = batch_norm(width)
        self.block_names: list[str] = []
        c_in = width
        for stage, n_blocks in enumerate(stage_sizes):
            filters = width * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block_cls(c_in, filters, stride))
                self.block_names.append(name)
                c_in = filters * block_cls.expansion
        self.classifier = Linear(c_in, num_classes)

    def forward(self, x: torch.Tensor, capture_features: bool = False):
        x = x.permute(0, 3, 1, 2).to(self.dtype)   # NHWC -> NCHW view, channels_last
        x = F.relu(self.stem_norm(self.stem_conv(x)))
        if self.stem == "imagenet":
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = remat_block(getattr(self, name), x, self.remat)
        x = x.mean(dim=(2, 3))
        features = x.float()
        logits = self.classifier(x).float()
        if capture_features:
            return logits, features
        return logits


def ResNet18(num_classes: int = 10, dtype=torch.float32, stem: str = "cifar",
             remat: bool = False) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes, dtype=dtype,
                  stem=stem, remat=remat)


def ResNet34(num_classes: int = 10, dtype=torch.float32, stem: str = "cifar",
             remat: bool = False) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, num_classes, dtype=dtype,
                  stem=stem, remat=remat)


def ResNet50(num_classes: int = 10, dtype=torch.float32, stem: str = "cifar",
             remat: bool = False) -> ResNet:
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_classes, dtype=dtype,
                  stem=stem, remat=remat)


def ResNet101(num_classes: int = 10, dtype=torch.float32, stem: str = "cifar",
              remat: bool = False) -> ResNet:
    return ResNet((3, 4, 23, 3), BottleneckBlock, num_classes, dtype=dtype,
                  stem=stem, remat=remat)


def ResNet152(num_classes: int = 10, dtype=torch.float32, stem: str = "cifar",
              remat: bool = False) -> ResNet:
    return ResNet((3, 8, 36, 3), BottleneckBlock, num_classes, dtype=dtype,
                  stem=stem, remat=remat)
