"""Model zoo registry (counterpart of ``data_diet_distributed_tpu/models/__init__.py``)."""

from __future__ import annotations

import torch

from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18, ResNet34,
                     ResNet50, ResNet101, ResNet152)
from .tiny import TinyCNN
from .wideresnet import WideResNet, WideResNet28_10

_REGISTRY = {
    "tiny_cnn": TinyCNN,
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
    "wideresnet28_10": WideResNet28_10,
}


def create_model(arch: str, num_classes: int, half_precision: bool = False,
                 stem: str = "cifar", remat: bool = False) -> torch.nn.Module:
    """A model by name, in eval mode, on the CPU with fp32 parameters;
    ``half_precision`` selects bf16 compute. ``stem`` is a ResNet's input
    geometry (``cifar`` or ``imagenet``); ``remat`` recomputes the blocks'
    activations in training backward passes (ResNets and WideResNet), with
    the same parameter names. Move it with
    ``.to(device, memory_format=torch.channels_last)``."""
    if arch not in _REGISTRY:
        raise ValueError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    dtype = torch.bfloat16 if half_precision else torch.float32
    if arch.startswith("resnet"):
        model = _REGISTRY[arch](num_classes=num_classes, dtype=dtype, stem=stem,
                                remat=remat)
    elif stem != "cifar":
        raise ValueError(f"arch {arch!r} has no {stem!r} stem variant")
    elif arch == "tiny_cnn":
        if remat:
            raise ValueError(f"arch {arch!r} has no remat variant")
        model = TinyCNN(num_classes=num_classes, dtype=dtype)
    else:
        model = _REGISTRY[arch](num_classes=num_classes, dtype=dtype, remat=remat)
    return model.eval()


def create_model_from_cfg(cfg) -> torch.nn.Module:
    """The one cfg -> model mapping (arch, classes, precision, stem, remat)."""
    return create_model(cfg.model.arch, cfg.model.num_classes,
                        cfg.train.half_precision, stem=cfg.model.stem,
                        remat=cfg.model.remat)


__all__ = [
    "BasicBlock", "BottleneckBlock", "ResNet", "ResNet18", "ResNet34", "ResNet50",
    "ResNet101", "ResNet152", "TinyCNN", "WideResNet", "WideResNet28_10",
    "create_model", "create_model_from_cfg",
]
