"""Model zoo registry (counterpart of ``data_diet_distributed_tpu/models/__init__.py``).

WideResNet-28-10 is not ported yet.
"""

from __future__ import annotations

import torch

from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18, ResNet34,
                     ResNet50, ResNet101, ResNet152)
from .tiny import TinyCNN

_REGISTRY = {
    "tiny_cnn": TinyCNN,
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
}


def create_model(arch: str, num_classes: int, half_precision: bool = False,
                 stem: str = "cifar", remat: bool = False) -> torch.nn.Module:
    """A model by name, in eval mode, on the CPU with fp32 parameters;
    ``half_precision`` selects bf16 compute. Move it with
    ``.to(device, memory_format=torch.channels_last)``."""
    if arch not in _REGISTRY:
        raise ValueError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    if remat:
        raise NotImplementedError(
            "model.remat is a training-memory option; the PyTorch port does not "
            "have it yet")
    dtype = torch.bfloat16 if half_precision else torch.float32
    if arch == "tiny_cnn":
        if stem != "cifar":
            raise ValueError(f"arch {arch!r} has no {stem!r} stem variant")
        model = TinyCNN(num_classes=num_classes, dtype=dtype)
    else:
        model = _REGISTRY[arch](num_classes=num_classes, dtype=dtype, stem=stem)
    return model.eval()


def create_model_from_cfg(cfg) -> torch.nn.Module:
    """The one cfg -> model mapping (arch, classes, precision, stem, remat)."""
    return create_model(cfg.model.arch, cfg.model.num_classes,
                        cfg.train.half_precision, stem=cfg.model.stem,
                        remat=cfg.model.remat)


__all__ = [
    "BasicBlock", "BottleneckBlock", "ResNet", "ResNet18", "ResNet34", "ResNet50",
    "ResNet101", "ResNet152", "TinyCNN", "create_model", "create_model_from_cfg",
]
