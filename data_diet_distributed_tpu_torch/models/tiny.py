"""A small ConvNet for tests (counterpart of ``data_diet_distributed_tpu/models/tiny.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv2d, Head, batch_norm


class TinyCNN(nn.Module):
    """Two 3x3/s2 conv-BN-ReLU layers, mean pooling, a linear head. NHWC in."""

    def __init__(self, num_classes: int = 10, width: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        chans = (3, width, width * 2)
        for i in range(2):
            self.add_module(f"Conv_{i}", Conv2d(chans[i], chans[i + 1], 3, stride=2,
                                                padding=1, bias=False))
            # Flax momentum 0.5 (fast-converging stats for tiny test runs).
            self.add_module(f"BatchNorm_{i}", batch_norm(chans[i + 1], momentum=0.5))
        self.classifier = Head(width * 2, num_classes)

    def forward(self, x: torch.Tensor, capture_features: bool = False):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(2):
            x = getattr(self, f"Conv_{i}")(x)
            x = getattr(self, f"BatchNorm_{i}")(x)
            x = F.relu(x)
        x = x.mean(dim=(2, 3))
        features = x.float()
        logits = self.classifier(x).float()
        if capture_features:
            return logits, features
        return logits
