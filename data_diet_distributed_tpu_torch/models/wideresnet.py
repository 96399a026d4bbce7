"""WideResNet (counterpart of ``data_diet_distributed_tpu/models/wideresnet.py``).

Pre-activation wide ResNets (Zagoruyko & Komodakis 2016), WRN-28-10 being
BASELINE config 4's model and the Data Diet paper's headline architecture:
a 3x3 stem of 16 channels, three stages of ``n = (depth - 4) / 6`` blocks of
16k, 32k and 64k channels (stride 2 at the first block of stages 2 and 3),
then BatchNorm, ReLU, global mean pooling and the classifier. Submodules
carry the Flax parameter paths (``stem_conv``, ``WideBlock_5.proj_conv``,
``final_norm``, ``classifier``), so weights port by name. Layout, dtypes and
BatchNorm are the ResNet port's (``resnet.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv2d, Head, batch_norm, remat_block


class WideBlock(nn.Module):
    """Pre-activation wide basic block: BN-ReLU-Conv3x3 twice plus a
    shortcut; the projection branches off the pre-activation ``y``."""

    def __init__(self, c_in: int, filters: int, stride: int):
        super().__init__()
        self.BatchNorm_0 = batch_norm(c_in)
        self.has_proj = stride != 1 or c_in != filters
        if self.has_proj:
            self.proj_conv = Conv2d(c_in, filters, 1, stride=stride, bias=False)
        self.Conv_0 = Conv2d(c_in, filters, 3, stride=stride, padding=1, bias=False)
        self.BatchNorm_1 = batch_norm(filters)
        self.Conv_1 = Conv2d(filters, filters, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(x))
        residual = self.proj_conv(y) if self.has_proj else x
        y = F.relu(self.BatchNorm_1(self.Conv_0(y)))
        return residual + self.Conv_1(y)


class WideResNet(nn.Module):
    """WRN-d-k over NHWC inputs: depth d = 6n + 4, widen factor k. ``forward``
    returns fp32 logits, or ``(logits, features)`` with
    ``capture_features=True``."""

    def __init__(self, depth: int = 28, widen_factor: int = 10, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        if (depth - 4) % 6 != 0:
            raise ValueError("WideResNet depth must be 6n+4")
        n = (depth - 4) // 6
        self.dtype = dtype
        self.remat = remat
        self.stem_conv = Conv2d(3, 16, 3, padding=1, bias=False)
        self.block_names: list[str] = []
        c_in = 16
        for stage, filters in enumerate((16 * widen_factor, 32 * widen_factor,
                                         64 * widen_factor)):
            for block in range(n):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f"WideBlock_{len(self.block_names)}"
                self.add_module(name, WideBlock(c_in, filters, stride))
                self.block_names.append(name)
                c_in = filters
        self.final_norm = batch_norm(c_in)
        self.classifier = Head(c_in, num_classes)

    def forward(self, x: torch.Tensor, capture_features: bool = False):
        x = x.permute(0, 3, 1, 2).to(self.dtype)   # NHWC -> NCHW view, channels_last
        x = self.stem_conv(x)
        for name in self.block_names:
            x = remat_block(getattr(self, name), x, self.remat)
        x = F.relu(self.final_norm(x))
        x = x.mean(dim=(2, 3))
        features = x.float()
        logits = self.classifier(x).float()
        if capture_features:
            return logits, features
        return logits


def WideResNet28_10(num_classes: int = 10, dtype=torch.float32,
                    remat: bool = False) -> WideResNet:
    return WideResNet(depth=28, widen_factor=10, num_classes=num_classes,
                      dtype=dtype, remat=remat)
