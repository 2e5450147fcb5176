"""R3D — full-3D ResNet video backbone.

Counterpart of ``dualvar_tpu/models/backbones/r3d.py`` (reference
backbone/r3d.py, R3DNet with layer_sizes (1,1,1,1)): a (3,7,7) stem with
stride (1,2,2), then four residual stages of 3x3x3 convolutions, stages 2-4
downsampling time and space by 2. Output for (B, 3, 16, 112, 112) is
(B, 512, 2, 7, 7); 14,361,792 parameters.

The stem is the plain convolution and stride-2 blocks convolve with stride 2
on all three axes: the JAX package's space-to-depth stem and phase-split
stride-2 data gradient compute the same functions for another machine.
Submodule names follow the flax tree (``conv1``, ``bn1``,
``layer{i}_block{j}.{conv1,bn1,conv2,bn2,downsample_conv,downsample_bn}``),
so weights carry over mechanically (``core/convert.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers import BatchNorm, Conv3d


class ResBlock3d(nn.Module):
    """conv-bn-relu-conv-bn + identity or downsample, final relu (reference
    backbone/r3d.py:41-89). With ``downsample`` the first conv and the
    shortcut use stride 2 on all three axes."""

    def __init__(self, in_ch: int, features: int, downsample: bool = False):
        super().__init__()
        stride = 2 if downsample else 1
        self.conv1 = Conv3d(in_ch, features, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv3d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = Conv3d(in_ch, features, 1, stride=2,
                                          bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = torch.relu(self.bn1(self.conv1(x)))
        res = self.bn2(self.conv2(res))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(x + res)


class R3DNet(nn.Module):
    """Reference backbone/r3d.py:126-157 (R3DNet)."""

    def __init__(self, layer_sizes: Sequence[int] = (1, 1, 1, 1)):
        super().__init__()
        self.conv1 = Conv3d(3, 64, (3, 7, 7), stride=(1, 2, 2),
                            padding=(1, 3, 3), bias=False)
        self.bn1 = BatchNorm(64)
        self.blocks: list[str] = []
        in_ch = 64
        for li, (width, n_blocks) in enumerate(
                zip((64, 128, 256, 512), layer_sizes)):
            for bi in range(n_blocks):
                name = f"layer{li + 1}_block{bi}"
                self.add_module(name, ResBlock3d(
                    in_ch, width, downsample=li > 0 and bi == 0))
                in_ch = width
                self.blocks.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x
