"""ResNet-2d3d — mixed 2D/3D ResNet (CVRL-style).

Counterpart of ``dualvar_tpu/models/backbones/resnet_2d3d.py`` (reference
backbone/resnet_2d3d.py, ResNet2d3d_full): 2D blocks convolve only
spatially ((1,3,3) kernels); 3D basic blocks use 3x3x3 kernels and 3D
bottlenecks a (3,1,1) temporal conv; every stage strides spatially only,
except a 3D basic block, which takes its stride on all three axes. Stage 4
has 256 planes and its last block no final ReLU. Conv weights are drawn
kaiming normal over the fan-out. r2d3d18 outputs (B, 256, 16, 4, 4) for a
(B, 3, 16, 112, 112) clip with 5,210,176 parameters; r2d3d50 (B, 1024, 16,
4, 4) with 17,401,920 (the reference's registry claims 2048 channels; its
layer 4 gives 256 * 4). Submodule names follow the flax tree (``conv1``,
``bn1``, ``layer{i}_block{j}.{conv1,bn1,...,downsample_conv,
downsample_bn}``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers import (BatchNorm, Conv3d, card_layout, kaiming_fan_out_init_,
                      max_pool3d)


def _conv(in_ch, out_ch, kernel_size, stride=1, padding=0) -> nn.Conv3d:
    return kaiming_fan_out_init_(Conv3d(in_ch, out_ch, kernel_size,
                                        stride=stride, padding=padding,
                                        bias=False))


def _spatial(stride: int) -> tuple[int, int, int]:
    return (1, stride, stride)


class BasicBlock(nn.Module):
    """BasicBlock2d / BasicBlock3d (reference resnet_2d3d.py:45-114)."""

    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 three_d: bool = False, use_final_relu: bool = True,
                 has_downsample: bool = False):
        super().__init__()
        k = 3 if three_d else (1, 3, 3)
        p = 1 if three_d else (0, 1, 1)
        s = stride if three_d else _spatial(stride)
        self.conv1 = _conv(in_ch, features, k, s, p)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, k, 1, p)
        self.bn2 = BatchNorm(features)
        self.use_final_relu = use_final_relu
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = _conv(in_ch, features, 1, s)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        out = x + out
        return torch.relu(out) if self.use_final_relu else out


class Bottleneck(nn.Module):
    """Bottleneck2d / Bottleneck3d (reference resnet_2d3d.py:117-200): a
    (3,1,1) temporal conv (3D) or a 1x1x1 conv (2D), then a (1,3,3) conv
    with the spatial stride, then a 1x1x1 conv to 4x the planes."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 three_d: bool = False, use_final_relu: bool = True,
                 has_downsample: bool = False):
        super().__init__()
        if three_d:
            self.conv1 = _conv(in_ch, features, (3, 1, 1), 1, (1, 0, 0))
        else:
            self.conv1 = _conv(in_ch, features, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, (1, 3, 3), _spatial(stride),
                           (0, 1, 1))
        self.bn2 = BatchNorm(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = BatchNorm(features * 4)
        self.use_final_relu = use_final_relu
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = _conv(in_ch, features * 4, 1,
                                         _spatial(stride))
            self.downsample_bn = BatchNorm(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        out = x + out
        return torch.relu(out) if self.use_final_relu else out


class ResNet2d3d(nn.Module):
    """Reference resnet_2d3d.py:203-269 (ResNet2d3d_full). ``blocks``: four
    ("basic" | "bottleneck", three_d) specs; ``layers``: blocks a stage."""

    def __init__(self, blocks: Sequence[tuple[str, bool]],
                 layers: Sequence[int]):
        super().__init__()
        self.conv1 = _conv(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3))
        self.bn1 = BatchNorm(64)
        self.blocks: list[str] = []
        inplanes = 64
        for li, planes in enumerate((64, 128, 256, 256)):
            kind, three_d = blocks[li]
            cls = BasicBlock if kind == "basic" else Bottleneck
            stride = 1 if li == 0 else 2
            n = layers[li]
            for bi in range(n):
                first = bi == 0
                name = f"layer{li + 1}_block{bi}"
                self.add_module(name, cls(
                    inplanes, planes, stride=stride if first else 1,
                    three_d=three_d,
                    use_final_relu=not (li == 3 and bi == n - 1),
                    has_downsample=first and (
                        stride != 1 or inplanes != planes * cls.expansion)))
                inplanes = planes * cls.expansion
                self.blocks.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(card_layout(x))))
        x = max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x


# the two published configurations (reference resnet_2d3d.py:345-356)
R2D3D18_SPEC = dict(blocks=[("basic", False)] * 4, layers=(2, 2, 2, 2))
R2D3D50_SPEC = dict(
    blocks=[("bottleneck", False), ("bottleneck", False),
            ("bottleneck", True), ("bottleneck", True)],
    layers=(3, 4, 6, 3))
