"""R(2+1)D — factored spatial+temporal ResNet video backbone.

Counterpart of ``dualvar_tpu/models/backbones/r21d.py`` (reference
backbone/r21d.py): every 3D convolution is factored into a (1,kh,kw) spatial
conv -> BN -> ReLU -> (kt,1,1) temporal conv, with the intermediate channel
count chosen so the pair has about the parameter budget of the dense 3D conv.
Output for (B, 3, 16, 112, 112) is (B, 512, 2, 7, 7); 14,365,303 parameters
at layer_sizes (1,1,1,1).

Submodule names follow the flax tree of the JAX package so weights carry
over mechanically (``core/convert.py``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..layers import BatchNorm, Conv3d


def _triple(x) -> tuple[int, int, int]:
    if isinstance(x, (tuple, list)):
        assert len(x) == 3
        return tuple(x)
    return (x, x, x)


def intermed_channels(in_ch: int, out_ch: int, ks) -> int:
    """Mid width of a factored conv (paper sec. 3.5; reference r21d.py:47-49)."""
    kt, kh, kw = _triple(ks)
    return int(math.floor(
        (kt * kh * kw * in_ch * out_ch) / (kh * kw * in_ch + kt * out_ch)))


class SpatioTemporalConv(nn.Module):
    """(1,kh,kw) conv -> BN -> ReLU -> (kt,1,1) conv (reference r21d.py:11-70)."""

    def __init__(self, in_ch: int, features: int, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        kt, kh, kw = _triple(kernel_size)
        st, sh, sw = _triple(stride)
        pt, ph, pw = _triple(padding)
        mid = intermed_channels(in_ch, features, kernel_size)
        self.spatial_conv = Conv3d(in_ch, mid, (1, kh, kw), stride=(1, sh, sw),
                                   padding=(0, ph, pw), bias=False)
        self.bn = BatchNorm(mid)
        self.temporal_conv = Conv3d(mid, features, (kt, 1, 1),
                                    stride=(st, 1, 1), padding=(pt, 0, 0),
                                    bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.temporal_conv(torch.relu(self.bn(self.spatial_conv(x))))


class ResBlock21d(nn.Module):
    """Residual block of two SpatioTemporalConvs (reference r21d.py:73-122)."""

    def __init__(self, in_ch: int, features: int, downsample: bool = False):
        super().__init__()
        stride = 2 if downsample else 1
        self.conv1 = SpatioTemporalConv(in_ch, features, 3, stride=stride,
                                        padding=1)
        self.bn1 = BatchNorm(features)
        self.conv2 = SpatioTemporalConv(features, features, 3, padding=1)
        self.bn2 = BatchNorm(features)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = SpatioTemporalConv(in_ch, features, 1,
                                                      stride=stride)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = torch.relu(self.bn1(self.conv1(x)))
        res = self.bn2(self.conv2(res))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(x + res)


class R2Plus1DNet(nn.Module):
    """Reference backbone/r21d.py:214-266. ``multi_level`` also returns the
    per-stage feature maps."""

    def __init__(self, layer_sizes: Sequence[int] = (1, 1, 1, 1)):
        super().__init__()
        self.conv1 = SpatioTemporalConv(3, 64, (3, 7, 7), stride=(1, 2, 2),
                                        padding=(1, 3, 3))
        self.bn1 = BatchNorm(64)
        self.stages: list[list[str]] = []
        in_ch = 64
        for li, (width, n_blocks) in enumerate(
                zip((64, 128, 256, 512), layer_sizes)):
            names = []
            for bi in range(n_blocks):
                name = f"layer{li + 1}_block{bi}"
                self.add_module(name, ResBlock21d(
                    in_ch, width, downsample=li > 0 and bi == 0))
                in_ch = width
                names.append(name)
            self.stages.append(names)

    def forward(self, x: torch.Tensor, multi_level: bool = False):
        x = torch.relu(self.bn1(self.conv1(x)))
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        if multi_level:
            return x, feats
        return x
