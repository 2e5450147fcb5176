"""R(2+1)D (Tran et al., CVPR 2018) as the DualVar reference builds it
(``backbone/r21d.py``): every 3D convolution factored into a (1,k,k)
spatial convolution, batch norm, ReLU and a (k,1,1) temporal convolution,
with the mid width floor(kt*kh*kw*cin*cout / (kh*kw*cin + kt*cout)); a stem
and four stages of ``layer_sizes`` residual blocks of widths 64, 128, 256,
512, the first block of stages 2-4 downsampling by 2 with a factored 1x1x1
shortcut. Output (N, 512, T/8, S/16, S/16). Module names are the port's
state-dict keys."""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import BatchNorm, Conv3d, Numerics

CONV_INIT = "fan_in_uniform"
FEATURE_SIZE = 512


def _t3(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x, x)


class SpatioTemporalConv(nn.Module):
    def __init__(self, num: Numerics, cin: int, cout: int, kernel, stride=1,
                 padding=0):
        super().__init__()
        kt, kh, kw = _t3(kernel)
        st, sh, sw = _t3(stride)
        pt, ph, pw = _t3(padding)
        mid = math.floor(kt * kh * kw * cin * cout / (kh * kw * cin + kt * cout))
        self.spatial_conv = Conv3d(num, cin, mid, (1, kh, kw), (1, sh, sw),
                                   (0, ph, pw))
        self.bn = BatchNorm(mid)
        self.temporal_conv = Conv3d(num, mid, cout, (kt, 1, 1), (st, 1, 1),
                                    (pt, 0, 0))

    def forward(self, x):
        return self.temporal_conv(torch.relu(self.bn(self.spatial_conv(x))))


class ResBlock(nn.Module):
    def __init__(self, num: Numerics, cin: int, cout: int, downsample: bool):
        super().__init__()
        s = 2 if downsample else 1
        self.conv1 = SpatioTemporalConv(num, cin, cout, 3, s, 1)
        self.bn1 = BatchNorm(cout)
        self.conv2 = SpatioTemporalConv(num, cout, cout, 3, 1, 1)
        self.bn2 = BatchNorm(cout)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = SpatioTemporalConv(num, cin, cout, 1, s)
            self.downsample_bn = BatchNorm(cout)

    def forward(self, x):
        res = torch.relu(self.bn1(self.conv1(x)))
        res = self.bn2(self.conv2(res))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(x + res)


class Backbone(nn.Module):
    def __init__(self, num: Numerics, layer_sizes=(1, 1, 1, 1)):
        super().__init__()
        self.conv1 = SpatioTemporalConv(num, 3, 64, (3, 7, 7), (1, 2, 2),
                                        (1, 3, 3))
        self.bn1 = BatchNorm(64)
        self.blocks = []
        cin = 64
        for li, (width, n) in enumerate(zip((64, 128, 256, 512), layer_sizes)):
            for bi in range(n):
                name = f"layer{li + 1}_block{bi}"
                self.add_module(name, ResBlock(num, cin, width,
                                               li > 0 and bi == 0))
                self.blocks.append(name)
                cin = width

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x


def build(num: Numerics, cfg: dict) -> Backbone:
    return Backbone(num, tuple(cfg["layer_sizes"]))
