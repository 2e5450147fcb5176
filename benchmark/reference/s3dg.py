"""S3D-G (Xie et al., ECCV 2018) as the DualVar reference builds it
(``backbone/s3dg.py``): separable (1,k,k)+(k,1,1) convolutions, each
followed by batch norm and ReLU; nine separable Inception blocks of four
branches (1x1; 1x1 then separable 3x3; the same again; 3x3x3 max pool then
1x1), each branch gated by sigmoid(fc(mean over T, H, W)). Convolutions
start from normal(0, 0.01). Output (N, 1024, T/8, S/32, S/32). Module names
are the port's state-dict keys."""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm, Conv3d, Linear, Numerics, max_pool3d

CONV_INIT = "normal_0.01"
FEATURE_SIZE = 1024

MIX_PLANES = {
    "Mixed_3b": [64, 96, 128, 16, 32, 32],
    "Mixed_3c": [128, 128, 192, 32, 96, 64],
    "Mixed_4b": [192, 96, 208, 16, 48, 64],
    "Mixed_4c": [160, 112, 224, 24, 64, 64],
    "Mixed_4d": [128, 128, 256, 24, 64, 64],
    "Mixed_4e": [112, 144, 288, 32, 64, 64],
    "Mixed_4f": [256, 160, 320, 32, 128, 128],
    "Mixed_5b": [256, 160, 320, 32, 128, 128],
    "Mixed_5c": [384, 192, 384, 48, 128, 128],
}
# each block and the max pool (kernel, stride, padding) before it
POOLS = (("Mixed_3b", ((1, 3, 3), (1, 2, 2), (0, 1, 1))),
         ("Mixed_3c", None), ("Mixed_4b", (3, 2, 1)), ("Mixed_4c", None),
         ("Mixed_4d", None), ("Mixed_4e", None), ("Mixed_4f", None),
         ("Mixed_5b", (2, 2, 0)), ("Mixed_5c", None))


class BasicConv3d(nn.Module):
    def __init__(self, num: Numerics, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3d(num, cin, cout, 1)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class STConv3d(nn.Module):
    def __init__(self, num: Numerics, cin: int, cout: int, k: int, stride=1,
                 padding=0):
        super().__init__()
        self.conv1 = Conv3d(num, cin, cout, (1, k, k), (1, stride, stride),
                            (0, padding, padding))
        self.bn1 = BatchNorm(cout)
        self.conv2 = Conv3d(num, cout, cout, (k, 1, 1), (stride, 1, 1),
                            (padding, 0, 0))
        self.bn2 = BatchNorm(cout)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))


class SelfGating(nn.Module):
    def __init__(self, num: Numerics, channels: int):
        super().__init__()
        self.fc = Linear(num, channels, channels)

    def forward(self, x):
        w = torch.sigmoid(self.fc(x.mean(dim=(2, 3, 4))))
        return w[:, :, None, None, None] * x


class SepInception(nn.Module):
    def __init__(self, num: Numerics, cin: int, planes):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = planes
        self.branch0 = BasicConv3d(num, cin, b0)
        self.branch1_0 = BasicConv3d(num, cin, b1a)
        self.branch1_1 = STConv3d(num, b1a, b1b, 3, padding=1)
        self.branch2_0 = BasicConv3d(num, cin, b2a)
        self.branch2_1 = STConv3d(num, b2a, b2b, 3, padding=1)
        self.branch3_1 = BasicConv3d(num, cin, b3b)
        for i, ch in enumerate((b0, b1b, b2b, b3b)):
            self.add_module(f"gating_b{i}", SelfGating(num, ch))
        self.out_channels = b0 + b1b + b2b + b3b

    def forward(self, x):
        outs = [self.branch0(x), self.branch1_1(self.branch1_0(x)),
                self.branch2_1(self.branch2_0(x)),
                self.branch3_1(max_pool3d(x, 3, 1, 1))]
        return torch.cat([getattr(self, f"gating_b{i}")(o)
                          for i, o in enumerate(outs)], dim=1)


class Backbone(nn.Module):
    def __init__(self, num: Numerics):
        super().__init__()
        self.Conv_1a = STConv3d(num, 3, 64, 7, stride=2, padding=3)
        self.Conv_2b = BasicConv3d(num, 64, 64)
        self.Conv_2c = STConv3d(num, 64, 192, 3, padding=1)
        cin = 192
        for name, _ in POOLS:
            block = SepInception(num, cin, MIX_PLANES[name])
            self.add_module(name, block)
            cin = block.out_channels

    def forward(self, x):
        x = max_pool3d(self.Conv_1a(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.Conv_2c(self.Conv_2b(x))
        for name, pool in POOLS:
            if pool is not None:
                x = max_pool3d(x, *pool)
            x = getattr(self, name)(x)
        return x


def build(num: Numerics, cfg: dict) -> Backbone:
    return Backbone(num)
