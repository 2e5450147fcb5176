"""S3D / S3D-G — separable-Inception video network with optional
self-gating.

Counterpart of the standard form of ``dualvar_tpu/models/backbones/s3dg.py``
(reference backbone/s3dg.py): ``STConv3d`` separable convolutions,
``SepInception`` blocks and, for S3D-G, a ``SelfGating`` on each branch.
Output for (B, 3, 16, 112, 112) is (B, 1024, 2, 3, 3); 7,910,048 parameters
(S3D) and 9,098,000 (S3D-G). Convolutions are drawn from normal(0, 0.01).
Submodule names follow the flax tree (``Conv_1a.{conv1,bn1,conv2,bn2}``,
``Mixed_3b.branch0.{conv,bn}``, ``Mixed_3b.branch1_1.conv1``,
``Mixed_3b.gating_b0.fc``, ...). The JAX package's branch-packed variant
(``s3d_packed``, ``s3dg_packed``) is not ported (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import BatchNorm, Conv3d, max_pool3d, normal_init_

# block name -> out planes [b0, b1a, b1b, b2a, b2b, b3b] (reference
# backbone/s3dg.py:135-217)
MIX_PLANES: dict[str, list[int]] = {
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


def _conv(in_ch, out_ch, kernel_size, stride=1, padding=0) -> nn.Conv3d:
    return normal_init_(Conv3d(in_ch, out_ch, kernel_size, stride=stride,
                               padding=padding, bias=False))


class BasicConv3d(nn.Module):
    """conv (no bias) -> BN -> ReLU (reference s3dg.py:8-28)."""

    def __init__(self, in_ch: int, features: int, kernel_size=1, stride=1,
                 padding=0):
        super().__init__()
        self.conv = _conv(in_ch, features, kernel_size, stride, padding)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class STConv3d(nn.Module):
    """(1,k,k) conv -> BN -> ReLU -> (k,1,1) conv -> BN -> ReLU (reference
    s3dg.py:30-65). An int stride applies to both factors' own axes; a
    tuple (t, s, s) puts t on the temporal factor and s on the spatial."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride=1, padding: int = 0):
        super().__init__()
        if isinstance(stride, (tuple, list)):
            t_stride, s = stride[0], stride[-1]
        else:
            t_stride = s = stride
        k, p = kernel_size, padding
        self.conv1 = _conv(in_ch, features, (1, k, k), (1, s, s), (0, p, p))
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, (k, 1, 1), (t_stride, 1, 1),
                           (p, 0, 0))
        self.bn2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))


class SelfGating(nn.Module):
    """S3D-G feature gating: sigmoid(fc(mean over T, H, W)) * x (reference
    s3dg.py:68-78). The mean of a bfloat16 map is taken in float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = torch.float32 if x.dtype in (torch.bfloat16,
                                           torch.float16) else x.dtype
        w = torch.sigmoid(self.fc(x.mean(dim=(2, 3, 4), dtype=acc)))
        return w[:, :, None, None, None] * x


class SepInception(nn.Module):
    """Four-branch separable Inception block (reference s3dg.py:81-132):
    1x1; 1x1 then separable 3x3; 1x1 then separable 3x3; 3x3x3 max pool
    (stride 1, padding 1) then 1x1; concatenated on channels."""

    def __init__(self, in_ch: int, planes: list[int], gating: bool = False):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = planes
        self.branch0 = BasicConv3d(in_ch, b0)
        self.branch1_0 = BasicConv3d(in_ch, b1a)
        self.branch1_1 = STConv3d(b1a, b1b, 3, padding=1)
        self.branch2_0 = BasicConv3d(in_ch, b2a)
        self.branch2_1 = STConv3d(b2a, b2b, 3, padding=1)
        self.branch3_1 = BasicConv3d(in_ch, b3b)
        self.gating = gating
        if gating:
            for i, ch in enumerate((b0, b1b, b2b, b3b)):
                self.add_module(f"gating_b{i}", SelfGating(ch))
        self.out_channels = b0 + b1b + b2b + b3b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.branch0(x),
                self.branch1_1(self.branch1_0(x)),
                self.branch2_1(self.branch2_0(x)),
                self.branch3_1(max_pool3d(x, 3, 1, 1))]
        if self.gating:
            outs = [getattr(self, f"gating_b{i}")(o)
                    for i, o in enumerate(outs)]
        return torch.cat(outs, dim=1)


# (block, max pool (kernel, stride, padding) before it or None)
_MIXED = (("Mixed_3b", ((1, 3, 3), (1, 2, 2), (0, 1, 1))),
          ("Mixed_3c", None), ("Mixed_4b", (3, 2, 1)), ("Mixed_4c", None),
          ("Mixed_4d", None), ("Mixed_4e", None), ("Mixed_4f", None),
          ("Mixed_5b", (2, 2, 0)), ("Mixed_5c", None))


class S3D(nn.Module):
    """Reference backbone/s3dg.py:135-217 (S3D, and S3D-G with
    ``gating``)."""

    def __init__(self, gating: bool = False):
        super().__init__()
        self.Conv_1a = STConv3d(3, 64, 7, stride=2, padding=3)
        self.Conv_2b = BasicConv3d(64, 64)
        self.Conv_2c = STConv3d(64, 192, 3, padding=1)
        in_ch = 192
        for name, _ in _MIXED:
            block = SepInception(in_ch, MIX_PLANES[name], gating)
            self.add_module(name, block)
            in_ch = block.out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_1a(x)
        x = max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.Conv_2c(self.Conv_2b(x))
        for name, pool in _MIXED:
            if pool is not None:
                x = max_pool3d(x, *pool)
            x = getattr(self, name)(x)
        return x
