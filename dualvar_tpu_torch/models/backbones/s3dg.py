"""S3D / S3D-G — separable-Inception video network with optional
self-gating.

Counterpart of the standard form of ``dualvar_tpu/models/backbones/s3dg.py``
(reference backbone/s3dg.py): ``STConv3d`` separable convolutions,
``SepInception`` blocks and, for S3D-G, a ``SelfGating`` on each branch.
Output for (B, 3, 16, 112, 112) is (B, 1024, 2, 3, 3); 7,910,048 parameters
(S3D) and 9,098,000 (S3D-G). Convolutions are drawn from normal(0, 0.01).
Submodule names follow the flax tree (``Conv_1a.{conv1,bn1,conv2,bn2}``,
``Mixed_3b.branch0.{conv,bn}``, ``Mixed_3b.branch1_1.conv1``,
``Mixed_3b.gating_b0.fc``, ...).

The branch-packed variant (``S3D(packed=True)``; registry ``s3d_packed``
and ``s3dg_packed``) swaps every ``SepInception`` for ``PackedSepInception``:
the same function with the three 1x1 convs over the shared input merged
into one, the two separable branches' convs run as block-diagonal convs
over their concatenated channels, and the batch norms over the
concatenated channels. Its parameters keep the JAX package's layout
(``conv1x1_kernel``, ``spatial_b1_kernel``, ..., ``bn1x1``, ``bn_spatial``,
``bn_temporal``); ``pack_s3d_params`` / ``unpack_s3d_params`` convert
state_dicts between the two layouts exactly.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import (BatchNorm, Conv3d, card_layout, max_pool3d,
                      normal_init_)

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


def _block_diag(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Block-diagonal conv weight [[k1, 0], [0, k2]] over (out, in). Built
    in each forward from the two blocks, as the JAX package builds it, so
    the zero blocks are constants, not parameters: they get no gradient,
    and the extra products are exact zeros."""
    o1, i1 = k1.shape[:2]
    o2, i2 = k2.shape[:2]
    top = torch.cat([k1, k1.new_zeros((o1, i2) + k1.shape[2:])], dim=1)
    bot = torch.cat([k2.new_zeros((o2, i1) + k2.shape[2:]), k2], dim=1)
    return torch.cat([top, bot], dim=0)


def _packed_kernel(out_ch: int, in_ch: int, ksize) -> nn.Parameter:
    """A conv weight (out, in, kt, kh, kw) drawn from normal(0, 0.01)."""
    return nn.Parameter(torch.empty(out_ch, in_ch, *ksize).normal_(0.0, 0.01))


class PackedSepInception(nn.Module):
    """``SepInception`` with its branches packed (JAX
    ``PackedSepInception``): one 1x1 conv to b0 + b1a + b2a channels and one
    batch norm over them; the (1,3,3) convs of branches 1 and 2 as one
    block-diagonal conv and one batch norm; the same for their (3,1,1)
    convs; branch 3 (pool, then 1x1) and the gates as in ``SepInception``.
    Every batch norm is per channel, so the merged ones compute the
    separate ones' values."""

    def __init__(self, in_ch: int, planes: list[int], gating: bool = False):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = planes
        self.planes = tuple(planes)
        self.conv1x1_kernel = _packed_kernel(b0 + b1a + b2a, in_ch, (1, 1, 1))
        self.bn1x1 = BatchNorm(b0 + b1a + b2a)
        self.spatial_b1_kernel = _packed_kernel(b1b, b1a, (1, 3, 3))
        self.spatial_b2_kernel = _packed_kernel(b2b, b2a, (1, 3, 3))
        self.bn_spatial = BatchNorm(b1b + b2b)
        self.temporal_b1_kernel = _packed_kernel(b1b, b1b, (3, 1, 1))
        self.temporal_b2_kernel = _packed_kernel(b2b, b2b, (3, 1, 1))
        self.bn_temporal = BatchNorm(b1b + b2b)
        self.branch3_1 = BasicConv3d(in_ch, b3b)
        self.gating = gating
        if gating:
            for i, ch in enumerate((b0, b1b, b2b, b3b)):
                self.add_module(f"gating_b{i}", SelfGating(ch))
        self.out_channels = b0 + b1b + b2b + b3b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0, _, b1b, _, _, _ = self.planes
        y = torch.relu(self.bn1x1(F.conv3d(x, self.conv1x1_kernel)))
        z = F.conv3d(y[:, b0:], _block_diag(self.spatial_b1_kernel,
                                            self.spatial_b2_kernel),
                     padding=(0, 1, 1))
        z = torch.relu(self.bn_spatial(z))
        w = F.conv3d(z, _block_diag(self.temporal_b1_kernel,
                                    self.temporal_b2_kernel),
                     padding=(1, 0, 0))
        w = torch.relu(self.bn_temporal(w))
        outs = [y[:, :b0], w[:, :b1b], w[:, b1b:],
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
    ``gating``); ``packed`` swaps every ``SepInception`` for
    ``PackedSepInception``."""

    def __init__(self, gating: bool = False, packed: bool = False):
        super().__init__()
        self.Conv_1a = STConv3d(3, 64, 7, stride=2, padding=3)
        self.Conv_2b = BasicConv3d(64, 64)
        self.Conv_2c = STConv3d(64, 192, 3, padding=1)
        in_ch = 192
        for name, _ in _MIXED:
            block = (PackedSepInception if packed else SepInception)(
                in_ch, MIX_PLANES[name], gating)
            self.add_module(name, block)
            in_ch = block.out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_1a(card_layout(x))
        x = max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.Conv_2c(self.Conv_2b(x))
        for name, pool in _MIXED:
            if pool is not None:
                x = max_pool3d(x, *pool)
            x = getattr(self, name)(x)
        return x


# --------------------------------------------------- standard <-> packed

_MIXED_KEY = re.compile(r"^(.*?\b(Mixed_\d[a-z]))\.(.*)$")
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
# packed name <- the standard (branch, module) blocks it concatenates
_PACKED_BNS = {"bn1x1": (("branch0", "bn"), ("branch1_0", "bn"),
                         ("branch2_0", "bn")),
               "bn_spatial": (("branch1_1", "bn1"), ("branch2_1", "bn1")),
               "bn_temporal": (("branch1_1", "bn2"), ("branch2_1", "bn2"))}
_PACKED_KERNELS = {"spatial_b1_kernel": "branch1_1.conv1",
                   "spatial_b2_kernel": "branch2_1.conv1",
                   "temporal_b1_kernel": "branch1_1.conv2",
                   "temporal_b2_kernel": "branch2_1.conv2"}
_CONV1X1 = ("branch0.conv", "branch1_0.conv", "branch2_0.conv")


def _by_block(state: dict) -> tuple[dict, dict]:
    """Split a state_dict into the Mixed blocks' entries, grouped by their
    block's full prefix (``backbone.Mixed_3b``, ...) with the rest of the
    key, and the other entries."""
    blocks: dict[str, dict] = {}
    rest = {}
    for key, val in state.items():
        m = _MIXED_KEY.match(key)
        if m and m.group(2) in MIX_PLANES:
            blocks.setdefault(m.group(1), {})[m.group(3)] = val
        else:
            rest[key] = val
    return blocks, rest


def _widths(planes: list[int]) -> dict[str, list[int]]:
    """Each packed batch norm's split into its standard blocks."""
    b0, b1a, b1b, b2a, b2b, _ = planes
    return {"bn1x1": [b0, b1a, b2a], "bn_spatial": [b1b, b2b],
            "bn_temporal": [b1b, b2b]}


def pack_s3d_params(state: dict[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """A standard S3D / S3D-G state_dict -> the packed layout (exact; keys
    may carry any prefix). The counterpart of the JAX package's
    ``pack_s3d_params``: the 1x1 convs of branches 0, 1 and 2 concatenated
    on the output channels, the separable branches' convs kept as the
    block-diagonal convs' blocks, the batch norms' entries concatenated."""
    blocks, out = _by_block(state)
    for prefix, block in blocks.items():
        block = dict(block)
        packed = {"conv1x1_kernel": torch.cat(
            [block.pop(f"{m}.weight") for m in _CONV1X1], dim=0)}
        for name, module in _PACKED_KERNELS.items():
            packed[name] = block.pop(f"{module}.weight")
        for name, parts in _PACKED_BNS.items():
            for leaf in _BN_LEAVES:
                packed[f"{name}.{leaf}"] = torch.cat(
                    [block.pop(f"{b}.{m}.{leaf}") for b, m in parts])
        packed.update(block)  # branch3_1 and the gates, as they are
        out.update({f"{prefix}.{k}": v for k, v in packed.items()})
    return out


def unpack_s3d_params(state: dict[str, torch.Tensor]
                      ) -> dict[str, torch.Tensor]:
    """A packed S3D / S3D-G state_dict -> the standard layout (exact; the
    inverse of ``pack_s3d_params``)."""
    blocks, out = _by_block(state)
    for prefix, block in blocks.items():
        block = dict(block)
        widths = _widths(MIX_PLANES[prefix.rsplit(".", 1)[-1]])
        std = dict(zip(
            (f"{m}.weight" for m in _CONV1X1),
            block.pop("conv1x1_kernel").split(widths["bn1x1"], dim=0)))
        for name, module in _PACKED_KERNELS.items():
            std[f"{module}.weight"] = block.pop(name)
        for name, parts in _PACKED_BNS.items():
            for leaf in _BN_LEAVES:
                for (b, m), val in zip(parts, block.pop(
                        f"{name}.{leaf}").split(widths[name])):
                    std[f"{b}.{m}.{leaf}"] = val
        std.update(block)
        out.update({f"{prefix}.{k}": v for k, v in std.items()})
    return out
