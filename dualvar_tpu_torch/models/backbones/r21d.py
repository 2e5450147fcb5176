"""R(2+1)D — factored spatial+temporal ResNet video backbone.

Counterpart of ``dualvar_tpu/models/backbones/r21d.py`` (reference
backbone/r21d.py): every 3D convolution is factored into a (1,kh,kw) spatial
conv -> BN -> ReLU -> (kt,1,1) temporal conv, with the intermediate channel
count chosen so the pair has about the parameter budget of the dense 3D conv.
Output for (B, 3, 16, 112, 112) is (B, 512, 2, 7, 7); 14,365,303 parameters
at layer_sizes (1,1,1,1).

``mid_mode`` gives the registry's two variants of the mid width (JAX
``intermed_channels``): ``'tile128'`` (``r21d_tiled``) snaps it to a
non-zero multiple of 128, a different network; ``'pad128'``
(``r21d_pad128``) keeps the formula width as the logical block and pads
the physical width up to the next multiple of 128 with channels that are
zero and stay zero through training (see ``SpatioTemporalConv``), so it
computes the formula network's function. ``embed_formula_state`` loads an
``r21d`` state into an ``r21d_pad128`` model.

Submodule names follow the flax tree of the JAX package so weights carry
over mechanically (``core/convert.py``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..layers import BatchNorm, Conv3d, card_layout


def _triple(x) -> tuple[int, int, int]:
    if isinstance(x, (tuple, list)):
        assert len(x) == 3
        return tuple(x)
    return (x, x, x)


MID_MODES = ("formula", "tile128", "pad128")


def intermed_channels(in_ch: int, out_ch: int, ks,
                      mid_mode: str = "formula") -> int:
    """Mid width of a factored conv (paper sec. 3.5; reference
    r21d.py:47-49): the formula's, snapped to the nearest non-zero multiple
    of 128 under ``'tile128'``, padded up to the next multiple of 128 under
    ``'pad128'``. The formula's widths 83/144/230/460/921 become
    128/128/256/512/896 and 128/256/256/512/1024."""
    kt, kh, kw = _triple(ks)
    mid = int(math.floor(
        (kt * kh * kw * in_ch * out_ch) / (kh * kw * in_ch + kt * out_ch)))
    if mid_mode == "tile128":
        return max(128, round(mid / 128) * 128)
    if mid_mode == "pad128":
        return -(-mid // 128) * 128
    if mid_mode != "formula":
        raise ValueError(f"mid_mode must be one of {MID_MODES}, "
                         f"got {mid_mode!r}")
    return mid


class SpatioTemporalConv(nn.Module):
    """(1,kh,kw) conv -> BN -> ReLU -> (kt,1,1) conv (reference r21d.py:11-70).

    Under ``mid_mode='pad128'`` the mid channels past the formula's
    ``logical`` width are a pad block: the spatial conv's output channels
    and the temporal conv's input rows there start at zero, and the temporal
    conv's init bound is taken from the logical fan-in (``kt * logical``), as
    the formula network draws it. A pad channel's map is then exactly 0, its
    batch norm maps 0 to its bias 0, and every gradient into the block is a
    sum of exact zeros, so SGD with momentum and weight decay keeps it zero
    (the pad's batch-norm scale and running variance move, but multiply
    zeros)."""

    def __init__(self, in_ch: int, features: int, kernel_size, stride=1,
                 padding=0, mid_mode: str = "formula"):
        super().__init__()
        kt, kh, kw = _triple(kernel_size)
        st, sh, sw = _triple(stride)
        pt, ph, pw = _triple(padding)
        mid = intermed_channels(in_ch, features, kernel_size, mid_mode)
        self.spatial_conv = Conv3d(in_ch, mid, (1, kh, kw), stride=(1, sh, sw),
                                   padding=(0, ph, pw), bias=False)
        self.bn = BatchNorm(mid)
        self.temporal_conv = Conv3d(mid, features, (kt, 1, 1),
                                    stride=(st, 1, 1), padding=(pt, 0, 0),
                                    bias=False)
        self.logical = intermed_channels(in_ch, features, kernel_size)
        if mid_mode == "pad128":
            bound = 1.0 / math.sqrt(kt * self.logical)
            with torch.no_grad():
                self.temporal_conv.weight.uniform_(-bound, bound)
                self.spatial_conv.weight[self.logical:] = 0
                self.temporal_conv.weight[:, self.logical:] = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.temporal_conv(torch.relu(self.bn(self.spatial_conv(x))))


class ResBlock21d(nn.Module):
    """Residual block of two SpatioTemporalConvs (reference r21d.py:73-122)."""

    def __init__(self, in_ch: int, features: int, downsample: bool = False,
                 mid_mode: str = "formula"):
        super().__init__()
        stride = 2 if downsample else 1
        self.conv1 = SpatioTemporalConv(in_ch, features, 3, stride=stride,
                                        padding=1, mid_mode=mid_mode)
        self.bn1 = BatchNorm(features)
        self.conv2 = SpatioTemporalConv(features, features, 3, padding=1,
                                        mid_mode=mid_mode)
        self.bn2 = BatchNorm(features)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = SpatioTemporalConv(
                in_ch, features, 1, stride=stride, mid_mode=mid_mode)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = torch.relu(self.bn1(self.conv1(x)))
        res = self.bn2(self.conv2(res))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(x + res)


class R2Plus1DNet(nn.Module):
    """Reference backbone/r21d.py:214-266. ``multi_level`` also returns the
    per-stage feature maps. ``mid_mode``: see ``intermed_channels``."""

    def __init__(self, layer_sizes: Sequence[int] = (1, 1, 1, 1),
                 mid_mode: str = "formula"):
        super().__init__()
        self.conv1 = SpatioTemporalConv(3, 64, (3, 7, 7), stride=(1, 2, 2),
                                        padding=(1, 3, 3), mid_mode=mid_mode)
        self.bn1 = BatchNorm(64)
        self.stages: list[list[str]] = []
        in_ch = 64
        for li, (width, n_blocks) in enumerate(
                zip((64, 128, 256, 512), layer_sizes)):
            names = []
            for bi in range(n_blocks):
                name = f"layer{li + 1}_block{bi}"
                self.add_module(name, ResBlock21d(
                    in_ch, width, downsample=li > 0 and bi == 0,
                    mid_mode=mid_mode))
                in_ch = width
                names.append(name)
            self.stages.append(names)

    def forward(self, x: torch.Tensor, multi_level: bool = False):
        x = torch.relu(self.bn1(self.conv1(card_layout(x))))
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        if multi_level:
            return x, feats
        return x


def embed_formula_state(src: dict[str, torch.Tensor],
                        dst: dict[str, torch.Tensor]
                        ) -> dict[str, torch.Tensor]:
    """An ``r21d`` state_dict (``src``, weights and running statistics)
    embedded into the shapes of an ``r21d_pad128`` one (``dst``; only its
    keys, shapes and types are read): entries of equal shape are copied;
    a mid-width entry gets ``src`` as its logical block and a pad block of
    zeros, or of ones for a batch norm's ``weight`` and ``running_var`` (the
    pad128 init; any pad value gives the same function, the pad maps being
    zero). The state_dict counterpart of the JAX ``embed_formula_tree``;
    keys may carry any prefix (``backbone.``, ``encoder_q.backbone.``)."""
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"key mismatch: absent from src {missing[:5]}, "
                       f"not in dst {extra[:5]}")
    out = {}
    for key, want in dst.items():
        leaf = src[key]
        if tuple(leaf.shape) == tuple(want.shape):
            out[key] = leaf.to(want.dtype).clone()
            continue
        if leaf.dim() != want.dim() or any(
                s > w for s, w in zip(leaf.shape, want.shape)):
            raise ValueError(f"{key}: src {tuple(leaf.shape)} does not fit "
                             f"in dst {tuple(want.shape)}")
        one = leaf.dim() == 1 and key.rsplit(".", 1)[-1] in (
            "weight", "running_var")
        block = torch.full(want.shape, 1.0 if one else 0.0, dtype=want.dtype)
        block[tuple(slice(0, s) for s in leaf.shape)] = leaf
        out[key] = block
    return out


def pad_blocks(model: nn.Module) -> dict[str, tuple]:
    """Where the pad blocks of ``model``'s ``pad128`` SpatioTemporalConvs
    lie: name of a parameter or buffer (as in ``model.state_dict()``) ->
    the index of its block. The spatial conv's output channels and the
    temporal conv's input rows past the logical width, and the mid batch
    norm's bias and running mean there: zero at init, and zero after any
    number of SGD steps with momentum and weight decay, as are their
    momentum buffers. Empty for the other mid modes."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, SpatioTemporalConv) and \
                m.logical < m.spatial_conv.out_channels:
            pad = slice(m.logical, None)
            out[f"{name}.spatial_conv.weight"] = (pad,)
            out[f"{name}.temporal_conv.weight"] = (slice(None), pad)
            out[f"{name}.bn.bias"] = (pad,)
            out[f"{name}.bn.running_mean"] = (pad,)
    return out
