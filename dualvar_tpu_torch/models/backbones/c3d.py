"""C3D — plain five-stage 3D CNN with batch norm.

Counterpart of ``dualvar_tpu/models/backbones/c3d.py`` (reference
backbone/c3d.py): 3x3x3 convolutions with biases, each followed by batch
norm and ReLU, and max pooling between the stages (the first pool spatial
only). Output for (B, 3, 16, 112, 112) is (B, 512, 2, 7, 7); 27,661,440
parameters. Submodule names follow the flax tree (``conv1``, ``bn1``, ...,
``conv5b``, ``bn5b``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import BatchNorm, Conv3d, card_layout, max_pool3d

# (name, output channels) in order; a pool follows the names in _POOL_AFTER
_STAGES = (("1", 64), ("2", 128), ("3a", 256), ("3b", 256), ("4a", 512),
           ("4b", 512), ("5a", 512), ("5b", 512))
_POOL_AFTER = {"1": ((1, 2, 2), (1, 2, 2)), "2": (2, 2), "3b": (2, 2),
               "4b": (2, 2)}


class C3D(nn.Module):
    """Reference backbone/c3d.py:9-83."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        for name, ch in _STAGES:
            self.add_module(f"conv{name}", Conv3d(in_ch, ch, 3, padding=1))
            self.add_module(f"bn{name}", BatchNorm(ch))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = card_layout(x)
        for name, _ in _STAGES:
            conv, bn = getattr(self, f"conv{name}"), getattr(self, f"bn{name}")
            x = torch.relu(bn(conv(x)))
            if name in _POOL_AFTER:
                x = max_pool3d(x, *_POOL_AFTER[name])
        return x
