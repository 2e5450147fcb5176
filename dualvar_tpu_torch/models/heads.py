"""Projection heads.

Counterpart of ``dualvar_tpu/models/heads.py``. The reference implements the
heads as 1x1x1 Conv3d stacks on the (B, C, 1, 1, 1) pooled feature
(model/simclr.py:164-180); on pooled features that is exactly a Linear
layer, whose default init (U(+-1/sqrt(fan_in)) for weight and bias) is the
one the JAX package copies.
"""

from __future__ import annotations

import torch
from torch import nn


class MLPHead(nn.Module):
    """Linear(feat) -> ReLU -> Linear(out): the nonlinear projection head
    (reference model/simclr.py:167-172 and :176-180)."""

    def __init__(self, feat: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(feat, feat)
        self.fc2 = nn.Linear(feat, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))
