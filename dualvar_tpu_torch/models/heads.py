"""Projection heads and the linear / finetune classifier.

Counterpart of ``dualvar_tpu/models/heads.py``. The reference implements the
heads as 1x1x1 Conv3d stacks on the (B, C, 1, 1, 1) pooled feature
(model/simclr.py:164-180); on pooled features that is exactly a Linear
layer, whose default init (U(+-1/sqrt(fan_in)) for weight and bias) is the
one the JAX package copies.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm, global_avg_pool3d, l2_normalize


class MLPHead(nn.Module):
    """Linear(feat) -> ReLU -> Linear(out): the nonlinear projection head
    (reference model/simclr.py:167-172 and :176-180)."""

    def __init__(self, feat: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(feat, feat)
        self.fc2 = nn.Linear(feat, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class LinearClassifier(nn.Module):
    """Backbone + global average pool + (L2 norm | final BN | dropout) + FC
    logits (reference model/classifier.py:10-63).

    ``forward(x, generator=None)``: ``x`` (B, T, H, W, C) channels-last, as
    the augmentation gives it -> ``(logits, feat)``, where ``feat`` is the
    pooled float32 feature, after ``l2_normalize`` when ``use_l2_norm``: what
    retrieval consumes (classifier.py:888-890). The backbone runs under the
    caller's autocast; the pooled feature is cast to float32 and the head
    runs in its parameters' type (float32 unless made double) with autocast
    off, as the JAX package keeps it. ``final_bn`` is the port's
    ``BatchNorm`` on (B, C), which folds the biased variance into its
    running variance as flax does.
    Dropout acts in train mode only and draws its mask on the feature's
    device from ``generator``, which must lie on that device.

    Submodules are named after the flax tree: ``backbone``, ``final_bn``,
    ``final_fc``.
    """

    def __init__(self, backbone: nn.Module, feature_size: int,
                 num_class: int = 101, dropout_rate: float = 0.5,
                 use_dropout: bool = True, use_l2_norm: bool = False,
                 use_final_bn: bool = False):
        super().__init__()
        self.backbone = backbone
        self.dropout_rate = dropout_rate
        self.use_dropout = use_dropout
        self.use_l2_norm = use_l2_norm
        if use_final_bn:
            self.final_bn = BatchNorm(feature_size)
        self.use_final_bn = use_final_bn
        self.final_fc = nn.Linear(feature_size, num_class)
        # normal(0, 0.01) weights, zero bias (classifier.py:65-70)
        nn.init.normal_(self.final_fc.weight, 0.0, 0.01)
        nn.init.zeros_(self.final_fc.bias)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        feat = global_avg_pool3d(self.backbone(
            x.permute(0, 4, 1, 2, 3))).float()
        with torch.autocast(device_type=x.device.type, enabled=False):
            if self.use_l2_norm:
                feat = l2_normalize(feat, axis=1)
            # in the head's parameter type, as flax promotes a Dense input
            h = feat.to(self.final_fc.weight.dtype)
            if self.use_final_bn:
                h = self.final_bn(h)
            if self.use_dropout and self.training and self.dropout_rate > 0:
                keep = 1.0 - self.dropout_rate
                mask = torch.rand(h.shape, generator=generator,
                                  device=h.device) < keep
                h = h * mask / keep
            return self.final_fc(h), feat
