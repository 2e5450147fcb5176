"""Shared building blocks for the 3D-CNN video backbones.

Counterpart of ``dualvar_tpu/models/layers.py``. Inside the backbones all
tensors are torch's ``(B, C, T, H, W)``; convolutions are ``nn.Conv3d`` (its
default init is the init the JAX package copies: kaiming-uniform with
a=sqrt(5), i.e. U(+-1/sqrt(fan_in))).

The JAX package's space-to-depth stem, phase-split stride-2 data gradient and
hand-VJP one-pass BN are rewrites of this same math for another machine;
cuDNN convolutions and the batch-norm below take their place.
"""

from __future__ import annotations

import torch
from torch import nn

Conv3d = nn.Conv3d


class BatchNorm(nn.Module):
    """Batch norm over ``(B, T, H, W)`` of a ``(B, C, T, H, W)`` map with the
    JAX package's running-statistics rule.

    Train mode normalises with the biased batch variance (eps 1e-5) like
    every batch norm, but — unlike ``torch.nn.BatchNorm3d``, which folds the
    *unbiased* variance into ``running_var`` — folds the **biased** variance
    into the running variance with weight 0.1, as flax's momentum-0.9 update
    does (``dualvar_tpu/models/layers.py:_FastBN``). After a train step the
    running stats therefore equal the JAX package's.

    State-dict keys: ``weight``, ``bias``, ``running_mean``, ``running_var``.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return torch.nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps)
        # no running buffers: the fold below is done by hand from the
        # returned batch mean and inverse std (= rsqrt(biased var + eps))
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            stat = self.running_var.dtype
            var = invstd.to(stat).pow(-2) - self.eps
            # in place: the buffers are module state, not part of the graph
            self.running_mean.lerp_(mean.to(stat), self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y


def global_avg_pool3d(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool3d((1,1,1)): (B, C, T, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3, 4))


def l2_normalize(x: torch.Tensor, axis: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize parity: x / max(||x||, eps)."""
    norm = x.square().sum(dim=axis, keepdim=True).sqrt()
    return x / norm.clamp_min(eps)
