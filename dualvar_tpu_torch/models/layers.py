"""Shared building blocks for the 3D-CNN video backbones.

Counterpart of ``dualvar_tpu/models/layers.py``. Inside the backbones all
tensors are torch's ``(B, C, T, H, W)``; convolutions are ``nn.Conv3d`` (its
default init is the init the JAX package copies: kaiming-uniform with
a=sqrt(5), i.e. U(+-1/sqrt(fan_in))); S3D and ResNet-2d3d redraw theirs
with ``normal_init_`` and ``kaiming_fan_out_init_``.

The JAX package's space-to-depth stem and phase-split stride-2 data gradient
are rewrites of this same math for another machine; cuDNN convolutions take
their place. Its hand-VJP one-pass batch norm (``_bn_train_fused``) is
``_OnePassBN`` below, taken when ``DUALVAR_BN_STATS=pallas`` selects the
channel-sum kernel for its two reductions; otherwise ATen's batch norm runs,
as the JAX package's default runs its XLA sums.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.bn_stats import channel_sums, use_kernel_stats

Conv3d = nn.Conv3d


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    if x.dim() == 5 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last_3d):
        return torch.channels_last_3d
    return torch.contiguous_format


def _sums(a: torch.Tensor, b: torch.Tensor):
    """Per-channel (sum a, sum a*b) over every axis but 1: the channel-sum
    kernel (its plain version on the CPU), or, for float64 inputs, float64
    torch sums, as the JAX package routes float64 away from its kernel
    (``_use_pallas_stats``)."""
    if a.dtype == torch.float64:
        dims = [d for d in range(a.dim()) if d != 1]
        return a.sum(dim=dims), (a * b).sum(dim=dims)
    return channel_sums(a, b, dim=1)


class _OnePassBN(torch.autograd.Function):
    """Train-mode batch norm core with a hand-written backward, the
    counterpart of ``dualvar_tpu/models/layers.py:_bn_train_fused``:

    forward   s1, s2 = sums(x, x); mu = s1/n; var = max(s2/n - mu^2, 0);
              inv = rsqrt(var + eps); y = x*a + b in x's dtype, with
              a = inv*scale and b = bias - mu*inv*scale;
    backward  s_g, s_gx = sums(g, x); dscale = (s_gx - mu*s_g)*inv;
              dbias = s_g; dx = g*A + x*C + B.

    Returns (y, mu, var); mu and var feed only the running statistics and
    carry no gradient, as under the JAX package's stop_gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        n = x.numel() // x.shape[1]
        s1, s2 = _sums(x, x)
        mu = s1 / n
        var = (s2 / n - mu * mu).clamp_min(0.0)
        inv = torch.rsqrt(var + eps)
        sc = weight.to(acc) * inv
        shape = (1, -1) + (1,) * (x.dim() - 2)
        a = sc.to(x.dtype).view(shape)
        b = (bias.to(acc) - mu * sc).to(x.dtype).view(shape)
        ctx.save_for_backward(x, weight, mu, inv)
        ctx.mark_non_differentiable(mu, var)
        return x * a + b, mu, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _gmu, _gvar):
        x, weight, mu, inv = ctx.saved_tensors
        acc = mu.dtype
        n = x.numel() // x.shape[1]
        g = g.contiguous(memory_format=_memory_format(x))
        s_g, s_gx = _sums(g, x)
        s_gc = s_gx - mu * s_g  # sum g*(x - mu)
        A = inv * weight.to(acc)
        C = -A * inv * inv * s_gc / n
        B = -A * s_g / n - C * mu
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dx = (g * A.to(g.dtype).view(shape) + x * C.to(x.dtype).view(shape)
              + B.to(x.dtype).view(shape))
        return (dx, (s_gc * inv).to(weight.dtype), s_g.to(weight.dtype),
                None)


class BatchNorm(nn.Module):
    """Batch norm over ``(B, T, H, W)`` of a ``(B, C, T, H, W)`` map with the
    JAX package's running-statistics rule.

    Train mode normalises with the biased batch variance (eps 1e-5) like
    every batch norm, but — unlike ``torch.nn.BatchNorm3d``, which folds the
    *unbiased* variance into ``running_var`` — folds the **biased** variance
    into the running variance with weight 0.1, as flax's momentum-0.9 update
    does (``dualvar_tpu/models/layers.py:_FastBN``). After a train step the
    running stats therefore equal the JAX package's.

    Train mode takes ATen's batch norm, or, when ``use_kernel_stats()``
    (``DUALVAR_BN_STATS=pallas``), the one-pass ``_OnePassBN`` whose sums
    come from the channel-sum kernel. The fold is the same on both paths.

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
        stat = self.running_var.dtype
        if use_kernel_stats():
            y, mean, var = _OnePassBN.apply(x, self.weight, self.bias,
                                            self.eps)
            var = var.to(stat)
        else:
            # no running buffers: the fold below is done by hand from the
            # returned batch mean and inverse std (= rsqrt(biased var + eps))
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            with torch.no_grad():
                var = invstd.to(stat).pow(-2) - self.eps
        with torch.no_grad():
            # in place: the buffers are module state, not part of the graph
            self.running_mean.lerp_(mean.to(stat), self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y


def max_pool3d(x: torch.Tensor, kernel_size, stride=None,
               padding=0) -> torch.Tensor:
    """torch.nn.MaxPool3d, which pads with -inf as flax's ``nn.max_pool``
    does in the JAX package's ``layers.max_pool3d``."""
    return torch.nn.functional.max_pool3d(x, kernel_size, stride, padding)


def normal_init_(conv: nn.Conv3d, std: float = 0.01) -> nn.Conv3d:
    """The conv's weight drawn from normal(0, ``std``) (S3D's init)."""
    nn.init.normal_(conv.weight, 0.0, std)
    return conv


def kaiming_fan_out_init_(conv: nn.Conv3d) -> nn.Conv3d:
    """The conv's weight drawn from kaiming normal over its fan-out
    (ResNet-2d3d's init)."""
    nn.init.kaiming_normal_(conv.weight, mode="fan_out",
                            nonlinearity="relu")
    return conv


def global_avg_pool3d(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool3d((1,1,1)): (B, C, T, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3, 4))


def l2_normalize(x: torch.Tensor, axis: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize parity: x / max(||x||, eps)."""
    norm = x.square().sum(dim=axis, keepdim=True).sqrt()
    return x / norm.clamp_min(eps)
