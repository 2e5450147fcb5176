"""Plain float32 building blocks of the reference models.

Batch norm here is the DualVar port's rule, written out: train mode
normalises with the biased batch variance (eps 1e-5) and folds the batch
mean and the *biased* variance into the running statistics with weight
0.1 (flax's momentum-0.9 update). Convolutions carry no bias; linear layers
do.

``Numerics`` says in which precision the products run. ``'float32'`` is the
reference. ``'fp8'`` rounds both operands of every convolution and linear
layer to float8 e4m3 with one scale a tensor (its largest magnitude mapped
to 448) before the float32 product, and a convolution's output gradient to
float8 e5m2 before its backward products: the precision control, the step
below the bfloat16 that the configuration states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # float8 e4m3, the operands
FP8_GRAD_MAX = 57344.0  # float8 e5m2, the gradients


class Numerics:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"numerics must be float32 or fp8, got {name!r}")
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "float32" else _Fp8.apply(x)


class _Fp8(torch.autograd.Function):
    """x rounded to float8 e4m3 at one scale for the tensor; the gradient
    passes straight through."""

    @staticmethod
    def forward(ctx, x):
        scale = FP8_MAX / x.abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    @staticmethod
    def backward(ctx, g):
        return g


def _t3(v):
    return list(v) if isinstance(v, (tuple, list)) else [v] * 3


def _to_fp8(x, dtype=torch.float8_e4m3fn, top=FP8_MAX):
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype), scale


def _fp8_grad(g):
    q, s = _to_fp8(g, torch.float8_e5m2, FP8_GRAD_MAX)
    return q.float() / s


class _Fp8Conv(torch.autograd.Function):
    """conv3d of x and w each rounded to float8 e4m3 (one scale a tensor),
    the product in float32; the backward rounds the output's gradient to
    float8 e5m2 and takes the rounded operands (kept as float8), the
    gradient passing straight through the operands' rounding."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        qx, sx = _to_fp8(x)
        qw, sw = _to_fp8(w)
        ctx.save_for_backward(qx, sx, qw, sw)
        ctx.conf = (stride, padding, x.requires_grad)
        return F.conv3d(qx.float() / sx, qw.float() / sw, stride=stride,
                        padding=padding)

    @staticmethod
    def backward(ctx, g):
        qx, sx, qw, sw = ctx.saved_tensors
        stride, padding, need_x = ctx.conf
        gx, gw, _ = torch.ops.aten.convolution_backward(
            _fp8_grad(g), qx.float() / sx, qw.float() / sw, None, stride, padding,
            [1, 1, 1], False, [0, 0, 0], 1, [need_x, True, False])
        return gx, gw, None, None


class Conv3d(nn.Module):
    def __init__(self, num: Numerics, cin: int, cout: int, kernel, stride=1,
                 padding=0):
        super().__init__()
        k = tuple(kernel) if isinstance(kernel, (tuple, list)) else (kernel,) * 3
        self.num, self.stride, self.padding = num, stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, *k))

    def forward(self, x):
        if self.num.name == "fp8":
            return _Fp8Conv.apply(x, self.weight, _t3(self.stride),
                                  _t3(self.padding))
        return F.conv3d(x, self.weight, stride=self.stride,
                        padding=self.padding)


class Linear(nn.Module):
    def __init__(self, num: Numerics, cin: int, cout: int):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.linear(self.num.operand(x), self.num.operand(self.weight),
                        self.bias)


class BatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=[0, 2, 3, 4], correction=0)
            self.running_mean += self.momentum * (mean - self.running_mean)
            self.running_var += self.momentum * (var - self.running_var)
        # normalised by the batch's mean and biased variance
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


def init_rule(module: nn.Module, leaf: str, conv_init: str):
    """How a leaf of ``module`` starts: ('uniform', bound), ('normal', std)
    or ('const', value). ``conv_init`` is the backbone's published rule for
    its convolutions: 'fan_in_uniform' (PyTorch's default, U(+-1/sqrt(fan
    in))) or 'normal_0.01'."""
    if isinstance(module, BatchNorm):
        return ("const", 1.0 if leaf in ("weight", "running_var") else 0.0)
    if isinstance(module, Linear):
        return ("uniform", 1.0 / math.sqrt(module.weight.shape[1]))
    if isinstance(module, Conv3d):
        if conv_init == "normal_0.01":
            return ("normal", 0.01)
        fan_in = module.weight[0].numel()
        return ("uniform", 1.0 / math.sqrt(fan_in))
    raise TypeError(f"no init rule for {type(module).__name__}.{leaf}")


def max_pool3d(x, kernel, stride, padding=0):
    return F.max_pool3d(x, kernel, stride, padding)
