"""S3D-G's plain float32 reference (``s3dg.py``, its layers and weights as
they are) computed so that it fits beside the program at a cell's batch:
the backbone runs stage by stage, each stage under activation
recomputation (``torch.utils.checkpoint``), so a step keeps only the
stages' inputs and one stage's activations at a time. The stem's two
halves are stages of their own, its first half holding the largest maps.
The recomputation folds nothing into the batch-norm running statistics:
they move once a step, as without it. On the meta device (the FLOP count
of ``counts.py``) nothing is recomputed, so the count is ``s3dg``'s.

A configuration with ``"rounding": "bfloat16"`` (set by
``calibrate_rounding.py``, never by a cell) builds the autocast-rounding
reference: the same model, rounded to bfloat16 wherever bf16 autocast
leaves a bfloat16 tensor in the program, with the products accumulated in
float32 as the program's kernels accumulate them:

* each convolution's and linear layer's operands (input, weight, the
  gate's bias) and output;
* each batch norm's output (its input is a convolution's output), its
  statistics and arithmetic in float32;
* the gate's sigmoid and its product with the branch; ReLU, the pools and
  the concatenation of rounded values are exact;
* the pooled feature (the program's mean of a bfloat16 map is bfloat16).

Each rounding also rounds the gradient that flows back through it, as the
program's backward carries bfloat16 gradients of those tensors. Under the
``fp8`` numerics the convolutions and linear layers take float8 operands
(``layers.py``) inside the same rounding.

``"rounding": "float8"`` puts float8 where bfloat16 was: each of those
tensors rounded to e4m3 at one scale a tensor (its largest magnitude at
448), each of their gradients to e5m2, as ``layers.py`` rounds the fp8
operands and gradients. With the ``fp8`` numerics that is the step below
the bfloat16 autocast that the configuration states, every tensor of the
autocast region one precision lower: the precision control.

``"moved": m`` (set by ``calibrate_rounding.py`` too) moves the input
block by ``m`` relative, one fixed draw a shape: at ``m`` = 1e-6, about
what the program's augmentation leaves its block off the reference's
(``block``), it gives another realisation of the same rounding, as far
from the first as the program may be without any fault.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import s3dg
from .layers import (BatchNorm, Conv3d, Linear, Numerics, _Fp8Conv, _fp8_grad,
                     _t3, _to_fp8, max_pool3d)
from .s3dg import CONV_INIT, FEATURE_SIZE, POOLS, SelfGating

__all__ = ["CONV_INIT", "FEATURE_SIZE", "build"]

# ``on`` while a checkpointed stage is recomputed: a thread local, the
# recomputation running on the thread of the backward that needs it
_REPLAY = threading.local()


@contextlib.contextmanager
def _replay():
    outer = getattr(_REPLAY, "on", False)
    _REPLAY.on = True
    try:
        yield
    finally:
        _REPLAY.on = outer


def _contexts():
    return contextlib.nullcontext(), _replay()


def _fp8(x):
    q, scale = _to_fp8(x)
    return q.to(x.dtype) / scale


# rounding -> (the forward's rounding, the gradient's)
_CASTS = {
    "bfloat16": (lambda x: x.to(torch.bfloat16).to(x.dtype),
                 lambda g: g.to(torch.bfloat16).to(g.dtype)),
    "float8": (_fp8, _fp8_grad),
}


class _Round(torch.autograd.Function):
    """x rounded as ``rounding`` says (kept in float32); its gradient
    rounded so too."""

    @staticmethod
    def forward(ctx, x, rounding):
        ctx.rounding = rounding
        return _CASTS[rounding][0](x)

    @staticmethod
    def backward(ctx, g):
        return _CASTS[ctx.rounding][1](g), None


class _Rounded:
    """A module that rounds as its backbone's ``rounding`` says (None: not
    at all)."""

    rounding = None

    def round(self, x):
        if self.rounding is None:
            return x
        return _Round.apply(x, self.rounding)


class _BatchNorm(_Rounded, BatchNorm):
    """The reference's batch norm, its output rounded; in a recomputation
    it normalises alike and folds nothing."""

    def forward(self, x):
        if getattr(_REPLAY, "on", False):
            y = F.batch_norm(x, None, None, self.weight, self.bias,
                             training=True, eps=self.eps)
        else:
            y = super().forward(x)
        return self.round(y)


class _RoundedConv3d(_Rounded, Conv3d):
    def forward(self, x):
        if self.num.name == "fp8":
            y = _Fp8Conv.apply(x, self.weight, _t3(self.stride),
                               _t3(self.padding))
        else:
            y = F.conv3d(self.round(x), self.round(self.weight),
                         stride=self.stride, padding=self.padding)
        return self.round(y)


class _RoundedLinear(_Rounded, Linear):
    def forward(self, x):
        op = self.num.operand if self.num.name == "fp8" else self.round
        return self.round(F.linear(op(x), op(self.weight),
                                   self.round(self.bias)))


class _RoundedGating(_Rounded, SelfGating):
    def forward(self, x):
        w = self.round(torch.sigmoid(self.fc(x.mean(dim=(2, 3, 4)))))
        return self.round(w[:, :, None, None, None] * x)


_ROUNDED = {Conv3d: _RoundedConv3d, Linear: _RoundedLinear,
            SelfGating: _RoundedGating}


class Backbone(s3dg.Backbone):
    """``s3dg.Backbone``'s modules and arithmetic, run stage by stage."""

    def __init__(self, num: Numerics, rounding: str | None = None,
                 moved: float = 0.0):
        super().__init__(num)
        if rounding not in (None, *_CASTS):
            raise ValueError(f"rounding must be one of {sorted(_CASTS)} or "
                             f"absent, got {rounding!r}")
        self.rounding = rounding
        self.moved = moved
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.__class__ = _BatchNorm
            elif rounding is not None and type(m) in _ROUNDED:
                m.__class__ = _ROUNDED[type(m)]
            else:
                continue
            m.rounding = rounding

    def stages(self):
        """The forward as a list of functions of one map each."""
        a = self.Conv_1a
        out = [lambda x: torch.relu(a.bn1(a.conv1(x))),
               lambda x: max_pool3d(torch.relu(a.bn2(a.conv2(x))),
                                    (1, 3, 3), (1, 2, 2), (0, 1, 1)),
               self.Conv_2b, self.Conv_2c]
        for name, pool in POOLS:
            block = getattr(self, name)
            out.append(block if pool is None else
                       (lambda x, b=block, p=pool: b(max_pool3d(x, *p))))
        return out

    def forward(self, x):
        if self.moved and x.device.type != "meta":
            g = torch.Generator(device=x.device).manual_seed(0)
            x = x * (1 + self.moved * torch.randn(
                x.shape, generator=g, device=x.device, dtype=x.dtype))
        for stage in self.stages():
            if x.device.type == "meta":
                x = stage(x)
            else:
                x = checkpoint(stage, x, use_reentrant=False,
                               context_fn=_contexts,
                               preserve_rng_state=False)
        if self.rounding is not None:
            # the pooled feature as the program rounds it; the caller's
            # mean over the remaining unit axes leaves it as it is
            return _Round.apply(x.mean(dim=(2, 3, 4), keepdim=True),
                                self.rounding)
        return x


def build(num: Numerics, cfg: dict) -> Backbone:
    return Backbone(num, cfg.get("rounding"), cfg.get("moved", 0.0))
