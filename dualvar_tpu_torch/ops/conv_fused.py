"""3x3x3 stride-1 SAME convolution with its batch-norm statistics: wrapper,
plain version, gradient and launch counter.

Replaces the Pallas kernel ``dualvar_tpu/ops/conv_fused.py:_kernel``
(through ``_fused_fwd`` and ``conv3d_bn_stats``) with the hand-written CUDA
kernel ``csrc/conv_fused.cu``. Same contract as the JAX function, in its
layout:

    x (N, T, H, W, C), w (3, 3, 3, C, Co)
    -> y = conv3d(x, w, stride 1, SAME) in x's dtype (w used in x's dtype,
       float32 accumulation), s1 = sum y, s2 = sum y^2 per output channel in
       float32, taken from y after it is rounded to x's dtype.

A ``channels_last_3d`` ``(N, C, T, H, W)`` map ``.permute(0, 2, 3, 4, 1)``
is this x without a copy.

Bound: operations, ``2*27*C*Co`` an output position (1.78e11 at the R3D
layer-1 shape (16, 16, 56, 56, 64)).

``conv3d_bn_stats_forward`` launches the kernel for CUDA tensors (or raises)
and takes ``conv3d_bn_stats_plain`` only for CPU tensors; its ``.launches``
counts the kernel launches. ``conv3d_bn_stats`` is the differentiable
function: its backward is the JAX package's ``_bwd`` (the statistics'
cotangents folded into dy, then the convolution's own input and weight
gradients, which the JAX package leaves to XLA). Like the JAX package, no
model of the port calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

_THREADS = 256  # kThreads of csrc/conv_fused.cu
_TW, _TC, _CI = 4, 8, 8  # kTW, kTC, kCI
_MAX_SMEM = 232448  # bytes of shared memory a block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ncdhw_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(3, 3, 3, C, Co) -> torch's (Co, C, 3, 3, 3) in ``dtype``."""
    return w.permute(4, 3, 0, 1, 2).to(dtype)


def conv3d_bn_stats_plain(x: torch.Tensor, w: torch.Tensor):
    """The same function in plain PyTorch on any device, the counterpart of
    ``conv3d_bn_stats_xla``: (y, s1, s2)."""
    _check(x, w)
    y = torch.nn.functional.conv3d(
        x.permute(0, 4, 1, 2, 3), _ncdhw_weight(w, x.dtype),
        padding=1).permute(0, 2, 3, 4, 1)
    yf = y.float()
    dims = (0, 1, 2, 3)
    return y, yf.sum(dim=dims), (yf * yf).sum(dim=dims)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3) \
            or w.shape[3] != x.shape[4]:
        raise ValueError(f"x must be (N, T, H, W, C) and w (3, 3, 3, C, Co); "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


def _tiling(W: int, Co: int) -> tuple[int, int, int]:
    """(rows a block, output channels a block, shared-memory bytes): at most
    one 4 x 8 output tile a thread."""
    co_tile = next(t for t in (64, 32, 16, 8) if Co % t == 0)
    nwg = -(-W // _TW)
    ht = 2
    while ht * nwg * (co_tile // _TC) > _THREADS:
        if ht > 1:
            ht = 1
        elif co_tile > _TC:
            co_tile //= 2
        else:
            raise ValueError(f"W={W} is too wide for the kernel's tiling")
    smem = 4 * max(27 * _CI * co_tile + 3 * (ht + 2) * _CI * (nwg * _TW + 2),
                   2 * _THREADS * _TC)
    if smem > _MAX_SMEM:
        raise ValueError(f"W={W}: {smem} bytes of shared memory a block")
    return ht, co_tile, smem


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("conv_fused").conv3d_bn_stats_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_int64, ctypes.c_void_p])
    return fn


def conv3d_bn_stats_forward(x: torch.Tensor, w: torch.Tensor):
    """(y, s1, s2) with no gradient recorded: the kernel for CUDA tensors,
    ``conv3d_bn_stats_plain`` for CPU tensors."""
    _check(x, w)
    if not x.is_cuda:
        with torch.no_grad():
            return conv3d_bn_stats_plain(x, w)
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"x and w must be float32 or bfloat16 on the card, "
                        f"got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous (N, T, H, W, C) and "
                         "(3, 3, 3, C, Co)")
    N, T, H, W, C = x.shape
    Co = w.shape[4]
    if Co % _TC:
        raise ValueError(f"Co={Co}: the kernel takes multiples of {_TC}")
    ht, co_tile, smem = _tiling(W, Co)
    y = torch.empty((N, T, H, W, Co), dtype=x.dtype, device=x.device)
    s1 = torch.empty(Co, dtype=torch.float32, device=x.device)
    s2 = torch.empty(Co, dtype=torch.float32, device=x.device)
    nblk = N * T * -(-H // ht)
    if nblk == 0 or Co == 0:
        return y, s1.zero_(), s2.zero_()
    partial = torch.empty((2, Co, nblk), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), partial.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), _DTYPES[x.dtype], _DTYPES[w.dtype],
            N, T, H, W, C, Co, ht, co_tile, smem,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_bn_stats kernel launch failed: CUDA "
                           f"error {err}")
    conv3d_bn_stats_forward.launches += 1
    return y, s1, s2


conv3d_bn_stats_forward.launches = 0


def conv3d_bn_stats_backward(x, w, y, gy, gs1, gs2):
    """(dx, dw) of ``conv3d_bn_stats`` from its residuals (x, w, y) and the
    cotangents of (y, s1, s2), as ``dualvar_tpu/ops/conv_fused.py:_bwd``:
    dy = gy + gs1 + 2*y*gs2 in x's dtype, then the convolution's
    gradients."""
    dy = (gy.float() + gs1 + 2.0 * y.float() * gs2).to(x.dtype)
    x_t, dy_t = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
    w_t = _ncdhw_weight(w, x.dtype)
    dx = torch.nn.grad.conv3d_input(x_t.shape, w_t, dy_t, padding=1)
    dw = torch.nn.grad.conv3d_weight(x_t, w_t.shape, dy_t, padding=1)
    return dx.permute(0, 2, 3, 4, 1), dw.permute(2, 3, 4, 1, 0).to(w.dtype)


class _Conv3dBNStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        y, s1, s2 = conv3d_bn_stats_forward(x, w)
        ctx.save_for_backward(x, w, y)
        return y, s1, s2

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, gs1, gs2):
        return conv3d_bn_stats_backward(*ctx.saved_tensors, gy, gs1, gs2)


def conv3d_bn_stats(x: torch.Tensor, w: torch.Tensor):
    """(y, s1, s2) = (conv3d_same(x, w), sum y, sum y^2), differentiable in
    x and w. On CUDA tensors the forward is the hand-written kernel."""
    return _Conv3dBNStats.apply(x, w)
