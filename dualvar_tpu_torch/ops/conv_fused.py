"""3x3x3 stride-1 SAME convolution with its batch-norm statistics: wrapper,
plain version, gradient and launch counters.

Replaces the Pallas kernel ``dualvar_tpu/ops/conv_fused.py:_kernel``
(through ``_fused_fwd`` and ``conv3d_bn_stats``) with the hand-written CUDA
kernels of ``csrc/conv_fused.cu``. Same contract as the JAX function, in its
layout:

    x (N, T, H, W, C), w (3, 3, 3, C, Co)
    -> y = conv3d(x, w, stride 1, SAME) in x's dtype (w used in x's dtype,
       float32 accumulation), s1 = sum y, s2 = sum y^2 per output channel in
       float32, taken from y after it is rounded to x's dtype.

A ``channels_last_3d`` ``(N, C, T, H, W)`` map ``.permute(0, 2, 3, 4, 1)``
is this x without a copy.

Bound: operations, ``2*27*C*Co`` an output position (1.78e11 at the R3D
layer-1 shape (16, 16, 56, 56, 64)).

Routes on the card, by x's dtype (``_route``):

- bfloat16 x with C % 8 == 0 and Co % 8 == 0 (TMA's 16-byte stride rule):
  ``tensor_core_forward``, an implicit GEMM with ``wgmma`` and TMA. The
  weight is packed once a call by ``pack_weight`` into bf16 (27, Co_pad,
  C_pad); TMA's zero fill pads a ragged C and x's borders, Co is padded in
  the packed weight and masked at the store.
- float32 x with Co % 8 == 0: ``cuda_core_forward``, float32 FMAs on the CUDA
  cores (TF32 would break the float32 tolerance).
- anything else raises. No route falls back to another or to the plain
  version.

Each route's wrapper counts its kernel launches in ``.launches``.
``conv3d_bn_stats_forward`` routes CUDA tensors and takes
``conv3d_bn_stats_plain`` only for CPU tensors. ``conv3d_bn_stats`` is the
differentiable function: its backward is the JAX package's ``_bwd`` (the
statistics' cotangents folded into dy, then the convolution's own input and
weight gradients, which the JAX package leaves to XLA). Like the JAX
package, no model of the port calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

# CUDA-core route: kThreads, kTW, kTC, kCI of csrc/conv_fused.cu
_THREADS = 256
_TW, _TC, _CI = 4, 8, 8
# tensor-core route: kTcC, kTcW, kTcCo, kTcRows (channels a K-step, w of a
# band row, output channels a block, output rows a block)
_TC_C, _TC_W, _TC_CO, _TC_ROWS = 64, 64, 64, 8
_MAX_SMEM = 232448  # bytes of shared memory a block may use
_W_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _route(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which kernel takes (x, w) on the card: "tensor_cores" or
    "cuda_cores"; raises on what neither takes."""
    C, Co = x.shape[4], w.shape[4]
    if w.dtype not in _W_DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if x.dtype == torch.bfloat16:
        if C % 8 or Co % 8:
            raise ValueError(f"C={C}, Co={Co}: the bfloat16 kernel takes "
                             "multiples of 8 (16-byte TMA strides)")
        return "tensor_cores"
    if x.dtype == torch.float32:
        if Co % _TC:
            raise ValueError(f"Co={Co}: the float32 kernel takes multiples "
                             f"of {_TC}")
        return "cuda_cores"
    raise TypeError(f"x must be bfloat16 or float32 on the card, got "
                    f"{x.dtype}")


def _tiling(W: int, Co: int) -> tuple[int, int, int]:
    """CUDA-core route: (rows a block, output channels a block, shared-memory
    bytes), at most one 4 x 8 output tile a thread."""
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


def _tc_plan(N: int, T: int, H: int, W: int, C: int,
             Co: int) -> tuple[int, int, int]:
    """Tensor-core route: (64-channel chunks of C, Co padded to the block's
    64 channels, blocks along the positions). A block owns 8 output rows x 64
    w of one (n, t); the grid's second axis is ``Co_pad // 64``."""
    nchunk = -(-C // _TC_C)
    co_pad = -(-Co // _TC_CO) * _TC_CO
    grid_x = N * T * -(-H // _TC_ROWS) * -(-W // _TC_W)
    return nchunk, co_pad, grid_x


def pack_weight(w: torch.Tensor, c_pad: int, co_pad: int,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(3, 3, 3, C, Co) -> (27, co_pad, c_pad) in ``dtype``: tap (dt, dw, dh)
    at index (3 dt + dw) 3 + dh, so the three dh taps of one (dt, dw) are
    adjacent; each output channel's input channels contiguous (the K-major
    operand of the GEMM); zeros past C and Co. 221 KB at C = Co = 64."""
    C, Co = w.shape[3], w.shape[4]
    taps = w.to(dtype).permute(0, 2, 1, 4, 3).reshape(27, Co, C)
    return torch.nn.functional.pad(
        taps, (0, c_pad - C, 0, co_pad - Co)).contiguous()


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = load_library("conv_fused")
    cuda_cores = lib.conv3d_bn_stats_launch
    cuda_cores.restype = ctypes.c_int
    cuda_cores.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                           + [ctypes.c_int64, ctypes.c_void_p])
    tensor_cores = lib.conv3d_bn_stats_tc_launch
    tensor_cores.restype = ctypes.c_int
    tensor_cores.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                             + [ctypes.c_void_p])
    return cuda_cores, tensor_cores


def _outputs(x: torch.Tensor, Co: int):
    """y, s1, s2 to be written by a kernel (every entry of s1, s2 is)."""
    y = torch.empty((*x.shape[:4], Co), dtype=x.dtype, device=x.device)
    s1 = torch.empty(Co, dtype=torch.float32, device=x.device)
    s2 = torch.empty(Co, dtype=torch.float32, device=x.device)
    return y, s1, s2


def _raise_on(err: int, route: str) -> None:
    if err != 0:
        raise RuntimeError(f"conv3d_bn_stats {route} kernel launch failed: "
                           f"error {err} (100000 + n: CUresult n from "
                           "encoding a tensor map)")


def tensor_core_forward(x: torch.Tensor, w: torch.Tensor):
    """The bfloat16 route on the card: (y, s1, s2) from the wgmma kernel.
    x bf16 contiguous, C and Co multiples of 8, x 16-byte aligned."""
    N, T, H, W, C = x.shape
    Co = w.shape[4]
    nchunk, co_pad, grid_x = _tc_plan(N, T, H, W, C, Co)
    y, s1, s2 = _outputs(x, Co)
    if grid_x == 0 or Co == 0:
        return y, s1.zero_(), s2.zero_()
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (TMA)")
    wp = pack_weight(w, nchunk * _TC_C, co_pad)
    partial = torch.empty((2, Co, grid_x), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels()[1](
            x.data_ptr(), wp.data_ptr(), y.data_ptr(), partial.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), N, T, H, W, C, Co, co_pad, nchunk,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "tensor-core")
    tensor_core_forward.launches += 1
    return y, s1, s2


def cuda_core_forward(x: torch.Tensor, w: torch.Tensor):
    """The float32 route on the card: (y, s1, s2) from the CUDA-core
    kernel. x float32 contiguous, Co a multiple of 8."""
    N, T, H, W, C = x.shape
    Co = w.shape[4]
    ht, co_tile, smem = _tiling(W, Co)
    y, s1, s2 = _outputs(x, Co)
    nblk = N * T * -(-H // ht)
    if nblk == 0 or Co == 0:
        return y, s1.zero_(), s2.zero_()
    partial = torch.empty((2, Co, nblk), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels()[0](
            x.data_ptr(), w.data_ptr(), y.data_ptr(), partial.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), _W_DTYPES[w.dtype], N, T, H, W, C,
            Co, ht, co_tile, smem, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "CUDA-core")
    cuda_core_forward.launches += 1
    return y, s1, s2


tensor_core_forward.launches = 0
cuda_core_forward.launches = 0


def conv3d_bn_stats_forward(x: torch.Tensor, w: torch.Tensor):
    """(y, s1, s2) with no gradient recorded: on the card the kernel of x's
    route (see the module docstring), for CPU tensors
    ``conv3d_bn_stats_plain``."""
    _check(x, w)
    if not x.is_cuda:
        with torch.no_grad():
            return conv3d_bn_stats_plain(x, w)
    route = _route(x, w)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous (N, T, H, W, C) and "
                         "(3, 3, 3, C, Co)")
    if route == "tensor_cores":
        return tensor_core_forward(x, w)
    return cuda_core_forward(x, w)


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
