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
layer-1 shape (16, 16, 56, 56, 64)): on the bf16 tensor cores for bf16 x,
three times that on the TF32 tensor cores for float32 x.

Routes on the card, by x's dtype (``_route``):

- bfloat16 x with C % 8 == 0 and Co % 8 == 0 (TMA's 16-byte stride rule):
  ``tensor_core_forward``, an implicit GEMM with ``wgmma`` and TMA. The
  weight is packed once a call by ``pack_weight`` into bf16 (27, Co_pad,
  C_pad); TMA's zero fill pads a ragged C and x's borders, Co is padded in
  the packed weight and masked at the store.
- float32 x with C % 4 == 0 and Co % 8 == 0 (TMA's 16-byte strides):
  ``split_tf32_forward``, the same implicit GEMM in split TF32 (3xTF32):
  x = x_hi + x_lo and w = w_hi + w_lo, each part a tf32 number
  (``_tf32``: nearest, ties away from zero), and y accumulates x_lo w_hi +
  x_hi w_lo + x_hi w_hi in float32 on the tensor cores. That keeps about 22
  bits of each product, float32's accuracy against a float32 conv; one TF32
  product (x_hi w_hi alone) keeps 11, which over K = 27 C = 1728 terms puts
  y some 1e-3 off, ten times the float32 tolerance. The weight is split and
  packed once a call by ``pack_weight_split`` (54, Co_pad, C_pad): hi taps,
  then lo taps, each 32-channel chunk in the kernel's K order
  (``_f32_k_order``); x is split in the kernel's registers.
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

# float32 route: kFC, kFW, kFCo, kFRows, kFSmem of csrc/conv_fused.cu
# (channels a K-step, w of a box row, output channels a block, output rows a
# block, dynamic shared memory: two stages of a 6-row box and 3 taps' hi and
# lo weights, 96 KB each)
_F32_C, _F32_W, _F32_CO, _F32_ROWS = 32, 64, 64, 4
_F32_SMEM = 2 * ((_F32_ROWS + 2) * _F32_W + 6 * _F32_CO) * _F32_C * 4 + 1024
# bfloat16 route: kTcC, kTcW, kTcCo, kTcRows (channels a K-step, w of a
# band row, output channels a block, output rows a block)
_TC_C, _TC_W, _TC_CO, _TC_ROWS = 64, 64, 64, 8
_MAX_SMEM = 232448  # bytes of shared memory a block may use
_W_DTYPES = (torch.float32, torch.bfloat16)


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
    """Which kernel takes (x, w) on the card: "tensor_cores" (bf16) or
    "split_tf32" (float32); raises on what neither takes."""
    C, Co = x.shape[4], w.shape[4]
    if w.dtype not in _W_DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if x.dtype == torch.bfloat16:
        if C % 8 or Co % 8:
            raise ValueError(f"C={C}, Co={Co}: the bfloat16 kernel takes "
                             "multiples of 8 (16-byte TMA strides)")
        return "tensor_cores"
    if x.dtype == torch.float32:
        if C % 4 or Co % 8:
            raise ValueError(f"C={C}, Co={Co}: the float32 kernel takes C a "
                             "multiple of 4 and Co of 8 (16-byte TMA "
                             "strides)")
        return "split_tf32"
    raise TypeError(f"x must be bfloat16 or float32 on the card, got "
                    f"{x.dtype}")


def _f32_plan(N: int, T: int, H: int, W: int, C: int,
              Co: int) -> tuple[int, int, int]:
    """float32 route: (32-channel chunks of C, Co padded to the block's 64
    channels, blocks along the positions). A block owns 4 output rows x 64
    w of one (n, t); the grid's second axis is ``Co_pad // 64``."""
    nchunk = -(-C // _F32_C)
    co_pad = -(-Co // _F32_CO) * _F32_CO
    grid_x = N * T * -(-H // _F32_ROWS) * -(-W // _F32_W)
    return nchunk, co_pad, grid_x


def _f32_k_order(device=None) -> torch.Tensor:
    """The float32 kernel's K order inside a 32-channel chunk: packed
    position 8 k + j (K-step k of 8, wgmma column j) holds channel 8 (j % 4)
    + 2 k + j // 4, the channel a thread's 16-byte load of x puts in that
    column. Made on ``device`` (no host copy: a CUDA graph may capture
    it)."""
    q = torch.arange(_F32_C, device=device)
    return 8 * (q % 8 % 4) + 2 * (q // 8) + q % 8 // 4


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """The tf32 number nearest to each float32 of ``v`` (ties away from
    zero), the bit rule of the kernel's ``tf32_rna``."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (tf32(v), tf32(v - hi)), float32 tensors of tf32 numbers:
    hi + lo is v within about 2**-22 of |v|."""
    hi = _tf32(v)
    return hi, _tf32(v - hi)


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


def pack_weight_split(w: torch.Tensor, c_pad: int,
                      co_pad: int) -> torch.Tensor:
    """(3, 3, 3, C, Co) -> (54, co_pad, c_pad) float32 for the float32
    route: ``pack_weight``'s taps of ``split_tf32(w)``'s hi parts, then of
    its lo parts, the channels of each 32-channel chunk in ``_f32_k_order``.
    884 KB at C = Co = 64."""
    hi, lo = split_tf32(w.float())
    idx = (torch.arange(0, c_pad, _F32_C, device=w.device)[:, None]
           + _f32_k_order(w.device)).reshape(-1)
    taps = torch.cat([pack_weight(p, c_pad, co_pad, torch.float32)
                      for p in (hi, lo)])
    return taps.index_select(2, idx).contiguous()


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = load_library("conv_fused")
    fns = (lib.conv3d_bn_stats_f32_launch, lib.conv3d_bn_stats_tc_launch)
    for fn in fns:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
    return fns


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


def split_tf32_forward(x: torch.Tensor, w: torch.Tensor):
    """The float32 route on the card: (y, s1, s2) from the split-TF32
    wgmma kernel. x float32 contiguous, C a multiple of 4 and Co of 8, x
    16-byte aligned."""
    N, T, H, W, C = x.shape
    Co = w.shape[4]
    nchunk, co_pad, grid_x = _f32_plan(N, T, H, W, C, Co)
    y, s1, s2 = _outputs(x, Co)
    if grid_x == 0 or Co == 0:
        return y, s1.zero_(), s2.zero_()
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (TMA)")
    wp = pack_weight_split(w, nchunk * _F32_C, co_pad)
    partial = torch.empty((2, Co, grid_x), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels()[0](
            x.data_ptr(), wp.data_ptr(), y.data_ptr(), partial.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), N, T, H, W, C, Co, co_pad, nchunk,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "split-TF32")
    split_tf32_forward.launches += 1
    return y, s1, s2


tensor_core_forward.launches = 0
split_tf32_forward.launches = 0


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
    return split_tf32_forward(x, w)


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
