"""Fused clip augmentation: wrapper, plain version and launch counter.

Replaces the Pallas kernel ``dualvar_tpu/ops/aug_fused.py:_aug_kernel`` with
the hand-written CUDA kernel ``csrc/aug_fused.cu`` (one block per frame, see
the source for the design). Same contract as the JAX ``aug_fused``:

    clips_u8 (N, 3, T, S, S) uint8 planar clips (already cropped)
    orders   (N, 4) int32   jitter op-order permutations of 0..3
                            [brightness, contrast, saturation, hue]
    factors  (N, 4) float32 clip-consistent factors, identity-folded for
                            no-apply clips
    blur     (N, 2) float32 (sigma, on > 0)
    ->       (N, 3, T, S, S) ``out_dtype`` (float32 or bfloat16)

The chain: u8 -> f32 / 255; the four colour ops in the clip's own order;
gated separable 13-tap Gaussian blur with edge replication; ImageNet
normalise; cast. All randomness is drawn outside and passed in.

Bound: bytes. Per clip the function reads 3*T*S*S bytes and writes
3*T*S*S*sizeof(out): 0.60 MB + 2.41 MB (f32 out) or 1.20 MB (bf16 out) at
T=16, S=112. The train step launches it once.

``aug_fused`` launches the kernel for CUDA tensors (or raises) and takes
``aug_fused_plain`` only for CPU tensors; ``aug_fused.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..aug import functional as F
from .build import load_library

_TAPS = 13  # matches aug/functional.py:gaussian_blur default
# 4 float32 planes of one frame must fit a block's shared memory (227 KB)
_MAX_SIZE = 120
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def aug_fused_plain(clips_u8: torch.Tensor, orders: torch.Tensor,
                    factors: torch.Tensor, blur: torch.Tensor, *,
                    out_dtype: torch.dtype = torch.float32,
                    normalize: bool = True) -> torch.Tensor:
    """The same function in plain PyTorch, built from ``aug/functional.py``;
    runs on any device. The CPU tests and the on-card comparison use it."""
    x = F.to_float(clips_u8.permute(0, 2, 3, 4, 1))  # (N, T, S, S, 3)
    ops = (F.adjust_brightness, F.adjust_contrast, F.adjust_saturation,
           F.adjust_hue)
    # clips that share an op order go through the chain together
    uniq, inverse = torch.unique(orders, dim=0, return_inverse=True)
    for u, order in enumerate(uniq.tolist()):
        idx = (inverse == u).nonzero()[:, 0]
        sub = x[idx]
        for op in order:
            sub = ops[op](sub, factors[idx, op].reshape(-1, 1, 1, 1, 1))
        x[idx] = sub
    x = F.gaussian_blur(x, blur[:, 0], taps=_TAPS, on=blur[:, 1] > 0)
    if normalize:
        x = F.normalize(x)
    return x.permute(0, 4, 1, 2, 3).contiguous().to(out_dtype)


def _check(clips_u8, orders, factors, blur, out_dtype):
    if clips_u8.dim() != 5 or clips_u8.shape[1] != 3 \
            or clips_u8.shape[3] != clips_u8.shape[4]:
        raise ValueError(
            f"clips_u8 must be (N, 3, T, S, S), got {tuple(clips_u8.shape)}")
    N = clips_u8.shape[0]
    for name, t, dtype, cols in (("orders", orders, torch.int32, 4),
                                 ("factors", factors, torch.float32, 4),
                                 ("blur", blur, torch.float32, 2)):
        if tuple(t.shape) != (N, cols):
            raise ValueError(
                f"{name} must be ({N}, {cols}), got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != clips_u8.device:
            raise ValueError(
                f"{name} is on {t.device}, clips_u8 on {clips_u8.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if clips_u8.dtype != torch.uint8:
        raise TypeError(f"clips_u8 must be uint8, got {clips_u8.dtype}")
    if not clips_u8.is_contiguous():
        raise ValueError("clips_u8 must be contiguous")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}")
    # every row a permutation of 0..3 (reads the values: on a CUDA tensor
    # this waits for the stream once per call)
    want = torch.arange(4, dtype=torch.int32, device=orders.device)
    if not bool((orders.sort(dim=1).values == want).all()):
        raise ValueError("every row of orders must be a permutation of 0..3")


def aug_fused(clips_u8: torch.Tensor, orders: torch.Tensor,
              factors: torch.Tensor, blur: torch.Tensor, *,
              out_dtype: torch.dtype = torch.float32,
              compute_dtype: torch.dtype = torch.float32,
              normalize: bool = True) -> torch.Tensor:
    """Run the fused augmentation chain on pre-cropped clips (see the module
    docstring for the contract). CUDA tensors go through the kernel, CPU
    tensors through ``aug_fused_plain``."""
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            "in-kernel bfloat16 compute is not ported (experimental in the "
            "JAX package; queued in ROADMAP.md); use compute_dtype=float32")
    _check(clips_u8, orders, factors, blur, out_dtype)
    if not clips_u8.is_cuda:
        return aug_fused_plain(clips_u8, orders, factors, blur,
                               out_dtype=out_dtype, normalize=normalize)
    if clips_u8.shape[-1] > _MAX_SIZE:
        raise ValueError(
            f"crop size {clips_u8.shape[-1]} > {_MAX_SIZE}: one frame's "
            "planes no longer fit a block's shared memory")
    return _launch(clips_u8, orders, factors, blur, out_dtype, normalize)


def _launch(clips_u8, orders, factors, blur, out_dtype, normalize):
    """Allocate the output and launch the kernel on the current stream;
    the arguments are already checked. No synchronisation."""
    N, _, T, S, _ = clips_u8.shape
    out = torch.empty(clips_u8.shape, dtype=out_dtype, device=clips_u8.device)
    if N == 0:
        return out
    fn = load_library("aug_fused").aug_fused_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(clips_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(clips_u8.data_ptr(), orders.data_ptr(), factors.data_ptr(),
                 blur.data_ptr(), out.data_ptr(), N, T, S,
                 int(out_dtype == torch.bfloat16), int(normalize), stream)
    aug_fused.launches += 1
    if err != 0:
        raise RuntimeError(f"aug_fused kernel launch failed: CUDA error {err}")
    return out


aug_fused.launches = 0
