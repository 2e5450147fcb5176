"""Per-channel float32 sums for the batch norm: wrapper, plain version and
launch counter.

Replaces the Pallas kernel ``dualvar_tpu/ops/bn_stats.py:_sums_kernel``
(through ``_channel_sums_2d`` and ``channel_sums``) with the hand-written
CUDA kernel ``csrc/bn_stats.cu``. Same contract as the JAX ``channel_sums``:
for ``a`` and ``b`` of one shape, the per-channel float32 pair

    (sum a, sum a*b)   over every axis but ``dim``,

from float32 or bfloat16 inputs and any row count. With ``b = a`` it gives a
batch norm's forward statistics, with ``(g, x)`` its backward sums. The
JAX package's channels-last maps take ``dim=-1``; the port's ``(N, C, T, H,
W)`` maps take ``dim=1``, in NCDHW or in ``channels_last_3d`` memory alike.

Bound: bytes. One pass over each input (over ``a`` alone when ``b is a``),
one or two float operations an element, ``8*C`` bytes out.

``channel_sums`` launches the kernel for CUDA tensors (or raises) and takes
``channel_sums_plain`` only for CPU tensors; ``channel_sums.launches`` counts
the kernel launches. ``use_kernel_stats()`` is the switch the batch norm of
``models/layers.py`` reads.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

from .build import load_library

_THREADS = 256  # kThreads of csrc/bn_stats.cu
_TARGET_BLOCKS = 1024  # about eight blocks an SM on 132 SMs
_PLANAR_CHUNK = 8 * _THREADS  # inner vectors a block, planar layout
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def use_kernel_stats() -> bool:
    """True when ``DUALVAR_BN_STATS=pallas``: the batch norm then takes its
    sums from ``channel_sums``. The same variable with the same values as the
    JAX package's ``use_pallas_stats``, so one setting drives both packages;
    in the port "pallas" selects the CUDA kernel. Default off."""
    return os.environ.get("DUALVAR_BN_STATS", "xla") == "pallas"


def _reduce_dims(t: torch.Tensor, dim: int) -> tuple[int, list[int]]:
    dim = dim % t.dim()
    return dim, [d for d in range(t.dim()) if d != dim]


def channel_sums_plain(a: torch.Tensor, b: torch.Tensor, dim: int = -1
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same sums in plain PyTorch on any device: float32, or float64
    for float64 inputs (as the JAX package's float64 path accumulates)."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    _, dims = _reduce_dims(a, dim)
    af = a.to(acc)
    return af.sum(dim=dims), (af * b.to(acc)).sum(dim=dims)


def _view(t: torch.Tensor, dim: int) -> tuple[int, int, int]:
    """(outer, C, inner) of ``t``'s memory, reduced over outer and inner:
    a contiguous tensor, or a channels-last one reduced over all but dim 1.
    Raises for any other layout."""
    dim, _ = _reduce_dims(t, dim)
    C = t.shape[dim]
    if t.is_contiguous():
        return math.prod(t.shape[:dim]), C, math.prod(t.shape[dim + 1:])
    cl = {4: torch.channels_last, 5: torch.channels_last_3d}.get(t.dim())
    if dim == 1 and cl is not None and t.is_contiguous(memory_format=cl):
        return t.numel() // C, C, 1
    raise ValueError(
        f"channel_sums takes contiguous or channels-last tensors; got shape "
        f"{tuple(t.shape)} strides {t.stride()} over dim {dim}")


def _grid(outer: int, C: int, inner: int, vec: int):
    """(p0, p1, isplit, nsplit, ncolgroups) for ``channel_sums_launch``:
    about ``_TARGET_BLOCKS`` blocks, each over whole vectors."""
    if inner == 1:  # rows of C channels
        cols = C // vec
        ncolgroups = -(-cols // _THREADS)
        rows_per_iter = _THREADS // min(_THREADS, cols)
        per_block = -(-outer * ncolgroups // _TARGET_BLOCKS)
        per_block = max(1, -(-per_block // rows_per_iter)) * rows_per_iter
        return 0, per_block, 1, -(-outer // per_block), ncolgroups
    nvec = inner // vec
    ichunk = min(nvec, _PLANAR_CHUNK)
    isplit = -(-nvec // ichunk)
    osplit = min(outer, max(1, -(-_TARGET_BLOCKS // (C * isplit))))
    rows_per_block = -(-outer // osplit)
    osplit = -(-outer // rows_per_block)
    return rows_per_block, ichunk, isplit, osplit * isplit, 1


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("bn_stats").channel_sums_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int64]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return fn


def channel_sums(a: torch.Tensor, b: torch.Tensor, dim: int = -1
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 ``(sum a, sum a*b)`` over every axis but ``dim``
    (see the module docstring). CUDA tensors go through the kernel, CPU
    tensors through ``channel_sums_plain``; pass ``b is a`` for the sums of
    squares, so the kernel reads the input once."""
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(
            f"a {tuple(a.shape)} {a.dtype} {a.device} and b {tuple(b.shape)} "
            f"{b.dtype} {b.device} must match")
    if not a.is_cuda:
        return channel_sums_plain(a, b, dim)
    if a.dtype not in _DTYPES:
        raise TypeError(f"channel_sums takes float32 or bfloat16 on the card, "
                        f"got {a.dtype}")
    outer, C, inner = _view(a, dim)
    if b is not a and (_view(b, dim) != (outer, C, inner)
                       or b.stride() != a.stride()):
        raise ValueError("a and b must have the same memory layout")
    s1 = torch.empty(C, dtype=torch.float32, device=a.device)
    s2 = torch.empty(C, dtype=torch.float32, device=a.device)
    if outer * inner == 0 or C == 0:
        return s1.zero_(), s2.zero_()
    # 16-byte loads where every run of the reduced axis stays aligned
    vec = 16 // a.element_size()
    run = C if inner == 1 else inner
    if run % vec or a.data_ptr() % 16 or b.data_ptr() % 16:
        vec = 1
    p0, p1, isplit, nsplit, ncolgroups = _grid(outer, C, inner, vec)
    partial = torch.empty((2, C, nsplit), dtype=torch.float32,
                          device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel()(
            a.data_ptr(), b.data_ptr(), _DTYPES[a.dtype], vec,
            partial.data_ptr(), s1.data_ptr(), s2.data_ptr(), outer, C, inner,
            p0, p1, isplit, nsplit, ncolgroups,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"channel_sums kernel launch failed: CUDA error "
                           f"{err}")
    channel_sums.launches += 1
    return s1, s2


channel_sums.launches = 0
