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
the kernel launches, one a call. Its result is one ``(2, C)`` float32 tensor,
returned as its two rows; the kernel combines its partial sums through a
workspace that each device keeps for the life of the process
(``_workspace``), so the calls on one device must be ordered on one
stream. ``use_kernel_stats()`` is the switch the batch norm of
``models/layers.py`` reads.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

from .build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the plan of csrc/bn_stats.cu
_THREADS = 256  # kThreads
_UNROLL = 4  # kUnroll: loads of each input a thread issues before adding
_COUNTERS = 1 << 16  # kCounters: the workspace's counters, then its partials
_PARTIALS = 1 << 20  # floats of partial sums in the workspace
# planar: a block reads batches of _THREADS * _UNROLL chunks; a map of more
# than _FILL_BLOCKS batches is cut into at most _FILL_BLOCKS blocks (four an
# SM: one wave, the last of a channel's blocks no shorter than the others);
# a channel's blocks at most
_FILL_BLOCKS = 132 * 4
_MAX_SPLIT = 1024
# channels-last: the bytes one block reads
_ROWS_BLOCK_BYTES = 64 << 10


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


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


@functools.lru_cache(maxsize=4096)
def _plan(outer: int, C: int, inner: int, esize: int, mis: int, wide: bool,
          same: bool) -> tuple[int, int, int, int, int]:
    """(kind bits, mis, nch, per, nsplit) of ``channel_sums_launch`` for a
    map (outer, C, inner) of ``esize``-byte elements whose data starts
    ``mis`` elements past a 16-byte boundary. ``wide``: 16-byte chunks may
    be read (a and b lie alike against 16 bytes, and for channels-last rows
    C fills whole chunks and both start on a boundary). ``same``: one input
    (b is a).

    Planar (inner > 1): each channel's ``outer * nch`` slots (chunks of a
    run) fall in ``nsplit`` blocks of ``per`` slots. In a map of up to
    ``_FILL_BLOCKS`` batches (``_UNROLL`` loads of each input a thread) a
    channel of up to two batches is one block, which needs no combining (one
    or two DRAM round trips), and a longer one is cut into blocks of one
    batch; a larger map gets ``_FILL_BLOCKS // C`` blocks a channel (at
    least one), all resident at once.

    Channels-last (inner == 1): ``nsplit`` blocks of ``per`` rows a column
    group of 256 chunks, a block reading about ``_ROWS_BLOCK_BYTES``; their
    count bounded so that the last block's sum of the partials stays short.
    """
    vec = 16 // esize if wide else 1
    n_in = 1 if same else 2
    if inner == 1:
        ng = min(_THREADS, C // vec) * vec  # channels of a column group
        rpi = _THREADS // (ng // vec)  # rows a block covers at once
        slots, tps = 2 * ng, 1
        while 2 * tps * slots <= _THREADS:
            tps *= 2
        nsplit = _cdiv(outer * ng * esize * n_in, _ROWS_BLOCK_BYTES)
        nsplit = max(1, min(nsplit, 128 * tps // _cdiv(slots, _THREADS),
                            _PARTIALS // (2 * C), _cdiv(outer, rpi)))
        per = _cdiv(outer, nsplit)
        return 2 * (vec > 1), 0, 0, per, _cdiv(outer, per)
    if vec == 1:
        mis = 0
    aligned = mis == 0 and inner % vec == 0
    nch = inner // vec if aligned else (inner + 2 * vec - 2) // vec
    nslots = outer * nch
    if nslots >= 1 << 32:
        raise ValueError(f"channel_sums: a channel of {outer} x {inner} "
                         "values is too large for the kernel")
    batch = _THREADS * _UNROLL
    if C * nslots <= _FILL_BLOCKS * batch:
        per = nslots if nslots <= 2 * batch else batch
    else:
        per = _cdiv(nslots, max(1, _FILL_BLOCKS // C))
    cap = min(_MAX_SPLIT, _PARTIALS // (2 * C))
    if _cdiv(nslots, per) > cap:
        per = _cdiv(nslots, cap)
    return 2 * (vec > 1) + 4 * aligned, mis, nch, per, _cdiv(nslots, per)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("bn_stats").channel_sums_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_void_p])
    return fn


_workspaces: dict[int, tuple[torch.Tensor, int]] = {}


def _workspace(a: torch.Tensor, device: int) -> int:
    """Address of ``device``'s workspace: ``_COUNTERS`` counters, which the
    kernel leaves at 0, then ``_PARTIALS`` floats. Zeroed once, at the
    device's first call, which must not be inside a CUDA graph capture (the
    zeroing would only run when the graph is replayed)."""
    ws = _workspaces.get(device)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "channel_sums: call it once on this device before capturing "
                "a CUDA graph, so that its workspace is zeroed eagerly")
        t = torch.zeros(_COUNTERS + _PARTIALS, dtype=torch.int32,
                        device=a.device)
        ws = _workspaces[device] = (t, t.data_ptr())
    return ws[1]


def channel_sums(a: torch.Tensor, b: torch.Tensor, dim: int = -1
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 ``(sum a, sum a*b)`` over every axis but ``dim``
    (see the module docstring). CUDA tensors go through the kernel, CPU
    tensors through ``channel_sums_plain``; pass ``b is a`` for the sums of
    squares, so the kernel reads the input once. Calls on one device share
    its workspace: issue them on one stream, never on two at once."""
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
    if b is not a and b.stride() != a.stride():
        raise ValueError("a and b must have the same memory layout")
    out = torch.empty((2, C), dtype=torch.float32, device=a.device)
    if outer * inner == 0 or C == 0:
        return out.zero_().unbind(0)
    if C > _COUNTERS:
        raise ValueError(f"channel_sums takes at most {_COUNTERS} channels "
                         f"on the card, got {C}")
    pa, pb = a.data_ptr(), b.data_ptr()
    esize = a.element_size()
    if inner == 1:
        wide = C % (16 // esize) == 0 and pa % 16 == 0 and pb % 16 == 0
    else:
        wide = pa % 16 == pb % 16
    bits, mis, nch, per, nsplit = _plan(outer, C, inner, esize,
                                        pa % 16 // esize, wide, pa == pb)
    device = a.get_device()
    args = (pa, pb, _DTYPES[a.dtype] + bits, out.data_ptr(),
            _workspace(a, device), outer, C, inner, mis, nch, per, nsplit,
            torch._C._cuda_getCurrentRawStream(device))
    if device == torch.cuda.current_device():
        err = _kernel()(*args)
    else:
        with torch.cuda.device(device):
            err = _kernel()(*args)
    if err != 0:
        raise RuntimeError(f"channel_sums kernel launch failed: CUDA error "
                           f"{err}")
    channel_sums.launches += 1
    return out.unbind(0)


channel_sums.launches = 0
