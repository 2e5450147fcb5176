"""Fused clip augmentation: wrapper, plain version and launch counter.

Replaces the Pallas kernel ``dualvar_tpu/ops/aug_fused.py:_aug_kernel`` with
the hand-written CUDA kernel ``csrc/aug_fused.cu``: a frame is cut into up
to 8 bands of rows (``_band_plan``), one block a band, and a frame's bands
are one thread-block cluster that shares the frame's gray sum through
distributed shared memory (see the source for the design). Same contract as
the JAX ``aug_fused``:

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

``compute_dtype`` is the planes' type inside the chain, as in the JAX
kernel: float32, or bfloat16, where every plane op is rounded to bfloat16
where the JAX kernel's bfloat16 mode rounds it (hue, the contrast mean's sum
and the blur's passes run in float32 on the bfloat16 planes, each result
rounded once; ``aug_fused_plain_bf16``). The kernel's bfloat16 route holds
two pixels a register and runs the colour chain, the gray and the
normalisation as packed bfloat16 pair ops, each rounded once as the float32
op and its round to bfloat16 are; it stages its planes as bfloat16.

Bound: bytes. Per clip the function reads 3*T*S*S bytes and writes
3*T*S*S*sizeof(out): 0.60 MB + 2.41 MB (f32 out) or 1.20 MB (bf16 out) at
T=16, S=112. The train step launches it once.

``aug_fused`` launches the kernel for CUDA tensors (or raises) and takes
``aug_fused_plain`` only for CPU tensors; ``aug_fused.launches`` counts the
kernel launches of both routes, ``aug_fused.bf16_launches`` those of the
bfloat16 compute route.
"""

from __future__ import annotations

import ctypes

import torch

from ..aug import functional as F
from ..core import spans
from .build import load_library

_TAPS = 13  # matches aug/functional.py:gaussian_blur default
_MAX_BANDS = 8  # blocks of a frame: one portable thread-block cluster
# the largest crop: a round of the kernel's in-place W pass covers at least
# one row (256 threads, one pixel each at worst), and a band has at most 32
# rows (kMaxBandRows of csrc/aug_fused.cu)
_MAX_SIZE = 256
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _band_plan(S: int) -> tuple[int, int, int]:
    """(bands a frame, rows a band, shared-memory bytes a block) for crop
    size S: at most 8 bands of ceil(S / 8) rows, one cluster of blocks a
    frame; a block holds its rows in 3 float32 planes (r, g, b, then their
    W pass, which the blocks above and below read for the H pass)."""
    if S > _MAX_SIZE:
        raise ValueError(f"crop size {S} > {_MAX_SIZE}: the kernel's W pass "
                         "takes rows of at most 256 pixels")
    bands = max(1, min(_MAX_BANDS, S))
    rows = -(-S // bands)
    bands = -(-S // max(rows, 1))
    return bands, rows, 4 * 3 * rows * S


def aug_fused_plain(clips_u8: torch.Tensor, orders: torch.Tensor,
                    factors: torch.Tensor, blur: torch.Tensor, *,
                    out_dtype: torch.dtype = torch.float32,
                    compute_dtype: torch.dtype = torch.float32,
                    normalize: bool = True) -> torch.Tensor:
    """The same function in plain PyTorch, built from ``aug/functional.py``;
    runs on any device. The CPU tests and the on-card comparison use it."""
    if compute_dtype == torch.bfloat16:
        return aug_fused_plain_bf16(clips_u8, orders, factors, blur,
                                    out_dtype=out_dtype, normalize=normalize)
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


def _bf16(values, like: torch.Tensor) -> torch.Tensor:
    """Python floats as JAX's weak typing makes them inside a bfloat16 op:
    rounded to bfloat16 once."""
    return torch.tensor(values, dtype=torch.bfloat16, device=like.device)


def _gray_bf16(x: torch.Tensor) -> torch.Tensor:
    """The JAX kernel's ``_gray`` on bfloat16 planes: three products and
    two sums, each rounded (not one float32 sum over the channels)."""
    w = [_bf16(v, x) for v in F._GRAY_W]
    return x[..., 0:1] * w[0] + x[..., 1:2] * w[1] + x[..., 2:3] * w[2]


def _blend_bf16(x: torch.Tensor, other, f: torch.Tensor) -> torch.Tensor:
    return (x * f + other * (1.0 - f)).clamp(0.0, 1.0)


def aug_fused_plain_bf16(clips_u8: torch.Tensor, orders: torch.Tensor,
                         factors: torch.Tensor, blur: torch.Tensor, *,
                         out_dtype: torch.dtype = torch.float32,
                         normalize: bool = True) -> torch.Tensor:
    """The chain with bfloat16 planes, op by op as the JAX kernel computes
    it with ``compute_dtype=bfloat16`` (``dualvar_tpu/ops/aug_fused.py``):
    each bfloat16 op of PyTorch rounds its result once, so

    * the plane is u8 * (1/255) in float32, rounded;
    * brightness, contrast and saturation factors are rounded once an op;
      each blend's ``x*f``, ``other*(1-f)``, their sum and the clip are
      bfloat16 ops, and so are the gray's products and sums;
    * the contrast mean is a float32 sum of the bfloat16 gray, times
      1/(H*W), rounded;
    * hue runs in float32 on the bfloat16 planes with the float32 factor,
      and its result is rounded;
    * the blur's two passes run in float32 on the bfloat16 planes, rounded
      once at the end;
    * the normalisation is ``x*scale + bias`` in bfloat16."""
    bf = torch.bfloat16
    x = (clips_u8.permute(0, 2, 3, 4, 1).to(torch.float32)
         * (1.0 / 255.0)).to(bf)  # (N, T, S, S, 3)
    H, W = x.shape[-3], x.shape[-2]

    def fac(idx, op, dtype=bf):  # one factor a clip, (n, 1, 1, 1, 1)
        return factors[idx, op].to(dtype).reshape(-1, 1, 1, 1, 1)

    def brightness(sub, idx):
        return _blend_bf16(sub, torch.zeros_like(sub), fac(idx, 0))

    def contrast(sub, idx):
        g = _gray_bf16(sub)
        m = (g.float().sum(dim=(-3, -2), keepdim=True)
             * (1.0 / (H * W))).to(bf)
        return _blend_bf16(sub, m, fac(idx, 1))

    def saturation(sub, idx):
        return _blend_bf16(sub, _gray_bf16(sub), fac(idx, 2))

    def hue(sub, idx):
        return F.adjust_hue(sub.float(), fac(idx, 3, torch.float32)).to(bf)

    ops = (brightness, contrast, saturation, hue)
    uniq, inverse = torch.unique(orders, dim=0, return_inverse=True)
    for u, order in enumerate(uniq.tolist()):
        idx = (inverse == u).nonzero()[:, 0]
        sub = x[idx]
        for op in order:
            sub = ops[op](sub, idx)
        x[idx] = sub
    x = F.gaussian_blur(x.float(), blur[:, 0], taps=_TAPS,
                        on=blur[:, 1] > 0).to(bf)
    if normalize:
        x = (x * _bf16([1.0 / s for s in F.IMAGENET_STD], x)
             + _bf16([-m / s for m, s in zip(F.IMAGENET_MEAN,
                                             F.IMAGENET_STD)], x))
    return x.permute(0, 4, 1, 2, 3).contiguous().to(out_dtype)


def _check(clips_u8, orders, factors, blur, out_dtype,
           compute_dtype=torch.float32):
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
    if compute_dtype not in _COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be one of {_COMPUTE_DTYPES}")
    # every row a permutation of 0..3 (reads the values: on a CUDA tensor
    # this waits for the stream once per call)
    want = torch.arange(4, dtype=torch.int32, device=orders.device)
    with spans.sync("aug_check"):
        ok = bool((orders.sort(dim=1).values == want).all())
    if not ok:
        raise ValueError("every row of orders must be a permutation of 0..3")


def aug_fused(clips_u8: torch.Tensor, orders: torch.Tensor,
              factors: torch.Tensor, blur: torch.Tensor, *,
              out_dtype: torch.dtype = torch.float32,
              compute_dtype: torch.dtype = torch.float32,
              normalize: bool = True) -> torch.Tensor:
    """Run the fused augmentation chain on pre-cropped clips (see the module
    docstring for the contract). CUDA tensors go through the kernel, CPU
    tensors through ``aug_fused_plain``."""
    _check(clips_u8, orders, factors, blur, out_dtype, compute_dtype)
    if not clips_u8.is_cuda:
        return aug_fused_plain(clips_u8, orders, factors, blur,
                               out_dtype=out_dtype,
                               compute_dtype=compute_dtype,
                               normalize=normalize)
    _band_plan(clips_u8.shape[-1])  # raises on a crop too large for a band
    return _launch(clips_u8, orders, factors, blur, out_dtype, normalize,
                   compute_dtype)


def _launch(clips_u8, orders, factors, blur, out_dtype, normalize,
            compute_dtype=torch.float32):
    """Allocate the output and launch the kernel on the current stream;
    the arguments are already checked. No synchronisation."""
    N, _, T, S, _ = clips_u8.shape
    out = torch.empty(clips_u8.shape, dtype=out_dtype, device=clips_u8.device)
    if out.numel() == 0:
        return out
    bands, rows, _ = _band_plan(S)
    # 4-pixel units (4-byte loads, 16-byte stores) when every row starts on
    # a 4-byte boundary
    vec = S % 4 == 0 and clips_u8.data_ptr() % 4 == 0
    fn = load_library("aug_fused").aug_fused_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    with torch.cuda.device(clips_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(clips_u8.data_ptr(), orders.data_ptr(), factors.data_ptr(),
                 blur.data_ptr(), out.data_ptr(), N, T, S, rows, bands,
                 int(vec), int(out_dtype == torch.bfloat16),
                 int(compute_dtype == torch.bfloat16), int(normalize), stream)
    aug_fused.launches += 1
    aug_fused.bf16_launches += int(compute_dtype == torch.bfloat16)
    if err != 0:
        raise RuntimeError(f"aug_fused kernel launch failed: CUDA error {err}")
    return out


aug_fused.launches = 0
aug_fused.bf16_launches = 0
