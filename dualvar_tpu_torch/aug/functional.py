"""Video augmentation primitives on tensors.

Counterpart of ``dualvar_tpu/aug/functional.py``. Every colour op takes
channels-last float32 frames ``(..., H, W, C)`` in [0, 1]; factors are
scalars or tensors that broadcast against the clip (e.g. ``(N, 1, 1, 1, 1)``
for ``(N, T, H, W, C)``). The crops and the flip take frames of any type,
uint8 included, with the same ``(..., H, W, C)`` axes.

The random per-clip ops (``random_crop``, ``random_hflip``,
``random_gray_channel_split``, ``channel_mask``, ``random_sized_crop``,
``random_rotation``, ``color_jitter``) take clips ``(..., T, H, W, C)``, one
independent draw per leading index (what the JAX package's ``vmap`` over
samples gives), from an explicit ``torch.Generator``. Each also takes its
decisions as tensors over the leading axes (offsets, flips, uniform draws,
factors, apply gates, op orders) in place of drawing them, so that a test
can hand both packages the same ones; with them given the generator is not
used and may be None.

Factor semantics follow torchvision's float-tensor functional ops, which the
reference ColorJitter delegates to (augmentation.py:493-505):

    brightness: img * f                       (clamped to [0,1])
    contrast:   blend(img, mean(gray(img)), f)   (per-frame mean)
    saturation: blend(img, gray(img), f)
    hue:        h channel rotated by f in HSV

GaussianBlur is a true separable Gaussian with edge replication, as in the
JAX package (PIL approximates one with box blurs, augmentation.py:706-721).
"""

from __future__ import annotations

import math

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# torchvision rgb_to_grayscale / reference utils/transforms.py:66 weights
_GRAY_W = (0.2989, 0.587, 0.114)


def to_float(clip_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1] (ToTensor, augmentation.py:361-364)."""
    return clip_u8.to(torch.float32) / 255.0


def normalize(clip: torch.Tensor, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> torch.Tensor:
    """Channel normalisation (utils/transforms.py:57; pretrain.py:280-282)."""
    mean = torch.tensor(mean, dtype=clip.dtype, device=clip.device)
    std = torch.tensor(std, dtype=clip.dtype, device=clip.device)
    return (clip - mean) / std


def center_crop(clip: torch.Tensor, size: int) -> torch.Tensor:
    """augmentation.py:178-191: origins ``int(round((d - size) / 2))``,
    Python's round, which rounds half to even (171 -> 112 gives 30)."""
    H, W = clip.shape[-3], clip.shape[-2]
    y0 = int(round((H - size) / 2.0))
    x0 = int(round((W - size) / 2.0))
    return clip[..., y0:y0 + size, x0:x0 + size, :]


def five_crop(clip: torch.Tensor, size: int, where: int) -> torch.Tensor:
    """1=topleft 2=topright 3=botleft 4=botright 5=center
    (augmentation.py:194-220)."""
    H, W = clip.shape[-3], clip.shape[-2]
    if where == 1:
        return clip[..., :size, :size, :]
    if where == 2:
        return clip[..., :size, W - size:, :]
    if where == 3:
        return clip[..., H - size:, :size, :]
    if where == 4:
        # reference crops (w-tw, h-tw, w, h): height origin uses tw
        return clip[..., H - size:, W - size:, :]
    return center_crop(clip, size)


def hflip(clip: torch.Tensor) -> torch.Tensor:
    """Horizontal flip: the W axis reversed."""
    return clip.flip(-2)


def grayscale(clip: torch.Tensor) -> torch.Tensor:
    """Luminance, keepdims 1 channel."""
    w = torch.tensor(_GRAY_W, dtype=clip.dtype, device=clip.device)
    return (clip * w).sum(dim=-1, keepdim=True)


def _blend(a: torch.Tensor, b, ratio) -> torch.Tensor:
    return (a * ratio + b * (1.0 - ratio)).clamp(0.0, 1.0)


def adjust_brightness(clip: torch.Tensor, factor) -> torch.Tensor:
    """torchvision F.adjust_brightness: blend with zero."""
    return _blend(clip, torch.zeros_like(clip), factor)


def adjust_contrast(clip: torch.Tensor, factor) -> torch.Tensor:
    """Blend with the per-frame gray mean (torchvision computes the mean
    over the image)."""
    mean = grayscale(clip).mean(dim=(-3, -2), keepdim=True)
    return _blend(clip, mean, factor)


def adjust_saturation(clip: torch.Tensor, factor) -> torch.Tensor:
    return _blend(clip, grayscale(clip), factor)


def rgb_to_hsv(clip: torch.Tensor) -> torch.Tensor:
    """Vectorized RGB->HSV, mirroring the reference's numpy port of PIL
    (augmentation.py:26-65) which itself mirrors torchvision."""
    r, g, b = clip[..., 0], clip[..., 1], clip[..., 2]
    maxc = clip.max(dim=-1).values
    minc = clip.min(dim=-1).values
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(eqc, ones, maxc)
    cr_div = torch.where(eqc, ones, cr)
    rc = (maxc - r) / cr_div
    gc = (maxc - g) / cr_div
    bc = (maxc - b) / cr_div
    zero = torch.zeros_like(maxc)
    hr = torch.where(maxc == r, bc - gc, zero)
    hg = torch.where((maxc == g) & (maxc != r), 2.0 + rc - bc, zero)
    hb = torch.where((maxc != g) & (maxc != r), 4.0 + gc - rc, zero)
    # floored modulo (torch.remainder), never torch.fmod
    h = torch.remainder((hr + hg + hb) / 6.0 + 1.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(clip: torch.Tensor) -> torch.Tensor:
    """Vectorized HSV->RGB (reference augmentation.py:67-88), branchless:
    channel(n) = v - v*s*clip(min(k, 4-k), 0, 1), k = (n + 6h) mod 6."""
    h, s, v = clip[..., 0], clip[..., 1], clip[..., 2]
    h6 = h * 6.0
    vs = v * s

    def chan(n):
        k = torch.remainder(n + h6, 6.0)
        return v - vs * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], dim=-1)


def adjust_hue(clip: torch.Tensor, factor) -> torch.Tensor:
    """factor in [-0.5, 0.5]: rotate the hue channel. ``h + factor`` goes
    negative, so the wrap is a floored modulo."""
    hsv = rgb_to_hsv(clip)
    h = torch.remainder(hsv[..., 0:1] + factor, 1.0)
    return hsv_to_rgb(torch.cat([h, hsv[..., 1:]], dim=-1))


def gaussian_blur(clip: torch.Tensor, sigma, taps: int = 13,
                  on=True) -> torch.Tensor:
    """Separable Gaussian blur with edge replication, W pass then H pass.

    ``clip``: (..., H, W, C). ``sigma`` and ``on``: scalars, or tensors over
    the leading axes of ``clip`` (shape ``clip.shape[:k]``), one per clip.
    Where ``on`` is False the original clip is returned bit-exactly.
    """
    r = taps // 2
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=clip.device)
    lead = sigma.dim()
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=clip.device)
    k = torch.exp(-0.5 * (x / sigma.clamp_min(1e-6)[..., None]) ** 2)
    k = k / k.sum(dim=-1, keepdim=True)  # (*lead, taps)
    k = k.reshape(*k.shape, *([1] * (clip.dim() - lead)))  # broadcastable

    def pass_1d(src: torch.Tensor, axis: int) -> torch.Tensor:
        n = src.shape[axis]
        pos = torch.arange(n, device=src.device)
        acc = torch.zeros_like(src)
        for j in range(taps):
            idx = (pos - r + j).clamp(0, n - 1)  # clamped neighbour
            # tap j, keeping the leading per-clip axes: (*lead, 1, ..., 1)
            acc = acc + k.select(lead, j) * src.index_select(axis, idx)
        return acc

    out = pass_1d(clip, clip.dim() - 2)  # W
    out = pass_1d(out, clip.dim() - 3)  # H
    if isinstance(on, bool):
        return out if on else clip
    on = on.reshape(*on.shape, *([1] * (clip.dim() - on.dim())))
    return torch.where(on, out, clip)



# --------------------------------------------------------------------------
# the per-sample random ops of the unfused pipeline
# --------------------------------------------------------------------------

def _lead(clip: torch.Tensor) -> tuple[int, ...]:
    """The leading axes of a ``(..., T, H, W, C)`` clip: one draw each."""
    return tuple(clip.shape[:-4])


def _rand(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def _uniform(generator, lo: float, hi: float, shape, device) -> torch.Tensor:
    """U[lo, hi) as ``jax.random.uniform(minval=lo, maxval=hi)`` forms it:
    ``max(lo, u * (hi - lo) + lo)``."""
    u = _rand(generator, shape, device)
    return (u * (hi - lo) + lo).clamp_min(lo)


def _randint(generator, lo: int, hi: int, shape, device) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=generator, device=device)


def _crop_frames(clip: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 size: int) -> torch.Tensor:
    """(..., T, H, W, C) -> (..., T, size, size, C): frame t of clip n cut
    at (y0[n, t], x0[n, t]) (offsets over the leading axes and T)."""
    lead = _lead(clip)
    T, H, W, C = clip.shape[-4:]
    N = math.prod(lead)
    flat = clip.reshape(N, T, H, W, C)
    dev = clip.device
    span = torch.arange(size, device=dev)
    y0 = y0.to(dev).reshape(N, T)
    x0 = x0.to(dev).reshape(N, T)
    n = torch.arange(N, device=dev).reshape(N, 1, 1, 1)
    t = torch.arange(T, device=dev).reshape(1, T, 1, 1)
    y = (y0[:, :, None] + span).reshape(N, T, size, 1)
    x = (x0[:, :, None] + span).reshape(N, T, 1, size)
    return flat[n, t, y, x].reshape(*lead, T, size, size, C)


def random_crop(generator: torch.Generator | None, clip: torch.Tensor,
                size: int, n_seqblock: int = 0,
                offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Clip-consistent random crop (augmentation.py:149-175).

    ``n_seqblock`` > 0 draws a fresh origin every ``n_seqblock`` frames
    (the reference's block-consistent variant). ``offsets``: the (y0, x0)
    origins, ``(..., 2)``, or ``(..., n_blocks, 2)`` with ``n_seqblock``;
    drawn uniformly over the valid window when not given."""
    lead = _lead(clip)
    T, H, W = clip.shape[-4:-1]
    dev = clip.device
    n_blocks = -(-T // n_seqblock) if n_seqblock > 0 else 0
    if offsets is None:
        shape = lead + ((n_blocks,) if n_blocks else ())
        y0 = _randint(generator, 0, H - size + 1, shape, dev)
        x0 = _randint(generator, 0, W - size + 1, shape, dev)
        offsets = torch.stack([y0, x0], dim=-1)
    offsets = torch.as_tensor(offsets, device=dev).long()
    if n_blocks:
        per_frame = offsets.index_select(
            offsets.dim() - 2, torch.arange(T, device=dev) // n_seqblock)
    else:
        per_frame = offsets.unsqueeze(-2).expand(*lead, T, 2)
    return _crop_frames(clip, per_frame[..., 0], per_frame[..., 1], size)


def random_hflip(generator: torch.Generator | None, clip: torch.Tensor,
                 p: float = 0.5, seq_len: int = 0,
                 flip: torch.Tensor | None = None) -> torch.Tensor:
    """Whole-clip random horizontal flip (augmentation.py:314-341).

    ``seq_len`` > 0 (and shorter than the clip) draws a fresh decision every
    ``seq_len`` frames. ``flip``: the decisions, ``(...)`` or
    ``(..., n_blocks)`` bool; drawn with probability ``p`` when not
    given."""
    lead = _lead(clip)
    T = clip.shape[-4]
    dev = clip.device
    blocked = 0 < seq_len < T
    if flip is None:
        shape = lead + ((-(-T // seq_len),) if blocked else ())
        flip = _rand(generator, shape, dev) < p
    flip = torch.as_tensor(flip, device=dev).bool()
    if blocked:
        flip = flip.index_select(flip.dim() - 1,
                                 torch.arange(T, device=dev) // seq_len)
    else:
        flip = flip.unsqueeze(-1).expand(*lead, T)
    return torch.where(flip[..., None, None, None], hflip(clip), clip)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x.abs()).clamp_min(0.0)


_KERNELS = {"linear": _triangle, "bilinear": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic}


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor, kernel, antialias: bool
                ) -> torch.Tensor:
    """(N, in_size, out_size) resampling weights, as
    ``jax.image.scale_and_translate`` computes them in float32: the kernel
    widened by 1/scale when downsampling (``antialias``), each output's
    weights normalised to sum 1, and zero where the sample lies outside the
    input."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]  # (N, 1)
    kernel_scale = inv_scale.clamp_min(1.0) if antialias else 1.0
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = ((out_pos + 0.5) * inv_scale
                - translation[:, None] * inv_scale - 0.5)  # (N, out)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - in_pos[None, :, None]).abs()
    if antialias:
        x = x / kernel_scale[:, :, None]
    weights = kernel(x)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def scale_and_translate(clip: torch.Tensor, out_hw: tuple[int, int],
                        scale, translation, method: str = "bilinear",
                        antialias: bool = True) -> torch.Tensor:
    """``jax.image.scale_and_translate`` over the (H, W) axes of
    ``(..., T, H, W, C)`` clips: output pixel (y, x) samples the input at
    ((y + .5 - ty) / sy - .5, (x + .5 - tx) / sx - .5). ``scale`` and
    ``translation``: ``(sy, sx)`` / ``(ty, tx)`` as ``(..., 2)`` tensors (one
    pair a clip) or pairs of numbers."""
    lead = _lead(clip)
    T, H, W, C = clip.shape[-4:]
    N = math.prod(lead)
    dev = clip.device
    kernel = _KERNELS[method]
    clip = clip.to(torch.float32) if not clip.is_floating_point() else clip
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    translation = torch.as_tensor(translation, dtype=torch.float32,
                                  device=dev)
    scale = scale.expand(*lead, 2).reshape(N, 2)
    translation = translation.expand(*lead, 2).reshape(N, 2)
    out_h, out_w = out_hw
    wy = _weight_mat(H, out_h, scale[:, 0], translation[:, 0], kernel,
                     antialias).to(clip.dtype)
    wx = _weight_mat(W, out_w, scale[:, 1], translation[:, 1], kernel,
                     antialias).to(clip.dtype)
    flat = clip.reshape(N, T, H, W, C)
    out = torch.einsum("nthwc,nhy,nwx->ntyxc", flat, wy, wx)
    return out.reshape(*lead, T, out_h, out_w, C)


def resize(clip: torch.Tensor, out_h: int, out_w: int,
           method: str = "bicubic") -> torch.Tensor:
    """Device-side resize, ``jax.image.resize`` (antialiased, Keys cubic
    for ``'bicubic'``, triangle for ``'bilinear'``) over the (H, W) axes of
    ``(..., T, H, W, C)`` clips; an axis whose size does not change is left
    as it is, as there. (augmentation.py:125-146's Scale; the host loaders
    resize with PIL or the native decoder instead.)"""
    if method not in _KERNELS:
        raise ValueError(f"resize method must be one of {sorted(_KERNELS)}, "
                         f"got {method!r}")
    H, W = clip.shape[-3:-1]
    if not clip.is_floating_point():
        clip = clip.to(torch.float32)
    if (H, W) == (out_h, out_w):
        return clip
    # the identity axis keeps scale 1 / translation 0: its weights are the
    # identity matrix (interpolating kernels), as JAX skips it
    return scale_and_translate(clip, (out_h, out_w),
                               (out_h / H, out_w / W), (0.0, 0.0), method)


def _blockwise(op, clip: torch.Tensor, block: int) -> torch.Tensor:
    """Apply a per-clip op independently to a (block x block) spatial grid
    (the reference's block machinery, augmentation.py:587-618): the grid's
    cells become a new leading axis (cell gy * block + gx) of
    ``(..., block**2, T, H/block, W/block, C)``, so the op draws (or takes)
    one decision a cell. H and W must be divisible by ``block``."""
    lead = _lead(clip)
    T, H, W, C = clip.shape[-4:]
    g = block
    assert H % g == 0 and W % g == 0, (H, W, g)
    hu, wu = H // g, W // g
    k = len(lead)
    tiles = clip.reshape(*lead, T, g, hu, g, wu, C)
    perm = list(range(k)) + [k + 1, k + 3, k, k + 2, k + 4, k + 5]
    tiles = tiles.permute(perm).reshape(*lead, g * g, T, hu, wu, C)
    out = op(tiles)
    out = out.reshape(*lead, g, g, T, hu, wu, C)
    inv = list(range(k)) + [k + 2, k, k + 3, k + 1, k + 4, k + 5]
    return out.permute(inv).reshape(*lead, T, H, W, C)


def random_gray_channel_split(generator: torch.Generator | None,
                              clip: torch.Tensor, p: float = 0.8,
                              block: int = 1,
                              channel: torch.Tensor | None = None,
                              apply: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """'RandomGray': one random channel copied over all three with
    probability ``p`` (augmentation.py:373-426, consistent). ``block`` > 1
    draws per spatial grid cell. ``channel`` (int in [0, 3)) and ``apply``
    (bool): the decisions over the leading axes (and the grid cells)."""
    if block > 1:
        return _blockwise(
            lambda c: random_gray_channel_split(generator, c, p, 1, channel,
                                                apply), clip, block)
    lead = _lead(clip)
    dev = clip.device
    if channel is None:
        channel = _randint(generator, 0, 3, lead, dev)
    if apply is None:
        apply = _rand(generator, lead, dev) < p
    channel = torch.as_tensor(channel, device=dev).long()
    apply = torch.as_tensor(apply, device=dev).bool()
    index = channel.reshape(*lead, 1, 1, 1, 1).expand(
        *clip.shape[:-1], 1)
    gray = torch.gather(clip, -1, index).expand_as(clip)
    return torch.where(apply.reshape(*lead, 1, 1, 1, 1), gray, clip)


def channel_mask(generator: torch.Generator | None, clip: torch.Tensor,
                 p: float = 0.75, block: int = 1,
                 draw: torch.Tensor | None = None) -> torch.Tensor:
    """Zero one random RGB channel with probability ``p``
    (augmentation.py:663-703, consistent). ``draw``: the one uniform draw
    the decision is made from, over the leading axes (and the grid cells
    with ``block`` > 1)."""
    if block > 1:
        return _blockwise(lambda c: channel_mask(generator, c, p, 1, draw),
                          clip, block)
    lead = _lead(clip)
    dev = clip.device
    if draw is None:
        draw = _rand(generator, lead, dev)
    u = torch.as_tensor(draw, dtype=torch.float32, device=dev)
    rgb = (u * 100.0).to(torch.int32) // int(100 * (p / 3.0)) - 1
    rgb = rgb.clamp(0, 2)
    on = u >= (1.0 - p)
    ch = torch.arange(clip.shape[-1], device=dev)
    hit = on[..., None] & (ch == rgb[..., None])  # (..., C)
    keep = torch.where(hit, 0.0, 1.0).to(clip.dtype)
    return clip * keep.reshape(*lead, 1, 1, 1, clip.shape[-1])


def random_sized_crop(generator: torch.Generator | None, clip: torch.Tensor,
                      size: int, p: float = 1.0,
                      area_range: tuple[float, float] = (0.5, 1.0),
                      ratio_range: tuple[float, float] = (3 / 4, 4 / 3),
                      draws: dict | None = None) -> torch.Tensor:
    """Clip-consistent random resized crop (reference
    augmentation.py:261-312), the JAX package's branchless form: a target
    area fraction and aspect ratio, the window clamped to the image, a
    bilinear ``scale_and_translate`` to ``size`` x ``size``; with
    probability 1-p the centre crop instead.

    ``draws``: the six draws over the leading axes, ``{'p', 'swap', 'x',
    'y'}`` uniform in [0, 1), ``'area'`` in ``area_range`` and ``'ratio'``
    in ``ratio_range``."""
    lead = _lead(clip)
    T, H, W = clip.shape[-4:-1]
    dev = clip.device
    if draws is None:
        g = generator
        draws = {"p": _rand(g, lead, dev),
                 "area": _uniform(g, *area_range, lead, dev),
                 "ratio": _uniform(g, *ratio_range, lead, dev),
                 "swap": _rand(g, lead, dev), "x": _rand(g, lead, dev),
                 "y": _rand(g, lead, dev)}
    d = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
         for k, v in draws.items()}
    target = d["area"] * H * W
    w = torch.sqrt(target * d["ratio"])
    h = torch.sqrt(target / d["ratio"])
    swap = d["swap"] < 0.5  # the reference's 50 % w/h swap
    w, h = torch.where(swap, h, w), torch.where(swap, w, h)
    w = w.clamp(8.0, W)
    h = h.clamp(8.0, H)
    x0 = d["x"] * (W - w)
    y0 = d["y"] * (H - h)
    do = d["p"] < p
    cw = float(min(H, W, size) if size <= min(H, W) else min(H, W))
    x0 = torch.where(do, x0, torch.full_like(x0, (W - cw) / 2))
    y0 = torch.where(do, y0, torch.full_like(y0, (H - cw) / 2))
    w = torch.where(do, w, torch.full_like(w, cw))
    h = torch.where(do, h, torch.full_like(h, cw))
    scale = torch.stack([size / h, size / w], dim=-1)
    translation = torch.stack([-y0 * size / h, -x0 * size / w], dim=-1)
    return scale_and_translate(clip, (size, size), scale, translation,
                               "bilinear")


def random_rotation(generator: torch.Generator | None, clip: torch.Tensor,
                    degree: float = 15.0, p: float = 1.0,
                    draws: dict | None = None) -> torch.Tensor:
    """Clip-consistent random rotation about the frame centre (reference
    augmentation.py:344-358), bilinear, zero outside the frame, on a fixed
    canvas (the reference expands it; the released pipelines never rotate).
    ``draws``: ``{'p': uniform in [0, 1), 'degree': in [-degree, degree)}``
    over the leading axes."""
    lead = _lead(clip)
    T, H, W, C = clip.shape[-4:]
    dev = clip.device
    if draws is None:
        draws = {"p": _rand(generator, lead, dev),
                 "degree": _uniform(generator, -degree, degree, lead, dev)}
    deg = torch.as_tensor(draws["degree"], dtype=torch.float32, device=dev)
    do = torch.as_tensor(draws["p"], dtype=torch.float32, device=dev) < p
    theta = torch.where(do, deg * math.pi / 180.0, torch.zeros_like(deg))
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - cy
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - cx
    cos = torch.cos(theta)[..., None, None]
    sin = torch.sin(theta)[..., None, None]
    src_y = cy + yy * cos - xx * sin  # (..., H, W)
    src_x = cx + yy * sin + xx * cos
    N = math.prod(lead)
    flat = clip.reshape(N, T, H, W, C)
    src_y, src_x = src_y.reshape(N, H, W), src_x.reshape(N, H, W)
    # jax.scipy.ndimage.map_coordinates, order 1, mode 'constant', cval 0:
    # the four corners in (y, x) order, a corner outside the frame counts 0
    n = torch.arange(N, device=dev)[:, None, None, None]
    t = torch.arange(T, device=dev)[None, :, None, None]
    ly, lx = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - ly, src_x - lx
    nodes_y = [(ly.to(torch.int32), 1 - wy1), (ly.to(torch.int32) + 1, wy1)]
    nodes_x = [(lx.to(torch.int32), 1 - wx1), (lx.to(torch.int32) + 1, wx1)]
    out = None
    for iy, wy in nodes_y:
        for ix, wx in nodes_x:
            valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            vals = flat[n, t, iy.clamp(0, H - 1).long()[:, None],
                        ix.clamp(0, W - 1).long()[:, None]]  # (N,T,H,W,C)
            vals = torch.where(valid[:, None, :, :, None], vals,
                               torch.zeros_like(vals))
            term = (wy * wx)[:, None, :, :, None] * vals
            out = term if out is None else out + term
    return out.reshape(*lead, T, H, W, C)


def pad_frames(clip: torch.Tensor, pad: int, value: float = 0.0
               ) -> torch.Tensor:
    """Border padding of the (H, W) axes (reference Padding /
    ImageOps.expand, augmentation.py:117-122)."""
    return torch.nn.functional.pad(clip, (0, 0, pad, pad, pad, pad),
                                   value=value)


# --------------------------------------------------------------------------
# colour jitter: the reference's consistent / per-frame / gradient-
# consistent variants as factor tensors and a random op order
# --------------------------------------------------------------------------

JITTER_NAMES = ("brightness", "contrast", "saturation", "hue")


def jitter_ranges(brightness: float = 0.8, contrast: float = 0.8,
                  saturation: float = 0.8, hue: float = 0.2
                  ) -> tuple[tuple[float, float], ...]:
    """The factor ranges of the four adjustments, in ``JITTER_NAMES``
    order."""
    return ((max(0.0, 1 - brightness), 1 + brightness),
            (max(0.0, 1 - contrast), 1 + contrast),
            (max(0.0, 1 - saturation), 1 + saturation),
            (-hue, hue))


def linspace_frames(start: torch.Tensor, stop: torch.Tensor,
                    n: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, n)`` along a new last axis, its
    arithmetic: ``start * (1 - s) + stop * s`` with ``s = i / (n - 1)``,
    the last entry ``stop`` itself."""
    if n == 1:
        return start[..., None]
    step = torch.arange(n - 1, dtype=torch.float32,
                        device=start.device) / (n - 1)
    out = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([out, stop[..., None]], dim=-1)


def sample_jitter_factors(generator: torch.Generator, seq_len: int,
                          brightness: float = 0.8, contrast: float = 0.8,
                          saturation: float = 0.8, hue: float = 0.2,
                          mode: str = "consistent", shape=(),
                          device=None) -> dict[str, torch.Tensor]:
    """Per-frame factor vectors, ``(*shape, seq_len)`` each, drawn in
    ``JITTER_NAMES`` order.

    mode: ``'consistent'`` one draw a clip (augmentation.py:596 with
    n_seqblock == seq_len); ``'frame'`` a fresh draw a frame
    (consistent=False); ``'grad'`` a linear ramp from a start to an end draw
    (grad_consistent, augmentation.py:512-525)."""
    if mode not in ("consistent", "frame", "grad"):
        raise ValueError(mode)
    device = device if device is not None else generator.device
    shape = tuple(shape)
    out = {}
    for name, (lo, hi) in zip(JITTER_NAMES, jitter_ranges(
            brightness, contrast, saturation, hue)):
        if mode == "consistent":
            f = _uniform(generator, lo, hi, shape + (1,), device).expand(
                *shape, seq_len)
        elif mode == "frame":
            f = _uniform(generator, lo, hi, shape + (seq_len,), device)
        else:
            ends = _uniform(generator, lo, hi, shape + (2,), device)
            f = linspace_frames(ends[..., 0], ends[..., 1], seq_len)
        out[name] = f
    return out


def apply_jitter(clip: torch.Tensor, factors: torch.Tensor,
                 order: torch.Tensor) -> torch.Tensor:
    """The four adjustments on ``(..., T, H, W, C)`` clips in each clip's
    ``order`` (``(..., 4)`` or one ``(4,)`` for all; 0 brightness, 1
    contrast, 2 saturation, 3 hue), with ``factors`` ``(..., 4, T)``
    (identity factors where a clip is not jittered).

    Slot i applies op ``order[i]`` to each clip. Brightness, contrast and
    saturation run on every clip with the identity factor where the slot
    holds another op, which leaves a clip in [0, 1] bitwise unchanged; hue
    (whose identity is a round trip through HSV) is selected per clip."""
    lead = _lead(clip)
    T = clip.shape[-4]
    dev = clip.device
    factors = torch.as_tensor(factors, dtype=clip.dtype,
                              device=dev).expand(*lead, 4, T)
    order = torch.as_tensor(order, device=dev).long().expand(*lead, 4)
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=clip.dtype,
                         device=dev)[:, None]
    ops = (adjust_brightness, adjust_contrast, adjust_saturation)
    for i in range(4):
        slot = order[..., i]  # (...)
        for k, op in enumerate(ops):
            f = torch.where((slot == k)[..., None], factors[..., k, :],
                            ident[k])
            clip = op(clip, f.reshape(*lead, T, 1, 1, 1))
        hue = (slot == 3).reshape(*lead, 1, 1, 1, 1)
        clip = torch.where(hue, adjust_hue(
            clip, factors[..., 3, :].reshape(*lead, T, 1, 1, 1)), clip)
    return clip


def color_jitter(generator: torch.Generator | None, clip: torch.Tensor,
                 brightness: float = 0.8, contrast: float = 0.8,
                 saturation: float = 0.8, hue: float = 0.2, p: float = 0.8,
                 mode: str = "consistent", block: int = 1,
                 order: torch.Tensor | None = None, gate=True,
                 factors: dict | torch.Tensor | None = None,
                 apply: torch.Tensor | None = None) -> torch.Tensor:
    """Reference ColorJitter (augmentation.py:429-652): with probability
    ``p`` the four adjustments with random factors in a random order,
    otherwise the identity factors (the ops still run, as in the JAX
    package). ``block`` > 1 draws factors, order and apply per spatial grid
    cell.

    ``gate``: an outer random-apply gate ANDed with the ``p`` draw (the
    reference's RandomApply around ColorJitter, pretrain.py:503-505).
    Decisions over the leading axes: ``apply`` (the ``p`` draw's outcome,
    bool), ``factors`` (``sample_jitter_factors``' dict, or ``(..., 4, T)``)
    and ``order`` (``(..., 4)``, or one ``(4,)`` shared by every clip)."""
    if block > 1:
        return _blockwise(
            lambda c: color_jitter(generator, c, brightness, contrast,
                                   saturation, hue, p, mode, 1, order, gate,
                                   factors, apply), clip, block)
    lead = _lead(clip)
    T = clip.shape[-4]
    dev = clip.device
    if apply is None:
        apply = _rand(generator, lead, dev) < p
    if factors is None:
        factors = sample_jitter_factors(generator, T, brightness, contrast,
                                        saturation, hue, mode, lead, dev)
    if isinstance(factors, dict):
        factors = torch.stack([torch.as_tensor(factors[n], device=dev)
                               for n in JITTER_NAMES], dim=-2)
    if order is None:
        order = _rand(generator, lead + (4,), dev).argsort(dim=-1)
    on = torch.as_tensor(apply, device=dev).bool() & torch.as_tensor(
        gate, device=dev).bool()
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)[:, None]
    factors = torch.where(on[..., None, None],
                          torch.as_tensor(factors, dtype=torch.float32,
                                          device=dev), ident)
    return apply_jitter(clip, factors, order)
