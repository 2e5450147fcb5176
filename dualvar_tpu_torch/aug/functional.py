"""Video augmentation primitives on tensors.

Counterpart of the part of ``dualvar_tpu/aug/functional.py`` that the plain
version of the fused augmentation and the classifier's test crops need. Every
colour op takes channels-last float32 frames ``(..., H, W, C)`` in [0, 1];
factors are scalars or tensors that broadcast against the clip (e.g.
``(N, 1, 1, 1, 1)`` for ``(N, T, H, W, C)``). The crops and the flip take
frames of any type, uint8 included, with the same ``(..., H, W, C)`` axes.

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

