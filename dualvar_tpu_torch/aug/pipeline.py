"""The augmentation pipelines on the device: pretrain, the classifier's
train batch, and its eval and test crops.

Counterpart of the fused path of ``dualvar_tpu/aug/pipeline.py``: the host
only produces uint8 frames; the random crop (and the classifier's flip) is
tensor indexing on uint8, and jitter, blur and normalisation run in one pass
through ``ops/aug_fused.py`` (the CUDA kernel on the card, its plain version
on the CPU). The eval and test crops only crop, convert and normalise, as in
the JAX package, and launch no kernel.

Pretrain pipeline weights (reference pretrain.py:523-527): view 0 gets the
null (crop-only) pipeline with probability 0.2 and the full pipeline with
probability 0.8; views 1 and 2 always get the full pipeline. The classifier's
train pipeline (classifier.py:1007-1020) is crop -> whole-clip flip with
probability 0.5 -> colour jitter with probability 0.8, no blur.

Random draws come from an explicit ``torch.Generator`` with the same
distributions and gates as the JAX package (``_draw_clip_params`` there);
the bits differ, so parity tests pass the drawn arrays in explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.aug_fused import aug_fused, aug_fused_plain
from . import functional as F


@dataclass(frozen=True)
class AugConfig:
    """Flags mirrored from the reference argparse groups (pretrain.py:114-126,
    classifier.py:50-105)."""

    img_dim: int = 112
    seq_len: int = 16
    aug_temp_consist: bool = True  # --aug_temp_consist
    aug_temp_grad_consist: bool = False  # latent --aug_temp_grad_consist
    with_color_jitter: bool = True  # classifier --with_color_jitter
    rand_flip: bool = False  # classifier spatial flip (classifier.py:1016)
    normalize: bool = True
    out_dtype: str = "float32"  # 'bfloat16' halves the aug->model traffic
    # 'batch': one jitter op-order draw per (step, view), shared across the
    # batch. 'sample': reference-exact per-clip order (augmentation.py:510).
    jitter_order: str = "batch"
    # 'auto' = the CUDA kernel when the frames lie on a CUDA device; 'on'
    # forces the kernel wrapper; 'off' the plain version, on CPU frames only
    fused: str = "auto"

    @property
    def jitter_mode(self) -> str:
        if self.aug_temp_grad_consist:
            return "grad"
        return "consistent" if self.aug_temp_consist else "frame"


def _rand(generator: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(*shape, generator=generator, device=generator.device)


def _uniform(generator, lo: float, hi: float, *shape) -> torch.Tensor:
    return lo + (hi - lo) * _rand(generator, *shape)


def _draw_jitter(generator: torch.Generator, cfg: AugConfig,
                 apply: torch.Tensor):
    """Colour-jitter factors and op orders for clips laid out as ``apply``
    (B, ...): factors (B, ..., 4) as ``sample_jitter_factors(.., 0.8, 0.8,
    0.8, 0.2, 'consistent')`` where ``apply``, else the identity; orders
    (B, ..., 4) int32, one per clip ('sample') or one per position of the
    trailing axes, shared across the batch ('batch')."""
    g = generator
    shape = tuple(apply.shape)
    drawn = torch.stack([
        _uniform(g, 0.2, 1.8, *shape),  # brightness: [max(0, 1 - .8), 1 + .8]
        _uniform(g, 0.2, 1.8, *shape),  # contrast
        _uniform(g, 0.2, 1.8, *shape),  # saturation
        _uniform(g, -0.2, 0.2, *shape),  # hue
    ], dim=-1)
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0], device=g.device)
    factors = torch.where(apply[..., None], drawn, ident)
    if cfg.jitter_order == "batch":
        orders = _rand(g, *shape[1:], 4).argsort(dim=-1).expand(*shape, 4)
    else:
        orders = _rand(g, *shape, 4).argsort(dim=-1)
    return factors, orders.to(torch.int32).contiguous()


def _draw_clip_params(generator: torch.Generator, cfg: AugConfig, B: int,
                      V: int, H0: int, W0: int):
    """Draw every clip's augmentation parameters, with the distributions and
    gates of the JAX package's ``_draw_clip_params`` / ``pretrain_batch_fused``:

    * crop offsets uniform over the valid window;
    * view 0 takes the null pipeline with probability 0.2;
    * colour jitter: outer gate 0.8 times inner apply 0.8, factors as in
      ``sample_jitter_factors(.., 0.8, 0.8, 0.8, 0.2, 'consistent')``,
      identity when not applied;
    * blur with probability 0.5, sigma ~ U[0.1, 2];
    * op order per clip ('sample') or per (step, view) ('batch').

    Returns crops (B, V, 2) int64 (y0, x0), orders (B, V, 4) int32, factors
    (B, V, 4) float32, blurs (B, V, 2) float32, on the generator's device.
    """
    g = generator
    d = cfg.img_dim
    dev = g.device
    y0 = torch.randint(0, H0 - d + 1, (B, V), generator=g, device=dev)
    x0 = torch.randint(0, W0 - d + 1, (B, V), generator=g, device=dev)
    use_aug = torch.ones(B, V, dtype=torch.bool, device=dev)
    use_aug[:, 0] = _rand(g, B) < 0.8
    jit_on = use_aug & (_rand(g, B, V) < 0.8)
    apply = jit_on & (_rand(g, B, V) < 0.8)
    factors, orders = _draw_jitter(g, cfg, apply)
    blur_on = use_aug & (_rand(g, B, V) < 0.5)
    sigma = _uniform(g, 0.1, 2.0, B, V)
    return (torch.stack([y0, x0], dim=-1), orders, factors,
            torch.stack([sigma, blur_on.float()], dim=-1))


def _crop_planar(frames_u8: torch.Tensor, crops: torch.Tensor, T: int,
                 d: int, flips: torch.Tensor | None = None) -> torch.Tensor:
    """(B, V*T, H0, W0, C) uint8 -> (B*V, C, T, d, d): each clip's own crop
    window and the channels-last -> planar transpose, in one gather. Where
    ``flips`` (one bool a clip) is set, the window's x index runs backwards:
    the crop flipped horizontally, as the JAX package flips the cropped
    clip."""
    B, VT, H0, W0, C = frames_u8.shape
    N = B * (VT // T)
    clips = frames_u8.reshape(N, T, H0, W0, C)
    dev = frames_u8.device
    crops = crops.reshape(N, 2).to(dev)
    span = torch.arange(d, device=dev)
    xspan = span.expand(N, d)
    if flips is not None:
        xspan = torch.where(flips.reshape(N, 1).to(dev), span.flip(0), span)
    n = torch.arange(N, device=dev).reshape(N, 1, 1, 1, 1)
    c = torch.arange(C, device=dev).reshape(1, C, 1, 1, 1)
    t = torch.arange(T, device=dev).reshape(1, 1, T, 1, 1)
    y = (crops[:, 0, None] + span).reshape(N, 1, 1, d, 1)
    x = (crops[:, 1, None] + xspan).reshape(N, 1, 1, 1, d)
    return clips[n, t, y, x, c]


def pretrain_batch_fused(generator: torch.Generator | None,
                         frames_u8: torch.Tensor, cfg: AugConfig, *,
                         crops=None, orders=None, factors=None, blurs=None,
                         kernel: bool = True) -> torch.Tensor:
    """(B, n_views*T, H0, W0, C) uint8 -> (B, n_views, T, d, d, C), the whole
    crop -> jitter -> blur -> normalize chain.

    The decisions are drawn from ``generator`` unless all four arrays
    (``crops`` (B, V, 2), ``orders`` (B, V, 4), ``factors`` (B, V, 4),
    ``blurs`` (B, V, 2)) are given, so a test can hand this and the JAX
    package the same ones. ``kernel=False`` takes the plain version on any
    device. The result is a channels-last view of the planar
    (B, V, C, T, d, d) output, which the model consumes without a copy.
    """
    if cfg.jitter_mode != "consistent":
        raise NotImplementedError(
            f"jitter_mode={cfg.jitter_mode!r}: only clip-consistent jitter is "
            "ported; the per-frame factor modes are queued in ROADMAP.md")
    B, VT, H0, W0, C = frames_u8.shape
    T, d = cfg.seq_len, cfg.img_dim
    V = VT // T
    given = [a is not None for a in (crops, orders, factors, blurs)]
    if not all(given):
        if any(given):
            raise ValueError("give all of crops, orders, factors, blurs or none")
        crops, orders, factors, blurs = _draw_clip_params(
            generator, cfg, B, V, H0, W0)
    dev = frames_u8.device
    planar = _crop_planar(frames_u8, crops, T, d)
    fn = aug_fused if kernel else aug_fused_plain
    out = fn(planar,
             orders.reshape(B * V, 4).to(dev, torch.int32).contiguous(),
             factors.reshape(B * V, 4).to(dev, torch.float32).contiguous(),
             blurs.reshape(B * V, 2).to(dev, torch.float32).contiguous(),
             out_dtype=getattr(torch, cfg.out_dtype),
             normalize=cfg.normalize)
    return out.reshape(B, V, C, T, d, d).permute(0, 1, 3, 4, 5, 2)


def _use_fused(cfg: AugConfig, device: torch.device) -> bool:
    """Single source of truth for kernel-vs-plain: 'auto' means the kernel
    exactly when the frames lie on a CUDA device, 'on' the kernel's wrapper
    (which takes the plain version for CPU frames). 'off' is the plain
    version for CPU frames only: on a CUDA device the JAX package's 'off' is
    its unfused per-frame path, which is not ported, and the plain version
    never stands in for the kernel there."""
    if cfg.fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be auto/on/off, got {cfg.fused!r}")
    if cfg.fused == "off" and device.type == "cuda":
        raise NotImplementedError(
            "fused_aug='off' on a CUDA device: the JAX package's 'off' is the "
            "unfused per-frame augmentation, which is not ported (ROADMAP.md "
            "A.13); use 'auto' or 'on' (the CUDA kernel)")
    if cfg.fused == "auto":
        return device.type == "cuda"
    return cfg.fused == "on"


def pretrain_batch(generator: torch.Generator, frames_u8: torch.Tensor,
                   cfg: AugConfig) -> torch.Tensor:
    """(B, n_views*T, H0, W0, C) uint8 -> (B, n_views, T, d, d, C)."""
    return pretrain_batch_fused(generator, frames_u8, cfg,
                                kernel=_use_fused(cfg, frames_u8.device))


# the classifier ----------------------------------------------------------

def _draw_classifier_params(generator: torch.Generator, cfg: AugConfig,
                            B: int, H0: int, W0: int):
    """Draw every clip's decisions of the classifier's train pipeline, with
    the distributions and gates of the ``draw`` of the JAX package's
    ``classifier_train_batch_fused``:

    * crop offsets uniform over the valid window;
    * a horizontal flip with probability 0.5, only if ``rand_flip``;
    * one jitter apply gate with probability 0.8, only if
      ``with_color_jitter`` (not pretrain's 0.8 x 0.8); factors and orders
      as ``_draw_jitter`` draws them.

    Returns crops (B, 2) int64 (y0, x0), flips (B,) bool, orders (B, 4)
    int32, factors (B, 4) float32, on the generator's device.
    """
    g = generator
    d = cfg.img_dim
    y0 = torch.randint(0, H0 - d + 1, (B,), generator=g, device=g.device)
    x0 = torch.randint(0, W0 - d + 1, (B,), generator=g, device=g.device)
    flips = (_rand(g, B) < 0.5) & cfg.rand_flip
    apply = (_rand(g, B) < 0.8) & cfg.with_color_jitter
    factors, orders = _draw_jitter(g, cfg, apply)
    return torch.stack([y0, x0], dim=-1), flips, orders, factors


def classifier_train_batch_fused(generator: torch.Generator | None,
                                 frames_u8: torch.Tensor, cfg: AugConfig, *,
                                 crops=None, flips=None, orders=None,
                                 factors=None,
                                 kernel: bool = True) -> torch.Tensor:
    """(B, T, H0, W0, C) uint8 -> (B, T, d, d, C): crop -> whole-clip flip
    -> clip-consistent jitter -> normalise, no blur (classifier.py:1007-1020).

    The decisions are drawn from ``generator`` unless all four arrays
    (``crops`` (B, 2), ``flips`` (B,), ``orders`` (B, 4), ``factors``
    (B, 4)) are given. The flip is folded into the uint8 gather; the kernel
    gets blur ``(1, 0)`` (off) for every clip. ``kernel=False`` takes the
    plain version on any device. The result is a channels-last view of the
    planar (B, C, T, d, d) output.
    """
    B, T, H0, W0, C = frames_u8.shape
    d = cfg.img_dim
    given = [a is not None for a in (crops, flips, orders, factors)]
    if not all(given):
        if any(given):
            raise ValueError("give all of crops, flips, orders, factors or "
                             "none")
        crops, flips, orders, factors = _draw_classifier_params(
            generator, cfg, B, H0, W0)
    dev = frames_u8.device
    planar = _crop_planar(frames_u8, crops, T, d, flips=flips)
    blurs = torch.tensor([[1.0, 0.0]], device=dev).expand(B, 2).contiguous()
    fn = aug_fused if kernel else aug_fused_plain
    out = fn(planar, orders.to(dev, torch.int32).contiguous(),
             factors.to(dev, torch.float32).contiguous(), blurs,
             out_dtype=getattr(torch, cfg.out_dtype),
             normalize=cfg.normalize)
    return out.permute(0, 2, 3, 4, 1)


def classifier_train_batch(generator: torch.Generator,
                           frames_u8: torch.Tensor,
                           cfg: AugConfig) -> torch.Tensor:
    """(B, T, H0, W0, C) uint8 -> (B, T, d, d, C). The classifier always
    jitters clip-consistently, whatever the pretrain jitter flags say.
    ``cfg.fused`` chooses as for pretrain (``_use_fused``): the kernel for
    CUDA frames, the plain version for CPU frames; ``'off'`` is refused for
    CUDA frames."""
    return classifier_train_batch_fused(
        generator, frames_u8, cfg, kernel=_use_fused(cfg, frames_u8.device))


def _finish(clip_u8: torch.Tensor, cfg: AugConfig) -> torch.Tensor:
    """uint8 crop -> float32 / 255 -> ImageNet normalisation -> out_dtype."""
    clip = F.to_float(clip_u8)
    if cfg.normalize:
        clip = F.normalize(clip)
    return clip.to(getattr(torch, cfg.out_dtype))


def eval_batch(frames_u8: torch.Tensor, cfg: AugConfig) -> torch.Tensor:
    """val / test pipeline (classifier.py:1022-1029): centre crop only.
    (B, T, H0, W0, C) uint8 -> (B, T, d, d, C)."""
    return _finish(F.center_crop(frames_u8, cfg.img_dim), cfg)


def tencrop_batch(frames_u8: torch.Tensor, cfg: AugConfig, where: int,
                  flip: bool) -> torch.Tensor:
    """Multi-crop test pipeline (classifier.py:589-600): optional flip, then
    crop ``where`` of the five (1-4 corners, 5 centre)."""
    clip = F.hflip(frames_u8) if flip else frames_u8
    return _finish(F.five_crop(clip, cfg.img_dim, where), cfg)


def tenclip_batch(frames_u8: torch.Tensor, cfg: AugConfig) -> torch.Tensor:
    """Temporal-10-clip pipeline (classifier.py:683-695): each clip's centre
    crop. (B, 10*T, H0, W0, C) -> (B, 10, T, d, d, C)."""
    B, _, H0, W0, C = frames_u8.shape
    clips = frames_u8.reshape(B, 10, cfg.seq_len, H0, W0, C)
    return _finish(F.center_crop(clips, cfg.img_dim), cfg)
