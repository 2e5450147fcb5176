"""The augmentation pipelines on the device: pretrain, the classifier's
train batch, and its eval and test crops.

Counterpart of ``dualvar_tpu/aug/pipeline.py``. The host only produces uint8
frames. Two paths, chosen by ``_use_fused`` as the JAX package chooses:

* the fused path: the random crop (and the classifier's flip) is tensor
  indexing on uint8, and jitter, blur and normalisation run in one pass
  through ``ops/aug_fused.py`` (the CUDA kernel for CUDA frames, its plain
  version for CPU frames); it takes clip-consistent jitter only;
* the unfused path (``_pretrain_batch_unfused``,
  ``_classifier_train_batch_unfused``): the per-sample ops of
  ``aug/functional.py`` in sequence over the whole batch, with per-frame
  jitter factors (``jitter_mode`` 'frame' and 'grad') as well. It is the
  counterpart of the JAX package's XLA path, not the kernel's plain version,
  and launches no kernel.

The eval and test crops only crop, convert and normalise, as in the JAX
package, and launch no kernel. The per-sample composers
(``transform_controller`` ... ``two_crops_transform``) mirror the
reference's multi-clip transforms for per-sample use.

Pretrain pipeline weights (reference pretrain.py:523-527): view 0 gets the
null (crop-only) pipeline with probability 0.2 and the full pipeline with
probability 0.8; views 1 and 2 always get the full pipeline. The classifier's
train pipeline (classifier.py:1007-1020) is crop -> whole-clip flip with
probability 0.5 -> colour jitter with probability 0.8, no blur.

Random draws come from an explicit ``torch.Generator`` with the same
distributions and gates as the JAX package (``_draw_clip_params`` there);
the bits differ, so parity tests pass the drawn arrays in explicitly. Both
paths draw the same decisions from the same generator, so in the
clip-consistent mode the unfused path computes what the fused one does.
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
    # 'auto' / 'on': the fused path (the CUDA kernel for CUDA frames, its
    # plain version for CPU frames); 'off': the unfused per-frame path.
    # Jitter that is not clip-consistent takes the unfused path ('on' then
    # raises)
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
    (B, ...): factors as ``sample_jitter_factors(.., 0.8, 0.8, 0.8, 0.2,
    cfg.jitter_mode)`` where ``apply``, else the identity, (B, ..., 4) in
    the clip-consistent mode and (B, ..., 4, T) per frame otherwise; orders
    (B, ..., 4) int32, one per clip ('sample') or one per position of the
    trailing axes, shared across the batch ('batch')."""
    g = generator
    shape = tuple(apply.shape)
    f = F.sample_jitter_factors(g, cfg.seq_len, mode=cfg.jitter_mode,
                                shape=shape)
    drawn = torch.stack([f[n] for n in F.JITTER_NAMES], dim=-2)
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0], device=g.device)[:, None]
    if cfg.jitter_mode == "consistent":  # one draw a clip: (B, ..., 4)
        drawn, ident = drawn[..., 0], ident[:, 0]
    factors = torch.where(apply.reshape(*shape, *([1] * (drawn.dim()
                                                         - len(shape)))),
                          drawn, ident)
    if cfg.jitter_order == "batch":
        orders = _rand(g, *shape[1:], 4).argsort(dim=-1).expand(*shape, 4)
    else:
        orders = _rand(g, *shape, 4).argsort(dim=-1)
    return factors, orders.to(torch.int32).contiguous()


def _draw_clip_params(generator: torch.Generator, cfg: AugConfig, B: int,
                      V: int, H0: int, W0: int,
                      use_aug: torch.Tensor | None = None):
    """Draw every clip's augmentation parameters, with the distributions and
    gates of the JAX package's ``_draw_clip_params`` / ``pretrain_batch_fused``:

    * crop offsets uniform over the valid window;
    * view 0 takes the null pipeline with probability 0.2 (unless
      ``use_aug`` (B, V) is given);
    * colour jitter: outer gate 0.8 times inner apply 0.8, factors as in
      ``sample_jitter_factors(.., 0.8, 0.8, 0.8, 0.2, cfg.jitter_mode)``,
      identity when not applied;
    * blur with probability 0.5, sigma ~ U[0.1, 2];
    * op order per clip ('sample') or per (step, view) ('batch').

    Returns crops (B, V, 2) int64 (y0, x0), orders (B, V, 4) int32, factors
    (B, V, 4) float32 ((B, V, 4, T) for jitter that is not clip-consistent),
    blurs (B, V, 2) float32, on the generator's device.
    """
    g = generator
    d = cfg.img_dim
    dev = g.device
    y0 = torch.randint(0, H0 - d + 1, (B, V), generator=g, device=dev)
    x0 = torch.randint(0, W0 - d + 1, (B, V), generator=g, device=dev)
    if use_aug is None:
        use_aug = torch.ones(B, V, dtype=torch.bool, device=dev)
        use_aug[:, 0] = _rand(g, B) < 0.8
    use_aug = use_aug.to(dev)
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
    The kernel takes clip-consistent jitter only (``_use_fused`` sends the
    other modes to the unfused path).
    """
    assert cfg.jitter_mode == "consistent", cfg.jitter_mode
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


def _use_fused(cfg: AugConfig, check_jitter_mode: bool = True) -> bool:
    """Single source of truth for the fused-vs-unfused dispatch, the JAX
    package's (``dualvar_tpu/aug/pipeline.py:_use_fused``) with the card in
    the TPU's place:

    * jitter that is not clip-consistent takes the unfused path, and
      ``fused='on'`` with it raises ``ValueError`` (the classifier passes
      ``check_jitter_mode=False``: it always jitters clip-consistently);
    * ``'off'`` takes the unfused path on any device;
    * ``'auto'`` and ``'on'`` take the fused path: the kernel for CUDA
      frames, its plain version for CPU frames (where the JAX package's
      'auto' on the CPU takes its unfused path)."""
    if cfg.fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be auto/on/off, got {cfg.fused!r}")
    if check_jitter_mode and cfg.jitter_mode != "consistent":
        if cfg.fused == "on":
            raise ValueError(
                "fused='on' requires clip-consistent jitter "
                f"(jitter_mode={cfg.jitter_mode!r}); use fused='auto'/'off' "
                "for per-frame factor modes")
        return False
    return cfg.fused != "off"


def pretrain_batch(generator: torch.Generator, frames_u8: torch.Tensor,
                   cfg: AugConfig) -> torch.Tensor:
    """(B, n_views*T, H0, W0, C) uint8 -> (B, n_views, T, d, d, C)."""
    if _use_fused(cfg):
        return pretrain_batch_fused(generator, frames_u8, cfg)
    return _pretrain_batch_unfused(generator, frames_u8, cfg)


# the unfused path --------------------------------------------------------

def _finish(clip: torch.Tensor, cfg: AugConfig) -> torch.Tensor:
    """ImageNet normalisation (if asked) -> out_dtype."""
    if cfg.normalize:
        clip = F.normalize(clip)
    return clip.to(getattr(torch, cfg.out_dtype))


def _per_frame_factors(factors: torch.Tensor, n_lead: int,
                       T: int) -> torch.Tensor:
    """Factors over ``n_lead`` leading axes: (..., 4) clip-consistent ones
    -> (..., 4, T); (..., 4, T) as they are."""
    factors = factors.to(torch.float32)
    if factors.dim() == n_lead + 1:
        return factors[..., None].expand(*factors.shape, T)
    return factors


def _unfused_clips(clips_u8: torch.Tensor, cfg: AugConfig, crops, orders,
                   factors, blurs) -> torch.Tensor:
    """The JAX package's ``_augmented_clip`` on clips (..., T, H0, W0, C)
    uint8 with their decisions over the leading axes: crop (on uint8) ->
    float -> colour jitter in each clip's order with per-frame factors ->
    gated blur. -> (..., T, d, d, C) float32 in [0, 1], not normalised."""
    dev = clips_u8.device
    T = clips_u8.shape[-4]
    n_lead = clips_u8.dim() - 4
    clip = F.to_float(F.random_crop(None, clips_u8, cfg.img_dim,
                                    offsets=crops.to(dev)))
    clip = F.apply_jitter(clip, _per_frame_factors(factors.to(dev), n_lead,
                                                   T), orders.to(dev))
    blurs = blurs.to(dev, torch.float32)
    return F.gaussian_blur(clip, blurs[..., 0], on=blurs[..., 1] > 0)


def _pretrain_batch_unfused(generator: torch.Generator | None,
                            frames_u8: torch.Tensor, cfg: AugConfig, *,
                            crops=None, orders=None, factors=None,
                            blurs=None) -> torch.Tensor:
    """The unfused pretrain batch, the JAX package's
    ``_pretrain_batch_unfused``: (B, n_views*T, H0, W0, C) uint8 ->
    (B, n_views, T, d, d, C), every view through ``_augmented_clip``'s ops
    over the whole batch at once, with any ``jitter_mode``.

    The decisions (``_draw_clip_params``: crops (B, V, 2), orders (B, V, 4),
    factors (B, V, 4) or (B, V, 4, T), blurs (B, V, 2)) are drawn from
    ``generator`` unless all four are given; ``jitter_order='batch'`` shares
    each view's order across the batch."""
    B, VT, H0, W0, C = frames_u8.shape
    T = cfg.seq_len
    V = VT // T
    given = [a is not None for a in (crops, orders, factors, blurs)]
    if not all(given):
        if any(given):
            raise ValueError("give all of crops, orders, factors, blurs or none")
        crops, orders, factors, blurs = _draw_clip_params(
            generator, cfg, B, V, H0, W0)
    clips = frames_u8.reshape(B, V, T, H0, W0, C)
    return _finish(_unfused_clips(clips, cfg, crops, orders, factors, blurs),
                   cfg)


def _augmented_clip(generator: torch.Generator, clip_u8: torch.Tensor,
                    cfg: AugConfig, use_aug=True,
                    order: torch.Tensor | None = None) -> torch.Tensor:
    """One clip (T, H0, W0, C) uint8: crop -> [jitter p=.8 outer] -> [blur
    p=.5] -> (T, d, d, C) float32, not normalised; ``use_aug`` gates the two
    random applies (the null pipeline is crop-only, pretrain.py:493-497).
    ``order``: an op order (4,) drawn outside, e.g. shared by a batch."""
    T, H0, W0, _ = clip_u8.shape
    crops, orders, factors, blurs = _draw_clip_params(
        generator, cfg, 1, 1, H0, W0,
        use_aug=torch.as_tensor(use_aug).reshape(1, 1))
    if order is not None:
        orders = torch.as_tensor(order).reshape(1, 1, 4)
    return _unfused_clips(clip_u8[None, None], cfg, crops, orders, factors,
                          blurs)[0, 0]


def pretrain_sample(generator: torch.Generator, frames_u8: torch.Tensor,
                    cfg: AugConfig,
                    orders: torch.Tensor | None = None) -> torch.Tensor:
    """One pretrain sample: (n_views*T, H0, W0, C) uint8 ->
    (n_views, T, d, d, C), normalised: each view an independent pipeline
    draw, view 0 the null pipeline with probability 0.2 (pretrain.py:523-527;
    MultiRandomizedTransform, augmentation.py:795-810). ``orders``: optional
    (n_views, 4) op orders drawn outside."""
    VT, H0, W0, C = frames_u8.shape
    V = VT // cfg.seq_len
    crops, drawn, factors, blurs = _draw_clip_params(generator, cfg, 1, V,
                                                     H0, W0)
    if orders is not None:
        drawn = torch.as_tensor(orders).reshape(1, V, 4)
    return _pretrain_batch_unfused(None, frames_u8[None], cfg, crops=crops,
                                   orders=drawn, factors=factors,
                                   blurs=blurs)[0]


# the reference's generic multi-clip composers (augmentation.py:733-894):
# each takes per-clip transforms fn(generator, clip) -> clip of one output
# shape and composes them as the reference's PIL-list composers did. The
# decisions (a uniform draw each) are drawn from the generator unless given.

def _draw(generator, given) -> float:
    if given is not None:
        return float(given)
    return float(torch.rand((), generator=generator,
                            device=generator.device))


def transform_controller(generator: torch.Generator, clip: torch.Tensor,
                         fns, weights, pick=None) -> torch.Tensor:
    """Pick one transform by weight and apply it (reference
    TransformController, augmentation.py:869-882). ``pick``: the uniform
    draw the choice is made from."""
    total = float(sum(weights))
    cum = torch.cumsum(torch.tensor([w / total for w in weights],
                                    dtype=torch.float32), dim=0)
    u = torch.tensor([_draw(generator, pick)], dtype=torch.float32)
    idx = min(int(torch.searchsorted(cum, u, right=True)), len(fns) - 1)
    return fns[idx](generator, clip)


def randomized_transform(generator: torch.Generator, frames: torch.Tensor,
                         fns, weights, seq_len: int,
                         picks=None) -> torch.Tensor:
    """Per-clip weighted transform choice over a multi-clip frame list
    (reference RandomizedTransform, augmentation.py:813-839). ``weights``:
    one distribution for every clip, or one a clip (MultiRandomizedTransform,
    augmentation.py:782-810); ``picks``: one uniform draw a clip."""
    n_clips = frames.shape[0] // seq_len
    clips = frames.reshape(n_clips, seq_len, *frames.shape[1:])
    if not hasattr(weights[0], "__len__"):
        weights = [weights] * n_clips
    return torch.cat([
        transform_controller(generator, clips[i], fns, weights[i],
                             None if picks is None else picks[i])
        for i in range(n_clips)], dim=0)


def two_clip_transform(generator: torch.Generator, frames: torch.Tensor,
                       base_fn, null_fn, seq_len: int, p: float = 0.3,
                       picks=None) -> torch.Tensor:
    """Each of two clips independently gets base with probability p, else
    null (reference TwoClipTransform, augmentation.py:733-758)."""
    return randomized_transform(generator, frames, [base_fn, null_fn],
                                [p, 1.0 - p], seq_len, picks)


def one_clip_transform(generator: torch.Generator, frames: torch.Tensor,
                       base_fn, null_fn, seq_len: int, half=None,
                       swap=None) -> torch.Tensor:
    """Keep one of the two clips (random), give [base(x), null(x)] in a
    random order (reference OneClipTransform, augmentation.py:842-866).
    ``half`` / ``swap``: the two uniform draws."""
    clips = frames.reshape(2, seq_len, *frames.shape[1:])
    x = clips[0] if _draw(generator, half) < 0.5 else clips[1]
    swapped = _draw(generator, swap) < 0.5
    a, b = base_fn(generator, x), null_fn(generator, x)
    return torch.cat([a, b] if swapped else [b, a], dim=0)


def multiple_clip_transform(generator: torch.Generator, frames: torch.Tensor,
                            fns, seq_len: int) -> torch.Tensor:
    """Apply fns[i] to clip i of a multi-clip frame list (reference
    MultipleClipTransform, augmentation.py:761-780)."""
    n_clips = frames.shape[0] // seq_len
    assert n_clips == len(fns), (n_clips, len(fns))
    clips = frames.reshape(n_clips, seq_len, *frames.shape[1:])
    return torch.cat([fns[i](generator, clips[i]) for i in range(n_clips)],
                     dim=0)


def two_crops_transform(generator: torch.Generator, clip: torch.Tensor,
                        base_fn) -> torch.Tensor:
    """Two independent draws of the same pipeline -> (2, ...) views
    (reference TwoCropsTransform, augmentation.py:886-894)."""
    return torch.stack([base_fn(generator, clip), base_fn(generator, clip)])


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
    ``cfg.fused`` chooses as for pretrain (``_use_fused``): the fused path
    for 'auto' and 'on', the unfused one for 'off'."""
    if _use_fused(cfg, check_jitter_mode=False):
        return classifier_train_batch_fused(generator, frames_u8, cfg)
    return _classifier_train_batch_unfused(generator, frames_u8, cfg)


def classifier_train_sample(generator: torch.Generator,
                            frames_u8: torch.Tensor, cfg: AugConfig,
                            order: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The finetune / linear-probe train pipeline on one clip
    (classifier.py:1007-1020): (T, H0, W0, C) uint8 -> (T, d, d, C), crop
    -> [whole-clip flip] -> [consistent jitter p=.8] -> normalise.
    ``order``: an op order (4,) drawn outside."""
    T, H0, W0, _ = frames_u8.shape
    crops, flips, orders, factors = _draw_classifier_params(
        generator, cfg, 1, H0, W0)
    if order is not None:
        orders = torch.as_tensor(order).reshape(1, 4)
    return _classifier_train_batch_unfused(
        None, frames_u8[None], cfg, crops=crops, flips=flips, orders=orders,
        factors=factors)[0]


def _classifier_train_batch_unfused(generator: torch.Generator | None,
                                    frames_u8: torch.Tensor, cfg: AugConfig,
                                    *, crops=None, flips=None, orders=None,
                                    factors=None) -> torch.Tensor:
    """The unfused classifier train batch, the JAX package's
    ``_classifier_train_batch_unfused``: (B, T, H0, W0, C) uint8 ->
    (B, T, d, d, C), crop -> float -> [whole-clip flip] -> [clip-consistent
    jitter] -> normalise, no blur. The decisions as
    ``classifier_train_batch_fused`` takes them."""
    B, T, H0, W0, C = frames_u8.shape
    given = [a is not None for a in (crops, flips, orders, factors)]
    if not all(given):
        if any(given):
            raise ValueError("give all of crops, flips, orders, factors or "
                             "none")
        crops, flips, orders, factors = _draw_classifier_params(
            generator, cfg, B, H0, W0)
    dev = frames_u8.device
    clip = F.to_float(F.random_crop(None, frames_u8, cfg.img_dim,
                                    offsets=crops.to(dev)))
    if cfg.rand_flip:
        clip = F.random_hflip(None, clip, flip=flips.to(dev))
    if cfg.with_color_jitter:
        clip = F.apply_jitter(clip, _per_frame_factors(factors.to(dev), 1, T),
                              orders.to(dev))
    return _finish(clip, cfg)


def _finish_u8(clip_u8: torch.Tensor, cfg: AugConfig) -> torch.Tensor:
    """uint8 crop -> float32 / 255 -> ImageNet normalisation -> out_dtype."""
    return _finish(F.to_float(clip_u8), cfg)


def eval_batch(frames_u8: torch.Tensor, cfg: AugConfig) -> torch.Tensor:
    """val / test pipeline (classifier.py:1022-1029): centre crop only.
    (B, T, H0, W0, C) uint8 -> (B, T, d, d, C)."""
    return _finish_u8(F.center_crop(frames_u8, cfg.img_dim), cfg)


def tencrop_batch(frames_u8: torch.Tensor, cfg: AugConfig, where: int,
                  flip: bool) -> torch.Tensor:
    """Multi-crop test pipeline (classifier.py:589-600): optional flip, then
    crop ``where`` of the five (1-4 corners, 5 centre)."""
    clip = F.hflip(frames_u8) if flip else frames_u8
    return _finish_u8(F.five_crop(clip, cfg.img_dim, where), cfg)


def tenclip_batch(frames_u8: torch.Tensor, cfg: AugConfig) -> torch.Tensor:
    """Temporal-10-clip pipeline (classifier.py:683-695): each clip's centre
    crop. (B, 10*T, H0, W0, C) -> (B, 10, T, d, d, C)."""
    B, _, H0, W0, C = frames_u8.shape
    clips = frames_u8.reshape(B, 10, cfg.seq_len, H0, W0, C)
    return _finish_u8(F.center_crop(clips, cfg.img_dim), cfg)
