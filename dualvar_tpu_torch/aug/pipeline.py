"""The pretrain augmentation pipeline on the device.

Counterpart of the fused path of ``dualvar_tpu/aug/pipeline.py``: the host
only produces uint8 frames; the random crop is tensor indexing on uint8, and
jitter, blur and normalisation run in one pass through
``ops/aug_fused.py`` (the CUDA kernel on the card, its plain version on the
CPU).

Pretrain pipeline weights (reference pretrain.py:523-527): view 0 gets the
null (crop-only) pipeline with probability 0.2 and the full pipeline with
probability 0.8; views 1 and 2 always get the full pipeline.

Random draws come from an explicit ``torch.Generator`` with the same
distributions and gates as the JAX package (``_draw_clip_params`` there);
the bits differ, so parity tests pass the drawn arrays in explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.aug_fused import aug_fused, aug_fused_plain


@dataclass(frozen=True)
class AugConfig:
    """Flags mirrored from the reference argparse groups (pretrain.py:114-126)."""

    img_dim: int = 112
    seq_len: int = 16
    aug_temp_consist: bool = True  # --aug_temp_consist
    aug_temp_grad_consist: bool = False  # latent --aug_temp_grad_consist
    normalize: bool = True
    out_dtype: str = "float32"  # 'bfloat16' halves the aug->model traffic
    # 'batch': one jitter op-order draw per (step, view), shared across the
    # batch. 'sample': reference-exact per-clip order (augmentation.py:510).
    jitter_order: str = "batch"
    # 'auto' = the CUDA kernel when the frames lie on a CUDA device;
    # 'on' forces the kernel wrapper, 'off' the plain version
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
    drawn = torch.stack([
        _uniform(g, 0.2, 1.8, B, V),  # brightness: [max(0, 1 - .8), 1 + .8]
        _uniform(g, 0.2, 1.8, B, V),  # contrast
        _uniform(g, 0.2, 1.8, B, V),  # saturation
        _uniform(g, -0.2, 0.2, B, V),  # hue
    ], dim=-1)
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)
    factors = torch.where(apply[..., None], drawn, ident)
    if cfg.jitter_order == "batch":
        orders = _rand(g, V, 4).argsort(dim=-1).expand(B, V, 4)
    else:
        orders = _rand(g, B, V, 4).argsort(dim=-1)
    blur_on = use_aug & (_rand(g, B, V) < 0.5)
    sigma = _uniform(g, 0.1, 2.0, B, V)
    return (torch.stack([y0, x0], dim=-1), orders.to(torch.int32).contiguous(),
            factors, torch.stack([sigma, blur_on.float()], dim=-1))


def _crop_planar(frames_u8: torch.Tensor, crops: torch.Tensor, T: int,
                 d: int) -> torch.Tensor:
    """(B, V*T, H0, W0, C) uint8 -> (B*V, C, T, d, d): each clip's own crop
    window and the channels-last -> planar transpose, in one gather."""
    B, VT, H0, W0, C = frames_u8.shape
    N = B * (VT // T)
    clips = frames_u8.reshape(N, T, H0, W0, C)
    dev = frames_u8.device
    crops = crops.reshape(N, 2).to(dev)
    span = torch.arange(d, device=dev)
    n = torch.arange(N, device=dev).reshape(N, 1, 1, 1, 1)
    c = torch.arange(C, device=dev).reshape(1, C, 1, 1, 1)
    t = torch.arange(T, device=dev).reshape(1, 1, T, 1, 1)
    y = (crops[:, 0, None] + span).reshape(N, 1, 1, d, 1)
    x = (crops[:, 1, None] + span).reshape(N, 1, 1, 1, d)
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
    exactly when the frames lie on a CUDA device."""
    if cfg.fused == "auto":
        return device.type == "cuda"
    if cfg.fused not in ("on", "off"):
        raise ValueError(f"fused must be auto/on/off, got {cfg.fused!r}")
    return cfg.fused == "on"


def pretrain_batch(generator: torch.Generator, frames_u8: torch.Tensor,
                   cfg: AugConfig) -> torch.Tensor:
    """(B, n_views*T, H0, W0, C) uint8 -> (B, n_views, T, d, d, C)."""
    return pretrain_batch_fused(generator, frames_u8, cfg,
                                kernel=_use_fused(cfg, frames_u8.device))
