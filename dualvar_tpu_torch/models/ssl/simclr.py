"""SimCLR models: naked NT-Xent and the DualVar TimeSeriesV4 variant.

Counterpart of ``dualvar_tpu/models/ssl/simclr.py`` (reference
model/simclr.py). Forward contracts, as in the JAX package:

* ``SimCLRNaked``: ``block`` (B, 2, T, H, W, C) -> dict of
  clip_{logits,labels,contrast_loss} (reference model/simclr.py:19-121);
* ``SimCLRTimeSeriesV4``: ``block`` (B, 3, T, H, W, C) — views [clip1-aug-a,
  clip2, clip1-aug-b] as assembled by the stage-prototype dataset — -> dict
  with clip NT-Xent, TC contrastive and the two shuffle-rank margin losses
  (reference model/simclr.py:130-400).

The modules permute to torch's (B, C, T, H, W) inside.

The per-sample segment permutation for shuffle-rank is drawn from an explicit
``torch.Generator`` unless ``perm`` (B, n_series) is given (tests pass one so
both packages make the same decision).

``nonlinear=False`` drops the clip head: the clip embedding is the
l2-normalised pooled feature (reference model/simclr.py:167-170).
``remat=True`` recomputes the backbone's activations in the backward pass
(``select_backbone``); ``get_features`` then refuses, as in the JAX package.

Precision: the backbone runs under whatever autocast the caller set; the
pooled features are cast to float32 and the heads and losses run with
autocast off, as the JAX package keeps them in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core import spans
from ..backbones import select_backbone
from ..heads import MLPHead
from ..layers import global_avg_pool3d, l2_normalize
from .losses import nt_xent_loss, shuffle_rank_loss, tc_contrast_loss_global


def random_segment_perms(generator: torch.Generator, batch: int,
                         n_series: int) -> torch.Tensor:
    """Per-sample permutations of the n_series segments, (B, n_series) int64
    on the generator's device."""
    noise = torch.rand(batch, n_series, generator=generator,
                       device=generator.device)
    return noise.argsort(dim=1)


def apply_segment_perm(clip: torch.Tensor, perm: torch.Tensor,
                       n_series: int, time_axis: int = 1) -> torch.Tensor:
    """Temporally shuffle a clip's segments: (B, T, H, W, C) x (B, s) -> same.

    Segment s of the output is segment perm[s] of the input (gather —
    reference model/simclr.py:378-383). ``time_axis`` names the T axis for
    other layouts (2 for (B, C, T, H, W)).
    """
    B, T = clip.shape[0], clip.shape[time_axis]
    seg_len = T // n_series
    # frame t of the output is frame perm[t // seg_len] * seg_len + t % seg_len
    frames = (perm.long()[:, :, None] * seg_len
              + torch.arange(seg_len, device=clip.device)).reshape(B, T)
    index = frames.reshape(
        [B] + [T if a == time_axis else 1 for a in range(1, clip.dim())])
    return torch.take_along_dim(clip, index, dim=time_axis)


def calibrate_shuffled(series_feats: torch.Tensor,
                       perm: torch.Tensor) -> torch.Tensor:
    """Scatter per-segment embeddings of a shuffled clip back into original
    order: calibrated[b, perm[b, s]] = series_feats[b, s] (reference
    model/simclr.py:389-392), i.e. a gather with the inverse permutation."""
    inv = perm.long().argsort(dim=1)
    rows = torch.arange(perm.shape[0], device=perm.device)[:, None]
    return series_feats[rows, inv]


def planar_views(block: torch.Tensor) -> torch.Tensor:
    """(B, V, T, H, W, C) -> (B, V, C, T, H, W): a view, and already
    contiguous when the block comes from the fused augmentation, whose
    output is planar."""
    return block.permute(0, 1, 5, 2, 3, 4)


def stage_attention_maps(backbone: nn.Module,
                         x: torch.Tensor) -> list[torch.Tensor]:
    """Per-stage channel-mean attention maps for visualisation (reference
    model/simclr.py:123-127 get_features): ``x`` (B, T, H, W, C) clips
    through a backbone with a ``multi_level`` forward (R(2+1)D) in eval mode
    with no gradient -> one float32 (B, T', H', W') map a stage. The
    backbone's train/eval mode is restored. A rematerialised backbone is
    refused, as the JAX package refuses it."""
    if getattr(backbone, "remat", False):
        raise ValueError(
            "get_features needs the backbone's multi_level forward; build the "
            "model with remat=False for visualization")
    was_training = backbone.training
    backbone.eval()
    try:
        with torch.no_grad():
            _, feats = backbone(x.permute(0, 4, 1, 2, 3), multi_level=True)
    finally:
        backbone.train(was_training)
    return [f.float().mean(dim=1) for f in feats]


class SimCLRNaked(nn.Module):
    """Reference model/simclr.py:19-121 (SimCLR_Naked)."""

    def __init__(self, network: str = "r21d", dim: int = 128,
                 temperature: float = 0.07, nonlinear: bool = True,
                 remat: bool = False):
        super().__init__()
        self.temperature = temperature
        self.nonlinear = nonlinear
        self.backbone, param = select_backbone(network, remat=remat)
        if nonlinear:
            self.clip_head = MLPHead(param["feature_size"], dim)

    def forward(self, block: torch.Tensor) -> dict[str, torch.Tensor]:
        B, n_views = block.shape[:2]
        assert n_views == 2, block.shape
        planar = planar_views(block)
        pooled = global_avg_pool3d(self.backbone(
            planar.reshape(B * 2, *planar.shape[2:]))).float()
        with torch.autocast(device_type=block.device.type, enabled=False), \
                spans.span("dualvar.losses", device=True):
            emb = l2_normalize(
                self.clip_head(pooled) if self.nonlinear else pooled, axis=1)
            with spans.span("dualvar.loss.clip"):
                return nt_xent_loss(emb.reshape(B, 2, -1), self.temperature,
                                    "clip_")

    def get_features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``stage_attention_maps`` of the backbone (reference
        model/simclr.py:123-127)."""
        return stage_attention_maps(self.backbone, x)


class SimCLRTimeSeriesV4(nn.Module):
    """Reference model/simclr.py:130-400 (SimCLR_TimeSeriesV4)."""

    def __init__(self, network: str = "r21d", dim: int = 128,
                 temperature: float = 0.07, n_series: int = 2,
                 series_dim: int = 64, aligned_T: float = 0.07,
                 mode: str = "clip-sr-tc", shufflerank_theta: float = 0.05,
                 dtw_gamma: float = 0.1, packed_encode: bool = False,
                 nonlinear: bool = True, remat: bool = False):
        super().__init__()
        self.temperature = temperature
        self.nonlinear = nonlinear
        self.n_series = n_series
        self.series_dim = series_dim
        self.aligned_T = aligned_T
        self.mode = mode
        self.shufflerank_theta = shufflerank_theta
        self.dtw_gamma = dtw_gamma
        # one (4B) backbone batch [v0, v1, v2, shuffled] instead of
        # (3B) + (B); train-mode BN then sees the merged batch, exactly as
        # the JAX package under the same flag
        self.packed_encode = packed_encode
        self.with_clip = "clip" in mode
        self.with_sr = "sr" in mode
        # 'clip-sr-tc' (paper default, mean similarity) or 'clip-sr-dtw'
        self.with_tc = "tc" in mode or "dtw" in mode
        self.tc_align = "dtw" if "dtw" in mode else "mean"

        self.backbone, param = select_backbone(network, remat=remat)
        feat = param["feature_size"]
        if self.with_clip and nonlinear:
            self.clip_head = MLPHead(feat, dim)
        self.series_head = MLPHead(feat, series_dim * n_series)

    def get_features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``stage_attention_maps`` of the backbone, as for SimCLRNaked."""
        return stage_attention_maps(self.backbone, x)

    def pool_backbone(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, T, H, W) clips -> (N, feat) float32 pooled features."""
        return global_avg_pool3d(self.backbone(x)).float()

    def forward(self, block: torch.Tensor, perm: torch.Tensor | None = None,
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        B, n_views = block.shape[:2]
        assert n_views == 3, block.shape
        planar = planar_views(block)
        x = planar.reshape(B * 3, *planar.shape[2:])
        if self.with_sr:
            if perm is None:
                perm = random_segment_perms(generator, B, self.n_series)
            perm = perm.to(block.device)
            shuffled = apply_segment_perm(planar[:, 2], perm, self.n_series,
                                          time_axis=2)

        sh_pooled = None
        if self.with_sr and self.packed_encode:
            pooled_all = self.pool_backbone(torch.cat([x, shuffled], dim=0))
            pooled, sh_pooled = pooled_all[:3 * B], pooled_all[3 * B:]
        else:
            pooled = self.pool_backbone(x)  # (3B, feat)
            if self.with_sr:
                sh_pooled = self.pool_backbone(shuffled)

        with torch.autocast(device_type=block.device.type, enabled=False), \
                spans.span("dualvar.losses", device=True):
            return self._losses(B, pooled, sh_pooled, perm)

    def _losses(self, B, pooled, sh_pooled, perm):
        """The heads and the loss terms, each term in its span
        ``dualvar.loss.<term>``."""
        ret: dict[str, torch.Tensor] = {}
        if self.with_clip:
            clip_emb = l2_normalize(
                self.clip_head(pooled) if self.nonlinear else pooled, axis=1)
            clip_emb = clip_emb.reshape(B, 3, -1)[:, :2]
            with spans.span("dualvar.loss.clip"):
                ret.update(nt_xent_loss(clip_emb, self.temperature, "clip_"))

        series = l2_normalize(self.series_head(pooled).reshape(
            B, 3, self.n_series, self.series_dim), axis=-1)
        if self.with_tc:
            with spans.span("dualvar.loss.tc"):
                ret.update(tc_contrast_loss_global(
                    series[:, :2], self.aligned_T, "tc_",
                    align=self.tc_align, dtw_gamma=self.dtw_gamma))

        if self.with_sr:
            sh_series = l2_normalize(self.series_head(sh_pooled).reshape(
                B, self.n_series, self.series_dim), axis=-1)
            calibrated = calibrate_shuffled(sh_series, perm)
            # views 0 (first aug of clip1) and 2 (second aug of clip1) each
            # pair with the calibrated shuffled embedding (simclr.py:395-398)
            pair_v0 = torch.stack([series[:, 0], calibrated], dim=2)
            pair_v2 = torch.stack([series[:, 2], calibrated], dim=2)
            with spans.span("dualvar.loss.aug_ranking"):
                ret.update(shuffle_rank_loss(
                    pair_v0, self.shufflerank_theta, 0.5, "aug_ranking_",
                    clip_max=5.0))
            with spans.span("dualvar.loss.unaug_ranking"):
                ret.update(shuffle_rank_loss(
                    pair_v2, self.shufflerank_theta, 0.5, "unaug_ranking_",
                    clip_max=5.0))
        return ret
