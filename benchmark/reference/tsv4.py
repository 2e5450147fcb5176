"""SimCLR-TimeSeriesV4, the DualVar objective (BMVC 2021; the reference's
``model/simclr.py``), in plain float32 PyTorch, with its SGD step.

A sample is three clips: view 0 and view 2 two augmentations of clip 1,
view 1 clip 2. The backbone encodes the 3B clips and, separately, view 2
with its ``n_series`` temporal segments shuffled. Heads: a two-layer MLP to
a 128-d clip embedding and one to ``n_series`` x 64-d segment embeddings,
all l2-normalised. Losses, summed:

* clip NT-Xent between views 0 and 1 (temperature 0.07, every other clip
  of the batch a negative);
* temporal coherence: NT-Xent on the segment embeddings' means of views 0
  and 1 (temperature 0.07);
* two shuffle-rank margin losses (weight 0.5, theta 0.05, exponent clipped
  at 5): the shuffled clip's segment embeddings, put back in order, must
  match the same segment of view 0 (``aug_ranking``) and of view 2
  (``unaug_ranking``) above every other segment.

SGD: momentum 0.9, weight decay 1e-4 added to the gradient, lr 0.003, on
every parameter.
"""

from __future__ import annotations

import importlib

import torch
from torch import nn

from .layers import Linear, Numerics

LOSS_NAMES = ("clip_loss", "tc_loss", "aug_ranking_margin_loss",
              "unaug_ranking_margin_loss")


def l2n(x, dim=-1):
    return x / x.square().sum(dim=dim, keepdim=True).sqrt().clamp_min(1e-12)


class MLPHead(nn.Module):
    def __init__(self, num: Numerics, feat: int, out: int):
        super().__init__()
        self.fc1 = Linear(num, feat, feat)
        self.fc2 = Linear(num, feat, out)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def nt_xent(z: torch.Tensor, temperature: float) -> torch.Tensor:
    """z (B, 2, D) unit rows; row i of view v has its partner in the other
    view as the positive and all other 2B-2 rows as negatives."""
    B = z.shape[0]
    f = z.transpose(0, 1).reshape(2 * B, -1)
    sim = (f @ f.T) / temperature
    eye = torch.eye(2 * B, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye, float("-inf"))
    target = (torch.arange(2 * B, device=z.device) + B) % (2 * B)
    return torch.nn.functional.cross_entropy(sim, target)


def shuffle_rank(pair: torch.Tensor, theta: float, weight: float,
                 clip_max: float = 5.0) -> torch.Tensor:
    """pair (B, s, 2, D) unit rows: each of the 2s segment embeddings
    against its same-segment partner in the other half, with a softplus
    margin over every other non-self embedding."""
    B, s = pair.shape[:2]
    f = pair.transpose(1, 2).reshape(B, 2 * s, -1)
    sim = f @ f.transpose(1, 2)
    idx = torch.arange(2 * s, device=pair.device)
    seg, half = idx % s, idx // s
    partner = (seg[:, None] == seg[None, :]) & (half[:, None] != half[None, :])
    other = ~(partner | (idx[:, None] == idx[None, :]))
    best = (sim * partner).sum(dim=2, keepdim=True)
    margin = torch.log1p(torch.exp(((sim - best) / theta).clamp_max(clip_max)))
    return weight * (margin * other).sum() / (B * 2 * s * (2 * s - 2))


class TSV4(nn.Module):
    def __init__(self, cfg: dict, num: Numerics):
        super().__init__()
        net = importlib.import_module(f"{__package__}.{cfg['backbone']}")
        self.backbone = net.build(num, cfg)
        self.conv_init = net.CONV_INIT
        feat = net.FEATURE_SIZE
        self.n_series, self.series_dim = cfg["n_series"], cfg["series_dim"]
        self.temperature, self.aligned_T = cfg["temperature"], cfg["aligned_T"]
        self.theta = cfg["shufflerank_theta"]
        self.clip_head = MLPHead(num, feat, cfg["dim"])
        self.series_head = MLPHead(num, feat, self.series_dim * self.n_series)

    def shuffle(self, clip: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
        """(B, C, T, H, W): output segment j is input segment perm[:, j]."""
        B, T = clip.shape[0], clip.shape[2]
        L = T // self.n_series
        frames = (perm[:, :, None] * L
                  + torch.arange(L, device=clip.device)).reshape(B, 1, T, 1, 1)
        return clip.gather(2, frames.expand(B, *clip.shape[1:]))

    def forward(self, block: torch.Tensor, perm: torch.Tensor) -> dict:
        """block (B, 3, T, H, W, 3) -> the four losses."""
        B = block.shape[0]
        planar = block.permute(0, 1, 5, 2, 3, 4)  # (B, 3, C, T, H, W)
        x = planar.reshape(B * 3, *planar.shape[2:])
        shuffled = self.shuffle(planar[:, 2], perm)
        # the heads and losses take float32 features
        pooled = self.backbone(x).mean(dim=(2, 3, 4)).float()
        sh_pooled = self.backbone(shuffled).mean(dim=(2, 3, 4)).float()
        s, D = self.n_series, self.series_dim
        clip = l2n(self.clip_head(pooled)).reshape(B, 3, -1)[:, :2]
        series = l2n(self.series_head(pooled).reshape(B, 3, s, D))
        sh = l2n(self.series_head(sh_pooled).reshape(B, s, D))
        # segment perm[b, j] of the original is sh[b, j]: put it back
        back = torch.empty_like(sh)
        rows = torch.arange(B, device=sh.device)[:, None]
        back[rows, perm] = sh
        return {
            "clip_loss": nt_xent(clip, self.temperature),
            "tc_loss": nt_xent(series[:, :2].mean(dim=2), self.aligned_T),
            "aug_ranking_margin_loss": shuffle_rank(
                torch.stack([series[:, 0], back], dim=2), self.theta, 0.5),
            "unaug_ranking_margin_loss": shuffle_rank(
                torch.stack([series[:, 2], back], dim=2), self.theta, 0.5),
        }


class SGD:
    """torch.optim.SGD's arithmetic with momentum, dampening 0, weight
    decay added to the gradient."""

    def __init__(self, params, lr: float, momentum: float, wd: float):
        self.params = list(params)
        self.lr, self.momentum, self.wd = lr, momentum, wd
        self.buf = [None] * len(self.params)

    @torch.no_grad()
    def step(self):
        for i, p in enumerate(self.params):
            d = p.grad + self.wd * p
            if self.buf[i] is None:
                self.buf[i] = d.clone()
            else:
                self.buf[i].mul_(self.momentum).add_(d)
            p.sub_(self.lr * self.buf[i])
