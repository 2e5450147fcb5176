"""MoCo models: momentum key encoder + ring-buffer negative queue.

Counterpart of ``dualvar_tpu/models/ssl/moco.py`` (reference model/moco.py).
The JAX package threads the key encoder, the queues and the pointer through
its train step as explicit state (``MoCoState``); here one ``nn.Module``,
``MoCo``, owns them, PyTorch's idiom:

* ``encoder_q`` — the query encoder, the only part the optimizer updates;
* ``encoder_k`` — the EMA key encoder (reference moco.py:103-107), same
  architecture, ``requires_grad=False``. Its parameters move only by
  ``momentum_update``; its BN running statistics are not averaged, they
  evolve from its own train-mode forwards;
* buffers ``queue (K, dim)`` and ``series_queue (K, n_series*series_dim)``,
  row-major ring buffers as in the JAX package (the reference stores them
  column-major, moco.py:319-323), and one shared ``queue_ptr``, written in
  place by ``dequeue_and_enqueue`` (K % batch == 0). Under a process group
  (``core/dist.py``) the keys of every rank are all-gathered and enqueued
  together, so the pointer moves by the global batch W*B, as the JAX
  package's step on the global batch moves it; the queues stay equal on
  every rank.

``MoCoEncoder`` is the shared encoder architecture (backbone + pool + clip
head + series head). ``moco_naked_forward`` and ``moco_timeseries_forward``
are the two forwards; ``MoCo.forward`` picks one.

A train-mode forward mutates the module (EMA, BN statistics, queues,
pointer) as the JAX forward returns new state: the returned losses see the
queues as they were *before* this step's keys were written.

Random decisions have explicit seams for the tests: ``perm`` (segment
shuffle) and ``bn_perm`` (the batch permutation of the BN-shuffle mode);
without them they are drawn from the ``generator`` handed in (``bn_perm``
by rank 0 under a process group, and broadcast).

The BN-shuffle mode (``shuffle_bn_groups`` > 0, the reference's
``_batch_shuffle_ddp`` / ``_batch_unshuffle_ddp``) computes the JAX
package's grouped key pass on the global batch; under a process group each
process encodes its share of the groups (``shuffled_key_encode``).

``nonlinear=False`` drops the clip heads: the clip embedding is the
l2-normalised pooled feature, and the clip queue is as wide as the
backbone's feature. ``remat=True`` recomputes the query encoder's backbone
activations in the backward pass (the key encoder runs without gradients,
so its forward is plain).

Precision: the backbones run under the caller's autocast; the pooled
features are cast to float32 and the heads and every loss run with autocast
off, so the soft-DTW cost matrices are float32.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ...core import dist, spans
from ..backbones import select_backbone
from ..heads import MLPHead
from ..layers import global_avg_pool3d, l2_normalize, local_batch_norm
from .losses import (moco_contrast_loss, moco_tc_contrast_loss,
                     shuffle_rank_loss)
from .simclr import (apply_segment_perm, calibrate_shuffled, planar_views,
                     random_segment_perms, stage_attention_maps)


class MoCoEncoder(nn.Module):
    """backbone + global pool + clip MLP head + series MLP head (reference
    moco.py:279-292, encoder_q + series_proj_head_q); the key encoder is the
    same architecture with its own parameters."""

    def __init__(self, network: str = "r21d", dim: int = 128,
                 n_series: int = 2, series_dim: int = 64,
                 with_series: bool = True, nonlinear: bool = True,
                 remat: bool = False):
        super().__init__()
        self.n_series = n_series
        self.series_dim = series_dim
        self.nonlinear = nonlinear
        self.backbone, param = select_backbone(network, remat=remat)
        feat = param["feature_size"]
        # the clip embedding's width: the head's, or the pooled feature's
        self.clip_dim = dim if nonlinear else feat
        if nonlinear:
            self.clip_head = MLPHead(feat, dim)
        if with_series:
            self.series_head = MLPHead(feat, series_dim * n_series)

    def pooled(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, T, H, W) clips -> (N, feat) float32 pooled features."""
        return global_avg_pool3d(self.backbone(x)).float()

    def _series(self, pooled: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.series_head(pooled).reshape(
            -1, self.n_series, self.series_dim), axis=-1)

    def forward(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """-> (clip_emb (N, dim) normalised, series (N, s, d) normalised or
        None for an encoder without a series head)."""
        p = self.pooled(x)
        with torch.autocast(device_type=x.device.type, enabled=False):
            clip_emb = l2_normalize(
                self.clip_head(p) if self.nonlinear else p, axis=1)
            series = self._series(p) if hasattr(self, "series_head") else None
        return clip_emb, series

    def get_features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``stage_attention_maps`` of this encoder's backbone (the query
        encoder's, called on ``MoCo.encoder_q``)."""
        return stage_attention_maps(self.backbone, x)

    def series_embed(self, x: torch.Tensor) -> torch.Tensor:
        """backbone + pool + series head only (the SR dual pass, reference
        moco.py:551-557)."""
        p = self.pooled(x)
        with torch.autocast(device_type=x.device.type, enabled=False):
            return self._series(p)


def momentum_update(encoder_q: nn.Module, encoder_k: nn.Module,
                    m: float) -> None:
    """k <- m*k + (1-m)*q on the parameters, in place, in float32 (reference
    moco.py:103-107). BN buffers are not touched."""
    with torch.no_grad():
        params_k = list(encoder_k.parameters())
        torch._foreach_mul_(params_k, m)
        torch._foreach_add_(params_k, list(encoder_q.parameters()),
                            alpha=1.0 - m)


def dequeue_and_enqueue(queue: torch.Tensor, ptr: torch.Tensor,
                        keys: torch.Tensor) -> None:
    """Ring-buffer insert of the key batch at ``ptr``, in place (reference
    moco.py:109-126); the caller advances the pointer. ``keys`` is the
    global batch's (W*B rows under a process group); requires K % (W*B) ==
    0. The rows are addressed through a device tensor, so the pointer is
    never read back to the host."""
    K, B = queue.shape[0], keys.shape[0]
    if K % B != 0:
        raise ValueError(
            f"queue size {K} must be divisible by the global batch size {B}")
    with torch.no_grad():
        rows = ptr + torch.arange(B, device=queue.device)
        queue.index_copy_(0, rows, keys.detach().to(queue.dtype))


def shuffled_key_encode(encoder: MoCoEncoder, x2: torch.Tensor, groups: int,
                        bn_perm: torch.Tensor):
    """BN batch-shuffle parity mode (reference moco.py:128-173): permute the
    global key batch with ``bn_perm``, split it into ``groups`` device-sized
    groups, run the key encoder on each group alone (BN reduces within the
    group only, per-GPU BN semantics), invert the permutation. Every group
    starts from the same running statistics and the new running statistics
    are the mean over the groups, as in the JAX package.

    Without a process group ``x2`` is the global batch. Under one (world
    size 1 too) each process holds B rows of the global W*B, as the
    reference's ``_batch_shuffle_ddp``: the key views are all-gathered,
    process r encodes groups ``r*groups/W`` to ``(r+1)*groups/W - 1`` of
    the permuted batch (``groups`` must be a multiple of W) with its batch
    norms local (``local_batch_norm``), the running statistics' sums are
    added over the processes (one all-reduce a dtype), and the keys and
    series of every process are gathered, unpermuted, and this process's
    B rows kept. ``bn_perm`` is the global permutation, the same on every
    process. Returns (keys, series or None) of this process's rows."""
    world, rank = dist.world_size(), dist.rank()
    if groups % world != 0:
        raise ValueError(
            f"moco_shuffle_bn={groups} groups cannot be shared by {world} "
            "processes: it must be a multiple of the world size")
    B = x2.shape[0]
    x_all = dist.all_gather(x2) if dist.active() else x2
    if x_all.shape[0] % groups != 0:
        raise ValueError(f"batch {x_all.shape[0]} is not divisible into "
                         f"{groups} groups")
    bn_perm = bn_perm.to(x2.device).long()
    per = groups // world
    chunks = x_all[bn_perm].chunk(groups)[rank * per:(rank + 1) * per]
    buffers = list(encoder.buffers())  # the BN running statistics
    start = [b.clone() for b in buffers]
    sums = [torch.zeros_like(b) for b in buffers]
    keys, series = [], []
    with local_batch_norm():
        for chunk in chunks:
            for b, s in zip(buffers, start):
                b.copy_(s)
            k, s = encoder(chunk)
            keys.append(k)
            series.append(s)
            torch._foreach_add_(sums, buffers)
    dist.sum_tensors_(sums)
    for b, s in zip(buffers, sums):
        b.copy_(s / groups)
    k = torch.cat(keys)
    s = torch.cat(series) if series[0] is not None else None
    if dist.active():
        both = k if s is None else torch.cat(
            [k, s.reshape(k.shape[0], -1)], dim=1)
        both = dist.all_gather(both)
        k = both[:, :k.shape[1]]
        if s is not None:
            s = both[:, k.shape[1]:].reshape(-1, *s.shape[1:])
    inv = bn_perm.argsort()
    k = k[inv]
    s = s[inv] if s is not None else None
    if dist.active():
        rows = slice(rank * B, (rank + 1) * B)
        k = k[rows]
        s = s[rows] if s is not None else None
    return k, s


class MoCo(nn.Module):
    """Reference model/moco.py: MoCo_Naked (``naked=True``: clip InfoNCE
    only, 2 views) and MoCo_TimeSeriesV4 (clip + TC + shuffle-rank losses,
    3 views)."""

    def __init__(self, network: str = "r21d", dim: int = 128, K: int = 2048,
                 m: float = 0.999, temperature: float = 0.07,
                 n_series: int = 2, series_dim: int = 64,
                 aligned_T: float = 0.07, mode: str = "clip-sr-tc",
                 dtw_gamma: float = 0.1, naked: bool = False,
                 shuffle_bn_groups: int = 0, packed_encode: bool = False,
                 nonlinear: bool = True, remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.m = m
        self.temperature = temperature
        self.aligned_T = aligned_T
        self.mode = mode
        self.dtw_gamma = dtw_gamma
        self.naked = naked
        self.shuffle_bn_groups = shuffle_bn_groups
        self.packed_encode = packed_encode
        self.encoder_q = MoCoEncoder(network, dim, n_series, series_dim,
                                     with_series=not naked,
                                     nonlinear=nonlinear, remat=remat)
        # the key encoder starts as a copy of the query encoder (reference
        # moco.py:310-315) and is never seen by the optimizer
        self.encoder_k = copy.deepcopy(self.encoder_q).requires_grad_(False)
        # queues start as normalised gaussian noise (reference moco.py:317-323)
        self.register_buffer("queue", l2_normalize(torch.randn(
            K, self.encoder_q.clip_dim, generator=generator), axis=1))
        if not naked:
            noise = torch.randn(K, n_series, series_dim, generator=generator)
            self.register_buffer("series_queue", l2_normalize(
                noise, axis=-1).reshape(K, n_series * series_dim))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.long))

    def key_pass(self, x2: torch.Tensor, bn_perm: torch.Tensor | None,
                 generator: torch.Generator | None):
        """EMA update of the key parameters from the current query
        parameters, then the key encoder's forward, without gradients
        (reference order, moco.py:508). In eval mode only the forward."""
        with torch.no_grad():
            if not self.training:
                return self.encoder_k(x2)
            # no collective: the parameters are equal on every rank
            with spans.span("dualvar.moco.momentum_update"):
                momentum_update(self.encoder_q, self.encoder_k, self.m)
            if not self.shuffle_bn_groups:
                return self.encoder_k(x2)
            if bn_perm is None:
                bn_perm = self.draw_bn_perm(x2, generator)
            return shuffled_key_encode(self.encoder_k, x2,
                                       self.shuffle_bn_groups, bn_perm)

    @staticmethod
    def draw_bn_perm(x2: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
        """The BN-shuffle mode's permutation of the global key batch:
        drawn from ``generator``; under a process group by rank 0 alone and
        broadcast (the processes' generators differ), so that rank 0 draws
        what a run of one process draws."""
        n = x2.shape[0] * dist.world_size()
        if dist.rank() == 0:
            perm = torch.randperm(n, generator=generator,
                                  device=generator.device).to(x2.device)
        else:
            perm = torch.empty(n, dtype=torch.long, device=x2.device)
        if dist.active():
            dist.broadcast_(perm, 0)
        return perm

    def enqueue(self, k: torch.Tensor, series_k: torch.Tensor | None) -> None:
        """Write this step's keys of every rank (one all-gather of both) into
        both queues at the shared pointer and advance it by their count (the
        span ``dualvar.moco.enqueue``)."""
        with spans.span("dualvar.moco.enqueue"):
            if series_k is not None:
                series_k = series_k.reshape(k.shape[0], -1)
            if dist.active():
                both = (k if series_k is None
                        else torch.cat([k, series_k], dim=1))
                both = dist.all_gather(both.detach())
                k, series_k = both[:, :k.shape[1]], (
                    None if series_k is None else both[:, k.shape[1]:])
            dequeue_and_enqueue(self.queue, self.queue_ptr, k)
            if series_k is not None:
                dequeue_and_enqueue(self.series_queue, self.queue_ptr,
                                    series_k)
            self.queue_ptr.add_(k.shape[0]).remainder_(self.queue.shape[0])

    def forward(self, block: torch.Tensor, perm: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                bn_perm: torch.Tensor | None = None
                ) -> dict[str, torch.Tensor]:
        if self.naked:
            return moco_naked_forward(self, block, generator=generator,
                                      bn_perm=bn_perm)
        return moco_timeseries_forward(self, block, perm=perm,
                                       generator=generator, bn_perm=bn_perm)


def moco_naked_forward(model: MoCo, block: torch.Tensor,
                       generator: torch.Generator | None = None,
                       bn_perm: torch.Tensor | None = None
                       ) -> dict[str, torch.Tensor]:
    """Reference moco.py:175-239 (MoCo_Naked.forward). ``block``:
    (B, 2, T, H, W, C) -> clip_{logits,labels,contrast_loss}."""
    assert block.shape[1] == 2, block.shape
    planar = planar_views(block)
    q, _ = model.encoder_q(planar[:, 0])
    k, _ = model.key_pass(planar[:, 1], bn_perm, generator)
    with torch.autocast(device_type=block.device.type, enabled=False), \
            spans.span("dualvar.losses", device=True), \
            spans.span("dualvar.loss.clip"):
        # a copy: the queue is kept for the backward of q and written below
        ret = moco_contrast_loss(q, k, model.queue.clone(),
                                 model.temperature, "clip_")
    if model.training:
        model.enqueue(k, None)
    return ret


def moco_timeseries_forward(model: MoCo, block: torch.Tensor,
                            perm: torch.Tensor | None = None,
                            generator: torch.Generator | None = None,
                            bn_perm: torch.Tensor | None = None
                            ) -> dict[str, torch.Tensor]:
    """Reference moco.py:482-573 (MoCo_TimeSeriesV4.forward). ``block``:
    (B, 3, T, H, W, C) with views [clip1-aug-a, clip2, clip1-aug-b].

    Order in train mode (reference moco.py:296-335): query pass; EMA update,
    then the key pass; the clip and TC losses on the queues as they stand;
    the enqueue; then the SR dual pass over ``[aug_x1, shuffled]``, whose BN
    running statistics continue from what the query pass wrote, and the two
    rank losses. ``packed_encode`` merges the dual pass into the query pass,
    one (3B) batch ``[x1, aug_x1, shuffled]``: train-mode BN then sees the
    merged batch, as in the JAX package under the same flag.

    MoCo's shuffle-rank loss differs from SimCLR's: theta fixed at 0.05,
    weight 0.5, no clipping of the exponent (reference moco.py:469).
    """
    B = block.shape[0]
    assert block.shape[1] == 3, block.shape
    enc_q = model.encoder_q
    planar = planar_views(block)
    x1, x2, aug_x1 = planar[:, 0], planar[:, 1], planar[:, 2]
    with_sr = "sr" in model.mode
    packed_sr = model.packed_encode and with_sr
    if with_sr:
        if perm is None:
            perm = random_segment_perms(generator, B, enc_q.n_series)
        perm = perm.to(block.device)
        shuffled = apply_segment_perm(aug_x1, perm, enc_q.n_series,
                                      time_axis=2)

    if packed_sr:
        clip_all, series_all = enc_q(torch.cat([x1, aug_x1, shuffled]))
        q, series_q = clip_all[:B], series_all[:B]
        aug_series, sh_raw = series_all[B:2 * B], series_all[2 * B:]
    else:
        q, series_q = enc_q(x1)
    k, series_k = model.key_pass(x2, bn_perm, generator)

    autocast_off = torch.autocast(device_type=block.device.type,
                                  enabled=False)
    with autocast_off, spans.span("dualvar.losses", device=True):
        # copies: the queues are kept for the backward of q and written below
        with spans.span("dualvar.loss.clip"):
            ret = moco_contrast_loss(q, k, model.queue.clone(),
                                     model.temperature, "clip_")
        if "tc" in model.mode or "dtw" in model.mode:
            with spans.span("dualvar.loss.tc"):
                ret.update(moco_tc_contrast_loss(
                    series_q, series_k, model.series_queue.clone(),
                    model.aligned_T, "tc_",
                    align="dtw" if "dtw" in model.mode else "mean",
                    dtw_gamma=model.dtw_gamma))
    if model.training:
        model.enqueue(k, series_k)

    if with_sr:
        if not packed_sr:
            dual = enc_q.series_embed(torch.cat([aug_x1, shuffled]))
            aug_series, sh_raw = dual[:B], dual[B:]
        with autocast_off, spans.span("dualvar.losses", device=True):
            calibrated = calibrate_shuffled(sh_raw, perm)
            pair_unaug = torch.stack([series_q, calibrated], dim=2)
            pair_aug = torch.stack([aug_series, calibrated], dim=2)
            with spans.span("dualvar.loss.unaug_ranking"):
                ret.update(shuffle_rank_loss(pair_unaug, 0.05, 0.5,
                                             "unaug_ranking_", clip_max=None))
            with spans.span("dualvar.loss.aug_ranking"):
                ret.update(shuffle_rank_loss(pair_aug, 0.05, 0.5,
                                             "aug_ranking_", clip_max=None))
    return ret
