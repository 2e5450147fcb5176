"""Contrastive / ranking losses of the DualVar objective, as plain functions.

Counterpart of ``dualvar_tpu/models/ssl/losses.py`` (reference
model/simclr.py). Every loss builds the same fixed-width logit matrix as the
JAX package, ``[positive | full similarity row]`` with the positive and
diagonal columns of the row masked to ``NEG_INF``, so logits compare with
the JAX functions element by element. Cross-entropy with target 0 and top-k
accuracies equal the reference's gathered layout because a masked column can
never win.

The TC similarity "mean of the pairwise segment-similarity matrix" equals
the inner product of the series-mean embeddings, and is computed that way.
"""

from __future__ import annotations

import torch

from ...ops.soft_dtw import soft_dtw

NEG_INF = -1.0e9


def cross_entropy_from_logits(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss parity: mean of -log softmax[target]."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, labels[:, None].long())[:, 0]
    return -picked.mean()


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks=(1, 5)) -> tuple[torch.Tensor, ...]:
    """Reference utils/utils.py:75-92 calc_topk_accuracy."""
    maxk = min(max(ks), logits.shape[-1])
    pred = logits.topk(maxk, dim=-1).indices  # (B, maxk)
    correct = pred == labels[:, None]
    return tuple(
        correct[:, : min(k, maxk)].any(dim=1).float().mean() for k in ks)


def _loss_dict(prefix: str, logits: torch.Tensor,
               loss: torch.Tensor) -> dict[str, torch.Tensor]:
    labels = torch.zeros(logits.shape[0], dtype=torch.int32,
                         device=logits.device)
    return {
        f"{prefix}logits": logits,
        f"{prefix}labels": labels,
        f"{prefix}contrast_loss": loss,
    }


def nt_xent_loss(features: torch.Tensor, temperature: float,
                 prefix: str = "clip_") -> dict[str, torch.Tensor]:
    """SimCLR NT-Xent over two views with every other clip as negative
    (reference model/simclr.py:183-229). ``features``: (N, 2, dim), already
    L2-normalised.

    Returns ``{prefix}logits`` of width 1 + 2N: column 0 is the positive
    (other view of the same clip), the rest is the full similarity row with
    its own diagonal and positive entries masked to NEG_INF.
    """
    N, n_views, dim = features.shape
    assert n_views == 2, features.shape
    # view-major layout (2N, dim): index v*N + i — reference simclr.py:193
    f = features.transpose(0, 1).reshape(2 * N, dim)
    return _nt_xent_from_sim(f @ f.T, N, temperature, prefix)


def _nt_xent_from_sim(sim: torch.Tensor, N: int, temperature: float,
                      prefix: str) -> dict[str, torch.Tensor]:
    """The ``[positive | masked row]`` logits and their cross-entropy from a
    (2N, 2N) similarity matrix in view-major order."""
    idx = torch.arange(2 * N, device=sim.device)
    clip_id = idx % N
    same_clip = clip_id[:, None] == clip_id[None, :]
    diag = idx[:, None] == idx[None, :]
    pos_mask = same_clip & ~diag  # exactly one True per row for 2 views
    pos = torch.where(pos_mask, sim, 0.0).sum(dim=1, keepdim=True)
    rest = torch.where(same_clip, NEG_INF, sim)  # mask diagonal AND positive
    logits = torch.cat([pos, rest], dim=1) / temperature
    loss = cross_entropy_from_logits(
        logits, torch.zeros(2 * N, dtype=torch.long, device=sim.device))
    return _loss_dict(prefix, logits, loss)


def dtw_alignment_similarity(a: torch.Tensor, b: torch.Tensor,
                             gamma: float = 0.1) -> torch.Tensor:
    """Soft-DTW alignment similarity between batches of segment sequences.

    ``a``: (..., n, d), ``b``: (..., m, d), broadcastable on the leading
    axes. Returns the negated soft-DTW of the *negated* inner-product cost,
    normalised by max(n, m): a differentiable soft-max over monotone
    alignment paths of the total segment similarity (the reference's
    DTW-aligned TC ablation, utils/soft_dtw_cuda.py:321-331), scaled to be
    comparable with the mean-similarity score.

    The cost tensor of the broadcast product, e.g. (B, K, n, m) for queries
    against a queue, is flattened to the contiguous row-major (B*K, n, m)
    float32 batch that the soft-DTW kernels read (``ops/soft_dtw.py``).
    """
    D = torch.einsum("...nd,...md->...nm", a, b)
    lead, (n, m) = D.shape[:-2], D.shape[-2:]
    flat = (-D).reshape(-1, n, m).contiguous()
    vals = -soft_dtw(flat, gamma, 0.0)
    return vals.reshape(lead) / max(n, m)


def tc_contrast_loss_global(series_features: torch.Tensor, temperature: float,
                            prefix: str = "tc_", align: str = "mean",
                            dtw_gamma: float = 0.1
                            ) -> dict[str, torch.Tensor]:
    """Temporal-coherent contrastive loss, SimCLR (global-matrix) form
    (reference model/simclr.py:280-337). ``series_features``:
    (N, 2, n_series, dim), per-segment L2-normalised.

    align='mean' (paper default): video-to-video similarity is the mean
    pairwise segment similarity == inner product of segment means.
    align='dtw': soft-DTW alignment similarity over the segment sequences
    (the reference's DTW ablation; the soft-DTW kernels on the card).
    """
    N, n_views, n_series, dim = series_features.shape
    assert n_views == 2, series_features.shape
    if align == "mean":
        return nt_xent_loss(series_features.mean(dim=2), temperature, prefix)
    if align != "dtw":
        raise ValueError(f"unknown align {align!r}")
    # view-major sequence batch (2N, s, d), pairwise DTW similarity matrix
    f = series_features.transpose(0, 1).reshape(2 * N, n_series, dim)
    sim = dtw_alignment_similarity(f[:, None], f[None, :], gamma=dtw_gamma)
    return _nt_xent_from_sim(sim, N, temperature, prefix)


def shuffle_rank_loss(pair_features: torch.Tensor, theta: float,
                      weight: float = 1.0, prefix: str = "ranking_",
                      clip_max: float | None = 5.0) -> dict[str, torch.Tensor]:
    """Shuffle-rank margin loss over per-segment embeddings (reference
    model/simclr.py:231-278). ``pair_features``: (B, n_series, 2, dim),
    L2-normalised — axis 2 pairs a reference embedding with its
    shuffle-calibrated counterpart.

    Each of the 2*n_series embeddings must match its same-segment other-view
    partner above every non-partner, non-self embedding, with a softplus
    margin: mean log(1 + exp((other - partner)/theta)), the exponent
    argument clipped at ``clip_max`` (simclr.py:260).

    ``{prefix}margin_logits``: (B*2s, 1 + 2s) — col 0 the partner similarity,
    the rest the row with self+partner masked to NEG_INF.
    """
    B, n_series, n_views, dim = pair_features.shape
    assert n_views == 2, pair_features.shape
    s2 = 2 * n_series
    # (B, 2s, dim), view-major: [view0 s0..s_{n-1}, view1 s0..] — simclr.py:246
    f = pair_features.transpose(1, 2).reshape(B, s2, dim)
    sim = f @ f.transpose(1, 2)  # (B, 2s, 2s)

    idx = torch.arange(s2, device=f.device)
    seg = idx % n_series
    view = idx // n_series
    diag = idx[:, None] == idx[None, :]
    corr = (seg[:, None] == seg[None, :]) & (view[:, None] != view[None, :])
    left = ~(diag | corr)  # (2s, 2s), 2s-2 True per row

    highest = torch.where(corr[None], sim, 0.0).sum(dim=2, keepdim=True)
    diff = (sim - highest) / theta
    if clip_max is not None:
        diff = diff.clamp_max(clip_max)
    per_entry = torch.log1p(torch.exp(diff))
    n_left = s2 - 2
    margin_loss = weight * torch.where(left[None], per_entry, 0.0).sum() / (
        B * s2 * n_left)

    rest = torch.where(left[None], sim, NEG_INF)
    margin_logits = torch.cat([highest, rest], dim=2).reshape(B * s2, 1 + s2)
    labels = torch.zeros(B * s2, dtype=torch.int32, device=f.device)
    return {
        f"{prefix}margin_logits": margin_logits,
        f"{prefix}margin_labels": labels,
        f"{prefix}margin_contrast_loss": margin_loss,
    }


def moco_contrast_loss(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
                       temperature: float,
                       prefix: str = "clip_") -> dict[str, torch.Tensor]:
    """MoCo InfoNCE against the negative queue (reference model/moco.py:
    426-438). ``q`` / ``k``: (B, dim) normalised; ``queue``: (K, dim) rows.
    No gradient flows through k or the queue."""
    k, queue = k.detach(), queue.detach()
    pos = (q * k).sum(dim=1, keepdim=True)
    neg = q @ queue.T  # (B, K)
    logits = torch.cat([pos, neg], dim=1) / temperature
    loss = cross_entropy_from_logits(
        logits, torch.zeros(q.shape[0], dtype=torch.long, device=q.device))
    return _loss_dict(prefix, logits, loss)


def moco_tc_contrast_loss(q_series: torch.Tensor, k_series: torch.Tensor,
                          series_queue: torch.Tensor, temperature: float,
                          prefix: str = "tc_", align: str = "mean",
                          dtw_gamma: float = 0.1) -> dict[str, torch.Tensor]:
    """Temporal-coherent loss, MoCo (queue) form (reference model/moco.py:
    404-424). ``q_series`` / ``k_series``: (B, n_series, dim);
    ``series_queue``: (K, n_series*dim), per-segment layout matching
    ``reshape(K, n_series, dim)``.

    align='mean' (paper default): mean pairwise segment similarity == inner
    product of segment means. align='dtw': soft-DTW alignment similarity of
    every query against its key (B pairs) and against the whole queue (B*K
    pairs), two calls of the soft-DTW function.
    """
    B, n_series, dim = q_series.shape
    k_series, series_queue = k_series.detach(), series_queue.detach()
    queue_seq = series_queue.reshape(-1, n_series, dim)
    if align == "mean":
        qm = q_series.mean(dim=1)  # (B, dim)
        pos = (qm * k_series.mean(dim=1)).sum(dim=1, keepdim=True)
        neg = qm @ queue_seq.mean(dim=1).T
    elif align == "dtw":
        pos = dtw_alignment_similarity(q_series, k_series,
                                       gamma=dtw_gamma)[:, None]
        neg = dtw_alignment_similarity(q_series[:, None], queue_seq[None, :],
                                       gamma=dtw_gamma)  # (B, K)
    else:
        raise ValueError(f"unknown align {align!r}")
    logits = torch.cat([pos, neg], dim=1) / temperature
    loss = cross_entropy_from_logits(
        logits, torch.zeros(B, dtype=torch.long, device=q_series.device))
    return _loss_dict(prefix, logits, loss)
