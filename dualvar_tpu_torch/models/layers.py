"""Shared building blocks for the 3D-CNN video backbones.

Counterpart of ``dualvar_tpu/models/layers.py``. Inside the backbones all
tensors are torch's ``(B, C, T, H, W)``; convolutions are ``Conv3d``, an
``nn.Conv3d`` (its default init is the init the JAX package copies:
kaiming-uniform with a=sqrt(5), i.e. U(+-1/sqrt(fan_in))); S3D and
ResNet-2d3d redraw theirs with ``normal_init_`` and
``kaiming_fan_out_init_``.

On the card each backbone's ``forward`` puts its input in
``channels_last_3d`` memory (``card_layout``), and every convolution, batch
norm, ReLU, residual add, pool and ``cat`` keeps it: cuDNN's bf16
convolutions on Hopper are NHWC kernels, which take such a map without a
transpose, and ATen's batch norm takes its channels-last kernels (through
a 4-D view, ``_channels_last_4d``).
Parameters and state dicts stay NCDHW, and CPU tensors keep the layout
they come in.

The JAX package's space-to-depth stem and phase-split stride-2 data gradient
are rewrites of this same math for another machine; cuDNN convolutions take
their place. Its hand-VJP one-pass batch norm (``_bn_train_fused``) is
``_OnePassBN`` below, taken when ``DUALVAR_BN_STATS=pallas`` selects the
channel-sum kernel for its two reductions; otherwise ATen's batch norm runs,
as the JAX package's default runs its XLA sums.

Under a process group (``core/dist.py``) every train-mode batch norm
normalises with the global batch's statistics, as the JAX package's
sharded step does: the one-pass route all-reduces its sums, the default
route takes ``torch.nn.SyncBatchNorm``'s arithmetic (``_SyncBN``).
Inside ``local_batch_norm()`` they normalise with this process's batch
alone (MoCo's batch-shuffled key pass, whose groups are per-process batches
by design).

Under activation rematerialisation (``select_backbone(..., remat=True)``)
the backward recomputes the backbone's forward in train mode. JAX's remat
throws the recomputed batch statistics away; here the recomputation reuses
the batch statistics of the step's first forward (``remat_contexts``), so the
running statistics are folded, the statistics' sums launched and their
collectives issued once a step, as without remat.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

from ..core import dist, spans
from ..ops.bn_stats import channel_sums, channel_sums_plain, use_kernel_stats


def card_layout(x: torch.Tensor) -> torch.Tensor:
    """A 5-D CUDA tensor in ``channels_last_3d`` memory (itself if it is
    already); any other tensor as it is."""
    if x.is_cuda and x.dim() == 5:
        return x.contiguous(memory_format=torch.channels_last_3d)
    return x


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` that counts, as ``nchw_convs`` in the open step
    (``core/spans.py:count``), each call whose 5-D input is not in
    ``channels_last_3d`` memory: on the card, a call that cuDNN transposes
    to NHWC and back."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 5 and not x.is_contiguous(
                memory_format=torch.channels_last_3d):
            spans.count("nchw_convs")
        return super().forward(x)


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    if x.dim() == 5 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last_3d):
        return torch.channels_last_3d
    return torch.contiguous_format


def _channels_last_4d(x: torch.Tensor) -> torch.Tensor:
    """A ``(N, C, T, H, W)`` map in ``channels_last_3d`` memory as the
    ``(N, C, T*H, W)`` view of the same memory, which is ``channels_last``;
    any other tensor as it is. On the card ATen's batch norm takes its
    channels-last kernels for a 4-D channels-last map, and for a 5-D one its
    general reductions, whose forward statistics hold a staging buffer of
    hundreds of MB at the flagship's first-stage maps."""
    if x.dim() == 5 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last_3d):
        n, c, t, h, w = x.shape
        return x.view(n, c, t * h, w)
    return x


def _sums(a: torch.Tensor, b: torch.Tensor):
    """Per-channel (sum a, sum a*b) over every axis but 1: the channel-sum
    kernel (its plain version on the CPU), or, for float64 inputs, its plain
    version in float64, as the JAX package routes float64 away from its
    kernel (``_use_pallas_stats``)."""
    if a.dtype == torch.float64:
        return channel_sums_plain(a, b, dim=1)
    return channel_sums(a, b, dim=1)


def _global_sums(*sums: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Per-channel sums added over the ranks, in one all-reduce."""
    flat = dist.all_reduce_(torch.cat(sums))
    return flat.split([s.numel() for s in sums])


class _OnePassBN(torch.autograd.Function):
    """Train-mode batch norm core with a hand-written backward, the
    counterpart of ``dualvar_tpu/models/layers.py:_bn_train_fused``:

    forward   s1, s2 = sums(x, x); mu = s1/n; var = max(s2/n - mu^2, 0);
              inv = rsqrt(var + eps); y = x*a + b in x's dtype, with
              a = inv*scale and b = bias - mu*inv*scale;
    backward  s_g, s_gx = sums(g, x); dscale = (s_gx - mu*s_g)*inv;
              dbias = s_g; dx = g*A + x*C + B.

    Returns (y, mu, var); mu and var feed only the running statistics and
    carry no gradient, as under the JAX package's stop_gradient.

    ``synced``: the sums are added over the ranks before use, (s1, s2) in
    the forward and (s_g, s_gx) in the backward, and n is the global count,
    so each rank normalises with the global batch's statistics and takes
    the global batch's dx (every rank's ``x`` has the same shape). dscale
    and dbias stay this rank's share: the gradient average over the ranks
    adds them up.

    ``stats``: (mu, var) of an earlier forward of the same ``x`` (the
    recomputation under remat), used in place of the sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, synced=False, stats=None):
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        n = x.numel() // x.shape[1]
        if synced:
            # every rank's batch has this shape (the loaders drop a short
            # last batch): the global count stays a host number, as the
            # local one is, and mu rounds as without a group
            n *= dist.world_size()
        if stats is None:
            s1, s2 = _sums(x, x)
            if synced:
                s1, s2 = _global_sums(s1, s2)
            mu = s1 / n
            var = (s2 / n - mu * mu).clamp_min(0.0)
        else:
            mu, var = stats
        inv = torch.rsqrt(var + eps)
        sc = weight.to(acc) * inv
        shape = (1, -1) + (1,) * (x.dim() - 2)
        a = sc.to(x.dtype).view(shape)
        b = (bias.to(acc) - mu * sc).to(x.dtype).view(shape)
        ctx.save_for_backward(x, weight, mu, inv)
        ctx.n, ctx.synced = n, synced
        ctx.mark_non_differentiable(mu, var)
        return x * a + b, mu, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _gmu, _gvar):
        x, weight, mu, inv = ctx.saved_tensors
        acc = mu.dtype
        n = ctx.n
        g = g.contiguous(memory_format=_memory_format(x))
        s_g, s_gx = _sums(g, x)
        s_gc = s_gx - mu * s_g  # sum g*(x - mu)
        dscale, dbias = (s_gc * inv).to(weight.dtype), s_g.to(weight.dtype)
        if ctx.synced:
            s_g, s_gc = _global_sums(s_g, s_gc)
        A = inv * weight.to(acc)
        C = -A * inv * inv * s_gc / n
        B = -A * s_g / n - C * mu
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dx = (g * A.to(g.dtype).view(shape) + x * C.to(x.dtype).view(shape)
              + B.to(x.dtype).view(shape))
        return dx, dscale, dbias, None, None, None


def _plain_stats(x: torch.Tensor, eps: float):
    """Per-channel (mean, invstd) of ``x`` over every axis but 1, as
    ``torch.batch_norm_stats`` returns them (its arithmetic, in plain
    torch; ATen has no CPU version)."""
    dims = [d for d in range(x.dim()) if d != 1]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    var, mean = torch.var_mean(x.to(acc), dim=dims, correction=0)
    return mean, torch.rsqrt(var + eps)


class _SyncBN(torch.autograd.Function):
    """Train-mode batch norm over the global batch with
    ``torch.nn.SyncBatchNorm``'s arithmetic (``torch/nn/modules/
    _functions.py``): each rank's (mean, invstd, count), all-gathered and
    combined by ``batch_norm_gather_stats_with_counts``; y by
    ``batch_norm_elemt``; the backward's (sum dy, sum dy*(x - mean)) from
    ``batch_norm_backward_reduce``, all-reduced, and dx by
    ``batch_norm_backward_elemt``. These ATen functions run on the card
    only; CPU tensors take the same arithmetic in plain torch.

    Returns (y, mean, biased var, invstd, counts); like ``_OnePassBN``, the
    statistics feed the running statistics (and a recomputation) only.
    dweight and dbias stay this rank's share, as SyncBatchNorm's do.

    ``stats``: (mean, invstd, counts) of an earlier forward of the same
    ``x`` (the recomputation under remat), used in place of the gather."""

    @staticmethod
    def _global_stats(x, eps):
        C = x.shape[1]
        if x.is_cuda:
            mean, invstd = torch.batch_norm_stats(x, eps)
        else:
            mean, invstd = _plain_stats(x, eps)
        count = torch.full((1,), x.numel() // C, dtype=mean.dtype,
                           device=mean.device)
        gathered = dist.all_gather(torch.cat([mean, invstd, count])[None])
        mean_all, invstd_all, count_all = gathered.split([C, C, 1], dim=1)
        counts = count_all.reshape(-1)
        if x.is_cuda:
            # running statistics to fold into at momentum 0, so that ATen
            # takes float32 counts with a bfloat16 input (without them it
            # wants counts in the input's type); the module folds its own
            scratch = torch.zeros((2, C), dtype=mean.dtype, device=x.device)
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                x, mean_all, invstd_all, scratch[0], scratch[1], 0.0, eps,
                counts)
        else:
            n = counts.sum()
            mean = (counts[:, None] * mean_all).sum(0) / n
            var_all = invstd_all.pow(-2) - eps
            var = (counts[:, None] * (var_all + (mean_all - mean).square())
                   ).sum(0) / n
            invstd = torch.rsqrt(var + eps)
        return mean, invstd, counts

    @staticmethod
    def forward(ctx, x, weight, bias, eps, stats=None):
        x = x.contiguous(memory_format=_memory_format(x))
        mean, invstd, counts = (_SyncBN._global_stats(x, eps)
                                if stats is None else stats)
        if x.is_cuda:
            y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            shape = (1, -1) + (1,) * (x.dim() - 2)
            scale = (invstd * weight.to(invstd.dtype)).view(shape)
            y = ((x - mean.view(shape)) * scale
                 + bias.to(invstd.dtype).view(shape)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd,
                              counts.to(torch.int32))
        var = invstd.pow(-2) - eps
        ctx.mark_non_differentiable(mean, var, invstd, counts)
        return y, mean, var, invstd, counts

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _gmean, _gvar, _ginvstd, _gcounts):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        g = g.contiguous(memory_format=_memory_format(x))
        if x.is_cuda:
            sum_dy, sum_dy_xmu, dweight, dbias = \
                torch.batch_norm_backward_reduce(g, x, mean, invstd, weight,
                                                 True, True, True)
        else:
            shape = (1, -1) + (1,) * (x.dim() - 2)
            dims = [d for d in range(x.dim()) if d != 1]
            acc = invstd.dtype
            xmu = x.to(acc) - mean.view(shape)
            sum_dy = g.to(acc).sum(dims)
            sum_dy_xmu = (g.to(acc) * xmu).sum(dims)
            dweight = (sum_dy_xmu * invstd).to(weight.dtype)
            dbias = sum_dy.to(weight.dtype)
        sum_dy, sum_dy_xmu = _global_sums(sum_dy, sum_dy_xmu)
        if x.is_cuda:
            w = weight.to(mean.dtype) if weight.dtype != mean.dtype \
                else weight
            dx = torch.batch_norm_backward_elemt(
                g, x, mean, invstd, w, sum_dy, sum_dy_xmu, counts)
        else:
            n = counts.sum().to(acc)
            dx = ((g.to(acc) - (sum_dy / n).view(shape)
                   - xmu * (invstd * invstd * sum_dy_xmu / n).view(shape))
                  * (invstd * weight.to(acc)).view(shape)).to(x.dtype)
        return dx, dweight, dbias, None, None


class _RematStats:
    """The batch statistics the batch norms of one checkpointed forward
    computed, in call order, for its recomputation to reuse."""

    def __init__(self):
        self.saved: list = []
        self.next = 0


# (stats, replaying) of the checkpointed region being run, if any: a thread
# local, because the recomputation runs on the autograd engine's thread
_REMAT = threading.local()


@contextlib.contextmanager
def _remat_region(stats: _RematStats, replaying: bool):
    outer = getattr(_REMAT, "region", None)
    _REMAT.region = (stats, replaying)
    stats.next = 0
    try:
        yield
    finally:
        _REMAT.region = outer


def remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: one record a checkpointed
    call, shared by its first forward (each train-mode ``BatchNorm`` appends
    its statistics) and its recomputation (each takes them back, in the same
    order, and neither recomputes nor folds them)."""
    stats = _RematStats()
    return _remat_region(stats, False), _remat_region(stats, True)


# whether train-mode batch norms use this process's batch alone under a
# process group (``local_batch_norm``)
_LOCAL = threading.local()


@contextlib.contextmanager
def local_batch_norm():
    """Inside the block every train-mode ``BatchNorm`` normalises with the
    statistics of the batch it is given, under a process group too, and
    calls no collective (the reference's per-GPU batch norm)."""
    outer = getattr(_LOCAL, "on", False)
    _LOCAL.on = True
    try:
        yield
    finally:
        _LOCAL.on = outer


class BatchNorm(nn.Module):
    """Batch norm over ``(B, T, H, W)`` of a ``(B, C, T, H, W)`` map with the
    JAX package's running-statistics rule.

    Train mode normalises with the biased batch variance (eps 1e-5) like
    every batch norm, but — unlike ``torch.nn.BatchNorm3d``, which folds the
    *unbiased* variance into ``running_var`` — folds the **biased** variance
    into the running variance with weight 0.1, as flax's momentum-0.9 update
    does (``dualvar_tpu/models/layers.py:_FastBN``). After a train step the
    running stats therefore equal the JAX package's.

    Train mode takes ATen's batch norm, or, when ``use_kernel_stats()``
    (``DUALVAR_BN_STATS=pallas``), the one-pass ``_OnePassBN`` whose sums
    come from the channel-sum kernel. Under a process group the statistics
    are the global batch's: the one-pass route adds its sums over the
    ranks, the default route takes ``_SyncBN`` in place of ATen's batch
    norm; without a group, or inside ``local_batch_norm()``, neither
    calls a collective. The fold is the
    same on every path.

    Inside a rematerialised backbone the recomputation takes the first
    forward's statistics and folds nothing (``remat_contexts``).

    State-dict keys: ``weight``, ``bias``, ``running_mean``, ``running_var``.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return torch.nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps)
        region = getattr(_REMAT, "region", None)
        saved = None
        if region is not None and region[1]:  # the recomputation
            record = region[0]
            saved = record.saved[record.next]
            record.next += 1
        stat = self.running_var.dtype
        synced = dist.active() and not getattr(_LOCAL, "on", False)
        if use_kernel_stats():
            y, mean, var = _OnePassBN.apply(x, self.weight, self.bias,
                                            self.eps, synced, saved)
            keep = (mean, var)
            var = var.to(stat)
        elif synced:
            y, mean, var, invstd, counts = _SyncBN.apply(
                x, self.weight, self.bias, self.eps, saved)
            keep = (mean, invstd, counts)
            var = var.to(stat)
        else:
            # no running buffers: the fold below is done by hand from the
            # returned batch mean and inverse std (= rsqrt(biased var + eps));
            # a recomputation recomputes them, with no sum kernel or
            # collective to repeat
            y, mean, invstd = torch.native_batch_norm(
                _channels_last_4d(x), self.weight, self.bias, None, None,
                True, 0.0, self.eps)
            y = y.view(x.shape)
            keep = None
            with torch.no_grad():
                var = invstd.to(stat).pow(-2) - self.eps
        if region is not None:
            if region[1]:
                return y  # folded once, by the first forward
            region[0].saved.append(keep)
        with torch.no_grad():
            # in place: the buffers are module state, not part of the graph
            self.running_mean.lerp_(mean.to(stat), self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y


def max_pool3d(x: torch.Tensor, kernel_size, stride=None,
               padding=0) -> torch.Tensor:
    """torch.nn.MaxPool3d, which pads with -inf as flax's ``nn.max_pool``
    does in the JAX package's ``layers.max_pool3d``."""
    return torch.nn.functional.max_pool3d(x, kernel_size, stride, padding)


def normal_init_(conv: nn.Conv3d, std: float = 0.01) -> nn.Conv3d:
    """The conv's weight drawn from normal(0, ``std``) (S3D's init)."""
    nn.init.normal_(conv.weight, 0.0, std)
    return conv


def kaiming_fan_out_init_(conv: nn.Conv3d) -> nn.Conv3d:
    """The conv's weight drawn from kaiming normal over its fan-out
    (ResNet-2d3d's init)."""
    nn.init.kaiming_normal_(conv.weight, mode="fan_out",
                            nonlinearity="relu")
    return conv


def global_avg_pool3d(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool3d((1,1,1)): (B, C, T, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3, 4))


def l2_normalize(x: torch.Tensor, axis: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize parity: x / max(||x||, eps)."""
    norm = x.square().sum(dim=axis, keepdim=True).sqrt()
    return x / norm.clamp_min(eps)
