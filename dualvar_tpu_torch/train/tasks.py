"""SSL pretrain tasks: one interface over the four model families (reference
model registry get_model, pretrain.py:61-77):

    simclr_naked | simclr_timeseriesv4 | moco_naked | moco_timeseriesv4

Counterpart of ``dualvar_tpu/train/tasks.py``. A task owns the model (an
``nn.Module`` holding parameters, BN statistics and, for MoCo, the key
encoder and the queues) and exposes ``forward(block, generator=..., perm=...)
-> ret dict``, ``n_views`` (clips per sample the dataset must supply) and
``parameters()`` (what the optimizer updates). Total loss = sum of every
``*loss`` entry of the returned dict — the reference's generic multi-loss
accounting (pretrain.py:404-445).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch

from ..core.config import ModelConfig
from ..models.ssl.moco import MoCo
from ..models.ssl.simclr import SimCLRNaked, SimCLRTimeSeriesV4


def total_loss(ret: dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of every '*loss' entry (reference pretrain.py:404-445)."""
    return sum(v for k, v in ret.items() if k.endswith("loss"))


@contextlib.contextmanager
def step_context(device_type: str, dtype: torch.dtype
                 ) -> Iterator[Callable[[], contextlib.AbstractContextManager]]:
    """The context of one step of a model whose forward runs under ``dtype``
    autocast on ``device_type``; it yields the forward's autocast (a
    ``torch.autocast``, off for float32)::

        with step_context(device.type, dtype) as autocast:
            with autocast():
                loss = ...
            loss.backward()

    The block holds the backward as well as the forward: on the CPU under
    bfloat16 it runs with oneDNN off, since oneDNN's bfloat16 weight
    gradient of some conv3d shapes is NaN, inf or far off (R(2+1)D-18's
    ``layer2_block0.conv2.temporal_conv`` at 4x16x16 clips), and
    ``convolution_backward`` picks its route when the backward runs. ATen's
    own bfloat16 convolutions then compute both passes. On CUDA, and in
    float32, the block is the autocast alone."""
    def autocast():
        return torch.autocast(device_type=device_type, dtype=dtype,
                              enabled=dtype != torch.float32)

    if device_type != "cpu" or dtype != torch.bfloat16:
        yield autocast
        return
    # the flag alone: ``torch.backends.mkldnn.flags`` also resets oneDNN's
    # TF32 and precision flags
    onednn = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield autocast
    finally:
        torch.backends.mkldnn.enabled = onednn


class SimCLRTask:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        if cfg.model == "simclr_naked":
            self.model = SimCLRNaked(network=cfg.net, dim=cfg.moco_dim,
                                     temperature=cfg.moco_t,
                                     remat=cfg.remat)
            self.n_views = 2
        else:
            self.model = SimCLRTimeSeriesV4(
                network=cfg.net, dim=cfg.moco_dim, temperature=cfg.moco_t,
                n_series=cfg.n_series, series_dim=cfg.series_dim,
                aligned_T=cfg.aligned_T, mode=cfg.mode,
                shufflerank_theta=cfg.shufflerank_theta,
                dtw_gamma=cfg.dtw_gamma, packed_encode=cfg.packed_encode,
                remat=cfg.remat,
            )
            self.n_views = 3

    def parameters(self):
        return self.model.parameters()

    def get_features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Per-stage attention maps for ``--visualize`` (a multi_level
        backbone: r21d)."""
        return self.model.get_features(x)

    def forward(self, block: torch.Tensor, generator=None, perm=None):
        if self.n_views == 2:
            return self.model(block)
        return self.model(block, perm=perm, generator=generator)


class MoCoTask:
    """``generator`` seeds the initial queues."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None):
        self.cfg = cfg
        naked = cfg.model == "moco_naked"
        self.n_views = 2 if naked else 3
        self.model = MoCo(
            network=cfg.net, dim=cfg.moco_dim, K=cfg.moco_k, m=cfg.moco_m,
            temperature=cfg.moco_t, n_series=cfg.n_series,
            series_dim=cfg.series_dim, aligned_T=cfg.aligned_T, mode=cfg.mode,
            dtw_gamma=cfg.dtw_gamma, naked=naked,
            shuffle_bn_groups=cfg.moco_shuffle_bn,
            packed_encode=cfg.packed_encode, remat=cfg.remat,
            generator=generator,
        )

    def parameters(self):
        """The query encoder's parameters: the key encoder moves only by its
        momentum update."""
        return self.model.encoder_q.parameters()

    def get_features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The query encoder's per-stage attention maps for
        ``--visualize``."""
        return self.model.encoder_q.get_features(x)

    def forward(self, block: torch.Tensor, generator=None, perm=None,
                bn_perm=None):
        return self.model(block, perm=perm, generator=generator,
                          bn_perm=bn_perm)


def make_task(cfg: ModelConfig, generator: torch.Generator | None = None):
    """Model registry (reference get_model, pretrain.py:61-77). Parameters
    are initialised from torch's global generator, MoCo's queues from
    ``generator``. ``packed_encode`` on a naked model, which has no dual
    pass to merge, raises (ROADMAP C.9: the JAX package ignores it)."""
    if cfg.packed_encode and cfg.model in ("simclr_naked", "moco_naked"):
        raise ValueError(f"packed_encode has no meaning for {cfg.model!r}: "
                         "it merges the TimeSeriesV4 dual pass")
    if cfg.model in ("simclr_naked", "simclr_timeseriesv4"):
        return SimCLRTask(cfg)
    if cfg.model in ("moco_naked", "moco_timeseriesv4"):
        return MoCoTask(cfg, generator)
    raise NotImplementedError(f"unknown model {cfg.model!r}")
