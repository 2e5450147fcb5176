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

import torch

from ..core.config import ModelConfig
from ..models.ssl.moco import MoCo
from ..models.ssl.simclr import SimCLRNaked, SimCLRTimeSeriesV4


def total_loss(ret: dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of every '*loss' entry (reference pretrain.py:404-445)."""
    return sum(v for k, v in ret.items() if k.endswith("loss"))


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
    ``generator``."""
    if cfg.model in ("simclr_naked", "simclr_timeseriesv4"):
        return SimCLRTask(cfg)
    if cfg.model in ("moco_naked", "moco_timeseriesv4"):
        return MoCoTask(cfg, generator)
    raise NotImplementedError(f"unknown model {cfg.model!r}")
