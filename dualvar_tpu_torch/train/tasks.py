"""SSL pretrain tasks (reference model registry get_model, pretrain.py:61-77).

Counterpart of ``dualvar_tpu/train/tasks.py``. A task owns the model (an
``nn.Module`` holding parameters and BN statistics) and exposes
``forward(block, generator=..., perm=...) -> ret dict``. Total loss = sum of
every ``*loss`` entry of the returned dict — the reference's generic
multi-loss accounting (pretrain.py:404-445).
"""

from __future__ import annotations

import torch

from ..core.config import ModelConfig
from ..models.ssl.simclr import SimCLRTimeSeriesV4


def total_loss(ret: dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of every '*loss' entry (reference pretrain.py:404-445)."""
    return sum(v for k, v in ret.items() if k.endswith("loss"))


class SimCLRTask:
    n_views = 3

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.model = SimCLRTimeSeriesV4(
            network=cfg.net, dim=cfg.moco_dim, temperature=cfg.moco_t,
            n_series=cfg.n_series, series_dim=cfg.series_dim,
            aligned_T=cfg.aligned_T, mode=cfg.mode,
            shufflerank_theta=cfg.shufflerank_theta,
            packed_encode=cfg.packed_encode,
        )

    def forward(self, block: torch.Tensor, generator=None, perm=None):
        return self.model(block, perm=perm, generator=generator)


def make_task(cfg: ModelConfig):
    """Model registry (reference get_model, pretrain.py:61-77)."""
    if cfg.model == "simclr_timeseriesv4":
        return SimCLRTask(cfg)
    if cfg.model in ("simclr_naked", "moco_naked", "moco_timeseriesv4"):
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet; only "
            "'simclr_timeseriesv4' is (see the module queue in ROADMAP.md)")
    raise NotImplementedError(f"unknown model {cfg.model!r}")
