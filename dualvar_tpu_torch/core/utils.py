"""Small shared utilities (reference utils/utils.py odds and ends).

Counterpart of ``dualvar_tpu/core/utils.py``'s ``batch_denorm``.
"""

from __future__ import annotations

import torch

from ..aug.functional import IMAGENET_MEAN, IMAGENET_STD


def batch_denorm(x: torch.Tensor, mean=IMAGENET_MEAN,
                 std=IMAGENET_STD) -> torch.Tensor:
    """Invert the channel normalisation for visualisation, on a ``(N, C,
    ...)`` tensor such as NCTHW clips: the channel axis is 1, as in the
    reference (utils/utils.py:65-72); the JAX package's works on the last
    axis of its channels-last clips."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device).view(shape)
    std = torch.tensor(std, dtype=x.dtype, device=x.device).view(shape)
    return x * std + mean
