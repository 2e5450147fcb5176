"""Backbone registry (reference backbone/select_backbone.py:7-32).

Counterpart of ``dualvar_tpu/models/backbones/__init__.py``: name ->
(module, {'feature_size': int}). Backbones take ``(B, C, T, H, W)`` clips and
return post-ReLU 5-D feature maps.
"""

from __future__ import annotations

from .r3d import R3DNet
from .r21d import R2Plus1DNet

__all__ = ["select_backbone", "R3DNet", "R2Plus1DNet"]


def select_backbone(network: str):
    if network == "r21d":
        return R2Plus1DNet(), {"feature_size": 512}
    if network == "r3d":
        return R3DNet(), {"feature_size": 512}
    raise NotImplementedError(
        f"backbone {network!r} is not ported yet; only 'r21d' and 'r3d' are "
        "(the remaining backbones are queued in ROADMAP.md)")
