"""Backbone registry (reference backbone/select_backbone.py:7-32).

Counterpart of ``dualvar_tpu/models/backbones/__init__.py``: name ->
(module, {'feature_size': int}). Backbones take ``(B, C, T, H, W)`` clips and
return 5-D feature maps, post-ReLU except ResNet-2d3d's, whose last block has
no final ReLU (as in the reference); on the card the maps are in
``channels_last_3d`` memory (``layers.card_layout``). r50's width is its
layer 4's true 1024, not the reference registry's 2048.

The registry variants: ``s3d_packed`` / ``s3dg_packed`` (the same function
as ``s3d`` / ``s3dg`` with the branches packed, another parameter layout:
``s3dg.pack_s3d_params``), ``r21d_pad128`` (the ``r21d`` function with its
mid widths padded to multiples of 128 by channels that stay zero:
``r21d.embed_formula_state``) and ``r21d_tiled`` (mid widths snapped to
multiples of 128: another network).

``select_backbone(..., remat=True)`` recomputes the backbone's activations
in the backward pass (``torch.utils.checkpoint``, non-reentrant), the
counterpart of the JAX package's ``nn.remat``: the same numbers, about 1/3
more FLOPs, far less activation memory. The recomputation is made exactly
once a backward, and what a train-mode forward does besides computing (the
batch norms' running statistics, their collectives and kernel counts) is
done once a step, in the first forward: ``models/layers.py:remat_contexts``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..layers import remat_contexts

from .c3d import C3D
from .r3d import R3DNet
from .r21d import R2Plus1DNet
from .resnet_2d3d import R2D3D18_SPEC, R2D3D50_SPEC, ResNet2d3d
from .s3dg import S3D

__all__ = ["select_backbone", "C3D", "R3DNet", "R2Plus1DNet", "ResNet2d3d",
           "S3D"]

_BACKBONES = {
    "s3d": (lambda: S3D(), 1024),
    "s3dg": (lambda: S3D(gating=True), 1024),
    "s3d_packed": (lambda: S3D(packed=True), 1024),
    "s3dg_packed": (lambda: S3D(gating=True, packed=True), 1024),
    "c3d": (C3D, 512),
    "r3d": (R3DNet, 512),
    "r21d": (R2Plus1DNet, 512),
    "r21d_tiled": (lambda: R2Plus1DNet(mid_mode="tile128"), 512),
    "r21d_pad128": (lambda: R2Plus1DNet(mid_mode="pad128"), 512),
    "r2d3d18": (lambda: ResNet2d3d(**R2D3D18_SPEC), 256),
    "r50": (lambda: ResNet2d3d(**R2D3D50_SPEC), 1024),
}


@functools.lru_cache(maxsize=None)
def _remat_class(cls: type) -> type:
    """``cls`` with its forward run under ``torch.utils.checkpoint`` where a
    gradient will be taken (train mode, grad enabled, no extra argument:
    the ``multi_level`` forward of the attention maps runs plainly). The
    region holds no random draw, so the RNG state is not saved
    (``preserve_rng_state`` would not restore an explicit generator
    anyway). A subclass keeps the module's parameter names."""

    class Remat(cls):
        remat = True

        def forward(self, x, *args, **kwargs):
            if args or kwargs or not (self.training
                                      and torch.is_grad_enabled()):
                return super().forward(x, *args, **kwargs)
            return checkpoint(super().forward, x, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=remat_contexts)

    Remat.__name__ = Remat.__qualname__ = f"Remat{cls.__name__}"
    return Remat


def select_backbone(network: str, remat: bool = False):
    """name -> (module, {'feature_size': int}). ``remat``: the module's
    forward recomputes its activations in the backward pass
    (``_remat_class``); the module and its ``state_dict`` are otherwise
    those of the plain backbone."""
    if network not in _BACKBONES:
        raise NotImplementedError(f"unknown backbone {network!r}")
    build, feature_size = _BACKBONES[network]
    module = build()
    if remat:
        module.__class__ = _remat_class(type(module))
    return module, {"feature_size": feature_size}
