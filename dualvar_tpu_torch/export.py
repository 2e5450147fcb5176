"""Serving export: a trained classifier frozen into a ``torch.export``
artifact that runs without this package at serve time.

Counterpart of ``dualvar_tpu/export.py``, which lowers the same function to
a serialized StableHLO program with ``jax.export``. Here the eval forward is
traced by ``torch.export.export`` at one static uint8 input shape (the JAX
artifact's signature is static too); the trained weights travel inside the
artifact, on the device it was exported on, and ``torch.export.save``
writes it. The serving host needs torch and the file only:
``torch.export.load(path).module()`` gives the callable (``load_serving``).

Two serving signatures, both taking the raw uint8 frames the data loader
produces (decode and resize stay on the host; the centre crop and the
normalisation are inside the artifact, as in the eval paths):

* single clip: ``(B, T, H0, W0, 3) u8 -> (probs, logits, feat)``, the
  validation / centre-crop forward (``train/classifier.py:make_eval_step``);
* ten clips: ``(B, 10*T, H0, W0, 3) u8 -> (probs, logits10, feat10)``, with
  probs the mean softmax over the 10 uniform clips: the temporal ten-clip
  protocol (reference classifier.py:657-738; ``test_temporal_tenclip``).

The model runs under the preset's autocast type, as the eval paths run it:
``torch.export`` keeps the autocast region (a ``wrap_with_autocast`` node),
so a bf16 preset serves what its eval step computes.

CLI::

    python -m dualvar_tpu_torch.export --preset paper_table1_ucf_ft \\
        --ckpt log/.../model --out serving.pt2 --ten_clip --batch 8
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

import torch
from torch import nn

from .aug.pipeline import AugConfig, eval_batch, tenclip_batch
from .core.checkpoint import load_state_dict
from .core.config import CLASSIFIER_PRESETS, ClassifierConfig
from .core.convert import classifier_from_torch, load_torch_checkpoint
from .models.heads import LinearClassifier
from .train.classifier import _forward, build_model
from .train.pretrain import _AUTOCAST, _resolve_device


def serve(model: LinearClassifier, frames_u8: torch.Tensor,
          aug_cfg: AugConfig, ten_clip: bool,
          autocast_dtype: torch.dtype = torch.float32):
    """The serving function on ``frames_u8`` with ``model`` in eval mode:
    ``(probs, logits, feat)`` as the module docstring gives them, through
    the eval paths' own crops and ``train/classifier.py:_forward``."""
    if not ten_clip:
        logit, feat = _forward(model, eval_batch(frames_u8, aug_cfg),
                               autocast_dtype)
        return logit.softmax(dim=-1), logit, feat
    clips = tenclip_batch(frames_u8, aug_cfg)  # (B, 10, T, d, d, C)
    B = clips.shape[0]
    logit, feat = _forward(model, clips.reshape(B * 10, *clips.shape[2:]),
                           autocast_dtype)
    probs = logit.softmax(dim=-1).reshape(B, 10, -1).mean(dim=1)
    return probs, logit.reshape(B, 10, -1), feat.reshape(B, 10, -1)


def make_serving_fn(model: LinearClassifier, aug_cfg: AugConfig,
                    ten_clip: bool = False,
                    autocast_dtype: torch.dtype = torch.float32) -> Callable:
    """A ``frames_u8 -> (probs, logits, feat)`` closure over the trained
    ``model`` (JAX ``make_serving_fn``). Shapes:

    * ``ten_clip=False``: frames (B, T, H0, W0, 3) -> probs / logits (B, C),
      feat (B, F), the pooled feature retrieval consumes;
    * ``ten_clip=True``: frames (B, 10*T, H0, W0, 3) -> probs (B, C)
      averaged over the clips, logits (B, 10, C), feat (B, 10, F).
    """
    return lambda frames_u8: serve(model, frames_u8, aug_cfg, ten_clip,
                                   autocast_dtype)


class _Serving(nn.Module):
    """``serve`` as a module, the form ``torch.export`` traces."""

    def __init__(self, model: LinearClassifier, aug_cfg: AugConfig,
                 ten_clip: bool, autocast_dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.aug_cfg, self.ten_clip = aug_cfg, ten_clip
        self.autocast_dtype = autocast_dtype

    def forward(self, frames_u8: torch.Tensor):
        return serve(self.model, frames_u8, self.aug_cfg, self.ten_clip,
                     self.autocast_dtype)


def export_serving(model: LinearClassifier, aug_cfg: AugConfig,
                   input_shape: tuple[int, ...], path: str,
                   ten_clip: bool = False,
                   autocast_dtype: torch.dtype = torch.float32):
    """Trace the serving function at the static uint8 ``input_shape``
    (batch included: export once a served batch size) on the device of
    ``model``'s parameters and write the artifact to ``path``. The batch
    norms take their eval branch (running statistics, no collective, no
    kernel). Returns the ``torch.export.ExportedProgram``."""
    device = next(model.parameters()).device
    example = torch.zeros(input_shape, dtype=torch.uint8, device=device)
    module = _Serving(model.eval(), aug_cfg, ten_clip, autocast_dtype)
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    # torch.export.save writes the example inputs too: zeros of the input
    # shape (84 MB of uint8 for ten clips at B=8) the served function never
    # reads
    program.example_inputs = None
    torch.export.save(program, path)
    return program


def load_serving(path: str) -> Callable:
    """The served callable of an artifact: ``torch.export.load(path)
    .module()``. This is the whole dependency of a serving host: torch and
    the file."""
    return torch.export.load(path).module()


def _load_weights(cfg: ClassifierConfig, model: LinearClassifier,
                  ckpt: str) -> str:
    """Load the trained classifier from ``ckpt``: a ``CheckpointStore``
    directory (its latest epoch), a port checkpoint file, or a reference
    ``.pth.tar`` (converted by ``core/convert.py:classifier_from_torch``).
    Returns which of the three it was."""
    if os.path.isdir(ckpt):
        model.load_state_dict(load_state_dict(ckpt))
        return "checkpoint store"
    sd, _ = load_torch_checkpoint(ckpt)
    if set(sd) == set(model.state_dict()):
        model.load_state_dict(sd)
        return "port checkpoint file"
    model.load_state_dict(classifier_from_torch(sd, cfg.model.net))
    return "reference checkpoint"


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="smoke",
                   choices=sorted(CLASSIFIER_PRESETS))
    p.add_argument("--ckpt", required=True,
                   help="CheckpointStore directory, port checkpoint file, "
                        "or reference .pth.tar")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--ten_clip", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu': where the artifact "
                        "runs")
    args = p.parse_args(argv)

    cfg = CLASSIFIER_PRESETS[args.preset]
    device = _resolve_device(args.device)
    model = build_model(cfg)
    source = _load_weights(cfg, model, args.ckpt)
    model.to(device)
    aug_cfg = AugConfig(img_dim=cfg.data.img_dim, seq_len=cfg.data.seq_len)
    T = cfg.data.seq_len * (10 if args.ten_clip else 1)
    H0, W0 = cfg.data.scale_hw
    shape = (args.batch, T, H0, W0, 3)
    export_serving(model, aug_cfg, shape, args.out, ten_clip=args.ten_clip,
                   autocast_dtype=_AUTOCAST[cfg.model.dtype])
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes, input "
          f"{shape} u8 on {device}, {cfg.model.dtype}, weights from the "
          f"{source} '{args.ckpt}'")


if __name__ == "__main__":
    main()
