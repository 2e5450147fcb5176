"""Where the R3D-18 SimCLR step's time goes: its segments, each timed
alone on the card. Counterpart of the JAX package's
``scripts/step_breakdown.py``.

The unit is ``tools/bench.py``'s (SimCLR on R3D-18, bfloat16 autocast, one
fixed uint8 batch of 171x128 frames, 16x112x112 clips) at B=128:

==========  ==============================================================
aug         the augmentation alone (uint8 -> two augmented float32 views,
            the kernel)
fwd         the model's train-mode forward from a resident augmented
            block, no gradient
fwdloss     the same and the total loss
step        the full train step (augmentation, forward, loss, backward,
            SGD: the trainer's step)
step_fz1    the full step with conv1's weight held (``requires_grad_(
            False)``: no weight gradient for the stem)
step_fzbn   the full step with every batch norm's scale and bias held
==========  ==============================================================

The held parameters are those the JAX script's ``is_frozen`` selects
(``backbone/conv1/*`` and every ``*/bn/*`` leaf: the 12 batch norms' scale
and bias); a held parameter gets no gradient and no SGD update. Each
segment builds its own model from the same seed and runs 3 warm-up steps
(the first under ``tools/timing.py:step_flops``), then ``--chains`` chains of
``--steps`` steps (the JAX script's one chain of 20 by default). A failure
ends the run with a non-zero exit. The records (ms a step, clips a second
at 2 clips a sample, the counted operations) go to ``--out`` (default
``build/bench/step_breakdown.json``) and, as a list, to the last line of
standard output.

Usage (on the card, from the repo root)::

    python3 -m dualvar_tpu_torch.tools.step_breakdown [segment ...]
        [--steps 20] [--chains 1] [--out PATH] [--device cuda] [--smoke]
"""

from __future__ import annotations

import json
import os
import sys

import torch

from ..aug.pipeline import pretrain_batch
from ..models.layers import BatchNorm
from ..train.pretrain import _AUTOCAST, _resolve_device
from ..train.tasks import step_context, total_loss
from .bench import SMOKE_BATCHES, TrainUnit, aug_config, shapes, tool_parser
from .soak import soak_config
from .timing import device_line, finite, log, measure

SEGMENTS = ("aug", "fwd", "fwdloss", "step", "step_fz1", "step_fzbn")
BATCH = 128


def frozen_names(model: torch.nn.Module, freeze_conv1: bool = False,
                 freeze_bn: bool = False) -> list[str]:
    """The parameters the JAX script's ``is_frozen`` holds: the backbone's
    stem conv (``freeze_conv1``) and every batch norm's scale and bias
    (``freeze_bn``)."""
    names = []
    for prefix, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            full = f"{prefix}.{name}" if prefix else name
            if ((freeze_conv1 and full.startswith("backbone.conv1."))
                    or (freeze_bn and isinstance(module, BatchNorm))):
                names.append(full)
    return names


class Segment(TrainUnit):
    """One segment of ``tools/bench.py``'s step at ``batch`` on its own
    model (seeded as the trainer seeds it); ``step()`` runs it once and
    returns a scalar: the loss, the model's first output, or a checksum of
    the augmented views."""

    def __init__(self, name: str, batch: int, smoke: bool,
                 device: torch.device):
        _, H0, W0, _ = shapes(smoke)
        super().__init__(soak_config("float32" if smoke else "bfloat16"),
                         aug_config(smoke), batch, (H0, W0), device)
        self.name = name
        self.dtype = _AUTOCAST[self.cfg.model.dtype]
        self.held = frozen_names(self.trainer.model,
                                 freeze_conv1=name == "step_fz1",
                                 freeze_bn=name == "step_fzbn")
        params = dict(self.trainer.model.named_parameters())
        for full in self.held:
            params[full].requires_grad_(False)
        self.block = None
        if name in ("fwd", "fwdloss"):
            with torch.no_grad():
                self.block = self.augment()
        if name == "aug":
            self.step = self.aug
        elif name in ("aug_fwd", "fwd", "fwdloss"):
            self.step = self.forward

    def augment(self) -> torch.Tensor:
        return pretrain_batch(self.trainer.generator, self.frames,
                              self.aug_cfg)

    def aug(self) -> torch.Tensor:
        with torch.no_grad():
            return self.augment()[:, :, 0, 0, 0, 0].sum()

    def forward(self) -> torch.Tensor:
        """The train-mode forward (batch statistics folded, no gradient)
        from the resident block, or from a fresh one (``aug_fwd``)."""
        task, device = self.trainer.task, self.frames.device
        with torch.no_grad():
            block = self.block if self.block is not None else self.augment()
            with step_context(device.type, self.dtype) as autocast:
                with autocast():
                    ret = task.forward(block)
            if self.name == "fwd":  # the model's first output, no loss
                return next(iter(ret.values())).flatten()[0].float()
            return total_loss(ret)


def segment_record(label: str, m, device: torch.device) -> dict:
    per = m.per_step
    rec = {"segment": label, **m.fields(device),
           "clips_per_sec": round(2 * m.batch / per, 1)}
    value = m.out.item()
    rec["loss" if label.startswith("step") else "output"] = round(value, 3)
    log(f"{label:10s} B={m.batch} {per * 1e3:7.1f} ms  "
        f"{rec['clips_per_sec']:8.1f} clips/s  "
        f"{'loss' if label.startswith('step') else 'output'} {value:.3f}")
    return rec


def run_segments(plan, n: int, chains: int, device: str | torch.device,
                 smoke: bool = False) -> list[dict]:
    """Each ``(label, segment, batch candidates)`` of ``plan`` timed alone;
    a record with ``error`` where no candidate fits."""
    device = _resolve_device(device)
    out = []
    for label, name, candidates in plan:
        m = measure(lambda b: Segment(name, b, smoke, device),
                    SMOKE_BATCHES if smoke else candidates, n, chains,
                    device, label, count_flops=name != "aug")
        if m.batch is None:
            out.append({"segment": label,
                        "error": "all batch candidates failed",
                        "did_not_fit": m.did_not_fit})
            log(f"{label}: no batch of {candidates} fits")
            continue
        out.append(segment_record(label, m, device))
        del m
    return out


def main_of(doc: str, plan: list, default_steps: int, default_out: str,
            argv: list[str] | None) -> int:
    """The command line both breakdowns share: positional segment labels
    (all by default), ``--steps``, ``--chains``, ``--device``, ``--out``,
    ``--smoke``."""
    p = tool_parser(doc, default_out, steps=default_steps, chains=1)
    p.add_argument("segments", nargs="*",
                   help=f"of {', '.join(label for label, _, _ in plan)}")
    args = p.parse_args(argv)
    unknown = set(args.segments) - {label for label, _, _ in plan}
    if unknown:
        p.error(f"unknown segments {sorted(unknown)}")
    chosen = [s for s in plan if not args.segments or s[0] in args.segments]
    line = device_line(torch.device(args.device))
    log(f"device: {line}")
    records = run_segments(chosen, args.steps, args.chains, args.device,
                           args.smoke)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"device": line, "results": records}, fh, indent=1)
    print(json.dumps(records), flush=True)
    return 0 if all(finite(r.get("loss", r.get("output")))
                    for r in records) else 1


def plan() -> list[tuple[str, str, tuple[int, ...]]]:
    return [(name, name, (BATCH,)) for name in SEGMENTS]


def main(argv: list[str] | None = None) -> int:
    return main_of(__doc__, plan(), 20, "step_breakdown.json", argv)


if __name__ == "__main__":
    sys.exit(main())
