"""MoCo production-step soak on the card: sustained MoCo-TimeSeriesV4
pretraining through the trainer's own step (``train/pretrain.py:
make_train_step``, the program ``python -m dualvar_tpu_torch.train.pretrain
--preset paper_table2_moco_r21d`` runs), long enough for the K=16384 queue
to wrap, then the stateful machinery a long MoCo run depends on: the EMA
key encoder, the ring-buffer queue and its pointer. Counterpart of the JAX
package's ``scripts/moco_soak.py``, with its checks:

* every chain's loss finite over the whole run;
* the queue pointer where the step count puts it, ``(ptr0 + steps * B) mod
  K`` with the warm-up step counted;
* the queue's rows unit-norm (the enqueued keys are l2-normalised) and the
  key encoder's parameters finite;
* resume: a mid-run checkpoint of the full state (both encoders, both
  queues, the pointer, the optimizer, the step's generator) saved through
  the async store while training goes on, restored twice after the run:
  each restore replays 3 steps, and the losses and pointers must equal the
  other replay's and the 3 live steps' after the save, bitwise (see
  ``tools/soak.py``, which this tool shares its loop with).

``paper_table2_moco_r21d`` (R(2+1)D-18, K=16384, mode ``clip-sr-tc``) at
B=32 in chains of 10 steps, 16x112x112 clips from one fixed batch of 171x128
frames, ``AugConfig(fused="auto", jitter_order="sample")``, the preset's
optimizer with 100 steps an epoch. ``--smoke``: R3D, K=16, float32, B=4, 4
frames of 40x36 cropped to 32, 0.2 minutes, chains of 2 (the JAX script's
rehearsal). The record is the JAX record, key for key; this tool writes no
file (the JAX script writes ``SOAK_MOCO_r04.json``). The exit code is 1
unless the pointer, the key encoder and the replays pass.

Usage (on the card, from the repo root)::

    python3 -m dualvar_tpu_torch.tools.moco_soak [--minutes 6] [--b 32] [--chain 10]
    python3 -m dualvar_tpu_torch.tools.moco_soak --smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ..aug.pipeline import AugConfig
from ..core.config import PRETRAIN_PRESETS, PretrainConfig
from ..train.pretrain import _resolve_device
from . import soak as S

PRESET = "paper_table2_moco_r21d"
# the JAX script's --smoke: its model, batch, length, chain and clip size
SMOKE_MODEL = {"net": "r3d", "moco_k": 16, "dtype": "float32"}
SMOKE_BATCH, SMOKE_MINUTES, SMOKE_CHAIN = 4, 0.2, 2
SMOKE_CLIP = (4, (40, 36), 32)  # frames, (H, W) before the crop, crop
FULL_CLIP = (16, (171, 128), 112)


def moco_config(smoke: bool = False) -> PretrainConfig:
    cfg = PRETRAIN_PRESETS[PRESET]
    if smoke:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **SMOKE_MODEL))
    return cfg


def queue_checks(model: torch.nn.Module, ptr0: int, steps: int,
                 batch: int) -> dict:
    """The pointer against ``steps`` of ``batch`` keys from ``ptr0``, the
    wraps, the queue rows' largest distance from unit norm and whether the
    key encoder is finite (the JAX script's checks, on the live state)."""
    K = model.queue.shape[0]
    ptr = int(model.queue_ptr)
    norms = model.queue.float().norm(dim=1)
    return {
        "ptr_expected": (ptr0 + steps * batch) % K,
        "ptr_actual": ptr,
        "queue_wraps": (ptr0 + steps * batch) // K,
        "queue_norm_max_dev": float((norms - 1.0).abs().max()),
        "ema_finite": all(bool(torch.isfinite(p).all())
                          for p in model.encoder_k.parameters()),
    }


def run_moco_soak(minutes: float = 6.0, batch: int = 32, chain: int = 10,
                  smoke: bool = False, device: str | torch.device = "cuda",
                  ckpt_dir: str | None = None) -> tuple[dict, dict]:
    """The soak; returns (the record, with the JAX record's keys; the
    details of ``soak.soak``). ``smoke`` sets the JAX ``--smoke`` sizes,
    whatever ``minutes``, ``batch`` and ``chain`` say."""
    device = _resolve_device(device)
    cfg = moco_config(smoke)
    if smoke:
        batch, minutes, chain = SMOKE_BATCH, SMOKE_MINUTES, SMOKE_CHAIN
    T, hw, img = SMOKE_CLIP if smoke else FULL_CLIP
    K = cfg.model.moco_k
    if K % batch:
        raise ValueError(f"the ring update needs K % B == 0: K={K}, "
                         f"B={batch}")
    aug_cfg = AugConfig(img_dim=img, seq_len=T, fused="auto",
                        jitter_order="sample")
    trainer = S.build_trainer(cfg, aug_cfg, device, steps_per_epoch=100)
    model, views = trainer.model, trainer.task.n_views
    ptr0 = int(model.queue_ptr)
    frames = S.fixed_frames(batch, views * T, hw, device)
    run, details = S.soak(
        trainer, frames, minutes, chain, batch * views,
        lambda m: (m["total_loss"].item(), int(model.queue_ptr)),
        "moco-soak", ckpt_dir,
        lambda run: queue_checks(model, ptr0, run.steps, batch))
    rates = run.rates(batch * views, chain)
    record = {
        "metric": "MoCo TimeSeriesV4 soak (production train step, "
                  f"{cfg.model.net}, K={K})",
        "unit": "clips/s/device",
        "value": float(np.mean(rates)),
        "minutes": minutes,
        "batch_size": batch,
        "steps": run.steps,
        "queue_wraps": details["queue_wraps"],
        "ptr_expected": details["ptr_expected"],
        "ptr_actual": details["ptr_actual"],
        "ptr_ok": details["ptr_actual"] == details["ptr_expected"],
        "queue_norm_max_dev": details["queue_norm_max_dev"],
        "ema_finite": details["ema_finite"],
        "best_chain": max(rates),
        "worst_chain": min(rates),
        "first_loss": run.first_loss,
        "last_loss": run.chain_losses[-1],
        "ckpt_save_enqueue_s": run.enqueue_s,
        "resume_deterministic": (details["replays_agree"]
                                 and details["replays_match_live"]),
        "backend": device.type,
    }
    return record, details


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--minutes", type=float, default=6.0)
    p.add_argument("--b", type=int, default=32)
    p.add_argument("--chain", type=int, default=10)
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes/queue on any device (CI rehearsal)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    try:
        record, details = run_moco_soak(args.minutes, args.b, args.chain,
                                        args.smoke, args.device)
    except FloatingPointError as e:
        S.log(json.dumps({"error": str(e)}))
        return 1
    S.log("[moco-soak] details: " + json.dumps(details))
    S.log(json.dumps(record))
    # the JAX script's exit code
    ok = (record["ptr_ok"] and record["ema_finite"]
          and record["resume_deterministic"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
