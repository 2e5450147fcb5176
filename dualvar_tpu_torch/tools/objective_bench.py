"""Throughput of the production pretrain step of each SSL objective on the
card. Counterpart of the JAX package's ``scripts/objective_bench.py``.

Each unit runs the step ``python -m dualvar_tpu_torch.train.pretrain``
runs: ``train/tasks.py:make_task`` and ``train/pretrain.py:
make_train_step`` (uint8 batch -> the augmentation kernel -> the task's
forward: every view, MoCo's key encoder and queue, the shuffle-rank
re-encode, the series losses -> backward -> SGD with
``paper_table1_k400``'s recipe), bfloat16 autocast, 16x112x112 clips from
171x128 frames on one fixed batch drawn with ``np.random.default_rng(0)``.

Units (the JAX script's, with their batch candidates, largest first):

==================================  =======================================
simclr_tsv4_r21d                    ``paper_table1_k400`` (3 views + re-encode)
moco_tsv4_r21d                      ``paper_table2_moco_r21d``, K=16384
simclr_tsv4_r3d                     the DualVar objective on R3D-18
moco_naked_r3d                      MoCo-v2-style baseline on R3D-18, K=16384
simclr_tsv4_r21d_packed,            the same with ``packed_encode=True``
moco_tsv4_r21d_packed               (the re-encode merged into the encode)
simclr_tsv4_r21d_tiled_packed,      and on ``r21d_tiled``
moco_tsv4_r21d_tiled_packed
==================================  =======================================

MoCo skips a batch that does not divide K. A batch that runs out of device
memory moves the search to the next (``tools/timing.py:fit_batch``); any
other failure ends the run with a non-zero exit. 3 warm-up steps (the first
under ``tools/timing.py:step_flops``), then 3 chains of 20 steps; the best
chain's step time gives ``clips_per_sec`` (B x views a second, the JAX
definition), ``samples_per_sec`` (B a second) and ``mfu_pct`` (the counted
operations against the H100's bf16 peak). Each record is merged into
``--out`` (default ``build/bench/objectives.json``) as it is measured
(``tools/sweep_merge.py``); the last line of standard output is the list
of records. ``--smoke``: the JAX script's smoke shapes (T=4, 40x36 frames,
32x32 crops, K=8, float32, B=2).

Usage (on the card, from the repo root)::

    python3 -m dualvar_tpu_torch.tools.objective_bench [unit ...]
        [--steps 20] [--chains 3] [--out PATH] [--device cuda] [--smoke]
"""

from __future__ import annotations

import dataclasses
import json
import sys

import torch

from ..core.config import PRETRAIN_PRESETS, ModelConfig
from ..train.pretrain import _resolve_device
from .bench import SMOKE_BATCHES, TrainUnit, aug_config, shapes, tool_parser
from .bench import train_record
from .sweep_merge import sweep
from .timing import device_line, finite, log, measure

_K400 = PRETRAIN_PRESETS["paper_table1_k400"].model
_MOCO = PRETRAIN_PRESETS["paper_table2_moco_r21d"].model
# unit -> (ModelConfig, batch candidates largest first)
UNITS: dict[str, tuple[ModelConfig, tuple[int, ...]]] = {
    "simclr_tsv4_r21d": (_K400, (32, 16)),
    "moco_tsv4_r21d": (_MOCO, (32, 16)),
    "simclr_tsv4_r3d": (dataclasses.replace(_K400, net="r3d"), (64, 32)),
    "moco_naked_r3d": (
        ModelConfig(net="r3d", model="moco_naked", moco_k=16384), (128, 64)),
    "simclr_tsv4_r21d_packed": (
        dataclasses.replace(_K400, packed_encode=True), (32, 16)),
    "moco_tsv4_r21d_packed": (
        dataclasses.replace(_MOCO, packed_encode=True), (32, 16)),
    "simclr_tsv4_r21d_tiled_packed": (
        dataclasses.replace(_K400, net="r21d_tiled", packed_encode=True),
        (32, 16)),
    "moco_tsv4_r21d_tiled_packed": (
        dataclasses.replace(_MOCO, net="r21d_tiled", packed_encode=True),
        (32, 16)),
}


def units(smoke: bool = False) -> dict:
    """``UNITS``, or with ``smoke`` each at K=8, float32, B=2."""
    if not smoke:
        return UNITS
    return {name: (dataclasses.replace(cfg, moco_k=8, dtype="float32"),
                   SMOKE_BATCHES) for name, (cfg, _) in UNITS.items()}


def bench_unit(name: str, n_steps: int = 20, chains: int = 3,
               device: str | torch.device = "cuda", smoke: bool = False
               ) -> dict:
    """One unit's record; ``error`` where no candidate fits."""
    device = _resolve_device(device)
    model_cfg, candidates = units(smoke)[name]
    _, H0, W0, _ = shapes(smoke)
    cfg = PRETRAIN_PRESETS["paper_table1_k400"].replace(model=model_cfg)
    aug_cfg = aug_config(smoke)
    is_moco = model_cfg.model.startswith("moco")

    def skip(batch):
        if is_moco and model_cfg.moco_k % batch:
            return f"K={model_cfg.moco_k} not divisible"
        return None

    m = measure(lambda b: TrainUnit(cfg, aug_cfg, b, (H0, W0), device,
                                    steps_per_epoch=100),
                candidates, n_steps, chains, device, name, skip=skip)
    if m.batch is None:
        return {"name": name, "error": "all batch candidates failed",
                "did_not_fit": m.did_not_fit}
    n_views = m.unit.n_views
    rec = {
        "name": name, "net": name, "model": model_cfg.model,
        "backbone": model_cfg.net, "n_views": n_views,
        "moco_k": model_cfg.moco_k if is_moco else None,
        **train_record(m, n_views, device),
        "dtype": model_cfg.dtype,
    }
    log(f"{name}: B={m.batch} {rec['ms_per_step']} ms/step, "
        f"{rec['clips_per_sec']} clips/s ({rec['samples_per_sec']} "
        f"samples/s), MFU {rec['mfu_pct']}% (chains {rec['chains_ms']})")
    return rec


def main(argv: list[str] | None = None) -> int:
    p = tool_parser(__doc__, "objectives.json")
    p.add_argument("units", nargs="*", help=f"of {', '.join(UNITS)}")
    args = p.parse_args(argv)
    line = device_line(torch.device(args.device))
    log(f"device: {line}")
    _, _, _, img = shapes(args.smoke)
    out = sweep(args.units or list(UNITS),
                lambda name: bench_unit(name, args.steps, args.chains,
                                        args.device, args.smoke),
                args.out, {"shape": f"16x{img}^2, fused aug, bf16, "
                                    "production train step", "device": line},
                list(UNITS), key="name")
    print(json.dumps(out), flush=True)
    return 0 if all(finite(r.get("final_loss")) for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
