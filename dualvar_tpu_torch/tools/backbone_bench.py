"""Throughput of the 2-view SimCLR pretrain step on every backbone of the
registry, on the card. Counterpart of the JAX package's
``scripts/backbone_bench.py``.

Each net runs ``tools/bench.py``'s step with its backbone swapped in
(uint8 batch -> the augmentation kernel -> 2-view encode -> NT-Xent ->
backward -> SGD at lr 0.003, momentum 0.9, weight decay 1e-4), bfloat16
autocast, 16x112x112 clips from 171x128 frames. The batch candidates are
the JAX script's, largest first; a batch that runs out of device memory
moves the search to the next (``tools/timing.py:fit_batch``), any other
failure ends the run with a non-zero exit. ``net:B`` (or ``net:B1,B2``)
times the given batches instead. 3 warm-up steps (the first under
``tools/timing.py:step_flops``), 3 chains of 20 steps; ``clips_per_sec`` is
B x 2 over the best chain's step time, ``mfu_pct`` the counted operations
against the H100's bf16 peak. Each record is merged into ``--out`` (default
``build/bench/backbones.json``) as it is measured (``tools/sweep_merge.py``);
the last line of standard output is the list of records.

Usage (on the card, from the repo root)::

    python3 -m dualvar_tpu_torch.tools.backbone_bench [net | net:B ...]
        [--steps 20] [--chains 3] [--out PATH] [--device cuda] [--smoke]
"""

from __future__ import annotations

import dataclasses
import json
import sys

import torch

from ..train.pretrain import _resolve_device
from .bench import SMOKE_BATCHES, TrainUnit, aug_config, shapes, tool_parser
from .bench import train_record
from .soak import soak_config
from .sweep_merge import parse_batches, sweep
from .timing import device_line, finite, log, measure

# batch candidates a family, largest first
CANDIDATES = {
    "r3d": (128, 64, 32),
    "r21d": (128, 64, 32, 16),
    "c3d": (256, 128, 64, 32),
    "s3d": (256, 128, 64, 32, 16),
    "s3dg": (256, 128, 64, 32, 16),
    # the branch-packed variants: the same function, merged 1x1 and
    # block-diagonal separable convolutions
    "s3d_packed": (256, 128, 64, 32, 16),
    "s3dg_packed": (256, 128, 64, 32, 16),
    "r2d3d18": (256, 128, 64, 32),
    "r50": (128, 64, 32, 16),
}


def bench_net(net: str, n_steps: int = 20, chains: int = 3, batches=None,
              device: str | torch.device = "cuda", smoke: bool = False
              ) -> dict:
    """One net's record; ``error`` where no candidate fits."""
    device = _resolve_device(device)
    _, H0, W0, _ = shapes(smoke)
    cfg = soak_config("float32" if smoke else "bfloat16")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, net=net))
    aug_cfg = aug_config(smoke)
    candidates = batches or (SMOKE_BATCHES if smoke else CANDIDATES[net])
    m = measure(lambda b: TrainUnit(cfg, aug_cfg, b, (H0, W0), device),
                candidates, n_steps, chains, device, net)
    if m.batch is None:
        return {"net": net, "error": "all batch candidates failed",
                "did_not_fit": m.did_not_fit}
    rec = {"net": net, **train_record(m, 2, device)}
    log(f"{net}: B={m.batch} {rec['ms_per_step']} ms/step, "
        f"{rec['clips_per_sec']} clips/s, MFU {rec['mfu_pct']}% "
        f"(chains {rec['chains_ms']})")
    return rec


def main(argv: list[str] | None = None) -> int:
    p = tool_parser(__doc__, "backbones.json")
    p.add_argument("nets", nargs="*",
                   help=f"of {', '.join(CANDIDATES)}, or net:B for given "
                        "batches")
    args = p.parse_args(argv)
    line = device_line(torch.device(args.device))
    log(f"device: {line}")
    _, _, _, img = shapes(args.smoke)

    def bench(spec):
        net, _, batches = spec.partition(":")
        return bench_net(net, args.steps, args.chains,
                         parse_batches(batches) if batches else None,
                         args.device, args.smoke)

    out = sweep(args.nets or list(CANDIDATES), bench, args.out,
                {"shape": f"16x{img}^2, 2 views, fused aug, bf16",
                 "device": line},
                list(CANDIDATES))
    print(json.dumps(out), flush=True)
    return 0 if all(finite(r.get("final_loss")) for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
