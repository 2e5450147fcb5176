#!/usr/bin/env python3
"""Where the PyTorch port's pretrain step spends its time on the GPU.

Runs the train step of a ``dualvar_tpu_torch`` preset (``paper_table1_k400``
unless ``--preset`` names another; ``--net``, ``--model`` and ``--mode``
override it; full width and depth, synthetic frames, one device-resident
batch) under ``torch.profiler`` for a few steps and prints the device time by
kernel, the device's busy share of the wall time, and the step time without
the profiler. ``DUALVAR_BN_STATS=pallas`` in the environment sends the batch
norm's sums through the channel-sum kernel, as in training.

    python3 scripts/port_profile_step.py --batch_size 32 [--channels_last 1]
    python3 scripts/port_profile_step.py --preset paper_table2_moco_r21d \\
        --mode clip-sr-dtw --batch_size 32
    python3 scripts/port_profile_step.py --preset s3dg_k400 --batch_size 8
    DUALVAR_BN_STATS=pallas python3 scripts/port_profile_step.py \\
        --net r3d --model simclr_naked --batch_size 32

Needs one CUDA device. Prints the card's name and power limit first; every
number is that card's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS
    from dualvar_tpu_torch.train.pretrain import setup_training

    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="paper_table1_k400",
                   choices=sorted(PRETRAIN_PRESETS))
    p.add_argument("--mode", default=None,
                   choices=[None, "clip-sr-tc", "clip-sr", "clip-sr-dtw"],
                   help="the preset's mode unless given")
    p.add_argument("--net", default=None, help="the preset's unless given")
    p.add_argument("--model", default=None, help="the preset's unless given")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--channels_last", type=int, default=0, choices=[0, 1],
                   help="experiment: keep the model's weights in "
                        "channels_last_3d memory format")
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print("device: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())

    cfg = PRETRAIN_PRESETS[args.preset]
    cfg = cfg.replace(
        data=dataclasses.replace(
            cfg.data, synthetic=True,
            synthetic_videos=max(cfg.data.synthetic_videos, args.batch_size)),
        model=dataclasses.replace(cfg.model,
                                  mode=args.mode or cfg.model.mode,
                                  net=args.net or cfg.model.net,
                                  model=args.model or cfg.model.model),
        optim=dataclasses.replace(cfg.optim, batch_size=args.batch_size))
    setup = setup_training(cfg, "cuda")
    if args.channels_last:
        setup.model.to(memory_format=torch.channels_last_3d)
    with setup.loader as loader:
        frames = torch.from_numpy(next(loader.epoch(0))["frames"]).to("cuda")
    step, generator = setup.train_step, setup.generator

    for _ in range(3):
        step(frames, generator)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(args.steps):
        step(frames, generator)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - tic) / args.steps * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(args.steps):
            step(frames, generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tic) * 1e3

    # device kernels only: the operator rows repeat their kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    print(json.dumps({
        "preset": args.preset, "net": cfg.model.net,
        "model": cfg.model.model, "mode": cfg.model.mode,
        "bn_stats": os.environ.get("DUALVAR_BN_STATS", "aten"),
        "batch_size": args.batch_size, "channels_last": args.channels_last,
        "steps": args.steps, "ms_per_step_unprofiled": plain_ms,
        "ms_per_step_profiled": wall_ms / args.steps,
        "device_ms_per_step": device_ms / args.steps,
        "device_busy_share": device_ms / wall_ms,
        "kernels_per_step": sum(r[2] for r in rows) / args.steps,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }))
    if device_ms == 0:
        print("the profiler recorded no device time")
        return 1
    print(f"{'device ms/step':>14} {'share':>6} {'calls/step':>10}  kernel")
    for key, ms, count in rows[:args.top]:
        print(f"{ms / args.steps:14.3f} {ms / device_ms:6.1%} "
              f"{count / args.steps:10.1f}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
