#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

Run from the repo root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit):

1. device: card name and power limit, CUDA version, TF32 flags;
2. build: every CUDA kernel of the main path, from ``dualvar_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main-path shape, then timed beside its roofline bound;
4. main path: ``train()`` on preset ``paper_table1_k400`` (full width, depth
   and clip size, synthetic frames, batch 8) for a few steps; the kernels'
   launch counts are set to 0 just before and read just after; then step
   times at B=8 and B=32;
5. on-card float32 check: one train-mode forward with TF32 off against the
   same forward on the CPU from the same weights and block.

The last three lines of standard output are one JSON object describing every
kernel (``{"kernels": [...]}``), the card's name and power limit, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device the script fails; it never carries on on the CPU. It
imports nothing of JAX. Logs and checkpoints of the run go under ``build/``
beside this file and are removed at the end.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

TRAIN_STEPS = 4
F32_ATOL = 2e-5  # kernel vs plain, float32 out: reassociated sums, fma
# one bfloat16 ulp at the top of the normalised range (|x| < 4 -> 2**-6):
# kernel and plain round the same float32 value up to 2e-5 apart
BF16_ATOL = 2.0 ** -6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_cuda(torch, fn, iters: int, warmup: int = 3) -> float:
    """Median milliseconds of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def aug_inputs(torch, n: int, t: int, s: int, seed: int, device):
    """Clips and decisions covering every op order, blur on and off (small
    and large sigma), hue shifts of both signs and the identity pipeline."""
    import itertools

    import numpy as np

    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 256, (n, 3, t, s, s), dtype=np.uint8)
    perms = list(itertools.permutations(range(4)))
    orders = np.array([perms[i % 24] for i in range(n)], np.int32)
    factors = rng.uniform(0.2, 1.8, (n, 4)).astype(np.float32)
    factors[:, 3] = rng.uniform(-0.2, 0.2, n)
    sigma = rng.uniform(0.1, 2.0, n).astype(np.float32)
    on = (np.arange(n) % 2).astype(np.float32)  # every other clip blurred
    if n >= 4:
        factors[3] = (1.0, 1.0, 1.0, 0.0)  # identity (null) pipeline,
        on[3] = 0.0                         # crop-only clip
        sigma[1], sigma[5 % n] = 0.1, 2.0
    blur = np.stack([sigma, on], axis=1)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (clips, orders, factors, blur))


def aug_bound_ms(torch, clips, blur, out_dtype) -> tuple[float, str]:
    """The least time the card could take: bytes (input read once, output
    written once) against operations (this run's blurred clips counted)."""
    n, _, t, s, _ = clips.shape
    pixels = n * t * s * s
    out_bytes = torch.empty((), dtype=out_dtype).element_size()
    bytes_moved = pixels * 3 * (1 + out_bytes)
    # float32 operations per pixel (3 channels): convert 3, brightness 9,
    # contrast 20, saturation 20, hue 60, normalise 6; blur 2 passes x 13
    # taps x 2 x 3 channels on the clips that are blurred
    blurred = float((blur[:, 1] > 0).float().mean())
    ops = pixels * (118 + 156 * blurred)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_aug_kernel(torch, device) -> dict:
    from dualvar_tpu_torch.ops import aug_fused as mod

    worst = 0.0
    for n, seed in ((24, 0), (5, 1)):
        args = aug_inputs(torch, n, 16, 112, seed, device)
        for normalize in (True, False):
            got = mod.aug_fused(*args, normalize=normalize)
            want = mod.aug_fused_plain(*args, normalize=normalize)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not err <= F32_ATOL:
                fail(f"aug_fused f32 N={n} normalize={normalize}: "
                     f"max abs err {err} > {F32_ATOL}")
        got16 = mod.aug_fused(*args, out_dtype=torch.bfloat16)
        want16 = mod.aug_fused_plain(*args, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        if got16.dtype != torch.bfloat16:
            fail("aug_fused bf16 output has the wrong dtype")
        err16 = float((got16.float() - want16.float()).abs().max())
        if not err16 <= BF16_ATOL:
            fail(f"aug_fused bf16 N={n}: max abs err {err16} > {BF16_ATOL}")
        print(f"kernels: aug_fused N={n} f32 max_abs_err={worst:.3e} "
              f"(atol {F32_ATOL}) bf16 max_abs_err={err16:.3e} "
              f"(atol {BF16_ATOL})", flush=True)

    # timing at the main-path shape (B=8 -> N=24, float32 out), and for the
    # record at B=32 -> N=96
    entry = {}
    for n in (24, 96):
        clips, orders, factors, blur = aug_inputs(torch, n, 16, 112, 2, device)
        bound, bound_by = aug_bound_ms(torch, clips, blur, torch.float32)
        ms = time_cuda(torch, lambda: mod._launch(
            clips, orders, factors, blur, torch.float32, True), 30)
        wrapper_ms = time_cuda(torch, lambda: mod.aug_fused(
            clips, orders, factors, blur), 30)
        plain_ms = time_cuda(torch, lambda: mod.aug_fused_plain(
            clips, orders, factors, blur), 5, warmup=1)
        row = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": bound_by}
        print(f"kernels: aug_fused timing N={n} T=16 S=112 f32: "
              + json.dumps(row), flush=True)
        if n == 24:
            entry = row
            # where the kernel's time goes: the same shape with every clip
            # blurred and with none
            for name, on in (("all", 1.0), ("none", 0.0)):
                b = blur.clone()
                b[:, 1] = on
                ms_b = time_cuda(torch, lambda: mod._launch(
                    clips, orders, factors, b, torch.float32, True), 30)
                print(f"kernels: aug_fused timing N=24, {name} of the clips "
                      f"blurred: {ms_b:.4f} ms", flush=True)
    return {
        "name": "aug_fused", "route": "cuda",
        "source": "dualvar_tpu_torch/csrc/aug_fused.cu",
        "replaces": "dualvar_tpu/ops/aug_fused.py:153",
        "launches": 0, "max_abs_err": worst, **entry,
        # no single PyTorch call computes this chain
        "library_ms": None,
    }


def smoke_cfg(batch_size: int, log_root: str):
    from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS

    cfg = PRETRAIN_PRESETS["paper_table1_k400"]
    return cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic=True),
        optim=dataclasses.replace(cfg.optim, batch_size=batch_size),
        run=dataclasses.replace(cfg.run, print_freq=1, log_root=log_root,
                                name_prefix=f"chip_smoke_b{batch_size}"))


def run_main_path(torch, log_root: str) -> tuple[dict, int]:
    """train() for TRAIN_STEPS steps at B=8; returns the checkpoint and the
    kernel's launch count over exactly that run."""
    from dualvar_tpu_torch.ops.aug_fused import aug_fused
    from dualvar_tpu_torch.train.pretrain import set_path, train

    cfg = smoke_cfg(8, log_root)
    aug_fused.launches = 0
    metrics = train(cfg, max_steps=TRAIN_STEPS, device="cuda")
    torch.cuda.synchronize()
    launches = aug_fused.launches
    for key in ("clip_loss", "tc_loss", "aug_ranking_margin_loss",
                "unaug_ranking_margin_loss", "total_loss"):
        if key not in metrics or not math.isfinite(metrics[key]):
            fail(f"main path: {key} missing or not finite: {metrics}")
    if launches != TRAIN_STEPS:
        fail(f"main path: aug_fused launched {launches} times in "
             f"{TRAIN_STEPS} train steps")
    ckpt = torch.load(os.path.join(set_path(cfg), "model", "epoch0.pth.tar"),
                      map_location="cpu")
    if ckpt["iteration"] != TRAIN_STEPS:
        fail(f"checkpoint iteration {ckpt['iteration']} != {TRAIN_STEPS}")
    state = ckpt["state_dict"]
    for key, val in state.items():
        if not torch.isfinite(val).all():
            fail(f"main path: {key} is not finite after training")
    mean = state["backbone.bn1.running_mean"]
    var = state["backbone.layer4_block0.bn2.running_var"]
    if float(mean.abs().max()) == 0.0 or float((var - 1).abs().max()) == 0.0:
        fail("main path: BN running statistics did not move")
    print(f"main path: {TRAIN_STEPS} steps of paper_table1_k400 at B=8, "
          f"aug_fused launches={launches}, metrics="
          + json.dumps(metrics), flush=True)
    return state, launches


def time_train_steps(torch, batch_size: int, log_root: str) -> None:
    """Step time of the same step train() runs, on one device-resident
    batch (loading excluded), bf16 autocast as the preset asks."""
    from dualvar_tpu_torch.train.pretrain import setup_training

    cfg = smoke_cfg(batch_size, log_root)
    setup = setup_training(cfg, "cuda")
    with setup.loader as loader:
        frames = torch.from_numpy(next(loader.epoch(0))["frames"]).to("cuda")
    for _ in range(3):
        setup.train_step(frames, setup.generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 10
    tic = time.perf_counter()
    for _ in range(n):
        metrics = setup.train_step(frames, setup.generator)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - tic) / n * 1e3
    if not math.isfinite(float(metrics["total_loss"])):
        fail(f"timed steps at B={batch_size}: total loss not finite")
    print("step time: " + json.dumps({
        "batch_size": batch_size, "dtype": cfg.model.dtype,
        "ms_per_step": ms, "clips_per_s": batch_size / ms * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }), flush=True)
    del setup
    torch.cuda.empty_cache()


def check_f32_forward(torch, state: dict, log_root: str) -> None:
    """One train-mode float32 forward on the card, TF32 off, against the CPU
    from the same state_dict, block and segment permutation.

    Tolerances: the losses to 1e-4 and the logits (cosine / 0.07, so up to
    +-14.3) to 5e-4 absolute — float32 convolutions that sum in another
    order, through 18 layers of batch-statistics BN on an 8-clip batch.
    TF32 convolutions (3 decimal digits) would miss these by a wide margin,
    so the check also shows that the flags took effect."""
    from dualvar_tpu_torch.aug.pipeline import AugConfig, pretrain_batch
    from dualvar_tpu_torch.data.loader import HostLoader
    from dualvar_tpu_torch.train.pretrain import build_dataset
    from dualvar_tpu_torch.train.tasks import make_task

    cfg = smoke_cfg(2, log_root)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with HostLoader(build_dataset(cfg), 2, seed=1, num_workers=2) as loader:
        frames = torch.from_numpy(next(loader.epoch(0))["frames"])
    generator = torch.Generator().manual_seed(3)
    aug_cfg = AugConfig(jitter_order="sample")
    block = pretrain_batch(generator, frames.to("cuda"), aug_cfg)
    perm = torch.tensor([[1, 0], [0, 1]])
    rets = {}
    for dev in ("cuda", "cpu"):
        task = make_task(cfg.model)
        task.model.load_state_dict(state)
        task.model.to(dev).train()
        with torch.no_grad():
            rets[dev] = {k: v.float().cpu() for k, v in task.forward(
                block.to(dev), perm=perm).items()}
    worst_loss = worst_logit = 0.0
    for key, want in rets["cpu"].items():
        got = rets["cuda"][key]
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"f32 check: {key} has shape {tuple(got.shape)} or is "
                 "not finite")
        if key.endswith("labels"):
            continue
        # masked columns hold -1e9 / T in both; compare the live entries
        live = want > -1e6
        if not torch.equal(live, got > -1e6):
            fail(f"f32 check: {key} masks differ")
        err = float((got - want)[live].abs().max())
        if key.endswith("loss"):
            worst_loss = max(worst_loss, err)
        else:
            worst_logit = max(worst_logit, err)
    print(f"f32 check: card vs CPU, TF32 off: max loss err {worst_loss:.3e} "
          f"(atol 1e-4), max logit err {worst_logit:.3e} (atol 5e-4)",
          flush=True)
    if not (worst_loss <= 1e-4 and worst_logit <= 5e-4):
        fail("f32 check: card and CPU forwards disagree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from dualvar_tpu_torch.ops.build import BUILD_DIR, load_library

    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    tic = time.perf_counter()
    load_library("aug_fused")
    print(f"build: aug_fused in {time.perf_counter() - tic:.1f} s", flush=True)
    with open(os.path.join(BUILD_DIR, "aug_fused.ptxas.log")) as fh:
        print("build: ptxas: " + " | ".join(
            line.strip() for line in fh if "registers" in line or "spill" in line),
            flush=True)

    device = torch.device("cuda")
    kernel = check_aug_kernel(torch, device)

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    log_root = tempfile.mkdtemp(prefix="chip_smoke_",
                                dir=os.path.join(here, "build"))
    try:
        state, launches = run_main_path(torch, log_root)
        kernel["launches"] = launches
        for batch_size in (8, 32):
            time_train_steps(torch, batch_size, log_root)
        check_f32_forward(torch, state, log_root)
    finally:
        shutil.rmtree(log_root, ignore_errors=True)

    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
