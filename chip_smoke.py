#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

Run from the repo root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit):

1. device: card name and power limit, CUDA version, TF32 flags;
2. build: every CUDA kernel of the paths below, from
   ``dualvar_tpu_torch/csrc``, one ``nvcc`` a source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the paths give it, then timed beside its roofline bound:
   ``aug_fused``, and the soft-DTW forward and backward kernels;
4. paths, each through ``train()`` at full width, depth and clip size on
   synthetic frames at batch 8, with every kernel's launch count set to 0
   just before and read just after:
   - preset ``paper_table1_k400`` (SimCLR TimeSeriesV4, mode ``clip-sr-tc``);
   - path M: preset ``paper_table2_moco_r21d`` in mode ``clip-sr-dtw`` (MoCo
     TimeSeriesV4, K=16384: soft-DTW of every query against the whole
     queue), with checks of the queues, the pointer and the key encoder;
   - path S: ``paper_table1_k400`` in mode ``clip-sr-dtw``;
   then step times at B=8 and B=32 (MoCo in ``clip-sr-tc`` and
   ``clip-sr-dtw``: the difference is what soft-DTW and its cost tensor
   take);
5. on-card float32 checks: one train-mode forward with TF32 off against the
   same forward on the CPU from the same weights and block, for the SimCLR
   model and for MoCo in mode ``clip-sr-dtw`` (where the CPU side runs the
   plain soft-DTW, so the kernels are also held against it inside the model).

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
PATH_S_STEPS = 2
MOCO_PRESET = "paper_table2_moco_r21d"
# soft-DTW kernels against the plain recurrences, float32 on the card: atol
# 1e-6 plus rtol 1e-5 of the largest finite |R| of the batch (about 20 at
# 16x16, one ulp 2e-6). Not bitwise: expf / logf of the CUDA math library
# differ from ATen's by an ulp and the kernel contracts multiply-adds.
DTW_RTOL, DTW_ATOL = 1e-5, 1e-6
# dD = E * g with E in [0, 1], both sides from the SAME R: only the three
# exp of a cell differ, by an ulp each
DTW_GRAD_ATOL = 1e-5
# dD through the whole function, each side from its own R: the two R differ
# by up to 1.5e-5 at 16x16 (8 ulp at |R| ~ 20), which over gamma 0.1 moves
# every exp of the E recurrence by 1.5e-4 relative, times |g| up to 4.5
DTW_GRAD_E2E_ATOL = 2e-3
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


def time_cuda_graph(torch, fn, reps: int, iters: int = 20) -> float:
    """Median milliseconds of one call of ``fn`` when ``reps`` calls are
    replayed back to back from a CUDA graph: the device's time for a kernel
    that is over sooner than the host can launch the next one."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_cuda(torch, graph.replay, iters) / reps


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


def dtw_bound_ms(P: int, N: int, M: int, backward: bool) -> tuple[float, str]:
    """The least time the card could take for one soft-DTW pass. Bytes:
    forward D read, R and the values written; backward D, R, g read and dD
    written. Operations, float32, a cell: forward 3 divisions, 3 exp, 1 log
    and 11 add / multiply / max; backward 3 exp, 6 subtractions, 3
    multiplications and 3 multiply-adds (counted as 2)."""
    cells = P * N * M
    if backward:
        bytes_moved, ops = 4 * (3 * cells + P), 18 * cells
    else:
        bytes_moved, ops = 4 * (2 * cells + P), 18 * cells
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_soft_dtw_kernels(torch, device) -> tuple[dict, dict]:
    """Both soft-DTW kernels against the plain recurrences on the card, then
    their times at the path-M shapes."""
    import numpy as np

    from dualvar_tpu_torch.ops import soft_dtw as mod

    def inputs(P, N, M, seed):
        rng = np.random.default_rng(seed)
        D = rng.uniform(-1.0, 1.0, (P, N, M)).astype(np.float32)
        g = rng.normal(size=P).astype(np.float32)
        return torch.from_numpy(D).to(device), torch.from_numpy(g).to(device)

    def max_err(got, want):
        """Largest |got - want| over the finite entries; inf where the two
        disagree on which entries are infinite."""
        finite = torch.isfinite(want)
        if not torch.equal(finite, torch.isfinite(got)) or \
                not torch.equal(got[~finite], want[~finite]):
            return math.inf
        err = (got - want)[finite].abs()
        return float(err.max()) if err.numel() else 0.0

    worst_fwd = worst_bwd = 0.0
    # path M at B=8 (B*K + B pairs of 2x2, gamma 0.1); the largest supported
    # size without and with a band; non-square with P not a block multiple
    for P, N, M, gamma, band in ((131080, 2, 2, 0.1, 0.0),
                                 (4096, 16, 16, 0.1, 0.0),
                                 (4096, 16, 16, 0.1, 3.0),
                                 (1000, 5, 7, 1.0, 0.0)):
        D, g = inputs(P, N, M, seed=P + N)
        values, R = mod.soft_dtw_forward(D, gamma, band)
        R_plain = mod._softdtw_R_plain(D, gamma, band)
        dD = mod.soft_dtw_backward(D, R, g, gamma, band)
        dD_plain = mod._softdtw_E_plain(D, R, gamma, band) * g[:, None, None]
        # the differentiable function end to end, each side from its own R
        leaf_k, leaf_p = (D.clone().requires_grad_() for _ in range(2))
        (mod.soft_dtw(leaf_k, gamma, band) * g).sum().backward()
        (mod.soft_dtw_plain(leaf_p, gamma, band) * g).sum().backward()
        torch.cuda.synchronize()
        err_v = max_err(values, R_plain[:, -1, -1])
        err_r = max_err(R, R_plain)
        err_g = max_err(dD, dD_plain)
        err_e2e = max_err(leaf_k.grad, leaf_p.grad)
        # on the scale of the largest finite |R|: a cell near 0 carries the
        # rounding of the larger cells it was summed from
        r_tol = DTW_ATOL + DTW_RTOL * float(
            R_plain[torch.isfinite(R_plain)].abs().max())
        print(f"kernels: soft_dtw P={P} N={N} M={M} gamma={gamma} "
              f"band={band}: values {err_v:.3e} R {err_r:.3e} (tolerance "
              f"{r_tol:.3e}) dD {err_g:.3e} (atol {DTW_GRAD_ATOL}, same R) "
              f"dD end to end {err_e2e:.3e} (atol {DTW_GRAD_E2E_ATOL})",
              flush=True)
        if band and not bool(torch.isinf(R).any()):
            fail("soft_dtw: a banded R holds no +inf")
        if not (err_v <= r_tol and err_r <= r_tol and err_g <= DTW_GRAD_ATOL
                and err_e2e <= DTW_GRAD_E2E_ATOL):
            fail(f"soft_dtw kernels disagree with the plain version at "
                 f"P={P} N={N} M={M} band={band}")
        worst_fwd = max(worst_fwd, err_v, err_r)
        worst_bwd = max(worst_bwd, err_g)

    # the wrapper refuses what the kernels do not take
    for bad, exc in ((torch.zeros(4, 17, 2, device=device), ValueError),
                     (torch.zeros(4, 2, 2, device=device,
                                  dtype=torch.bfloat16), TypeError)):
        try:
            mod.soft_dtw(bad, 0.1)
        except exc:
            continue
        fail(f"soft_dtw accepted {tuple(bad.shape)} {bad.dtype}")
    empty = mod.soft_dtw(torch.zeros(0, 2, 2, device=device), 0.1)
    if tuple(empty.shape) != (0,):
        fail("soft_dtw on P=0 did not return an empty result")

    # timing: path M at B=8 and B=32 (K=16384, 2x2), and the largest size.
    # ``ms`` is the kernel on the device (10 launches replayed from a CUDA
    # graph: at 2x2 it is over before the host has launched the next one),
    # ``wrapper_ms`` one eager call of the wrapper as the model makes it.
    entries = {}
    for label, (P, N, M) in (("path M, B=8", (131080, 2, 2)),
                             ("path M, B=32", (524320, 2, 2)),
                             ("largest size", (524288, 16, 16))):
        D, g = inputs(P, N, M, seed=7)
        _, R = mod.soft_dtw_forward(D, 0.1, 0.0)
        rows = {}
        for name, backward, kernel, plain in (
                ("soft_dtw_fwd", False,
                 lambda: mod.soft_dtw_forward(D, 0.1, 0.0),
                 lambda: mod._softdtw_R_plain(D, 0.1, 0.0)),
                ("soft_dtw_bwd", True,
                 lambda: mod.soft_dtw_backward(D, R, g, 0.1, 0.0),
                 lambda: mod._softdtw_E_plain(D, R, 0.1, 0.0)
                 * g[:, None, None])):
            bound, bound_by = dtw_bound_ms(P, N, M, backward)
            rows[name] = {
                "ms": time_cuda_graph(torch, kernel, 10),
                "wrapper_ms": time_cuda(torch, kernel, 30),
                "plain_ms": time_cuda(torch, plain, 3, warmup=1),
                "bound_ms": bound, "bound_by": bound_by}
            print(f"kernels: {name} timing, {label}, P={P} N={N} M={M}: "
                  + json.dumps(rows[name]), flush=True)
        if not entries:
            entries = rows
    common = {"route": "cuda",
              "source": "dualvar_tpu_torch/csrc/soft_dtw.cu", "launches": 0,
              # no single PyTorch call computes the recurrence
              "library_ms": None}
    return (
        {"name": "soft_dtw_fwd",
         "replaces": "dualvar_tpu/ops/soft_dtw.py:186",
         "max_abs_err": worst_fwd, **common, **entries["soft_dtw_fwd"]},
        {"name": "soft_dtw_bwd",
         "replaces": "dualvar_tpu/ops/soft_dtw.py:204",
         "max_abs_err": worst_bwd, **common, **entries["soft_dtw_bwd"]})


def smoke_cfg(preset: str, batch_size: int, log_root: str,
              mode: str | None = None):
    from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS

    cfg = PRETRAIN_PRESETS[preset]
    mode = mode or cfg.model.mode
    return cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic=True),
        model=dataclasses.replace(cfg.model, mode=mode),
        optim=dataclasses.replace(cfg.optim, batch_size=batch_size),
        run=dataclasses.replace(
            cfg.run, print_freq=1, log_root=log_root,
            name_prefix=f"chip_smoke_{mode}_b{batch_size}"))


def kernel_counters() -> dict:
    """name in the ``kernels`` line -> the wrapper that carries its count."""
    from dualvar_tpu_torch.ops.aug_fused import aug_fused
    from dualvar_tpu_torch.ops.soft_dtw import (soft_dtw_backward,
                                                soft_dtw_forward)

    return {"aug_fused": aug_fused, "soft_dtw_fwd": soft_dtw_forward,
            "soft_dtw_bwd": soft_dtw_backward}


def run_path(torch, label: str, cfg, steps: int, want_launches: dict,
             loss_keys: tuple) -> tuple[dict, dict]:
    """train() for ``steps`` steps at B=8 with every launch count set to 0
    just before and read just after; returns the checkpoint's state_dict and
    the counts of exactly that run."""
    from dualvar_tpu_torch.train.pretrain import set_path, train

    counters = kernel_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    metrics = train(cfg, max_steps=steps, device="cuda")
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in counters.items()}
    for key in loss_keys + ("total_loss",):
        if key not in metrics or not math.isfinite(metrics[key]):
            fail(f"{label}: {key} missing or not finite: {metrics}")
    if launches != want_launches:
        fail(f"{label}: launches {launches} in {steps} train steps, "
             f"expected {want_launches}")
    ckpt = torch.load(os.path.join(set_path(cfg), "model", "epoch0.pth.tar"),
                      map_location="cpu")
    if ckpt["iteration"] != steps:
        fail(f"{label}: checkpoint iteration {ckpt['iteration']} != {steps}")
    state = ckpt["state_dict"]
    for key, val in state.items():
        if not torch.isfinite(val).all():
            fail(f"{label}: {key} is not finite after training")
    print(f"{label}: {steps} steps of {cfg.run.prefix} mode "
          f"{cfg.model.mode} at B={cfg.optim.batch_size}, launches="
          + json.dumps(launches) + ", metrics=" + json.dumps(metrics),
          flush=True)
    return state, launches


TSV4_LOSSES = ("clip_loss", "tc_loss", "aug_ranking_margin_loss",
               "unaug_ranking_margin_loss")


def run_main_path(torch, log_root: str) -> tuple[dict, dict]:
    """The first slice's path: SimCLR TimeSeriesV4 in mode clip-sr-tc."""
    state, launches = run_path(
        torch, "path paper_table1_k400",
        smoke_cfg("paper_table1_k400", 8, log_root), TRAIN_STEPS,
        {"aug_fused": TRAIN_STEPS, "soft_dtw_fwd": 0, "soft_dtw_bwd": 0},
        TSV4_LOSSES)
    mean = state["backbone.bn1.running_mean"]
    var = state["backbone.layer4_block0.bn2.running_var"]
    if float(mean.abs().max()) == 0.0 or float((var - 1).abs().max()) == 0.0:
        fail("main path: BN running statistics did not move")
    return state, launches


def initial_state(torch, cfg) -> dict:
    """The state_dict ``setup_training`` starts from for ``cfg``, rebuilt on
    the CPU from the same seeds."""
    from dualvar_tpu_torch.train.tasks import make_task

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.run.seed)
        task = make_task(cfg.model,
                         torch.Generator().manual_seed(cfg.run.seed))
    return task.model.state_dict()


def run_path_m(torch, log_root: str) -> tuple[dict, dict]:
    """Path M: MoCo TimeSeriesV4 at K=16384 in mode clip-sr-dtw. A step
    calls the soft-DTW function twice (each query against its key, B pairs,
    and against the whole queue, B*K pairs), so both kernels launch twice a
    step."""
    cfg = smoke_cfg(MOCO_PRESET, 8, log_root, mode="clip-sr-dtw")
    state, launches = run_path(
        torch, "path M", cfg, TRAIN_STEPS,
        {"aug_fused": TRAIN_STEPS, "soft_dtw_fwd": 2 * TRAIN_STEPS,
         "soft_dtw_bwd": 2 * TRAIN_STEPS}, TSV4_LOSSES)
    init = initial_state(torch, cfg)
    written = 8 * TRAIN_STEPS
    if int(state["queue_ptr"]) != written:
        fail(f"path M: queue_ptr {int(state['queue_ptr'])} != {written}")
    m = cfg.model
    for name, seg_dim in (("queue", m.moco_dim),
                          ("series_queue", m.series_dim)):
        new, old = state[name], init[name]
        if not torch.equal(new[written:], old[written:]):
            fail(f"path M: rows {written}.. of {name} changed")
        if bool((new[:written] == old[:written]).all(dim=1).any()):
            fail(f"path M: a row 0..{written - 1} of {name} was not written")
        norms = new[:written].reshape(written, -1, seg_dim).norm(dim=-1)
        if float((norms - 1).abs().max()) > 1e-4:
            fail(f"path M: written rows of {name} are not unit-norm per "
                 "segment")
    moved = differs = False
    for key in (k for k in state if k.startswith("encoder_k.")
                and "running_" not in k):
        moved |= not torch.equal(state[key], init[key])
        differs |= not torch.equal(state[key],
                                   state["encoder_q." + key[10:]])
    if not (moved and differs):
        fail("path M: the key encoder did not move by its momentum update, "
             "or equals the query encoder")
    k_mean = state["encoder_k.backbone.bn1.running_mean"]
    if float(k_mean.abs().max()) == 0.0 or torch.equal(
            k_mean, state["encoder_q.backbone.bn1.running_mean"]):
        fail("path M: the key encoder's BN running statistics did not move "
             "from its own forwards")
    print(f"path M: queue_ptr={written}, rows 0..{written - 1} of both "
          "queues written and unit-norm, the rest untouched; key encoder "
          "moved", flush=True)
    return state, launches


def run_path_s(torch, log_root: str) -> dict:
    """Path S: SimCLR TimeSeriesV4 with the TC loss aligned by soft-DTW, one
    call over the (2B)^2 pairs a step."""
    _, launches = run_path(
        torch, "path S",
        smoke_cfg("paper_table1_k400", 8, log_root, mode="clip-sr-dtw"),
        PATH_S_STEPS,
        {"aug_fused": PATH_S_STEPS, "soft_dtw_fwd": PATH_S_STEPS,
         "soft_dtw_bwd": PATH_S_STEPS}, TSV4_LOSSES)
    return launches


def time_train_steps(torch, cfg) -> None:
    """Step time of the same step train() runs, on one device-resident
    batch (loading excluded), bf16 autocast as the preset asks."""
    from dualvar_tpu_torch.train.pretrain import setup_training

    batch_size = cfg.optim.batch_size
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
    key_encoder = getattr(setup.model, "encoder_k", None)
    if key_encoder is not None and any(
            p.grad is not None or p.requires_grad
            for p in key_encoder.parameters()):
        fail("timed steps: a key-encoder parameter has a gradient")
    print("step time: " + json.dumps({
        "preset": cfg.run.prefix, "mode": cfg.model.mode,
        "batch_size": batch_size, "dtype": cfg.model.dtype,
        "ms_per_step": ms, "clips_per_s": batch_size / ms * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }), flush=True)
    del setup
    torch.cuda.empty_cache()


def check_f32_forward(torch, label: str, cfg, state: dict) -> None:
    """One train-mode float32 forward on the card, TF32 off, against the CPU
    from the same state_dict, block and segment permutation. On the CPU the
    soft-DTW wrapper takes its plain version, so for mode clip-sr-dtw this
    also holds the kernels against it inside the model.

    Tolerances: the losses to 1e-4 and the logits (cosine / 0.07, so up to
    +-14.3) to 5e-4 absolute — float32 convolutions that sum in another
    order, through 18 layers of batch-statistics BN on a 2-clip batch.
    TF32 convolutions (3 decimal digits) would miss these by a wide margin,
    so the check also shows that the flags took effect."""
    from dualvar_tpu_torch.aug.pipeline import AugConfig, pretrain_batch
    from dualvar_tpu_torch.data.loader import HostLoader
    from dualvar_tpu_torch.train.pretrain import build_dataset
    from dualvar_tpu_torch.train.tasks import make_task

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
            fail(f"f32 check, {label}: {key} has shape {tuple(got.shape)} "
                 "or is not finite")
        if key.endswith("labels"):
            continue
        # masked columns hold -1e9 / T in both; compare the live entries
        live = want > -1e6
        if not torch.equal(live, got > -1e6):
            fail(f"f32 check, {label}: {key} masks differ")
        err = float((got - want)[live].abs().max())
        if key.endswith("loss"):
            worst_loss = max(worst_loss, err)
        else:
            worst_logit = max(worst_logit, err)
    print(f"f32 check, {label}: card vs CPU, TF32 off: max loss err "
          f"{worst_loss:.3e} (atol 1e-4), max logit err {worst_logit:.3e} "
          "(atol 5e-4)", flush=True)
    if not (worst_loss <= 1e-4 and worst_logit <= 5e-4):
        fail(f"f32 check, {label}: card and CPU forwards disagree")


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

    from concurrent.futures import ThreadPoolExecutor

    tic = time.perf_counter()
    names = ("aug_fused", "soft_dtw")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc a source
        list(pool.map(load_library, names))
    print(f"build: {', '.join(names)} in {time.perf_counter() - tic:.1f} s",
          flush=True)
    for name in names:
        with open(os.path.join(BUILD_DIR, f"{name}.ptxas.log")) as fh:
            print(f"build: ptxas {name}: " + " | ".join(
                line.strip() for line in fh
                if "registers" in line or "spill" in line), flush=True)

    device = torch.device("cuda")
    kernels = [check_aug_kernel(torch, device),
               *check_soft_dtw_kernels(torch, device)]

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    log_root = tempfile.mkdtemp(prefix="chip_smoke_",
                                dir=os.path.join(here, "build"))
    try:
        state, by_path = run_main_path(torch, log_root)
        by_path = {"paper_table1_k400": by_path}
        moco_state, by_path["path M"] = run_path_m(torch, log_root)
        by_path["path S"] = run_path_s(torch, log_root)
        for kernel in kernels:
            # this slice's main path; the other paths' counts ride along
            kernel["launches"] = by_path["path M"][kernel["name"]]
            kernel["launches_by_path"] = {
                path: counts[kernel["name"]]
                for path, counts in by_path.items()}
        for batch_size in (8, 32):
            time_train_steps(torch, smoke_cfg(
                "paper_table1_k400", batch_size, log_root))
            for mode in ("clip-sr-tc", "clip-sr-dtw"):
                time_train_steps(torch, smoke_cfg(
                    MOCO_PRESET, batch_size, log_root, mode=mode))
        check_f32_forward(torch, "paper_table1_k400",
                          smoke_cfg("paper_table1_k400", 2, log_root), state)
        check_f32_forward(
            torch, "path M",
            smoke_cfg(MOCO_PRESET, 2, log_root, mode="clip-sr-dtw"),
            moco_state)
    finally:
        shutil.rmtree(log_root, ignore_errors=True)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
