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
   ``aug_fused``, the soft-DTW forward and backward kernels, the channel
   sums of the batch norm (``channel_sums``; also against float64 sums) and
   the 3x3x3 conv with BN statistics (``conv3d_bn_stats``; its sums also
   against float64 sums of its own output, at three grid sizes);
4. paths, each through ``train()`` at full width, depth and clip size on
   synthetic frames at batch 8, with every kernel's launch count set to 0
   just before and read just after:
   - preset ``paper_table1_k400`` (SimCLR TimeSeriesV4, mode ``clip-sr-tc``);
   - path M: preset ``paper_table2_moco_r21d`` in mode ``clip-sr-dtw`` (MoCo
     TimeSeriesV4, K=16384: soft-DTW of every query against the whole
     queue), with checks of the queues, the pointer and the key encoder;
   - path S: ``paper_table1_k400`` in mode ``clip-sr-dtw``;
   - path R: ``paper_table1_k400`` with ``--net r3d --model simclr_naked``
     (SimCLR NT-Xent on R3D-18) with ``DUALVAR_BN_STATS=pallas`` (every batch
     norm's sums through ``channel_sums``), and without it; then
     ``conv3d_bn_stats`` on the input of path R's ``layer1_block0.conv2``
     against that layer's output and the batch statistics its ``bn2`` used;
   - the presets ``smoke``, ``smoke_dualvar`` and ``smoke_moco``, one step;
   then step times at B=8 and B=32 (MoCo in ``clip-sr-tc`` and
   ``clip-sr-dtw``: the difference is what soft-DTW and its cost tensor
   take), and of path R at B=8, 32 and 128 with the variable on and off;
5. on-card float32 checks: one train-mode forward with TF32 off against the
   same forward on the CPU from the same weights and block, for the SimCLR
   model, for MoCo in mode ``clip-sr-dtw`` (where the CPU side runs the
   plain soft-DTW, so the kernels are also held against it inside the model)
   and for path R with the variable on (the CPU side takes the plain sums).

The last three lines of standard output are one JSON object describing every
kernel (``{"kernels": [...]}``), the card's name and power limit, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device the script fails; it never carries on on the CPU. It
imports nothing of JAX. Logs and checkpoints of the run go under ``build/``
beside this file and are removed at the end.
"""

from __future__ import annotations

import contextlib
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
BF16_FLOPS_PER_S = 989e12

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
# channel sums vs float64 sums and vs the plain version: float32 sums over up
# to 802,816 values a channel, taken in another order; relative to the sum
# of the magnitudes (sum |a|, sum |a*b|), where float32 order alone moves a
# few 1e-7
SUMS_RTOL = 1e-5
# the path R map shapes of the batch norm at B=8 (16 clips): stem and
# layer 1, layers 2, 3, 4 (three batch norms each, 12 in all)
R3D_MAPS = ((16, 64, 16, 56, 56), (16, 128, 8, 28, 28), (16, 256, 4, 14, 14),
            (16, 512, 2, 7, 7))
# conv3d_bn_stats: y against a float32 convolution of the same bf16 inputs
# is within half a bfloat16 ulp (2**-8 of |y|) plus float32 sum order;
# against another bf16 result (cuDNN's) within one ulp (2**-7 of |y|)
CONV_HALF_ULP, CONV_ULP, CONV_ATOL = 2.0 ** -8, 2.0 ** -7, 1e-4
# its s1, s2 against float64 sums of its own y: float32 partial sums only
CONV_SUMS_RTOL = 1e-5
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


def sums_bound_ms(numel: int, C: int, elem_bytes: int,
                  backward: bool) -> tuple[float, str]:
    """The least time for one channel_sums call: bytes (one or two inputs
    read once, 8*C bytes written) against float32 operations (an add and a
    multiply-add, 3 a value)."""
    n_in = 2 if backward else 1
    t_bytes = (n_in * numel * elem_bytes + 8 * C) / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * numel / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_channel_sums_kernel(torch, device) -> dict:
    """channel_sums against float64 sums and its plain version on the card,
    at path R's map shapes and a ragged one, in NCDHW and channels_last_3d,
    float32 and bfloat16, a = b and a != b; then its time at path R's shapes
    (CUDA-graph replays), beside ATen's reductions for the same
    information."""
    from dualvar_tpu_torch.ops import bn_stats as mod

    gen = torch.Generator(device=device).manual_seed(5)
    worst = worst_abs = 0.0
    # (3, 24, 7, 11, 13): 21,021 rows channels-last, 1001 inner values
    for shape in R3D_MAPS + ((3, 24, 7, 11, 13),):
        base = torch.randn(shape, device=device, generator=gen) * 2 + 0.5
        other = torch.randn(shape, device=device, generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            for fmt in (torch.contiguous_format, torch.channels_last_3d):
                a = base.to(dtype).contiguous(memory_format=fmt)
                for b in (a, other.to(dtype).contiguous(memory_format=fmt)):
                    s1, s2 = mod.channel_sums(a, b, dim=1)
                    p1, p2 = mod.channel_sums_plain(a, b, dim=1)
                    a64, b64 = a.double(), b.double()
                    dims = (0, 2, 3, 4)
                    r1, r2 = a64.sum(dims), (a64 * b64).sum(dims)
                    m1, m2 = a64.abs().sum(dims), (a64 * b64).abs().sum(dims)
                    torch.cuda.synchronize()
                    err = max(
                        float(((s1.double() - r1).abs() / m1).max()),
                        float(((s2.double() - r2).abs() / m2).max()),
                        float(((s1 - p1).double().abs() / m1).max()),
                        float(((s2 - p2).double().abs() / m2).max()))
                    worst = max(worst, err)
                    worst_abs = max(worst_abs, float((s1 - p1).abs().max()),
                                    float((s2 - p2).abs().max()))
                    if not err <= SUMS_RTOL:
                        fail(f"channel_sums {shape} {dtype} {fmt} "
                             f"a{'=' if b is a else '!='}b: relative error "
                             f"{err} > {SUMS_RTOL}")
    print(f"kernels: channel_sums vs float64 and plain, {len(R3D_MAPS) + 1} "
          f"shapes x 2 layouts x 2 dtypes x (a=b, a!=b): worst error "
          f"{worst:.3e} of the summed magnitudes (rtol {SUMS_RTOL}); largest "
          f"absolute difference from the plain version {worst_abs:.3e}",
          flush=True)

    # timing, bfloat16 NCDHW as the bf16 step gives them: each map shape
    # once forward (x, x) and once backward (g, x); a step runs each three
    # times (12 batch norms). B=32 for the layer-1 map besides.
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    rows = []
    for shape in R3D_MAPS + ((64, 64, 16, 56, 56),):
        x = torch.randn(shape, device=device, generator=gen).to(
            torch.bfloat16)
        g = torch.randn(shape, device=device, generator=gen).to(
            torch.bfloat16)
        C = shape[1]
        mean = torch.zeros(C, device=device)
        invstd = torch.ones(C, device=device)
        weight = torch.ones(C, device=device)
        for backward, a, b in ((False, x, x), (True, g, x)):
            bound, bound_by = sums_bound_ms(x.numel(), C, 2, backward)
            if backward:
                def library():
                    torch.batch_norm_backward_reduce(
                        g, x, mean, invstd, weight, True, True, True)
            else:
                def library():
                    torch.batch_norm_stats(x, 1e-5)
            row = {
                "shape": list(shape), "backward": backward,
                "ms": time_cuda_graph(
                    torch, lambda: mod.channel_sums(a, b, dim=1), 10),
                "plain_ms": time_cuda(
                    torch, lambda: mod.channel_sums_plain(a, b, dim=1), 10),
                "library_ms": time_cuda_graph(torch, library, 10),
                "bound_ms": bound, "bound_by": bound_by}
            print("kernels: channel_sums timing " + json.dumps(row),
                  flush=True)
            rows.append(row)
            if shape[0] == 16:
                for key in totals:
                    totals[key] += 3 * row[key]
        del x, g
    print("kernels: channel_sums, a B=8 step of path R (12 forward + 12 "
          "backward calls): " + json.dumps(totals), flush=True)
    torch.cuda.empty_cache()
    return {"name": "channel_sums", "route": "cuda",
            "source": "dualvar_tpu_torch/csrc/bn_stats.cu",
            "replaces": "dualvar_tpu/ops/bn_stats.py:63", "launches": 0,
            "max_abs_err": worst_abs, "max_rel_err": worst,
            "rel_err_is_relative_to": "sum of magnitudes",
            "shape": "path R, B=8: the 12 forward and 12 backward calls of "
                     "one step",
            **totals, "bound_by": "bytes",
            # ATen's batch_norm_stats (forward) and
            # batch_norm_backward_reduce (backward) on the same maps
            "library": "torch.batch_norm_stats + "
                       "torch.batch_norm_backward_reduce",
            "per_call": rows}


def conv_bound_ms(N, T, H, W, C, Co, elem_bytes) -> tuple[float, str]:
    """The least time for one 3x3x3 conv with statistics: 2*27*C*Co
    operations an output position at the bf16 tensor-core rate, against x,
    w and y moved once."""
    flops = 2 * N * T * H * W * 27 * C * Co
    bytes_moved = (N * T * H * W * (C + Co) + 27 * C * Co) * elem_bytes
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_conv_kernel(torch, device) -> dict:
    """conv3d_bn_stats at path R's layer-1 shape for N = 1, 2, 16 (three grid
    sizes) and at a ragged shape: y against a float32 convolution of the
    same inputs (TF32 off), s1 and s2 against float64 sums of the kernel's
    own y and against the plain version's; then its time at N=16 (B=8) and
    N=64 (B=32) beside cuDNN's convolution without the sums."""
    from dualvar_tpu_torch.ops import conv_fused as mod

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(6)
    worst_y = worst_s = worst_abs = 0.0
    for (N, T, H, W, C, Co), dtype in (
            ((1, 16, 56, 56, 64, 64), torch.bfloat16),
            ((2, 16, 56, 56, 64, 64), torch.bfloat16),
            ((16, 16, 56, 56, 64, 64), torch.bfloat16),
            ((2, 5, 9, 13, 24, 40), torch.bfloat16),
            ((2, 16, 56, 56, 64, 64), torch.float32)):
        x = torch.randn((N, T, H, W, C), device=device, generator=gen).to(dtype)
        w = torch.randn((3, 3, 3, C, Co), device=device,
                        generator=gen) / math.sqrt(27 * C)
        y, s1, s2 = mod.conv3d_bn_stats_forward(x, w)
        # float32 convolution of the same (rounded) inputs
        ref_y, _, _ = mod.conv3d_bn_stats_plain(x.float(), w.to(dtype).float())
        p_y, p1, p2 = mod.conv3d_bn_stats_plain(x, w)
        torch.cuda.synchronize()
        half_ulp = CONV_HALF_ULP if dtype == torch.bfloat16 else 0.0
        err_y = float(((y.float() - ref_y).abs()
                       / (half_ulp * ref_y.abs() + CONV_ATOL)).max())
        # s1, s2 against float64 sums of the kernel's own y, relative to
        # sum |y| and sum y^2
        y64 = y.double()
        dims = (0, 1, 2, 3)
        err_s = max(
            float(((s1.double() - y64.sum(dims)).abs()
                   / y64.abs().sum(dims)).max()),
            float(((s2.double() - y64.square().sum(dims)).abs()
                   / y64.square().sum(dims)).max()))
        # against the plain version's sums: each y within an ulp of its y
        tol = CONV_ULP if dtype == torch.bfloat16 else 1e-5
        err_p = max(
            float(((s1 - p1).abs() / p_y.float().abs().sum(dims)).max()),
            float(((s2 - p2).abs() / p_y.float().square().sum(dims)).max())
            / 2)
        exact = float((y == p_y).float().mean())
        print(f"kernels: conv3d_bn_stats x={(N, T, H, W, C)} Co={Co} {dtype}: "
              f"y vs float32 conv {err_y:.3e} of the tolerance, s1/s2 vs "
              f"float64 of own y {err_s:.3e} (rtol {CONV_SUMS_RTOL}), vs plain "
              f"{err_p:.3e} (rtol {tol}); y equal to the plain version's "
              f"{exact:.4f} of entries", flush=True)
        if not (err_y <= 1.0 and err_s <= CONV_SUMS_RTOL and err_p <= tol):
            fail(f"conv3d_bn_stats disagrees at x={(N, T, H, W, C)} Co={Co} "
                 f"{dtype}")
        worst_y, worst_s = max(worst_y, err_y), max(worst_s, err_s)
        worst_abs = max(worst_abs, float((y.float() - ref_y).abs().max()))
        del x, y, y64, ref_y, p_y
    torch.backends.cudnn.allow_tf32 = True

    entry = {}
    for N in (16, 64):
        x = torch.randn((N, 16, 56, 56, 64), device=device,
                        generator=gen).to(torch.bfloat16)
        w = torch.randn((3, 3, 3, 64, 64), device=device,
                        generator=gen) / math.sqrt(27 * 64)
        x_ncdhw = x.permute(0, 4, 1, 2, 3)  # channels_last_3d, no copy
        w_ncdhw = w.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d)
        bound, bound_by = conv_bound_ms(N, 16, 56, 56, 64, 64, 2)
        row = {
            "shape": [N, 16, 56, 56, 64],
            "ms": time_cuda(torch, lambda: mod.conv3d_bn_stats_forward(x, w),
                            5, warmup=1),
            "plain_ms": time_cuda(
                torch, lambda: mod.conv3d_bn_stats_plain(x, w), 5, warmup=1),
            # cuDNN's convolution of the same bf16 input, without the sums
            "library_ms": time_cuda(
                torch, lambda: torch.nn.functional.conv3d(
                    x_ncdhw, w_ncdhw, padding=1), 5, warmup=1),
            "bound_ms": bound, "bound_by": bound_by}
        print("kernels: conv3d_bn_stats timing " + json.dumps(row),
              flush=True)
        if N == 16:
            entry = row
        del x, x_ncdhw
    torch.cuda.empty_cache()
    return {"name": "conv3d_bn_stats", "route": "cuda",
            "source": "dualvar_tpu_torch/csrc/conv_fused.cu",
            "replaces": "dualvar_tpu/ops/conv_fused.py:64", "launches": 0,
            # y against a float32 convolution of the same inputs; the share
            # of its tolerance (half a bf16 ulp of |y| + 1e-4) it used
            "max_abs_err": worst_abs, "y_err_over_tol": worst_y,
            "sums_rel_err": worst_s,
            "library": "torch.nn.functional.conv3d (cuDNN), without the sums",
            **entry}


def smoke_cfg(preset: str, batch_size: int, log_root: str,
              mode: str | None = None, **model_kw):
    from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS

    cfg = PRETRAIN_PRESETS[preset]
    mode = mode or cfg.model.mode
    model = dataclasses.replace(cfg.model, mode=mode, **model_kw)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic=True),
        model=model,
        optim=dataclasses.replace(cfg.optim, batch_size=batch_size),
        run=dataclasses.replace(
            cfg.run, print_freq=1, log_root=log_root,
            name_prefix=f"chip_smoke_{model.model}_{model.net}_{mode}"
                        f"_b{batch_size}"))


def path_r_cfg(batch_size: int, log_root: str):
    """Path R: ``--preset paper_table1_k400 --net r3d --model
    simclr_naked``, with at least a batch of synthetic videos."""
    cfg = smoke_cfg("paper_table1_k400", batch_size, log_root, net="r3d",
                    model="simclr_naked")
    return cfg.replace(data=dataclasses.replace(
        cfg.data, synthetic_videos=max(cfg.data.synthetic_videos,
                                       batch_size)))


@contextlib.contextmanager
def bn_stats_env(on: bool):
    """``DUALVAR_BN_STATS=pallas`` inside the block if ``on``, unset
    outside."""
    if on:
        os.environ["DUALVAR_BN_STATS"] = "pallas"
    try:
        yield
    finally:
        os.environ.pop("DUALVAR_BN_STATS", None)


def kernel_counters() -> dict:
    """name in the ``kernels`` line -> the wrapper that carries its count."""
    from dualvar_tpu_torch.ops.aug_fused import aug_fused
    from dualvar_tpu_torch.ops.bn_stats import channel_sums
    from dualvar_tpu_torch.ops.conv_fused import conv3d_bn_stats_forward
    from dualvar_tpu_torch.ops.soft_dtw import (soft_dtw_backward,
                                                soft_dtw_forward)

    return {"aug_fused": aug_fused, "soft_dtw_fwd": soft_dtw_forward,
            "soft_dtw_bwd": soft_dtw_backward, "channel_sums": channel_sums,
            "conv3d_bn_stats": conv3d_bn_stats_forward}


def expected_launches(**counts) -> dict:
    """Expected launch counts of a run: the ones given, every other 0."""
    return {name: counts.get(name, 0) for name in kernel_counters()}


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
        expected_launches(aug_fused=TRAIN_STEPS), TSV4_LOSSES)
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
        expected_launches(aug_fused=TRAIN_STEPS,
                          soft_dtw_fwd=2 * TRAIN_STEPS,
                          soft_dtw_bwd=2 * TRAIN_STEPS), TSV4_LOSSES)
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
        expected_launches(aug_fused=PATH_S_STEPS, soft_dtw_fwd=PATH_S_STEPS,
                          soft_dtw_bwd=PATH_S_STEPS), TSV4_LOSSES)
    return launches


# batch norms of R3D-18: the stem's, two a residual block, three shortcuts'
R3D_BATCH_NORMS = 12


def run_path_r(torch, log_root: str) -> tuple[dict, dict, dict]:
    """Path R: SimCLR NT-Xent on R3D-18. With DUALVAR_BN_STATS=pallas each
    batch norm takes one forward and one backward channel_sums call a step;
    without it (ATen's batch norm, the default) none."""
    cfg = path_r_cfg(8, log_root)
    with bn_stats_env(True):
        state, on = run_path(
            torch, "path R", cfg, TRAIN_STEPS,
            expected_launches(
                aug_fused=TRAIN_STEPS,
                channel_sums=2 * R3D_BATCH_NORMS * TRAIN_STEPS),
            ("clip_loss",))
    for key in ("backbone.bn1.running_mean",
                "backbone.layer4_block0.bn2.running_mean"):
        if float(state[key].abs().max()) == 0.0:
            fail(f"path R: {key} did not move")
    if float((state["backbone.layer4_block0.downsample_bn.running_var"]
              - 1).abs().max()) == 0.0:
        fail("path R: running variances did not move")
    off_cfg = cfg.replace(run=dataclasses.replace(
        cfg.run, name_prefix=cfg.run.name_prefix + "_aten"))
    _, off = run_path(torch, "path R, ATen batch norm", off_cfg,
                      PATH_S_STEPS, expected_launches(aug_fused=PATH_S_STEPS),
                      ("clip_loss",))
    return state, on, off


def check_conv_on_path_r(torch, cfg, state: dict) -> dict:
    """conv3d_bn_stats on path R's own layer-1 tensor: a train step of the
    model path R trained (variable on, bf16 autocast) with the input and
    output of ``backbone.layer1_block0.conv2`` hooked. The kernel, given
    that input and that layer's weight, must give the layer's output (cuDNN
    in bf16: within one bf16 ulp), and through s1/n and s2/n - mu^2 the batch
    mean and variance ``bn2`` folded into its running statistics."""
    from dualvar_tpu_torch.ops.conv_fused import conv3d_bn_stats_forward
    from dualvar_tpu_torch.train.pretrain import setup_training

    with bn_stats_env(True):
        setup = setup_training(cfg, "cuda")
        setup.model.load_state_dict(state)
        with setup.loader as loader:
            frames = torch.from_numpy(
                next(loader.epoch(0))["frames"]).to("cuda")
        block = setup.model.backbone.layer1_block0
        seen = {}
        # the weight as the forward used it: the step's SGD update moves it
        hooks = [block.conv2.register_forward_pre_hook(
                     lambda mod, args: seen.update(
                         x=args[0].detach(), w=mod.weight.detach().clone())),
                 block.conv2.register_forward_hook(
                     lambda mod, args, out: seen.update(y=out.detach()))]
        bn = block.bn2
        rm0, rv0 = bn.running_mean.clone(), bn.running_var.clone()
        setup.train_step(frames, setup.generator)
        for hook in hooks:
            hook.remove()
    m = bn.momentum
    # lerp: new = old + m * (batch - old)
    mu_used = rm0 + (bn.running_mean - rm0) / m
    var_used = rv0 + (bn.running_var - rv0) / m
    x, y_layer = seen["x"], seen["y"].permute(0, 2, 3, 4, 1)
    w = seen["w"].permute(2, 3, 4, 1, 0).contiguous()
    y, s1, s2 = conv3d_bn_stats_forward(
        x.permute(0, 2, 3, 4, 1).contiguous(), w)
    torch.cuda.synchronize()
    if x.dtype != torch.bfloat16 or tuple(x.shape) != (16, 64, 16, 56, 56):
        fail(f"path R layer 1: conv2 input is {x.dtype} {tuple(x.shape)}")
    yl = y_layer.float()
    err_y = float(((y.float() - yl).abs()
                   / (CONV_ULP * yl.abs() + CONV_ATOL)).max())
    n = y.numel() // y.shape[-1]
    mean = s1 / n
    var = s2 / n - mean * mean
    dims = (0, 1, 2, 3)
    # each y within an ulp of the layer's: the means within an ulp of the
    # mean |y|, the second moments within two of the mean y^2
    err_mean = float(((mean - mu_used).abs()
                      / (CONV_ULP * yl.abs().mean(dims) + 1e-6)).max())
    err_var = float(((var - var_used).abs()
                     / (2 * CONV_ULP * yl.square().mean(dims)
                        + 2 * CONV_ULP * mean.abs() * yl.abs().mean(dims)
                        + 1e-6)).max())
    row = {"y_err_over_tol": err_y, "mean_err_over_tol": err_mean,
           "var_err_over_tol": err_var,
           "y_equal_share": float((y == y_layer).float().mean()),
           "mean_abs_diff": float((mean - mu_used).abs().max()),
           "var_abs_diff": float((var - var_used).abs().max())}
    print("path R layer 1: conv3d_bn_stats on the input of "
          "layer1_block0.conv2 vs the layer's output and bn2's batch "
          "statistics: " + json.dumps(row), flush=True)
    if not (err_y <= 1.0 and err_mean <= 1.0 and err_var <= 1.0):
        fail("path R layer 1: conv3d_bn_stats disagrees with the layer")
    del setup
    torch.cuda.empty_cache()
    return row


def run_smoke_presets(torch, log_root: str) -> dict:
    """The CPU-sized presets on the card, one step each."""
    counts = {}
    for preset, keys in (("smoke", ("clip_loss",)),
                         ("smoke_dualvar", TSV4_LOSSES),
                         ("smoke_moco", TSV4_LOSSES)):
        _, counts[preset] = run_path(
            torch, f"preset {preset}", smoke_cfg(preset, 4, log_root), 1,
            expected_launches(aug_fused=1), keys)
    return counts


def time_path_r(torch, log_root: str) -> None:
    """Path R's step at B=8 and 32, and at 128 (else 64) if it fits, with
    ATen's batch norm and with the channel-sum kernel."""
    import gc

    for batch_size in (8, 32):
        for on in (False, True):
            with bn_stats_env(on):
                time_train_steps(torch, path_r_cfg(batch_size, log_root))
    for batch_size in (128, 64):
        try:
            for on in (False, True):
                with bn_stats_env(on):
                    time_train_steps(torch, path_r_cfg(batch_size, log_root),
                                     n=5)
            return
        except torch.cuda.OutOfMemoryError as exc:
            print(f"step time: path R at B={batch_size} does not fit: "
                  f"{str(exc).splitlines()[0]}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def time_train_steps(torch, cfg, n: int = 10) -> None:
    """Step time of the same step train() runs, on one device-resident
    batch (loading excluded), bf16 autocast as the preset asks, over ``n``
    steps after 3 warm-up steps."""
    from dualvar_tpu_torch.train.pretrain import setup_training

    batch_size = cfg.optim.batch_size
    setup = setup_training(cfg, "cuda")
    with setup.loader as loader:
        frames = torch.from_numpy(next(loader.epoch(0))["frames"]).to("cuda")
    for _ in range(3):
        setup.train_step(frames, setup.generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
        "preset": cfg.run.prefix, "net": cfg.model.net,
        "model": cfg.model.model, "mode": cfg.model.mode,
        "bn_stats": os.environ.get("DUALVAR_BN_STATS", "aten"),
        "batch_size": batch_size, "steps": n, "dtype": cfg.model.dtype,
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
    n_views = 2 if cfg.model.model.endswith("naked") else 3
    with HostLoader(build_dataset(cfg, n_views), 2, seed=1,
                    num_workers=2) as loader:
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

    # the batch norm's path is chosen per run below, not by the caller
    os.environ.pop("DUALVAR_BN_STATS", None)
    tic = time.perf_counter()
    names = ("aug_fused", "soft_dtw", "bn_stats", "conv_fused")
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
               *check_soft_dtw_kernels(torch, device),
               check_channel_sums_kernel(torch, device),
               check_conv_kernel(torch, device)]

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    log_root = tempfile.mkdtemp(prefix="chip_smoke_",
                                dir=os.path.join(here, "build"))
    try:
        state, by_path = run_main_path(torch, log_root)
        by_path = {"paper_table1_k400": by_path}
        moco_state, by_path["path M"] = run_path_m(torch, log_root)
        by_path["path S"] = run_path_s(torch, log_root)
        r_state, by_path["path R"], by_path["path R, ATen batch norm"] = \
            run_path_r(torch, log_root)
        by_path.update(run_smoke_presets(torch, log_root))
        for kernel in kernels:
            # each kernel's count on the main path of the slice that ported
            # it (path R for this slice's); every path's count rides along
            home = "path M" if kernel["name"].startswith("soft_dtw") \
                else "path R"
            kernel["launches"] = by_path[home][kernel["name"]]
            kernel["launches_path"] = home
            kernel["launches_by_path"] = {
                path: counts[kernel["name"]]
                for path, counts in by_path.items()}
        kernels[-1]["path_r_layer1"] = check_conv_on_path_r(
            torch, path_r_cfg(8, log_root), r_state)
        for batch_size in (8, 32):
            time_train_steps(torch, smoke_cfg(
                "paper_table1_k400", batch_size, log_root))
            for mode in ("clip-sr-tc", "clip-sr-dtw"):
                time_train_steps(torch, smoke_cfg(
                    MOCO_PRESET, batch_size, log_root, mode=mode))
        time_path_r(torch, log_root)
        check_f32_forward(torch, "paper_table1_k400",
                          smoke_cfg("paper_table1_k400", 2, log_root), state)
        check_f32_forward(
            torch, "path M",
            smoke_cfg(MOCO_PRESET, 2, log_root, mode="clip-sr-dtw"),
            moco_state)
        with bn_stats_env(True):
            check_f32_forward(torch, "path R", path_r_cfg(2, log_root),
                              r_state)
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
