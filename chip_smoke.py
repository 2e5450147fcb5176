#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

Run from the repo root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit):

1. device: card name and power limit, CUDA version, TF32 flags;
2. build: every CUDA kernel of the paths below, from
   ``dualvar_tpu_torch/csrc``, one ``nvcc`` a source, all started together;
   the soft-DTW and channel-sum kernels must show no stack frame and no
   spills in the ptxas log;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the paths give it, then timed beside its roofline bound:
   ``aug_fused`` (its float32 route, with where its error against the
   plain version comes from, and its bfloat16 compute route at the main
   path's N=24 with blur on and off and path C's N=4 and 32, both output
   types, in bfloat16 ulps, timed in L2 and out of it beside the float32
   route), the soft-DTW forward and backward kernels (every column
   bucket and both routes, at path M's and path M16's shapes; timed with
   their data out of L2, the rows route beside the 2x2 route), the channel
   sums of the batch norm (``channel_sums``; also against float64 sums, at
   path R's and path G's shapes, ragged runs, one channel and data off a
   16-byte boundary, every call twice bitwise equal and one CUDA kernel a
   call; path R's 24 calls of a step timed in L2 and out of it beside ATen's
   reductions, with the host's time a call and the replay floor of an empty
   kernel) and
   the 3x3x3 conv with BN statistics (``conv3d_bn_stats``, both routes: the
   bfloat16 tensor-core kernel and the float32 CUDA-core kernel; its sums
   also against float64 sums of its own output, at three grid sizes); the
   number of ``HGMMA`` / ``UTMALDG`` instructions in the conv library's SASS;
4. paths, each through ``train()`` at full width, depth and clip size on
   synthetic frames at batch 8, with every kernel's launch count set to 0
   just before and read just after:
   - preset ``paper_table1_k400`` (SimCLR TimeSeriesV4, mode ``clip-sr-tc``);
     then one step of it with ``fused_compute='bfloat16'`` set on the
     ``AugConfig`` (``aug_fused`` once, through its bfloat16 route);
   - path M: preset ``paper_table2_moco_r21d`` in mode ``clip-sr-dtw`` (MoCo
     TimeSeriesV4, K=16384: soft-DTW of every query against the whole
     queue), with checks of the queues, the pointer and the key encoder;
   - path M16: path M with ``n_series=16`` (pairs of 16x16), the same
     counts and checks;
   - path S: ``paper_table1_k400`` in mode ``clip-sr-dtw``;
   - path R: ``paper_table1_k400`` with ``--net r3d --model simclr_naked``
     (SimCLR NT-Xent on R3D-18) with ``DUALVAR_BN_STATS=pallas`` (every batch
     norm's sums through ``channel_sums``), and without it; then
     ``conv3d_bn_stats`` on the input of path R's ``layer1_block0.conv2``
     against that layer's output and the batch statistics its ``bn2`` used;
   - the presets ``smoke``, ``smoke_dualvar`` and ``smoke_moco``, one step;
   - path C: the downstream classifier, preset ``paper_table1_ucf_ft``
     (R(2+1)D-18, 101 classes, B=4) grafted from the main path's
     checkpoint: the graft's report, a finetune run with validation, a
     linear-probe run (backbone bitwise unchanged), one pass of each test
     protocol (center, five and ten crop, temporal ten-clip, retrieval)
     from the finetuned checkpoint; ``aug_fused`` with blur off at N=4 and
     N=32 against its plain version and timed out of L2;
   - path P, the paper's experiment chains: each chain of
     ``scripts/paper_torch/`` (``paper_table1_k400``,
     ``paper_table2_moco_r21d``, ``paper_table2_re_simclr_r21d``) recorded
     from its ``run.sh`` with ``DATA_ROOT``, ``DB_PATH`` and ``EXP_NAME``
     unset and replayed in this process (``tools/paper_chain.py``) with
     ``--synthetic 1 --epochs 1 --max_steps 2 --print_freq 1``: the
     pretrain's losses and checkpoint, each finetune's graft of that
     checkpoint (bitwise), each temporal ten-clip test run on the state its
     finetune saved (bitwise), retrieval's dumps and R@k, ``aug_fused``
     once a train step and no other kernel; each stage's wall time;
   - path G: preset ``s3dg_k400`` (SimCLR TimeSeriesV4 on S3D-G), two
     epochs of three steps saved through the checkpoint store, then
     ``--resume auto`` for a third: the state restored on the card against
     the saved file (model, optimizer, scheduler, generator, iteration),
     what the store keeps under ``keep_all``; one more run with
     ``DUALVAR_BN_STATS=pallas`` (``channel_sums`` 308 a step);
   - path M resumed: path M for one epoch, saved, resumed for a second
     (queues, pointer and key encoder restored bitwise);
   - the backbone steps: ``paper_table1_k400 --net s3d / c3d / r2d3d18 /
     r50``, two steps each;
   - path D, data parallel (the card is one, so a group of one over NCCL):
     the batch norm's routes under the group at path R's first-block shape,
     float32 and bf16 (the one-pass route bitwise as without a group,
     ``_SyncBN`` and ATen's batch norm against float64); ``python -m
     torch.distributed.run --standalone --nproc_per_node 1`` of the pretrain
     CLI (``paper_table1_k400``, B=8, 3 steps, ``DUALVAR_BN_STATS=pallas``),
     which must exit 0 and end bitwise as the same steps in this process
     without a group; then this process joins a group of one itself
     (torchrun's variables, ``init_distributed``) for path R under the
     variable (``channel_sums`` 24 a step, running statistics bitwise as
     without a group) and one MoCo epoch in mode clip-sr-dtw (pointer B a
     step, soft-DTW twice a step); the step time of ``paper_table1_k400`` at
     B=8 (five windows) and 32 (three) without and with the group, with
     the collectives a step by kind; one MoCo epoch with
     ``--moco_shuffle_bn 2`` in a group of one (the distributed BN-shuffle
     route) bitwise as the same epoch without a group, and its collectives
     a step;
   - path V, the backbone registry's variants: ``paper_table1_k400 --net
     r21d_pad128 / r21d_tiled / s3d_packed / s3dg_packed``, two steps each
     and the step time at B=8; r21d_pad128 also two steps under
     ``DUALVAR_BN_STATS=pallas``, and after both runs every pad block (the
     weights', the batch-norm biases' and running means', the momentum
     buffers') bitwise zero; the main path's r21d state embedded into
     r21d_pad128, one float32 step against r21d's on the same frames; path
     G's S3D-G packed into s3dg_packed, its eval forward against the
     standard one;
   - path E, the serving export: path C's finetuned checkpoint through
     ``python -m dualvar_tpu_torch.export`` (its ``main``) at B=8, single
     clip and ten clips, both artifacts run in a fresh process that imports
     torch only, against the eager eval path on the same frames (no kernel
     launched); the export's time, the artifact's bytes, the served and the
     eager ms a batch;
   - path J, the real-data path: a frame tree in the reference layout
     (``{class}/{video}/image_%05d.jpg``, 26 videos of 72 frames at
     UCF101's extracted 320x240, JPEG quality 80) written with PIL from a
     seed, its split CSV from the port's ``write_csv``, then
     ``paper_table1_k400`` trained from the files at B=8 (3 steps,
     ``aug_fused`` 3) through the native batch assembler where ``g++`` and
     libjpeg build the decoder, else through PIL; one epoch with
     ``--fast_decode 1`` (refused without the native decoder, as it must
     be); the native batch against the per-sample route bitwise and the
     native decode against PIL's where it was built; decode ms a batch by
     route; the ``Data`` wait a step and the step's wall ms of train()'s
     loop on the files against the same preset on synthetic frames;
   - path F, the unfused augmentation and the training options:
     ``paper_table1_k400`` at B=8 with ``--aug_temp_consist 0``, with
     ``aug_temp_grad_consist`` (set in the config: neither package's parser
     has the flag) and with ``--fused_aug off``, 2 steps each with no
     ``aug_fused`` launch; the unfused batch at B=8 card against CPU on the
     same decisions in each jitter mode, against the kernel in the
     clip-consistent one, and timed against it; 2 steps with ``--optim
     adam`` and 2 classifier steps (``paper_table1_ucf_ft``) with ``--optim
     adam --remat`` (Adam state in the checkpoint); one main-path step at
     B=32 under ``DUALVAR_BN_STATS=pallas`` with and without ``--remat``
     (running statistics and losses bitwise, ``channel_sums`` 96 each), and
     the B=32 step time and peak memory with and without it;
   - what the main path's run writes besides its checkpoint: the profiler
     trace of ``--profile_steps 2`` (it must name the ``aug_fused``
     kernel, once a traced step) and the metrics writer's
     ``metrics.jsonl``; ``get_features`` of SimCLR TimeSeriesV4 and of
     MoCo on the card against the CPU;
   - learning: ``dualvar_tpu_torch/tools/learning_check.py``'s four checks
     (SimCLR naked and TimeSeriesV4 300 steps at B=16 on the synthetic
     videos, the classifier 360 steps, SimCLR naked 160 steps from a JPEG
     tree written from a seed), each below its chance plateau by its
     margin (above 0.6 top-1 for the classifier), the loss every 20
     steps;
   - path K, the soaks (``tools/soak.py``, ``tools/moco_soak.py``): the
     R3D-18 SimCLR step at B=128 for ``SOAK_MINUTES`` and the
     ``paper_table2_moco_r21d`` step (MoCo-TSV4, R(2+1)D-18, K=16384) at
     B=32 for ``MOCO_SOAK_MINUTES``, at least one wrap of the queue: every
     chain's loss finite, the async store's mid-run checkpoint restored
     twice and replayed 3 steps bitwise as each other and as the live
     steps after the save (deterministic cuDNN), the queue pointer, the
     queue rows' norms within 1e-3, the key encoder finite, ``aug_fused``
     once a step and no other kernel; both records, clips/s by chain, the
     save's cost and the device memory;
   - path B, the benches (``tools/bench.py``, ``tools/objective_bench.py``,
     ``tools/backbone_bench.py``, ``tools/eval_bench.py``,
     ``tools/step_breakdown.py``, ``tools/perf_breakdown.py``), each
     tool's function at 16x112x112 from 171x128 frames, bf16: the R3D-18
     SimCLR unit at B=128 (2 chains of 10 steps), all 8 objective units,
     all 9 backbones and all 7 eval nets at the largest batch that fits
     (one chain of 5 steps), the breakdown's segments (5 steps each):
     every record's losses finite, its chains positive, ``step_tflops``
     and ``mfu_pct`` on every train record, ``aug_fused`` once a train
     step (none in eval) and no other kernel; every record with its
     launches;
   then step times at B=8 and B=32 (MoCo in ``clip-sr-tc`` and
   ``clip-sr-dtw``, at n_series 2 and 16: the difference is what soft-DTW
   and its cost tensor take), of path R at B=8, 32 and 128 with the
   variable on and off, of the classifier's finetune step at B=4 (the
   median of five 20-step windows, with each window's time) and 32, of
   path G at B=8 (five windows, with ATen's batch norm and under
   ``DUALVAR_BN_STATS=pallas``) and 32, and of each backbone step at B=8;
5. on-card float32 checks: one train-mode forward with TF32 off against the
   same forward on the CPU from the same weights and block, for the SimCLR
   model, for MoCo in mode ``clip-sr-dtw`` (where the CPU side runs the
   plain soft-DTW, so the kernels are also held against it inside the model)
   for path R and path G with the variable on (the CPU side takes the plain
   sums; the card's forward must launch ``channel_sums`` once a batch norm
   a backbone pass), for the finetuned classifier, and for path G and each
   backbone step with the backbone's features compared too (card against
   CPU, and the CPU's float32 against its float64, at a fixed tolerance a
   family); and ``channel_sums`` on every batch norm's own maps of one
   path-G step (308 calls), against float64 sums, timed together in L2 and
   out of it with a breakdown by call size; then one ``channel_sums`` call
   in a ``torch.profiler`` trace.

``python3 chip_smoke.py --bench-only`` builds the kernels and runs path B
alone (no contract line at the end).

The last lines of standard output are the script's wall time, one JSON
object describing every kernel (``{"kernels": [...]}``), the card's name and
power limit, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device the script fails; it never carries on on the CPU. It
imports nothing of JAX. Logs and checkpoints of the run go under ``build/``
beside this file and are removed at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

from dualvar_tpu_torch.tools.timing import BF16_FLOPS_PER_S, HBM_BYTES_PER_S

# published H100 SXM peak (NVIDIA data sheet, dense), beside the memory
# rate and the bf16 peak of tools/timing.py
F32_FLOPS_PER_S = 67e12
# special functions (exp2, log2, reciprocal): 16 results a clock an SM
# (Hopper white paper), 132 SMs at the 1.98 GHz boost clock that the float32
# peak above also assumes
SPECIAL_OPS_PER_S = 16 * 132 * 1.98e9

TRAIN_STEPS = 4
PATH_S_STEPS = 2
MOCO_PRESET = "paper_table2_moco_r21d"
# path G: --preset s3dg_k400 (SimCLR TimeSeriesV4 on S3D-G), epochs of
# PATH_G_VIDEOS // 8 steps at B=8, then one more epoch through --resume
PATH_G_PRESET = "s3dg_k400"
PATH_G_VIDEOS = 24
# S3D-G's batch norms: Conv_1a 2, Conv_2b 1, Conv_2c 2, nine Mixed blocks
# of 8; the unpacked TimeSeriesV4 step runs the backbone twice (the 3B
# views, then the B shuffled clips), each batch norm one forward and one
# backward channel_sums call a pass
S3DG_BATCH_NORMS = 77
S3DG_SUMS_PER_STEP = 2 * 2 * S3DG_BATCH_NORMS
# the backbone steps: paper_table1_k400 --net <x>, 2 steps at B=8
BACKBONE_STEP_NETS = ("s3d", "c3d", "r2d3d18", "r50")
# float32 backbone features inside check_f32_forward (TF32 off), card
# against CPU and the CPU's float32 against its float64: the JAX suite's
# band for a backbone forward against its torch oracle (ROADMAP.md), for
# every family but R2D3D-50. Its float32 forward at B=2 lies 7.2e-4 to
# 7.6e-4 from its own float64 on the CPU through 53 batch norms, and the
# card 8.0e-4 to 9.8e-4 from the CPU (H100 readings in PERF.md): a fixed
# 1.5e-3 for it.
FEATURE_F32_ATOL = 2e-4
FEATURE_F32_ATOL_BY_NET = {"r50": 1.5e-3}
# path C: the downstream classifier, finetuned and probed from the main
# path's checkpoint
CLASSIFIER_PRESET = "paper_table1_ucf_ft"
PROBE_STEPS = 2
CLASSIFIER_METRICS = ("loss", "top1", "val_top1")
# float32 classifier forward, card against CPU (TF32 off): the JAX suite's
# band for a backbone forward against its torch oracle (ROADMAP.md)
CLF_F32_ATOL = 2e-4
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
# channel_sums cases beyond path R's maps: (shape, dtype, layout, offsets
# of a and b in elements from a 16-byte boundary). Path G's widths 16 and
# 384 at its shapes (S3D-G at B=8: 24 clips, then 8), its runs of 196, a
# run of 98, a map smaller than one block's batch, one channel,
# channels-last rows over many blocks, and data off a 16-byte boundary
# (both alike: 16-byte chunks; unlike: one element a load)
SUMS_CASES = (
    ((24, 16, 2, 28, 28), "bfloat16", "ncdhw", (0, 0)),
    ((8, 384, 2, 3, 3), "bfloat16", "ncdhw", (0, 0)),
    ((24, 320, 4, 7, 7), "bfloat16", "ncdhw", (0, 0)),
    ((16, 40, 2, 7, 7), "bfloat16", "ncdhw", (0, 0)),
    ((2, 8, 1, 3, 5), "bfloat16", "ncdhw", (0, 0)),
    ((4, 1, 16, 56, 56), "bfloat16", "ncdhw", (0, 0)),
    ((4, 1, 3, 5, 7), "float32", "ncdhw", (1, 1)),
    ((8, 32, 8, 28, 28), "bfloat16", "channels_last_3d", (0, 0)),
    ((16, 512, 2, 7, 7), "bfloat16", "ncdhw", (3, 3)),
    ((16, 64, 4, 28, 28), "bfloat16", "ncdhw", (5, 5)),
    ((3, 24, 7, 11, 13), "float32", "ncdhw", (1, 1)),
    ((16, 64, 4, 14, 14), "bfloat16", "ncdhw", (2, 5)),
    ((3, 24, 7, 11, 13), "bfloat16", "channels_last_3d", (2, 2)),
)
# the breakdown's copies of one small call: at most this many a replay
SUMS_MAX_COPIES = 4096
# byte sizes of the breakdown's buckets (a call's inputs and outputs)
SUMS_BUCKETS = (64 << 10, 1 << 20, 8 << 20)
# an empty kernel: the replay floor of one launch from a CUDA graph
LAUNCH_FLOOR_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""
# conv3d_bn_stats: y against a float32 convolution of the same bf16 inputs
# is within half a bfloat16 ulp (2**-8 of |y|) plus float32 sum order;
# against another bf16 result (cuDNN's) within one ulp (2**-7 of |y|)
CONV_HALF_ULP, CONV_ULP, CONV_ATOL = 2.0 ** -8, 2.0 ** -7, 1e-4
# its s1, s2 against float64 sums of its own y: float32 partial sums only
CONV_SUMS_RTOL = 1e-5
# one bfloat16 ulp at the top of the normalised range (|x| < 4 -> 2**-6):
# kernel and plain round the same float32 value up to 2e-5 apart
BF16_ATOL = 2.0 ** -6
# aug_fused's bfloat16 compute route against its plain version, in bfloat16
# ulps of the output. The kernel evaluates every op as the plain version
# does on the card, so the two differ only where the contrast mean's
# float32 sum (another order: one rounding of the frame's mean, then a
# frame's pixels) or the blur taps' sum moves a rounding. Such a flip is
# one ulp of a plane value (2**-8 at most), which the later ops can carry
# up to contrast 1.8 x saturation 1.8 x hue's slope 6 x normalise 4.47
# (0.34) before the final rounding: at most 16 ulps at the top of the
# normalised range (2**-6 each). Elements more than one ulp of their own
# magnitude apart: at most 1e-3 of them (each is printed as a count).
BF16C_BEYOND_SHARE = 1e-3
BF16C_MAX_ULPS = 16


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


def tf32_off(torch):
    """Turn TF32 off for convolutions and matmuls; returns the old flags
    for ``tf32_restore``."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return old


def tf32_restore(torch, old) -> None:
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        old


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
    # record at B=32 -> N=96; ms in L2 (the same tensors replayed), cold_ms
    # out of it
    entry = {}
    for n in (24, 96):
        clips, orders, factors, blur = aug_inputs(torch, n, 16, 112, 2, device)
        bound, bound_by = aug_bound_ms(torch, clips, blur, torch.float32)
        # the kernel's device time (10 launches replayed from a CUDA graph:
        # an eager launch costs the host about as long as the kernel runs),
        # one eager launch, and one eager call of the wrapper (which also
        # checks the orders on the host)
        ms = time_cuda_graph(torch, lambda: mod._launch(
            clips, orders, factors, blur, torch.float32, True), 10)
        eager_ms = time_cuda(torch, lambda: mod._launch(
            clips, orders, factors, blur, torch.float32, True), 30)
        wrapper_ms = time_cuda(torch, lambda: mod.aug_fused(
            clips, orders, factors, blur), 30)
        plain_ms = time_cuda(torch, lambda: mod.aug_fused_plain(
            clips, orders, factors, blur), 5, warmup=1)
        # out of L2: copies of the inputs that hold four L2s, launched in
        # turn, each launch keeping its own output
        copies = cold_copies(torch, clips.numel() * (1 + 4))
        sets = [(clips.clone(), orders.clone(), factors.clone(),
                 blur.clone()) for _ in range(copies)]
        outs = []

        def launch(c):
            outs.append(mod._launch(*sets[c], torch.float32, True))

        cold_ms = time_cuda_graph_cold(torch, launch, copies)
        del sets, outs
        row = {"ms": ms, "cold_ms": cold_ms, "eager_ms": eager_ms,
               "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "cold_bound_share": bound / cold_ms}
        print(f"kernels: aug_fused timing N={n} T=16 S=112 f32: "
              + json.dumps(row), flush=True)
        if n == 24:
            entry = row
            # where the kernel's time goes: the same shape with every clip
            # blurred and with none
            for name, on in (("all", 1.0), ("none", 0.0)):
                b = blur.clone()
                b[:, 1] = on
                ms_b = time_cuda_graph(torch, lambda: mod._launch(
                    clips, orders, factors, b, torch.float32, True), 10)
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


def bf16_ulp(torch, x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    mag = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16c_errors(torch, got, want) -> dict:
    """The bfloat16 route's kernel output against its plain version: the
    largest error in ulps at the top of the normalised range, the elements
    more than one ulp of their own magnitude apart, the bitwise share."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    beyond = int((err > bf16_ulp(torch, want)).sum())
    return {"max_abs_err": float(err.max()),
            "max_ulps": float(err.max()) / BF16_ATOL,
            "beyond_1ulp": beyond, "elements": err.numel(),
            "beyond_share": beyond / err.numel(),
            "bitwise_share": float((err == 0).float().mean())}


def aug_ptxas(name: str = "aug_fused") -> list[dict]:
    """ptxas's registers, stack and spills of every ``aug_band_kernel``
    instantiation, named by its template arguments."""
    import re

    rows = ptxas_report(name)
    for row in rows:
        m = re.search(r"aug_band_kernelI(f|13__nv_bfloat16)Lb([01])ELb([01])E",
                      row["kernel"])
        if m:
            row["kernel"] = (
                f"aug_band_kernel<out={'f32' if m.group(1) == 'f' else 'bf16'}"
                f", vec={m.group(2)}, compute_bf16={m.group(3)}>")
    return rows


def check_aug_bf16_compute(torch, device) -> dict:
    """The bfloat16 compute route of ``aug_fused`` against its plain version
    (``aug_fused_plain_bf16``) on the card: the main path's N=24 (B=8 x 3
    views, 16x112x112) with blur on every other clip, on all and on none,
    float32 and bfloat16 out; path C's N=4 and N=32 with blur off. Then
    timed at N=24 (float32 out), in L2 and out of it, beside the float32
    route timed the same way in the same run and the same bytes bound; and
    ptxas's report of the new instantiations."""
    from dualvar_tpu_torch.aug.pipeline import _crop_planar
    from dualvar_tpu_torch.ops import aug_fused as mod

    cases = []
    args = aug_inputs(torch, 24, 16, 112, 0, device)
    for blurred, on in (("every other clip", None), ("all", 1.0),
                        ("none", 0.0)):
        blur = args[3].clone()
        if on is not None:
            blur[:, 1] = on
        cases.append((f"N=24 blur {blurred}", args[:3] + (blur,)))
    for n in (4, 32):
        frames, crops, flips, orders, factors = classifier_aug_inputs(
            torch, n, 20 + n, device)
        planar = _crop_planar(frames, crops, 16, 112, flips=flips)
        blur = torch.tensor([[1.0, 0.0]], device=device).repeat(n, 1)
        cases.append((f"N={n} (path C) blur none",
                      (planar, orders, factors, blur)))
    worst, rows = {}, {}
    for label, case in cases:
        for out_dtype in (torch.float32, torch.bfloat16):
            got = mod.aug_fused(*case, out_dtype=out_dtype,
                                compute_dtype=torch.bfloat16)
            want = mod.aug_fused_plain(*case, out_dtype=out_dtype,
                                       compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            if got.dtype != out_dtype:
                fail(f"aug_fused bf16 compute {label}: {got.dtype} out")
            errs = bf16c_errors(torch, got, want)
            key = f"{label}, {str(out_dtype).split('.')[-1]} out"
            rows[key] = errs
            print(f"kernels: aug_fused bf16 compute {key}: "
                  + json.dumps(errs), flush=True)
            if not (errs["max_ulps"] <= BF16C_MAX_ULPS
                    and errs["beyond_share"] <= BF16C_BEYOND_SHARE):
                fail(f"aug_fused bf16 compute {key}: {errs} beyond "
                     f"{BF16C_MAX_ULPS} ulps or a share "
                     f"{BF16C_BEYOND_SHARE} beyond one ulp")
            if errs["max_abs_err"] >= worst.get("max_abs_err", -1.0):
                worst = dict(errs, case=key)
    # timing at the main path's launch: N=24, float32 out
    clips, orders, factors, blur = aug_inputs(torch, 24, 16, 112, 2, device)
    bound, bound_by = aug_bound_ms(torch, clips, blur, torch.float32)
    copies = cold_copies(torch, clips.numel() * (1 + 4))
    sets = [(clips.clone(), orders.clone(), factors.clone(), blur.clone())
            for _ in range(copies)]
    times = {}
    for compute in (torch.bfloat16, torch.float32):
        outs = []

        def launch(c):
            outs.append(mod._launch(*sets[c], torch.float32, True, compute))

        name = str(compute).split(".")[-1]
        times[f"{name}_cold_ms"] = time_cuda_graph_cold(torch, launch,
                                                        copies)
        outs.clear()
        times[f"{name}_ms"] = time_cuda_graph(torch, lambda: mod._launch(
            clips, orders, factors, blur, torch.float32, True, compute), 10)
    del sets
    plain_ms = time_cuda(torch, lambda: mod.aug_fused_plain(
        clips, orders, factors, blur, compute_dtype=torch.bfloat16), 5,
        warmup=1)
    ptxas = [r for r in aug_ptxas() if "compute_bf16=1" in r["kernel"]]
    print("build: ptxas aug_fused, bf16 compute route: " + json.dumps(ptxas),
          flush=True)
    entry = {
        "name": "aug_fused_bf16", "route": "cuda",
        "source": "dualvar_tpu_torch/csrc/aug_fused.cu",
        "replaces": "dualvar_tpu/ops/aug_fused.py:153",
        "launches": 0, "max_abs_err": worst["max_abs_err"],
        "ms": times["bfloat16_ms"], "cold_ms": times["bfloat16_cold_ms"],
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "cold_bound_share": bound / times["bfloat16_cold_ms"],
        "f32_route_ms": times["float32_ms"],
        "f32_route_cold_ms": times["float32_cold_ms"],
        "worst_case": worst, "cases": rows, "ptxas": ptxas,
        # no single PyTorch call computes this chain
        "library_ms": None}
    print("kernels: aug_fused bf16 compute timing N=24 T=16 S=112, f32 out: "
          + json.dumps({k: v for k, v in entry.items()
                        if k.endswith("ms") or k == "cold_bound_share"}),
          flush=True)
    torch.cuda.empty_cache()
    return entry


def aug_plain_f64(torch, clips, orders, factors, blur):
    """``aug_fused_plain``'s chain in float64 (the blur's taps float32, as
    ``gaussian_blur`` makes them): the reference the float32 route's
    kernel and plain version are both held against in
    ``diagnose_aug_f32_margin``."""
    from dualvar_tpu_torch.aug import functional as F

    x = clips.permute(0, 2, 3, 4, 1).double() / 255.0
    f = factors.double()
    ops = (F.adjust_brightness, F.adjust_contrast, F.adjust_saturation,
           F.adjust_hue)
    for i in range(x.shape[0]):
        sub = x[i:i + 1]
        for op in orders[i].tolist():
            sub = ops[op](sub, f[i, op])
        x[i:i + 1] = sub
    x = F.gaussian_blur(x, blur[:, 0], taps=13, on=blur[:, 1] > 0)
    return F.normalize(x).permute(0, 4, 1, 2, 3)


def diagnose_aug_f32_margin(torch, device) -> dict:
    """Where the float32 route's error against its plain version comes from
    (ROADMAP C.6): on ``check_aug_kernel``'s N=24 input, the largest error
    with only one op away from its identity factor (the others at identity:
    brightness, contrast and saturation exact, hue's round trip still run),
    with none, and with all; for the whole chain's five largest errors the
    clip's order and factors, the blur, and both sides' distance from a
    float64 chain. Printed only."""
    from dualvar_tpu_torch.ops import aug_fused as mod

    clips, orders, factors, blur = aug_inputs(torch, 24, 16, 112, 0, device)
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0], device=device)
    variants = {"none": (ident.expand(24, 4).contiguous(), 0.0)}
    for k, name in enumerate(("brightness", "contrast", "saturation",
                              "hue")):
        f = ident.expand(24, 4).clone()
        f[:, k] = factors[:, k]
        variants[name] = (f, 0.0)
    variants["blur"] = (ident.expand(24, 4).contiguous(), None)
    variants["all"] = (factors, None)
    out = {}
    for name, (f, on) in variants.items():
        b = blur.clone()
        if on is not None:
            b[:, 1] = on
        got = mod.aug_fused(clips, orders, f, b)
        want = mod.aug_fused_plain(clips, orders, f, b)
        err = (got - want).abs()
        out[name] = {"max_abs_err": float(err.max()),
                     "elements_over_5e-6": int((err > 5e-6).sum())}
        if name == "all":
            ref = aug_plain_f64(torch, clips, orders, f, b)
            top = torch.topk(err.flatten(), 5).indices
            worst = []
            for i in top.tolist():
                idx = list(torch.unravel_index(torch.tensor(i), err.shape))
                n, c, t, y, x = (int(v) for v in idx)
                worst.append({
                    "clip": n, "channel": c, "t": t, "y": y, "x": x,
                    "order": orders[n].tolist(),
                    "factors": [round(v, 4) for v in factors[n].tolist()],
                    "blur_on": bool(b[n, 1] > 0),
                    "kernel_minus_plain": float(got[n, c, t, y, x]
                                                - want[n, c, t, y, x]),
                    "kernel_minus_f64": float(got[n, c, t, y, x].double()
                                              - ref[n, c, t, y, x]),
                    "plain_minus_f64": float(want[n, c, t, y, x].double()
                                             - ref[n, c, t, y, x]),
                    "value": float(want[n, c, t, y, x])})
            out["all"]["worst"] = worst
            out["all"]["kernel_max_vs_f64"] = float(
                (got.double() - ref).abs().max())
            out["all"]["plain_max_vs_f64"] = float(
                (want.double() - ref).abs().max())
    print("kernels: aug_fused float32 route, where its error against the "
          "plain version comes from (C.6): " + json.dumps(out), flush=True)
    return out


def dtw_bytes(P: int, N: int, M: int, backward: bool) -> int:
    """Bytes one soft-DTW pass must move: forward D read, R and the values
    written (8 a cell, 4 a pair); backward D, R, g read and dD written (12 a
    cell, 4 a pair)."""
    return 4 * ((3 if backward else 2) * P * N * M + P)


def dtw_bound_parts(P: int, N: int, M: int,
                    backward: bool) -> dict[str, float]:
    """Three floors, in ms, for one soft-DTW pass. Bytes: ``dtw_bytes``.
    Float32 operations a cell: forward 3 multiplications by 1/gamma, 3 exp,
    1 log and 11 add / multiply / max; backward 3 exp, 6 subtractions, 3
    multiplications and 3 multiply-adds (counted as 2) - 18 either way.
    Special functions a cell, on their own units at 16 a clock an SM:
    forward 3 exp + 1 log, backward 3 exp."""
    cells = P * N * M
    return {"bytes_ms": dtw_bytes(P, N, M, backward) / HBM_BYTES_PER_S * 1e3,
            "f32_ms": 18 * cells / F32_FLOPS_PER_S * 1e3,
            "special_ms": (3 if backward else 4) * cells
            / SPECIAL_OPS_PER_S * 1e3}


def dtw_bound_ms(P: int, N: int, M: int, backward: bool) -> tuple[float, str]:
    """The least time the card could take for one soft-DTW pass: the larger
    of the bytes floor and the operations floor, the latter the larger of the
    float32 and the special-function floors (``dtw_bound_parts``). Bytes
    bind at every shape the models give: at 16x16 the forward's 2.4 ps a
    cell of bytes against 1.0 ps of special functions, the backward's 3.6
    against 0.7."""
    parts = dtw_bound_parts(P, N, M, backward)
    t_ops = max(parts["f32_ms"], parts["special_ms"])
    t_bytes = parts["bytes_ms"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# soft-DTW correctness cases (P, N, M, gamma, band, offset): path M at B=8
# and path M16's query-key call (B pairs of 16x16); the largest size without
# and with a band; non-square with P not a multiple of a warp's 32 pairs;
# then the rows route's edges: one row, one column (bucket 2), a band
# narrower than the length gap, each square bucket, 8-byte copies (M = 6), a
# single pair, a ragged P at 16x16, and 2x2 at addresses 4 and 8 bytes past
# a 16-byte boundary (the rows route with 4- and 8-byte copies). Every
# DTW_TIMED shape is checked too, on the inputs it is timed on.
DTW_CASES = ((131080, 2, 2, 0.1, 0.0, 0), (8, 16, 16, 0.1, 0.0, 0),
             (4096, 16, 16, 0.1, 0.0, 0), (4096, 16, 16, 0.1, 3.0, 0),
             (1000, 5, 7, 1.0, 0.0, 0), (777, 1, 16, 0.1, 0.0, 0),
             (777, 16, 1, 0.1, 0.0, 0), (777, 3, 16, 0.1, 2.0, 0),
             (4099, 4, 4, 0.1, 0.0, 0), (4099, 8, 8, 0.1, 0.0, 0),
             (777, 6, 6, 0.1, 0.0, 0), (1, 16, 16, 0.1, 0.0, 0),
             (1, 2, 2, 0.1, 0.0, 0), (129, 16, 16, 0.1, 0.0, 0),
             (4099, 2, 2, 0.1, 0.0, 1), (4099, 2, 2, 0.1, 0.0, 2))
# soft-DTW timing shapes: path M at B=8 and B=32 (K=16384, 2x2), the middle
# buckets, path M16 (n_series 16) at B=8 and B=32
DTW_TIMED = (("path M, B=8", (131080, 2, 2)), ("path M, B=32", (524320, 2, 2)),
             ("4x4", (131080, 4, 4)), ("8x8", (131080, 8, 8)),
             ("path M16, B=8", (131080, 16, 16)),
             ("path M16, B=32", (524320, 16, 16)))


def dtw_inputs(torch, P, N, M, seed, device):
    import numpy as np

    rng = np.random.default_rng(seed)
    D = rng.uniform(-1.0, 1.0, (P, N, M)).astype(np.float32)
    g = rng.normal(size=P).astype(np.float32)
    return torch.from_numpy(D).to(device), torch.from_numpy(g).to(device)


def off_boundary(t, floats: int):
    """A copy of ``t``, in its memory layout, whose data starts ``floats``
    elements past a 16-byte boundary (the allocator's blocks start on
    one)."""
    return t.new_empty(t.numel() + floats)[floats:].as_strided(
        t.shape, t.stride()).copy_(t)


def l2_bytes(torch) -> int:
    """The card's L2 size (50 MB on an H100)."""
    return getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                   50 << 20)


def cold_copies(torch, nbytes: int) -> int:
    """How many copies of a launch's ``nbytes`` (inputs and outputs) hold
    at least four times the L2 between them."""
    return max(1, math.ceil(4 * l2_bytes(torch) / nbytes))


def time_cuda_graph_cold(torch, launch, copies: int, iters: int = 20) -> float:
    """Median milliseconds of one ``launch(c)`` when launches on copies c =
    0, 1, ..., copies - 1 of a kernel's inputs and outputs (``cold_copies``:
    four L2s of them) are replayed in turn from a CUDA graph, at least 10: no
    launch finds its data in L2, as a bound by DRAM bytes assumes."""
    reps = copies * math.ceil(10 / copies)
    for c in range(copies):
        launch(c)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(reps):
            launch(k % copies)
    return time_cuda(torch, graph.replay, iters) / reps


def dtw_copies(torch, D, R, g, backward: bool, copies: int,
               offset: int = 0) -> list[tuple]:
    """``copies`` sets of the tensors of one soft-DTW launch: forward (D, R,
    values), backward (D, R, g, dD), with D, R and g copied from the ones
    given and dD, R (forward) and values to be written; D, R and dD start
    ``offset`` floats past a 16-byte boundary."""
    out = []
    for _ in range(copies):
        if backward:
            out.append((off_boundary(D, offset), off_boundary(R, offset),
                        g.clone(), off_boundary(torch.empty_like(D), offset)))
        else:
            out.append((off_boundary(D, offset),
                        off_boundary(torch.empty_like(D), offset),
                        D.new_empty(D.shape[0])))
    return out


def dtw_launcher(mod, args: list[tuple], backward: bool):
    """``launch(c)``: this tree's soft-DTW forward (or backward) kernel,
    gamma 0.1, on ``args[c]`` (``dtw_copies``). Goes to the entry point
    directly: launches made to time a kernel do not count."""
    name = "soft_dtw_bwd_launch" if backward else "soft_dtw_fwd_launch"
    return lambda c: mod._launch(name, args[c], args[c][0].shape, 0.1, 0.0)


def ptxas_report(name: str) -> list[dict]:
    """Registers, stack frame and spills of every kernel in the ptxas log of
    library ``name``, the one ``ops/build.py`` keeps beside it."""
    import re

    from dualvar_tpu_torch.ops.build import ptxas_log_path

    rows, fn = [], None
    with open(ptxas_log_path(name)) as fh:
        for line in fh:
            if m := re.search(r"Compiling entry function '([^']+)'", line):
                fn = {"kernel": m.group(1)}
                rows.append(fn)
            elif fn and (m := re.search(
                    r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads", line)):
                fn.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                          spill_loads=int(m.group(3)))
            elif fn and (m := re.search(r"Used (\d+) registers", line)):
                fn["registers"] = int(m.group(1))
    for row in rows:  # ..._rowsILi16EE... -> soft_dtw_fwd_rows<16>
        m = re.search(r"(soft_dtw_(?:fwd|bwd)_(?:rows|2x2))(?:ILi(\d+)E)?",
                      row["kernel"])
        if m:
            row["kernel"] = m.group(1) + (f"<{m.group(2)}>" if m.group(2)
                                          else "")
    return rows


# kernels of a library that must keep everything in registers: soft-DTW's
# rows route at buckets 2, 4, 8, 16 and its 2x2 route, forward and backward
# (10); channel_sums' planar kernel (float32 and bfloat16; 16-byte chunks
# whole or masked, or one element a chunk; one input or two) and its
# channels-last kernel (both types, 16-byte chunks or one element, one
# input or two) (20)
PTXAS_CLEAN = {"soft_dtw": 10, "bn_stats": 20}


def check_ptxas_clean(name: str) -> list[dict]:
    """Every kernel of library ``name`` (``PTXAS_CLEAN`` of them) has no
    stack frame and no spills in its ptxas log."""
    rows = ptxas_report(name)
    print(f"build: {name} kernels " + json.dumps(rows), flush=True)
    if len(rows) != PTXAS_CLEAN[name] or any(
            row.get("stack", 1) or row.get("spill_stores", 1)
            or row.get("spill_loads", 1) for row in rows):
        fail(f"{name}: not {PTXAS_CLEAN[name]} kernels with 0 bytes of "
             f"stack and spills in the ptxas log: {rows}")
    return rows


def check_dtw_case(torch, mod, D, g, gamma: float, band: float,
                   label: str) -> tuple[float, float]:
    """Both soft-DTW kernels against the plain recurrences on D, g: the
    values and R, dD from the same R, and the differentiable function's
    gradient end to end, each side from its own R. Returns the forward's
    and the backward's largest errors; fails past a tolerance."""
    def max_err(got, want):
        """Largest |got - want| over the finite entries; inf where the two
        disagree on which entries are infinite."""
        finite = torch.isfinite(want)
        if not torch.equal(finite, torch.isfinite(got)) or \
                not torch.equal(got[~finite], want[~finite]):
            return math.inf
        err = (got - want)[finite].abs()
        return float(err.max()) if err.numel() else 0.0

    values, R = mod.soft_dtw_forward(D, gamma, band)
    R_plain = mod._softdtw_R_plain(D, gamma, band)
    dD = mod.soft_dtw_backward(D, R, g, gamma, band)
    dD_plain = mod._softdtw_E_plain(D, R, gamma, band) * g[:, None, None]
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
    print(f"kernels: soft_dtw {label} gamma={gamma} band={band}: values "
          f"{err_v:.3e} R {err_r:.3e} (tolerance {r_tol:.3e}) dD "
          f"{err_g:.3e} (atol {DTW_GRAD_ATOL}, same R) dD end to end "
          f"{err_e2e:.3e} (atol {DTW_GRAD_E2E_ATOL})", flush=True)
    if band and not bool(torch.isinf(R).any()):
        fail("soft_dtw: a banded R holds no +inf")
    if not (err_v <= r_tol and err_r <= r_tol and err_g <= DTW_GRAD_ATOL
            and err_e2e <= DTW_GRAD_E2E_ATOL):
        fail(f"soft_dtw kernels disagree with the plain version at {label} "
             f"band={band}")
    return max(err_v, err_r), err_g


def check_soft_dtw_kernels(torch, device) -> tuple[dict, dict]:
    """Both soft-DTW kernels against the plain recurrences on the card at
    ``DTW_CASES`` (every bucket, both routes, every copy width), the
    refusals, then at each ``DTW_TIMED`` shape first against the plain
    recurrences and then timed beside its bound."""
    from dualvar_tpu_torch.ops import soft_dtw as mod

    worst_fwd = worst_bwd = 0.0
    for P, N, M, gamma, band, offset in DTW_CASES:
        D, g = dtw_inputs(torch, P, N, M, P + N + M, device)
        errs = check_dtw_case(
            torch, mod, off_boundary(D, offset), g, gamma, band,
            f"P={P} N={N} M={M}"
            + (f" {4 * offset} bytes past 16" if offset else ""))
        worst_fwd, worst_bwd = max(worst_fwd, errs[0]), max(worst_bwd, errs[1])

    # the wrapper refuses what the kernels do not take; the entry points run
    # the bucket they are given, and refuse one that does not hold M
    for bad, exc in ((torch.zeros(4, 17, 2, device=device), ValueError),
                     (torch.zeros(4, 2, 2, device=device,
                                  dtype=torch.bfloat16), TypeError)):
        try:
            mod.soft_dtw(bad, 0.1)
        except exc:
            continue
        fail(f"soft_dtw accepted {tuple(bad.shape)} {bad.dtype}")
    D, _ = dtw_inputs(torch, 4, 5, 5, 3, device)
    by_bucket = {}
    for bucket in (2, 4, 3, 32, 8, 16):
        R = torch.empty_like(D)
        values = D.new_empty(4)
        err = mod._kernel("soft_dtw_fwd_launch", 3)(
            D.data_ptr(), R.data_ptr(), values.data_ptr(), 4, 5, 5, 0.1, 0.0,
            bucket, torch.cuda.current_stream().cuda_stream)
        if (err == 0) != (bucket in (8, 16)):
            fail(f"soft_dtw_fwd_launch {'took' if err == 0 else 'refused'} "
                 f"bucket {bucket} for M=5")
        by_bucket[bucket] = R
    torch.cuda.synchronize()
    if not torch.equal(by_bucket[8], by_bucket[16]):
        fail("soft_dtw_fwd_launch: buckets 8 and 16 disagree at M=5")
    empty = mod.soft_dtw(torch.zeros(0, 2, 2, device=device), 0.1)
    if tuple(empty.shape) != (0,):
        fail("soft_dtw on P=0 did not return an empty result")

    # ``ms``: the kernel's device time with its data in DRAM, as the bytes
    # bound assumes (``time_cuda_graph_cold``); ``warm_ms``: the same launch
    # on the same tensors replayed back to back (in L2 where they fit, as D
    # is in the step, written just before); ``wrapper_ms``: one eager call
    # of the wrapper as the model makes it. At 2x2 the rows route is timed
    # beside the 2x2 route in turns (2x2, rows, rows, 2x2), on copies 8
    # bytes past a 16-byte boundary, where the rows route takes them.
    rows = {"soft_dtw_fwd": {}, "soft_dtw_bwd": {}}
    for label, (P, N, M) in DTW_TIMED:
        D, g = dtw_inputs(torch, P, N, M, 7, device)
        errs = check_dtw_case(torch, mod, D, g, 0.1, 0.0,
                              f"{label} ({P},{N},{M}), timed")
        worst_fwd, worst_bwd = max(worst_fwd, errs[0]), max(worst_bwd, errs[1])
        _, R = mod.soft_dtw_forward(D, 0.1, 0.0)
        for name, backward, wrapper, plain in (
                ("soft_dtw_fwd", False,
                 lambda: mod.soft_dtw_forward(D, 0.1, 0.0),
                 lambda: mod._softdtw_R_plain(D, 0.1, 0.0)),
                ("soft_dtw_bwd", True,
                 lambda: mod.soft_dtw_backward(D, R, g, 0.1, 0.0),
                 lambda: mod._softdtw_E_plain(D, R, 0.1, 0.0)
                 * g[:, None, None])):
            copies = cold_copies(torch, dtw_bytes(P, N, M, backward))
            routes = {"ms": 0, "rows_route_ms": 2} if N == M == 2 \
                else {"ms": 0}
            launch = {key: dtw_launcher(mod, dtw_copies(
                          torch, D, R, g, backward, copies, offset), backward)
                      for key, offset in routes.items()}
            runs = {key: [] for key in routes}
            for key in (["ms", "rows_route_ms", "rows_route_ms", "ms"]
                        if len(routes) == 2 else ["ms"]):
                runs[key].append(time_cuda_graph_cold(torch, launch[key],
                                                      copies))
            bound, bound_by = dtw_bound_ms(P, N, M, backward)
            row = {"shape": [P, N, M], "ms": statistics.mean(runs["ms"]),
                   "warm_ms": time_cuda_graph(torch, lambda: launch["ms"](0),
                                              10),
                   "wrapper_ms": time_cuda(torch, wrapper, 30),
                   "plain_ms": time_cuda(torch, plain, 3, warmup=1),
                   "bound_ms": bound, "bound_by": bound_by,
                   **dtw_bound_parts(P, N, M, backward), "copies": copies}
            if len(routes) == 2:
                row["ms_runs"] = runs["ms"]
                row["rows_route_ms_runs"] = runs["rows_route_ms"]
            row["share_of_bound"] = bound / row["ms"]
            rows[name][label] = row
            print(f"kernels: {name} timing, {label}: " + json.dumps(row),
                  flush=True)
            del launch
        del D, g, R
        torch.cuda.empty_cache()
    common = {"route": "cuda",
              "source": "dualvar_tpu_torch/csrc/soft_dtw.cu", "launches": 0,
              # no single PyTorch call computes the recurrence
              "library_ms": None}
    return tuple(
        {"name": name, "replaces": f"dualvar_tpu/ops/soft_dtw.py:{line}",
         "max_abs_err": err, **common, **rows[name]["path M, B=8"],
         # the path that makes the kernels work: n_series 16
         "path_m16": rows[name]["path M16, B=8"], "by_shape": rows[name]}
        for name, line, err in (("soft_dtw_fwd", 186, worst_fwd),
                                ("soft_dtw_bwd", 204, worst_bwd)))


def sums_bound_ms(numel: int, C: int, elem_bytes: int,
                  backward: bool) -> tuple[float, str]:
    """The least time for one channel_sums call: bytes (one or two inputs
    read once, 8*C bytes written) against float32 operations (an add and a
    multiply-add, 3 a value)."""
    n_in = 2 if backward else 1
    t_bytes = (n_in * numel * elem_bytes + 8 * C) / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * numel / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sums_errors(torch, a, b) -> tuple[float, float]:
    """channel_sums(a, b) over dim 1 against float64 sums and against its
    plain version: the largest error relative to the summed magnitudes
    (sum |a|, sum |a*b|), and the largest absolute difference from the
    plain version. Fails unless a second call gives the same bits."""
    from dualvar_tpu_torch.ops import bn_stats as mod

    s1, s2 = mod.channel_sums(a, b, dim=1)
    again = mod.channel_sums(a, b, dim=1)
    p1, p2 = mod.channel_sums_plain(a, b, dim=1)
    a64, b64 = a.double(), b.double()
    dims = (0, 2, 3, 4)
    r1, r2 = a64.sum(dims), (a64 * b64).sum(dims)
    # a channel of zeros (a gradient a ReLU cut everywhere) sums to 0 on
    # every side
    m1 = a64.abs().sum(dims).clamp_min(1e-300)
    m2 = (a64 * b64).abs().sum(dims).clamp_min(1e-300)
    torch.cuda.synchronize()
    if not (torch.equal(s1, again[0]) and torch.equal(s2, again[1])):
        fail(f"channel_sums {tuple(a.shape)} {a.dtype}: two calls on the "
             "same input differ")
    err = max(float(((s1.double() - r1).abs() / m1).max()),
              float(((s2.double() - r2).abs() / m2).max()),
              float(((s1 - p1).double().abs() / m1).max()),
              float(((s2 - p2).double().abs() / m2).max()))
    return err, max(float((s1 - p1).abs().max()),
                    float((s2 - p2).abs().max()))


def sums_case(torch, shape, dtype: str, layout: str, offsets, gen):
    """The calls (x, x) and (g, x) of one ``SUMS_CASES`` entry on the card:
    x of the first and g at the first offset, the second call's x at the
    second."""
    fmt = (torch.channels_last_3d if layout == "channels_last_3d"
           else torch.contiguous_format)
    base = torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5
    other = torch.randn(shape, device="cuda", generator=gen)
    x, g = (t.to(getattr(torch, dtype)).contiguous(memory_format=fmt)
            for t in (base, other))
    xa = off_boundary(x, offsets[0])
    return ((xa, xa),
            (off_boundary(g, offsets[0]), off_boundary(x, offsets[1])))


def graph_kernels(torch, fn) -> int:
    """The kernels one ``fn()`` launches: the kernel nodes of a CUDA graph
    that captures it (the driver's ``cuGraphGetNodes`` and
    ``cuGraphNodeGetType``)."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count))
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                   ctypes.byref(kind)) != 0:
            fail("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels


def check_sums_profiler(torch) -> list[str]:
    """The device kernels of one channel_sums call in a ``torch.profiler``
    trace: exactly one, a channel_sums kernel, or none where the profiler
    records no device event (said, not failed). Run after the paths, so
    the main path's ``--profile_steps`` trace is the process's first."""
    from dualvar_tpu_torch.ops import bn_stats as mod

    from torch.profiler import ProfilerActivity, profile

    x = (torch.randn((24, 64, 8, 28, 28), device="cuda") * 2 + 0.5).to(
        torch.bfloat16)
    mod.channel_sums(x, x, dim=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mod.channel_sums(x, x, dim=1)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    if names and (len(names) != 1 or "channel_sums" not in names[0]):
        fail(f"channel_sums: one call ran {len(names)} device kernels by "
             f"the profiler: {names}")
    print(f"kernels: channel_sums, one call in a torch.profiler trace: "
          f"{len(names)} device kernel(s) {names}"
          + ("" if names else " (the profiler recorded no device event)"),
          flush=True)
    return names


def sums_call_bytes(a, b) -> int:
    """Bytes one channel_sums(a, b) call must move: its inputs read once
    (a alone when b is a), 8*C bytes written."""
    return (1 if b is a else 2) * a.numel() * a.element_size() + 8 * a.shape[1]


def private_calls(calls) -> list[tuple]:
    """``calls`` on tensors of their own: each input cloned in its layout,
    a call with b is a keeping one input."""
    out = []
    for a, b in calls:
        a2 = a.clone()
        out.append((a2, a2 if b is a else b.clone()))
    return out


def time_calls_cold(torch, fn, calls, iters: int = 5) -> float:
    """Milliseconds of ``fn(a, b)`` over ``calls`` in order, each call on
    tensors of its own, with as many copies of the whole list as hold four
    L2s, replayed in turn from a CUDA graph (``time_cuda_graph_cold``): no
    call finds its inputs in L2."""
    copies = cold_copies(torch, sum(sums_call_bytes(a, b) for a, b in calls))
    sets = [private_calls(calls) for _ in range(copies)]

    def launch(c):
        for a, b in sets[c]:
            fn(a, b)

    return time_cuda_graph_cold(torch, launch, copies, iters)


def host_us_per_call(torch, fn, calls, rounds: int = 5) -> float:
    """Host microseconds of one ``fn(a, b)``: the calls run eagerly in
    order with a host clock around them and no synchronise (their device
    time is below their host time, so the launch queue never fills), the
    median of ``rounds``."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for a, b in calls:
            fn(a, b)
        times.append((time.perf_counter() - tic) / len(calls) * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def aten_sums(torch):
    """``fn(a, b)``: ATen's reductions for the same information as
    channel_sums, ``batch_norm_stats`` (b is a) or
    ``batch_norm_backward_reduce`` (a = g, b = x); the library's time."""
    consts = {}

    def fn(a, b):
        C = a.shape[1]
        if C not in consts:
            ones = torch.ones(C, device=a.device)
            consts[C] = (torch.zeros_like(ones), ones)
        zeros, ones = consts[C]
        if b is a:
            torch.batch_norm_stats(a, 1e-5)
        else:
            torch.batch_norm_backward_reduce(a, b, zeros, ones, ones, True,
                                             True, True)

    return fn


def kernel_sums(mod):
    """``fn(a, b)``: ``mod.channel_sums`` over dim 1."""
    return lambda a, b: mod.channel_sums(a, b, dim=1)


def measure_sums(torch, fn, calls, floor=None) -> dict:
    """``fn(a, b)`` over one step's channel-sum ``calls``, against their
    bytes bound:

    - ``ms``: each distinct call (shape, dtype, layout, one or two inputs)
      replayed on the same tensors (``time_cuda_graph``: in L2 where it
      fits), times its count;
    - ``cold_ms``: the calls in order, out of L2 (``time_calls_cold``);
    - ``host_us``: the host's time a call (``host_us_per_call``);
    - ``floor_ms``: an empty kernel replayed from a graph, once a call;
    - ``per_call``: each distinct call's bytes, C, inner, layout, count and
      time out of L2 (copies of it replayed in turn, at most
      ``SUMS_MAX_COPIES``: a call under 50 KB then keeps part of its data in
      L2, ``"l2": true``), beside its bound; ``by_size``: the same summed
      by the bytes of a call."""
    from dualvar_tpu_torch.ops.bn_stats import _view

    groups = {}
    for a, b in calls:
        layout = "ncdhw" if a.is_contiguous() else "channels_last_3d"
        key = (tuple(a.shape), str(a.dtype).replace("torch.", ""), layout,
               b is a)
        groups.setdefault(key, [0, a, b])[0] += 1
    rows = []
    for (shape, dtype, layout, same), (n, a, b) in groups.items():
        nbytes = sums_call_bytes(a, b)
        copies = min(cold_copies(torch, nbytes), SUMS_MAX_COPIES)
        sets = private_calls([(a, b)] * copies)
        hot = time_cuda_graph(torch, lambda: fn(a, b), 20, iters=5)
        cold = time_cuda_graph_cold(torch, lambda c: fn(*sets[c]), copies,
                                    iters=3)
        del sets
        _, C, inner = _view(a, 1)
        bound = sums_bound_ms(a.numel(), C, a.element_size(),
                              backward=not same)[0]
        rows.append({"shape": list(shape), "dtype": dtype, "layout": layout,
                     "inputs": 1 if same else 2, "C": C, "inner": inner,
                     "bytes": nbytes, "calls": n, "hot_us": hot * 1e3,
                     "us": cold * 1e3, "bound_us": bound * 1e3,
                     "share": bound / cold,
                     "l2": copies * nbytes < 4 * l2_bytes(torch)})
    by_size = []
    for lo, hi in zip((0,) + SUMS_BUCKETS, SUMS_BUCKETS + (None,)):
        part = [r for r in rows
                if r["bytes"] >= lo and (hi is None or r["bytes"] < hi)]
        if part:
            us = sum(r["us"] * r["calls"] for r in part)
            bound = sum(r["bound_us"] * r["calls"] for r in part)
            by_size.append({"bytes_from": lo, "bytes_to": hi,
                            "calls": sum(r["calls"] for r in part),
                            "us": us, "bound_us": bound,
                            "share": bound / us})
    out = {"calls": len(calls),
           "ms": sum(r["hot_us"] * r["calls"] for r in rows) / 1e3,
           "cold_ms": time_calls_cold(torch, fn, calls),
           "sum_of_calls_cold_ms": sum(r["us"] * r["calls"]
                                       for r in rows) / 1e3,
           "bound_ms": sum(r["bound_us"] * r["calls"] for r in rows) / 1e3,
           "host_us": host_us_per_call(torch, fn, calls)}
    if floor is not None:
        out["floor_ms"] = time_cuda_graph(torch, floor, len(calls)) \
            * len(calls)
    out["share_cold"] = out["bound_ms"] / out["cold_ms"]
    out["by_size"] = by_size
    out["per_call"] = rows
    return out


def launch_floor_kernel(torch):
    """``fn()``: launch the empty kernel of ``LAUNCH_FLOOR_CU`` on the
    current stream; the source is written under build/ beside this file and
    built as the package's kernels are."""
    import ctypes

    from dualvar_tpu_torch.ops.build import load_library

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "launch_floor", "launch_floor.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(LAUNCH_FLOOR_CU)
    fn = load_library("launch_floor", source=path).empty_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]

    def launch():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            fail("the empty kernel did not launch")

    return launch


def path_r_sum_calls(torch, gen) -> list[tuple]:
    """The 24 channel_sums calls of a B=8 step of path R, bf16 NCDHW as the
    step gives them: three batch norms a map shape (``R3D_MAPS``), each
    with its own x and g, the forward calls (x, x) in layer order, then the
    backward calls (g, x) in reverse."""
    fwd, bwd = [], []
    for shape in R3D_MAPS:
        for _ in range(3):
            x = (torch.randn(shape, device="cuda", generator=gen) * 2
                 + 0.5).to(torch.bfloat16)
            g = torch.randn(shape, device="cuda", generator=gen).to(
                torch.bfloat16)
            fwd.append((x, x))
            bwd.append((g, x))
    return fwd + bwd[::-1]


def check_channel_sums_kernel(torch, device, floor) -> dict:
    """channel_sums against float64 sums and its plain version on the card,
    at path R's map shapes and a ragged one, in NCDHW and channels_last_3d,
    float32 and bfloat16, a = b and a != b, and at ``SUMS_CASES``; each
    case twice, bitwise equal; one CUDA kernel a call (profiler); then
    path R's 24 calls of a B=8 step timed in L2 and out of it
    (``measure_sums``), beside ATen's reductions for the same information
    and the plain version."""
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
                    err, err_abs = sums_errors(torch, a, b)
                    worst = max(worst, err)
                    worst_abs = max(worst_abs, err_abs)
                    if not err <= SUMS_RTOL:
                        fail(f"channel_sums {shape} {dtype} {fmt} "
                             f"a{'=' if b is a else '!='}b: relative error "
                             f"{err} > {SUMS_RTOL}")
    for shape, dtype, layout, offsets in SUMS_CASES:
        for a, b in sums_case(torch, shape, dtype, layout, offsets, gen):
            err, err_abs = sums_errors(torch, a, b)
            worst, worst_abs = max(worst, err), max(worst_abs, err_abs)
            if not err <= SUMS_RTOL:
                fail(f"channel_sums {shape} {dtype} {layout} offsets "
                     f"{offsets} a{'=' if b is a else '!='}b: relative "
                     f"error {err} > {SUMS_RTOL}")
    print(f"kernels: channel_sums vs float64 and plain, {len(R3D_MAPS) + 1} "
          f"shapes x 2 layouts x 2 dtypes x (a=b, a!=b) and "
          f"{len(SUMS_CASES)} more cases x (a=b, a!=b), each twice bitwise "
          f"equal: worst error {worst:.3e} of the summed magnitudes (rtol "
          f"{SUMS_RTOL}); largest absolute difference from the plain version "
          f"{worst_abs:.3e}", flush=True)

    # one kernel a call, counted in a CUDA graph of the call: channels of
    # several blocks combined by the counter (path R's layer 1, backward,
    # 8 blocks; path G's Conv_2b, 8; one channel of 25 blocks), one block a
    # channel (layer 4) and channels-last rows over many blocks; each
    # planar probe's split asserted from the wrapper's plan
    probe_cases = (((16, 64, 16, 56, 56), "ncdhw", 1, 8),
                   ((24, 64, 8, 28, 28), "ncdhw", 0, 8),
                   ((4, 1, 16, 56, 56), "ncdhw", 1, 25),
                   ((16, 512, 2, 7, 7), "ncdhw", 0, 1),
                   ((8, 32, 8, 28, 28), "channels_last_3d", 1, None))
    probes = []
    for shape, layout, k, split in probe_cases:
        a, b = sums_case(torch, shape, "bfloat16", layout, (0, 0), gen)[k]
        if split is not None:
            outer, C, inner = mod._view(a, 1)
            got = mod._plan(outer, C, inner, a.element_size(), 0, True,
                            b is a)[4]
            if got != split:
                fail(f"channel_sums probe {shape}: {got} blocks a channel, "
                     f"not {split}")
        probes.append((a, b))
    per_call = [graph_kernels(torch, lambda: mod.channel_sums(a, b, dim=1))
                for a, b in probes]
    if per_call != [1] * len(probes):
        fail(f"channel_sums: kernels a call {per_call}, not 1 each")
    print(f"kernels: channel_sums, one CUDA kernel a call (kernel nodes of a "
          f"graph of one call: {per_call})", flush=True)
    del probes

    calls = path_r_sum_calls(torch, gen)
    kernel = measure_sums(torch, kernel_sums(mod), calls, floor)
    library = measure_sums(torch, aten_sums(torch), calls)
    plain_ms = 0.0
    for a, b in calls[:len(calls) // 2:3] + calls[len(calls) // 2::3]:
        plain_ms += 3 * time_cuda(
            torch, lambda: mod.channel_sums_plain(a, b, dim=1), 10)
    for row in kernel["per_call"]:
        print("kernels: channel_sums timing, path R " + json.dumps(row),
              flush=True)
    totals = {"ms": kernel["ms"], "cold_ms": kernel["cold_ms"],
              "plain_ms": plain_ms, "library_ms": library["ms"],
              "library_cold_ms": library["cold_ms"],
              "bound_ms": kernel["bound_ms"], "host_us": kernel["host_us"],
              "floor_ms": kernel["floor_ms"]}
    print("kernels: channel_sums, a B=8 step of path R (12 forward + 12 "
          "backward calls; ms in L2, cold_ms out of it): "
          + json.dumps(totals), flush=True)
    del calls
    torch.cuda.empty_cache()
    return {"name": "channel_sums", "route": "cuda",
            "source": "dualvar_tpu_torch/csrc/bn_stats.cu",
            "replaces": "dualvar_tpu/ops/bn_stats.py:63", "launches": 0,
            "max_abs_err": worst_abs, "max_rel_err": worst,
            "rel_err_is_relative_to": "sum of magnitudes",
            "shape": "path R, B=8: the 12 forward and 12 backward calls of "
                     "one step",
            **totals, "bound_by": "bytes",
            "kernels_a_call": per_call,
            # set at the end of the run (check_sums_profiler)
            "profiler_kernels_a_call": None,
            # ATen's batch_norm_stats (forward) and
            # batch_norm_backward_reduce (backward) on the same maps
            "library": "torch.batch_norm_stats + "
                       "torch.batch_norm_backward_reduce",
            # the per-call rows are printed above, not carried here
            "by_size": kernel["by_size"]}


def conv_bound_ms(N, T, H, W, C, Co, elem_bytes) -> tuple[float, str]:
    """The least time for one 3x3x3 conv with statistics: 2*27*C*Co
    operations an output position, at the bf16 tensor-core rate for bf16
    inputs and the float32 rate of the CUDA cores for float32 ones, against
    x, w and y moved once."""
    flops = 2 * N * T * H * W * 27 * C * Co
    bytes_moved = (N * T * H * W * (C + Co) + 27 * C * Co) * elem_bytes
    rate = BF16_FLOPS_PER_S if elem_bytes == 2 else F32_FLOPS_PER_S
    t_ops = flops / rate * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sass_counts(lib_path: str) -> dict:
    """How many HGMMA (wgmma) and UTMALDG (TMA load) instructions the
    library's SASS holds, from ``cuobjdump -sass``; None where the toolkit
    has no cuobjdump."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        return {"HGMMA": None, "UTMALDG": None}
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib_path}: {out.stderr.strip()}")
    return {op: sum(op in line for line in out.stdout.splitlines())
            for op in ("HGMMA", "UTMALDG")}


def check_conv_kernel(torch, device) -> tuple[dict, dict]:
    """conv3d_bn_stats on both routes: bfloat16 (tensor cores) at path R's
    layer-1 shape for N = 1, 2, 16 (three grid sizes), at a ragged shape and
    at one with W > 64, C > 64 and Co not a multiple of 64; float32 (CUDA
    cores) at N = 2. y against a float32 convolution of the same inputs
    (TF32 off), s1 and s2 against float64 sums of the kernel's own y and
    against the plain version's; each call must go through its route's
    kernel. Then the times at N=16 (B=8) and N=64 (B=32) beside cuDNN's
    convolution without the sums, and the float32 route's at N=16."""
    from dualvar_tpu_torch.ops import conv_fused as mod
    from dualvar_tpu_torch.ops.build import library_path

    sass = sass_counts(library_path("conv_fused"))
    print(f"kernels: conv_fused SASS: {json.dumps(sass)}", flush=True)
    if sass["HGMMA"] == 0 or sass["UTMALDG"] == 0:
        fail(f"conv_fused: no wgmma or no TMA load in the SASS: {sass}")

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(6)
    worst = {torch.bfloat16: [0.0, 0.0, 0.0], torch.float32: [0.0, 0.0, 0.0]}
    for (N, T, H, W, C, Co), dtype in (
            ((1, 16, 56, 56, 64, 64), torch.bfloat16),
            ((2, 16, 56, 56, 64, 64), torch.bfloat16),
            ((16, 16, 56, 56, 64, 64), torch.bfloat16),
            ((2, 5, 9, 13, 24, 40), torch.bfloat16),
            ((1, 4, 12, 70, 128, 96), torch.bfloat16),
            ((2, 16, 56, 56, 64, 64), torch.float32)):
        x = torch.randn((N, T, H, W, C), device=device, generator=gen).to(dtype)
        w = torch.randn((3, 3, 3, C, Co), device=device,
                        generator=gen) / math.sqrt(27 * C)
        route = (mod.tensor_core_forward if dtype == torch.bfloat16
                 else mod.cuda_core_forward)
        before = route.launches
        y, s1, s2 = mod.conv3d_bn_stats_forward(x, w)
        if route.launches != before + 1:
            fail(f"conv3d_bn_stats {dtype} did not go through its kernel")
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
        acc = worst[dtype]
        acc[0] = max(acc[0], err_y)
        acc[1] = max(acc[1], err_s)
        acc[2] = max(acc[2], float((y.float() - ref_y).abs().max()))
        del x, y, y64, ref_y, p_y
    # what neither kernel takes is refused, not run another way
    for shape_x, shape_w, dtype, exc in (
            ((1, 2, 4, 4, 12), (3, 3, 3, 12, 16), torch.bfloat16, ValueError),
            ((1, 2, 4, 4, 16), (3, 3, 3, 16, 16), torch.float16, TypeError)):
        try:
            mod.conv3d_bn_stats_forward(
                torch.zeros(shape_x, device=device, dtype=dtype),
                torch.zeros(shape_w, device=device))
        except exc:
            continue
        fail(f"conv3d_bn_stats accepted x {shape_x} {dtype}")

    entries = {}
    for dtype, sizes in ((torch.bfloat16, (16, 64)), (torch.float32, (16,))):
        for N in sizes:
            x = torch.randn((N, 16, 56, 56, 64), device=device,
                            generator=gen).to(dtype)
            w = torch.randn((3, 3, 3, 64, 64), device=device,
                            generator=gen) / math.sqrt(27 * 64)
            x_ncdhw = x.permute(0, 4, 1, 2, 3)  # channels_last_3d, no copy
            w_ncdhw = w.permute(4, 3, 0, 1, 2).to(dtype).contiguous(
                memory_format=torch.channels_last_3d)
            bound, bound_by = conv_bound_ms(N, 16, 56, 56, 64, 64,
                                            x.element_size())
            reps = 3 if dtype == torch.bfloat16 else 1
            row = {
                "shape": [N, 16, 56, 56, 64], "dtype": str(dtype),
                # the wrapper's device time (weight packing included), from
                # CUDA-graph replays; cuDNN with TF32 off for float32
                "ms": time_cuda_graph(
                    torch, lambda: mod.conv3d_bn_stats_forward(x, w), reps,
                    iters=5),
                "plain_ms": time_cuda(
                    torch, lambda: mod.conv3d_bn_stats_plain(x, w), 5,
                    warmup=1),
                # cuDNN's convolution of the same input, without the sums
                "library_ms": time_cuda(
                    torch, lambda: torch.nn.functional.conv3d(
                        x_ncdhw, w_ncdhw, padding=1), 5, warmup=1),
                "bound_ms": bound, "bound_by": bound_by}
            if dtype == torch.bfloat16 and N == 16:
                # out of L2: copies of x and w that hold four L2s with
                # their outputs, launched in turn
                nbytes = 2 * x.numel() * x.element_size()
                copies = cold_copies(torch, nbytes)
                sets = [(x.clone(), w.clone()) for _ in range(copies)]
                row["cold_ms"] = time_cuda_graph_cold(
                    torch, lambda c: mod.conv3d_bn_stats_forward(*sets[c]),
                    copies, iters=5)
                row["cold_bound_share"] = bound / row["cold_ms"]
                del sets
            print("kernels: conv3d_bn_stats timing " + json.dumps(row),
                  flush=True)
            entries.setdefault(dtype, row)
            del x, x_ncdhw
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    common = {"route": "cuda", "source": "dualvar_tpu_torch/csrc/conv_fused.cu",
              "replaces": "dualvar_tpu/ops/conv_fused.py:64", "launches": 0,
              "library": "torch.nn.functional.conv3d (cuDNN), without the sums"}
    out = []
    for name, dtype in (("conv3d_bn_stats_bf16", torch.bfloat16),
                        ("conv3d_bn_stats_f32", torch.float32)):
        err_y, err_s, err_abs = worst[dtype]
        out.append({"name": name, **common,
                    # y against a float32 convolution of the same inputs; the
                    # share of its tolerance (half a bf16 ulp of |y| + 1e-4,
                    # or 1e-4 in float32) it used
                    "max_abs_err": err_abs, "y_err_over_tol": err_y,
                    "sums_rel_err": err_s, **entries[dtype]})
    out[0]["sass"] = sass
    return tuple(out)


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
                        f"_s{model.n_series}_b{batch_size}"))


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


class RouteCount:
    """``.launches`` of one route of a kernel whose wrapper keeps that
    route's count in another attribute (``aug_fused.bf16_launches``)."""

    def __init__(self, wrapper, attr: str):
        self.wrapper, self.attr = wrapper, attr

    @property
    def launches(self) -> int:
        return getattr(self.wrapper, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.wrapper, self.attr, value)


def kernel_counters() -> dict:
    """name in the ``kernels`` line -> the wrapper that carries its count
    (``aug_fused`` counts the launches of both its routes, ``aug_fused_bf16``
    those of the bfloat16 compute route)."""
    from dualvar_tpu_torch.ops.aug_fused import aug_fused
    from dualvar_tpu_torch.ops.bn_stats import channel_sums
    from dualvar_tpu_torch.ops.conv_fused import (cuda_core_forward,
                                                  tensor_core_forward)
    from dualvar_tpu_torch.ops.soft_dtw import (soft_dtw_backward,
                                                soft_dtw_forward)

    return {"aug_fused": aug_fused,
            "aug_fused_bf16": RouteCount(aug_fused, "bf16_launches"),
            "soft_dtw_fwd": soft_dtw_forward,
            "soft_dtw_bwd": soft_dtw_backward, "channel_sums": channel_sums,
            "conv3d_bn_stats_bf16": tensor_core_forward,
            "conv3d_bn_stats_f32": cuda_core_forward}


def expected_launches(**counts) -> dict:
    """Expected launch counts of a run: the ones given, every other 0."""
    return {name: counts.get(name, 0) for name in kernel_counters()}


def is_classifier(cfg) -> bool:
    from dualvar_tpu_torch.core.config import ClassifierConfig

    return isinstance(cfg, ClassifierConfig)


def trainer_of(cfg):
    """The trainer module that runs ``cfg``: the classifier's for a
    ``ClassifierConfig``, else pretrain's."""
    from dualvar_tpu_torch.train import classifier, pretrain

    return classifier if is_classifier(cfg) else pretrain


def describe(cfg) -> str:
    """How the printed lines name a run's configuration."""
    if is_classifier(cfg):
        return f"{CLASSIFIER_PRESET} train_what={cfg.train_what}"
    return f"{cfg.run.prefix} mode {cfg.model.mode}"


# the metrics of the last run_path
LAST_METRICS: dict = {}


def run_path(torch, label: str, cfg, steps: int, want_launches: dict,
             metric_keys: tuple, profile_steps: int = 0) -> tuple[dict, dict]:
    """train() of ``cfg``'s trainer for ``steps`` steps with every launch
    count set to 0 just before and read just after; returns the state_dict
    of the newest checkpoint it saved and the counts of exactly that run.
    ``metric_keys`` must come back finite (and pretrain's ``total_loss``).
    ``profile_steps``: pretrain's ``--profile_steps``."""
    from dualvar_tpu_torch.core.checkpoint import checkpoint_file

    trainer = trainer_of(cfg)
    counters = kernel_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    extra = {"profile_steps": profile_steps} if profile_steps else {}
    metrics = trainer.train(cfg, max_steps=steps, device="cuda", **extra)
    LAST_METRICS.clear()
    LAST_METRICS.update(metrics)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in counters.items()}
    if not is_classifier(cfg):
        metric_keys += ("total_loss",)
    for key in metric_keys:
        if key not in metrics or not math.isfinite(metrics[key]):
            fail(f"{label}: {key} missing or not finite: {metrics}")
    if launches != want_launches:
        fail(f"{label}: launches {launches} in {steps} train steps, "
             f"expected {want_launches}")
    ckpt = torch.load(
        checkpoint_file(os.path.join(trainer.set_path(cfg), "model")),
        map_location="cpu")
    if ckpt["iteration"] != steps:
        fail(f"{label}: checkpoint iteration {ckpt['iteration']} != {steps}")
    state = ckpt["state_dict"]
    for key, val in state.items():
        if not torch.isfinite(val).all():
            fail(f"{label}: {key} is not finite after training")
    print(f"{label}: {steps} steps of {describe(cfg)} at "
          f"B={cfg.optim.batch_size}, launches=" + json.dumps(launches)
          + ", metrics=" + json.dumps(metrics), flush=True)
    return state, launches


TSV4_LOSSES = ("clip_loss", "tc_loss", "aug_ranking_margin_loss",
               "unaug_ranking_margin_loss")


# the main path's run traces this many steps (--profile_steps)
PROFILE_STEPS = 2


def run_main_path(torch, log_root: str) -> tuple[dict, dict]:
    """The first slice's path: SimCLR TimeSeriesV4 in mode clip-sr-tc, with
    ``profile_steps`` on (``check_observability``)."""
    cfg = smoke_cfg("paper_table1_k400", 8, log_root)
    state, launches = run_path(
        torch, "path paper_table1_k400", cfg, TRAIN_STEPS,
        expected_launches(aug_fused=TRAIN_STEPS), TSV4_LOSSES,
        profile_steps=PROFILE_STEPS)
    mean = state["backbone.bn1.running_mean"]
    var = state["backbone.layer4_block0.bn2.running_var"]
    if float(mean.abs().max()) == 0.0 or float((var - 1).abs().max()) == 0.0:
        fail("main path: BN running statistics did not move")
    check_observability(cfg)
    return state, launches


@contextlib.contextmanager
def fused_compute(name: str):
    """Inside the block the pretrain trainer's augmentation runs with
    ``AugConfig.fused_compute=name``: no preset or flag sets it, in
    either package, so it is set on the ``AugConfig`` in code."""
    from dualvar_tpu_torch.train import pretrain as TP

    made = TP.aug_config
    TP.aug_config = lambda cfg: dataclasses.replace(made(cfg),
                                                    fused_compute=name)
    try:
        yield
    finally:
        TP.aug_config = made


def run_bf16_compute_step(torch, log_root: str) -> dict:
    """One step of the main path (``paper_table1_k400``, B=8) with
    ``fused_compute='bfloat16'``: finite losses, ``aug_fused`` launched
    once, through its bfloat16 compute route."""
    cfg = smoke_cfg("paper_table1_k400", 8, log_root)
    cfg = cfg.replace(run=dataclasses.replace(
        cfg.run, name_prefix=cfg.run.name_prefix + "_bf16_compute"))
    with fused_compute("bfloat16"):
        _, launches = run_path(
            torch, "main path, bf16 compute", cfg, 1,
            expected_launches(aug_fused=1, aug_fused_bf16=1), TSV4_LOSSES)
    return launches


def check_observability(cfg) -> None:
    """What the main path's run wrote besides its checkpoint: the profiler
    trace of ``PROFILE_STEPS`` steps under ``{exp}/img/profile``, which
    must name the ``aug_fused`` kernel's symbol (``aug_band_kernel``) once a
    traced step, and ``{exp}/img/pretrain/metrics.jsonl`` with a
    ``local/<metric>`` line for each metric of each of the ``TRAIN_STEPS``
    logged steps and the epoch's ``global/`` losses and accuracies."""
    from dualvar_tpu_torch.train.pretrain import set_path

    exp = set_path(cfg)
    trace = os.path.join(exp, "img", "profile", "rank0.pt.trace.json")
    if not os.path.exists(trace):
        fail(f"profile_steps: no trace at {trace}")
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    aug = [e for e in events if "aug_band_kernel" in e.get("name", "")]
    device = [e for e in events if e.get("cat") == "kernel"]
    if len(aug) != PROFILE_STEPS:
        fail(f"profile_steps: the trace names aug_band_kernel {len(aug)} "
             f"times, expected {PROFILE_STEPS} (one launch a traced step)")
    print(f"profile_steps: {trace} ({os.path.getsize(trace)} bytes), "
          f"{len(device)} device kernel events in {PROFILE_STEPS} steps, "
          f"aug_fused as '{aug[0]['name']}' {len(aug)} times", flush=True)
    with open(os.path.join(exp, "img", "pretrain", "metrics.jsonl")) as fh:
        lines = [json.loads(line) for line in fh]
    local = [x for x in lines if x["tag"].startswith("local/")]
    tags = {x["tag"] for x in lines}
    want = {"local/total_loss", "local/clip_loss", "global/clip_loss",
            "global/clip_acc", "global/total_loss"}
    if not want <= tags or len({x["step"] for x in local}) != TRAIN_STEPS \
            or not all(math.isfinite(x["value"]) for x in lines):
        fail(f"metrics writer: tags {sorted(tags)}, steps "
             f"{sorted({x['step'] for x in local})}")
    print(f"metrics writer: {len(lines)} lines, tags {sorted(tags)}",
          flush=True)


def initial_state(torch, cfg) -> dict:
    """The state_dict ``setup_training`` starts from for ``cfg``, rebuilt on
    the CPU from the same seeds."""
    from dualvar_tpu_torch.train.pretrain import build_task

    return build_task(cfg).model.state_dict()


def check_moco_state(torch, label: str, cfg, state: dict,
                     steps: int) -> None:
    """What ``steps`` MoCo steps at B=8 must leave: the queue pointer at 8 x
    steps, rows 0.. of both queues written and unit-norm per segment (the
    series queue has ``n_series`` segments of ``series_dim``), the rest
    untouched, the key encoder moved by its momentum update and its batch
    norms by its own forwards."""
    init = initial_state(torch, cfg)
    written = cfg.optim.batch_size * steps
    if int(state["queue_ptr"]) != written:
        fail(f"{label}: queue_ptr {int(state['queue_ptr'])} != {written}")
    m = cfg.model
    for name, seg_dim in (("queue", m.moco_dim),
                          ("series_queue", m.series_dim)):
        new, old = state[name], init[name]
        if not torch.equal(new[written:], old[written:]):
            fail(f"{label}: rows {written}.. of {name} changed")
        if bool((new[:written] == old[:written]).all(dim=1).any()):
            fail(f"{label}: a row 0..{written - 1} of {name} was not written")
        norms = new[:written].reshape(written, -1, seg_dim).norm(dim=-1)
        if float((norms - 1).abs().max()) > 1e-4:
            fail(f"{label}: written rows of {name} are not unit-norm per "
                 "segment")
    if state["series_queue"].shape[1] != m.n_series * m.series_dim:
        fail(f"{label}: series_queue is {tuple(state['series_queue'].shape)}"
             f", not {m.n_series} segments of {m.series_dim}")
    moved = differs = False
    for key in (k for k in state if k.startswith("encoder_k.")
                and "running_" not in k):
        moved |= not torch.equal(state[key], init[key])
        differs |= not torch.equal(state[key],
                                   state["encoder_q." + key[10:]])
    if not (moved and differs):
        fail(f"{label}: the key encoder did not move by its momentum update, "
             "or equals the query encoder")
    k_mean = state["encoder_k.backbone.bn1.running_mean"]
    if float(k_mean.abs().max()) == 0.0 or torch.equal(
            k_mean, state["encoder_q.backbone.bn1.running_mean"]):
        fail(f"{label}: the key encoder's BN running statistics did not move "
             "from its own forwards")
    print(f"{label}: queue_ptr={written}, rows 0..{written - 1} of both "
          f"queues written and unit-norm ({m.n_series} segments of the "
          "series queue), the rest untouched; key encoder moved", flush=True)


def run_path_m(torch, log_root: str, label: str = "path M",
               **model_kw) -> tuple[dict, dict]:
    """Path M: MoCo TimeSeriesV4 at K=16384 in mode clip-sr-dtw. A step
    calls the soft-DTW function twice (each query against its key, B pairs,
    and against the whole queue, B*K pairs), so both kernels launch twice a
    step. ``n_series=16`` gives path M16: pairs of 16x16 segments."""
    cfg = smoke_cfg(MOCO_PRESET, 8, log_root, mode="clip-sr-dtw", **model_kw)
    state, launches = run_path(
        torch, label, cfg, TRAIN_STEPS,
        expected_launches(aug_fused=TRAIN_STEPS,
                          soft_dtw_fwd=2 * TRAIN_STEPS,
                          soft_dtw_bwd=2 * TRAIN_STEPS), TSV4_LOSSES)
    check_moco_state(torch, label, cfg, state, TRAIN_STEPS)
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
    from dualvar_tpu_torch.ops.conv_fused import (conv3d_bn_stats_forward,
                                                  tensor_core_forward)
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
    before = tensor_core_forward.launches
    y, s1, s2 = conv3d_bn_stats_forward(
        x.permute(0, 2, 3, 4, 1).contiguous(), w)
    torch.cuda.synchronize()
    if x.dtype != torch.bfloat16 or tuple(x.shape) != (16, 64, 16, 56, 56):
        fail(f"path R layer 1: conv2 input is {x.dtype} {tuple(x.shape)}")
    if tensor_core_forward.launches != before + 1:
        fail("path R layer 1: the conv did not take the tensor-core kernel")
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


def time_train_steps(torch, cfg, n: int = 10, windows: int = 1) -> None:
    """Step time of the same step train() runs for ``cfg`` (pretrain or the
    classifier), on one device-resident batch (loading excluded), bf16
    autocast as the preset asks: ``windows`` host-clock windows of ``n``
    steps after 3 warm-up steps, the median window's ms per step and every
    window's, with peak device memory. ``samples_per_s`` is B a second,
    ``clips_per_s`` B x views a second (the benches' and soaks' clips)."""
    classifier = is_classifier(cfg)
    batch_size = cfg.optim.batch_size
    setup = trainer_of(cfg).setup_training(cfg, "cuda")
    # clips a sample: the views each pretrain sample encodes, one for the
    # classifier
    n_views = 1 if classifier else setup.task.n_views
    with setup.loader as loader:
        batch = next(loader.epoch(0))
    inputs = [torch.from_numpy(batch[key]).to("cuda")
              for key in (("frames", "label") if classifier else ("frames",))]
    for _ in range(3):
        setup.train_step(*inputs, setup.generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    from dualvar_tpu_torch.core import dist

    dist.collectives.clear()
    window_ms = []
    for _ in range(windows):
        tic = time.perf_counter()
        for _ in range(n):
            metrics = setup.train_step(*inputs, setup.generator)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - tic) / n * 1e3)
    ms = statistics.median(window_ms)
    loss = "loss" if classifier else "total_loss"
    if not math.isfinite(float(metrics[loss])):
        fail(f"timed steps of {describe(cfg)} at B={batch_size}: {loss} not "
             "finite")
    key_encoder = getattr(setup.model, "encoder_k", None)
    if key_encoder is not None and any(
            p.grad is not None or p.requires_grad
            for p in key_encoder.parameters()):
        fail("timed steps: a key-encoder parameter has a gradient")
    if classifier:
        what = {"preset": CLASSIFIER_PRESET, "net": cfg.model.net,
                "train_what": cfg.train_what}
    else:
        what = {"preset": cfg.run.prefix, "net": cfg.model.net,
                "model": cfg.model.model, "mode": cfg.model.mode,
                "bn_stats": os.environ.get("DUALVAR_BN_STATS", "aten"),
                "n_series": cfg.model.n_series}
    record = {
        **what, "remat": cfg.model.remat, "optim": cfg.optim.optim,
        "batch_size": batch_size, "steps": n, "windows": windows,
        "dtype": cfg.model.dtype, "world_size": dist.world_size(),
        "backend": torch.distributed.get_backend() if dist.active() else None,
        "collectives_per_step": {k: v / (n * windows)
                                 for k, v in dist.collectives.items()},
        "ms_per_step": ms, "samples_per_s": batch_size / ms * 1e3,
        "clips_per_s": batch_size * n_views / ms * 1e3,
        "window_ms_per_step": window_ms,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    print("step time: " + json.dumps(record), flush=True)
    del setup
    torch.cuda.empty_cache()
    return record


def check_f32_forward(torch, label: str, cfg, state: dict,
                      want_sums: int = 0,
                      feature_atol: float | None = None) -> None:
    """One train-mode float32 forward on the card, TF32 off, against the CPU
    from the same state_dict, block and segment permutation. On the CPU the
    soft-DTW wrapper takes its plain version, so for mode clip-sr-dtw this
    also holds the kernels against it inside the model; under
    ``DUALVAR_BN_STATS=pallas`` the same holds for ``channel_sums``, and the
    card's forward must launch it ``want_sums`` times (one call a batch
    norm a backbone pass), else never.

    Tolerances: the losses to 1e-4 and the logits (cosine / 0.07, so up to
    +-14.3) to 5e-4 absolute — float32 convolutions that sum in another
    order, through 18 layers of batch-statistics BN on a 2-clip batch.
    TF32 convolutions (3 decimal digits) would miss these by a wide margin,
    so the check also shows that the flags took effect.

    With ``feature_atol`` the backbone's outputs inside the forward are
    compared too: the card's against the CPU's, and the CPU's float32
    against a float64 pass of the CPU's backbone on the same inputs, each
    within ``feature_atol``."""
    from dualvar_tpu_torch.aug.pipeline import AugConfig, pretrain_batch
    from dualvar_tpu_torch.data.loader import HostLoader
    from dualvar_tpu_torch.ops.bn_stats import channel_sums
    from dualvar_tpu_torch.train.pretrain import build_dataset
    from dualvar_tpu_torch.train.tasks import make_task

    tf32 = tf32_off(torch)
    n_views = 2 if cfg.model.model.endswith("naked") else 3
    with HostLoader(build_dataset(cfg, n_views), 2, seed=1,
                    num_workers=2) as loader:
        frames = torch.from_numpy(next(loader.epoch(0))["frames"])
    generator = torch.Generator().manual_seed(3)
    aug_cfg = AugConfig(jitter_order="sample")
    block = pretrain_batch(generator, frames.to("cuda"), aug_cfg)
    perm = torch.tensor([[1, 0], [0, 1]])
    rets, feats = {}, {}
    for dev in ("cuda", "cpu"):
        task = make_task(cfg.model)
        task.model.load_state_dict(state)
        task.model.to(dev).train()
        seen = feats[dev] = []  # (input, output) of each backbone pass
        if feature_atol is not None:
            hook = task.model.backbone.register_forward_hook(
                lambda mod, args, out, seen=seen: seen.append(
                    (args[0].to("cpu", copy=True), out.double().cpu())))
        before = channel_sums.launches
        with torch.no_grad():
            rets[dev] = {k: v.float().cpu() for k, v in task.forward(
                block.to(dev), perm=perm).items()}
        if feature_atol is not None:
            hook.remove()
        if dev == "cuda":
            sums = channel_sums.launches - before
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
          f"(atol 5e-4); channel_sums launches {sums} (expected "
          f"{want_sums})", flush=True)
    if not (worst_loss <= 1e-4 and worst_logit <= 5e-4):
        fail(f"f32 check, {label}: card and CPU forwards disagree")
    if sums != want_sums:
        fail(f"f32 check, {label}: the card's forward launched channel_sums "
             f"{sums} times, expected {want_sums}")
    if feature_atol is not None:
        backbone = task.model.backbone.double()
        with torch.no_grad():
            f64 = [backbone(x.double()) for x, _ in feats["cpu"]]
        errs = {"card_vs_cpu": 0.0, "cpu_vs_f64": 0.0, "card_vs_f64": 0.0}
        for (_, card), (_, cpu), want in zip(feats["cuda"], feats["cpu"],
                                             f64):
            if not torch.isfinite(card).all():
                fail(f"f32 check, {label}: the card's features are not "
                     "finite")
            for key, a, b in (("card_vs_cpu", card, cpu),
                              ("cpu_vs_f64", cpu, want),
                              ("card_vs_f64", card, want)):
                errs[key] = max(errs[key], float((a - b).abs().max()))
        errs["max_abs_out"] = max(float(w.abs().max()) for w in f64)
        print(f"f32 check, {label}: backbone features of "
              f"{len(f64)} passes, shapes "
              f"{[tuple(w.shape) for w in f64]}: " + json.dumps(errs)
              + f" (atol {feature_atol:.1e} on card_vs_cpu and cpu_vs_f64)",
              flush=True)
        if not (len(feats["cuda"]) == len(f64) > 0
                and errs["card_vs_cpu"] <= feature_atol
                and errs["cpu_vs_f64"] <= feature_atol):
            fail(f"f32 check, {label}: backbone features off by more than "
                 f"{feature_atol}")
    tf32_restore(torch, tf32)


def check_restore_on_card(torch, label: str, cfg) -> dict:
    """What ``--resume`` restores, on the card: ``setup_training`` on cuda,
    then ``restore_training_state`` from the latest checkpoint of the run's
    store (what ``train()`` does). The model's state_dict, the optimizer's
    momentum buffers, the scheduler's state and the CUDA generator's state
    must equal the saved file bitwise. Returns the checkpoint."""
    from dualvar_tpu_torch.core.checkpoint import CheckpointStore
    from dualvar_tpu_torch.train.pretrain import (restore_training_state,
                                                  set_path, setup_training)

    ckpt = CheckpointStore(os.path.join(set_path(cfg), "model")).restore()
    setup = setup_training(cfg, "cuda")
    setup.loader.close()
    restore_training_state(ckpt, setup.model, setup.optimizer,
                           setup.scheduler, setup.generator)
    torch.cuda.synchronize()
    bad = [k for k, v in setup.model.state_dict().items()
           if v.device.type != "cuda" or not torch.equal(
               v.cpu(), ckpt["state_dict"][k])]
    opt = setup.optimizer.state_dict()["state"]
    want_opt = ckpt["optimizer"]["state"]
    if set(opt) != set(want_opt) or not opt:
        bad.append("optimizer state keys")
    bad += [f"optimizer {i}" for i in opt if not torch.equal(
        opt[i]["momentum_buffer"].cpu(), want_opt[i]["momentum_buffer"])]
    sched = setup.scheduler.state_dict()
    want_sched = ckpt["scheduler"]
    if (dict(sched["milestones"]) != want_sched["milestones"]
            or {k: v for k, v in sched.items() if k != "milestones"}
            != {k: v for k, v in want_sched.items() if k != "milestones"}):
        bad.append("scheduler")
    if setup.generator.device.type != "cuda" or not torch.equal(
            setup.generator.get_state(), ckpt["generator"]):
        bad.append("generator")
    if bad:
        fail(f"{label}: restored on the card unlike the saved file: "
             f"{bad[:6]}")
    print(f"{label}: restored epoch {ckpt['epoch']} iteration "
          f"{ckpt['iteration']} on the card: {len(ckpt['state_dict'])} "
          f"state_dict entries, {len(opt)} momentum buffers, the scheduler "
          "and the CUDA generator's state bitwise as saved", flush=True)
    del setup
    torch.cuda.empty_cache()
    return ckpt


def check_store(label: str, cfg, latest: list, best: list) -> None:
    """The epochs the run's store keeps in ``latest/`` and ``best/``."""
    from dualvar_tpu_torch.core.checkpoint import _epoch_files
    from dualvar_tpu_torch.train.pretrain import set_path

    model = os.path.join(set_path(cfg), "model")
    got = [sorted(_epoch_files(os.path.join(model, d)))
           for d in ("latest", "best")]
    if got != [latest, best]:
        fail(f"{label}: the store keeps latest {got[0]} best {got[1]}, "
             f"expected {latest} {best}")
    print(f"{label}: the store keeps latest {latest}, best {best} "
          f"(keep_all={cfg.run.keep_all})", flush=True)


def path_g_cfg(batch_size: int, log_root: str, epochs: int = 2,
               resume: str = "", videos: int = PATH_G_VIDEOS, tag: str = ""):
    """Path G: ``--preset s3dg_k400`` at full width (S3D-G, 3 views,
    16x112x112 clips at ds 4, SGD, bf16 autocast, keep_all) on ``videos``
    synthetic videos, saving every epoch."""
    cfg = smoke_cfg(PATH_G_PRESET, batch_size, log_root)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_videos=max(
            videos, batch_size)),
        optim=dataclasses.replace(cfg.optim, epochs=epochs),
        run=dataclasses.replace(cfg.run, eval_freq=1, save_freq=1,
                                resume=resume,
                                name_prefix=cfg.run.name_prefix + tag))


def run_path_g(torch, log_root: str) -> tuple[dict, dict]:
    """Path G: two epochs, then ``--resume auto`` for a third, then a run
    with ``DUALVAR_BN_STATS=pallas``. Returns the resumed run's state_dict
    and the launch counts by run."""
    spe = PATH_G_VIDEOS // 8
    by_run = {}
    cfg = path_g_cfg(8, log_root)
    _, by_run["path G"] = run_path(
        torch, "path G", cfg, 2 * spe,
        expected_launches(aug_fused=2 * spe), TSV4_LOSSES)
    check_store("path G", cfg, [0, 1], [0, 1])

    resumed = path_g_cfg(8, log_root, epochs=3, resume="auto")
    ckpt = check_restore_on_card(torch, "path G", resumed)
    if (ckpt["epoch"], ckpt["iteration"]) != (1, 2 * spe):
        fail(f"path G: the latest checkpoint is epoch {ckpt['epoch']} "
             f"iteration {ckpt['iteration']}, not 1 and {2 * spe}")
    # one epoch more: the run starts at epoch 2, global step 2 * spe
    state, by_run["path G, resumed"] = run_path(
        torch, "path G, resumed", resumed, 3 * spe,
        expected_launches(aug_fused=spe), TSV4_LOSSES)
    check_store("path G, resumed", resumed, [1, 2], [0, 1, 2])
    if torch.equal(state["backbone.Conv_1a.conv1.weight"],
                   ckpt["state_dict"]["backbone.Conv_1a.conv1.weight"]):
        fail("path G, resumed: the stem did not move in the third epoch")

    pallas = path_g_cfg(8, log_root, epochs=1, tag="_pallas")
    with bn_stats_env(True):
        _, by_run["path G, DUALVAR_BN_STATS=pallas"] = run_path(
            torch, "path G, DUALVAR_BN_STATS=pallas", pallas, PATH_S_STEPS,
            expected_launches(aug_fused=PATH_S_STEPS,
                              channel_sums=S3DG_SUMS_PER_STEP * PATH_S_STEPS),
            TSV4_LOSSES)
    return state, by_run


def path_g_sum_calls(torch, cfg, state: dict | None) -> list[tuple]:
    """The channel_sums calls of one train step of path G (variable on,
    bf16 autocast) from ``state`` (None: the model's own initialisation),
    with every batch norm's input and the gradient of its output hooked —
    77 layers of 16 to 384 channels, each in both backbone passes, so the
    step's 154 forward calls (x, x) and 154 backward calls (g, x) exactly
    as the layer makes them, in the order it makes them. Fails unless the
    step launched as many."""
    from dualvar_tpu_torch.models.layers import BatchNorm, _memory_format
    from dualvar_tpu_torch.ops import bn_stats as mod
    from dualvar_tpu_torch.train.pretrain import setup_training

    with bn_stats_env(True):
        setup = setup_training(cfg, "cuda")
        if state is not None:
            setup.model.load_state_dict(state)
        with setup.loader as loader:
            frames = torch.from_numpy(
                next(loader.epoch(0))["frames"]).to("cuda")
        calls = []  # (a, b) of each channel_sums call of the step

        def hook(layer, args, out):
            x = args[0].detach()
            calls.append((x, x))
            out.register_hook(lambda g: calls.append((g.contiguous(
                memory_format=_memory_format(x)), x)))

        layers = [m for m in setup.model.backbone.modules()
                  if isinstance(m, BatchNorm)]
        hooks = [m.register_forward_hook(hook) for m in layers]
        before = mod.channel_sums.launches
        setup.train_step(frames, setup.generator)
        torch.cuda.synchronize()
        launched = mod.channel_sums.launches - before
        for h in hooks:
            h.remove()
    if not (len(layers) == S3DG_BATCH_NORMS
            and len(calls) == launched == S3DG_SUMS_PER_STEP):
        fail(f"path G step: {len(layers)} batch norms, {len(calls)} calls "
             f"hooked, {launched} launched; expected {S3DG_BATCH_NORMS} and "
             f"{S3DG_SUMS_PER_STEP}")
    del setup
    return calls


def check_sums_on_path_g(torch, cfg, state: dict, floor) -> dict:
    """channel_sums on path G's own maps (``path_g_sum_calls``): each call
    against float64 sums and the plain version (``SUMS_RTOL``), twice
    bitwise equal; then the 308 calls timed together as the step makes
    them (replayed from one CUDA graph), in L2 and out of it with the
    per-call breakdown (``measure_sums``), beside the plain version and
    ATen's pair on the same maps."""
    from dualvar_tpu_torch.ops import bn_stats as mod

    calls = path_g_sum_calls(torch, cfg, state)
    worst = worst_abs = 0.0
    for a, b in calls:
        err, err_abs = sums_errors(torch, a, b)
        worst, worst_abs = max(worst, err), max(worst_abs, err_abs)
    if not worst <= SUMS_RTOL:
        fail(f"path G step: channel_sums relative error {worst} > "
             f"{SUMS_RTOL}")
    kernel_fn, library_fn = kernel_sums(mod), aten_sums(torch)

    def replay(fn):
        return lambda: [fn(a, b) for a, b in calls]

    kernel = measure_sums(torch, kernel_fn, calls, floor)
    library = measure_sums(torch, library_fn, calls)
    row = {"calls": len(calls),
           "widths": sorted({a.shape[1] for a, _ in calls}),
           "dtypes": sorted({str(a.dtype) for a, _ in calls}),
           "max_rel_err": worst, "max_abs_err": worst_abs,
           # the step's calls in its order, on its tensors (a layer's x
           # read by its forward and, later, its backward call)
           "as_hooked_ms": time_cuda_graph(torch, replay(kernel_fn), 1),
           "plain_ms": time_cuda(torch, replay(lambda a, b:
                                               mod.channel_sums_plain(
                                                   a, b, dim=1)), 5),
           "library_as_hooked_ms": time_cuda_graph(torch, replay(library_fn),
                                                   1),
           "library_ms": library["ms"], "library_cold_ms": library["cold_ms"],
           **{k: v for k, v in kernel.items() if k != "per_call"}}
    print("path G step: channel_sums on the step's own maps (B=8, every "
          "batch norm, forward and backward; ms in L2, cold_ms out of it): "
          + json.dumps(row), flush=True)
    for r in kernel["per_call"]:
        print("path G step: channel_sums per call " + json.dumps(r),
              flush=True)
    del calls
    torch.cuda.empty_cache()
    return row


def run_path_m_resume(torch, log_root: str) -> dict:
    """Path M for one epoch of two steps, saved, then resumed for a
    second: the queue, the series queue, the pointer and the key encoder
    come back on the card bitwise as saved, and after the second epoch the
    queues hold the four steps' keys."""
    by_run = {}

    def cfg_of(epochs, resume=""):
        cfg = smoke_cfg(MOCO_PRESET, 8, log_root, mode="clip-sr-dtw")
        return cfg.replace(
            data=dataclasses.replace(cfg.data, synthetic_videos=16),
            optim=dataclasses.replace(cfg.optim, epochs=epochs),
            run=dataclasses.replace(cfg.run, eval_freq=1, save_freq=1,
                                    resume=resume,
                                    name_prefix=cfg.run.name_prefix
                                    + "_resume"))

    first = cfg_of(1)
    counts = dict(aug_fused=2, soft_dtw_fwd=4, soft_dtw_bwd=4)
    _, by_run["path M, one epoch"] = run_path(
        torch, "path M, one epoch", first, 2, expected_launches(**counts),
        TSV4_LOSSES)
    resumed = cfg_of(2, resume="auto")
    ckpt = check_restore_on_card(torch, "path M", resumed)
    moco = ("queue", "series_queue", "queue_ptr")
    if int(ckpt["state_dict"]["queue_ptr"]) != 16:
        fail(f"path M: saved queue_ptr {int(ckpt['state_dict']['queue_ptr'])}"
             " != 16")
    state, by_run["path M, resumed"] = run_path(
        torch, "path M, resumed", resumed, 4, expected_launches(**counts),
        TSV4_LOSSES)
    check_moco_state(torch, "path M, resumed", resumed, state, 4)
    print("path M: " + ", ".join(moco) + " and the key encoder ("
          f"{sum(k.startswith('encoder_k.') for k in ckpt['state_dict'])} "
          "entries) restored bitwise", flush=True)
    return by_run


def run_backbone_steps(torch, log_root: str) -> dict:
    """``paper_table1_k400 --net <x>`` for each of ``BACKBONE_STEP_NETS``:
    two steps at B=8 (``aug_fused`` 2), the step time at B=8 (three
    10-step windows) with peak memory, and the backbone's float32 forward
    on the card against the CPU (``check_f32_forward`` with the family's
    feature tolerance)."""
    by_run = {}
    for net in BACKBONE_STEP_NETS:
        cfg = smoke_cfg("paper_table1_k400", 8, log_root, net=net)
        label = f"backbone {net}"
        state, by_run[label] = run_path(
            torch, label, cfg, PATH_S_STEPS,
            expected_launches(aug_fused=PATH_S_STEPS), TSV4_LOSSES)
        time_train_steps(torch, cfg, windows=3)
        check_f32_forward(
            torch, label, smoke_cfg("paper_table1_k400", 2, log_root, net=net),
            state, feature_atol=FEATURE_F32_ATOL_BY_NET.get(
                net, FEATURE_F32_ATOL))
        torch.cuda.empty_cache()
    return by_run


# --------------------------------------------------------------------------
# path C: the downstream classifier
# --------------------------------------------------------------------------

def path_c_cfg(log_root: str, batch_size: int = 4, train_what: str = "ft",
               pretrain: str = "", resume: str = "", videos: int = 8):
    """``--preset paper_table1_ucf_ft`` at full width (R(2+1)D-18, 101
    classes, 16x112x112 clips at ds 2, bf16 autocast, the preset's SGD) on
    ``videos`` synthetic videos."""
    from dualvar_tpu_torch.core.config import CLASSIFIER_PRESETS

    cfg = CLASSIFIER_PRESETS[CLASSIFIER_PRESET]
    return dataclasses.replace(
        cfg, train_what=train_what,
        data=dataclasses.replace(cfg.data, synthetic=True,
                                 synthetic_videos=videos),
        optim=dataclasses.replace(cfg.optim, batch_size=batch_size),
        run=dataclasses.replace(
            cfg.run, print_freq=1, log_root=log_root, pretrain=pretrain,
            resume=resume,
            name_prefix=f"chip_smoke_{train_what}_b{batch_size}"))


def check_graft(torch, cfg, label: str = "path C graft") -> dict:
    """The graft of the pretrain checkpoint ``cfg.run.pretrain`` into a fresh
    classifier: every ``backbone.*`` entry loaded from the checkpoint's
    backbone (SimCLR's ``backbone.*``, MoCo's ``encoder_q.backbone.*``),
    nothing unused, ``final_fc`` kept at its init. Returns the grafted
    state_dict."""
    from dualvar_tpu_torch.core.checkpoint import (load_pretrained_backbone,
                                                   load_state_dict,
                                                   pretrain_backbone)
    from dualvar_tpu_torch.train.classifier import build_model

    fresh = build_model(cfg, cfg.run.seed).state_dict()
    pretrained = load_state_dict(cfg.run.pretrain)
    source = pretrain_backbone(pretrained)
    state, report = load_pretrained_backbone(fresh, pretrained)
    backbone = [k for k in fresh if k.startswith("backbone.")]
    if (sorted(report["loaded"]) != sorted(backbone)
            or report["missing_in_src"] or report["unused_src"]):
        fail(f"{label}: {len(report['loaded'])} of {len(backbone)} "
             f"backbone entries loaded, missing {report['missing_in_src'][:4]}"
             f", unused {report['unused_src'][:4]}")
    for key in backbone:
        if not torch.equal(state[key], source[key[len("backbone."):]]):
            fail(f"{label}: {key} is not the checkpoint's")
    for key in (k for k in fresh if not k.startswith("backbone.")):
        if not torch.equal(state[key], fresh[key]):
            fail(f"{label}: {key} did not keep its init")
    print(f"{label}: {len(backbone)} backbone entries loaded from "
          f"{cfg.run.pretrain}, final_fc kept at init", flush=True)
    return state


def run_path_c(torch, log_root: str, pretrain: str) -> tuple[dict, dict]:
    """Path C: graft, finetune, probe and the five test protocols. Returns
    the finetuned state_dict and the launch counts by run."""
    from dualvar_tpu_torch.train import classifier as clf

    cfg = path_c_cfg(log_root, pretrain=pretrain)
    grafted = check_graft(torch, cfg)
    by_run = {}
    ft, by_run["path C"] = run_path(
        torch, "path C finetune", cfg, TRAIN_STEPS,
        expected_launches(aug_fused=TRAIN_STEPS), CLASSIFIER_METRICS)
    if all(torch.equal(ft[k], grafted[k]) for k in grafted
           if k.startswith("backbone.") and "running_" not in k):
        fail("path C finetune: the backbone did not move")

    probe_cfg = path_c_cfg(log_root, train_what="last", pretrain=pretrain)
    probe, by_run["path C, probe"] = run_path(
        torch, "path C probe", probe_cfg, PROBE_STEPS,
        expected_launches(aug_fused=PROBE_STEPS), CLASSIFIER_METRICS)
    for key in (k for k in grafted if k.startswith("backbone.")):
        if not torch.equal(probe[key], grafted[key]):
            fail(f"path C probe: {key} changed; the probe must leave every "
                 "backbone weight and running statistic as grafted")
    if torch.equal(probe["final_fc.weight"], grafted["final_fc.weight"]):
        fail("path C probe: final_fc did not move")
    print("path C probe: every backbone weight and running statistic "
          "bitwise unchanged, final_fc moved", flush=True)

    # the protocols read the finetuned checkpoint; batch 16 (the batch of
    # an eval pass changes no result)
    test_cfg = path_c_cfg(log_root, batch_size=16,
                          resume=os.path.join(clf.set_path(cfg), "model"))
    counters = kernel_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    protocols = (
        ("center", lambda: clf.test_multicrop(test_cfg, "center")),
        ("five", lambda: clf.test_multicrop(test_cfg, "five")),
        ("ten", lambda: clf.test_multicrop(test_cfg, "ten")),
        ("temporal_ten_clip", lambda: clf.test_temporal_tenclip(test_cfg)),
        ("retrieval", lambda: clf.test_retrieval(test_cfg)))
    for name, run in protocols:
        tic = time.perf_counter()
        out = run()
        took = time.perf_counter() - tic
        values = {k: v for k, v in out.items() if k != "classwise"}
        if not values or not all(
                math.isfinite(v) and 0.0 <= v <= 1.0 for v in values.values()):
            fail(f"path C protocol {name}: {out}")
        print(f"path C protocol {name}: {took:.2f} s, " + json.dumps(values),
              flush=True)
    launches = {n: w.launches for n, w in counters.items()}
    if launches != expected_launches():
        fail(f"path C protocols launched kernels: {launches}")
    by_run["path C, protocols"] = launches
    return ft, by_run


def classifier_aug_inputs(torch, n: int, seed: int, device):
    """The classifier train batch's inputs at full size: uint8 frames
    (n, 16, 171, 128, 3) and decisions with both window extremes, every
    other clip flipped, one clip with identity factors."""
    import itertools

    import numpy as np

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, 16, 171, 128, 3), dtype=np.uint8)
    crops = np.stack([rng.integers(0, 171 - 112 + 1, n),
                      rng.integers(0, 128 - 112 + 1, n)], axis=-1)
    crops[0], crops[-1] = (0, 0), (171 - 112, 128 - 112)
    flips = np.arange(n) % 2 == 1
    perms = list(itertools.permutations(range(4)))
    orders = np.array([perms[(i * 7) % 24] for i in range(n)], np.int32)
    factors = rng.uniform(0.2, 1.8, (n, 4)).astype(np.float32)
    factors[:, 3] = rng.uniform(-0.2, 0.2, n)
    factors[1] = (1.0, 1.0, 1.0, 0.0)  # jitter not applied
    return tuple(torch.from_numpy(a).to(device)
                 for a in (frames, crops, flips, orders, factors))


def check_aug_classifier_shapes(torch, device) -> dict:
    """``aug_fused`` on the classifier's launches: blur off for every clip,
    the flip folded into the uint8 gather, N = 4 (the preset's B) and 32.
    The train batch through the kernel against the same batch through the
    plain version (float32 out at ``F32_ATOL``, bfloat16 at ``BF16_ATOL``),
    then the kernel timed with its data out of L2 and in L2 against
    ``aug_bound_ms``."""
    from dualvar_tpu_torch.aug.pipeline import (AugConfig, _crop_planar,
                                                classifier_train_batch_fused)
    from dualvar_tpu_torch.ops import aug_fused as mod

    rows = {}
    for n in (4, 32):
        frames, crops, flips, orders, factors = classifier_aug_inputs(
            torch, n, 20 + n, device)
        errs = {}
        for out_dtype, atol in (("float32", F32_ATOL),
                                ("bfloat16", BF16_ATOL)):
            cfg = AugConfig(out_dtype=out_dtype)
            got, want = (classifier_train_batch_fused(
                None, frames, cfg, crops=crops, flips=flips, orders=orders,
                factors=factors, kernel=kernel) for kernel in (True, False))
            torch.cuda.synchronize()
            if got.dtype != getattr(torch, out_dtype):
                fail(f"aug_fused classifier N={n}: {got.dtype} out")
            errs[out_dtype] = float((got.float() - want.float()).abs().max())
            if not errs[out_dtype] <= atol:
                fail(f"aug_fused classifier N={n} {out_dtype}: max abs err "
                     f"{errs[out_dtype]} > {atol}")
        # the kernel's own inputs: the flipped crops and blur (1, 0)
        planar = _crop_planar(frames, crops, 16, 112, flips=flips)
        blur = torch.tensor([[1.0, 0.0]], device=device).repeat(n, 1)
        bound, bound_by = aug_bound_ms(torch, planar, blur, torch.float32)
        nbytes = planar.numel() * (1 + 4)
        copies = cold_copies(torch, nbytes)
        sets = [(planar.clone(), orders.clone(), factors.clone(),
                 blur.clone()) for _ in range(copies)]
        outs = []  # every launch keeps its own output

        def launch(c):
            outs.append(mod._launch(*sets[c], torch.float32, True))

        cold_ms = time_cuda_graph_cold(torch, launch, copies)
        outs.clear()
        warm_ms = time_cuda_graph(torch, lambda: mod._launch(
            planar, orders, factors, blur, torch.float32, True), 10)
        plain_ms = time_cuda(torch, lambda: mod.aug_fused_plain(
            planar, orders, factors, blur), 5, warmup=1)
        rows[f"N={n}"] = {
            "ms": cold_ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "bound_share": bound / cold_ms, "max_abs_err": errs["float32"],
            "bf16_max_abs_err": errs["bfloat16"]}
        print(f"kernels: aug_fused classifier batch N={n} T=16 S=112, blur "
              "off, flips folded in: " + json.dumps(rows[f"N={n}"]),
              flush=True)
        del sets, outs
        torch.cuda.empty_cache()
    return rows


def check_f32_classifier(torch, cfg, state: dict) -> None:
    """One train-mode float32 forward of the finetuned classifier on the
    card, TF32 off, against the CPU from the same state_dict and clips:
    logits, pooled features and the loss within ``CLF_F32_ATOL``."""
    from dualvar_tpu_torch.aug.pipeline import (AugConfig,
                                                classifier_train_batch)
    from dualvar_tpu_torch.data.loader import HostLoader
    from dualvar_tpu_torch.models.ssl.losses import cross_entropy_from_logits
    from dualvar_tpu_torch.train.classifier import (build_model,
                                                    classifier_dataset)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with HostLoader(classifier_dataset(cfg, "train"), 2, seed=1,
                    num_workers=2) as loader:
        batch = next(loader.epoch(0))
    clips = classifier_train_batch(
        torch.Generator().manual_seed(3),
        torch.from_numpy(batch["frames"]).to("cuda"),
        AugConfig(img_dim=cfg.data.img_dim, seq_len=cfg.data.seq_len,
                  rand_flip=True))
    labels = torch.from_numpy(batch["label"]).long()
    outs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg)
        model.load_state_dict(state)
        model.to(dev).train()
        with torch.no_grad():
            logit, feat = model(clips.to(dev))
            loss = cross_entropy_from_logits(logit, labels.to(dev))
        outs[dev] = [t.float().cpu() for t in (logit, feat, loss)]
    errs = [float((a - b).abs().max()) for a, b in zip(outs["cuda"],
                                                        outs["cpu"])]
    print(f"f32 check, path C: card vs CPU, TF32 off: max logit err "
          f"{errs[0]:.3e}, max feature err {errs[1]:.3e}, loss err "
          f"{errs[2]:.3e} (atol {CLF_F32_ATOL})", flush=True)
    if not all(torch.isfinite(t).all() for t in outs["cuda"]):
        fail("f32 check, path C: the card's forward is not finite")
    if not max(errs) <= CLF_F32_ATOL:
        fail("f32 check, path C: card and CPU forwards disagree")


# --------------------------------------------------------------------------
# path P: the paper's experiment chains (scripts/paper_torch/)
# --------------------------------------------------------------------------

# appended to every stage of a chain: the presets' own widths, batches and
# clips on synthetic frames, two train steps each logged
PATH_P_ARGV = ("--synthetic", "1", "--epochs", "1", "--max_steps", "2",
               "--print_freq", "1")
PATH_P_STEPS = 2
RETRIEVAL_DUMPS = tuple(
    f"ucf101_{split}_{what}" for split in ("test", "train")
    for what in ("feature.npy", "per_feature.npy", "label.npy",
                 "vname.json")) + ("ucf101_sim.npy", "retrieval.json")


@contextlib.contextmanager
def tested_states():
    """Yields a dict that gets, by ``--resume``, the classifier's state_dict
    as each test protocol loaded it (``classifier._load_test_state``)."""
    from dualvar_tpu_torch.train import classifier as clf

    load, states = clf._load_test_state, {}

    def keep(cfg, model, logger):
        load(cfg, model, logger)
        if cfg.run.resume:
            states[cfg.run.resume] = {k: v.detach().clone()
                                      for k, v in model.state_dict().items()}

    clf._load_test_state = keep
    try:
        yield states
    finally:
        clf._load_test_state = load


# the kinds of a chain's stages, in run.sh's order
CHAIN_STAGES = ("pretrain", "finetune", "test", "finetune", "test",
                "retrieval")


def stage_kind(stage) -> str:
    """pretrain, finetune, test (temporal ten-clip) or retrieval."""
    if stage.module.endswith(".pretrain"):
        return "pretrain"
    if "--test" not in stage.argv:
        return "finetune"
    test = stage.argv[stage.argv.index("--test") + 1]
    return {"temporal_ten_clip": "test", "retrieval": "retrieval"}[test]


def saved_checkpoint(torch, label: str, stage) -> dict:
    """The newest checkpoint of the stage's store, which must hold
    ``PATH_P_STEPS`` steps and finite entries, and have been logged."""
    from dualvar_tpu_torch.core.checkpoint import checkpoint_file

    if not any(line.startswith("saved checkpoint epoch 0")
               for line in stage.log):
        fail(f"{label}: no 'saved checkpoint' in its log")
    ckpt = torch.load(checkpoint_file(os.path.join(stage.directory, "model")),
                      map_location="cpu")
    if ckpt["iteration"] != PATH_P_STEPS:
        fail(f"{label}: checkpoint iteration {ckpt['iteration']}")
    for key, val in ckpt["state_dict"].items():
        if not torch.isfinite(val).all():
            fail(f"{label}: {key} is not finite in its checkpoint")
    return ckpt["state_dict"]


def check_chain_stage(torch, label: str, stage, cwd: str, earlier: dict,
                      tested: dict) -> None:
    """One replayed stage of a chain against what it must show; ``earlier``:
    the chain's pretrain stage and its finetunes by fold."""
    from dualvar_tpu_torch.train.classifier import set_path

    kind = stage_kind(stage)
    want = expected_launches(aug_fused=PATH_P_STEPS) if kind in (
        "pretrain", "finetune") else expected_launches()
    if stage.launches != want:
        fail(f"{label}: launches {stage.launches}, expected {want}")
    run = stage.config.run
    if kind == "pretrain":
        for key in TSV4_LOSSES + ("total_loss",):
            if not math.isfinite(stage.result.get(key, math.nan)):
                fail(f"{label}: {key} missing or not finite: {stage.result}")
        saved_checkpoint(torch, label, stage)
        return
    fold = os.path.basename(set_path(stage.config, create=False))
    read = run.resume if kind == "test" else run.pretrain
    source = earlier["finetune", fold] if kind == "test" else \
        earlier["pretrain"]
    if os.path.join(cwd, read) != os.path.join(source.directory, "model"):
        fail(f"{label}: reads {read}, not {source.directory}/model")
    if kind == "finetune":
        if f"=> loaded pretrained checkpoint '{read}'" not in stage.log:
            fail(f"{label}: no graft of {read} in its log")
        check_graft(torch, dataclasses.replace(stage.config, run=(
            dataclasses.replace(run, pretrain=os.path.join(cwd, read)))),
            f"{label}, graft")
        for key in CLASSIFIER_METRICS:
            if not math.isfinite(stage.result.get(key, math.nan)):
                fail(f"{label}: {key} missing or not finite: {stage.result}")
        saved_checkpoint(torch, label, stage)
    elif kind == "test":
        if f"=> loaded test checkpoint '{read}'" not in stage.log:
            fail(f"{label}: no test checkpoint {read} in its log")
        saved = saved_checkpoint(torch, f"{label}, its finetune", source)
        ran = tested.get(read, {})
        if set(ran) != set(saved) or not all(
                torch.equal(ran[k], saved[k]) for k in saved):
            fail(f"{label}: the state tested is not the finetune's saved "
                 "state bitwise")
        if not 0.0 <= stage.result["top1"] <= 1.0:
            fail(f"{label}: top1 {stage.result}")
    else:
        values = list(stage.result.values())
        if len(values) != 5 or not all(
                math.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
            fail(f"{label}: R@k {stage.result}")
        feat = os.path.join(stage.directory, stage.config.dirname)
        missing = [f for f in RETRIEVAL_DUMPS
                   if not os.path.exists(os.path.join(feat, f))]
        if missing:
            fail(f"{label}: no {missing} under {feat}")


def run_path_p(torch, log_root: str) -> dict:
    """Path P: each chain of ``scripts/paper_torch/`` recorded from its
    ``run.sh`` with ``DATA_ROOT``, ``DB_PATH`` and ``EXP_NAME`` unset (what
    the JAX chains cannot run) and replayed in this process in a fresh
    directory (``tools/paper_chain.py``) with ``PATH_P_ARGV``: pretrain,
    finetune and temporal ten-clip test on UCF101 and on HMDB51, retrieval.
    Every stage is held to ``check_chain_stage``; ``aug_fused`` launches
    once a train step, ``PATH_P_STEPS`` in the pretrain and in each
    finetune, and no kernel in a test. Returns each chain's counts."""
    from dualvar_tpu_torch.tools import paper_chain as PC

    by_run, start = {}, time.perf_counter()
    for chain in PC.CHAINS:
        stages = PC.chain_commands(chain)
        cwd = os.path.join(log_root, "path_p", chain)
        os.makedirs(cwd)
        counters = kernel_counters()
        for wrapper in counters.values():
            wrapper.launches = 0
        tic = time.perf_counter()
        with tested_states() as tested:
            done = PC.run_chain(stages, PATH_P_ARGV, cwd, counters)
        torch.cuda.synchronize()
        took = time.perf_counter() - tic
        launches = {name: w.launches for name, w in counters.items()}
        kinds = tuple(stage_kind(s) for s in done)
        if kinds != CHAIN_STAGES:
            fail(f"path P, {chain}: stages {kinds}, not {CHAIN_STAGES}")
        earlier = {}
        for stage, kind in zip(done, CHAIN_STAGES):
            name = PC.stage_name(stage.module, stage.argv)
            label = f"path P, {chain}: {name}"
            check_chain_stage(torch, label, stage, cwd, earlier, tested)
            if kind == "pretrain":
                earlier["pretrain"] = stage
            elif kind == "finetune":
                earlier["finetune", os.path.basename(stage.directory)] = stage
            shown = {k: v for k, v in stage.result.items()
                     if k != "classwise"}
            print(f"{label}: {stage.seconds:.2f} s, launches="
                  + json.dumps({k: v for k, v in stage.launches.items()
                                if v}) + ", " + json.dumps(shown),
                  flush=True)
        want = expected_launches(aug_fused=PATH_P_STEPS * sum(
            kind in ("pretrain", "finetune") for kind in CHAIN_STAGES))
        if launches != want:
            fail(f"path P, {chain}: launches {launches}, expected {want}")
        print(f"path P, {chain}: {len(done)} stages in {took:.2f} s, "
              f"launches=" + json.dumps(launches), flush=True)
        by_run[f"path P, {chain}"] = launches
    print(f"path P: {len(PC.CHAINS)} chains in "
          f"{time.perf_counter() - start:.2f} s", flush=True)
    return by_run


# path D: data parallel across processes. The card is one, so the group
# is of one process over NCCL: every collective runs, on the real backend
PATH_D_STEPS = 3
PATH_D_MOCO_VIDEOS = 16
# path D's MoCo run in the BN-shuffle mode: --moco_shuffle_bn
SHUFFLE_BN_GROUPS = 2
# batch norms of R(2+1)D-18: the stem's two, two a (2+1)D conv, and the
# shortcuts'
R2P1D_BATCH_NORMS = 24


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def process_group(torch):
    """This process as rank 0 of a group of one over NCCL, joined through
    ``init_distributed`` from the environment torchrun would set; left and
    the environment cleared after the block."""
    from dualvar_tpu_torch.core import dist

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    try:
        if not dist.init_distributed("cuda"):
            fail("path D: init_distributed did not join a group")
        if torch.distributed.get_backend() != "nccl":
            fail(f"path D: backend {torch.distributed.get_backend()}, not "
                 "nccl")
        yield dist
    finally:
        dist.destroy()
        for k in env:
            os.environ.pop(k, None)


def path_d_cfg(log_root: str):
    """The torchrun run's configuration, for a run in this process (its
    own directory: the main path's store holds a later iteration)."""
    cfg = smoke_cfg("paper_table1_k400", 8, log_root)
    return cfg.replace(run=dataclasses.replace(
        cfg.run, name_prefix="chip_smoke_path_d_single"))


def run_torchrun(torch, log_root: str) -> tuple[dict, dict]:
    """``python -m torch.distributed.run --standalone --nproc_per_node 1``
    of the pretrain CLI, ``paper_table1_k400`` on synthetic frames at B=8
    for ``PATH_D_STEPS`` steps with ``DUALVAR_BN_STATS=pallas``; returns its
    last checkpoint and the losses its log printed for the last step (3
    decimals). A non-zero exit fails."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    cwd = os.path.join(log_root, "torchrun")
    os.makedirs(cwd)
    env = {k: v for k, v in os.environ.items()
           if k not in ("DUALVAR_BN_STATS", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = here
    env["DUALVAR_BN_STATS"] = "pallas"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "dualvar_tpu_torch.train.pretrain",
           "--preset", "paper_table1_k400", "--synthetic", "1",
           "--batch_size", "8", "--max_steps", str(PATH_D_STEPS),
           "--print_freq", "1", "--name_prefix", "path_d"]
    tic = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        fail("path D: the torchrun launch did not end in 300 s:\n"
             + out[-3000:])
    if proc.returncode != 0:
        fail(f"path D: the torchrun launch exited {proc.returncode}:\n"
             + out[-3000:])
    if "Effective batch = 8 (1 processes x 8)" not in out:
        fail("path D: the torchrun launch logged no effective batch of 8:\n"
             + out[-3000:])
    import re

    from dualvar_tpu_torch.core.checkpoint import checkpoint_file

    ckpt = torch.load(checkpoint_file(os.path.join(
        cwd, "log", "paper_table1_k400", "pretrain", "path_d", "model")),
        map_location="cpu")
    steps = [line for line in out.splitlines()
             if "Epoch:[" in line and "total_loss" in line]
    if len(steps) != PATH_D_STEPS:
        fail(f"path D: the torchrun log has {len(steps)} step lines:\n"
             + out[-3000:])
    losses = {k: float(v) for k, v in
              re.findall(r"(\w+_loss) (-?[0-9.]+)\.", steps[-1])}
    print(f"path D: torchrun --nproc_per_node 1 of the pretrain CLI, "
          f"{PATH_D_STEPS} steps of paper_table1_k400 at B=8, exit 0 in "
          f"{time.perf_counter() - tic:.1f} s; last step's losses "
          + json.dumps(losses), flush=True)
    return ckpt, losses


def check_bn_routes_at_world_one(torch) -> None:
    """Under the group of one, at the shape of path R's first block,
    float32 and bfloat16: the one-pass batch norm with its sums all-reduced
    gives bitwise what it gives without a group (forward and backward);
    ``_SyncBN`` (ATen's SyncBatchNorm functions) is held against float64,
    beside ATen's batch norm."""
    from dualvar_tpu_torch.models.layers import _OnePassBN, _SyncBN

    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (16, 64, 16, 56, 56)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = torch.rand(64, generator=gen, device="cuda") + 0.5
        b = torch.randn(64, generator=gen, device="cuda")

        def run(fn, *extra):
            xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
            y, mean, var = fn(xs, ws, bs, 1e-5, *extra)
            y.backward(g)
            return [y, mean, var, xs.grad, ws.grad, bs.grad]

        synced, plain = run(_OnePassBN.apply, True), run(_OnePassBN.apply,
                                                         False)
        if not all(torch.equal(a, c) for a, c in zip(synced, plain)):
            fail(f"path D: the one-pass batch norm at world size 1 differs "
                 f"from its unsynced result ({dtype}): " + ", ".join(
                     f"{float((a.float() - c.float()).abs().max()):.3g}"
                     for a, c in zip(synced, plain)))

        def aten(xs, ws, bs, eps):
            y, mean, invstd = torch.native_batch_norm(
                xs, ws, bs, None, None, True, 0.0, eps)
            return y, mean, invstd.pow(-2) - eps

        ref = bn_reference_float64(torch, x, w, b, g)
        names = ("y", "mean", "var", "dx", "dweight", "dbias")
        errs = {}
        def sync_bn(*args):  # (y, mean, var) of its five outputs
            return _SyncBN.apply(*args)[:3]

        for route, outs in (("_SyncBN", run(sync_bn)), ("ATen", run(aten))):
            for name, a, c in zip(names, outs, ref):
                scale = float(c.abs().max())
                err = float((a.detach().double() - c).abs().max())
                errs[f"{route} {name}"] = err / scale
                # float32: 1e-5 of the scale (measured under 1e-6); bf16:
                # one ulp of it: y and dx are stored in bf16, and ATen's
                # SyncBatchNorm functions round g*(x - mean) to the input's
                # type before they sum it
                tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
                if route == "_SyncBN" and not err <= tol * scale:
                    fail(f"path D: _SyncBN {name} ({dtype}) is {err:.3g} "
                         f"from float64, more than {tol:.3g} of {scale:.3g}")
        print(f"path D: {dtype} at {shape}: one-pass synced == unsynced "
              "bitwise; error over the scale against float64: " + ", ".join(
                  f"{k} {v:.2g}" for k, v in errs.items()), flush=True)


def bn_reference_float64(torch, x, w, b, g) -> list:
    """Train-mode batch norm of ``x`` and its backward of ``g`` in float64:
    y, mean, biased var, dx, dweight, dbias."""
    x, g = x.double(), g.double()
    dims = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    var, mean = torch.var_mean(x, dim=dims, correction=0)
    inv = torch.rsqrt(var + 1e-5)
    xhat = (x - mean.view(shape)) * inv.view(shape)
    wd = w.double().view(shape)
    y = xhat * wd + b.double().view(shape)
    dbias = g.sum(dims)
    dweight = (g * xhat).sum(dims)
    n = x.numel() // x.shape[1]
    dx = wd * inv.view(shape) * (g - dbias.view(shape) / n
                                 - xhat * dweight.view(shape) / n)
    return [y, mean, var, dx, dweight, dbias]


def run_path_d(torch, log_root: str, r_state: dict) -> dict:
    """Path D. The torchrun launch of the pretrain CLI against the same
    steps in this process without a group. Then, in this process as a
    group of one over NCCL (the launch counters live here): the batch
    norms' routes at world size 1, path R under ``DUALVAR_BN_STATS=pallas``
    (``channel_sums`` 24 a step, its running statistics against path R's
    without a group), one MoCo epoch in mode clip-sr-dtw (the pointer moves
    by B a step; soft-DTW twice a step); the collectives a step and the step
    time of ``paper_table1_k400`` at B=8 and 32 with the group, beside the
    same without it."""
    from dualvar_tpu_torch.core import dist

    by_run = {}
    with process_group(torch):
        check_bn_routes_at_world_one(torch)
    d_ckpt, d_losses = run_torchrun(torch, log_root)
    cfg = path_d_cfg(log_root)
    with bn_stats_env(True):
        _, by_run["path D, one process"] = run_path(
            torch, "path D, one process", cfg, PATH_D_STEPS,
            expected_launches(aug_fused=PATH_D_STEPS, channel_sums=2 * 2
                              * R2P1D_BATCH_NORMS * PATH_D_STEPS),
            TSV4_LOSSES)
    s_losses = dict(LAST_METRICS)
    from dualvar_tpu_torch.core.checkpoint import checkpoint_file

    single = torch.load(checkpoint_file(os.path.join(
        trainer_of(cfg).set_path(cfg), "model")), map_location="cpu")
    if d_ckpt["iteration"] != PATH_D_STEPS or len(d_ckpt["generators"]) != 1:
        fail(f"path D: torchrun checkpoint at iteration "
             f"{d_ckpt['iteration']} with {len(d_ckpt['generators'])} "
             "generator states")
    if not torch.equal(d_ckpt["generators"][0], single["generator"]):
        fail("path D: rank 0's generator did not draw what one process "
             "draws")
    # at world size 1 the one-pass batch norm's all-reduces, the losses'
    # gathers and the gradient's average are identities, so the runs are
    # the same arithmetic: bitwise (tolerance 0)
    differ = [k for k, v in single["state_dict"].items()
              if not torch.equal(d_ckpt["state_dict"][k], v)]
    if differ:
        fail(f"path D: {len(differ)} of {len(single['state_dict'])} state "
             f"entries of the torchrun run differ from one process's, e.g. "
             f"{differ[:3]}")
    for key, got in d_losses.items():  # its log prints 3 decimals
        if not abs(got - s_losses[key]) <= 5e-4 + 1e-6:
            fail(f"path D: torchrun's last {key} {got} against one "
                 f"process's {s_losses[key]}")
    print(f"path D: every state entry ({len(single['state_dict'])}) of the "
          f"torchrun run bitwise as one process's after {PATH_D_STEPS} "
          "steps, rank 0's generator state too; its last losses as logged: "
          + json.dumps(d_losses), flush=True)

    for batch_size in (8, 32):
        time_train_steps(torch, smoke_cfg("paper_table1_k400", batch_size,
                                          log_root),
                         windows=5 if batch_size == 8 else 3)
    with process_group(torch):
        r_cfg = path_r_cfg(8, log_root)
        r_cfg = r_cfg.replace(run=dataclasses.replace(
            r_cfg.run, name_prefix=r_cfg.run.name_prefix + "_path_d"))
        with bn_stats_env(True):
            dist.collectives.clear()
            state, by_run["path D, path R"] = run_path(
                torch, "path D, path R", r_cfg, TRAIN_STEPS,
                expected_launches(
                    aug_fused=TRAIN_STEPS,
                    channel_sums=2 * R3D_BATCH_NORMS * TRAIN_STEPS),
                ("clip_loss",))
        print("path D, path R: collectives in the run "
              f"({TRAIN_STEPS} steps, setup and saves included): "
              + json.dumps(dict(dist.collectives)), flush=True)
        stats = [k for k in r_state if "running_" in k]
        if not all(torch.equal(state[k], r_state[k]) for k in stats):
            fail("path D, path R: the one-pass running statistics differ "
                 "from path R's without a group")
        print(f"path D, path R: the {len(stats)} running statistics bitwise "
              "as path R's without a group", flush=True)

        m_cfg = smoke_cfg(MOCO_PRESET, 8, log_root, mode="clip-sr-dtw")
        m_cfg = m_cfg.replace(
            data=dataclasses.replace(m_cfg.data,
                                     synthetic_videos=PATH_D_MOCO_VIDEOS),
            optim=dataclasses.replace(m_cfg.optim, epochs=1),
            run=dataclasses.replace(m_cfg.run, name_prefix=m_cfg.run
                                    .name_prefix + "_path_d"))
        steps = PATH_D_MOCO_VIDEOS // 8
        m_state, by_run["path D, MoCo epoch"] = run_path(
            torch, "path D, MoCo epoch", m_cfg, steps,
            expected_launches(aug_fused=steps, soft_dtw_fwd=2 * steps,
                              soft_dtw_bwd=2 * steps), TSV4_LOSSES)
        check_moco_state(torch, "path D, MoCo epoch", m_cfg, m_state, steps)

        for batch_size in (8, 32):
            time_train_steps(torch, smoke_cfg("paper_table1_k400",
                                              batch_size, log_root),
                             windows=5 if batch_size == 8 else 3)
    by_run["path D, MoCo shuffle BN"] = check_shuffle_bn_at_world_one(
        torch, log_root)
    return by_run


def check_shuffle_bn_at_world_one(torch, log_root: str) -> dict:
    """``--moco_shuffle_bn 2`` in this process as a group of one: the
    distributed BN-shuffle route (key views gathered, rank 0's permutation
    broadcast, the groups' running statistics all-reduced, the keys
    gathered back) for one epoch of MoCo at B=8 under
    ``DUALVAR_BN_STATS=pallas``, against the same epoch without a group:
    every state entry (queues, pointer, both encoders and their running
    statistics) and every logged metric bitwise; the collectives of a step
    by kind (``time_train_steps`` in the group)."""
    from dualvar_tpu_torch.core import dist

    cfg = smoke_cfg(MOCO_PRESET, 8, log_root,
                    moco_shuffle_bn=SHUFFLE_BN_GROUPS)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data,
                                 synthetic_videos=PATH_D_MOCO_VIDEOS),
        optim=dataclasses.replace(cfg.optim, epochs=1))
    steps = PATH_D_MOCO_VIDEOS // 8
    runs = {}
    for label in ("group", "one process"):
        run_cfg = cfg.replace(run=dataclasses.replace(
            cfg.run, name_prefix=f"{cfg.run.name_prefix}_shuffle_bn_"
                                 f"{label.replace(' ', '_')}"))
        group = (process_group(torch) if label == "group"
                 else contextlib.nullcontext())
        with group, bn_stats_env(True):
            # channel_sums: the query and dual passes' batch norms forward
            # and backward, the key pass's forward once a group
            state, launches = run_path(
                torch, f"path D, MoCo shuffle BN, {label}", run_cfg, steps,
                expected_launches(aug_fused=steps, channel_sums=(
                    2 * 2 + SHUFFLE_BN_GROUPS) * R2P1D_BATCH_NORMS * steps),
                TSV4_LOSSES)
            runs[label] = (state, dict(LAST_METRICS), launches)
            if label == "group":
                if dist.world_size() != 1 or not dist.active():
                    fail("path D, MoCo shuffle BN: not in a group of one")
                time_train_steps(torch, cfg, n=5)
    (g_state, g_metrics, launches), (s_state, s_metrics, _) = (
        runs["group"], runs["one process"])
    differ = [k for k, v in s_state.items() if not torch.equal(g_state[k], v)]
    if differ or g_metrics != s_metrics:
        fail(f"path D, MoCo shuffle BN: {len(differ)} of {len(s_state)} "
             f"state entries differ from one process's (e.g. {differ[:3]}); "
             f"metrics {g_metrics} against {s_metrics}")
    check_moco_state(torch, "path D, MoCo shuffle BN", cfg, g_state, steps)
    print(f"path D, MoCo shuffle BN: every state entry ({len(s_state)}: "
          "queues, pointer, both encoders, running statistics) and every "
          "logged metric bitwise as one process's", flush=True)
    return launches


# --------------------------------------------------------------------------
# the learning check
# --------------------------------------------------------------------------

# steps of the learning checks where they are not the tool's (the JAX
# scripts') own: the JPEG tree's 60 leave the loss at chance's edge in both
# packages (the port 3.227 on the card; the JAX package 3.272 on its TPU,
# PARITY.md's round-5 record, which passed at 160 steps: 2.711), so it runs
# the 160 steps that record passed at, against the same pass condition
LEARNING_STEPS = {"real_files": 160}


def run_learning(torch, log_root: str) -> dict:
    """``dualvar_tpu_torch/tools/learning_check.py``'s four checks on the
    card at their full configurations and pass conditions (SimCLR naked
    and TimeSeriesV4 300 steps, the classifier 360, the JPEG tree 160:
    ``LEARNING_STEPS``): the loss every 20 steps on lines of its own, each
    check's record; a check that does not pass fails the run."""
    from dualvar_tpu_torch.tools import learning_check as LC

    out = {}
    for name in LC.CHECKS:
        record = LC.run_check(name, steps=LEARNING_STEPS.get(name),
                              device="cuda",
                              log_root=os.path.join(log_root, "learning",
                                                    name))
        record.pop("log_root")
        LC.print_record(record)
        if not record["passed"]:
            fail(f"learning: {name} did not pass ({record['metric']} "
                 f"{record['final']}, pass condition {record['condition']})")
        out[name] = {k: record[k] for k in ("final", "condition", "steps",
                                            "seconds")}
    return out


# --------------------------------------------------------------------------
# path K: the soaks
# --------------------------------------------------------------------------

# the SimCLR soak's length, and the MoCo soak's: at least one wrap of the
# K=16384 queue is 512 steps at B=32, 153 s at the 298 ms a step measured
# on an H100, so 3 minutes wrap it once with 18 % to spare
SOAK_MINUTES = 1.0
MOCO_SOAK_MINUTES = 3.0
# a queue row's distance from unit norm, float32 keys
QUEUE_NORM_TOL = 1e-3


def check_soak(label: str, record: dict, details: dict) -> None:
    """What fails a soak: a non-finite loss, replays that are not bitwise
    each other and the live steps after the save."""
    losses = [record["first_loss"], record["last_loss"],
              *(o if isinstance(o, float) else o[0]
                for o in details["live"])]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: a loss is not finite: {losses}")
    if not details["replays_agree"]:
        fail(f"{label}: the two replays of the checkpoint differ: "
             f"{details['replays']}")
    if not details["replays_match_live"]:
        fail(f"{label}: the replays {details['replays'][0]} are not the "
             f"live steps after the save {details['live']}")


def run_soak_paths(torch, log_root: str) -> dict:
    """Path K: ``tools/soak.py`` (SimCLR on R3D-18, B=128, 16x112x112,
    bf16) for ``SOAK_MINUTES`` and ``tools/moco_soak.py`` (the
    ``paper_table2_moco_r21d`` step at B=32, K=16384) for
    ``MOCO_SOAK_MINUTES``, on the card, with every launch count set to 0
    just before each and read just after: ``aug_fused`` once a step (the
    live steps and the replays), every other kernel 0. Fails on a
    non-finite loss, a replay that is not bitwise, a wrong pointer, a queue
    row off unit norm by more than ``QUEUE_NORM_TOL``, a non-finite key
    encoder, or no wrap of the queue. Prints both records and their
    details."""
    from dualvar_tpu_torch.tools import moco_soak as MS
    from dualvar_tpu_torch.tools import soak as S

    counters = kernel_counters()
    out = {}
    for label, run, minutes in (
            ("path K, SimCLR soak", S.run_soak, SOAK_MINUTES),
            ("path K, MoCo soak", MS.run_moco_soak, MOCO_SOAK_MINUTES)):
        for wrapper in counters.values():
            wrapper.launches = 0
        tic = time.perf_counter()
        record, details = run(minutes=minutes, device="cuda",
                              ckpt_dir=os.path.join(log_root, "soak_ckpt"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - tic
        launches = {name: w.launches for name, w in counters.items()}
        steps = record["steps"] + S.REPLAYS * S.REPLAY_STEPS
        print(f"{label}: {seconds:.1f} s, {steps} steps (the replays "
              "included), launches a step " + json.dumps(
                  {k: v / steps for k, v in launches.items()}), flush=True)
        print(f"{label}: details " + json.dumps(details), flush=True)
        print(f"{label}: record " + json.dumps(record), flush=True)
        check_soak(label, record, details)
        if launches != expected_launches(aug_fused=steps):
            fail(f"{label}: launches {launches} in {steps} steps, expected "
                 "aug_fused once a step and nothing else")
        if "ptr_ok" in record:
            if not record["ptr_ok"]:
                fail(f"{label}: pointer {record['ptr_actual']}, expected "
                     f"{record['ptr_expected']}")
            if not record["queue_norm_max_dev"] <= QUEUE_NORM_TOL:
                fail(f"{label}: a queue row is {record['queue_norm_max_dev']}"
                     f" off unit norm (tolerance {QUEUE_NORM_TOL})")
            if not record["ema_finite"]:
                fail(f"{label}: the key encoder is not finite")
            if record["queue_wraps"] < 1:
                fail(f"{label}: {record['steps']} steps of B="
                     f"{record['batch_size']} did not wrap the queue")
        out[label] = launches
    return out


# --------------------------------------------------------------------------
# path B: the benches
# --------------------------------------------------------------------------

# tools/bench.py: chains and steps a chain; every objective unit, backbone,
# eval net and breakdown segment: one chain of BENCH_SWEEP_STEPS steps
BENCH_CHAINS, BENCH_STEPS = 2, 10
BENCH_SWEEP_STEPS = 5
# perf_breakdown's segments that step_breakdown's do not repeat
PERF_BREAKDOWN_SEGMENTS = ("aug_fwd", "step_b256")


def check_bench_record(label: str, rec: dict, launches: dict,
                       aug_launches: int, flops: bool = True) -> None:
    """What fails a bench record: an error (no batch fits), a chain time
    that is not positive, a non-finite loss or output, a record without
    ``step_tflops`` and ``mfu_pct`` (with ``flops``), and launches other
    than ``aug_launches`` of ``aug_fused`` at the batch that fit and none
    of another kernel. A batch that ran out of memory adds the steps it
    started, its last one with or without its launch (the allocation that
    failed may come before the kernel)."""
    if "error" in rec:
        fail(f"{label}: {rec['error']} (did not fit: {rec['did_not_fit']})")
    if not all(ms > 0 for ms in rec["chains_ms"]):
        fail(f"{label}: a chain took {rec['chains_ms']} ms a step")
    value = rec.get("output_finite", rec.get(
        "final_loss", rec.get("loss", rec.get("output"))))
    if value is not True and not (isinstance(value, float)
                                  and math.isfinite(value)):
        fail(f"{label}: the loss or output is not finite ({value})")
    if flops and (rec.get("step_tflops") is None
                  or rec.get("mfu_pct") is None):
        fail(f"{label}: no step_tflops / mfu_pct in {rec}")
    low = high = aug_launches
    if aug_launches:
        high += rec["oom_steps"]
        low = high - len(rec["did_not_fit"])
    if not low <= launches["aug_fused"] <= high or any(
            n for name, n in launches.items() if name != "aug_fused"):
        fail(f"{label}: launches {launches}, expected aug_fused "
             f"{low}..{high} (steps {rec['steps']}, the batches that did "
             f"not fit {rec['did_not_fit']} with {rec['oom_steps']} steps) "
             "and no other kernel")


def run_bench_phase(torch) -> dict:
    """Path B: each bench tool's function on the card at full width
    (16x112x112 clips from 171x128 frames, bf16 autocast), with every
    launch count set to 0 just before each call and read just after:
    ``tools/bench.py`` (R3D-18 SimCLR at B=128, ``BENCH_CHAINS`` chains of
    ``BENCH_STEPS``), every unit of ``tools/objective_bench.py``, every
    net of ``tools/backbone_bench.py`` and ``tools/eval_bench.py`` at the
    largest batch that fits, and the breakdowns' segments, one chain of
    ``BENCH_SWEEP_STEPS`` each. Checks every record
    (``check_bench_record``) and prints it with its launches; returns the
    launches summed over the phase."""
    from dualvar_tpu_torch.tools import backbone_bench as BB
    from dualvar_tpu_torch.tools import bench as BN
    from dualvar_tpu_torch.tools import eval_bench as EB
    from dualvar_tpu_torch.tools import objective_bench as OB
    from dualvar_tpu_torch.tools import perf_breakdown as PB
    from dualvar_tpu_torch.tools import step_breakdown as SB

    counters = kernel_counters()
    total = dict.fromkeys(counters, 0)
    tic = time.perf_counter()

    def call(label, fn, aug=lambda rec: rec["steps"], flops=True):
        for wrapper in counters.values():
            wrapper.launches = 0
        start = time.perf_counter()
        rec = fn()
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in counters.items()}
        print(f"path B, {label}: {time.perf_counter() - start:.1f} s, "
              f"launches {json.dumps(launches)}, record {json.dumps(rec)}",
              flush=True)
        check_bench_record(f"path B, {label}", rec, launches, aug(rec),
                           flops)
        for name, n in launches.items():
            total[name] += n
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    # the forward's count augments one more batch outside the steps
    call("bench", lambda: BN.run_bench(steps=BENCH_STEPS,
                                       chains=BENCH_CHAINS,
                                       device="cuda")[0],
         aug=lambda rec: rec["steps"] + 1)
    for name in OB.UNITS:
        call(f"objective {name}", lambda: OB.bench_unit(
            name, BENCH_SWEEP_STEPS, 1, "cuda"))
    for net in BB.CANDIDATES:
        call(f"backbone {net}", lambda: BB.bench_net(
            net, BENCH_SWEEP_STEPS, 1, device="cuda"))
    for net in EB.CANDIDATES:
        call(f"eval {net}", lambda: EB.bench_net(
            net, BENCH_SWEEP_STEPS, 1, device="cuda"),
             aug=lambda rec: 0, flops=False)
    plan = SB.plan() + [s for s in PB.plan()
                        if s[0] in PERF_BREAKDOWN_SEGMENTS]
    for segment in plan:
        # fwd and fwdloss augment once, for their resident block
        call(f"breakdown {segment[0]}", lambda: SB.run_segments(
            [segment], BENCH_SWEEP_STEPS, 1, "cuda")[0],
             aug=(lambda rec: 1) if segment[1] in ("fwd", "fwdloss")
             else (lambda rec: rec["steps"]),
             flops=segment[1] != "aug")
    print(f"path B: {time.perf_counter() - tic:.1f} s, launches "
          + json.dumps(total), flush=True)
    return {"path B": total}


# --------------------------------------------------------------------------
# path V: the backbone registry's variants
# --------------------------------------------------------------------------

VARIANT_NETS = ("r21d_pad128", "r21d_tiled", "s3d_packed", "s3dg_packed")
# R(2+1)D-18's 24 batch norms, each one forward and one backward
# channel_sums call in each of a TimeSeriesV4 step's two backbone passes
R21D_SUMS_PER_STEP = 2 * 2 * 24
# r21d_pad128 embedded from an r21d state against r21d, one float32 step
# on the same frames and draws, TF32 off: the same function, its padded
# reductions regrouping float32 sums (the CPU tests: 1e-5 at 8x32x32); the
# f32 check's loss tolerance
EMBED_LOSS_ATOL = 1e-4
# s3dg_packed packed from an s3dg state: the forward in float32 (TF32 off)
# against the standard one, relative to the largest |feature|; the packed
# convs have other shapes, so cuDNN sums in another order. Eval mode: 1e-4.
# Train mode (batch statistics, no gradient), where S3D-G's 77 batch norms
# divide by batch deviations and carry the conv rounding along: 1e-3, the
# JAX package's measured float32 spread of its own packed against standard
# network in train mode (dualvar_tpu/models/backbones/s3dg.py tests).
PACKED_REL_TOL = {"eval": 1e-4, "train": 1e-3}


def pad_block_values(torch, model, state: dict, momentum: dict) -> tuple:
    """The pad blocks of ``model``'s r21d_pad128 (``r21d.pad_blocks``) in a
    ``state`` dict and in the momentum buffers (``momentum``: parameter
    name -> buffer): (blocks, values that are not +0.0 bitwise, values)."""
    from dualvar_tpu_torch.models.backbones.r21d import pad_blocks

    blocks = pad_blocks(model)
    bad = total = 0
    for key, index in blocks.items():
        for t in (state[key], momentum.get(key)):
            if t is None:
                continue
            block = t[index].detach().contiguous()
            bad += int(block.view(torch.int32).ne(0).sum())
            total += block.numel()
    return len(blocks), bad, total


def check_pad_blocks_saved(torch, label: str, cfg) -> None:
    """Every pad block of the r21d_pad128 run's newest checkpoint, in the
    weights, the running means and the momentum buffers, bitwise zero."""
    from dualvar_tpu_torch.core.checkpoint import checkpoint_file
    from dualvar_tpu_torch.train.pretrain import build_task, set_path

    ckpt = torch.load(checkpoint_file(os.path.join(set_path(cfg), "model")),
                      map_location="cpu")
    model = build_task(cfg).model
    names = [n for n, _ in model.named_parameters()]
    momentum = {names[i]: st["momentum_buffer"]
                for i, st in ckpt["optimizer"]["state"].items()}
    blocks, bad, total = pad_block_values(torch, model, ckpt["state_dict"],
                                          momentum)
    print(f"{label}: {blocks} pad blocks (weights, batch-norm biases and "
          f"running means, momentum buffers): {total} values, {bad} not "
          "+0.0", flush=True)
    if blocks != 44 or bad or not total:
        fail(f"{label}: the pad blocks are not bitwise zero after "
             f"{ckpt['iteration']} steps")


def check_embedded_pad128_step(torch, log_root: str, r21d_state: dict):
    """The main path's r21d state embedded into r21d_pad128
    (``embed_formula_state``): one float32 train step (TF32 off) of each on
    the same frames and generator, losses within ``EMBED_LOSS_ATOL``; the
    pad blocks bitwise zero after it."""
    from dualvar_tpu_torch.models.backbones.r21d import embed_formula_state
    from dualvar_tpu_torch.train.pretrain import setup_training

    old = tf32_off(torch)
    losses = {}
    for net in ("r21d", "r21d_pad128"):
        cfg = smoke_cfg("paper_table1_k400", 8, log_root, net=net,
                        dtype="float32")
        setup = setup_training(cfg, "cuda")
        state = r21d_state if net == "r21d" else embed_formula_state(
            r21d_state, setup.model.state_dict())
        setup.model.load_state_dict(state)
        with setup.loader as loader:
            frames = torch.from_numpy(next(loader.epoch(0))["frames"])
        metrics = setup.train_step(frames.to("cuda"), setup.generator)
        losses[net] = {k: float(v) for k, v in metrics.items()
                       if k.endswith("loss")}
        if net == "r21d_pad128":
            momentum = {n: setup.optimizer.state[p]["momentum_buffer"]
                        for n, p in setup.model.named_parameters()}
            blocks, bad, total = pad_block_values(
                torch, setup.model, setup.model.state_dict(), momentum)
        del setup
    tf32_restore(torch, old)
    err = max(abs(losses["r21d"][k] - v)
              for k, v in losses["r21d_pad128"].items())
    print("path V r21d_pad128 embedded from the main path's r21d state, one "
          "float32 step (TF32 off): losses " + json.dumps(losses)
          + f", max difference {err:.3e} (atol {EMBED_LOSS_ATOL}); pad "
          f"blocks after it: {total} values, {bad} not +0.0", flush=True)
    if set(losses["r21d"]) != set(losses["r21d_pad128"]) \
            or not err <= EMBED_LOSS_ATOL or bad or blocks != 44:
        fail("path V: the embedded r21d_pad128 step is not the r21d step")


def check_packed_s3dg(torch, g_state: dict) -> None:
    """Path G's S3D-G backbone packed into s3dg_packed
    (``pack_s3d_params``): the eval and the train-mode forward on the card
    in float32 (TF32 off) against the standard one on the same clips,
    within ``PACKED_REL_TOL`` of the largest |feature|."""
    from dualvar_tpu_torch.models.backbones import select_backbone
    from dualvar_tpu_torch.models.backbones.s3dg import pack_s3d_params

    backbone = {k[len("backbone."):]: v for k, v in g_state.items()
                if k.startswith("backbone.")}
    standard, _ = select_backbone("s3dg")
    standard.load_state_dict(backbone)
    packed, _ = select_backbone("s3dg_packed")
    packed.load_state_dict(pack_s3d_params(backbone))
    x = torch.randn(8, 3, 16, 112, 112,
                    generator=torch.Generator().manual_seed(5)).to("cuda")
    standard.to("cuda")
    packed.to("cuda")
    old = tf32_off(torch)
    errs = {}
    for mode in ("eval", "train"):
        with torch.no_grad():
            want = standard.train(mode == "train")(x)
            got = packed.train(mode == "train")(x)
        scale = float(want.abs().max())
        errs[mode] = float((got - want).abs().max()) / scale
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"path V s3dg_packed: {mode} forward {tuple(got.shape)} "
                 "or not finite")
        print(f"path V s3dg_packed packed from path G's S3D-G: {mode} "
              f"forward {tuple(got.shape)}, max |difference| "
              f"{errs[mode]:.3e} of the largest |feature| {scale:.4g} "
              f"(tolerance {PACKED_REL_TOL[mode]})", flush=True)
    tf32_restore(torch, old)
    if not all(errs[m] <= PACKED_REL_TOL[m] for m in errs):
        fail("path V: s3dg_packed does not compute s3dg's forward")


def run_path_v(torch, log_root: str, main_state: dict,
               g_state: dict) -> dict:
    """``paper_table1_k400 --net <variant>``, two steps each at B=8
    (``aug_fused`` once a step), then the step time (three windows);
    r21d_pad128 also two steps under ``DUALVAR_BN_STATS=pallas``
    (``channel_sums`` 96 a step) and its pad blocks after both runs; the
    embedded r21d_pad128 step and the packed S3D-G forward."""
    by_run = {}
    for net in VARIANT_NETS:
        cfg = smoke_cfg("paper_table1_k400", 8, log_root, net=net)
        label = f"path V {net}"
        _, by_run[label] = run_path(
            torch, label, cfg, PATH_S_STEPS,
            expected_launches(aug_fused=PATH_S_STEPS), TSV4_LOSSES)
        if net == "r21d_pad128":
            check_pad_blocks_saved(torch, label, cfg)
            pallas = cfg.replace(run=dataclasses.replace(
                cfg.run, name_prefix=cfg.run.name_prefix + "_pallas"))
            with bn_stats_env(True):
                _, by_run[label + ", DUALVAR_BN_STATS=pallas"] = run_path(
                    torch, label + ", DUALVAR_BN_STATS=pallas", pallas,
                    PATH_S_STEPS, expected_launches(
                        aug_fused=PATH_S_STEPS,
                        channel_sums=R21D_SUMS_PER_STEP * PATH_S_STEPS),
                    TSV4_LOSSES)
            check_pad_blocks_saved(torch, label + ", pallas", pallas)
        time_train_steps(torch, cfg, windows=3)
        torch.cuda.empty_cache()
    check_embedded_pad128_step(torch, log_root, main_state)
    check_packed_s3dg(torch, g_state)
    return by_run


# --------------------------------------------------------------------------
# path E: the serving export
# --------------------------------------------------------------------------

SERVE_BATCH = 8
SERVE_REPS = 10
# the artifact against the eager eval path on the same frames, both bf16
# autocast: the same ATen ops; probabilities to 1e-3, logits and features
# to one bf16 ulp at the top of their range (2**-7 of the largest |value|)
SERVE_PROB_ATOL, SERVE_ULP = 1e-3, 2.0 ** -7

# run in a fresh process: torch only
_SERVE = """
import json, statistics, sys, time
import torch
out = {}
for path, frames_path, result_path in json.loads(sys.argv[1]):
    served = torch.export.load(path).module()
    frames = torch.load(frames_path).to("cuda")
    times = []
    with torch.inference_mode():
        for i in range(%d + 2):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            result = served(frames)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - tic) * 1e3)
    torch.save([r.cpu() for r in result], result_path)
    out[path] = statistics.median(times[2:])
bad = sorted(m for m in sys.modules if m.startswith("dualvar_tpu"))
assert not bad, bad
print(json.dumps(out))
""" % SERVE_REPS


def run_path_e(torch, log_root: str, clf_cfg) -> dict:
    """Path C's finetuned checkpoint exported by ``python -m
    dualvar_tpu_torch.export`` (its ``main``, on the card) at B=8, single
    clip and ten clips; both artifacts loaded and run in one fresh process
    that imports torch only, against the eager eval path
    (``export.make_serving_fn``, bf16 as the preset) on the same frames.
    Prints the export's wall time, the artifact's bytes and the served
    and eager ms a batch; no kernel is launched (the eval path has none).
    Returns the launch counts."""
    from dualvar_tpu_torch import export
    from dualvar_tpu_torch.aug.pipeline import AugConfig
    from dualvar_tpu_torch.core.checkpoint import load_state_dict
    from dualvar_tpu_torch.core.config import CLASSIFIER_PRESETS
    from dualvar_tpu_torch.train import classifier as clf
    from dualvar_tpu_torch.train.pretrain import _AUTOCAST

    counters = kernel_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    cfg = CLASSIFIER_PRESETS[CLASSIFIER_PRESET]
    ckpt = os.path.join(clf.set_path(clf_cfg), "model")
    model = clf.build_model(cfg)
    model.load_state_dict(load_state_dict(ckpt))
    model.to("cuda")
    aug = AugConfig(img_dim=cfg.data.img_dim, seq_len=cfg.data.seq_len)
    H0, W0 = cfg.data.scale_hw
    jobs, eager, report = [], {}, {}
    for ten in (False, True):
        name = "ten_clip" if ten else "single_clip"
        out = os.path.join(log_root, f"serving_{name}.pt2")
        tic = time.perf_counter()
        export.main(["--preset", CLASSIFIER_PRESET, "--ckpt", ckpt, "--out",
                     out, "--batch", str(SERVE_BATCH)]
                    + (["--ten_clip"] if ten else []))
        export_s = time.perf_counter() - tic
        frames = torch.randint(
            0, 256, (SERVE_BATCH, cfg.data.seq_len * (10 if ten else 1), H0,
                     W0, 3), dtype=torch.uint8,
            generator=torch.Generator().manual_seed(7 + ten))
        frames_path = os.path.join(log_root, f"frames_{name}.pt")
        torch.save(frames, frames_path)
        fn = export.make_serving_fn(model, aug, ten,
                                    _AUTOCAST[cfg.model.dtype])
        frames = frames.to("cuda")
        times = []
        with torch.no_grad():
            for _ in range(SERVE_REPS + 2):
                torch.cuda.synchronize()
                tic = time.perf_counter()
                result = fn(frames)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - tic) * 1e3)
        eager[out] = [r.float().cpu() for r in result]
        report[name] = {"export_s": export_s,
                        "artifact_bytes": os.path.getsize(out),
                        "input_shape": list(frames.shape),
                        "eager_ms": statistics.median(times[2:])}
        jobs.append((out, frames_path, out + ".result.pt"))
    launches = {n: w.launches for n, w in counters.items()}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    tic = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", _SERVE, json.dumps(jobs)],
                         cwd=log_root, env=env, capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        fail(f"path E: the torch-only process failed:\n{run.stderr[-3000:]}")
    served_ms = json.loads(run.stdout.strip().splitlines()[-1])
    process_s = time.perf_counter() - tic
    for (out, _, result_path), name in zip(jobs, ("single_clip",
                                                  "ten_clip")):
        got = torch.load(result_path)
        errs = []
        for g, w in zip(got, eager[out]):
            if g.shape != w.shape or not torch.isfinite(g).all():
                fail(f"path E {name}: served {tuple(g.shape)} against "
                     f"eager {tuple(w.shape)}, or not finite")
            errs.append(float((g.float() - w).abs().max()))
        tol = [SERVE_PROB_ATOL] + [SERVE_ULP * float(w.abs().max())
                                   for w in eager[out][1:]]
        report[name].update(
            served_ms=served_ms[out], output_shapes=[list(g.shape)
                                                     for g in got],
            max_abs_err={"probs": errs[0], "logits": errs[1],
                         "feat": errs[2]},
            tolerance={"probs": tol[0], "logits": tol[1], "feat": tol[2]})
        if not all(e <= t for e, t in zip(errs, tol)):
            fail(f"path E {name}: served outputs off the eager eval path: "
                 + json.dumps(report[name]))
    print(f"path E: torch-only serving process {process_s:.1f} s (no "
          "dualvar_tpu module imported there), " + json.dumps(report),
          flush=True)
    if launches != expected_launches():
        fail(f"path E launched kernels: {launches}")
    return launches


def check_features_on_card(torch, log_root: str, tsv4_state: dict,
                           moco_state: dict) -> None:
    """``get_features`` of the main path's TSV4 and path M's MoCo (query
    encoder) on R(2+1)D-18, float32 with TF32 off, card against CPU on the
    same weights and clips: four finite (B, T', H', W') maps each, the
    shapes the CPU gives, within ``FEATURE_F32_ATOL``. ``visualize`` runs in
    the CPU tests; it writes PNGs through pillow, which this machine may
    not have."""
    from dualvar_tpu_torch.train.tasks import make_task

    try:
        import PIL
        pillow = f"pillow {PIL.__version__}"
    except ImportError:
        pillow = "no pillow"
    print("visualize: not run by this script; it writes PNGs through "
          "pillow, which a card machine need not have (this one: "
          f"{pillow}); tests/test_torch_port_observe.py runs it on the CPU",
          flush=True)
    x = torch.randn(2, 16, 112, 112, 3,
                    generator=torch.Generator().manual_seed(9))
    old = tf32_off(torch)
    for label, cfg, state in (
            ("TSV4", smoke_cfg("paper_table1_k400", 8, log_root), tsv4_state),
            ("MoCo", smoke_cfg(MOCO_PRESET, 8, log_root, mode="clip-sr-dtw"),
             moco_state)):
        task = make_task(cfg.model)
        task.model.load_state_dict(state)
        want = task.get_features(x)
        task.model.to("cuda")
        got = task.get_features(x.to("cuda"))
        err = max(float((g.cpu() - w).abs().max())
                  for g, w in zip(got, want))
        shapes = [tuple(g.shape) for g in got]
        print(f"get_features {label}: card vs CPU, TF32 off: shapes {shapes}"
              f", max err {err:.3e} (atol {FEATURE_F32_ATOL})", flush=True)
        if len(got) != 4 or shapes != [tuple(w.shape) for w in want] \
                or not all(torch.isfinite(g).all() for g in got) \
                or not err <= FEATURE_F32_ATOL:
            fail(f"get_features {label}: the card's maps are not the CPU's")
    tf32_restore(torch, old)


# --------------------------------------------------------------------------
# path J: the real-data path (JPEG frame tree -> split CSV -> loader)
# --------------------------------------------------------------------------

# a frame tree in the reference layout at UCF101's extracted size: 130
# videos in 2 classes, each longer than the preset's sampler reaches (3
# views of 16 frames at ds 4: a span of 64); 2 go to the validation carve,
# 128 train: 16 steps an epoch at B=8, so that the timed loader window
# (warm-up, timed steps, the lookahead and the loader's prefetch) lies
# inside one epoch
PATH_J_CLASSES = ("ApplyEyeMakeup", "Archery")
PATH_J_VIDEOS = 130
PATH_J_VAL = 2
PATH_J_FRAMES = 72
PATH_J_HW = (240, 320)
PATH_J_QUALITY = 80
PATH_J_STEPS = 3
PATH_J_EPOCH_STEPS = (PATH_J_VIDEOS - PATH_J_VAL) // 8
# timed loader steps after the warm-up steps, inside epoch 0 (train()'s
# loop): the first waits of an epoch cover its first prefetch window
PATH_J_WARMUP_STEPS = 3
PATH_J_TIMED_STEPS = 10


def write_frame_tree(root: str, seed: int = 0) -> tuple[str, str]:
    """``{root}/frames/{class}/{video}/image_%05d.jpg`` (320x240, JPEG
    quality 80, written with PIL from a thread pool: a smooth colour field
    with a little noise, one a video, drifting 3 pixels a frame) and the
    UCF101 split lists of its videos under ``{root}/splits``; returns
    (frame root, split root)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    frames, splits = os.path.join(root, "frames"), os.path.join(root,
                                                                "splits")
    os.makedirs(splits, exist_ok=True)
    rng = np.random.default_rng(seed)
    H, W = PATH_J_HW
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    lines, jobs = [], []
    for v in range(PATH_J_VIDEOS):
        c = v % len(PATH_J_CLASSES)
        cls = PATH_J_CLASSES[c]
        name = f"v_{cls}_g{v:02d}_c01"
        vdir = os.path.join(frames, cls, name)
        os.makedirs(vdir)
        fy, fx, ph = (rng.uniform(0.5, 4.0, 3), rng.uniform(0.5, 4.0, 3),
                      rng.uniform(0, 2 * np.pi, 3))
        base = np.stack([127.5 + 90 * np.sin(
            2 * np.pi * (fy[k] * y / H + fx[k] * x / W) + ph[k])
            for k in range(3)], -1) + rng.integers(-12, 13, (H, W, 3))
        base = base.clip(0, 255).astype(np.uint8)
        jobs += [(base, 3 * i, os.path.join(vdir, f"image_{i + 1:05d}.jpg"))
                 for i in range(PATH_J_FRAMES)]
        lines.append(f"{cls}/{name}.avi {c + 1}")

    def save(job):
        base, shift, path = job
        Image.fromarray(np.roll(base, shift, axis=1)).save(
            path, quality=PATH_J_QUALITY)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(save, jobs))
    with open(os.path.join(splits, "trainlist01.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(splits, "testlist01.txt"), "w") as fh:
        fh.write("\n".join(line.split()[0] for line in lines[:4]) + "\n")
    return frames, splits


def path_j_cfg(log_root: str, index_root: str, frame_root: str,
               fast_decode: bool = False, synthetic: bool = False):
    """``--preset paper_table1_k400 --data_root <index> --db_path <frames>``
    at B=8 (``--fast_decode 1`` if asked); ``synthetic``: the same preset on
    synthetic frames instead."""
    cfg = smoke_cfg("paper_table1_k400", 8, log_root)
    data = dataclasses.replace(
        cfg.data, synthetic=synthetic, data_root=index_root,
        db_path=frame_root, val_size=PATH_J_VAL, fast_decode=fast_decode)
    tag = "synthetic" if synthetic else ("fast" if fast_decode else "exact")
    return cfg.replace(data=data, run=dataclasses.replace(
        cfg.run, name_prefix=f"chip_smoke_path_j_{tag}"))


def time_loader_steps(torch, cfg, steps: int = PATH_J_TIMED_STEPS) -> dict:
    """train()'s loop over epoch 0 of ``cfg``'s own loader (batches placed
    on the card one step ahead, none carried across the epoch's end),
    ``print_freq`` 1 (the loss read back each step): after
    ``PATH_J_WARMUP_STEPS`` steps, the ``Data`` meter's wait a step (the
    host waiting for the next batch), the step's wall ms and the rest of
    the step (wall less wait: the step's dispatch and the read-back, which
    host threads decoding beside it can slow). The window ends at least
    the loader's prefetch depth before the epoch does, so that every timed
    step has the loader in its steady state."""
    setup = trainer_of(cfg).setup_training(cfg, "cuda")
    need = PATH_J_WARMUP_STEPS + steps + 1 + setup.loader.prefetch
    if len(setup.loader) < need:
        fail(f"loader steps of {cfg.run.name_prefix}: {len(setup.loader)} "
             f"steps an epoch, the timed window needs {need}")

    def placed():
        for b in setup.loader.epoch(0):
            yield torch.from_numpy(b["frames"]).to("cuda", non_blocking=True)

    with setup.loader:
        batches = placed()
        lookahead = next(batches, None)
        waits, walls = [], []
        end = time.perf_counter()
        for i in range(PATH_J_WARMUP_STEPS + steps):
            frames, lookahead = lookahead, next(batches, None)
            wait = time.perf_counter() - end
            metrics = setup.train_step(frames, setup.generator)
            loss = metrics["total_loss"].item()
            now = time.perf_counter()
            if i >= PATH_J_WARMUP_STEPS:
                waits.append(wait)
                walls.append(now - end)
            end = now
        batches.close()
    if not math.isfinite(loss):
        fail(f"loader steps of {cfg.run.name_prefix}: total_loss {loss}")
    src = setup.loader.dataset.source
    route = ("synthetic" if cfg.data.synthetic else
             "native" if src.native_batch is not None else "PIL")
    record = {"route": route, "fast_decode": cfg.data.fast_decode,
              "batch_size": cfg.optim.batch_size,
              "steps_per_epoch": len(setup.loader),
              "warmup_steps": PATH_J_WARMUP_STEPS, "steps": steps,
              "workers": cfg.data.workers, "cpu_count": os.cpu_count(),
              "data_wait_ms_per_step": statistics.mean(waits) * 1e3,
              "data_wait_ms_by_step": [w * 1e3 for w in waits],
              "ms_per_step": statistics.mean(walls) * 1e3,
              "ms_by_step": [w * 1e3 for w in walls],
              "step_less_wait_ms_per_step": statistics.mean(
                  w - d for w, d in zip(walls, waits)) * 1e3}
    print("path J loader steps: " + json.dumps(record), flush=True)
    del setup
    torch.cuda.empty_cache()
    return record


def time_decode_routes(cfg) -> dict:
    """ms to decode one B=8 batch of the preset's plans (8 x 48 frames,
    320x240 -> 171x128): PIL one frame at a time on one thread and through
    the loader's worker pool, and the native assembler (exact and fast) with
    the loader's threads where the decoder was built. Median of 5."""
    from dualvar_tpu_torch.data.loader import HostLoader, JpegFrameSource
    from dualvar_tpu_torch.train.pretrain import build_dataset

    dataset = build_dataset(cfg)
    indices = list(range(cfg.optim.batch_size))
    out = {}

    def median_ms(fn, reps=5):
        fn()  # page cache warm: every route reads the same files
        times = []
        for _ in range(reps):
            tic = time.perf_counter()
            fn()
            times.append((time.perf_counter() - tic) * 1e3)
        return statistics.median(times)

    pil = dataclasses.replace(dataset, source=JpegFrameSource(
        cfg.data.db_path, scale=cfg.data.scale_hw, use_native=False))
    with HostLoader(pil, len(indices), num_workers=cfg.data.workers) as ld:
        out["PIL, 1 thread"] = median_ms(
            lambda: [ld._sample(0, i) for i in indices])
        out[f"PIL, {cfg.data.workers} loader threads"] = median_ms(
            lambda: [f.result() for f in [ld.pool.submit(ld._sample, 0, i)
                                          for i in indices]])
    for fast in (False, True):
        try:
            src = JpegFrameSource(cfg.data.db_path, scale=cfg.data.scale_hw,
                                  fast_decode=fast)
        except RuntimeError:
            continue
        if src.native_batch is None:
            continue
        ds = dataclasses.replace(dataset, source=src)
        with HostLoader(ds, len(indices),
                        num_workers=cfg.data.workers) as ld:
            out[f"native{' fast' if fast else ''}, "
                f"{cfg.data.workers // 2} threads"] = median_ms(
                lambda: ld._assemble(0, indices))
    print("path J decode ms a batch: " + json.dumps(out), flush=True)
    return out


def check_native_batches(cfg) -> dict:
    """The native assembler's batch of a few indices against the per-sample
    route bitwise, and the native decode against PIL's (tests/test_native.py's
    band: mean difference under 0.6, none over 8 levels)."""
    import numpy as np
    from PIL import Image

    from dualvar_tpu_torch.data.loader import HostLoader
    from dualvar_tpu_torch.train.pretrain import build_dataset

    dataset = build_dataset(cfg)
    n = len(dataset)
    indices = [5 % n, 0, n - 1, 3 % n]
    with HostLoader(dataset, 4, num_workers=cfg.data.workers) as loader:
        batch = loader._assemble(1, indices)
        samples = [loader._sample(1, i) for i in indices]
    for key in batch:
        if not np.array_equal(batch[key],
                              np.stack([s[key] for s in samples])):
            fail(f"path J: the native batch's {key} differs from the "
                 "per-sample route")
    vname, idx, _ = dataset.plan(0, np.random.default_rng(0))
    paths = dataset.source.paths(vname, idx[:8])
    H, W = cfg.data.scale_hw
    pil = np.stack([np.asarray(Image.open(p).convert("RGB").resize(
        (W, H), Image.BICUBIC)) for p in paths])
    diff = np.abs(dataset.source(vname, idx[:8]).astype(int)
                  - pil.astype(int))
    if not (diff.mean() < 0.6 and diff.max() <= 8):
        fail(f"path J: native decode vs PIL mean {diff.mean()} max "
             f"{diff.max()}")
    out = {"assembler_bitwise": True, "vs_pil_mean": float(diff.mean()),
           "vs_pil_max": int(diff.max())}
    print("path J native checks: " + json.dumps(out), flush=True)
    return out


def run_path_j(torch, log_root: str) -> dict:
    """Path J: a frame tree written from a seed, its split CSV from the
    port's ``write_csv``, then ``train()`` from the files (the native
    assembler where the decoder builds, else PIL): ``aug_fused`` once a
    step; one epoch with ``--fast_decode 1`` (refused where the native
    decoder is not built); the native checks; decode ms by route; the
    ``Data`` wait and the step on real files (with the preset's decode
    threads and half as many) against synthetic frames."""
    from dualvar_tpu_torch import native
    from dualvar_tpu_torch.data.prep import write_csv

    root = os.path.join(log_root, "path_j")
    tic = time.perf_counter()
    frame_root, split_root = write_frame_tree(root)
    index_root = os.path.join(root, "index")
    write_csv.main(["ucf101", "--frame_root", frame_root, "--split_root",
                    split_root, "--out_root", index_root, "--which_split",
                    "1"])
    with open(os.path.join(index_root, "ClassInd.txt"), "w") as fh:
        fh.write("\n".join(PATH_J_CLASSES) + "\n")
    built = native.available()
    print(f"path J: {PATH_J_VIDEOS} videos x {PATH_J_FRAMES} frames "
          f"{PATH_J_HW[1]}x{PATH_J_HW[0]} q{PATH_J_QUALITY} and the split "
          f"CSV in {time.perf_counter() - tic:.1f} s; host cpu_count "
          f"{os.cpu_count()}; native decoder "
          + ("built (" + native.library_path() + ")" if built else
             "could not be built here (g++ or libjpeg's header missing): "
             "the loader decodes with PIL"), flush=True)
    by_run = {}
    cfg = path_j_cfg(log_root, index_root, frame_root)
    _, by_run["path J"] = run_path(
        torch, "path J", cfg, PATH_J_STEPS,
        expected_launches(aug_fused=PATH_J_STEPS), TSV4_LOSSES)
    fast = path_j_cfg(log_root, index_root, frame_root, fast_decode=True)
    summary = {"native_built": built}
    if built:
        _, by_run["path J, --fast_decode 1"] = run_path(
            torch, "path J, --fast_decode 1", fast, PATH_J_EPOCH_STEPS,
            expected_launches(aug_fused=PATH_J_EPOCH_STEPS), TSV4_LOSSES)
        summary["native"] = check_native_batches(cfg)
    else:
        trainer = trainer_of(fast)
        try:
            trainer.train(fast, max_steps=PATH_J_STEPS, device="cuda")
        except RuntimeError as err:
            if "fast_decode" not in str(err):
                raise
            print(f"path J, --fast_decode 1: refused without the native "
                  f"decoder, as it must be: {err}", flush=True)
        else:
            fail("path J: --fast_decode 1 trained without the native decoder")
    summary["decode_ms_per_batch"] = time_decode_routes(cfg)
    summary["real"] = time_loader_steps(torch, cfg)
    # half the decode threads: a slower decode against less contention
    # with the thread that launches the step
    summary[f"real, {cfg.data.workers // 2} workers"] = time_loader_steps(
        torch, cfg.replace(data=dataclasses.replace(
            cfg.data, workers=cfg.data.workers // 2)))
    synthetic = path_j_cfg(log_root, index_root, frame_root, synthetic=True)
    summary["synthetic"] = time_loader_steps(torch, synthetic.replace(
        data=dataclasses.replace(synthetic.data,
                                 synthetic_videos=PATH_J_VIDEOS)))
    print("path J: " + json.dumps(summary), flush=True)
    return by_run


# --------------------------------------------------------------------------
# path F: the unfused per-frame augmentation and the training options
# --------------------------------------------------------------------------

PATH_F_STEPS = 2
# the unfused batch on the card against the CPU: float32 sums in another
# order (the blur's taps, the contrast mean, the HSV round trip), relative
# to the batch's largest |value|
UNFUSED_RTOL = 1e-5


def path_f_aug_cfgs():
    """The three unfused configurations of path F: per-frame jitter
    (``--aug_temp_consist 0``), the gradient ramp (``aug_temp_grad_consist``
    in the config: neither package's parser has the flag) and ``--fused_aug
    off`` with clip-consistent jitter."""
    return (("--aug_temp_consist 0", {"aug_temp_consist": False}),
            ("aug_temp_grad_consist", {"aug_temp_grad_consist": True}),
            ("--fused_aug off", {"fused_aug": "off"}))


def check_unfused_on_card(torch) -> dict:
    """The unfused pretrain batch at B=8 (3 x 16 frames, 171x128 -> 112)
    with the same explicit decisions on the card and on the CPU, in each
    jitter mode, within ``UNFUSED_RTOL`` of the largest value; in the
    clip-consistent mode also against the ``aug_fused`` kernel on the same
    decisions (``F32_ATOL``). Then the unfused batch timed against the
    kernel's fused batch at B=8 (CUDA events, median of 10)."""
    import numpy as np

    from dualvar_tpu_torch.aug.pipeline import (AugConfig,
                                                _draw_clip_params,
                                                _pretrain_batch_unfused,
                                                pretrain_batch,
                                                pretrain_batch_fused)

    frames = torch.from_numpy(np.random.default_rng(40).integers(
        0, 256, (8, 48, 171, 128, 3), dtype=np.uint8))
    cuda = frames.to("cuda")
    out = {}
    for mode, kw in (("consistent", {}),
                     ("frame", {"aug_temp_consist": False}),
                     ("grad", {"aug_temp_grad_consist": True})):
        cfg = AugConfig(**kw)
        decisions = _draw_clip_params(torch.Generator().manual_seed(41), cfg,
                                      8, 3, 171, 128)
        names = ("crops", "orders", "factors", "blurs")
        want = _pretrain_batch_unfused(None, frames, cfg,
                                       **dict(zip(names, decisions)))
        got = _pretrain_batch_unfused(None, cuda, cfg, **dict(zip(
            names, (d.to("cuda") for d in decisions))))
        torch.cuda.synchronize()
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        if not err <= UNFUSED_RTOL * scale:
            fail(f"path F: unfused batch ({mode}) card vs CPU {err} > "
                 f"{UNFUSED_RTOL} x {scale}")
        out[mode] = {"max_abs_err": err, "scale": scale}
        if mode == "consistent":
            fused = pretrain_batch_fused(None, cuda, cfg, **dict(zip(
                names, (d.to("cuda") for d in decisions))))
            kerr = float((fused - got).abs().max())
            if not kerr <= F32_ATOL:
                fail(f"path F: unfused vs aug_fused on the card {kerr}")
            out[mode]["vs_aug_fused"] = kerr
    gen = torch.Generator(device="cuda")
    for name, cfg in (("aug_fused", AugConfig()),
                      ("unfused consistent", AugConfig(fused="off")),
                      ("unfused frame", AugConfig(aug_temp_consist=False))):
        out[f"{name} ms, B=8"] = time_cuda(
            torch, lambda: pretrain_batch(gen.manual_seed(0), cuda, cfg), 10)
    print("path F unfused batch: " + json.dumps(out), flush=True)
    return out


def check_remat_running_stats(torch, log_root: str) -> dict:
    """One main-path step at B=32 under ``DUALVAR_BN_STATS=pallas`` and
    deterministic cuDNN algorithms, without, with and again without
    ``--remat``, from the same init, frames and generator seed. The two
    runs without remat must agree bitwise (the step is deterministic); the
    run with remat must then agree with them bitwise in the losses, every
    running statistic, every gradient (the backward through the recomputed
    backbone) and every parameter after ``optimizer.step()``, with
    ``channel_sums`` launched as often (the recomputation reuses the first
    forward's statistics)."""
    from dualvar_tpu_torch.ops.bn_stats import channel_sums
    from dualvar_tpu_torch.train.pretrain import setup_training

    cudnn = torch.backends.cudnn
    old = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    results = []
    try:
        with bn_stats_env(True):
            for remat in (False, True, False):
                cfg = smoke_cfg("paper_table1_k400", 32, log_root,
                                remat=remat)
                setup = setup_training(cfg, "cuda")
                with setup.loader as loader:
                    frames = torch.from_numpy(
                        next(loader.epoch(0))["frames"]).to("cuda")
                channel_sums.launches = 0
                metrics = setup.train_step(frames, setup.generator)
                torch.cuda.synchronize()
                grads = {k: p.grad.clone()
                         for k, p in setup.model.named_parameters()
                         if p.grad is not None}
                state = {k: v.clone()
                         for k, v in setup.model.state_dict().items()}
                results.append((metrics, grads, state,
                                channel_sums.launches))
                del setup
                torch.cuda.empty_cache()
    finally:
        cudnn.deterministic, cudnn.benchmark = old

    def differing(a, b):
        return [k for k in a if not torch.equal(a[k], b[k])]

    (m0, g0, s0, n0), (m1, g1, s1, n1), (m2, g2, s2, n2) = results
    if not (n0 == n1 == n2 == R21D_SUMS_PER_STEP):
        fail(f"path F remat: channel_sums {n0}, {n2} without, {n1} with "
             "remat")
    if not g0 or sorted(g0) != sorted(g1):
        fail(f"path F remat: gradients of {len(g0)} and {len(g1)} "
             "parameters")
    for what, a, b in (("losses", m0, m2), ("gradients", g0, g2),
                       ("state", s0, s2)):
        if differing(a, b):
            fail(f"path F remat: two runs without remat differ in {what}: "
                 f"{differing(a, b)[:4]}")
    for what, a, b in (("losses", m0, m1), ("gradients", g0, g1),
                       ("state after the step", s0, s1)):
        if differing(a, b):
            fail(f"path F remat: remat changes the {what}: "
                 f"{differing(a, b)[:4]}")
    out = {"losses_bitwise": len(m0), "gradients_bitwise": len(g0),
           "running_statistics_bitwise": sum("running_" in k for k in s0),
           "state_after_step_bitwise": len(s0), "channel_sums": n0,
           "cudnn_deterministic": True}
    print("path F remat, one B=32 step, DUALVAR_BN_STATS=pallas: "
          + json.dumps(out), flush=True)
    return out


def run_path_f(torch, log_root: str) -> dict:
    """Path F: ``paper_table1_k400`` at B=8 on the unfused path three ways
    (``aug_fused`` 0 launches), the unfused batch card against CPU and
    timed against the kernel, two ``--optim adam`` steps, two classifier
    steps with ``--optim adam --remat``, the main path at B=32 with and
    without ``--remat`` (peak memory, step ms) and one step with and
    without it bitwise (``check_remat_running_stats``)."""
    from dualvar_tpu_torch.core.checkpoint import checkpoint_file

    by_run = {}
    for flag, kw in path_f_aug_cfgs():
        cfg = smoke_cfg("paper_table1_k400", 8, log_root)
        cfg = cfg.replace(
            aug=dataclasses.replace(cfg.aug, **kw),
            run=dataclasses.replace(cfg.run, name_prefix=(
                "chip_smoke_path_f_" + flag.strip("-").replace(" ", "_"))))
        label = f"path F, {flag}"
        _, by_run[label] = run_path(torch, label, cfg, PATH_F_STEPS,
                                    expected_launches(), TSV4_LOSSES)
    summary = {"unfused": check_unfused_on_card(torch)}
    adam = smoke_cfg("paper_table1_k400", 8, log_root)
    adam = adam.replace(
        optim=dataclasses.replace(adam.optim, optim="adam"),
        run=dataclasses.replace(adam.run,
                                name_prefix="chip_smoke_path_f_adam"))
    clf = path_c_cfg(log_root)
    clf = dataclasses.replace(
        clf, optim=dataclasses.replace(clf.optim, optim="adam"),
        model=dataclasses.replace(clf.model, remat=True),
        run=dataclasses.replace(clf.run,
                                name_prefix="chip_smoke_path_f_adam_remat"))
    for label, cfg, keys in (("path F, --optim adam", adam, TSV4_LOSSES),
                             ("path F, classifier --optim adam --remat", clf,
                              CLASSIFIER_METRICS)):
        _, by_run[label] = run_path(
            torch, label, cfg, PATH_F_STEPS,
            expected_launches(aug_fused=PATH_F_STEPS), keys)
        ckpt = torch.load(checkpoint_file(os.path.join(
            trainer_of(cfg).set_path(cfg), "model")), map_location="cpu")
        states = ckpt["optimizer"]["state"].values()
        if not states or not all("exp_avg_sq" in s for s in states):
            fail(f"{label}: the checkpoint holds no Adam state")
    summary["remat"] = check_remat_running_stats(torch, log_root)
    for remat in (False, True):
        record = time_train_steps(torch, smoke_cfg(
            "paper_table1_k400", 32, log_root, remat=remat))
        summary[f"B=32 remat={remat}"] = {
            k: record[k] for k in ("ms_per_step",
                                   "max_memory_allocated_bytes")}
    print("path F: " + json.dumps(summary), flush=True)
    return by_run, summary


def main(argv: list[str] | None = None) -> int:
    start = time.perf_counter()
    # --bench-only: the kernels' build, then path B alone (no contract line)
    bench_only = "--bench-only" in (sys.argv[1:] if argv is None else argv)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from dualvar_tpu_torch.ops.build import load_library, ptxas_log_path
    from dualvar_tpu_torch.train.pretrain import set_path

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

    def build(name):
        start = time.perf_counter()
        load_library(name)
        return time.perf_counter() - start

    def build_native():
        # the host JPEG decoder (g++ and libjpeg); False where either is
        # missing, and path J then decodes with PIL
        from dualvar_tpu_torch import native

        start = time.perf_counter()
        return native.available(), time.perf_counter() - start

    def build_floor():
        start = time.perf_counter()
        return launch_floor_kernel(torch), time.perf_counter() - start

    # one compiler a source
    with ThreadPoolExecutor(len(names) + 2) as pool:
        decoder = pool.submit(build_native)
        empty = pool.submit(build_floor)
        took = dict(zip(names, pool.map(build, names)))
        native_built, took["native decoder (g++)"] = decoder.result()
        floor, took["empty kernel"] = empty.result()
    print(f"build: {', '.join(names)}, the empty kernel and the native "
          f"decoder in "
          f"{time.perf_counter() - tic:.1f} s side by side; each: "
          + json.dumps(took) + f"; native decoder built: {native_built}",
          flush=True)
    for name in names:
        with open(ptxas_log_path(name)) as fh:
            print(f"build: ptxas {name}: " + " | ".join(
                line.strip() for line in fh
                if "registers" in line or "spill" in line), flush=True)

    for name in PTXAS_CLEAN:
        check_ptxas_clean(name)
    if bench_only:
        run_bench_phase(torch)
        print(f"chip_smoke --bench-only: {time.perf_counter() - start:.1f} s "
              "from start to end, the kernels' build included", flush=True)
        print(smi)
        return 0

    device = torch.device("cuda")
    kernels = [check_aug_kernel(torch, device),
               check_aug_bf16_compute(torch, device),
               *check_soft_dtw_kernels(torch, device),
               check_channel_sums_kernel(torch, device, floor),
               *check_conv_kernel(torch, device)]

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    log_root = tempfile.mkdtemp(prefix="chip_smoke_",
                                dir=os.path.join(here, "build"))
    try:
        state, by_path = run_main_path(torch, log_root)
        by_path = {"paper_table1_k400": by_path}
        by_path["main path, bf16 compute"] = run_bf16_compute_step(
            torch, log_root)
        moco_state, by_path["path M"] = run_path_m(torch, log_root)
        _, by_path["path M16"] = run_path_m(torch, log_root, "path M16",
                                            n_series=16)
        by_path["path S"] = run_path_s(torch, log_root)
        r_state, by_path["path R"], by_path["path R, ATen batch norm"] = \
            run_path_r(torch, log_root)
        by_path.update(run_smoke_presets(torch, log_root))
        # path C grafts from the main path's checkpoint directory
        main_ckpt = os.path.join(
            set_path(smoke_cfg("paper_table1_k400", 8, log_root)), "model")
        clf_state, path_c = run_path_c(torch, log_root, main_ckpt)
        by_path.update(path_c)
        by_path.update(run_path_p(torch, log_root))
        g_state, path_g = run_path_g(torch, log_root)
        by_path.update(path_g)
        by_path.update(run_path_m_resume(torch, log_root))
        by_path.update(run_backbone_steps(torch, log_root))
        by_path.update(run_path_d(torch, log_root, r_state))
        by_path.update(run_path_v(torch, log_root, state, g_state))
        by_path["path E"] = run_path_e(torch, log_root, path_c_cfg(log_root))
        by_path.update(run_path_j(torch, log_root))
        path_f, path_f_summary = run_path_f(torch, log_root)
        by_path.update(path_f)
        check_features_on_card(torch, log_root, state, moco_state)
        run_learning(torch, log_root)
        by_path.update(run_soak_paths(torch, log_root))
        by_path.update(run_bench_phase(torch))
        for kernel in kernels:
            # each kernel's count on the main path of the slice that ported
            # it (path R for the third slice's, the main path's bf16 step
            # for aug_fused's bfloat16 route); every path's count rides
            # along
            home = ("path M" if kernel["name"].startswith("soft_dtw")
                    else "main path, bf16 compute"
                    if kernel["name"] == "aug_fused_bf16" else "path R")
            kernel["launches"] = by_path[home][kernel["name"]]
            kernel["launches_path"] = home
            if "path_m16" in kernel:
                kernel["path_m16"]["launches"] = \
                    by_path["path M16"][kernel["name"]]
            kernel["launches_by_path"] = {
                path: counts[kernel["name"]]
                for path, counts in by_path.items()}
        sums = next(k for k in kernels if k["name"] == "channel_sums")
        sums["path_g_launches_per_step"] = by_path[
            "path G, DUALVAR_BN_STATS=pallas"]["channel_sums"] / PATH_S_STEPS
        sums["path_g_step"] = check_sums_on_path_g(
            torch, path_g_cfg(8, log_root), g_state, floor)
        sums["profiler_kernels_a_call"] = len(check_sums_profiler(torch))
        aug = next(k for k in kernels if k["name"] == "aug_fused")
        aug["path_c"] = check_aug_classifier_shapes(torch, device)
        aug["f32_error_sources"] = diagnose_aug_f32_margin(torch, device)
        # the unfused path beside the kernel (path F): no launch of it
        aug["path_f_unfused"] = path_f_summary["unfused"]
        conv = next(k for k in kernels if k["name"] == "conv3d_bn_stats_bf16")
        conv["path_r_layer1"] = check_conv_on_path_r(
            torch, path_r_cfg(8, log_root), r_state)
        for batch_size in (8, 32):
            time_train_steps(torch, smoke_cfg(
                "paper_table1_k400", batch_size, log_root))
            for mode in ("clip-sr-tc", "clip-sr-dtw"):
                time_train_steps(torch, smoke_cfg(
                    MOCO_PRESET, batch_size, log_root, mode=mode))
        # path M16: the two modes' difference is soft-DTW at 16x16 and its
        # cost tensor
        for batch_size in (8, 32):
            for mode in ("clip-sr-tc", "clip-sr-dtw"):
                time_train_steps(torch, smoke_cfg(
                    MOCO_PRESET, batch_size, log_root, mode=mode,
                    n_series=16))
        time_path_r(torch, log_root)
        # B=4 steps last about 20 ms: five windows of 20 steps show the
        # host clock's spread
        time_train_steps(torch, path_c_cfg(log_root, 4), n=20, windows=5)
        time_train_steps(torch, path_c_cfg(log_root, 32, videos=32),
                         windows=3)
        time_train_steps(torch, path_g_cfg(8, log_root), windows=5)
        with bn_stats_env(True):
            time_train_steps(torch, path_g_cfg(8, log_root), windows=5)
        time_train_steps(torch, path_g_cfg(32, log_root, videos=32),
                         windows=3)
        check_f32_forward(torch, "paper_table1_k400",
                          smoke_cfg("paper_table1_k400", 2, log_root), state)
        check_f32_forward(
            torch, "path M",
            smoke_cfg(MOCO_PRESET, 2, log_root, mode="clip-sr-dtw"),
            moco_state)
        with bn_stats_env(True):
            check_f32_forward(torch, "path R", path_r_cfg(2, log_root),
                              r_state, want_sums=R3D_BATCH_NORMS)
        check_f32_classifier(torch, path_c_cfg(log_root), clf_state)
        with bn_stats_env(True):
            # no backward: one call a batch norm, two backbone passes
            check_f32_forward(torch, "path G", path_g_cfg(2, log_root),
                              g_state, want_sums=2 * S3DG_BATCH_NORMS,
                              feature_atol=FEATURE_F32_ATOL)
    finally:
        shutil.rmtree(log_root, ignore_errors=True)

    print(f"chip_smoke: {time.perf_counter() - start:.1f} s from start to "
          "end, the kernels' build included", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
