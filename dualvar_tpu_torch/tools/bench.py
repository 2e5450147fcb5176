"""Throughput of the R3D-18 SimCLR pretrain step on the card, in clips a
second. Counterpart of the JAX package's ``bench.py``.

The unit is that script's: ``SimCLRNaked`` on R3D-18 (dim 128, temperature
0.07) under bfloat16 autocast (the trainers' ``train/tasks.py:
step_context``), ``AugConfig(img_dim=112, seq_len=16, fused="auto",
jitter_order="sample")``, SGD at lr 0.003, momentum 0.9, weight decay 1e-4;
one fixed uint8 batch of 171x128 frames drawn with
``np.random.default_rng(0)`` and kept on the card; the trainer's own step
(``train/pretrain.py:make_train_step``: the augmentation kernel, the 2-view
forward, NT-Xent, the backward, SGD). Batch candidates 128, then 64
(``tools/timing.py:fit_batch``), 3 warm-up steps (the first under
``tools/timing.py:step_flops``), then 3 chains of 20 steps. "Clips" counts
encoded 16-frame clips, 2 a sample: ``value`` is B x 2 over the best
chain's step time.

``vs_baseline`` is the JAX script's: the measured rate over an analytic
A100 estimate of the PyTorch reference, 0.45 x 156e12 / (3 x F_fwd) clips
a second, with F_fwd the forward's operations a clip (here from
``tools/timing.py:step_flops``, which counts more than XLA's cost analysis
did: the ratio is not the JAX record's), and its band at 35 and 55 %.
Beside it: the step's operations (``step_tflops``), their share of the
H100's bf16 peak (``mfu_pct``), every chain, the median chain, the card's
name and power limit.

``--input-pipeline`` feeds the same step from a JPEG tree written from a
seed into ``build/bench/bench_jpegs`` (2 x 16-frame clips a sample, 4 x B +
16 videos of 140 frames at 171x128, quality 80; about 74,000 files):
``PretrainDataset`` -> ``JpegFrameSource`` (the native decoder where it is
built, else PIL) -> ``HostLoader``, each batch pinned and copied to the
card one step ahead. It reports the rate achieved, the decode rate of one
core, the host-to-card copy rate, the host cores and the cores it would
take to keep up with the resident-batch rate. ``fast_decode`` is measured
only through the native decoder: where that is not built (no libjpeg),
``JpegFrameSource(fast_decode=True)`` raises, and the record says so with
``null``.

Not ported, being the TPU relay's: the preflight subprocess, the watchdog
and its error records, ``BENCH_LAST_GOOD.json``'s last known good, and the
in-thread soft-DTW and augmentation device checks (the kernels are checked
on the card by ``chip_smoke.py``'s kernel phase). A failed run exits
non-zero and prints no record with ``value``.

Progress goes to standard error, the record to standard output (one JSON
line) and to ``--out`` (default ``build/bench/bench.json``, or
``build/bench/pipeline.json`` with ``--input-pipeline``); nothing is written
at the repo root.

Usage (on the card, from the repo root)::

    python3 -m dualvar_tpu_torch.tools.bench [--input-pipeline]
        [--steps 20] [--chains 3] [--out PATH] [--device cuda] [--smoke]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..aug.pipeline import AugConfig, pretrain_batch
from ..core.config import PretrainConfig
from ..train.pretrain import _AUTOCAST, _resolve_device
from ..train.tasks import step_context
from .soak import build_trainer, fixed_frames, soak_config
from .timing import (device_line, finite, log, measure, step_flops,
                     synchronize)

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "bench")
# --input-pipeline's frame tree (a few hundred MB at full size)
JPEG_ROOT = os.path.join(BENCH_DIR, "bench_jpegs")
BATCHES = (128, 64)
# (T, H0, W0, crop): the clip, the stored frames, the crop; --smoke: the
# JAX scripts' smoke shapes, in float32
SHAPES = (16, 171, 128, 112)
SMOKE_SHAPES = (4, 40, 36, 32)
SMOKE_BATCHES = (2,)
METRIC = ("clips/sec/device pretrain (R3D-18 SimCLR, 16x112^2, bf16 "
          "autocast, full train step incl. on-device aug)")
# the JAX script's A100 estimate of the reference: TF32 peak and the
# utilisations of its band
A100_TF32_FLOPS_PER_S = 156e12
A100_UTILS = (0.35, 0.45, 0.55)
# the input pipeline: JPEG frames a video, steps fed from files
PIPELINE_FRAMES = 140
PIPELINE_STEPS = 4


def shapes(smoke: bool) -> tuple[int, int, int, int]:
    return SMOKE_SHAPES if smoke else SHAPES


def tool_parser(doc: str, out: str | None, steps: int = 20, chains: int = 3
                ) -> argparse.ArgumentParser:
    """The flags every bench tool takes; ``out`` is ``--out``'s default
    under ``BENCH_DIR``."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=steps, help="steps a chain")
    p.add_argument("--chains", type=int, default=chains)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--out", default=out and os.path.join(BENCH_DIR, out),
                   help="where the records are written (default under "
                        "build/bench/)")
    p.add_argument("--smoke", action="store_true",
                   help="the JAX scripts' smoke shapes: T=4, 40x36 frames, "
                        "32x32 crops, float32, B=2 (MoCo at K=8)")
    return p


class TrainUnit:
    """One trainer step of ``cfg`` on a fixed uint8 batch of ``batch``
    samples on ``device``; ``step()`` returns the total loss."""

    def __init__(self, cfg: PretrainConfig, aug_cfg: AugConfig, batch: int,
                 frame_hw: tuple[int, int], device: torch.device,
                 steps_per_epoch: int = 1):
        self.cfg, self.aug_cfg = cfg, aug_cfg
        self.trainer = build_trainer(cfg, aug_cfg, device, steps_per_epoch)
        self.n_views = self.trainer.task.n_views
        self.frames = fixed_frames(batch, self.n_views * aug_cfg.seq_len,
                                   frame_hw, device)

    def step(self) -> torch.Tensor:
        return self.trainer.step(self.frames)["total_loss"]

    def forward_flops(self) -> int:
        """The operations of the task's forward on one augmented batch, as
        the step runs it (no gradient kept)."""
        trainer, device = self.trainer, self.frames.device
        with torch.no_grad():
            block = pretrain_batch(trainer.generator, self.frames,
                                   self.aug_cfg)
            with step_context(device.type,
                              _AUTOCAST[self.cfg.model.dtype]) as autocast:
                with autocast():
                    return step_flops(lambda: trainer.task.forward(
                        block, generator=trainer.generator))


def aug_config(smoke: bool) -> AugConfig:
    T, _, _, img = shapes(smoke)
    return AugConfig(img_dim=img, seq_len=T, fused="auto",
                     jitter_order="sample")


def train_record(m, n_views: int, device: torch.device) -> dict:
    """The timing keys of a train unit's record, with the rates: clips
    (B x ``n_views``) and samples a second over the best chain."""
    per = m.per_step
    return {**m.fields(device),
            "clips_per_sec": round(m.batch * n_views / per, 1),
            "samples_per_sec": round(m.batch / per, 1),
            "final_loss": round(m.out.item(), 3)}


def run_bench(batches=BATCHES, steps: int = 20, chains: int = 3,
              device: str | torch.device = "cuda", smoke: bool = False
              ) -> tuple[dict, TrainUnit]:
    """The headline record and the unit it timed (its trainer warmed up,
    for ``input_pipeline``). Raises ``RuntimeError`` when no candidate
    fits."""
    device = _resolve_device(device)
    line = device_line(device)
    log(f"device: {line}")
    _, H0, W0, _ = shapes(smoke)
    cfg = soak_config("float32" if smoke else "bfloat16")
    aug_cfg = aug_config(smoke)
    m = measure(lambda b: TrainUnit(cfg, aug_cfg, b, (H0, W0), device),
                batches, steps, chains, device, "bench")
    if m.batch is None:
        raise RuntimeError(f"no batch candidate fits: {m.did_not_fit}")
    per = m.per_step
    clips_per_sec = m.batch * 2 / per
    f_fwd_per_clip = m.unit.forward_flops() / (2 * m.batch)
    estimate = {u: u * A100_TF32_FLOPS_PER_S / (3.0 * f_fwd_per_clip)
                for u in A100_UTILS}
    fields = train_record(m, 2, device)
    log(f"step {per * 1e3:.1f} ms best of {chains} (all: {fields['chains_ms']}"
        f" ms), {clips_per_sec:.1f} clips/s, final loss "
        f"{fields['final_loss']}; fwd {f_fwd_per_clip / 1e9:.2f} GFLOP/clip, "
        f"A100 estimate {estimate[0.45]:.1f} clips/s")
    record = {
        "metric": METRIC,
        "value": round(clips_per_sec, 2),
        "unit": "clips/s/device",
        "vs_baseline": round(clips_per_sec / estimate[0.45], 3),
        **{f"vs_baseline_at_{round(u * 100)}pct_a100_util":
           round(clips_per_sec / est, 3) for u, est in estimate.items()},
        "batch_size": m.batch,
        "backend": device.type,
        "fwd_gflops_per_clip": round(f_fwd_per_clip / 1e9, 3),
        **{k: v for k, v in fields.items() if k != "batch"},
        "device": line,
    }
    return record, m.unit


def write_jpeg_tree(root: str, n_videos: int, vlen: int,
                    frame_hw: tuple[int, int]) -> list:
    """The synthetic videos of ``synthetic_entries(n_videos, 8)`` as JPEG
    frames (quality 80) under ``root`` in ``JpegFrameSource``'s layout,
    written once: a marker names what the tree holds. Returns the
    entries and their class index."""
    from PIL import Image

    from ..data.loader import SyntheticFrameSource, synthetic_entries

    entries, class_index = synthetic_entries(n_videos, 8, min_len=vlen,
                                             max_len=vlen + 1)
    marker = os.path.join(root, ".complete")
    what = f"{n_videos} {vlen} {frame_hw[0]}x{frame_hw[1]}\n"
    if os.path.exists(marker) and open(marker).read() == what:
        return entries, class_index
    src = SyntheticFrameSource(scale=frame_hw)

    def write(e):
        d = os.path.join(root, e.vname)
        os.makedirs(d, exist_ok=True)
        for i, frame in enumerate(src(e.vname, np.arange(vlen))):
            Image.fromarray(frame).save(
                os.path.join(d, f"image_{i + 1:05d}.jpg"), quality=80)

    with ThreadPoolExecutor(max(1, len(os.sched_getaffinity(0)))) as pool:
        list(pool.map(write, entries))
    with open(marker, "w") as fh:
        fh.write(what)
    return entries, class_index


def input_pipeline(unit: TrainUnit, resident_clips_per_sec: float,
                   root: str) -> dict:
    """The same step fed from JPEG files (``PIPELINE_STEPS`` steps, each
    batch placed on the card one step ahead from pinned memory)."""
    from .. import native
    from ..data.loader import HostLoader, JpegFrameSource, PretrainDataset

    device = unit.frames.device
    B, n_frames, H0, W0, _ = unit.frames.shape
    T = n_frames // 2
    n_videos = 4 * B + 16  # at least 4 batches an epoch, so prefetch overlaps
    tic = time.perf_counter()
    entries, class_index = write_jpeg_tree(root, n_videos, PIPELINE_FRAMES,
                                           (H0, W0))
    log(f"jpeg tree ready in {time.perf_counter() - tic:.1f} s")
    ncores = len(os.sched_getaffinity(0))
    threads = max(1, min(4, ncores))

    def dataset(fast_decode=False):
        source = JpegFrameSource(root, scale=(H0, W0), native_threads=threads,
                                 fast_decode=fast_decode)
        return PretrainDataset(entries=entries, class_index=class_index,
                               source=source, num_frames=T, ds=4,
                               rand_flip=False, aug_series=False)

    def decode_rate(ds, n_probe=8):
        """Clips (2 a sample) a second of one caller decoding samples."""
        rng = np.random.default_rng(0)
        tic = time.perf_counter()
        for i in range(n_probe):
            ds(i % n_videos, rng)
        return 2 * n_probe / (time.perf_counter() - tic)

    data = dataset()
    route = "native" if data.source.native_batch is not None else "PIL"
    decode_clips = decode_rate(data)
    log(f"host decode ({route}): {decode_clips:.1f} clips/s/core on {ncores} "
        "core(s)")
    if native.available():
        fast_clips, fast_note = decode_rate(dataset(fast_decode=True)), None
    else:
        fast_clips = None
        fast_note = ("not measured: the native JPEG decoder is not built "
                     "here (no g++ or libjpeg), and JpegFrameSource("
                     "fast_decode=True) raises without it; PIL is not "
                     "fast_decode")
    log(f"host decode (fast_decode): {fast_clips} clips/s/core"
        + (f" ({fast_note})" if fast_note else ""))

    probe = torch.zeros(tuple(unit.frames.shape), dtype=torch.uint8)
    probe = probe.pin_memory() if device.type == "cuda" else probe
    probe.to(device)
    synchronize(device)
    tic = time.perf_counter()
    probe.to(device, non_blocking=True)
    synchronize(device)
    h2d_mbps = probe.nbytes / (time.perf_counter() - tic) / 1e6
    log(f"H2D: {h2d_mbps:.0f} MB/s for a {probe.nbytes / 1e6:.0f} MB batch "
        "from pinned memory")
    del probe

    trainer = unit.trainer
    steps, lookahead, loss = 0, None, None
    with HostLoader(data, B, shuffle=True, seed=0,
                    num_workers=max(2, 2 * ncores), drop_last=True) as loader:
        tic = time.perf_counter()
        epoch = 0
        while steps < PIPELINE_STEPS:
            for batch in loader.epoch(epoch):
                frames = torch.from_numpy(batch["frames"])
                if device.type == "cuda":
                    frames = frames.pin_memory()
                frames = frames.to(device, non_blocking=True)
                if lookahead is not None:
                    loss = trainer.step(lookahead)["total_loss"]
                    steps += 1
                lookahead = frames
                if steps >= PIPELINE_STEPS:
                    break
            epoch += 1
        loss = loss.item()
        seconds = time.perf_counter() - tic
    if not finite(loss):
        raise FloatingPointError(f"input pipeline: loss {loss}")
    achieved = steps * B * 2 / seconds
    need = resident_clips_per_sec / decode_clips
    h2d_clips = h2d_mbps * 1e6 / (T * H0 * W0 * 3)
    log(f"input-pipeline-fed: {achieved:.1f} clips/s "
        f"({achieved / resident_clips_per_sec:.1%} of the resident batch); "
        f"~{need:.0f} cores would keep up with the card")
    return {
        "metric": "clips/sec/device pretrain fed by the real input path "
                  f"(JPEG files -> {route} decode -> HostLoader -> pinned "
                  "H2D)",
        "value": round(achieved, 2),
        "unit": "clips/s/device",
        "vs_baseline": round(achieved / resident_clips_per_sec, 3),
        "resident_batch_clips_per_sec": round(resident_clips_per_sec, 2),
        "host_decode_clips_per_sec_per_core": round(decode_clips, 2),
        "fast_decode_clips_per_sec_per_core": (
            None if fast_clips is None else round(fast_clips, 2)),
        "host_cores": ncores,
        "cores_to_saturate_chip": round(need, 1),
        "h2d_MBps": round(h2d_mbps, 1),
        "h2d_sustainable_clips_per_sec": round(h2d_clips, 1),
        "note": f"decode route {route}; fast_decode: "
                + (fast_note or "measured through the native decoder"),
        "steps": steps,
        "final_loss": round(loss, 3),
    }


def main(argv: list[str] | None = None) -> int:
    p = tool_parser(__doc__, None)
    p.add_argument("--input-pipeline", action="store_true",
                   help="feed the step from a JPEG tree through the loader")
    args = p.parse_args(argv)
    out = args.out or os.path.join(
        BENCH_DIR, "pipeline.json" if args.input_pipeline else "bench.json")
    record, unit = run_bench(SMOKE_BATCHES if args.smoke else BATCHES,
                             args.steps, args.chains, args.device, args.smoke)
    if not finite(record["final_loss"]):
        log(f"bench: final loss {record['final_loss']} is not finite")
        return 1
    if args.input_pipeline:
        record = {**input_pipeline(unit, record["value"], JPEG_ROOT),
                  "device": record["device"]}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
