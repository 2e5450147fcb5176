"""Sustained-training soak on the card: the R3D-18 SimCLR step (B=128, the
fused augmentation) run continuously for ``--minutes``, then the properties
a long pretrain relies on. Counterpart of the JAX package's
``scripts/soak.py``:

* sustained throughput: clips/s of every chain of ``--chain`` steps (one
  host barrier a chain, the ``.item()`` of its last loss) over the whole
  run, with the best, the worst and the 10th percentile chain;
* numerical health: every chain's loss finite (a non-finite one ends the
  run with exit code 1), and whether the fixed batch's loss is lower at the
  end than at the start;
* resume: at half time the full state (model, optimizer, scheduler and the
  step's generator, ``train/pretrain.py:training_state``) is saved through
  ``core/checkpoint.py:CheckpointStore(..., async_save=True)`` while
  training goes on; the 3 live steps after the save are kept, and after the
  run two restores of the checkpoint each replay those 3 steps: the replays
  must equal each other and the live steps bitwise. The JAX script compares
  the two replays only (its live state was donated). The live steps and
  the replays run under deterministic cuDNN algorithms; only the chains,
  which run without them, are timed.

The configuration is the JAX script's: ``SimCLRNaked`` on R3D-18, dim 128,
temperature 0.07, bfloat16 autocast; 16x112x112 clips cropped from one
fixed uint8 batch of 171x128 frames drawn with ``np.random.default_rng(0)``;
``AugConfig(fused="auto", jitter_order="sample")``; SGD at a constant lr
0.003, momentum 0.9, weight decay 1e-4. The step is the trainer's own
(``train/pretrain.py:make_train_step``).

The checkpoint goes to ``$SOAK_CKPT_DIR`` (emptied first) or to a fresh
temporary directory removed at the end. Earlier lines print the device
(the card's name and power limit), each chain, the device memory allocated
after the first chain and at the end, the save's chain against the median
chain; the last line is the JSON record, with the JAX record's keys. The
exit code is 1 when a check fails.

Usage (on the card, from the repo root)::

    python3 -m dualvar_tpu_torch.tools.soak [--minutes 10] [--b 128] [--chain 20]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..aug.pipeline import AugConfig
from ..core.checkpoint import CheckpointStore
from ..core.config import ModelConfig, PretrainConfig
from ..train.pretrain import (_AUTOCAST, _resolve_device, build_task,
                              make_optimizer, make_train_step,
                              restore_training_state, training_state)

# live steps kept after the save, and steps of each replay
REPLAY_STEPS = 3
REPLAYS = 2
log = functools.partial(print, flush=True)


def device_line(device: torch.device) -> str:
    """What the run's numbers are read on: ``nvidia-smi``'s name and power
    limit of the card (torch's name where ``nvidia-smi`` cannot be run), or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi: {e})"
    return out.stdout.strip() or torch.cuda.get_device_name(device)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, chosen without benchmarking, inside
    the block; the flags as found after it."""
    cudnn = torch.backends.cudnn
    old = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = old


@contextlib.contextmanager
def checkpoint_dir(path: str | None = None):
    """``path``, else ``$SOAK_CKPT_DIR``, emptied first; else a fresh
    temporary directory, removed at the end."""
    path = path or os.environ.get("SOAK_CKPT_DIR")
    if path:
        shutil.rmtree(path, ignore_errors=True)
        yield path
        return
    tmp = tempfile.mkdtemp(prefix="soak_ckpt_")
    try:
        yield tmp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class Trainer(NamedTuple):
    """What a soak steps: the trainer's step over these objects."""

    task: object
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    train_step: Callable  # (frames_u8, generator) -> metrics
    generator: torch.Generator

    def step(self, frames: torch.Tensor) -> dict:
        return self.train_step(frames, self.generator)


def build_trainer(cfg: PretrainConfig, aug_cfg: AugConfig,
                  device: torch.device, steps_per_epoch: int) -> Trainer:
    """The model of ``cfg`` (initialised from ``cfg.run.seed``) on
    ``device`` in train mode, its optimizer and scheduler, the trainer's
    step and the step's generator, seeded 1."""
    task = build_task(cfg)
    model = task.model.to(device)
    model.train()
    optimizer, scheduler = make_optimizer(cfg, task.parameters(),
                                          steps_per_epoch)
    train_step = make_train_step(task, optimizer, scheduler, aug_cfg,
                                 _AUTOCAST[cfg.model.dtype])
    generator = torch.Generator(device=device).manual_seed(1)
    return Trainer(task, model, optimizer, scheduler, train_step, generator)


def fixed_frames(batch: int, frames: int, hw: tuple[int, int],
                 device: torch.device) -> torch.Tensor:
    """The soak's one uint8 batch (batch, frames, H, W, 3), drawn with
    ``np.random.default_rng(0)`` as the JAX scripts draw it."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(
        0, 255, (batch, frames, *hw, 3), dtype=np.uint8)).to(device)


def allocated(device: torch.device) -> int | None:
    return (torch.cuda.memory_allocated(device) if device.type == "cuda"
            else None)


@dataclasses.dataclass
class SoakRun:
    """What the timed loop saw."""

    first_loss: float
    steps: int = 1  # live steps taken, the warm-up included
    chain_seconds: list = dataclasses.field(default_factory=list)
    chain_losses: list = dataclasses.field(default_factory=list)
    saved_at: int | None = None  # steps taken when the state was saved
    enqueue_s: float | None = None  # the store's save() call
    save_chain: int | None = None  # index of the first chain after the save
    live: list = dataclasses.field(default_factory=list)
    live_s: float | None = None
    memory_first_chain: int | None = None

    def rates(self, clips_per_step: int, chain: int) -> list[float]:
        return [clips_per_step * chain / s for s in self.chain_seconds]


def run_chains(trainer: Trainer, frames: torch.Tensor, minutes: float,
               chain: int, clips_per_step: int, observe: Callable,
               store: CheckpointStore, tag: str) -> SoakRun:
    """The warm-up step, then chains of ``chain`` steps until ``minutes``
    have passed (at least one chain, and the save): after the first chain
    that ends past half time the full state is saved (async), and the
    ``REPLAY_STEPS`` steps after it run under deterministic cuDNN with
    ``observe(metrics)`` of each kept. A non-finite chain loss raises
    ``FloatingPointError``."""
    device = frames.device
    tic = time.perf_counter()
    run = SoakRun(first_loss=trainer.step(frames)["total_loss"].item())
    log(f"[{tag}] first step in {time.perf_counter() - tic:.1f} s; "
        f"warm-up loss {run.first_loss:.4f}")
    start = time.perf_counter()
    halfway, deadline = start + minutes * 30.0, start + minutes * 60.0
    while (not run.chain_seconds or run.saved_at is None
           or time.perf_counter() < deadline):
        tc = time.perf_counter()
        for _ in range(chain):
            metrics = trainer.step(frames)
        loss = metrics["total_loss"].item()  # the chain's host barrier
        run.chain_seconds.append(time.perf_counter() - tc)
        run.chain_losses.append(loss)
        run.steps += chain
        if len(run.chain_seconds) == 1:
            run.memory_first_chain = allocated(device)
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {run.steps}")
        log(f"[{tag}] step {run.steps}: "
            f"{clips_per_step * chain / run.chain_seconds[-1]:.1f} clips/s, "
            f"loss {loss:.4f}")
        if run.saved_at is None and time.perf_counter() > halfway:
            ts = time.perf_counter()
            store.save(0, training_state(
                trainer.model, trainer.optimizer, trainer.scheduler,
                trainer.generator, 0, run.steps, 0.0))
            run.enqueue_s = time.perf_counter() - ts
            run.saved_at = run.steps
            with deterministic_cudnn():
                ts = time.perf_counter()
                run.live = [observe(trainer.step(frames))
                            for _ in range(REPLAY_STEPS)]
                run.live_s = time.perf_counter() - ts
            run.steps += REPLAY_STEPS
            run.save_chain = len(run.chain_seconds)
            log(f"[{tag}] checkpoint at step {run.saved_at} "
                f"({run.enqueue_s:.3f} s enqueue); the next "
                f"{REPLAY_STEPS} steps under deterministic cuDNN in "
                f"{run.live_s:.3f} s: {run.live}")
    return run


def replay(trainer: Trainer, frames: torch.Tensor, store: CheckpointStore,
           observe: Callable) -> tuple[list, list, list]:
    """Close the store (its writer thread done), then ``REPLAYS`` times:
    restore the checkpoint into the trainer's objects and replay
    ``REPLAY_STEPS`` steps under deterministic cuDNN. Returns each
    replay's observations, the seconds of each restore (the file read and
    loaded into the objects on the device) and of each replay's steps."""
    store.close()
    outs, restore_s, seconds = [], [], []
    with deterministic_cudnn():
        for _ in range(REPLAYS):
            ts = time.perf_counter()
            restore_training_state(store.restore(0), trainer.model,
                                   trainer.optimizer, trainer.scheduler,
                                   trainer.generator)
            if frames.device.type == "cuda":
                torch.cuda.synchronize(frames.device)
            restore_s.append(time.perf_counter() - ts)
            ts = time.perf_counter()
            outs.append([observe(trainer.step(frames))
                         for _ in range(REPLAY_STEPS)])
            seconds.append(time.perf_counter() - ts)
    return outs, restore_s, seconds


def soak(trainer: Trainer, frames: torch.Tensor, minutes: float,
         chain: int, clips_per_step: int, observe: Callable, tag: str,
         ckpt_dir: str | None = None,
         checks: Callable[[SoakRun], dict] | None = None
         ) -> tuple[SoakRun, dict]:
    """``run_chains``, then ``checks(run)`` on the live state, then
    ``replay``. Returns the run and the details every record carries
    beside its JAX keys: the device, the checks, the live steps and the
    replays (and whether they agree), the save's chain against the median,
    memory."""
    device = frames.device
    line = device_line(device)
    log(f"[{tag}] device: {line}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with checkpoint_dir(ckpt_dir) as directory:
        store = CheckpointStore(directory, async_save=True)
        try:
            run = run_chains(trainer, frames, minutes, chain, clips_per_step,
                             observe, store, tag)
            checked = checks(run) if checks else {}
            replays, restore_s, replay_s = replay(trainer, frames, store,
                                                  observe)
        finally:
            store.close()
    median = statistics.median(run.chain_seconds)
    save_chain_s = (run.chain_seconds[run.save_chain]
                    if run.save_chain < len(run.chain_seconds) else None)
    details = {
        "device": line,
        **checked,
        "saved_at_step": run.saved_at,
        "live": run.live,
        "replays": replays,
        "replays_agree": all(r == replays[0] for r in replays),
        "replays_match_live": all(r == run.live for r in replays),
        "restore_s": restore_s,
        "live_steps_s": run.live_s,
        "replay_steps_s": replay_s,
        "save_chain_s": save_chain_s,
        "median_chain_s": median,
        "chain_s": run.chain_seconds,
        "memory_first_chain_bytes": run.memory_first_chain,
        "memory_end_bytes": allocated(device),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }
    log(f"[{tag}] device memory allocated after the first chain "
        f"{details['memory_first_chain_bytes']} B, at the end "
        f"{details['memory_end_bytes']} B, peak {details['peak_memory_bytes']}"
        f" B")
    log(f"[{tag}] the chain after the save: {save_chain_s} s against the "
        f"median chain {median} s; the {REPLAY_STEPS} live steps after it "
        f"{run.live_s} s against the replays' {replay_s} s; each restore "
        f"{restore_s} s")
    log(f"[{tag}] replays: {replays}; live: {run.live}")
    return run, details


def soak_config(dtype: str = "bfloat16") -> PretrainConfig:
    """``SimCLRNaked`` on R3D-18 (dim 128, temperature 0.07) under ``dtype``
    autocast; SGD at a constant lr 0.003, momentum 0.9, weight decay
    1e-4."""
    cfg = PretrainConfig()
    return cfg.replace(
        model=ModelConfig(net="r3d", model="simclr_naked", moco_dim=128,
                          moco_t=0.07, dtype=dtype),
        optim=dataclasses.replace(cfg.optim, lr=0.003, momentum=0.9,
                                  wd=1e-4, schedule=()))


def run_soak(minutes: float = 10.0, batch: int = 128, chain: int = 20,
             device: str | torch.device = "cuda", seq: int = 16,
             img: int = 112, frame_hw: tuple[int, int] = (171, 128),
             dtype: str = "bfloat16", ckpt_dir: str | None = None
             ) -> tuple[dict, dict]:
    """The soak; returns (the record, with the JAX record's keys; the
    details of ``soak``). ``seq``, ``img``, ``frame_hw`` and ``dtype`` size
    it down for a run on the CPU."""
    device = _resolve_device(device)
    cfg = soak_config(dtype)
    aug_cfg = AugConfig(img_dim=img, seq_len=seq, fused="auto",
                        jitter_order="sample")
    trainer = build_trainer(cfg, aug_cfg, device, steps_per_epoch=1)
    frames = fixed_frames(batch, 2 * seq, frame_hw, device)
    run, details = soak(trainer, frames, minutes, chain, 2 * batch,
                        lambda m: m["total_loss"].item(), "soak", ckpt_dir)
    rates = run.rates(2 * batch, chain)
    record = {
        "metric": "soak sustained pretrain throughput",
        "unit": "clips/s/device",
        "value": float(np.mean(rates)),
        "minutes": minutes,
        "batch_size": batch,
        "steps": run.steps,
        "chains": len(rates),
        "best_chain": max(rates),
        "worst_chain": min(rates),
        "p10_chain": float(np.percentile(rates, 10)),
        "first_loss": run.first_loss,
        "last_loss": run.chain_losses[-1],
        "loss_decreased": run.chain_losses[-1] < run.first_loss,
        "ckpt_save_enqueue_s": run.enqueue_s,
        "resume_deterministic": (details["replays_agree"]
                                 and details["replays_match_live"]),
    }
    return record, details


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--minutes", type=float, default=10.0)
    p.add_argument("--b", type=int, default=128)
    p.add_argument("--chain", type=int, default=20,
                   help="steps per timed chain (one host barrier per chain)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    try:
        record, details = run_soak(args.minutes, args.b, args.chain,
                                   args.device)
    except FloatingPointError as e:
        log(json.dumps({"error": str(e)}))
        return 1
    log("[soak] details: " + json.dumps(details))
    log(json.dumps(record))
    return 0 if record["resume_deterministic"] else 1


if __name__ == "__main__":
    sys.exit(main())
