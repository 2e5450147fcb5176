"""SSL pretraining trainer (reference pretrain.py entry point).

Counterpart of ``dualvar_tpu/train/pretrain.py``. One train step: uint8 batch
-> on-device augmentation (the fused CUDA kernel) -> model forward (all
losses; for MoCo also the key encoder's momentum update and the enqueue) ->
backward -> SGD update of the task's trainable parameters -> metric scalars.
Checkpoints go through ``core/checkpoint.py:CheckpointStore`` under
``model/`` (``latest/`` and ``best/``, ranked by the clip accuracy). Each
holds the epoch, the iteration, the best accuracy, the model's
``state_dict`` (for MoCo the query and key encoders, both queues and the
pointer), the optimizer's and the scheduler's ``state_dict`` and the run
generator's state. ``--resume auto`` (this run's store) or ``--resume
<dir>`` restores all of it and goes on from the next epoch; ``--pretrain
<checkpoint>`` loads the weights only, every entry whose key and shape
match. Runs on ``cuda`` unless the caller passes ``device="cpu"``; a
missing card is an error, never a silent fall back to the CPU.

Data-parallel across processes when launched with torchrun
(``core/dist.py``): each process trains on its shard of the data with a
batch of ``batch_size`` (per process, as the reference's batch per GPU),
and the step is the JAX package's step on the global batch: batch norms
over the global batch, the contrastive losses' negatives from every
process, MoCo's queue fed by every process's keys, the gradient averaged
over the processes. Process 0 logs and writes the checkpoints; a
checkpoint holds every process's generator state.

Usage:
    python -m dualvar_tpu_torch.train.pretrain --preset paper_table1_k400 \\
        --synthetic 1 --max_steps 20
    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m dualvar_tpu_torch.train.pretrain --preset paper_table1_k400 \\
        --synthetic 1 --max_steps 20
    python -m dualvar_tpu_torch.train.pretrain --preset paper_table2_moco_r21d \\
        --mode clip-sr-dtw --synthetic 1 --max_steps 20
    python -m dualvar_tpu_torch.train.pretrain --preset s3dg_k400 \\
        --synthetic 1 --resume auto
    python -m dualvar_tpu_torch.train.pretrain --preset paper_table1_k400 \\
        --data_root ... --db_path ...
    python -m dualvar_tpu_torch.train.pretrain --preset paper_table1_k400 \\
        --synthetic 1 --max_steps 5 --profile_steps 2
    python -m dualvar_tpu_torch.train.pretrain --preset paper_table1_k400 \\
        --synthetic 1 --visualize --pretrain log/.../model

Process 0 writes the metrics through ``core/metrics_writer.py`` under
``{exp}/img/pretrain`` (``metrics.jsonl``, and TensorBoard where
tensorboardX imports): ``local/<metric>`` at each logged step,
``global/<name>_loss`` and ``global/<name>_acc`` at each epoch's end.
``--profile_steps N`` traces N steps after the first with
``torch.profiler`` (the card's kernels included) into
``{exp}/img/profile``. ``--visualize`` writes input frames and per-stage
attention maps as images instead of training (``visualize``).

``--optim adam`` trains with AdamW (``make_optimizer``); ``--remat``
recomputes the backbone's activations in the backward pass
(``models/backbones/__init__.py:select_backbone``); ``--fast_decode 1``
takes the native decoder's DCT-scaled decode (``data/loader.py:
JpegFrameSource``, which raises where the native decoder cannot be built).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import math
import os
import time
from typing import Callable, NamedTuple

import torch

from ..aug.pipeline import AugConfig, pretrain_batch
from ..core import dist
from ..core.checkpoint import (CheckpointStore, load_state_dict,
                               merge_matching_leaves)
from ..core.config import PRETRAIN_PRESETS, PretrainConfig
from ..core.logging import get_logger
from ..core.meters import AverageMeter, MeterBank, ProgressMeter
from ..core.metrics_writer import MetricsWriter
from ..core.utils import batch_denorm
from ..data.indices import load_class_index, load_split
from ..data.loader import (HostLoader, JpegFrameSource, PretrainDataset,
                           SyntheticFrameSource, synthetic_entries)
from ..models.ssl.losses import topk_accuracy
from .tasks import make_task, total_loss

_AUTOCAST = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_optimizer(cfg, params, steps_per_epoch: int):
    """The optimizer of both trainers (``cfg``: a pretrain or a classifier
    config) on every parameter given (BN and bias included), and MultiStepLR
    gamma 0.1 at ``epoch * steps_per_epoch`` step boundaries (reference
    pretrain.py:272,328). The scheduler is stepped once per train step.

    * ``'sgd'``: momentum 0.9 with the weight decay added to the gradient,
      the JAX package's ``chain(add_decayed_weights, sgd)``;
    * ``'adam'``: ``AdamW(betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)``,
      the arithmetic of the JAX package's ``optax.adamw(lr,
      weight_decay=wd)`` (decoupled decay scaled by the lr, bias-corrected
      moments, eps outside the square root)."""
    o = cfg.optim
    if o.optim == "sgd":
        optimizer = torch.optim.SGD(params, lr=o.lr, momentum=o.momentum,
                                    weight_decay=o.wd, dampening=0,
                                    nesterov=False)
    elif o.optim == "adam":
        optimizer = torch.optim.AdamW(params, lr=o.lr, betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=o.wd)
    else:
        raise ValueError(f"optim must be 'sgd' or 'adam', got {o.optim!r}")
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=[e * steps_per_epoch for e in o.schedule],
        gamma=0.1)
    return optimizer, scheduler


def compute_metrics(ret: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Per-loss scalars + accuracies, mirroring the reference's dynamic meter
    discovery (pretrain.py:404-445); under a process group each averaged
    over the processes, which makes it the global batch's."""
    metrics: dict[str, torch.Tensor] = {}
    for key, val in ret.items():
        if not key.endswith("loss"):
            continue
        prefix = key.replace("contrast_loss", "").replace("loss", "").rstrip("_")
        metrics[f"{prefix}_loss"] = val.detach()
        for lk in (f"{prefix}_logits", f"{prefix}_margin_logits"):
            if lk in ret:
                labels = ret[lk.replace("logits", "labels")]
                logits = ret[lk].detach()
                metrics[f"{prefix}_top1"] = topk_accuracy(logits, labels, (1,))[0]
                if prefix == "clip":
                    metrics["clip_top5"] = topk_accuracy(logits, labels, (1, 5))[1]
    metrics["total_loss"] = total_loss(ret).detach()
    return dist.mean_over_ranks(metrics)


def make_train_step(task, optimizer, scheduler, aug_cfg: AugConfig,
                    autocast_dtype: torch.dtype = torch.float32):
    """Returns ``train_step(frames_u8, generator) -> metrics``. The generator
    feeds the augmentation draws and the segment shuffle. Under a process
    group the gradient is averaged over the processes before the update."""
    def train_step(frames_u8: torch.Tensor, generator: torch.Generator):
        with torch.no_grad():
            block = pretrain_batch(generator, frames_u8, aug_cfg)
        with torch.autocast(device_type=frames_u8.device.type,
                            dtype=autocast_dtype,
                            enabled=autocast_dtype != torch.float32):
            ret = task.forward(block, generator=generator)
        loss = total_loss(ret)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        dist.average_gradients(task.parameters())
        optimizer.step()
        scheduler.step()
        with torch.no_grad():
            return compute_metrics(ret)

    return train_step


def dataset_variant(dataset: str) -> str:
    """Map the reference's dataset-name suffixes to pretrain clip-sampler
    variants (reference get_data, pretrain.py:535-548)."""
    if dataset.endswith("2clip-stage-prototype"):
        return "stage-prototype"
    if dataset.endswith("2clip-prototype"):
        return "prototype"
    if dataset.endswith("2clip"):
        return "2clip"
    return "stage-prototype"


def build_dataset(cfg: PretrainConfig, n_views: int = 3):
    d = cfg.data
    if d.synthetic:
        entries, class_index = synthetic_entries(
            d.synthetic_videos, d.synthetic_classes)
        source = SyntheticFrameSource(scale=d.scale_hw)
    else:
        name = d.dataset.split("-")[0]  # ucf101 | hmdb51 | k400
        root = d.data_root or os.path.join("process_data", "data", name)
        entries = load_split(root, mode="train", which_split=d.which_split,
                             val_size=d.val_size)
        class_index = load_class_index(root)
        source = JpegFrameSource(d.db_path, scale=d.scale_hw,
                                 fast_decode=d.fast_decode)
    return PretrainDataset(
        entries=entries, class_index=class_index, source=source,
        num_frames=d.seq_len, ds=d.ds, rand_flip=cfg.aug.rand_flip,
        aug_series=cfg.aug.aug_series and n_views == 3,
        variant=dataset_variant(d.dataset),
    )


def set_path(cfg: PretrainConfig, create: bool = True) -> str:
    """log/{prefix}/pretrain/{name}/ layout (reference pretrain.py:567-591),
    made unless ``create`` is false."""
    exp = os.path.join(cfg.run.log_root, cfg.run.prefix, "pretrain",
                       cfg.run.name_prefix)
    if create:
        os.makedirs(os.path.join(exp, "model"), exist_ok=True)
    return exp


def aug_config(cfg: PretrainConfig) -> AugConfig:
    """The augmentation of the train step (and of ``visualize``)."""
    return AugConfig(
        img_dim=cfg.data.img_dim, seq_len=cfg.data.seq_len,
        aug_temp_consist=cfg.aug.aug_temp_consist,
        aug_temp_grad_consist=cfg.aug.aug_temp_grad_consist,
        jitter_order=cfg.aug.jitter_order,
        fused=cfg.aug.fused_aug,
    )


def build_task(cfg: PretrainConfig):
    """The task of ``cfg``, its parameters drawn from ``cfg.run.seed`` (the
    process-global RNG is left untouched)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.run.seed)
        return make_task(cfg.model,
                         torch.Generator().manual_seed(cfg.run.seed))


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' (--device cpu) to run "
            "on the CPU on purpose")
    return device


class TrainSetup(NamedTuple):
    """Everything one run of the train step needs, as ``train()`` builds it."""

    task: object
    model: torch.nn.Module
    loader: HostLoader  # the caller closes it
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    train_step: Callable  # (frames_u8, generator) -> metrics
    generator: torch.Generator  # feeds every random draw of the run


def setup_training(cfg: PretrainConfig,
                   device: str | torch.device = "cuda") -> TrainSetup:
    """Model, data, optimizer and train step for ``cfg`` on ``device``.

    Model init and every random draw of the run come from explicit
    generators seeded with ``cfg.run.seed``; the process-global RNG is left
    untouched. Under a process group every process builds the same model
    (checked once), loads its shard of the data, and draws from
    ``cfg.run.seed + rank``: process 0 draws what a run of one process
    draws."""
    device = _resolve_device(device)
    task = build_task(cfg)
    model = task.model.to(device)
    model.train()
    dist.assert_replicas_equal(
        list(model.parameters()) + list(model.buffers()),
        "the model's initial parameters and buffers")
    loader = HostLoader(build_dataset(cfg, task.n_views),
                        cfg.optim.batch_size, shuffle=True,
                        seed=cfg.run.seed, num_workers=cfg.data.workers,
                        process_index=dist.rank(),
                        process_count=dist.world_size())
    optimizer, scheduler = make_optimizer(cfg, task.parameters(),
                                          len(loader))
    train_step = make_train_step(task, optimizer, scheduler, aug_config(cfg),
                                 _AUTOCAST[cfg.model.dtype])
    # on the device: the augmentation's draws and the segment shuffles are
    # made there, with no copy from the host
    generator = torch.Generator(device=device).manual_seed(
        cfg.run.seed + dist.rank())
    return TrainSetup(task, model, loader, optimizer, scheduler, train_step,
                      generator)


def training_state(model, optimizer, scheduler, generator, epoch: int,
                   iteration: int, best_acc: float,
                   generators: list | None = None) -> dict:
    """What a checkpoint holds: everything a resumed run needs to go on as
    the uninterrupted run would. ``generators``: under a process group,
    every process's generator state in rank order
    (``dist.gather_generator_states``); ``generator`` is this process's."""
    sched = scheduler.state_dict()
    # a plain dict: torch.load's weights-only reader rebuilds a Counter's
    # items as its keys
    sched["milestones"] = dict(sched["milestones"])
    state = {"epoch": epoch, "iteration": iteration, "best_acc": best_acc,
             "state_dict": model.state_dict(),
             "optimizer": optimizer.state_dict(), "scheduler": sched,
             "generator": generator.get_state()}
    if generators is not None:
        state["generators"] = generators
    return state


def restore_training_state(ckpt: dict, model, optimizer, scheduler,
                           generator) -> None:
    """Load a checkpoint of ``training_state`` into the run's objects (the
    optimizer's state moves to its parameters' device). Each process takes
    its own generator state; a process whose rank the checkpoint has no
    state for (it was saved by fewer processes) keeps its fresh one."""
    model.load_state_dict(ckpt["state_dict"])
    optimizer.load_state_dict(ckpt["optimizer"])
    sched = dict(ckpt["scheduler"])
    sched["milestones"] = collections.Counter(sched["milestones"])
    scheduler.load_state_dict(sched)
    states = ckpt.get("generators", [ckpt["generator"]])
    if dist.rank() < len(states):
        generator.set_state(states[dist.rank()])


def resume_training(resume: str, store: CheckpointStore, model, optimizer,
                    scheduler, generator, logger):
    """``--resume auto`` (this run's ``store``) or ``--resume <dir>`` (a
    store that must hold a checkpoint): the latest checkpoint restored into
    the run's objects. Returns (next epoch, iteration, best accuracy), or
    None where ``auto`` finds no checkpoint."""
    source = store
    if resume != "auto":
        source = CheckpointStore(resume) if os.path.isdir(resume) else None
        if source is None or source.latest_epoch() is None:
            raise FileNotFoundError(
                f"--resume {resume!r}: no checkpoint there")
    last = source.latest_epoch()
    if last is None:
        logger.info("[warning] no checkpoint found, training from scratch")
        return None
    ckpt = source.restore(last)
    restore_training_state(ckpt, model, optimizer, scheduler, generator)
    saved_by = len(ckpt.get("generators", [None]))
    if saved_by != dist.world_size():
        logger.info(f"[warning] the checkpoint holds the generators of "
                    f"{saved_by} processes, this run has "
                    f"{dist.world_size()}: the others start fresh")
    logger.info(f"=> resumed from epoch {last} (iteration "
                f"{ckpt['iteration']}) of {source.directory}")
    return last + 1, ckpt["iteration"], ckpt["best_acc"]


def load_pretrain_weights(model: torch.nn.Module, path: str,
                          logger=None) -> dict[str, list[str]]:
    """``--pretrain``: a weights-only, tolerant load of the checkpoint at
    ``path`` (file or directory) into ``model`` — every entry whose key and
    shape match, MoCo's key encoder, queues and pointer included; the
    optimizer, the scheduler and the epoch start fresh (the JAX package's
    ``_load_pretrain_weights``). A SimCLR or backbone-only checkpoint loads
    into MoCo's query encoder, a MoCo one's query encoder into a SimCLR
    model. Returns the report of ``merge_matching_leaves``."""
    dst, src = model.state_dict(), load_state_dict(path)
    q = "encoder_q."
    if any(k.startswith(q) for k in dst) != any(k.startswith(q) for k in src):
        # across families: MoCo's query encoder holds what a SimCLR model
        # (or a backbone alone) holds, as in the JAX package's trees
        src = ({q + k: v for k, v in src.items()}
               if any(k.startswith(q) for k in dst)
               else {k[len(q):]: v for k, v in src.items()
                     if k.startswith(q)})
    merged, report = merge_matching_leaves(dst, src, logger)
    model.load_state_dict(merged)
    return report


class _StepProfiler:
    """``torch.profiler`` over the steps ``first + 1 .. first + steps`` of
    a run whose first step is ``first`` (the JAX trainer's window: the
    first step, which builds and warms up, is left out), CUDA activity
    included on the card; the trace goes to ``{directory}/rank<r>.pt.
    trace.json``. A run that ends inside the window writes what it
    traced."""

    def __init__(self, steps: int, first: int, directory: str,
                 device: torch.device, logger):
        self.steps, self.first = steps, first
        self.path = os.path.join(directory, f"rank{dist.rank()}.pt.trace.json")
        self.device, self.logger = device, logger
        self.prof, self.traced = None, 0

    def before(self, step: int) -> None:
        if self.steps and step == self.first + 1:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.start()

    def after(self, step: int) -> None:
        if self.prof is None:
            return
        self.traced += 1
        if step == self.first + self.steps:
            self.finish()

    def finish(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        self.logger.info(f"profiler trace of {self.traced} steps written to "
                         f"'{self.path}'")


def train(cfg: PretrainConfig, max_steps: int | None = None,
          device: str | torch.device = "cuda",
          profile_steps: int = 0) -> dict[str, float]:
    """Full pretraining loop. Returns the last logged step's metrics (under
    a process group the global batch's, on every process). Joins the
    process group torchrun's environment names (``dist.init_distributed``);
    a group the caller made is used as it is. ``profile_steps`` > 0 traces
    that many steps after the run's first (``_StepProfiler``) under
    ``{exp}/img/profile``."""
    device = _resolve_device(device)
    dist.init_distributed(device)
    exp_path = set_path(cfg, create=dist.is_main())
    logger = get_logger(os.path.join(exp_path, "log"),
                        process_index=dist.rank())
    logger.info(f"=> creating {cfg.model.model} with '{cfg.model.net}' "
                f"backbone on {device}")
    if device.type == "cuda":
        # cuDNN convolutions may use TF32 for float32 inputs (the bf16
        # autocast path does not depend on it); float32 matmuls stay full
        # precision, which the float32 heads and losses rely on
        torch.backends.cudnn.allow_tf32 = True
        logger.info(
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    task, model, loader, optimizer, scheduler, train_step, generator = \
        setup_training(cfg, device)
    steps_per_epoch = len(loader)
    logger.info(f"train dataset size {len(loader.dataset)}, "
                f"{steps_per_epoch} steps/epoch")
    logger.info(f"=> Effective batch = "
                f"{cfg.optim.batch_size * dist.world_size()} "
                f"({dist.world_size()} processes x {cfg.optim.batch_size})")
    n_params = sum(p.numel() for p in task.parameters())
    logger.info(f"params: {n_params / 1e6:.2f}M")

    # process 0 writes the store; the others open it only to resume, once
    # it exists and its leftovers are gone
    store = None
    if dist.is_main():
        store = CheckpointStore(os.path.join(exp_path, "model"),
                                keep_all=cfg.run.keep_all,
                                async_save=cfg.run.async_ckpt)
    dist.barrier()
    start_epoch = cfg.optim.start_epoch
    best_acc = 0.0
    global_step = start_epoch * steps_per_epoch
    if cfg.run.resume:
        resumed = resume_training(
            cfg.run.resume, store or CheckpointStore(
                os.path.join(exp_path, "model")),
            model, optimizer, scheduler, generator, logger)
        if resumed:
            start_epoch, global_step, best_acc = resumed
    elif cfg.run.pretrain:
        load_pretrain_weights(model, cfg.run.pretrain, logger)
        logger.info(f"=> loaded pretrain weights from '{cfg.run.pretrain}'")
    writer = (MetricsWriter(os.path.join(exp_path, "img", "pretrain"))
              if dist.is_main() else None)
    profiler = _StepProfiler(profile_steps, global_step,
                             os.path.join(exp_path, "img", "profile"),
                             device, logger)
    final_metrics: dict[str, float] = {}
    done = False
    try:
        for epoch in range(start_epoch, cfg.optim.epochs):
            bank = MeterBank()
            t_data = AverageMeter("Data", ":.3f")
            t_batch = AverageMeter("Time", ":.3f")
            progress = ProgressMeter(
                steps_per_epoch, [],
                prefix=f"Epoch:[{epoch}/{cfg.optim.epochs}] "
                       f"lr:{scheduler.get_last_lr()[0]:.5f} ",
                logger=logger)
            tic = time.time()
            end = time.time()

            # overlap the host-to-device copy with compute: batches are placed
            # on the device one step ahead of consumption
            def placed_frames():
                for b in loader.epoch(epoch):
                    yield torch.from_numpy(b["frames"]).to(
                        device, non_blocking=True)

            batches = placed_frames()
            lookahead = next(batches, None)
            it = -1
            while lookahead is not None:
                it += 1
                frames = lookahead
                lookahead = next(batches, None)
                t_data.update(time.time() - end)
                profiler.before(global_step)
                metrics = train_step(frames, generator)
                profiler.after(global_step)
                if (it + 1) % cfg.run.print_freq == 0 or it == steps_per_epoch - 1:
                    # .item() waits for the device: the only sync point
                    final_metrics = {k: v.item() for k, v in metrics.items()}
                    if not math.isfinite(final_metrics["total_loss"]):
                        raise FloatingPointError(
                            f"non-finite total loss at step {global_step}: "
                            f"{final_metrics}")
                    B = cfg.optim.batch_size
                    for k, v in final_metrics.items():
                        if k.endswith("_loss"):
                            bank.loss(k[:-5]).update(v, B)
                        elif k.endswith("top1"):
                            bank.acc(k[:-5]).update(v, B)
                    progress.meters = [t_batch, t_data] + bank.all_meters()
                    progress.display(it)
                    if writer:
                        for k, v in final_metrics.items():
                            writer.add_scalar(f"local/{k}", v, global_step)
                t_batch.update(time.time() - end)
                end = time.time()
                global_step += 1
                if max_steps is not None and global_step >= max_steps:
                    done = True
                    break

            logger.info(
                f"Epoch: [{epoch}/{cfg.optim.epochs}]\tT-epoch:{time.time() - tic:.2f}")
            if writer:
                for key, m in bank.losses.items():
                    writer.add_scalar(f"global/{key}_loss", m.avg, epoch)
                for key, m in bank.accs.items():
                    writer.add_scalar(f"global/{key}_acc", m.avg, epoch)
            last = epoch == cfg.optim.epochs - 1 or done
            if (epoch + 1) % cfg.run.eval_freq == 0 or last:
                train_acc = bank.accs["clip"].avg if "clip" in bank.accs else 0.0
                best_acc = max(best_acc, train_acc)
                if (epoch + 1) % cfg.run.save_freq == 0 or last:
                    generators = dist.gather_generator_states(generator)
                    saved = store is None or store.save(
                        epoch, training_state(
                            model, optimizer, scheduler, generator, epoch,
                            global_step, best_acc, generators),
                        {"acc": train_acc})
                    if saved:
                        logger.info(f"saved checkpoint epoch {epoch} "
                                    f"(acc {train_acc:.4f})")
                    else:
                        logger.info(
                            f"[warning] checkpoint epoch {epoch} not saved: "
                            f"the store already holds epoch "
                            f"{store.latest_epoch()}")
            if done:
                break
    finally:
        profiler.finish()
        loader.close()
        if writer:
            writer.close()
        if store is not None:
            store.close()

    logger.info(
        f"Training from ep {start_epoch} to ep {cfg.optim.epochs} finished")
    return final_metrics


def visualize(cfg: PretrainConfig, n_samples: int = 4,
              device: str | torch.device = "cuda") -> list[str]:
    """The reference's ``--visualize`` (pretrain.py:555,581-584), as the
    JAX package's ``visualize``: the first ``n_samples`` clips of an
    unshuffled loader through the train step's augmentation; view 0's middle
    frame, denormalised, and the middle time slice of each stage's
    channel-mean attention map (min-max scaled) written as PNGs under
    ``{exp}/img/`` (``vis_sample{i}_input_0.png``,
    ``vis_sample{i}_stage{s}_0.png``) and to TensorBoard where it imports.

    The weights come from ``cfg.run.pretrain`` (a weights-only load) when
    set, otherwise from the seeded init. Needs pillow and the multi_level
    backbone (``r21d``). Returns the written files' paths."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        raise RuntimeError(
            "--visualize writes PNGs and needs pillow (without it the "
            "writer falls back to .npy dumps and the returned paths would "
            "be wrong)")
    if cfg.model.remat:
        raise ValueError("--visualize needs remat=False (the rematerialised "
                         "backbone has no multi_level forward)")
    if cfg.model.net != "r21d":
        raise ValueError(
            f"--visualize needs the multi_level backbone ('r21d'), got "
            f"{cfg.model.net!r} (reference get_features, model/simclr.py:123)")
    device = _resolve_device(device)
    exp_path = set_path(cfg)
    logger = get_logger(os.path.join(exp_path, "vis_log"))
    task = build_task(cfg)
    task.model.to(device)
    if cfg.run.pretrain:
        load_pretrain_weights(task.model, cfg.run.pretrain, logger)
        logger.info(f"=> visualizing weights from '{cfg.run.pretrain}'")

    dataset = build_dataset(cfg, task.n_views)
    B = min(n_samples, len(dataset))
    # unshuffled: the reference disables shuffling under --visualize
    # (pretrain.py:555), so runs compare across checkpoints
    with HostLoader(dataset, B, shuffle=False, seed=cfg.run.seed,
                    num_workers=cfg.data.workers) as loader:
        frames = next(iter(loader.epoch(0)))["frames"]
    generator = torch.Generator(device=device).manual_seed(cfg.run.seed + 1)
    with torch.no_grad():
        block = pretrain_batch(generator, torch.from_numpy(frames).to(device),
                               aug_config(cfg))
    view0 = block[:, 0]  # (B, T, d, d, 3), normalised
    dtype = _AUTOCAST[cfg.model.dtype]
    with torch.autocast(device_type=device.type, dtype=dtype,
                        enabled=dtype != torch.float32):
        attn = task.get_features(view0)

    writer = MetricsWriter(exp_path)  # images land under {exp}/img/
    written = []
    mid = view0.shape[1] // 2
    inputs = batch_denorm(view0[:, mid].permute(0, 3, 1, 2)).clamp(0.0, 1.0)
    inputs = inputs.permute(0, 2, 3, 1).float().cpu().numpy()
    img_dir = os.path.join(exp_path, "img")
    for i in range(B):
        writer.add_image(f"vis/sample{i}/input", inputs[i], 0)
        written.append(os.path.join(img_dir, f"vis_sample{i}_input_0.png"))
        for s, fmap in enumerate(attn):
            a = fmap[i].cpu().numpy()  # (T', H', W')
            a = a[a.shape[0] // 2]  # middle time slice
            lo, hi = float(a.min()), float(a.max())
            a = (a - lo) / (hi - lo) if hi > lo else a * 0.0
            writer.add_image(f"vis/sample{i}/stage{s}", a, 0)
            written.append(os.path.join(img_dir,
                                        f"vis_sample{i}_stage{s}_0.png"))
    writer.close()
    logger.info(f"wrote {len(written)} visualization images under {img_dir}")
    return written


def _override(group, args, names):
    """dataclasses.replace(group) with every non-None CLI value in names."""
    kw = {n: getattr(args, n) for n in names if getattr(args, n) is not None}
    return dataclasses.replace(group, **kw) if kw else group


def main(argv: list[str] | None = None):
    """Flag surface mirrors the JAX trainer's (reference parser
    pretrain.py:90-164), cut to what this package supports; a preset
    supplies the defaults, every flag overrides it."""
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="paper_table1_k400",
                   choices=sorted(PRETRAIN_PRESETS))
    # model group
    p.add_argument("--net", default=None)
    p.add_argument("--model", default=None)
    p.add_argument("--mode", "--series_mode", dest="mode", default=None,
                   choices=[None, "clip-sr-tc", "clip-sr", "clip-sr-dtw"])
    p.add_argument("--n_series", type=int, default=None)
    p.add_argument("--series_dim", type=int, default=None)
    p.add_argument("--shufflerank_theta", type=float, default=None)
    p.add_argument("--series_T", type=float, default=None)
    p.add_argument("--aligned_T", type=float, default=None)
    p.add_argument("--moco-dim", dest="moco_dim", type=int, default=None)
    p.add_argument("--moco-k", dest="moco_k", type=int, default=None)
    p.add_argument("--moco-m", dest="moco_m", type=float, default=None)
    p.add_argument("--moco-t", dest="moco_t", type=float, default=None)
    p.add_argument("--moco_shuffle_bn", type=int, default=None,
                   help="BN batch-shuffle parity mode: number of BN groups")
    p.add_argument("--remat", action="store_true", default=None,
                   help="rematerialize backbone activations in the backward "
                        "pass (torch.utils.checkpoint; less memory, about "
                        "1/3 more FLOPs)")
    p.add_argument("--dtype", default=None, choices=[None, "bfloat16", "float32"],
                   help="autocast type of the model forward on the card")
    p.add_argument("--packed_encode", type=int, default=None,
                   choices=[None, 0, 1],
                   help="pack the SR shuffled pass into the main encode "
                        "batch (BN train stats merge across views — "
                        "documented divergence, see core/config.py)")
    # aug group
    p.add_argument("--jitter_order", default=None,
                   choices=[None, "batch", "sample"])
    p.add_argument("--aug_temp_consist", type=int, default=None,
                   choices=[None, 0, 1])
    p.add_argument("--aug_series", type=int, default=None, choices=[None, 0, 1])
    p.add_argument("--rand_flip", type=int, default=None, choices=[None, 0, 1])
    p.add_argument("--fused_aug", default=None,
                   choices=[None, "auto", "on", "off"],
                   help="fused CUDA aug kernel (default auto: on for CUDA)")
    # dataset group
    p.add_argument("--dataset", default=None)
    p.add_argument("--data_root", default=None)
    p.add_argument("--db_path", default=None)
    p.add_argument("--synthetic", type=int, default=None, choices=[None, 0, 1],
                   help="deterministic generated frames, no files needed")
    p.add_argument("--val_size", type=int, default=None)
    p.add_argument("--seq_len", type=int, default=None)
    p.add_argument("--ds", type=int, default=None)
    p.add_argument("--img_dim", type=int, default=None)
    p.add_argument("-j", "--workers", type=int, default=None)
    p.add_argument("--num_seq", type=int, default=None)
    p.add_argument("--fast_decode", type=int, default=None, choices=[None, 0, 1],
                   help="native decoder DCT-domain scaled decode (close to, "
                        "not bitwise, the exact decode; needs the native "
                        "decoder)")
    # optim group
    p.add_argument("--optim", default=None, choices=[None, "sgd", "adam"])
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--wd", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--start_epoch", type=int, default=None)
    p.add_argument("--schedule", nargs="*", type=int, default=None)
    # run group
    p.add_argument("--prefix", default=None)
    p.add_argument("--name_prefix", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--print_freq", type=int, default=None)
    p.add_argument("--eval_freq", type=int, default=None)
    p.add_argument("--save_freq", type=int, default=None)
    p.add_argument("--resume", default=None,
                   help="'auto' (this run's model/ store) or a store "
                        "directory: go on from its latest epoch")
    p.add_argument("--pretrain", default=None,
                   help="checkpoint file or directory: weights only")
    p.add_argument("--async_ckpt", type=int, default=None, choices=[None, 0, 1],
                   help="overlap checkpoint writes with training (default 1)")
    # run control
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace this many steps after the first with "
                        "torch.profiler into {exp}/img/profile")
    p.add_argument("--visualize", action="store_true",
                   help="write input and attention-map images under "
                        "{exp}/img/ instead of training (reference "
                        "pretrain.py:581; needs --net r21d; use --pretrain "
                        "for trained weights)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    cfg = PRETRAIN_PRESETS[args.preset]
    if args.packed_encode is not None:
        args.packed_encode = bool(args.packed_encode)
    data = _override(cfg.data, args,
                     ("dataset", "data_root", "db_path", "seq_len", "ds",
                      "img_dim", "workers", "num_seq", "val_size"))
    if args.fast_decode is not None:
        data = dataclasses.replace(data, fast_decode=bool(args.fast_decode))
    if args.synthetic is not None:
        data = dataclasses.replace(data, synthetic=bool(args.synthetic))
    if args.data_root or args.db_path:
        data = dataclasses.replace(data, synthetic=False)
    aug = _override(cfg.aug, args, ("jitter_order", "fused_aug"))
    for k in ("aug_temp_consist", "aug_series", "rand_flip"):
        v = getattr(args, k)
        if v is not None:
            aug = dataclasses.replace(aug, **{k: bool(v)})
    cfg = cfg.replace(
        data=data,
        aug=aug,
        model=_override(cfg.model, args,
                        ("net", "model", "mode", "n_series", "series_dim",
                         "shufflerank_theta", "series_T", "aligned_T",
                         "moco_dim", "moco_k", "moco_m", "moco_t",
                         "moco_shuffle_bn", "dtype", "packed_encode",
                         "remat")),
        optim=_override(
            dataclasses.replace(
                cfg.optim,
                schedule=tuple(args.schedule) if args.schedule else cfg.optim.schedule),
            args, ("batch_size", "lr", "wd", "epochs", "start_epoch",
                   "optim")),
        run=_override(cfg.run, args,
                      ("prefix", "name_prefix", "seed", "print_freq",
                       "eval_freq", "save_freq", "resume", "pretrain")),
    )
    if args.async_ckpt is not None:
        cfg = cfg.replace(run=dataclasses.replace(
            cfg.run, async_ckpt=bool(args.async_ckpt)))
    if args.visualize:
        visualize(cfg, device=args.device)
        return
    try:
        train(cfg, max_steps=args.max_steps, device=args.device,
              profile_steps=args.profile_steps)
    finally:
        dist.destroy()


if __name__ == "__main__":
    main()
