"""Downstream classification trainer: finetune / linear-probe training,
validation, the multi-crop and temporal-10-clip test protocols, and k-NN
video retrieval (reference classifier.py entry point).

Counterpart of ``dualvar_tpu/train/classifier.py``. Modes (reference
classifier.py:38-108 flags + :273-319 dispatch):

* train: finetune (``'ft'``) or linear probe (``'last'``: the whole model in
  inference mode, so BN uses its running statistics and dropout is off, and
  the backbone out of the optimizer, reference classifier.py:240-253,
  435-438);
* test center / five / ten crop (classifier.py:545-654 test_10crop);
* test temporal 10-clip (classifier.py:657-738 temporal_test_10clip);
* retrieval: 10-clip averaged features, centred and L2-normalised cosine
  k-NN, R@{1,5,10,20,50} (classifier.py:787-995 test_retrieval).

The train step's augmentation goes through the fused CUDA kernel
(``aug/pipeline.py:classifier_train_batch``, blur off); eval and the test
protocols only crop and normalise. ``--pretrain`` grafts the backbone of a
port pretrain checkpoint (``core/checkpoint.py``). Checkpoints go through
``CheckpointStore`` under ``model/`` (best five by validation accuracy),
with the fields of the pretrain trainer's; ``--resume`` (``auto`` or a
store directory) resumes training from its latest epoch, and gives the
test protocols the latest classifier checkpoint of a store (or a file).
Runs on ``cuda`` unless the caller passes ``device="cpu"``, and a missing
card is an error.

Data-parallel across processes when launched with torchrun
(``core/dist.py``), as the pretrain trainer: ``batch_size`` per process,
the finetune's batch norms over the global batch, the gradient averaged
over the processes, the logged metrics and the validation sums over the
global batch; process 0 logs and writes. The test protocols shard the test
set by process, gather every process's results and drop the duplicates
that pad the shards, by video id (the JAX package's ``_gather_concat`` /
``_dedupe_by_vid``); their accuracies equal a single process's.

Usage:
    python -m dualvar_tpu_torch.train.classifier --preset paper_table1_ucf_ft \\
        --synthetic 1 --pretrain log/paper_table1_k400/pretrain/exp/model
    python -m dualvar_tpu_torch.train.classifier --preset smoke --device cpu
    python -m dualvar_tpu_torch.train.classifier --preset smoke --device cpu \\
        --test retrieval
    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m dualvar_tpu_torch.train.classifier --preset paper_table1_ucf_ft \\
        --synthetic 1 --pretrain log/paper_table1_k400/pretrain/exp/model

Process 0 writes the metrics through ``core/metrics_writer.py`` under
``{exp}/img/train``: ``local/<metric>`` at each logged step, ``val/top1`` at
each validation. ``--fused_aug`` (``auto``, ``on``, ``off``) chooses the
train batch's augmentation as pretrain's flag does
(``aug/pipeline.py:_use_fused``): ``off`` takes the unfused per-frame
path on any device. ``--optim adam``, ``--remat`` and ``--fast_decode 1``
work as in the pretrain trainer.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..aug.pipeline import (AugConfig, classifier_train_batch, eval_batch,
                            tenclip_batch, tencrop_batch)
from ..core import dist
from ..core.checkpoint import (CheckpointStore, load_pretrained_backbone,
                               load_state_dict)
from ..core.config import CLASSIFIER_PRESETS, ClassifierConfig
from ..core.logging import get_logger
from ..core.meters import AverageMeter, ProgressMeter
from ..core.metrics_writer import MetricsWriter
from ..data.indices import load_class_index, load_split
from ..data.loader import (ClassifierDataset, HostLoader, JpegFrameSource,
                           SyntheticFrameSource, TenClipDataset,
                           synthetic_entries)
from ..models.backbones import select_backbone
from ..models.heads import LinearClassifier
from ..models.ssl.losses import cross_entropy_from_logits, topk_accuracy
from .pretrain import (_AUTOCAST, _override, _resolve_device, make_optimizer,
                       resume_training, training_state)


def build_model(cfg: ClassifierConfig, seed: int = 0) -> LinearClassifier:
    """The classifier, initialised from ``seed`` (the process-global RNG is
    left untouched)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        backbone, param = select_backbone(cfg.model.net,
                                          remat=cfg.model.remat)
        return LinearClassifier(
            backbone, param["feature_size"], num_class=cfg.num_class,
            dropout_rate=cfg.dropout, use_dropout=cfg.use_dropout,
            use_l2_norm=cfg.use_l2_norm, use_final_bn=cfg.use_final_bn)


def trainable_parameters(model: LinearClassifier,
                         train_what: str) -> list[torch.nn.Parameter]:
    """What the optimizer updates: every parameter in ``'ft'`` mode; in
    ``'last'`` mode (the probe) the head only, with the backbone's
    parameters set not to require gradients, so that neither a gradient nor
    the weight decay moves them (reference classifier.py:240-247)."""
    if train_what == "ft":
        return list(model.parameters())
    if train_what == "last":
        model.backbone.requires_grad_(False)
        return [p for name, p in model.named_parameters()
                if not name.startswith("backbone.")]
    raise ValueError(f"train_what must be 'ft' or 'last', got {train_what!r}")


def make_train_step(model: LinearClassifier, optimizer, scheduler,
                    aug_cfg: AugConfig, train_what: str,
                    autocast_dtype: torch.dtype = torch.float32):
    """Returns ``train_step(frames_u8, labels, generator) -> metrics``. The
    generator feeds the augmentation draws and the dropout mask. Under a
    process group the gradient is averaged over the processes before the
    update, and the metrics are the global batch's."""
    probe = train_what == "last"

    def train_step(frames_u8: torch.Tensor, labels: torch.Tensor,
                   generator: torch.Generator):
        with torch.no_grad():
            clips = classifier_train_batch(generator, frames_u8, aug_cfg)
        # the probe applies the whole model in inference mode, as the JAX
        # package applies it with train=False: BN running statistics are
        # used and left as they are, dropout is off
        model.train(not probe)
        with torch.autocast(device_type=frames_u8.device.type,
                            dtype=autocast_dtype,
                            enabled=autocast_dtype != torch.float32):
            logit, _ = model(clips, generator=generator)
        loss = cross_entropy_from_logits(logit, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        dist.average_gradients(model.parameters())
        optimizer.step()
        scheduler.step()
        with torch.no_grad():
            top1, top5 = topk_accuracy(logit, labels, (1, 5))
        return dist.mean_over_ranks(
            {"loss": loss.detach(), "top1": top1, "top5": top5})

    return train_step


def _forward(model: LinearClassifier, clips: torch.Tensor,
             autocast_dtype: torch.dtype):
    """Inference-mode forward -> (float32 logits, feat)."""
    model.eval()
    with torch.no_grad(), torch.autocast(
            device_type=clips.device.type, dtype=autocast_dtype,
            enabled=autocast_dtype != torch.float32):
        logit, feat = model(clips)
    return logit.float(), feat


def make_eval_step(model: LinearClassifier, aug_cfg: AugConfig,
                   autocast_dtype: torch.dtype = torch.float32):
    """Returns ``eval_step(frames_u8, labels) -> sums`` of the loss, top-1
    and top-5 hits and the count over the batch (the JAX package's masked
    sums, with no padding: eager batches may be short)."""

    def eval_step(frames_u8: torch.Tensor, labels: torch.Tensor):
        logit, _ = _forward(model, eval_batch(frames_u8, aug_cfg),
                            autocast_dtype)
        labels = labels.long()
        logp = torch.log_softmax(logit, dim=-1)
        per_loss = -logp.gather(1, labels[:, None])[:, 0]
        top1 = (logit.argmax(dim=1) == labels).float()
        k5 = logit.topk(min(5, logit.shape[-1]), dim=1).indices
        top5 = (k5 == labels[:, None]).any(dim=1).float()
        return {"loss": per_loss.sum(), "top1": top1.sum(),
                "top5": top5.sum(), "n": torch.tensor(float(len(labels)))}

    return eval_step


def build_datasets(cfg: ClassifierConfig, mode: str):
    d = cfg.data
    if d.synthetic:
        entries, class_index = synthetic_entries(
            d.synthetic_videos, d.synthetic_classes)
        source = SyntheticFrameSource(scale=d.scale_hw)
    else:
        name = "hmdb51" if "hmdb" in d.dataset else (
            "k400" if "k400" in d.dataset else "ucf101")
        root = d.data_root or os.path.join("process_data", "data", name)
        entries = load_split(root, mode=mode, which_split=d.which_split,
                             val_size=d.val_size)
        class_index = load_class_index(root)
        source = JpegFrameSource(d.db_path, scale=d.scale_hw,
                                 fast_decode=d.fast_decode)
    return entries, class_index, source


def classifier_dataset(cfg: ClassifierConfig, mode: str) -> ClassifierDataset:
    entries, class_index, source = build_datasets(cfg, mode)
    return ClassifierDataset(
        entries=entries, class_index=class_index, source=source,
        num_frames=cfg.data.seq_len * cfg.data.num_seq, ds=cfg.data.ds,
        mode=mode)


def tenclip_dataset(cfg: ClassifierConfig, mode: str) -> TenClipDataset:
    entries, class_index, source = build_datasets(cfg, mode)
    return TenClipDataset(
        entries=entries, class_index=class_index, source=source,
        num_frames=cfg.data.seq_len, ds=cfg.data.ds)


def set_path(cfg: ClassifierConfig, create: bool = True) -> str:
    """log/{prefix}/ft/{name}/{ucf|hmdb}/ layout (classifier.py:1087-1116),
    made unless ``create`` is false."""
    fold = "hmdb" if "hmdb" in cfg.data.dataset else "ucf"
    exp = os.path.join(cfg.run.log_root, cfg.run.prefix, "ft",
                       cfg.run.name_prefix, fold)
    if create:
        os.makedirs(os.path.join(exp, "model"), exist_ok=True)
    return exp


def graft_pretrained(model: LinearClassifier, path: str,
                     logger=None) -> dict[str, list[str]]:
    """Load the backbone of the pretrain checkpoint at ``path`` (a file or
    a ``model/`` directory) into ``model``; returns the graft's report."""
    state, report = load_pretrained_backbone(
        model.state_dict(), load_state_dict(path), logger)
    model.load_state_dict(state)
    if logger:
        logger.info(f"=> loaded pretrained checkpoint '{path}'")
    return report


def _aug_config(cfg: ClassifierConfig) -> AugConfig:
    return AugConfig(
        img_dim=cfg.data.img_dim, seq_len=cfg.data.seq_len,
        with_color_jitter=cfg.aug.with_color_jitter,
        rand_flip=cfg.aug.rand_flip, jitter_order=cfg.aug.jitter_order,
        fused=cfg.aug.fused_aug)


class TrainSetup(NamedTuple):
    """Everything one run of the train step needs, as ``train()`` builds it."""

    model: LinearClassifier
    loader: HostLoader  # the caller closes it
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    train_step: Callable  # (frames_u8, labels, generator) -> metrics
    generator: torch.Generator  # feeds every random draw of the run


def setup_training(cfg: ClassifierConfig, device: str | torch.device = "cuda",
                   logger=None) -> TrainSetup:
    """Model (grafted from ``cfg.run.pretrain`` if set), train data,
    optimizer and train step for ``cfg`` on ``device``. Model init and every
    random draw of the run come from ``cfg.run.seed``; under a process group
    each process loads its shard and draws from ``cfg.run.seed + rank``."""
    device = _resolve_device(device)
    model = build_model(cfg, cfg.run.seed)
    if cfg.run.pretrain:
        graft_pretrained(model, cfg.run.pretrain, logger)
    model.to(device)
    dist.assert_replicas_equal(
        list(model.parameters()) + list(model.buffers()),
        "the classifier's initial parameters and buffers")
    loader = HostLoader(classifier_dataset(cfg, "train"),
                        cfg.optim.batch_size, shuffle=True,
                        seed=cfg.run.seed, num_workers=cfg.data.workers,
                        process_index=dist.rank(),
                        process_count=dist.world_size())
    optimizer, scheduler = make_optimizer(
        cfg, trainable_parameters(model, cfg.train_what), len(loader))
    train_step = make_train_step(model, optimizer, scheduler,
                                 _aug_config(cfg), cfg.train_what,
                                 _AUTOCAST[cfg.model.dtype])
    # on the device: the augmentation's draws and the dropout mask are made
    # there, with no copy from the host
    generator = torch.Generator(device=device).manual_seed(
        cfg.run.seed + dist.rank())
    return TrainSetup(model, loader, optimizer, scheduler, train_step,
                      generator)


def train(cfg: ClassifierConfig, max_steps: int | None = None,
          device: str | torch.device = "cuda") -> dict[str, float]:
    """Train loop with validation every ``eval_freq`` epochs (and at the
    end), each validation saving a checkpoint of the pretrain trainer's
    fields to the ``model/`` store, ranked by validation accuracy.
    ``cfg.run.resume`` goes on from the latest epoch of a store. Returns the
    last logged step's metrics and ``val_top1``."""
    device = _resolve_device(device)
    dist.init_distributed(device)
    exp_path = set_path(cfg, create=dist.is_main())
    logger = get_logger(os.path.join(exp_path, "log"),
                        process_index=dist.rank())
    logger.info(f"Classifier to {cfg.num_class} classes with "
                f"{cfg.model.net} backbone on {device}, "
                f"train_what={cfg.train_what}")
    if device.type == "cuda":
        # as train/pretrain.py: cuDNN convolutions may use TF32 for float32
        # inputs; float32 matmuls stay full precision
        torch.backends.cudnn.allow_tf32 = True
    model, loader, optimizer, scheduler, train_step, generator = \
        setup_training(cfg, device, logger)
    autocast_dtype = _AUTOCAST[cfg.model.dtype]
    eval_step = make_eval_step(model, _aug_config(cfg), autocast_dtype)
    # sharded like train: the padded shards keep the processes in step, and
    # the validation sums count the padding, as the JAX package's do
    val_loader = HostLoader(classifier_dataset(cfg, "val"),
                            cfg.optim.batch_size, shuffle=False,
                            seed=cfg.run.seed, num_workers=cfg.data.workers,
                            drop_last=False, process_index=dist.rank(),
                            process_count=dist.world_size())
    steps_per_epoch = len(loader)
    logger.info(f"=> Effective batch = "
                f"{cfg.optim.batch_size * dist.world_size()} "
                f"({dist.world_size()} processes x {cfg.optim.batch_size}); "
                f"{steps_per_epoch} steps/epoch")

    store = None
    if dist.is_main():
        store = CheckpointStore(os.path.join(exp_path, "model"),
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
    writer = (MetricsWriter(os.path.join(exp_path, "img", "train"))
              if dist.is_main() else None)
    final: dict[str, float] = {}
    done = False
    try:
        for epoch in range(start_epoch, cfg.optim.epochs):
            meters = {k: AverageMeter(k, ":.4f")
                      for k in ("loss", "top1", "top5")}
            progress = ProgressMeter(
                steps_per_epoch, list(meters.values()),
                prefix=f"Epoch:[{epoch}/{cfg.optim.epochs}] "
                       f"lr:{scheduler.get_last_lr()[0]:.5f} ",
                logger=logger)
            tic = time.time()
            for it, batch in enumerate(loader.epoch(epoch)):
                frames = torch.from_numpy(batch["frames"]).to(device)
                labels = torch.from_numpy(batch["label"]).to(device)
                metrics = train_step(frames, labels, generator)
                if (it + 1) % cfg.run.print_freq == 0 \
                        or it == steps_per_epoch - 1:
                    # .item() waits for the device: the only sync point
                    final = {k: v.item() for k, v in metrics.items()}
                    if not math.isfinite(final["loss"]):
                        raise FloatingPointError(
                            f"non-finite loss at step {global_step}: {final}")
                    for k, m in meters.items():
                        m.update(final[k], cfg.optim.batch_size)
                    progress.display(it)
                    if writer:
                        for k, v in final.items():
                            writer.add_scalar(f"local/{k}", v, global_step)
                global_step += 1
                if max_steps is not None and global_step >= max_steps:
                    done = True
                    break
            logger.info(
                f"train epoch [{epoch}] T-epoch:{time.time() - tic:.2f}")

            if (epoch + 1) % cfg.run.eval_freq == 0 or done:
                sums = {"loss": 0.0, "top1": 0.0, "top5": 0.0, "n": 0.0}
                for batch in val_loader.epoch(0):
                    m = eval_step(
                        torch.from_numpy(batch["frames"]).to(device),
                        torch.from_numpy(batch["label"]).to(device))
                    for k in sums:
                        sums[k] += m[k].item()
                sums = dist.sum_over_ranks(sums)
                n = max(sums["n"], 1.0)
                val_acc = sums["top1"] / n
                logger.info(
                    f"val Epoch: [{epoch}] Loss: {sums['loss'] / n:.4f} "
                    f"Acc@1: {val_acc:.4f} Acc@5: {sums['top5'] / n:.4f}")
                if writer:
                    writer.add_scalar("val/top1", val_acc, epoch)
                final["val_top1"] = val_acc
                best_acc = max(best_acc, val_acc)
                generators = dist.gather_generator_states(generator)
                saved = store is None or store.save(epoch, training_state(
                    model, optimizer, scheduler, generator, epoch,
                    global_step, best_acc, generators), {"acc": val_acc})
                if saved:
                    logger.info(f"saved checkpoint epoch {epoch} "
                                f"(acc {val_acc:.4f})")
                else:
                    logger.info(
                        f"[warning] checkpoint epoch {epoch} not saved: "
                        f"the store already holds epoch "
                        f"{store.latest_epoch()}")
            if done:
                break
    finally:
        loader.close()
        val_loader.close()
        if writer:
            writer.close()
        if store is not None:
            store.close()
    return final


# --------------------------------------------------------------------------
# test protocols
# --------------------------------------------------------------------------

def _test_loader(cfg: ClassifierConfig, dataset) -> HostLoader:
    """This process's shard of ``dataset``, padded to the others' length."""
    return HostLoader(dataset, cfg.optim.batch_size, shuffle=False, seed=0,
                      num_workers=cfg.data.workers, drop_last=False,
                      process_index=dist.rank(),
                      process_count=dist.world_size())


def _dedupe_by_vid(vids: np.ndarray, *arrays: np.ndarray):
    """The first record of each video id, in the order of the ids: the
    shards' padding repeats some videos."""
    _, first = np.unique(vids, return_index=True)
    return tuple(a[first] for a in (vids,) + arrays)


def _load_test_state(cfg: ClassifierConfig, model: LinearClassifier,
                     logger) -> None:
    """``--resume``: a classifier checkpoint ``train`` wrote (a file, or the
    latest epoch of a ``model/`` store); else ``--pretrain``: the graft;
    else the random init."""
    if cfg.run.resume:
        model.load_state_dict(load_state_dict(cfg.run.resume))
        logger.info(f"=> loaded test checkpoint '{cfg.run.resume}'")
    elif cfg.run.pretrain:  # retrieval directly from a pretrain checkpoint
        graft_pretrained(model, cfg.run.pretrain, logger)
    else:
        logger.info("[warning] testing with random init weights")


def _test_setup(cfg: ClassifierConfig, device, log_name: str):
    """(device, exp_path, logger, model on the device, autocast type), in
    the process group torchrun's environment names, if any."""
    device = _resolve_device(device)
    dist.init_distributed(device)
    exp_path = set_path(cfg, create=dist.is_main())
    logger = get_logger(os.path.join(exp_path, log_name),
                        process_index=dist.rank())
    model = build_model(cfg)
    _load_test_state(cfg, model, logger)
    return (device, exp_path, logger, model.to(device),
            _AUTOCAST[cfg.model.dtype])


def test_multicrop(cfg: ClassifierConfig, protocol: str = "ten",
                   device: str | torch.device = "cuda") -> dict[str, float]:
    """center / five / ten-crop test (reference test_10crop,
    classifier.py:545-654): softmax probabilities averaged over the crop x
    flip combinations and the test windows of each video. One pass yields
    the nested groups center ⊂ five ⊂ ten, as the reference reports them."""
    device, exp_path, logger, model, autocast_dtype = _test_setup(
        cfg, device, "test_log")
    aug_cfg = AugConfig(img_dim=cfg.data.img_dim, seq_len=cfg.data.seq_len)
    dataset = classifier_dataset(cfg, "test")
    aug_list = {"center": [5], "five": [5, 1, 2, 3, 4],
                "ten": [5, 1, 2, 3, 4]}[protocol]
    flip_list = [0, 1] if protocol == "ten" else [0]
    groups = ["center", "five", "ten"][
        : {"center": 1, "five": 2, "ten": 3}[protocol]]
    n_class = cfg.num_class
    # probabilities summed per record (video, window) over each group's
    # passes. A pass writes each record it sees (a shard's padding may show
    # a record twice, to this process or another: the same value), so the
    # processes' sums, divided by how many processes saw a record, are a
    # single process's
    prob_rec = {g: np.zeros((len(dataset), n_class), np.float64)
                for g in groups}
    g_passes = {g: 0 for g in groups}
    seen = np.zeros(len(dataset), bool)
    labels_arr = np.full(len(dataset.entries), -1, np.int64)
    with _test_loader(cfg, dataset) as loader:
        for flip in flip_list:
            for where in aug_list:
                logger.info(f"Aug type: {where}; flip: {flip}")
                tmp = np.zeros((len(dataset), n_class), np.float64)
                for batch in loader.epoch(0):
                    clips = tencrop_batch(
                        torch.from_numpy(batch["frames"]).to(device),
                        aug_cfg, where, bool(flip))
                    logit, _ = _forward(model, clips, autocast_dtype)
                    tmp[batch["rid"]] = logit.softmax(dim=-1).cpu().numpy()
                    seen[batch["rid"]] = True
                    labels_arr[batch["vid"]] = batch["label"]
                for g, member in (("center", flip == 0 and where == 5),
                                  ("five", flip == 0), ("ten", True)):
                    if g in prob_rec and member:
                        prob_rec[g] += tmp
                        g_passes[g] += 1
    if dist.active():
        gathered = dist.gather_concat(
            labels_arr[None], seen[None].astype(np.int64),
            *[prob_rec[g][None] for g in groups])
        labels_arr = gathered[0].max(axis=0)
        seen_by = gathered[1].sum(axis=0)
        for i, g in enumerate(groups):
            prob_rec[g] = (gathered[2 + i].sum(axis=0)
                           / np.maximum(seen_by, 1)[:, None])
        seen = seen_by > 0

    # mean over a video's records and the group's passes
    rec_vid = dataset.record_vids()[seen]
    n_rec = np.bincount(rec_vid, minlength=len(labels_arr))
    out: dict[str, float] = {}
    for g in groups:
        prob_sum = np.zeros((len(labels_arr), n_class), np.float64)
        np.add.at(prob_sum, rec_vid, prob_rec[g][seen])
        mean_probs = prob_sum / (n_rec * g_passes[g])[:, None]
        top1 = float(np.mean(mean_probs.argmax(1) == labels_arr))
        topk = np.argsort(-mean_probs, axis=1)[:, :min(5, n_class)]
        top5 = float(np.mean((topk == labels_arr[:, None]).any(axis=1)))
        logger.info(f"{g}-crop: Mean: Acc@1: {top1:.4f} Acc@5: {top5:.4f}")
        out[f"{g}_top1"], out[f"{g}_top5"] = top1, top5
    out["top1"], out["top5"] = out[f"{protocol}_top1"], out[f"{protocol}_top5"]
    if dist.is_main():
        with open(os.path.join(exp_path, f"prob-{protocol}.json"), "w") as f:
            json.dump(out, f)
    return out


def _tenclip_pass(cfg: ClassifierConfig, model: LinearClassifier, mode: str,
                  aug_cfg: AugConfig, device, autocast_dtype):
    """One pass over the 10-clip dataset of ``mode``: per video the softmax
    probabilities averaged over its 10 clips (N, C), the features averaged
    (N, D), the per-clip features (N, 10, D), the labels (N,), and the
    dataset; under a process group every process's videos, gathered, each
    once, in the order of their ids."""
    dataset = tenclip_dataset(cfg, mode)
    probs, feats, pers, labels, vids = [], [], [], [], []
    with _test_loader(cfg, dataset) as loader:
        for batch in loader.epoch(0):
            clips = tenclip_batch(
                torch.from_numpy(batch["frames"]).to(device), aug_cfg)
            B = clips.shape[0]
            logit, feat = _forward(
                model, clips.reshape(B * 10, *clips.shape[2:]),
                autocast_dtype)
            per = feat.reshape(B, 10, -1)
            probs.append(logit.softmax(dim=-1).reshape(B, 10, -1)
                         .mean(dim=1).cpu().numpy())
            feats.append(per.mean(dim=1).cpu().numpy())  # classifier.py:888
            pers.append(per.cpu().numpy())
            labels.append(batch["label"])
            vids.append(batch["vid"])
    _, *arrays = _dedupe_by_vid(*dist.gather_concat(*(
        np.concatenate(a) for a in (vids, probs, feats, pers, labels))))
    return (*arrays, dataset)


def test_temporal_tenclip(cfg: ClassifierConfig,
                          device: str | torch.device = "cuda"
                          ) -> dict[str, float]:
    """Temporal 10-clip centre-crop test (reference temporal_test_10clip,
    classifier.py:657-738): per video, the mean softmax over 10 uniform
    clips; with the class-wise summary (classifier.py:741-759)."""
    device, exp_path, logger, model, autocast_dtype = _test_setup(
        cfg, device, "temporal_10_test_log")
    aug_cfg = AugConfig(img_dim=cfg.data.img_dim, seq_len=cfg.data.seq_len)
    probs, _, _, labels, _ = _tenclip_pass(cfg, model, "test", aug_cfg,
                                           device, autocast_dtype)
    top1 = float(np.mean(probs.argmax(1) == labels))
    top5 = float(np.mean([
        l in np.argsort(-p)[:5] for p, l in zip(probs, labels)]))
    logger.info(
        f"temporal 10-clip: Mean: Acc@1: {top1:.4f} Acc@5: {top5:.4f}")
    classwise: dict[int, list[int]] = {}
    for p, l in zip(probs, labels):
        classwise.setdefault(int(l), []).append(int(p.argmax() == l))
    class_acc = {int(k): float(np.mean(v)) for k, v in classwise.items()}
    out = {"top1": top1, "top5": top5, "classwise": class_acc}
    if dist.is_main():
        with open(os.path.join(exp_path, "prob-temporal_10_clip.json"),
                  "w") as f:
            json.dump(out, f)
    return out


def extract_tenclip_features(cfg: ClassifierConfig, model: LinearClassifier,
                             mode: str, aug_cfg: AugConfig,
                             device: str | torch.device = "cuda",
                             autocast_dtype: torch.dtype = torch.float32):
    """Per-video 10-clip features: (mean feature (N, D), per-clip feature
    (N, 10, D), label (N,), video names) — the artifact set the reference
    persists per split (classifier.py:878-915)."""
    _, feats, pers, labels, dataset = _tenclip_pass(
        cfg, model, mode, aug_cfg, device, autocast_dtype)
    return feats, pers, labels, [e.vname for e in dataset.entries]


def test_retrieval(cfg: ClassifierConfig,
                   device: str | torch.device = "cuda") -> dict[str, float]:
    """k-NN video retrieval (reference test_retrieval, classifier.py:787-995):
    test videos against train videos by cosine similarity of their centred,
    L2-normalised 10-clip features; R@k is the share of test videos with a
    train video of their class among the k nearest."""
    device, exp_path, logger, model, autocast_dtype = _test_setup(
        cfg, device, "test_retrieval_log")
    aug_cfg = AugConfig(img_dim=cfg.data.img_dim, seq_len=cfg.data.seq_len)
    test_f, test_p, test_l, test_v = extract_tenclip_features(
        cfg, model, "test", aug_cfg, device, autocast_dtype)
    train_f, train_p, train_l, train_v = extract_tenclip_features(
        cfg, model, "train", aug_cfg, device, autocast_dtype)
    logger.info(f"test {test_f.shape}, train {train_f.shape}")

    # the reference's artifact set (classifier.py:861-915,977) as npy /
    # json, written by process 0
    ds_name = cfg.data.dataset.split("-")[0]
    feat_dir = os.path.join(exp_path, cfg.dirname)
    write = dist.is_main()
    if write:
        os.makedirs(feat_dir, exist_ok=True)
    for split, f, p, l, v in (("test", test_f, test_p, test_l, test_v),
                              ("train", train_f, train_p, train_l, train_v)):
        if not write:
            break
        np.save(os.path.join(feat_dir, f"{ds_name}_{split}_feature.npy"), f)
        np.save(os.path.join(feat_dir, f"{ds_name}_{split}_per_feature.npy"),
                p)
        np.save(os.path.join(feat_dir, f"{ds_name}_{split}_label.npy"), l)
        with open(os.path.join(feat_dir, f"{ds_name}_{split}_vname.json"),
                  "w") as fp:
            json.dump(list(v), fp)

    # centering + L2 norm + cosine similarity (classifier.py:966-975)
    test_f = test_f - test_f.mean(0, keepdims=True)
    train_f = train_f - train_f.mean(0, keepdims=True)
    test_f /= np.maximum(np.linalg.norm(test_f, axis=1, keepdims=True), 1e-12)
    train_f /= np.maximum(np.linalg.norm(train_f, axis=1, keepdims=True),
                          1e-12)
    sim = test_f @ train_f.T
    if write:
        np.save(os.path.join(feat_dir, f"{ds_name}_sim.npy"), sim)

    out = {}
    for k in (1, 5, 10, 20, 50):
        topk = np.argsort(-sim, axis=1)[:, :min(k, sim.shape[1])]
        hit = (train_l[topk] == test_l[:, None]).any(axis=1)
        out[f"R@{k}"] = float(hit.mean())
        logger.info(f"R@{k} ({k}NN acc) = {out[f'R@{k}']:.4f}")
    if write:
        with open(os.path.join(feat_dir, "retrieval.json"), "w") as f:
            json.dump(out, f)
    return out


def main(argv: list[str] | None = None):
    """Flag surface of the JAX classifier CLI (reference parser
    classifier.py:38-108)
    plus ``--device`` and ``--synthetic``; a preset supplies the defaults,
    every flag overrides it."""
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="smoke", choices=sorted(CLASSIFIER_PRESETS))
    p.add_argument("--test", default="",
                   choices=["", "center", "five", "ten", "temporal_ten_clip",
                            "retrieval"])
    # model / probe group
    p.add_argument("--net", default=None)
    p.add_argument("--remat", action="store_true", default=None,
                   help="rematerialize backbone activations in the backward pass")
    p.add_argument("--train_what", default=None, choices=[None, "ft", "last"])
    p.add_argument("--use_dropout", action="store_const", const=True, default=None)
    p.add_argument("--use_norm", dest="use_l2_norm", action="store_const",
                   const=True, default=None)
    p.add_argument("--use_bn", dest="use_final_bn", action="store_const",
                   const=True, default=None)
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--jitter_order", default=None,
                   choices=[None, "batch", "sample"],
                   help="color-jitter op-order granularity: 'sample' is the "
                        "reference-exact per-clip order")
    p.add_argument("--fused_aug", default=None,
                   choices=[None, "auto", "on", "off"],
                   help="fused CUDA aug kernel (default auto: on for CUDA; "
                        "off: the unfused per-frame path)")
    p.add_argument("--with_color_jitter", type=int, default=None,
                   choices=[None, 0, 1],
                   help="finetune-time color jitter (classifier.py:50)")
    p.add_argument("--aug_crop", type=int, default=None, choices=[None, 0, 1],
                   help="1 (default): fixed 128x171 portrait resize before "
                        "the test crop (reference --aug_crop + img_dim 112, "
                        "classifier.py:688-693); 0: short-side resize to "
                        "img_resize_dim")
    p.add_argument("--rand_flip", type=int, default=None, choices=[None, 0, 1],
                   help="random horizontal flip in finetune aug "
                        "(classifier.py:1015)")
    # dataset group
    p.add_argument("--dataset", default=None)
    p.add_argument("--which_split", type=int, default=None)
    p.add_argument("--seq_len", type=int, default=None)
    p.add_argument("--num_seq", type=int, default=None)
    p.add_argument("--ds", type=int, default=None)
    p.add_argument("--img_dim", type=int, default=None)
    p.add_argument("--img_resize_dim", type=int, default=None,
                   help="host resize short side (classifier.py:58)")
    p.add_argument("-j", "--workers", type=int, default=None)
    p.add_argument("--fast_decode", type=int, default=None, choices=[None, 0, 1],
                   help="native decoder DCT-domain scaled decode (needs the "
                        "native decoder)")
    p.add_argument("--data_root", default=None)
    p.add_argument("--db_path", default=None)
    p.add_argument("--synthetic", type=int, default=None, choices=[None, 0, 1],
                   help="deterministic generated frames, no files needed")
    p.add_argument("--val_size", type=int, default=None)
    # optim group
    p.add_argument("--optim", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--wd", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--schedule", nargs="*", type=int, default=None)
    # run group
    p.add_argument("--prefix", default=None)
    p.add_argument("--name_prefix", default=None)
    p.add_argument("--print_freq", type=int, default=None)
    p.add_argument("--eval_freq", type=int, default=None)
    p.add_argument("--save_freq", type=int, default=None)
    p.add_argument("--pretrain", default=None)
    p.add_argument("--resume", default=None,
                   help="train: 'auto' (this run's model/ store) or a store "
                        "directory to go on from; --test: a classifier "
                        "checkpoint file or store directory")
    p.add_argument("--dirname", default=None,
                   help="retrieval feature-dump dir under the experiment "
                        "path (reference classifier.py:77; default 'feature')")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    cfg = CLASSIFIER_PRESETS[args.preset]
    num_class_by_dataset = {"ucf101": 101, "hmdb51": 51}
    if args.dataset:
        cfg = dataclasses.replace(
            cfg, num_class=num_class_by_dataset.get(
                args.dataset.split("-")[0], cfg.num_class))
    data = _override(cfg.data, args,
                     ("dataset", "which_split", "seq_len", "num_seq", "ds",
                      "img_dim", "workers", "data_root", "db_path",
                      "val_size"))
    if args.img_resize_dim is not None:
        # reference Scale(img_resize_dim) is a short-side resize; the static
        # pipeline keeps the 4:3 source aspect at the new short side
        r = args.img_resize_dim
        data = dataclasses.replace(data, img_resize_dim=r,
                                   scale_hw=(round(r * 171 / 128), r))
    if args.aug_crop == 0:
        # reference non-aug_crop test path: Scale(img_resize_dim) short-side
        # resize (classifier.py:684-687), landscape for 4:3 frame trees
        r = data.img_resize_dim
        data = dataclasses.replace(data, scale_hw=(r, round(r * 171 / 128)))
    if args.fast_decode is not None:
        data = dataclasses.replace(data, fast_decode=bool(args.fast_decode))
    if args.synthetic is not None:
        data = dataclasses.replace(data, synthetic=bool(args.synthetic))
    if args.data_root or args.db_path:
        data = dataclasses.replace(data, synthetic=False)
    aug = _override(cfg.aug, args, ("jitter_order", "fused_aug"))
    for k in ("with_color_jitter", "rand_flip", "aug_crop"):
        v = getattr(args, k)
        if v is not None:
            aug = dataclasses.replace(aug, **{k: bool(v)})
    cfg = dataclasses.replace(
        cfg,
        data=data,
        aug=aug,
        model=_override(cfg.model, args, ("net", "remat")),
        optim=_override(
            dataclasses.replace(
                cfg.optim,
                schedule=tuple(args.schedule) if args.schedule else cfg.optim.schedule),
            args, ("optim", "batch_size", "lr", "wd", "epochs")),
        run=_override(cfg.run, args,
                      ("prefix", "name_prefix", "print_freq",
                       "eval_freq", "save_freq", "pretrain", "resume")),
    )
    for name in ("train_what", "use_dropout", "use_l2_norm", "use_final_bn",
                 "dropout", "dirname"):
        if getattr(args, name) is not None:
            cfg = dataclasses.replace(cfg, **{name: getattr(args, name)})

    try:
        if args.test == "retrieval":
            test_retrieval(cfg, args.device)
        elif args.test == "temporal_ten_clip":
            test_temporal_tenclip(cfg, args.device)
        elif args.test in ("center", "five", "ten"):
            test_multicrop(cfg, args.test, args.device)
        else:
            train(cfg, max_steps=args.max_steps, device=args.device)
    finally:
        dist.destroy()


if __name__ == "__main__":
    main()
