"""Typed configuration: frozen dataclasses mirroring the reference argparse
groups, with the paper scripts' hyperparameters as named presets.

Own copy of ``dualvar_tpu/core/config.py`` (the port imports nothing of the
JAX package). The fields the port has carry the JAX package's names and
defaults, so a preset means the same experiment in both packages.

Three fields read differently here:

* ``ModelConfig.dtype`` is the autocast type of the model's forward pass on
  the card (parameters, BN statistics, heads and losses stay float32);
* ``AugFlags.fused_aug='auto'`` means the hand-written CUDA kernel
  (``ops/aug_fused.py``) whenever the batch lies on a CUDA device, in both
  trainers; ``'off'`` is the unfused per-frame path (``aug/pipeline.py``)
  on any device;
* ``DataConfig.fast_decode`` raises where the native decoder is not
  available, where the JAX package decodes exactly instead.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "ucf101-2clip-stage-prototype"  # pretrain.py:115
    data_root: str = ""  # ClassInd + split CSVs directory
    db_path: str = ""  # frame JPEG root
    seq_len: int = 16  # frames per clip (pretrain.py:116)
    num_seq: int = 2  # clips per sample (pretrain.py:117)
    ds: int = 4  # temporal stride (pretrain.py:118)
    img_dim: int = 112  # crop size (pretrain.py:119)
    img_resize_dim: int = 128  # classifier.py:58
    which_split: int = 1
    # rows carved out of the train CSV as the fixed validation subset
    # (reference local_dataset.py:96-104, seeded 666)
    val_size: int = 800
    workers: int = 8
    synthetic: bool = False  # no-filesystem deterministic data
    # native decoder DCT-domain scaled decode: ~1/4 the IDCT work on frames
    # larger than scale_hw; pixels close to (not bitwise) the exact decode
    fast_decode: bool = False
    synthetic_videos: int = 64
    synthetic_classes: int = 8
    # host resize target (H, W) — Scale((128,171)) semantics: width 128,
    # height 171 (pretrain.py:494; PIL resize takes (W, H))
    scale_hw: tuple[int, int] = (171, 128)


@dataclass(frozen=True)
class AugFlags:
    aug_temp_consist: bool = True  # pretrain.py:124, paper scripts pass it
    aug_temp_grad_consist: bool = False
    aug_series: bool = True  # pretrain.py:125
    rand_flip: bool = True  # temporal flip in pretrain; spatial in classifier
    with_color_jitter: bool = True  # classifier.py:50
    aug_crop: bool = True  # classifier.py:104 — Scale((128,171)) when img_dim 112
    # 'sample': reference-exact per-clip random op order
    # (augmentation.py:510); 'batch': one draw per (step, view)
    jitter_order: str = "sample"
    # fused CUDA aug kernel (ops/aug_fused.py): 'auto' = the kernel on a CUDA
    # device, its plain version on the CPU; 'on'/'off' force
    fused_aug: str = "auto"


@dataclass(frozen=True)
class ModelConfig:
    net: str = "r21d"  # backbone (pretrain.py:93)
    model: str = "simclr_timeseriesv4"  # pretrain.py:94
    moco_dim: int = 128  # pretrain.py:106
    moco_k: int = 2048  # pretrain.py:108
    moco_m: float = 0.999  # pretrain.py:110
    moco_t: float = 0.07  # pretrain.py:112
    # BN batch-shuffle parity mode: >0 splits the key batch into this many
    # BN groups after a random permutation (reference moco.py:128-173);
    # 0 = whole-batch BN (default)
    moco_shuffle_bn: int = 0
    n_series: int = 2  # pretrain.py:97
    series_dim: int = 64  # pretrain.py:96
    shufflerank_theta: float = 0.05  # pretrain.py:98
    series_T: float = 0.07  # pretrain.py:99
    aligned_T: float = 0.07  # pretrain.py:101
    mode: str = "clip-sr-tc"  # pretrain.py:103; also 'clip-sr-dtw'
    dtw_gamma: float = 0.1  # soft-DTW smoothing for the dtw TC mode
    dtype: str = "bfloat16"  # autocast type on the card (params stay f32)
    # pack the SR shuffled-clip pass into the main encode batch: one 4B
    # backbone batch instead of 3B + B. Train-mode BN statistics then merge
    # across the four groups, exactly as in the JAX package under the same
    # flag — a documented divergence from the reference's separate passes.
    packed_encode: bool = False
    # recompute the backbone's activations in the backward pass
    # (torch.utils.checkpoint): the same numbers, about 1/3 more FLOPs, far
    # less activation memory
    remat: bool = False


@dataclass(frozen=True)
class OptimConfig:
    optim: str = "sgd"
    batch_size: int = 8  # per-host batch (paper_table1 pretrain .sh:15)
    lr: float = 0.003  # per-process lr, paper_table1 pretrain .sh:15
    wd: float = 1e-4
    momentum: float = 0.9  # pretrain.py:272
    epochs: int = 200
    start_epoch: int = 0
    schedule: tuple[int, ...] = (120, 160)  # x0.1 drops (pretrain.py:328)


@dataclass(frozen=True)
class RunConfig:
    prefix: str = "pretrain"
    name_prefix: str = "exp"
    print_freq: int = 20
    eval_freq: int = 5
    save_freq: int = 5
    seed: int = 0
    resume: str = ""
    pretrain: str = ""
    keep_all: bool = False  # keep every checkpoint (k400 runs)
    # overlap checkpoint writes with training (core/checkpoint.py)
    async_ckpt: bool = True
    log_root: str = "log"


@dataclass(frozen=True)
class PretrainConfig:
    data: DataConfig = field(default_factory=DataConfig)
    aug: AugFlags = field(default_factory=AugFlags)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def replace(self, **kw) -> "PretrainConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ClassifierConfig:
    data: DataConfig = field(default_factory=lambda: DataConfig(
        dataset="ucf101", num_seq=1, ds=2))
    aug: AugFlags = field(default_factory=lambda: AugFlags(rand_flip=True))
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=lambda: OptimConfig(
        batch_size=4, lr=0.05, wd=1e-3, epochs=150, schedule=(50, 100)))
    run: RunConfig = field(default_factory=lambda: RunConfig(prefix="linclr"))
    train_what: str = "ft"  # 'ft' finetune all | 'last' linear probe
    num_class: int = 101
    use_dropout: bool = False
    dropout: float = 0.5
    use_l2_norm: bool = False
    use_final_bn: bool = False
    # retrieval feature-dump directory under the experiment path
    # (reference --dirname, classifier.py:77,861-864; default 'feature')
    dirname: str = "feature"


def _smoke_data(**kw) -> DataConfig:
    return DataConfig(
        synthetic=True, synthetic_videos=32, synthetic_classes=4,
        seq_len=8, ds=2, img_dim=64, scale_hw=(80, 72), workers=2, **kw)


PRETRAIN_PRESETS: dict[str, PretrainConfig] = {
    # paper_scripts/paper_table1_k400/pretrain/*.sh — SimCLR TimeSeriesV4,
    # r21d, k400, 8x batch 8, lr .003, wd 1e-4, 200 ep, drops [120,160]
    "paper_table1_k400": PretrainConfig(
        data=DataConfig(dataset="k400-2clip-stage-prototype", ds=4),
        model=ModelConfig(net="r21d", model="simclr_timeseriesv4"),
        optim=OptimConfig(batch_size=8, lr=0.003, wd=1e-4, epochs=200,
                          schedule=(120, 160)),
        run=RunConfig(prefix="paper_table1_k400", keep_all=True),
    ),
    # paper_scripts/paper_table2_moco_r21d/pretrain/*.sh — MoCo K=16384
    "paper_table2_moco_r21d": PretrainConfig(
        data=DataConfig(dataset="ucf101-2clip-stage-prototype", ds=4),
        model=ModelConfig(net="r21d", model="moco_timeseriesv4", moco_k=16384),
        optim=OptimConfig(batch_size=8, lr=0.003, wd=1e-4, epochs=200,
                          schedule=(120, 160)),
        run=RunConfig(prefix="paper_table2_moco_r21d"),
    ),
    # paper_scripts/paper_table2_re_simclr_r21d — SimCLR on UCF101
    "paper_table2_re_simclr_r21d": PretrainConfig(
        data=DataConfig(dataset="ucf101-2clip-stage-prototype", ds=4),
        model=ModelConfig(net="r21d", model="simclr_timeseriesv4"),
        optim=OptimConfig(batch_size=8, lr=0.003, wd=1e-4, epochs=200,
                          schedule=(120, 160)),
        run=RunConfig(prefix="paper_table2_re_simclr_r21d"),
    ),
    "s3dg_k400": PretrainConfig(
        data=DataConfig(dataset="k400-2clip-stage-prototype", ds=4),
        model=ModelConfig(net="s3dg", model="simclr_timeseriesv4"),
        optim=OptimConfig(batch_size=8, lr=0.003, wd=1e-4, epochs=200,
                          schedule=(120, 160)),
        run=RunConfig(prefix="s3dg_k400", keep_all=True),
    ),
    # CPU-runnable synthetic smokes (same names and sizes as the JAX package)
    "smoke": PretrainConfig(
        data=_smoke_data(),
        model=ModelConfig(net="r3d", model="simclr_naked", dtype="float32"),
        optim=OptimConfig(batch_size=4, lr=0.01, epochs=2, schedule=(1,)),
        run=RunConfig(prefix="smoke", print_freq=1, eval_freq=1, save_freq=1),
    ),
    "smoke_dualvar": PretrainConfig(
        data=_smoke_data(),
        model=ModelConfig(net="r3d", model="simclr_timeseriesv4", dtype="float32"),
        optim=OptimConfig(batch_size=4, lr=0.01, epochs=1, schedule=(1,)),
        run=RunConfig(prefix="smoke_dualvar", print_freq=1),
    ),
    "smoke_moco": PretrainConfig(
        data=_smoke_data(),
        model=ModelConfig(net="r3d", model="moco_timeseriesv4", moco_k=32,
                          dtype="float32"),
        optim=OptimConfig(batch_size=4, lr=0.01, epochs=1, schedule=(1,)),
        run=RunConfig(prefix="smoke_moco", print_freq=1),
    ),
}


CLASSIFIER_PRESETS: dict[str, ClassifierConfig] = {
    # paper_scripts/paper_table1_k400/finetune/*.sh
    "paper_table1_ucf_ft": ClassifierConfig(
        data=DataConfig(dataset="ucf101", num_seq=1, ds=2),
        optim=OptimConfig(batch_size=4, lr=0.05, wd=1e-3, epochs=150,
                          schedule=(50, 100)),
        run=RunConfig(prefix="paper_table1_k400"),
        train_what="ft", num_class=101,
    ),
    "paper_table1_hmdb_ft": ClassifierConfig(
        data=DataConfig(dataset="hmdb51", num_seq=1, ds=2),
        optim=OptimConfig(batch_size=4, lr=0.05, wd=1e-3, epochs=100,
                          schedule=(30, 60, 80)),
        run=RunConfig(prefix="paper_table1_k400"),
        train_what="ft", num_class=51,
    ),
    "smoke": ClassifierConfig(
        data=_smoke_data(dataset="ucf101", num_seq=1),
        model=ModelConfig(net="r3d", dtype="float32"),
        optim=OptimConfig(batch_size=4, lr=0.05, epochs=2, schedule=(1,)),
        run=RunConfig(prefix="smoke", print_freq=1, eval_freq=1),
        train_what="ft", num_class=4,
    ),
}
