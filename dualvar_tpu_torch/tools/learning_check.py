"""Does training learn? Four checks that a loss falls well below its chance
plateau, through the port's own trainers (``train.pretrain.train`` and
``train.classifier.train``): the counterparts of the JAX package's
``scripts/learning_check.py`` (``main``, ``classifier_check``) and
``scripts/real_data_learning_check.py``, with their configurations and
pass conditions:

==================== ========================================== ===== ==========================
check                configuration                              steps pass condition
==================== ========================================== ===== ==========================
simclr_naked         preset ``smoke``, r3d, seq 8, img 64,      300   clip_loss < ln(2B-1) - 0.4
                     scale (80, 72), 32 synthetic videos, B=16,
                     lr 0.003, bfloat16 autocast
simclr_timeseriesv4  the same, SimCLR TimeSeriesV4              300   clip_loss < ln(2B-1) - 0.4
classifier           classifier preset ``smoke``, r3d, 4        360   val_top1 > 0.6
                     classes, 64 synthetic videos, B=16, lr 0.01
real_files           ``simclr_naked`` from a JPEG frame tree     60   clip_loss < ln(2B-1) - 0.3
                     written from the synthetic videos (quality
                     90, reference layout, split CSV), decoded by
                     the loader (native decoder or PIL)
==================== ========================================== ===== ==========================

The synthetic videos are low-frequency colour waves, so instance
discrimination on them is learnable (the JAX script found lr 0.03 at B=16
collapses the embeddings in a step; the recipe's 0.003 learns).

Run on the card from the repo root::

    python3 -m dualvar_tpu_torch.tools.learning_check            # all four
    python3 -m dualvar_tpu_torch.tools.learning_check --check classifier

Each check prints its loss every 20 steps and one JSON record; the exit
code is 1 when a check fails. ``run_check`` also takes a device, a batch,
a clip size and an autocast type, with which the tests run the plumbing a
few steps on the CPU (a pass needs the full configuration).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

CHECKS = ("simclr_naked", "simclr_timeseriesv4", "classifier", "real_files")
STEPS = {"simclr_naked": 300, "simclr_timeseriesv4": 300, "classifier": 360,
         "real_files": 60}
BATCH = 16
# below the chance plateau ln(2B-1) by this much (the JAX scripts' margins)
MARGIN = {"simclr_naked": 0.4, "simclr_timeseriesv4": 0.4, "real_files": 0.3}
CLASSIFIER_TOP1 = 0.6
CURVE_EVERY = 20
SEQ, IMG = 8, 64
REAL_VIDEOS = 32


def chance_loss(batch: int) -> float:
    """NT-Xent at chance: every one of the 2B-1 candidates equally likely."""
    return math.log(2 * batch - 1)


def _scale(img: int) -> tuple[int, int]:
    """The frames' (H, W) before the crop: (80, 72) at img 64."""
    return img + 16, img + 8


def pretrain_config(model: str, log_root: str, batch: int = BATCH,
                    seq: int = SEQ, img: int = IMG,
                    dtype: str = "bfloat16"):
    """``scripts/learning_check.py:main``'s configuration."""
    from ..core.config import PRETRAIN_PRESETS, ModelConfig

    cfg = PRETRAIN_PRESETS["smoke"]
    return cfg.replace(
        data=dataclasses.replace(cfg.data, seq_len=seq, img_dim=img,
                                 scale_hw=_scale(img), synthetic_videos=32,
                                 workers=4),
        model=ModelConfig(net="r3d", model=model, dtype=dtype, moco_k=32),
        optim=dataclasses.replace(cfg.optim, batch_size=batch, lr=0.003,
                                  epochs=10000, schedule=(9999,)),
        run=dataclasses.replace(cfg.run, prefix="learning_check",
                                name_prefix=model, log_root=log_root,
                                print_freq=10, eval_freq=1000,
                                save_freq=1000))


def classifier_config(log_root: str, batch: int = BATCH, seq: int = SEQ,
                      img: int = IMG, dtype: str = "bfloat16"):
    """``scripts/learning_check.py:classifier_check``'s configuration."""
    from ..core.config import CLASSIFIER_PRESETS, ModelConfig

    cfg = CLASSIFIER_PRESETS["smoke"]
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, seq_len=seq, img_dim=img,
                                 scale_hw=_scale(img), synthetic_videos=64,
                                 synthetic_classes=4, workers=4),
        model=ModelConfig(net="r3d", dtype=dtype),
        optim=dataclasses.replace(cfg.optim, batch_size=batch, lr=0.01,
                                  epochs=120, schedule=(80,)),
        run=dataclasses.replace(cfg.run, prefix="clf_learning_check",
                                log_root=log_root, print_freq=20,
                                eval_freq=30, save_freq=30),
        num_class=4)


def write_tree(root: str, db: str, n_videos: int = REAL_VIDEOS,
               seq: int = SEQ, img: int = IMG) -> None:
    """The synthetic videos as a JPEG frame tree in the reference layout,
    ``{db}/{class}/{video}/image_%05d.jpg`` (quality 90, 5*seq frames of
    ``_scale(img)``), with ``ClassInd.txt`` and ``train_split01.csv``
    under ``root`` (``scripts/real_data_learning_check.py:write_tree``)."""
    import numpy as np
    from PIL import Image

    from ..data.loader import SyntheticFrameSource, synthetic_entries

    vlen = 5 * seq
    os.makedirs(root, exist_ok=True)
    entries, class_index = synthetic_entries(n_videos, 8, min_len=vlen,
                                             max_len=vlen + 1)
    with open(os.path.join(root, "ClassInd.txt"), "w") as fh:
        fh.write("\n".join(class_index.classes))
    source = SyntheticFrameSource(scale=_scale(img))
    rows = []
    for e in entries:
        vdir = os.path.join(db, e.vname)
        os.makedirs(vdir, exist_ok=True)
        frames = source(e.vname, np.arange(vlen))
        for i in range(vlen):
            Image.fromarray(frames[i]).save(
                os.path.join(vdir, f"image_{i + 1:05d}.jpg"), quality=90)
        rows.append(f"{vdir}/,{vlen}")
    with open(os.path.join(root, "train_split01.csv"), "w") as fh:
        fh.write("\n".join(rows))


def real_files_config(root: str, db: str, log_root: str, batch: int = BATCH,
                      seq: int = SEQ, img: int = IMG, steps: int = 60,
                      dtype: str = "bfloat16"):
    """``scripts/real_data_learning_check.py:main``'s configuration."""
    from ..core.config import PRETRAIN_PRESETS, ModelConfig

    cfg = PRETRAIN_PRESETS["smoke"]
    return cfg.replace(
        data=dataclasses.replace(
            cfg.data, synthetic=False, data_root=root, db_path=db,
            dataset="ucf101-2clip-stage-prototype", val_size=4, seq_len=seq,
            ds=2, img_dim=img, scale_hw=_scale(img), workers=4),
        model=ModelConfig(net="r3d", model="simclr_naked", dtype=dtype),
        optim=dataclasses.replace(cfg.optim, batch_size=batch, lr=0.003,
                                  epochs=10000, schedule=(9999,)),
        run=dataclasses.replace(cfg.run, prefix="real_learning_check",
                                log_root=log_root,
                                print_freq=min(10, steps), eval_freq=1000,
                                save_freq=1000))


def read_curve(metrics_dir: str, tag: str, every: int = CURVE_EVERY
               ) -> list[tuple[int, float]]:
    """(steps done, value) of ``tag`` in ``{metrics_dir}/metrics.jsonl`` at
    every ``every``-th step (the run logs a scalar at its step's index)."""
    curve = []
    with open(os.path.join(metrics_dir, "metrics.jsonl")) as fh:
        for line in fh:
            item = json.loads(line)
            if item["tag"] == tag and (item["step"] + 1) % every == 0:
                curve.append((item["step"] + 1, item["value"]))
    return curve


def run_check(name: str, steps: int | None = None, device: str = "cuda",
              log_root: str | None = None, batch: int = BATCH,
              seq: int = SEQ, img: int = IMG,
              dtype: str = "bfloat16") -> dict:
    """Train check ``name`` for ``steps`` (its own count by default) and
    return its record: the final value against the pass condition, whether
    it passed, the curve every ``CURVE_EVERY`` steps and the wall time."""
    from ..train import classifier as TC
    from ..train import pretrain as TP

    if name not in CHECKS:
        raise ValueError(f"unknown check {name!r}; one of {CHECKS}")
    steps = STEPS[name] if steps is None else steps
    base = log_root or tempfile.mkdtemp(prefix="learning_check_")
    log = os.path.join(base, "log")
    tic = time.perf_counter()
    if name == "classifier":
        cfg = classifier_config(log, batch, seq, img, dtype)
        final = TC.train(cfg, max_steps=steps, device=device)
        value = final.get("val_top1", 0.0)
        threshold = CLASSIFIER_TOP1
        passed = value > threshold
        tag = "local/loss"
        curve = read_curve(os.path.join(TC.set_path(cfg), "img", "train"),
                           tag)
        what = "val_top1"
    else:
        if name == "real_files":
            root, db = os.path.join(base, "idx"), os.path.join(base, "frames")
            write_tree(root, db, seq=seq, img=img)
            cfg = real_files_config(root, db, log, batch, seq, img, steps,
                                    dtype)
        else:
            cfg = pretrain_config(name, log, batch, seq, img, dtype)
        final = TP.train(cfg, max_steps=steps, device=device)
        value = final.get("clip_loss", float("inf"))
        threshold = chance_loss(batch) - MARGIN[name]
        passed = value < threshold
        tag = "local/clip_loss"
        curve = read_curve(os.path.join(TP.set_path(cfg), "img", "pretrain"),
                           tag)
        what = "clip_loss"
    return {"check": name, "steps": steps, "batch": batch, "seq": seq,
            "img": img, "dtype": dtype, "device": str(device),
            "metric": what, "final": value,
            "condition": f"{what} {'>' if name == 'classifier' else '<'} "
                         f"{threshold}",
            "chance_loss": chance_loss(batch), "passed": bool(passed),
            "curve_tag": tag, "curve": curve,
            "seconds": time.perf_counter() - tic,
            "log_root": base}


def print_record(record: dict) -> None:
    """A check's curve, a line every ``CURVE_EVERY`` steps, then its record
    as one JSON line."""
    for step, value in record["curve"]:
        print(f"learning: {record['check']} step {step}: "
              f"{record['curve_tag']} {value:.4f}", flush=True)
    print("learning: " + json.dumps(record), flush=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check", action="append", choices=CHECKS,
                   help="a check to run (repeatable); all four by default")
    p.add_argument("--steps", type=int, default=None,
                   help="steps of every check (default: each its own)")
    p.add_argument("--log_root", default=None,
                   help="where the runs write (default: a new temp dir)")
    args = p.parse_args(argv)
    ok = True
    for name in args.check or CHECKS:
        root = (os.path.join(args.log_root, name) if args.log_root
                else None)
        record = run_check(name, args.steps, log_root=root)
        print_record(record)
        ok &= record["passed"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
