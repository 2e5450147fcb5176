"""Dataset index loading: class lists and (frame_dir, num_frames) CSV splits.

Own copy of ``dualvar_tpu/data/indices.py``.

Parity with dataset/local_dataset.py:55-105, with the reference's two latent
index bugs fixed as intended behavior (SURVEY.md §4 defects #4):
``video_subset`` is actually assigned, and the train split drops the val
rows by *index* (`drop(val_split.index)`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class VideoEntry:
    vpath: str  # raw csv path column
    vlen: int  # number of frames
    vlabel: str  # class name
    vname: str  # "class/videoname" — frame dir key relative to db_path


@dataclass
class ClassIndex:
    classes: list[str]

    @property
    def num_class(self) -> int:
        return len(self.classes)

    def encode(self, name: str) -> int:
        return self.classes.index(name)

    def decode(self, idx: int) -> str:
        return self.classes[idx]


def load_class_index(root: str) -> ClassIndex:
    """ClassInd.txt: one class per line, optionally 'id,name' (reference
    local_dataset.py:78-79)."""
    with open(os.path.join(root, "ClassInd.txt")) as f:
        classes = [line.strip() for line in f if line.strip()]
    if "," in classes[0]:
        classes = [c.split(",")[-1].strip() for c in classes]
    return ClassIndex(classes)


def load_split(
    root: str,
    mode: str = "train",
    which_split: int = 1,
    val_size: int = 800,
    val_seed: int = 666,
) -> list[VideoEntry]:
    """Load a split CSV into entries.

    train/val: read train_split%02d.csv and carve out a fixed ``val_size``-row
    validation subset with pandas' seeded sampler (reference
    local_dataset.py:96-104, seed 666). test: read test_split%02d.csv.
    """
    import pandas as pd  # host-only dependency, needed for CSV splits only

    split_mode = "train" if mode == "val" else mode
    csv_path = os.path.join(root, f"{split_mode}_split{which_split:02d}.csv")
    if not os.path.exists(csv_path):
        raise FileNotFoundError(
            f"split index {csv_path} not found; see "
            "process_data/data/README.md for how the split CSVs are written "
            "(ClassInd.txt and the official UCF101 split lists are vendored "
            "there).")
    info = pd.read_csv(csv_path, header=None)
    info[2] = info[0].str.split("/").str.get(-3)
    info[3] = info[2] + "/" + info[0].str.split("/").str.get(-2)
    if mode in ("train", "val"):
        val_split = info.sample(n=min(val_size, len(info)), random_state=val_seed)
        info = info.drop(val_split.index) if mode == "train" else val_split
    return [
        VideoEntry(str(r[0]), int(r[1]), str(r[2]), str(r[3]))
        for _, r in info.iterrows()
    ]


def shard_for_process(
    n: int, process_index: int, process_count: int, shuffle_seed: int | None = None
) -> np.ndarray:
    """Per-host index shard (DistributedSampler equivalent, pretrain.py:552):
    optional seeded shuffle, then pad to a multiple of process_count and take
    a strided slice so every host sees the same number of samples."""
    idx = np.arange(n)
    if shuffle_seed is not None:
        idx = np.random.default_rng(shuffle_seed).permutation(idx)
    per = -(-n // process_count)
    padded = np.concatenate([idx, idx[: per * process_count - n]])
    return padded[process_index::process_count]
