"""Host-side input pipeline: frame sources, the pretrain and classifier
datasets and a seeded, thread-pooled batch loader.

Own copy of the parts of ``dualvar_tpu/data/loader.py`` that the pretrain
step and the classifier need. The host only produces uint8 frames; crops,
jitter, blur and normalisation run on the device (``dualvar_tpu_torch.aug``),
so batches cross to the card as uint8. With the same seed this loader yields the same
uint8 batch as the JAX package's (tests/test_torch_port_slice.py).

Left out for now: the native C++ JPEG decoder branch of ``JpegFrameSource``
and the whole-batch native assembler that rides on it (see ROADMAP.md);
``JpegFrameSource`` here decodes with PIL only.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np

from . import samplers
from .indices import ClassIndex, VideoEntry, shard_for_process


class JpegFrameSource:
    """Reads ``{db_path}/{vname}/image_{i+1:05d}.jpg`` (reference
    local_dataset.py:149-150) and resizes with PIL bicubic (the reference
    Scale default, augmentation.py:126)."""

    def __init__(self, db_path: str, scale: tuple[int, int] | int = (171, 128)):
        # scale: (H, W) fixed resize, or int short-side resize
        self.db_path = db_path
        self.scale = scale

    def __call__(self, vname: str, frame_indices: np.ndarray) -> np.ndarray:
        from PIL import Image  # host-only dependency

        frames = []
        for i in frame_indices:
            path = os.path.join(self.db_path, vname, f"image_{int(i) + 1:05d}.jpg")
            with Image.open(path) as im:
                im = im.convert("RGB")
                if isinstance(self.scale, int):
                    w, h = im.size
                    if w < h:
                        ow, oh = self.scale, int(self.scale * h / w)
                    else:
                        oh, ow = self.scale, int(self.scale * w / h)
                    im = im.resize((ow, oh), Image.BICUBIC)
                else:
                    H, W = self.scale
                    im = im.resize((W, H), Image.BICUBIC)
                frames.append(np.asarray(im, dtype=np.uint8))
        return np.stack(frames)


class SyntheticFrameSource:
    """Deterministic pseudo-video frames, no filesystem. Each video is a
    translating superposition of random low-frequency color waves seeded by
    its name; same (vname, index) always yields the same frame.

    Low-frequency structure matters: iid-noise frames are unlearnable for
    instance discrimination through a global-average-pooled CNN; smooth
    per-video patterns keep videos separable."""

    def __init__(self, scale: tuple[int, int] = (171, 128)):
        self.scale = scale

    def __call__(self, vname: str, frame_indices: np.ndarray) -> np.ndarray:
        H, W = self.scale
        # class determines the wave frequencies, the video id adds
        # phases/amplitudes. crc32: stable across processes, unlike hash().
        cls_part = vname.split("/")[0]
        cls_rng = np.random.default_rng(zlib.crc32(cls_part.encode()))
        vid_rng = np.random.default_rng(zlib.crc32(vname.encode()))
        y = np.arange(H)[:, None] / H
        x = np.arange(W)[None, :] / W
        base = np.zeros((H, W, 3), np.float32)
        for c in range(3):
            for _ in range(3):
                fy, fx = cls_rng.uniform(0.5, 4.0, 2)
                phase = vid_rng.uniform(0, 2 * np.pi)
                amp = vid_rng.uniform(0.5, 1.0)
                base[..., c] += amp * np.sin(
                    2 * np.pi * (fy * y + fx * x) + phase).astype(np.float32)
        base = (127.5 + 50.0 * base).clip(0, 255).astype(np.uint8)
        out = np.empty((len(frame_indices), H, W, 3), dtype=np.uint8)
        for n, i in enumerate(frame_indices):
            out[n] = np.roll(base, shift=int(i) * 3, axis=1)
        return out


def synthetic_entries(
    n_videos: int, n_classes: int, min_len: int = 60, max_len: int = 300, seed: int = 0
) -> tuple[list[VideoEntry], ClassIndex]:
    rng = np.random.default_rng(seed)
    classes = [f"class{c:03d}" for c in range(n_classes)]
    entries = []
    for v in range(n_videos):
        c = classes[v % n_classes]
        vlen = int(rng.integers(min_len, max_len))
        name = f"{c}/video{v:05d}"
        entries.append(VideoEntry(f"/synthetic/{name}/", vlen, c, name))
    return entries, ClassIndex(classes)


@dataclass
class PretrainDataset:
    """Multi-clip pretrain samples; ``variant`` selects the clip sampler,
    mirroring the reference's 2-CLIP dataset family:

    * ``stage-prototype`` — two stage-prototype clips (+ clip1 again when
      aug_series), reference local_dataset.py:246-308;
    * ``prototype`` — two center-clipped prototype clips
      (local_dataset.py:204-244);
    * ``2clip`` — two independent train windows (local_dataset.py:140-143).

    ``aug_series`` appends clip1's indices as a third view for the
    TimeSeriesV4 shuffle-rank pass (local_dataset.py:291-292).
    """

    entries: list[VideoEntry]
    class_index: ClassIndex
    source: Callable[[str, np.ndarray], np.ndarray]
    num_frames: int = 16
    ds: int = 4
    rand_flip: bool = True
    aug_series: bool = True
    variant: str = "stage-prototype"

    def __len__(self):
        return len(self.entries)

    def _indices(self, rng: np.random.Generator, vlen: int) -> np.ndarray:
        T = self.num_frames
        if self.variant == "stage-prototype":
            return samplers.stage_prototype_views(
                rng, vlen, T, self.ds, self.rand_flip, self.aug_series)
        if self.variant == "prototype":
            idx1 = samplers.prototype_sampler(rng, vlen, T, self.ds)
            idx2 = samplers.prototype_sampler(rng, vlen, T, self.ds)
        elif self.variant == "2clip":
            both = samplers.double_sampler(rng, vlen, T, self.ds)
            idx1, idx2 = both[:T], both[T:]
        else:
            raise ValueError(f"unknown pretrain dataset variant {self.variant!r}")
        out = np.concatenate([idx1, idx2])
        return np.concatenate([out, idx1]) if self.aug_series else out

    def __call__(self, index: int, rng: np.random.Generator) -> dict[str, Any]:
        e = self.entries[index]
        idx = self._indices(rng, e.vlen)
        return {
            "frames": self.source(e.vname, idx),
            "label": np.int32(self.class_index.encode(e.vlabel)),
        }


@dataclass
class ClassifierDataset:
    """Single-clip classification samples (reference UCF101LMDB,
    local_dataset.py:176-201).

    Test mode covers ALL half-overlapping temporal windows per video
    (reference frame_sampler test branch, local_dataset.py:107-123): each
    (video, window) pair is its own record carrying the video's ``vid``, and
    the protocols' per-vid probability averaging reproduces the reference's
    mean over windows (classifier.py:612-628). ``rid`` is the record's index.
    """

    entries: list[VideoEntry]
    class_index: ClassIndex
    source: Callable[[str, np.ndarray], np.ndarray]
    num_frames: int = 16
    ds: int = 2
    mode: str = "train"  # train | val | test

    def __post_init__(self):
        self._records = None
        if self.mode == "test":
            self._records = [
                (ei, w)
                for ei, e in enumerate(self.entries)
                for w in range(samplers.n_test_windows(
                    e.vlen, self.num_frames, self.ds))
            ]

    def __len__(self):
        return len(self._records) if self._records is not None \
            else len(self.entries)

    def __call__(self, index: int, rng: np.random.Generator) -> dict[str, Any]:
        if self._records is not None:
            ei, w = self._records[index]
            e = self.entries[ei]
            idx = samplers.test_window(rng, e.vlen, self.num_frames, self.ds, w)
        else:
            ei = index
            e = self.entries[ei]
            idx = samplers.frame_sampler_train(rng, e.vlen, self.num_frames,
                                               self.ds)
        return {
            "frames": self.source(e.vname, idx),
            "label": np.int32(self.class_index.encode(e.vlabel)),
            "vid": np.int32(ei),
            "rid": np.int32(index),
        }

    def record_vids(self) -> np.ndarray:
        """vid per record id (test mode: records are (video, window) pairs;
        train / val: records are videos)."""
        if self._records is not None:
            return np.asarray([ei for ei, _ in self._records], np.int64)
        return np.arange(len(self.entries), dtype=np.int64)


@dataclass
class TenClipDataset:
    """10 uniformly spaced clips per video (reference UCF101_10CLIP,
    local_dataset.py:311-350)."""

    entries: list[VideoEntry]
    class_index: ClassIndex
    source: Callable[[str, np.ndarray], np.ndarray]
    num_frames: int = 16
    ds: int = 2

    def __len__(self):
        return len(self.entries)

    def __call__(self, index: int, rng: np.random.Generator) -> dict[str, Any]:
        e = self.entries[index]
        idx = samplers.tenclip_sampler(e.vlen, self.num_frames, self.ds)
        return {
            "frames": self.source(e.vname, idx),
            "label": np.int32(self.class_index.encode(e.vlabel)),
            "vid": np.int32(index),
        }


class HostLoader:
    """Seeded, sharded, thread-pooled batch loader with bounded prefetch.

    Equivalent role to FastDataLoader + DistributedSampler
    (pretrain.py:550-556): per-epoch deterministic shuffle, per-host shard,
    drop_last batching. Call ``close()`` (or use it as a context manager)
    to stop the decode threads.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.pool = ThreadPoolExecutor(max_workers=num_workers)

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self):
        n = len(shard_for_process(len(self.dataset), self.process_index,
                                  self.process_count))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _rng(self, epoch: int, index: int) -> np.random.Generator:
        """The per-sample rng stream: one stream per (seed, epoch, index)."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, int(index)])
        )

    def _sample(self, epoch: int, index: int) -> dict[str, np.ndarray]:
        return self.dataset(int(index), self._rng(epoch, index))

    def epoch(self, epoch: int = 0) -> Iterator[dict[str, np.ndarray]]:
        order = shard_for_process(
            len(self.dataset),
            self.process_index,
            self.process_count,
            shuffle_seed=(self.seed + epoch) if self.shuffle else None,
        )
        nb = len(order) // self.batch_size if self.drop_last \
            else -(-len(order) // self.batch_size)
        batches = [
            order[b * self.batch_size : (b + 1) * self.batch_size]
            for b in range(nb)
        ]
        pending = []
        bi = 0

        def submit(b):
            return [self.pool.submit(self._sample, epoch, i) for i in batches[b]]

        while bi < min(self.prefetch, nb):
            pending.append(submit(bi))
            bi += 1
        for b in range(nb):
            futs = pending.pop(0)
            if bi < nb:
                pending.append(submit(bi))
                bi += 1
            samples = [f.result() for f in futs]
            yield {
                k: np.stack([s[k] for s in samples]) for k in samples[0]
            }
