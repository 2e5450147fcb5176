"""Host-side input pipeline: frame sources, the pretrain and classifier
datasets and a seeded, thread-pooled batch loader.

Own copy of ``dualvar_tpu/data/loader.py``. The host only produces uint8
frames; crops, jitter, blur and normalisation run on the device
(``dualvar_tpu_torch.aug``), so batches cross to the card as uint8. With the
same seed this loader yields the same uint8 batch as the JAX package's
(tests/test_torch_port_slice.py, tests/test_torch_port_real_data.py).

``JpegFrameSource`` decodes fixed-size resizes with the native C++ decoder
(``dualvar_tpu_torch.native``) where it builds, else with PIL. On the native
route ``HostLoader`` assembles a whole batch with one native call
(``_assemble``) from the datasets' ``plan()``, bitwise equal to the
per-sample path, and hints the page cache one prefetch window ahead
(``_readahead``).
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
    local_dataset.py:149-150) and resizes with bicubic antialiasing (the
    reference Scale default, augmentation.py:126).

    Fixed-size resizes go through the native decoder (``..native``: libjpeg,
    a PIL-equivalent resampler and a thread pool) when it is available and
    ``use_native``; PIL is the fallback and handles int short-side resizes.
    The two routes agree to a few levels a pixel, not bitwise.

    ``fast_decode``: the native decoder's DCT-domain scaled decode (libjpeg
    k/8 scaling), which skips most of the IDCT work when the frames are
    larger than ``scale``; its pixels are close to, not bitwise equal with,
    the exact decode. Only the native decoder has it: unlike the JAX
    package, which then quietly decodes exactly with PIL, this source
    raises where ``fast_decode`` is asked for and the native route cannot
    be taken (no library, ``use_native=False`` or an int ``scale``).
    """

    def __init__(self, db_path: str, scale: tuple[int, int] | int = (171, 128),
                 use_native: bool = True, native_threads: int = 4,
                 fast_decode: bool = False):
        # scale: (H, W) fixed resize, or int short-side resize
        self.db_path = db_path
        self.scale = scale
        self.native_threads = native_threads
        self.fast_decode = fast_decode
        self._native = None
        if use_native and not isinstance(scale, int):
            from .. import native

            if native.available():
                self._native = native
        if fast_decode and self._native is None:
            raise RuntimeError(
                "fast_decode needs the native JPEG decoder (g++ and libjpeg, "
                "a fixed (H, W) scale, use_native=True); it is not available "
                "here, and decoding exactly instead would not be what was "
                "asked for")

    def paths(self, vname: str, frame_indices: np.ndarray) -> list[str]:
        return [
            os.path.join(self.db_path, vname, f"image_{int(i) + 1:05d}.jpg")
            for i in frame_indices
        ]

    @property
    def native_batch(self):
        """(native_module, (H, W)) when the batch assembler can decode for
        this source, else None."""
        if self._native is None:
            return None
        return self._native, tuple(self.scale)

    def __call__(self, vname: str, frame_indices: np.ndarray) -> np.ndarray:
        paths = self.paths(vname, frame_indices)
        if self._native is not None:
            return self._native.decode_jpeg_files(
                paths, self.scale, n_threads=self.native_threads,
                fast=self.fast_decode)
        from PIL import Image  # host-only dependency

        frames = []
        for path in paths:
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

    def plan(self, index: int, rng: np.random.Generator):
        """(vname, frame_indices, aux) with the decode deferred: the
        loader's batch assembler decodes a whole batch's plans in one native
        call."""
        e = self.entries[index]
        idx = self._indices(rng, e.vlen)
        return e.vname, idx, {
            "label": np.int32(self.class_index.encode(e.vlabel)),
        }

    def __call__(self, index: int, rng: np.random.Generator) -> dict[str, Any]:
        vname, idx, aux = self.plan(index, rng)
        return {"frames": self.source(vname, idx), **aux}


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

    def plan(self, index: int, rng: np.random.Generator):
        """(vname, frame_indices, aux), as ``PretrainDataset.plan``."""
        if self._records is not None:
            ei, w = self._records[index]
            e = self.entries[ei]
            idx = samplers.test_window(rng, e.vlen, self.num_frames, self.ds, w)
        else:
            ei = index
            e = self.entries[ei]
            idx = samplers.frame_sampler_train(rng, e.vlen, self.num_frames,
                                               self.ds)
        return e.vname, idx, {
            "label": np.int32(self.class_index.encode(e.vlabel)),
            "vid": np.int32(ei),
            "rid": np.int32(index),
        }

    def __call__(self, index: int, rng: np.random.Generator) -> dict[str, Any]:
        vname, idx, aux = self.plan(index, rng)
        return {"frames": self.source(vname, idx), **aux}

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

    def plan(self, index: int, rng: np.random.Generator):
        """(vname, frame_indices, aux), as ``PretrainDataset.plan``."""
        e = self.entries[index]
        idx = samplers.tenclip_sampler(e.vlen, self.num_frames, self.ds)
        return e.vname, idx, {
            "label": np.int32(self.class_index.encode(e.vlabel)),
            "vid": np.int32(index),
        }

    def __call__(self, index: int, rng: np.random.Generator) -> dict[str, Any]:
        vname, idx, aux = self.plan(index, rng)
        return {"frames": self.source(vname, idx), **aux}


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
        self.num_workers = num_workers
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
        """The per-sample rng stream, one per (seed, epoch, index): its only
        definition, on which the batch assembler's bitwise equality with
        the per-sample path rests."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, int(index)])
        )

    def _sample(self, epoch: int, index: int) -> dict[str, np.ndarray]:
        return self.dataset(int(index), self._rng(epoch, index))

    def _native_batch_ctx(self):
        """(native_module, (H, W)) when the whole-batch native assembler
        applies: the dataset has ``plan()`` and its source is a fixed-size
        ``JpegFrameSource`` on the native route; else None."""
        src = getattr(self.dataset, "source", None)
        if (hasattr(self.dataset, "plan")
                and getattr(src, "native_batch", None) is not None):
            return src.native_batch
        return None

    def _readahead(self, epoch: int, indices) -> None:
        """Page-cache hint (``posix_fadvise`` WILLNEED) for a batch that
        will be decoded one prefetch window from now: the plans are drawn
        again (cheap index arithmetic, deterministic per (epoch, index)) and
        their files handed to the kernel, which queues the reads and returns
        at once. A no-op off the native route."""
        ctx = self._native_batch_ctx()
        if ctx is None:
            return
        native_mod, _ = ctx
        src = self.dataset.source
        paths = [
            p
            for i in indices
            for vname, idx, _ in (self.dataset.plan(int(i),
                                                    self._rng(epoch, int(i))),)
            for p in src.paths(vname, idx)
        ]
        native_mod.readahead_files(paths)

    def _assemble(self, epoch: int, indices) -> dict[str, np.ndarray]:
        """The batch assembler: every sample's plan, then all B*F frames
        decoded straight into the batch buffer by one native call (its
        thread pool balances over the frames; no per-sample stack). Bitwise
        equal to the per-sample path: the same per-index rng stream and the
        same decoder."""
        native_mod, (H, W) = self._native_batch_ctx()
        src = self.dataset.source
        plans = [self.dataset.plan(int(i), self._rng(epoch, int(i)))
                 for i in indices]
        F = len(plans[0][1])
        assert all(len(idx) == F for _, idx, _ in plans), \
            [len(idx) for _, idx, _ in plans]
        out = np.empty((len(plans), F, H, W, 3), np.uint8)
        paths = [p for vname, idx, _ in plans for p in src.paths(vname, idx)]
        # up to `prefetch` assemblies run at once, each with its own native
        # threads: split the workers between them
        ok = native_mod.decode_jpeg_files_into(
            paths, out.reshape(len(plans) * F, H, W, 3),
            n_threads=max(1, self.num_workers // max(1, min(
                self.prefetch, 2))),
            fast=src.fast_decode)
        assert ok
        batch = {"frames": out}
        for k in plans[0][2]:
            batch[k] = np.stack([aux[k] for _, _, aux in plans])
        return batch

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
        use_native_batch = self._native_batch_ctx() is not None

        def submit(b):
            if use_native_batch and b + self.prefetch < nb:
                # prime the page cache one prefetch window out
                self.pool.submit(self._readahead, epoch,
                                 batches[b + self.prefetch])
            if use_native_batch:
                return self.pool.submit(self._assemble, epoch, batches[b])
            return [self.pool.submit(self._sample, epoch, i) for i in batches[b]]

        while bi < min(self.prefetch, nb):
            pending.append(submit(bi))
            bi += 1
        for b in range(nb):
            futs = pending.pop(0)
            if bi < nb:
                pending.append(submit(bi))
                bi += 1
            if use_native_batch:
                yield futs.result()
                continue
            samples = [f.result() for f in futs]
            yield {
                k: np.stack([s[k] for s in samples]) for k in samples[0]
            }
