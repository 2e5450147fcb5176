"""Clip frame samplers — pure numpy, explicitly seeded.

Parity with the sampling logic in dataset/local_dataset.py (cited per
function). All samplers return 0-based frame indices into a video of
``total`` frames; callers add 1 when forming ``image_%05d.jpg`` keys
(reference :149).
"""

from __future__ import annotations

import numpy as np


def frame_sampler_train(
    rng: np.random.Generator, total: int, num_frames: int, ds: int
) -> np.ndarray:
    """Random contiguous (strided) window, with random left/right padding for
    short videos. Reference local_dataset.py:124-137 (train/val branch)."""
    span = num_frames * ds
    if total - span <= 0:
        sequence = np.arange(num_frames) * ds + rng.choice(ds)
        if rng.integers(0, 2):  # pad left
            seq_idx = np.zeros_like(sequence)
            valid = sequence[sequence < total]
            seq_idx[len(seq_idx) - len(valid):] = valid
        else:  # pad right
            seq_idx = np.ones_like(sequence) * (total - 1)
            valid = sequence[sequence < total]
            seq_idx[: len(valid)] = valid
        return seq_idx
    start = rng.choice(total - span)
    return np.arange(num_frames) * ds + start


def frame_sampler_test(
    rng: np.random.Generator, total: int, num_frames: int, ds: int
) -> np.ndarray:
    """Half-overlapping windows covering the video (flattened). Reference
    local_dataset.py:109-123 (test branch)."""
    span = num_frames * ds
    if total - span <= 0:
        sequence = np.arange(num_frames) * ds
        if rng.integers(0, 2):
            seq_idx = np.zeros_like(sequence)
            valid = sequence[sequence < total]
            seq_idx[len(seq_idx) - len(valid):] = valid
        else:
            seq_idx = np.ones_like(sequence) * (total - 1)
            valid = sequence[sequence < total]
            seq_idx[: len(valid)] = valid
        return seq_idx
    available = total - span
    start = np.arange(0, available + 1, span // 2 - 1)[:, None]
    return (np.arange(num_frames)[None, :] * ds + start).flatten()


def n_test_windows(total: int, num_frames: int, ds: int) -> int:
    """Number of half-overlapping test windows frame_sampler_test yields
    (reference local_dataset.py:119-123: arange step span//2 - 1)."""
    span = num_frames * ds
    if total - span <= 0:
        return 1
    return len(range(0, total - span + 1, span // 2 - 1))


def test_window(
    rng: np.random.Generator, total: int, num_frames: int, ds: int, window: int
) -> np.ndarray:
    """Frame indices of one half-overlapping test window. Together with
    ``n_test_windows`` this exposes frame_sampler_test's output one
    static-shape window at a time, so the test protocols can average softmax
    over ALL windows per video (reference classifier.py:612-628) by expanding
    (video, window) records instead of padding to a max window count."""
    span = num_frames * ds
    if total - span <= 0:
        return frame_sampler_test(rng, total, num_frames, ds)
    starts = np.arange(0, total - span + 1, span // 2 - 1)
    return np.arange(num_frames) * ds + starts[window]


def prototype_sampler(
    rng: np.random.Generator, total: int, num_frames: int, ds: int
) -> np.ndarray:
    """Clip centered at a random frame, clipped to the video bounds.
    Reference local_dataset.py:208-214 (UCF101LMDB_2CLIP_Protytype)."""
    center = rng.integers(0, total)
    diff = (np.arange(num_frames) - num_frames // 2) * ds
    return np.clip(diff + center, 0, total - 1).astype(np.int64)


def stage_prototype_sampler(
    rng: np.random.Generator,
    total: int,
    num_frames: int,
    ds: int,
    center_lower: int = 0,
    center_upper: int = 0,
    repeat_prob: float = 0.25,
    length: int = 0,
) -> np.ndarray:
    """Prototype sampler with optional stage-boundary repeat probability.
    Reference local_dataset.py:252-263 (UCF101LMDB_2CLIP_Stage_Prototype).

    Note: in the released default path the bounds are (0, total) so the two
    boundary-relaxation draws are inert; they are consumed anyway for RNG
    stream parity with the general machinery.
    """
    length = num_frames if length == 0 else length
    if center_upper == 0:
        center_upper = total
    center = rng.integers(center_lower, center_upper)
    diff = (np.arange(length) - length // 2) * ds
    if rng.uniform() >= repeat_prob:  # allow crossing the lower boundary
        center_lower = 0
    if rng.uniform() >= repeat_prob:  # allow crossing the upper boundary
        center_upper = total
    return np.clip(diff + center, center_lower, center_upper - 1).astype(np.int64)


def stage_prototype_views(
    rng: np.random.Generator,
    total: int,
    num_frames: int,
    ds: int,
    rand_flip: bool = False,
    aug_series: bool = True,
) -> np.ndarray:
    """Full pretrain sample index assembly: two stage-prototype clips plus the
    first clip repeated as the third view. Reference local_dataset.py:271-292:
    ``rand_flip`` reverses both clips *temporally* with one coin flip;
    ``aug_series`` appends clip1's indices again (views = [c1, c2, c1])."""
    flip = bool(rng.integers(0, 2)) if rand_flip else False
    idx1 = stage_prototype_sampler(rng, total, num_frames, ds)
    if flip:
        idx1 = idx1[::-1]
    idx2 = stage_prototype_sampler(rng, total, num_frames, ds)
    if flip:
        idx2 = idx2[::-1]
    out = np.concatenate([idx1, idx2])
    if aug_series:
        out = np.concatenate([out, idx1])
    return out


def tenclip_sampler(total: int, num_frames: int, ds: int) -> np.ndarray:
    """10 uniformly spaced clip centers; per clip a strided window clamped to
    the video end. Reference local_dataset.py:315-335 (UCF101_10CLIP)."""
    half = num_frames * ds // 2
    min_index = min(half, total)
    max_index = max(min_index, total - half)
    out = []
    for center in np.linspace(min_index, max_index, 10):
        start = max(0, int(center) - half)
        idx = np.arange(start, start + num_frames * ds, ds)
        out.append(np.minimum(idx, total - 1))
    return np.concatenate(out)


def double_sampler(
    rng: np.random.Generator, total: int, num_frames: int, ds: int
) -> np.ndarray:
    """Two independent train windows (reference local_dataset.py:140-143)."""
    return np.concatenate(
        [
            frame_sampler_train(rng, total, num_frames, ds),
            frame_sampler_train(rng, total, num_frames, ds),
        ]
    )
