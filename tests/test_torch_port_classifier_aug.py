"""The classifier's augmentation and datasets in the port against the JAX
package on the CPU.

The train batch takes explicit decisions (crop, flip, op order, factors), so
both packages get the same ones: the JAX side is a numpy crop and flip, then
its ``aug_fused`` in interpret mode with blur ``(1, 0)``, as its
``classifier_train_batch_fused`` calls it; the port runs the plain version
of its kernel (CPU tensors). Eval and test crops have no randomness and are
compared on the same uint8 frames. Tolerances: 2e-5 through the jitter
chain (tests/test_aug_fused.py's band), 1e-6 for crop + normalise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.aug import functional as JF
from dualvar_tpu.aug import pipeline as JP
from dualvar_tpu.data import loader as JL
from dualvar_tpu.ops.aug_fused import aug_fused as jax_aug_fused
from dualvar_tpu_torch.aug import functional as TF
from dualvar_tpu_torch.aug.pipeline import (AugConfig,
                                            _draw_classifier_params,
                                            classifier_train_batch,
                                            classifier_train_batch_fused,
                                            eval_batch, tenclip_batch,
                                            tencrop_batch)
from dualvar_tpu_torch.data import loader as TL
from dualvar_tpu_torch.ops.aug_fused import aug_fused

import torch_port_util  # noqa: F401  (caps torch's threads)

T, H0, W0, SIZE = 4, 40, 36, 32
ATOL = 2e-5
CROP_ATOL = 1e-6


def _frames(B, t=T, h=H0, w=W0, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, t, h, w, 3),
                                                dtype=np.uint8)


def _decisions(B, seed=1):
    rng = np.random.default_rng(seed)
    crops = np.stack([rng.integers(0, H0 - SIZE + 1, B),
                      rng.integers(0, W0 - SIZE + 1, B)], axis=-1)
    crops[0] = (0, 0)
    crops[-1] = (H0 - SIZE, W0 - SIZE)  # both window extremes
    flips = np.arange(B) % 2 == 1
    orders = np.stack([rng.permutation(4) for _ in range(B)]).astype(np.int32)
    factors = np.stack([rng.uniform(0.2, 1.8, B), rng.uniform(0.2, 1.8, B),
                        rng.uniform(0.2, 1.8, B),
                        rng.uniform(-0.2, 0.2, B)], axis=-1).astype(np.float32)
    factors[1] = (1.0, 1.0, 1.0, 0.0)  # jitter not applied
    return crops, flips, orders, factors


def _jax_train_batch(frames, crops, flips, orders, factors):
    """numpy crop (+ flip of the cropped clip) -> JAX ``aug_fused`` with blur
    off for every clip, as ``classifier_train_batch_fused`` does it."""
    cropped = np.stack([
        f[:, y:y + SIZE, x:x + SIZE][:, :, ::-1] if fl
        else f[:, y:y + SIZE, x:x + SIZE]
        for f, (y, x), fl in zip(frames, crops, flips)])
    B = len(frames)
    out = jax_aug_fused(
        jnp.asarray(cropped.transpose(0, 4, 1, 2, 3)), jnp.asarray(orders),
        jnp.asarray(factors),
        jnp.tile(jnp.asarray([[1.0, 0.0]], jnp.float32), (B, 1)),
        interpret=True)
    return np.asarray(out).transpose(0, 2, 3, 4, 1)


def test_train_batch_explicit_decisions_match_jax():
    B = 6
    frames = _frames(B)
    crops, flips, orders, factors = _decisions(B)
    want = _jax_train_batch(frames, crops, flips, orders, factors)
    cfg = AugConfig(img_dim=SIZE, seq_len=T)
    aug_fused.launches = 0
    got = classifier_train_batch_fused(
        None, torch.from_numpy(frames), cfg, crops=torch.from_numpy(crops),
        flips=torch.from_numpy(flips), orders=torch.from_numpy(orders),
        factors=torch.from_numpy(factors))
    assert tuple(got.shape) == (B, T, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # a channels-last view of the planar output; on the CPU the wrapper
    # takes the plain version and launches nothing
    assert got.permute(0, 4, 1, 2, 3).is_contiguous()
    assert aug_fused.launches == 0
    plain = classifier_train_batch_fused(
        None, torch.from_numpy(frames), cfg, crops=torch.from_numpy(crops),
        flips=torch.from_numpy(flips), orders=torch.from_numpy(orders),
        factors=torch.from_numpy(factors), kernel=False)
    assert torch.equal(got, plain)
    # the flip is the crop's mirror: identity-jitter clip 1 is flipped,
    # identity clip 1 unflipped equals clip 1 flipped back
    unflipped = classifier_train_batch_fused(
        None, torch.from_numpy(frames), cfg, crops=torch.from_numpy(crops),
        flips=torch.zeros(B, dtype=torch.bool),
        orders=torch.from_numpy(orders), factors=torch.from_numpy(factors))
    assert torch.equal(unflipped[1], got[1].flip(2))
    with pytest.raises(ValueError, match="all of"):
        classifier_train_batch_fused(None, torch.from_numpy(frames), cfg,
                                     crops=torch.from_numpy(crops))


@pytest.mark.parametrize("jitter_order", ["batch", "sample"])
def test_draws_obey_the_gates(jitter_order):
    B = 4000
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0])
    cfg = AugConfig(img_dim=SIZE, seq_len=T, rand_flip=True,
                    with_color_jitter=True, jitter_order=jitter_order)
    crops, flips, orders, factors = _draw_classifier_params(
        torch.Generator().manual_seed(0), cfg, B, H0, W0)
    assert crops.shape == (B, 2) and flips.dtype == torch.bool
    assert orders.dtype == torch.int32 and factors.dtype == torch.float32
    assert int(crops[:, 0].min()) == 0 and int(crops[:, 0].max()) == H0 - SIZE
    assert int(crops[:, 1].min()) == 0 and int(crops[:, 1].max()) == W0 - SIZE
    assert torch.equal(orders.sort(dim=-1).values,
                       torch.arange(4, dtype=torch.int32).expand(B, 4))
    n_orders = len({tuple(o) for o in orders.tolist()})
    assert n_orders == (24 if jitter_order == "sample" else 1)
    # one apply gate of 0.8 (not pretrain's 0.8 x 0.8), flips at 0.5;
    # +-4 sigma at B=4000
    applied = ~(factors == ident).all(dim=-1)
    assert abs(float(applied.float().mean()) - 0.8) < 0.026
    assert abs(float(flips.float().mean()) - 0.5) < 0.032
    f = factors[applied]
    assert 0.2 <= float(f[:, :3].min()) and float(f[:, :3].max()) <= 1.8
    assert -0.2 <= float(f[:, 3].min()) and float(f[:, 3].max()) <= 0.2

    off = AugConfig(img_dim=SIZE, seq_len=T, rand_flip=False,
                    with_color_jitter=False, jitter_order=jitter_order)
    _, flips, _, factors = _draw_classifier_params(
        torch.Generator().manual_seed(0), off, B, H0, W0)
    assert not bool(flips.any())
    assert bool((factors == ident).all())
    # the same seed gives the same draws
    again = _draw_classifier_params(torch.Generator().manual_seed(0), off, B,
                                    H0, W0)
    assert torch.equal(again[3], factors)


def test_train_batch_draws_and_dispatch():
    frames = torch.from_numpy(_frames(4))
    cfg = AugConfig(img_dim=SIZE, seq_len=T, rand_flip=True)
    a = classifier_train_batch(torch.Generator().manual_seed(5), frames, cfg)
    b = classifier_train_batch(torch.Generator().manual_seed(5), frames, cfg)
    assert torch.equal(a, b) and tuple(a.shape) == (4, T, SIZE, SIZE, 3)
    assert bool(torch.isfinite(a).all())
    # fused='auto' on CPU frames takes the plain version (as the kernel's
    # wrapper would for a CPU tensor): the same numbers as asked by name
    plain = classifier_train_batch_fused(torch.Generator().manual_seed(5),
                                         frames, cfg, kernel=False)
    assert torch.equal(a, plain)


def test_center_crop_rounds_half_to_even_and_five_crop_origins():
    clip = torch.arange(171 * 128).reshape(1, 171, 128, 1)
    c = TF.center_crop(clip, 112)
    assert int(c[0, 0, 0, 0]) == 30 * 128 + 8  # (171-112)/2 = 29.5 -> 30
    j = np.asarray(JF.center_crop(jnp.asarray(clip.numpy()), 112))
    np.testing.assert_array_equal(c.numpy(), j)
    for where in range(1, 6):
        np.testing.assert_array_equal(
            TF.five_crop(clip, 112, where).numpy(),
            np.asarray(JF.five_crop(jnp.asarray(clip.numpy()), 112, where)))
    np.testing.assert_array_equal(TF.hflip(clip).numpy(),
                                  np.asarray(JF.hflip(jnp.asarray(
                                      clip.numpy()))))


def test_eval_batch_matches_jax():
    frames = _frames(2, h=171, w=128, seed=3)
    cfg = AugConfig(img_dim=112, seq_len=T)
    want = np.asarray(JP.eval_batch(jnp.asarray(frames),
                                    JP.AugConfig(img_dim=112, seq_len=T)))
    got = eval_batch(torch.from_numpy(frames), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=CROP_ATOL, rtol=0)


@pytest.mark.parametrize("flip", [False, True])
def test_tencrop_batch_matches_jax_for_every_crop(flip):
    frames = _frames(2, h=H0, w=W0, seed=4)
    cfg = AugConfig(img_dim=SIZE, seq_len=T)
    jcfg = JP.AugConfig(img_dim=SIZE, seq_len=T)
    for where in range(1, 6):
        want = np.asarray(JP.tencrop_batch(jnp.asarray(frames), jcfg, where,
                                           flip))
        got = tencrop_batch(torch.from_numpy(frames), cfg, where, flip)
        np.testing.assert_allclose(got.numpy(), want, atol=CROP_ATOL, rtol=0,
                                   err_msg=f"where={where}")


def test_tenclip_batch_matches_jax():
    frames = _frames(2, t=10 * T, seed=5)
    cfg = AugConfig(img_dim=SIZE, seq_len=T)
    want = np.asarray(JP.tenclip_batch(jnp.asarray(frames),
                                       JP.AugConfig(img_dim=SIZE, seq_len=T)))
    got = tenclip_batch(torch.from_numpy(frames), cfg)
    assert tuple(got.shape) == (2, 10, T, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=CROP_ATOL, rtol=0)


def _datasets(mode, n_videos=5, num_frames=4, ds=2):
    out = []
    for pkg in (JL, TL):
        entries, class_index = pkg.synthetic_entries(n_videos, 3)
        source = pkg.SyntheticFrameSource(scale=(H0, W0))
        out.append(pkg.ClassifierDataset(
            entries=entries, class_index=class_index, source=source,
            num_frames=num_frames, ds=ds, mode=mode))
    return out


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_classifier_dataset_matches_jax(mode):
    jds, tds = _datasets(mode)
    assert len(tds) == len(jds)
    if mode == "test":
        assert len(tds) > len(tds.entries)  # every window of every video
    np.testing.assert_array_equal(tds.record_vids(), jds.record_vids())
    for index in range(len(tds)):
        want = jds(index, np.random.default_rng([7, index]))
        got = tds(index, np.random.default_rng([7, index]))
        assert set(got) == set(want) == {"frames", "label", "vid", "rid"}
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert int(got["rid"]) == index


def test_tenclip_dataset_matches_jax():
    out = []
    for pkg in (JL, TL):
        entries, class_index = pkg.synthetic_entries(4, 2)
        out.append(pkg.TenClipDataset(
            entries=entries, class_index=class_index,
            source=pkg.SyntheticFrameSource(scale=(H0, W0)), num_frames=T,
            ds=2))
    jds, tds = out
    assert len(tds) == len(jds) == 4
    for index in range(len(tds)):
        want = jds(index, np.random.default_rng(index))
        got = tds(index, np.random.default_rng(index))
        assert set(got) == set(want) == {"frames", "label", "vid"}
        assert got["frames"].shape == (10 * T, H0, W0, 3)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
