"""The port's losses and shuffle helpers (dualvar_tpu_torch.models.ssl)
against the JAX package on the golden inputs of tests/test_losses.py.

Logits are compared element by element, masked columns included: both
packages keep the ``[positive | masked similarity row]`` layout with
``NEG_INF = -1e9``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.models.ssl import losses as JL
from dualvar_tpu.models.ssl import simclr as JS
from dualvar_tpu_torch.models.ssl import losses as TL
from dualvar_tpu_torch.models.ssl import simclr as TS

G = os.path.join(os.path.dirname(__file__), "goldens")

# float32 on both sides; the logits are similarities of unit vectors over a
# temperature >= 0.05, so |logit| <= 20 and one rounding is ~2e-6
ATOL = 1e-5


def _load(name):
    return np.load(os.path.join(G, name))


def _compare(got: dict, want: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        g, w = got[key].numpy(), np.asarray(w)
        assert g.shape == w.shape, key
        if key.endswith("labels"):
            np.testing.assert_array_equal(g, w)
            continue
        # masked entries are NEG_INF / T in both: equal to float32 rounding
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=1e-6, err_msg=key)
        if key.endswith("logits"):
            np.testing.assert_array_equal(g < -1e6, w < -1e6)


def test_nt_xent_matches_jax_and_golden():
    f = _load("g_ntxent_in.npy")
    got = TL.nt_xent_loss(torch.from_numpy(f), 0.07)
    _compare(got, JL.nt_xent_loss(jnp.asarray(f), 0.07))
    assert got["clip_logits"].shape == (8, 9)
    # the reference's float64 value (tests/test_losses.py)
    r64 = TL.nt_xent_loss(torch.from_numpy(f).double(), 0.07)
    assert abs(float(r64["clip_contrast_loss"]) - 2.5256540821) < 1e-8


def test_tc_global_matches_jax_and_golden():
    sf = _load("g_tc_in.npy")
    got = TL.tc_contrast_loss_global(torch.from_numpy(sf), 0.11)
    _compare(got, JL.tc_contrast_loss_global(jnp.asarray(sf), 0.11))
    r64 = TL.tc_contrast_loss_global(torch.from_numpy(sf).double(), 0.11)
    assert abs(float(r64["tc_contrast_loss"]) - 3.4785968469) < 1e-8


def test_tc_dtw_raises_and_never_falls_back():
    sf = torch.from_numpy(_load("g_tc_in.npy"))
    with pytest.raises(NotImplementedError, match="soft-DTW"):
        TL.tc_contrast_loss_global(sf, 0.11, align="dtw")
    with pytest.raises(ValueError):
        TL.tc_contrast_loss_global(sf, 0.11, align="median")


@pytest.mark.parametrize("clip_max", [5.0, None])
def test_shuffle_rank_matches_jax(clip_max):
    pf = _load("g_rank_in.npy")
    got = TL.shuffle_rank_loss(torch.from_numpy(pf), 0.05, 0.5, "r_",
                               clip_max=clip_max)
    want = JL.shuffle_rank_loss(jnp.asarray(pf), 0.05, 0.5, "r_",
                                clip_max=clip_max)
    if clip_max is None:
        # unclipped exp((other - partner) / 0.05) reaches e^40: compare the
        # loss relatively
        np.testing.assert_allclose(
            float(got["r_margin_contrast_loss"]),
            float(want["r_margin_contrast_loss"]), rtol=1e-5)
        got.pop("r_margin_contrast_loss"), want.pop("r_margin_contrast_loss")
    _compare(got, want)
    assert got["r_margin_logits"].shape == (4 * 6, 7)
    # the reference's float64 values (tests/test_losses.py)
    r64 = TL.shuffle_rank_loss(torch.from_numpy(pf).double(), 0.05, 0.5, "r_",
                               clip_max=clip_max)
    golden = 1.1121192997 if clip_max else 2.6231011374
    assert abs(float(r64["r_margin_contrast_loss"]) - golden) < 1e-6


def test_cross_entropy_and_topk_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 9)).astype(np.float32) * 3
    labels = rng.integers(0, 9, 16).astype(np.int32)
    got = TL.cross_entropy_from_logits(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    want = JL.cross_entropy_from_logits(jnp.asarray(logits),
                                        jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    for ks in ((1,), (1, 5), (1, 20)):  # k larger than the width is capped
        g = TL.topk_accuracy(torch.from_numpy(logits),
                             torch.from_numpy(labels), ks)
        w = JL.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), ks)
        assert [float(x) for x in g] == [float(x) for x in w]


def test_segment_shuffle_helpers_match_jax():
    rng = np.random.default_rng(1)
    B, T, n_series = 3, 8, 4
    clip = rng.normal(size=(B, T, 5, 6, 3)).astype(np.float32)
    perm = np.stack([rng.permutation(n_series) for _ in range(B)]).astype(
        np.int32)
    want = np.asarray(JS.apply_segment_perm(jnp.asarray(clip),
                                            jnp.asarray(perm), n_series))
    got = TS.apply_segment_perm(torch.from_numpy(clip),
                                torch.from_numpy(perm), n_series)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same shuffle on the planar (B, C, T, H, W) layout the model uses
    planar = torch.from_numpy(clip).permute(0, 4, 1, 2, 3)
    got_p = TS.apply_segment_perm(planar, torch.from_numpy(perm), n_series,
                                  time_axis=2)
    np.testing.assert_array_equal(got_p.permute(0, 2, 3, 4, 1).numpy(), want)

    feats = rng.normal(size=(B, n_series, 7)).astype(np.float32)
    want_c = np.asarray(JS.calibrate_shuffled(jnp.asarray(feats),
                                              jnp.asarray(perm)))
    got_c = TS.calibrate_shuffled(torch.from_numpy(feats),
                                  torch.from_numpy(perm))
    np.testing.assert_array_equal(got_c.numpy(), want_c)


def test_random_segment_perms_are_permutations_from_the_generator():
    g = torch.Generator().manual_seed(0)
    perms = TS.random_segment_perms(g, 2000, 3)
    assert perms.shape == (2000, 3)
    assert torch.equal(perms.sort(dim=1).values,
                       torch.arange(3).expand(2000, 3))
    counts = {}
    for p in perms.tolist():
        counts[tuple(p)] = counts.get(tuple(p), 0) + 1
    # all 6 orders, each near 1/6 (+-5 sigma)
    assert len(counts) == 6
    assert all(abs(c / 2000 - 1 / 6) < 0.045 for c in counts.values())
    again = TS.random_segment_perms(torch.Generator().manual_seed(0), 2000, 3)
    assert torch.equal(perms, again)
