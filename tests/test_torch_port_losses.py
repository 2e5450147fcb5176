"""The port's losses and shuffle helpers (dualvar_tpu_torch.models.ssl)
against the JAX package on the golden inputs of tests/test_losses.py.

Logits are compared element by element, masked columns included: both
packages keep the ``[positive | masked similarity row]`` layout with
``NEG_INF = -1e9``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.models.ssl import losses as JL
from dualvar_tpu.models.ssl import simclr as JS
from dualvar_tpu_torch.models.ssl import losses as TL
from dualvar_tpu_torch.models.ssl import simclr as TS

import torch_port_util  # noqa: F401  (caps torch's threads)

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


def test_tc_global_rejects_an_unknown_align():
    sf = torch.from_numpy(_load("g_tc_in.npy"))
    with pytest.raises(ValueError, match="align"):
        TL.tc_contrast_loss_global(sf, 0.11, align="median")
    qs = torch.from_numpy(_load("g_moco_qs.npy"))
    with pytest.raises(ValueError, match="align"):
        TL.moco_tc_contrast_loss(qs, qs, torch.zeros(16, 15), 0.11,
                                 align="median")


# soft-DTW similarities over a temperature of 0.11: |logit| <= 10, and the
# DTW value carries a few ulp more than a plain inner product
DTW_ATOL = 2e-5


def _compare_dtw(got: dict, want: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        g, w = got[key].detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, key
        if key.endswith("labels"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=DTW_ATOL, rtol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("gamma", [0.1, 1.0])
def test_dtw_alignment_similarity_matches_jax(gamma):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 3, 8)).astype(np.float32)
    b = rng.normal(size=(7, 4, 8)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    # paired (5 against the first 5) and broadcast (5 x 7) leading axes
    for ta, tb in ((a, b[:5]), (a[:, None], b[None, :])):
        want = np.asarray(JL.dtw_alignment_similarity(
            jnp.asarray(ta), jnp.asarray(tb), gamma=gamma, impl="xla"))
        got = TL.dtw_alignment_similarity(torch.from_numpy(ta),
                                          torch.from_numpy(tb), gamma=gamma)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)
    # one segment each: the alignment similarity is the inner product
    one = TL.dtw_alignment_similarity(torch.from_numpy(a[:, :1]),
                                      torch.from_numpy(b[:5, :1]), gamma=0.01)
    np.testing.assert_allclose(
        one.numpy(), np.einsum("bid,bjd->b", a[:, :1], b[:5, :1]), rtol=1e-4,
        atol=1e-6)


@pytest.mark.parametrize("gamma", [0.1, 0.5])
def test_tc_global_dtw_matches_jax_with_gradient(gamma):
    sf = _load("g_tc_in.npy").astype(np.float32)  # (4, 2, 3, 5)
    leaf = torch.from_numpy(sf).requires_grad_()
    got = TL.tc_contrast_loss_global(leaf, 0.11, align="dtw",
                                     dtw_gamma=gamma)
    _compare_dtw(got, JL.tc_contrast_loss_global(
        jnp.asarray(sf), 0.11, align="dtw", dtw_gamma=gamma))
    assert got["tc_logits"].shape == (8, 9)
    np.testing.assert_array_equal(
        got["tc_logits"].detach().numpy() < -1e6,
        np.asarray(JL.tc_contrast_loss_global(
            jnp.asarray(sf), 0.11, align="dtw",
            dtw_gamma=gamma)["tc_logits"]) < -1e6)
    got["tc_contrast_loss"].backward()
    want_g = np.asarray(jax.grad(lambda f: JL.tc_contrast_loss_global(
        f, 0.11, align="dtw", dtw_gamma=gamma)["tc_contrast_loss"])(
            jnp.asarray(sf)))
    np.testing.assert_allclose(leaf.grad.numpy(), want_g, atol=2e-5,
                               rtol=1e-4)
    # gamma reaches the loss: another value gives another loss
    other = TL.tc_contrast_loss_global(torch.from_numpy(sf), 0.11,
                                       align="dtw", dtw_gamma=2 * gamma)
    assert abs(float(other["tc_contrast_loss"])
               - float(got["tc_contrast_loss"].detach())) > 1e-4


def test_moco_clip_matches_jax_and_golden():
    q, k = _load("g_moco_q.npy"), _load("g_moco_k.npy")
    queue = _load("g_moco_queue.npy").T.copy()  # row-major (K, dim)
    f32 = [torch.from_numpy(a.astype(np.float32)) for a in (q, k, queue)]
    f32[0].requires_grad_()
    got = TL.moco_contrast_loss(*f32, 0.07)
    _compare(
        {key: val.detach() for key, val in got.items()},
        JL.moco_contrast_loss(*(jnp.asarray(a, jnp.float32)
                                for a in (q, k, queue)), 0.07))
    assert got["clip_logits"].shape == (4, 17)  # 1 + K
    # no gradient through the key or the queue
    f32[1].requires_grad_(), f32[2].requires_grad_()
    TL.moco_contrast_loss(*f32, 0.07)["clip_contrast_loss"].backward()
    assert f32[0].grad is not None
    assert f32[1].grad is None and f32[2].grad is None
    # the reference's float64 value (tests/test_losses.py)
    r64 = TL.moco_contrast_loss(*(torch.from_numpy(a).double()
                                  for a in (q, k, queue)), 0.07)
    assert abs(float(r64["clip_contrast_loss"]) - 3.6123032569885254) < 1e-6


def _moco_tc_inputs():
    qs, ks = _load("g_moco_qs.npy"), _load("g_moco_ks.npy")
    sq = _load("g_moco_sq.npy").T.copy()  # row-major (K, n_series * dim)
    return qs, ks, sq


def test_moco_tc_mean_matches_jax_and_golden():
    arrays = _moco_tc_inputs()
    got = TL.moco_tc_contrast_loss(
        *(torch.from_numpy(a.astype(np.float32)) for a in arrays), 0.11)
    _compare(got, JL.moco_tc_contrast_loss(
        *(jnp.asarray(a, jnp.float32) for a in arrays), 0.11))
    assert got["tc_logits"].shape == (4, 17)
    r64 = TL.moco_tc_contrast_loss(
        *(torch.from_numpy(a).double() for a in arrays), 0.11)
    assert abs(float(r64["tc_contrast_loss"]) - 3.657632827758789) < 1e-6


@pytest.mark.parametrize("gamma", [0.1, 0.5])
def test_moco_tc_dtw_matches_jax_with_gradient(gamma):
    qs, ks, sq = (a.astype(np.float32) for a in _moco_tc_inputs())
    leaf = torch.from_numpy(qs).requires_grad_()
    got = TL.moco_tc_contrast_loss(leaf, torch.from_numpy(ks),
                                   torch.from_numpy(sq), 0.11, align="dtw",
                                   dtw_gamma=gamma)
    _compare_dtw(got, JL.moco_tc_contrast_loss(
        jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(sq), 0.11, align="dtw",
        dtw_gamma=gamma))
    assert got["tc_logits"].shape == (4, 17)
    got["tc_contrast_loss"].backward()
    want_g = np.asarray(jax.grad(lambda f: JL.moco_tc_contrast_loss(
        f, jnp.asarray(ks), jnp.asarray(sq), 0.11, align="dtw",
        dtw_gamma=gamma)["tc_contrast_loss"])(jnp.asarray(qs)))
    np.testing.assert_allclose(leaf.grad.numpy(), want_g, atol=2e-5,
                               rtol=1e-4)


def test_dtw_losses_in_float64_are_finite_and_close_to_float32():
    """The float64 path the two-step parity test relies on."""
    qs, ks, sq = _moco_tc_inputs()
    r64 = TL.moco_tc_contrast_loss(
        *(torch.from_numpy(a).double() for a in (qs, ks, sq)), 0.11,
        align="dtw")
    r32 = TL.moco_tc_contrast_loss(
        *(torch.from_numpy(a.astype(np.float32)) for a in (qs, ks, sq)), 0.11,
        align="dtw")
    assert r64["tc_logits"].dtype == torch.float64
    np.testing.assert_allclose(r32["tc_logits"].numpy(),
                               r64["tc_logits"].numpy(), atol=DTW_ATOL)


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
