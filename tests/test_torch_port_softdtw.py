"""The port's soft-DTW (dualvar_tpu_torch.ops.soft_dtw) on the CPU, where the
wrappers take the plain recurrences: values and gradients against the JAX
package's XLA oracle and its Pallas kernels in interpret mode (as
tests/test_softdtw.py runs them), and against an independent numpy DP in
float64 with finite-difference gradients.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds them against the
same plain recurrences on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.ops import soft_dtw as JD
from dualvar_tpu_torch.ops import soft_dtw as TD

import torch_port_util  # noqa: F401  (caps torch's threads)

# float32 on both sides, the same recurrence in the same order: a few ulp of
# values up to ~25 (16x16)
RTOL, ATOL = 1e-5, 1e-6

CASES = [  # shape, gamma, bandwidth
    pytest.param((6, 5, 7), 1.0, 0.0, id="6x5x7"),
    pytest.param((6, 5, 7), 0.7, 2.0, id="6x5x7-band2"),
    pytest.param((64, 2, 2), 0.1, 0.0, id="64x2x2-gamma0.1"),
    pytest.param((8, 16, 16), 1.0, 3.0, id="8x16x16-band3"),
]


def _costs(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _weights(n, seed=1):
    """Per-pair weights of the scalar that is differentiated, so the
    incoming gradient differs from pair to pair."""
    return np.random.default_rng(seed).uniform(0.5, 1.0, n).astype(np.float32)


def np_softdtw(D, gamma, bandwidth=0.0):
    """Straight-line DP written from the recurrence, in the dtype of D."""
    B, N, M = D.shape
    R = np.full((B, N + 2, M + 2), np.inf)
    R[:, 0, 0] = 0
    for b in range(B):
        for j in range(1, M + 1):
            for i in range(1, N + 1):
                if 0 < bandwidth < abs(i - j):
                    continue
                r = -np.array([R[b, i - 1, j - 1], R[b, i - 1, j],
                               R[b, i, j - 1]]) / gamma
                rmax = r.max()
                R[b, i, j] = D[b, i - 1, j - 1] - gamma * (
                    np.log(np.exp(r - rmax).sum()) + rmax)
    return R[:, -2, -2]


def _port(D, w, gamma, band, fn=TD.soft_dtw):
    leaf = torch.from_numpy(D).requires_grad_()
    values = fn(leaf, gamma, band)
    (values * torch.from_numpy(w)).sum().backward()
    return values.detach().numpy(), leaf.grad.numpy()


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("shape,gamma,band", CASES)
def test_values_and_gradient_match_jax(shape, gamma, band, impl):
    D, w = _costs(shape), _weights(shape[0])
    want_v = np.asarray(JD.soft_dtw(jnp.asarray(D), gamma, band, impl))
    want_g = np.asarray(jax.grad(lambda d: jnp.sum(
        JD.soft_dtw(d, gamma, band, impl) * w))(jnp.asarray(D)))
    got_v, got_g = _port(D, w, gamma, band)
    np.testing.assert_allclose(got_v, want_v, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_g, want_g, rtol=RTOL, atol=ATOL)
    if band:
        assert (got_g == 0).any()  # out-of-band cells carry no gradient


@pytest.mark.parametrize("shape,gamma,band", CASES)
def test_r_and_e_matrices_match_the_xla_oracle(shape, gamma, band):
    """The interiors of R and E cell by cell, +inf of a band included."""
    D = _costs(shape, seed=2)
    N, M = shape[1:]
    R_j = JD._softdtw_R_xla(jnp.asarray(D), gamma, band)
    E_j = np.asarray(JD._softdtw_E_xla(jnp.asarray(D), R_j, gamma, band))
    R_j = np.asarray(R_j)[:, 1:N + 1, 1:M + 1]
    values, R = TD.soft_dtw_forward(torch.from_numpy(D), gamma, band)
    E = TD.soft_dtw_backward(torch.from_numpy(D), R, torch.ones(shape[0]),
                             gamma, band)
    assert R.shape == E.shape == shape and R.is_contiguous()
    np.testing.assert_array_equal(np.isinf(R.numpy()), np.isinf(R_j))
    assert bool(np.isinf(R_j).any()) == bool(band)
    np.testing.assert_allclose(R.numpy(), R_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(values.numpy(), R_j[:, -1, -1], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(E.numpy(), E_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,gamma,band", CASES)
def test_float64_matches_numpy_dp_and_finite_differences(shape, gamma, band):
    D = _costs(shape, seed=3).astype(np.float64)[:4]
    w = np.ones(len(D))
    got_v, got_g = _port(D, w, gamma, band)
    np.testing.assert_allclose(got_v, np_softdtw(D, gamma, band), rtol=1e-12)
    eps = 1e-6
    rng = np.random.default_rng(4)
    for _ in range(6):
        idx = tuple(rng.integers(0, n) for n in D.shape)
        Dp, Dm = D.copy(), D.copy()
        Dp[idx] += eps
        Dm[idx] -= eps
        fd = (np_softdtw(Dp, gamma, band).sum()
              - np_softdtw(Dm, gamma, band).sum()) / (2 * eps)
        assert abs(got_g[idx] - fd) < 1e-7, idx


def test_plain_function_is_the_wrapper_on_cpu_tensors():
    D, w = _costs((9, 4, 3)), _weights(9)
    v1, g1 = _port(D, w, 0.3, 0.0, TD.soft_dtw)
    v2, g2 = _port(D, w, 0.3, 0.0, TD.soft_dtw_plain)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(g1, g2)
    assert TD.soft_dtw_forward.launches == 0
    assert TD.soft_dtw_backward.launches == 0


def test_band_narrower_than_the_length_gap_gives_inf_and_zero_gradient():
    D, w = _costs((3, 5, 7)), _weights(3)
    values, grad = _port(D, w, 0.7, 1.0)
    assert np.isposinf(values).all()
    assert (grad == 0).all() and not np.isnan(grad).any()


def test_softmin_of_three_infinities_is_infinity_not_nan():
    inf = torch.full((4,), float("inf"))
    assert torch.isposinf(TD._softmin3(inf, inf, inf, 0.1)).all()
    one = TD._softmin3(torch.zeros(4), inf, inf, 0.1)
    np.testing.assert_allclose(one.numpy(), 0.0, atol=1e-7)


def test_gradient_arrives_expanded_or_strided():
    """``sum()`` hands the backward an expanded gradient, a slice a strided
    one; the function makes it contiguous."""
    D = _costs((8, 3, 3))
    leaf = torch.from_numpy(D).requires_grad_()
    TD.soft_dtw(leaf, 0.5).sum().backward()
    want = leaf.grad.clone()
    leaf.grad = None
    (TD.soft_dtw(leaf, 0.5)[::2] * 2).sum().backward()
    np.testing.assert_allclose(leaf.grad[::2].numpy(), 2 * want[::2].numpy(),
                               rtol=1e-6)
    assert float(leaf.grad[1::2].abs().max()) == 0.0


def test_cost_matrix_may_be_a_non_contiguous_view():
    D = _costs((5, 4, 6))
    strided = torch.from_numpy(D.transpose(0, 2, 1).copy()).transpose(1, 2)
    assert not strided.is_contiguous()
    np.testing.assert_array_equal(
        TD.soft_dtw(strided, 0.4).numpy(),
        TD.soft_dtw(torch.from_numpy(D), 0.4).numpy())


def test_empty_batch():
    leaf = torch.zeros(0, 2, 2, requires_grad=True)
    values = TD.soft_dtw(leaf, 0.1)
    assert values.shape == (0,)
    values.sum().backward()
    assert leaf.grad.shape == (0, 2, 2)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    D = torch.zeros(4, 2, 2)
    with pytest.raises(TypeError, match="float32"):
        TD.soft_dtw(D.to(torch.bfloat16), 0.1)
    with pytest.raises(TypeError, match="float32"):
        TD.soft_dtw(D.to(torch.int32), 0.1)
    with pytest.raises(ValueError, match=r"\(P, N, M\)"):
        TD.soft_dtw(torch.zeros(4, 2), 0.1)
    with pytest.raises(ValueError, match="gamma"):
        TD.soft_dtw(D, 0.0)
    values, R = TD.soft_dtw_forward(D, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        TD.soft_dtw_forward(D.transpose(1, 2)[:, :, :1].expand(4, 2, 2), 0.1)
    with pytest.raises(ValueError, match="do not match"):
        TD.soft_dtw_backward(D, R, torch.ones(3), 0.1)
    with pytest.raises(TypeError, match="float64"):
        TD.soft_dtw_backward(D, R, torch.ones(4, dtype=torch.float64), 0.1)
    # above the kernels' size the CPU still takes the plain recurrence; the
    # limit belongs to the card
    assert TD.soft_dtw(torch.zeros(2, 17, 3), 0.1).shape == (2,)


def test_a_cuda_request_without_a_card_raises_and_never_runs_plain():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        TD.soft_dtw(torch.zeros(4, 2, 2).to("cuda"), 0.1)


def test_distance_builders_and_sequences_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4, 6)).astype(np.float32)
    y = rng.normal(size=(3, 5, 6)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(
        TD.similarity_matrix(tx, ty).numpy(),
        np.asarray(JD.similarity_matrix(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        TD.euclidean_matrix(tx, ty).numpy(),
        np.asarray(JD.euclidean_matrix(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)
    for dist in ("similarity", "euclidean"):
        want = np.asarray(JD.soft_dtw_sequences(
            jnp.asarray(x), jnp.asarray(y), 0.8, 0.0, dist, impl="xla"))
        got = TD.soft_dtw_sequences(tx, ty, 0.8, 0.0, dist).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="dist"):
        TD.soft_dtw_sequences(tx, ty, dist="cosine")


def test_kernel_build_raises_without_nvcc_and_nothing_is_launched(
        tmp_path, monkeypatch):
    import os
    import shutil

    from dualvar_tpu_torch.ops import build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    build.load_library.cache_clear()
    TD._kernel.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        TD._kernel("soft_dtw_fwd_launch", 3)
    assert os.listdir(tmp_path) == []
    assert TD.soft_dtw_forward.launches == 0
