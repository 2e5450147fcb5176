"""The soft-DTW kernels' edges on the CPU: the plain recurrences that
``chip_smoke.py`` holds the kernels against, checked against the JAX
package at every edge shape of the kernels' buckets and routes; the column
bucket the wrapper hands the C entry points; the row-by-row plan of
``csrc/soft_dtw.cu`` (``fwd_row`` / ``bwd_row``, unrolled to the bucket with
``j < M`` guards and the corner of the backward) replayed in plain torch;
and the MoCo TC loss and a train step at n_series 16 and 4.

The CUDA kernels cannot run here. Change ``_emulate_forward`` /
``_emulate_backward`` together with the kernels' row functions.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.models.ssl import losses as JL
from dualvar_tpu.ops import soft_dtw as JD
from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS
from dualvar_tpu_torch.models.ssl import losses as TL
from dualvar_tpu_torch.ops import soft_dtw as TD
from dualvar_tpu_torch.train.pretrain import train

import torch_port_util  # noqa: F401  (caps torch's threads)

# float32 on both sides, the same recurrence in the same order: a few ulp of
# values up to ~25 (16x16)
RTOL, ATOL = 1e-5, 1e-6
INF = float("inf")

# (P, N, M), gamma, bandwidth: the rows route at one column (bucket 2), one
# row (bucket 16), a band narrower than the length gap, each square bucket, a
# single pair, and P not a multiple of a warp's 32 pairs at a ragged M
EDGES = [
    pytest.param((5, 1, 16), 0.1, 0.0, id="1x16"),
    pytest.param((5, 16, 1), 0.1, 0.0, id="16x1"),
    pytest.param((5, 3, 16), 0.7, 2.0, id="3x16-band2"),
    pytest.param((6, 4, 4), 0.1, 0.0, id="4x4"),
    pytest.param((6, 8, 8), 0.1, 0.0, id="8x8"),
    pytest.param((3, 16, 16), 0.1, 0.0, id="16x16"),
    pytest.param((1, 16, 16), 1.0, 0.0, id="P1-16x16"),
    pytest.param((129, 5, 7), 0.5, 0.0, id="P129-5x7"),
]


def _costs(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,gamma,band", EDGES)
def test_plain_recurrences_match_jax_at_the_kernels_edges(shape, gamma, band):
    """R and E cell by cell against ``_softdtw_R_xla`` / ``_softdtw_E_xla``,
    and the differentiable function's values and gradients against
    ``soft_dtw(impl="xla")``."""
    D = _costs(shape, seed=sum(shape))
    w = np.random.default_rng(1).uniform(0.5, 1.0, shape[0]).astype(
        np.float32)
    N, M = shape[1:]
    R_j = JD._softdtw_R_xla(jnp.asarray(D), gamma, band)
    E_j = np.asarray(JD._softdtw_E_xla(jnp.asarray(D), R_j, gamma, band))
    R_j = np.asarray(R_j)[:, 1:N + 1, 1:M + 1]
    R = TD._softdtw_R_plain(torch.from_numpy(D), gamma, band)
    E = TD._softdtw_E_plain(torch.from_numpy(D), R, gamma, band)
    np.testing.assert_array_equal(np.isinf(R.numpy()), np.isinf(R_j))
    np.testing.assert_allclose(R.numpy(), R_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(E.numpy(), E_j, rtol=RTOL, atol=ATOL)

    want_v, vjp = jax.vjp(lambda d: JD.soft_dtw(d, gamma, band, "xla"),
                          jnp.asarray(D))
    want_v, (want_g,) = np.asarray(want_v), vjp(jnp.asarray(w))
    leaf = torch.from_numpy(D).requires_grad_()
    values = TD.soft_dtw(leaf, gamma, band)
    (values * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(values.detach().numpy(), want_v, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(leaf.grad.numpy(), want_g, rtol=RTOL,
                               atol=ATOL)
    if abs(N - M) > band > 0:  # no path fits the band
        assert np.isposinf(want_v).all() and (leaf.grad == 0).all()


@pytest.mark.parametrize("M", range(1, 17))
def test_column_bucket_is_the_smallest_that_holds_the_row(M):
    bucket = TD._column_bucket(M)
    assert bucket in (2, 4, 8, 16) and bucket >= M
    assert bucket == 2 or bucket // 2 < M


@pytest.mark.parametrize("M", [0, 17, -1])
def test_column_bucket_refuses_what_no_kernel_takes(M):
    with pytest.raises(ValueError, match="columns"):
        TD._column_bucket(M)


# --------------------------------------------------------------------------
# the kernels' row plan in plain torch
# --------------------------------------------------------------------------

def _in_band(i, j, band):
    return not band > 0 or abs(i - j) <= band


def _softmin3(a, b, c, gamma):
    """csrc/soft_dtw.cu:softmin3, with the kernel's multiply by 1/gamma."""
    inv = 1.0 / gamma
    r = torch.stack([-a * inv, -b * inv, -c * inv])
    rmax = r.max(dim=0).values
    safe = torch.where(torch.isinf(rmax), torch.zeros_like(rmax), rmax)
    out = -gamma * (torch.log(torch.exp(r - safe).sum(dim=0)) + safe)
    return torch.where(rmax == -INF, torch.full_like(out, INF), out)


def _emulate_forward(D, gamma, band):
    """``fwd_row`` over the rows, one register row of bucket width, columns
    j >= M never touched; the value is the last cell of the last row."""
    P, N, M = D.shape
    kM = TD._column_bucket(M)
    row = [torch.full((P,), INF, dtype=D.dtype) for _ in range(kM)]
    R = torch.empty_like(D)
    for i in range(N):
        diag = torch.full((P,), 0.0 if i == 0 else INF, dtype=D.dtype)
        left = torch.full((P,), INF, dtype=D.dtype)
        for j in range(kM):
            if j < M:
                up = row[j]
                r = torch.full((P,), INF, dtype=D.dtype)
                if _in_band(i, j, band):
                    r = _softmin3(diag, up, left, gamma) + D[:, i, j]
                diag, left, row[j] = up, r, r
        R[:, i] = torch.stack(row[:M], dim=1)
    return row[M - 1], R


def _emulate_backward(D, R, g, gamma, band):
    """``bwd_row`` from the last row up: the rows of E, R and D of row i+1
    carried, the row past the last (-inf, 0) with its corner (E 1, R of the
    last cell) first, column M as E 0, R -inf, D 0."""
    P, N, M = D.shape
    kM = TD._column_bucket(M)
    inv = 1.0 / gamma
    full = lambda v: torch.full((P,), v, dtype=D.dtype)  # noqa: E731
    view = torch.where(torch.isinf(R), torch.full_like(R, -INF), R)
    e = [full(0.0) for _ in range(kM)]
    rn = [full(-INF) for _ in range(kM)]
    dn = [full(0.0) for _ in range(kM)]
    e_corner, r_corner = full(1.0), view[:, N - 1, M - 1]
    dD = torch.empty_like(D)
    for i in range(N - 1, -1, -1):
        rc = [view[:, i, j] if j < M else full(-INF) for j in range(kM)]
        dc = [D[:, i, j] if j < M else full(0.0) for j in range(kM)]
        right_e, right_r, right_d = full(0.0), full(-INF), full(0.0)
        diag_e, diag_r, diag_d = e_corner, r_corner, full(0.0)
        for j in range(kM - 1, -1, -1):
            if j < M:
                down_e, down_r, down_d = e[j], rn[j], dn[j]
                v = full(0.0)
                if _in_band(i, j, band):
                    a = torch.exp((down_r - rc[j] - down_d) * inv)
                    b = torch.exp((right_r - rc[j] - right_d) * inv)
                    c = torch.exp((diag_r - rc[j] - diag_d) * inv)
                    v = down_e * a + right_e * b + diag_e * c
                e[j] = v
                diag_e, diag_r, diag_d = down_e, down_r, down_d
                right_e, right_r, right_d = v, rc[j], dc[j]
        dD[:, i] = torch.stack(e[:M], dim=1) * g[:, None]
        rn, dn = rc, dc
        e_corner, r_corner = full(0.0), full(-INF)
    return dD


@pytest.mark.parametrize("shape,gamma,band", EDGES + [
    pytest.param((7, 2, 2), 0.1, 0.0, id="2x2"),
    pytest.param((7, 2, 2), 0.3, 1.0, id="2x2-band1"),
    pytest.param((4, 13, 11), 0.2, 3.0, id="13x11-band3")])
def test_the_kernels_row_plan_gives_the_plain_recurrences(shape, gamma, band):
    """In float64, where only the logic can differ: R, the values and dD of
    the row plan against the plain recurrences."""
    D = torch.from_numpy(_costs(shape, seed=7).astype(np.float64))
    g = torch.from_numpy(np.random.default_rng(8).normal(size=shape[0]))
    values, R = _emulate_forward(D, gamma, band)
    R_plain = TD._softdtw_R_plain(D, gamma, band)
    assert torch.equal(torch.isinf(R), torch.isinf(R_plain))
    np.testing.assert_allclose(R.numpy(), R_plain.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(values.numpy(), R_plain[:, -1, -1].numpy(),
                               rtol=1e-12, atol=1e-12)
    dD = _emulate_backward(D, R_plain, g, gamma, band)
    dD_plain = TD._softdtw_E_plain(D, R_plain, gamma, band) * g[:, None, None]
    assert not torch.isnan(dD).any()
    np.testing.assert_allclose(dD.numpy(), dD_plain.numpy(), rtol=1e-12,
                               atol=1e-12)


# --------------------------------------------------------------------------
# n_series 16 and 4
# --------------------------------------------------------------------------

def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_moco_tc_dtw_at_sixteen_segments_matches_jax_with_gradient():
    """Path M16's TC loss at B=4, K=16: soft-DTW over 4 + 64 pairs of
    16x16, values, logits and the query gradient against JAX."""
    B, K, S, dim = 4, 16, 16, 8
    rng = np.random.default_rng(16)
    qs, ks = _unit(rng, (B, S, dim)), _unit(rng, (B, S, dim))
    sq = _unit(rng, (K, S, dim)).reshape(K, S * dim)
    leaf = torch.from_numpy(qs).requires_grad_()
    got = TL.moco_tc_contrast_loss(leaf, torch.from_numpy(ks),
                                   torch.from_numpy(sq), 0.07, align="dtw",
                                   dtw_gamma=0.1)
    def jax_loss(f):
        out = JL.moco_tc_contrast_loss(f, jnp.asarray(ks), jnp.asarray(sq),
                                       0.07, align="dtw", dtw_gamma=0.1)
        return out["tc_contrast_loss"], out

    (_, want), want_g = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(qs))
    assert got["tc_logits"].shape == (B, 1 + K)
    for key, w in want.items():
        g, w = got[key].detach().numpy(), np.asarray(w)
        if key.endswith("labels"):
            np.testing.assert_array_equal(g, w)
        else:  # |logit| <= 1/0.07: a few float32 roundings of ~14
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-6,
                                       err_msg=key)
    got["tc_contrast_loss"].backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_g),
                               atol=2e-5, rtol=1e-4)


def test_train_step_of_smoke_moco_with_four_segments_on_cpu(tmp_path):
    """``--preset smoke_moco --mode clip-sr-dtw --n_series 4`` (clips of 8
    frames): one step, finite losses, four segments of the series queue
    written, and no kernel launched on the CPU."""
    cfg = PRETRAIN_PRESETS["smoke_moco"]
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, mode="clip-sr-dtw", n_series=4),
        data=dataclasses.replace(cfg.data, img_dim=32, scale_hw=(40, 36)),
        run=dataclasses.replace(cfg.run, log_root=str(tmp_path)))
    assert cfg.data.seq_len == 8
    TD.soft_dtw_forward.launches = TD.soft_dtw_backward.launches = 0
    metrics = train(cfg, max_steps=1, device="cpu")
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert np.isfinite(metrics["tc_loss"])
    assert TD.soft_dtw_forward.launches == 0
    assert TD.soft_dtw_backward.launches == 0
    state = torch.load(os.path.join(
        tmp_path, cfg.run.prefix, "pretrain", cfg.run.name_prefix, "model",
        "epoch0.pth.tar"))["state_dict"]
    B, d = cfg.optim.batch_size, cfg.model.series_dim
    assert state["series_queue"].shape == (cfg.model.moco_k, 4 * d)
    written = state["series_queue"][:B].reshape(B, 4, d)
    np.testing.assert_allclose(written.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_against_tool_needs_a_card_and_prints_no_timing(tmp_path):
    """``python3 -m dualvar_tpu_torch.tools.soft_dtw_against`` stops with a
    non-zero exit before building anything when there is no CUDA device."""
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "dualvar_tpu_torch.tools.soft_dtw_against",
         "--without-bucket", str(tmp_path / "old.cu")], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "needs a CUDA device" in out.stderr
    assert "soft_dtw against" not in out.stdout
