"""The port's 3x3x3 conv + BN-statistics function
(dualvar_tpu_torch.ops.conv_fused) against the JAX package's
``_fused_fwd`` (Pallas kernel in interpret mode), ``conv3d_bn_stats_xla``
and the custom-VJP backward ``_bwd``, on the CPU.

On CPU tensors the forward takes its plain version; the CUDA kernel is held
against that version, and against float64 sums of its own output, on the
card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.ops import conv_fused as JC
from dualvar_tpu_torch.ops import conv_fused as TC

import torch_port_util  # noqa: F401  (caps torch's threads)

SHAPE, WSHAPE = (2, 3, 6, 6, 8), (3, 3, 3, 8, 8)  # tests/test_conv_fused.py


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    w = (rng.standard_normal(WSHAPE) * 0.2).astype(np.float32)
    return x, w


def test_plain_matches_jax_interpret_kernel_and_xla():
    """With the tolerances of tests/test_conv_fused.py."""
    x, w = _inputs(0)
    got = TC.conv3d_bn_stats_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got[0].shape == SHAPE and got[1].dtype == torch.float32
    for want in (JC._fused_fwd(jnp.asarray(x), jnp.asarray(w),
                               interpret=True),
                 JC.conv3d_bn_stats_xla(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=1e-4)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   atol=1e-3)


def test_forward_on_cpu_is_the_plain_version_without_a_graph():
    x, w = (torch.from_numpy(a).requires_grad_() for a in _inputs(1))
    got = TC.conv3d_bn_stats_forward(x, w)
    want = TC.conv3d_bn_stats_plain(x.detach(), w.detach())
    for g, wnt in zip(got, want):
        assert not g.requires_grad
        assert torch.equal(g, wnt)
    assert TC.conv3d_bn_stats_forward.launches == 0  # no kernel on the CPU


def test_backward_matches_jax_bwd_on_the_same_residuals():
    """The port's backward against ``conv_fused._bwd`` driven with the same
    residuals (x, w, y) and cotangents, tolerances of
    tests/test_conv_fused.py."""
    x, w = _inputs(2)
    y, s1, _ = JC.conv3d_bn_stats_xla(jnp.asarray(x), jnp.asarray(w))
    cots = (jnp.cos(y), jnp.full_like(s1, 0.3), jnp.full_like(s1, 0.1))
    gx_j, gw_j = JC._bwd((jnp.asarray(x), jnp.asarray(w), y), cots)
    gx_t, gw_t = TC.conv3d_bn_stats_backward(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(np.array(y)),
        *(torch.from_numpy(np.array(c)) for c in cots))
    assert gx_t.shape == SHAPE and gw_t.shape == WSHAPE
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), atol=2e-4)
    np.testing.assert_allclose(gw_t.numpy(), np.asarray(gw_j), atol=2e-3)


def test_autograd_matches_jax_grad_of_the_xla_contract():
    """The differentiable function end to end: d/dx and d/dw of
    sum(sin y) + 0.3 sum(s1) + 0.1 sum(s2) against jax.grad of the same
    loss on ``conv3d_bn_stats_xla``."""
    x, w = _inputs(3)

    def loss_ref(x, w):
        y, s1, s2 = JC.conv3d_bn_stats_xla(x, w)
        return jnp.sum(jnp.sin(y)) + jnp.sum(s1 * 0.3) + jnp.sum(s2 * 0.1)

    gx_j, gw_j = jax.grad(loss_ref, argnums=(0, 1))(jnp.asarray(x),
                                                     jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y, s1, s2 = TC.conv3d_bn_stats(xt, wt)
    (y.sin().sum() + 0.3 * s1.sum() + 0.1 * s2.sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=2e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=2e-3)


def test_channels_last_3d_map_is_the_jax_layout_without_a_copy():
    """An NCDHW map in channels_last_3d memory, permuted to (N, T, H, W, C),
    is contiguous: the kernel takes it as it is."""
    x, w = _inputs(4)
    ncdhw = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous(
        memory_format=torch.channels_last_3d)
    view = ncdhw.permute(0, 2, 3, 4, 1)
    assert view.is_contiguous() and view.data_ptr() == ncdhw.data_ptr()
    got = TC.conv3d_bn_stats_plain(view, torch.from_numpy(w))
    want = TC.conv3d_bn_stats_plain(torch.from_numpy(x), torch.from_numpy(w))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt.numpy(), atol=1e-5)


def test_refuses_what_is_not_a_3x3x3_conv():
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match=r"\(3, 3, 3, C, Co\)"):
        TC.conv3d_bn_stats_forward(x, torch.zeros(1, 3, 3, 8, 8))
    with pytest.raises(ValueError, match=r"\(3, 3, 3, C, Co\)"):
        TC.conv3d_bn_stats_forward(x, torch.zeros(3, 3, 3, 4, 8))


@pytest.mark.parametrize("W,Co,want", [
    (56, 64, (2, 64, 77568)),    # path R's layer 1
    (28, 128, (2, 64, 66816)),   # layer 2 (tiled over Co)
    (7, 512, (2, 64, 59136)),    # layer 4
    (112, 64, (1, 64, 88128)),   # too wide for two rows of 64 channels
    (6, 8, (2, 8, 16384)),       # the test size
])
def test_tiling_fits_a_block(W, Co, want):
    """Rows a block, output channels a block and shared memory: at most one
    4 x 8 output tile a thread of 256, within 227 KB."""
    ht, co_tile, smem = TC._tiling(W, Co)
    assert (ht, co_tile, smem) == want
    assert ht * -(-W // 4) * co_tile // 8 <= 256 and smem <= 232448
    with pytest.raises(ValueError, match="too wide"):
        TC._tiling(4096, 8)
