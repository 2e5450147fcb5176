"""The port's layers, r21d backbone, heads and weight conversion
(dualvar_tpu_torch.models, .core.convert) against the JAX package on the CPU.

Both sides get the same numpy-made weights (through ``from_jax_variables``)
and the same numpy-made input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.models import heads as JH
from dualvar_tpu.models import layers as JLy
from dualvar_tpu.models.backbones.r21d import R2Plus1DNet as JaxR21d
from dualvar_tpu.models.backbones.r21d import \
    intermed_channels as jax_intermed_channels
from dualvar_tpu.models.ssl.simclr import SimCLRTimeSeriesV4 as JaxTSV4
from dualvar_tpu_torch.core.convert import from_jax_variables
from dualvar_tpu_torch.models import layers as TLy
from dualvar_tpu_torch.models.backbones import select_backbone
from dualvar_tpu_torch.models.backbones.r21d import (R2Plus1DNet,
                                                     intermed_channels)
from dualvar_tpu_torch.models.heads import MLPHead
from dualvar_tpu_torch.models.ssl.simclr import SimCLRTimeSeriesV4

from torch_port_util import numpy_variables

# the band tests/test_torch_parity.py uses for the r21d forward: float32
# convolutions summed in another order through 18 conv + BN layers
ATOL, RTOL = 5e-4, 1e-3


@pytest.fixture(scope="module")
def r21d_pair():
    """(JAX model, params, batch_stats, port model) with the same weights."""
    jm = JaxR21d()
    params, stats = numpy_variables(
        jm, jnp.zeros((1, 8, 32, 32, 3)), seed=0, train=False)
    tm = R2Plus1DNet()
    tm.load_state_dict(from_jax_variables(params, stats, module=tm))
    return jm, params, stats, tm


def _input(batch, seed=1):
    x = np.random.default_rng(seed).normal(
        size=(batch, 3, 8, 32, 32)).astype(np.float32)
    return x, jnp.asarray(x.transpose(0, 2, 3, 4, 1))  # NCDHW, NTHWC


def test_backbone_parameter_count():
    bb, meta = select_backbone("r21d")
    assert sum(p.numel() for p in bb.parameters()) == 14_365_303
    assert meta == {"feature_size": 512}


@pytest.mark.parametrize("name", ["s3dg_packed", "r21d_tiled", "s3d_packed",
                                  "r21d_pad128"])
def test_unported_backbones_raise_naming_the_roadmap(name):
    """The registry variants build now (tests/test_torch_port_variants.py
    holds them against JAX); what stays unported for them is the reference
    checkpoint mapping, which the JAX package's converter lacks as well:
    the converter refuses them, naming the families it maps. An unknown
    name is refused by the registry."""
    from dualvar_tpu_torch.core.convert import backbone_from_torch

    module, meta = select_backbone(name)
    assert meta["feature_size"] == (512 if name.startswith("r21d") else 1024)
    with pytest.raises(NotImplementedError, match="supported"):
        backbone_from_torch({}, name)
    with pytest.raises(NotImplementedError, match="unknown backbone"):
        select_backbone(name + "_x")


@pytest.mark.parametrize("args", [(3, 64, (3, 7, 7)), (64, 64, 3),
                                  (64, 128, 1), (256, 512, 3)])
def test_intermed_channels_matches_jax(args):
    assert intermed_channels(*args) == jax_intermed_channels(*args)


def test_from_jax_variables_round_trip():
    jm = JaxTSV4(network="r21d")
    params, stats = numpy_variables(
        jm, jnp.zeros((2, 3, 8, 32, 32, 3)), seed=2, train=True)
    tm = SimCLRTimeSeriesV4()
    state = from_jax_variables(params, stats, module=tm)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)  # strict
    n_leaves = len(jax.tree.leaves(params)) + len(jax.tree.leaves(stats))
    assert len(state) == n_leaves  # every leaf consumed into its own key
    # back again by hand for one leaf of each kind
    k = params["backbone"]["layer4_block0"]["conv1"]["spatial_conv"]["kernel"]
    w = state["backbone.layer4_block0.conv1.spatial_conv.weight"].numpy()
    np.testing.assert_array_equal(w.transpose(2, 3, 4, 1, 0), k)
    np.testing.assert_array_equal(
        state["series_head.fc2.weight"].numpy().T,
        params["series_head"]["fc2"]["kernel"])
    np.testing.assert_array_equal(
        state["clip_head.fc1.bias"].numpy(), params["clip_head"]["fc1"]["bias"])
    np.testing.assert_array_equal(
        state["backbone.conv1.bn.weight"].numpy(),
        params["backbone"]["conv1"]["bn"]["bn"]["scale"])
    np.testing.assert_array_equal(
        state["backbone.bn1.running_var"].numpy(),
        stats["backbone"]["bn1"]["bn"]["var"])
    # a missing leaf or a stray one is an error, not a silent partial load
    short = {k: v for k, v in params.items() if k != "clip_head"}
    with pytest.raises(KeyError, match="unfilled"):
        from_jax_variables(short, stats, module=tm)
    extra = dict(params, other_head=params["clip_head"])
    with pytest.raises(KeyError, match="unconsumed"):
        from_jax_variables(extra, stats, module=tm)
    with pytest.raises(KeyError, match="unknown leaf"):
        from_jax_variables({"x": {"gamma": np.zeros(3)}}, {})


def test_r21d_eval_forward_matches_jax(r21d_pair):
    jm, params, stats, tm = r21d_pair
    x_t, x_j = _input(1)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x_j)
    want = np.asarray(want).transpose(0, 4, 1, 2, 3)
    tm.eval()
    with torch.no_grad():
        got, feats = tm(torch.from_numpy(x_t), multi_level=True)
    assert got.shape == want.shape == (1, 512, 1, 2, 2)
    assert [f.shape[1] for f in feats] == [64, 128, 256, 512]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_r21d_train_forward_and_running_stats_match_jax(r21d_pair):
    """Train mode: batch statistics, and the running mean AND running var
    after one step. The deepest BNs see n = B*T'*H'*W' = 8 values a channel,
    so the unbiased variance torch.nn.BatchNorm3d would fold differs by 8/7:
    matching running_var here pins the biased-variance rule."""
    jm, params, stats, tm = r21d_pair
    x_t, x_j = _input(2, seed=3)
    want, updated = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, x_j)
    want = np.asarray(want).transpose(0, 4, 1, 2, 3)
    tm.load_state_dict(from_jax_variables(params, stats))
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x_t))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    want_state = from_jax_variables(params, updated["batch_stats"])
    got_state = tm.state_dict()
    keys = [k for k in got_state if "running_" in k]
    assert len(keys) == 2 * 24
    for key in keys:
        np.testing.assert_allclose(
            got_state[key].numpy(), want_state[key].numpy(),
            atol=1e-5, rtol=1e-4, err_msg=key)
    # the rule is visible: the unbiased fold would be off by far more
    key = "layer4_block0.bn2.running_var"
    old = torch.from_numpy(stats["layer4_block0"]["bn2"]["bn"]["var"])
    batch_var = (got_state[key] - 0.9 * old) / 0.1
    unbiased = 0.9 * old + 0.1 * batch_var * 8 / 7
    assert float((unbiased - want_state[key]).abs().max()) > 1e-3


def test_batchnorm_folds_the_biased_variance():
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, size=(2, 5, 1, 2, 2)).astype(np.float32)
    bn = TLy.BatchNorm(5)
    bn.train()
    y = bn(torch.from_numpy(x))
    mean = x.mean(axis=(0, 2, 3, 4))
    var = x.var(axis=(0, 2, 3, 4))  # biased (ddof=0), n = 8
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var,
                               rtol=1e-5)
    want = (x - mean[None, :, None, None, None]) / np.sqrt(
        var[None, :, None, None, None] + 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), want, atol=1e-5)
    assert set(bn.state_dict()) == {"weight", "bias", "running_mean",
                                    "running_var"}
    # eval mode uses the running statistics and leaves them alone
    bn.eval()
    before = bn.running_var.clone()
    y_eval = bn(torch.from_numpy(x))
    assert torch.equal(bn.running_var, before)
    want_eval = (x - bn.running_mean.numpy()[None, :, None, None, None]) \
        / np.sqrt(before.numpy()[None, :, None, None, None] + 1e-5)
    np.testing.assert_allclose(y_eval.detach().numpy(), want_eval, atol=1e-5)


def test_batchnorm_gradients_match_jax():
    """The hand-folded BN still differentiates like the JAX one (which has a
    hand-written VJP): d/dx, d/dscale, d/dbias of sum(y * w)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)  # NTHWC
    w = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)

    def jax_loss(x, scale, bias):
        y, _, _ = JLy._bn_train_fused(x, scale, bias, 1e-5)
        return jnp.sum(y * w)

    gx, gs, gb = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    bn = TLy.BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()).requires_grad_()
    (bn(xt) * torch.from_numpy(w.transpose(0, 4, 1, 2, 3).copy())).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 4, 1),
                               np.asarray(gx), atol=1e-4)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gs),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gb),
                               atol=1e-4, rtol=1e-4)


def test_mlp_head_matches_jax():
    jm = JH.MLPHead(24)
    params, _ = numpy_variables(jm, jnp.zeros((1, 16)), seed=6)
    x = np.random.default_rng(7).normal(size=(5, 16)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = MLPHead(16, 24)
    tm.load_state_dict(from_jax_variables(params, {}, module=tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pool_and_l2_normalize_match_jax():
    x = np.random.default_rng(8).normal(size=(3, 4, 5, 6, 7)).astype(np.float32)
    np.testing.assert_allclose(
        TLy.global_avg_pool3d(
            torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy())).numpy(),
        np.asarray(JLy.global_avg_pool3d(jnp.asarray(x))), atol=1e-6)
    v = x.reshape(3, -1)
    v[1] = 0.0  # the eps clamp
    np.testing.assert_allclose(
        TLy.l2_normalize(torch.from_numpy(v), axis=1).numpy(),
        np.asarray(JLy.l2_normalize(jnp.asarray(v), axis=1)), atol=1e-6)
