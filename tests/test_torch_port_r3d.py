"""The port's R3D-18 backbone (dualvar_tpu_torch.models.backbones.r3d) and
the weight conversion of the models built on it, against the JAX package on
the CPU.

Both sides get the same numpy-made weights (through ``from_jax_variables``)
and the same numpy-made input. The JAX R3DNet evaluates its stem by
space-to-depth at these even sizes, the port by the plain (3,7,7) stride
(1,2,2) convolution: the same function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.models.backbones.r3d import R3DNet as JaxR3D
from dualvar_tpu.models.ssl import moco as JM
from dualvar_tpu.models.ssl.simclr import SimCLRNaked as JaxNaked
from dualvar_tpu_torch.core.config import ModelConfig
from dualvar_tpu_torch.core.convert import (from_jax_task_state,
                                            from_jax_variables)
from dualvar_tpu_torch.models.backbones import select_backbone
from dualvar_tpu_torch.models.backbones.r3d import R3DNet
from dualvar_tpu_torch.models.ssl.simclr import SimCLRNaked
from dualvar_tpu_torch.train.tasks import make_task

from torch_port_util import moco_numpy_state, numpy_variables

# the backbone band of tests/test_torch_parity.py: float32 convolutions
# summed in another order through 17 conv + BN layers
ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(scope="module")
def r3d_pair():
    """(JAX model, params, batch_stats, port model) with the same weights."""
    jm = JaxR3D()
    params, stats = numpy_variables(
        jm, jnp.zeros((1, 8, 32, 32, 3)), seed=0, train=False)
    tm = R3DNet()
    tm.load_state_dict(from_jax_variables(params, stats, module=tm))
    return jm, params, stats, tm


def _input(batch, seed):
    x = np.random.default_rng(seed).normal(
        size=(batch, 3, 8, 32, 32)).astype(np.float32)
    return x, jnp.asarray(x.transpose(0, 2, 3, 4, 1))  # NCDHW, NTHWC


def test_parameter_count_and_registry():
    bb, meta = select_backbone("r3d")
    assert isinstance(bb, R3DNet)
    assert sum(p.numel() for p in bb.parameters()) == 14_361_792
    assert meta == {"feature_size": 512}
    # 12 batch norms: the stem's, two a block and the three shortcuts'
    assert sum(type(m).__name__ == "BatchNorm" for m in bb.modules()) == 12


def test_eval_forward_matches_jax(r3d_pair):
    jm, params, stats, tm = r3d_pair
    x_t, x_j = _input(2, seed=1)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x_j)
    want = np.asarray(want).transpose(0, 4, 1, 2, 3)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x_t))
    assert got.shape == want.shape == (2, 512, 1, 2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_train_forward_and_running_stats_match_jax(r3d_pair):
    """Batch statistics, and the running mean and biased running variance
    after one train-mode forward."""
    jm, params, stats, tm = r3d_pair
    x_t, x_j = _input(2, seed=2)
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
    assert len(keys) == 2 * 12
    for key in keys:
        np.testing.assert_allclose(
            got_state[key].numpy(), want_state[key].numpy(),
            atol=1e-5, rtol=1e-4, err_msg=key)


def test_from_jax_variables_fills_simclr_naked_on_r3d():
    params, stats = numpy_variables(
        JaxNaked(network="r3d"), jnp.zeros((2, 2, 8, 32, 32, 3)), seed=3,
        train=True)
    tm = SimCLRNaked(network="r3d")
    state = from_jax_variables(params, stats, module=tm)
    tm.load_state_dict(state)  # strict
    n_leaves = len(jax.tree.leaves(params)) + len(jax.tree.leaves(stats))
    assert len(state) == n_leaves == len(tm.state_dict())
    # one leaf of each kind, back by hand
    k = params["backbone"]["layer2_block0"]["downsample_conv"]["kernel"]
    np.testing.assert_array_equal(
        state["backbone.layer2_block0.downsample_conv.weight"].numpy()
        .transpose(2, 3, 4, 1, 0), k)
    np.testing.assert_array_equal(
        state["backbone.conv1.weight"].numpy().transpose(2, 3, 4, 1, 0),
        params["backbone"]["conv1"]["kernel"])
    np.testing.assert_array_equal(
        state["backbone.layer4_block0.bn2.running_mean"].numpy(),
        stats["backbone"]["layer4_block0"]["bn2"]["bn"]["mean"])
    # a leaf of the wrong shape is an error, not a silent load
    bad = jax.tree.map(lambda a: a, params)
    bad["clip_head"]["fc1"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_variables(bad, stats, module=tm)


@pytest.mark.parametrize("model", ["moco_naked", "moco_timeseriesv4"])
def test_from_jax_task_state_fills_moco_on_r3d(model):
    naked = model == "moco_naked"
    encoder = JM.MoCoEncoder(network="r3d", with_series=not naked)
    params, stats, moco = moco_numpy_state(
        encoder, jnp.zeros((2, 8, 32, 32, 3)), K=16, seed=4)
    task = make_task(ModelConfig(net="r3d", model=model, moco_k=16),
                     torch.Generator().manual_seed(0))
    state = from_jax_task_state(params, stats, moco, module=task.model)
    task.model.load_state_dict(state)  # strict
    np.testing.assert_array_equal(
        state["encoder_k.backbone.layer3_block0.conv2.weight"].numpy()
        .transpose(2, 3, 4, 1, 0),
        moco["params_k"]["backbone"]["layer3_block0"]["conv2"]["kernel"])
    assert int(state["queue_ptr"]) == 4
    with pytest.raises(KeyError, match="unfilled"):
        from_jax_task_state(
            {k: v for k, v in params.items() if k != "backbone"}, stats,
            moco, module=task.model)
