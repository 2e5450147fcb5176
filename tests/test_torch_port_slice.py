"""The first slice of the port as a whole — the SimCLR-TimeSeriesV4 pretrain
step of dualvar_tpu_torch — against the JAX package on the CPU, at B=2, T=8,
32x32 so JAX's CPU compile stays short.

Weights are numpy-made and carried over with ``from_jax_variables``; both
sides get the same block and the same segment permutation.

The JAX side runs in float64 here. Its float32 *backward* pass on XLA:CPU is
not a usable oracle at this size: against its own float64 result the stem
conv's gradient is off by 6 % of its largest entry (layer 4: 1.4 %), while
the port's float32 gradient is within 4e-4 of float64 and the two float64
gradients agree to 1e-6. The float32 forwards agree (tests/
test_torch_port_model.py compares them in float32).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.models.ssl.simclr import SimCLRTimeSeriesV4 as JaxTSV4
from dualvar_tpu.train.pretrain import compute_metrics as jax_metrics
from dualvar_tpu.train.tasks import total_loss as jax_total_loss
from dualvar_tpu_torch.core.config import ModelConfig
from dualvar_tpu_torch.core.convert import from_jax_variables
from dualvar_tpu_torch.train.pretrain import compute_metrics
from dualvar_tpu_torch.train.tasks import make_task, total_loss

from torch_port_util import numpy_variables

B, T, S = 2, 8, 32
PERM = np.array([[1, 0], [0, 1]], np.int32)

# Port float32 against JAX float64: float32 through 18 conv + BN layers whose
# deepest BNs normalise over 8 to 16 values a channel, then cosine / 0.07.
# The backbone band of tests/test_torch_parity.py (5e-4, 1e-3).
ATOL, RTOL = 5e-4, 1e-3


def _block(seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, 3, T, S, S, 3)).astype(np.float32)


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    jm = JaxTSV4(network="r21d")
    return numpy_variables(jm, jnp.zeros((B, 3, T, S, S, 3)), seed=11,
                           train=True)


class JaxStep:
    """The JAX train step, compiled once per setting for the whole module:
    the forward in float32 (both packages' working type), and the gradients
    of the total loss in float64 (see the module docstring)."""

    def __init__(self):
        self._fns = {}

    @staticmethod
    def _loss_fn(packed, dtype):
        jm = JaxTSV4(network="r21d", packed_encode=packed, dtype=dtype)

        def loss_fn(params, stats, block, perm):
            ret, upd = jm.apply({"params": params, "batch_stats": stats},
                                block, perm=perm, train=True,
                                mutable=["batch_stats"])
            return jax_total_loss(ret), (ret, upd["batch_stats"])

        return loss_fn

    def forward(self, packed, params, stats, block):
        """-> (ret, new batch_stats) as numpy trees, float32."""
        key = ("forward", packed)
        if key not in self._fns:
            self._fns[key] = jax.jit(self._loss_fn(packed, jnp.float32))
        _, (ret, new_stats) = self._fns[key](
            params, stats, jnp.asarray(block), jnp.asarray(PERM))
        return _to_numpy(ret), _to_numpy(new_stats)

    def grads_f64(self, params, stats, block):
        """Gradients of the total loss (packed_encode off), float64."""
        with _x64():
            if "grads" not in self._fns:
                self._fns["grads"] = jax.jit(jax.grad(
                    self._loss_fn(False, jnp.float64), has_aux=True))
            grads, _ = self._fns["grads"](
                _f64(params), _f64(stats), jnp.asarray(block, jnp.float64),
                jnp.asarray(PERM))
            return _to_numpy(grads)


@pytest.fixture(scope="module")
def jax_step():
    return JaxStep()


def _port_model(weights, packed):
    task = make_task(ModelConfig(dtype="float32", packed_encode=packed))
    task.model.load_state_dict(
        from_jax_variables(*weights, module=task.model))
    task.model.train()
    return task


@pytest.mark.parametrize("packed", [False, True])
def test_step_losses_logits_bn_stats_and_gradients_match_jax(
        weights, jax_step, packed):
    params, stats = weights
    block = _block()
    ret_j, stats_j = jax_step.forward(packed, params, stats, block)

    task = _port_model(weights, packed)
    ret_t = task.forward(torch.from_numpy(block),
                         perm=torch.from_numpy(PERM))
    total_loss(ret_t).backward()

    assert set(ret_t) == set(ret_j)
    assert sorted(k for k in ret_j if k.endswith("loss")) == [
        "aug_ranking_margin_contrast_loss", "clip_contrast_loss",
        "tc_contrast_loss", "unaug_ranking_margin_contrast_loss"]
    for key, want in ret_j.items():
        got = ret_t[key].detach().numpy()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=key)

    # the new BN statistics: under packed_encode one merged 4B batch, else
    # the 3B pass followed by the B pass, exactly as the JAX package
    want_state = from_jax_variables(params, stats_j)
    got_state = task.model.state_dict()
    for key in (k for k in got_state if "running_" in k):
        np.testing.assert_allclose(
            got_state[key].numpy(), want_state[key].numpy(), atol=1e-5,
            rtol=1e-4, err_msg=key)

    if packed:
        return
    # gradients of the total loss: stem conv, one layer-4 conv, both heads,
    # on the scale of each tensor's largest entry. The port's float32
    # backward sits within 5e-4 of float64 on that scale; 2e-3 leaves room.
    want_grads = from_jax_variables(
        jax_step.grads_f64(params, stats, block), {})
    got_grads = dict(task.model.named_parameters())
    for key in ("backbone.conv1.spatial_conv.weight",
                "backbone.layer4_block0.conv2.temporal_conv.weight",
                "clip_head.fc1.weight", "clip_head.fc2.bias",
                "series_head.fc1.weight", "series_head.fc2.weight"):
        want = want_grads[key].numpy()
        scale = np.abs(want).max()
        assert scale > 0, key
        np.testing.assert_allclose(got_grads[key].grad.numpy() / scale,
                                   want / scale, atol=2e-3, err_msg=key)


def test_packed_encode_changes_train_mode_bn_statistics(weights):
    """The flag is live: merged-batch statistics differ from two passes."""
    block, perm = torch.from_numpy(_block()), torch.from_numpy(PERM)
    states = []
    for packed in (False, True):
        task = _port_model(weights, packed)
        with torch.no_grad():
            task.forward(block, perm=perm)
        states.append(task.model.state_dict()["backbone.bn1.running_mean"])
    assert float((states[0] - states[1]).abs().max()) > 1e-4


def test_compute_metrics_keys_match_jax(weights, jax_step):
    block = _block()
    ret_j, _ = jax_step.forward(False, *weights, block)
    want = jax_metrics({k: jnp.asarray(v) for k, v in ret_j.items()})
    task = _port_model(weights, False)
    with torch.no_grad():
        got = compute_metrics(task.forward(torch.from_numpy(block),
                                           perm=torch.from_numpy(PERM)))
    assert set(got) == set(want)
    for key, w in want.items():
        if key.endswith("loss"):
            np.testing.assert_allclose(float(got[key]), float(w), atol=ATOL,
                                       rtol=RTOL, err_msg=key)
        else:  # accuracies over a handful of rows with well separated logits
            assert float(got[key]) == pytest.approx(float(w)), key
