"""Three SGD steps of the ``r21d_pad128`` and ``s3dg_packed`` backbones
against the JAX package on the CPU, in float64, on both of the port's
batch-norm routes (ATen's, and the one-pass ``_OnePassBN`` under
``DUALVAR_BN_STATS=pallas``, whose float64 sums take the plain version);
and ``r21d_pad128``'s pad blocks after the steps.

Each step is train mode on a new numpy-made batch with the loss
sum(features * w), then the JAX package's optimizer (weight decay
added to the gradient, SGD with momentum 0.9: ``optax.chain(
add_decayed_weights, sgd)``) against ``torch.optim.SGD`` with the same
rule. The weights are made as ``tests/test_torch_port_variants.py`` makes
them (``r21d_pad128`` embedded from an ``r21d``: pad blocks zero). JAX's
float64 route is one (it routes float64 away from its kernel), so each of
the port's routes is held against the same JAX run. Bands, those of
``tests/test_torch_port_s3dg_step.py``: the first step's gradients 5e-6 of
each tensor's largest entry (floored at ``GRAD_FLOOR`` of the largest
gradient), the running statistics 1e-6, the parameters' change over the
three steps 5e-6 of each tensor's largest change (floored the same way).

Sizes: ``r21d_pad128`` at B=2, T=8, 32x32 (the other port files' size);
``s3dg_packed`` at B=4, T=8, 64x64, where its last batch norms see 16
values a channel. At B=2 and 32x32 they see 2, and three steps in float64
already part the two packages by up to 0.3 of a gradient tensor's scale:
the gradients through such a batch norm are ill-conditioned, and SGD
compounds the rounding of the first step's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dualvar_tpu.models.backbones import select_backbone as jax_backbone
from dualvar_tpu_torch.core.convert import _convert_leaf, _flatten
from dualvar_tpu_torch.models.backbones import select_backbone
from dualvar_tpu_torch.models.backbones.r21d import pad_blocks

from test_torch_port_variants import variant_variables
from torch_port_util import GRAD_FLOOR, backbone_input, x64

STEPS, WD, MOMENTUM = 3, 1e-4, 0.9
# net -> ((B, T, S), learning rate)
NETS = {"r21d_pad128": ((2, 8, 32), 0.05), "s3dg_packed": ((4, 8, 64), 0.01)}


def _state64(tree) -> dict[str, torch.Tensor]:
    """A numpy variable tree -> port state_dict keys, in float64 (the
    converter's layouts without its float32 cast)."""
    out = {}
    for path, value in _flatten(tree):
        key, _ = _convert_leaf(path, value)
        if value.ndim == 5:
            value = value.transpose(4, 3, 0, 1, 2)
        elif value.ndim == 2:
            value = value.T
        out[key] = torch.from_numpy(np.array(value, np.float64, order="C"))
    return out


def _batches(net, seed):
    size = NETS[net][0]
    return [backbone_input(size, seed + i) for i in range(STEPS)]


@pytest.fixture(scope="module", params=sorted(NETS))
def jax_run(request):
    """The JAX package's three float64 steps of one net: (net, params0,
    stats0, first-step gradients, params after, batch_stats after, the
    loss weights w), trees as port float64 state_dicts."""
    net = request.param
    (B, T, S), lr = NETS[net]
    jm, params, stats = variant_variables(net, seed=21)
    jm64, _ = jax_backbone(net, dtype=jnp.float64)
    batches = _batches(net, 22)
    out_shape = (B,) + tuple(jax.eval_shape(
        lambda: jm.apply({"params": params, "batch_stats": stats},
                         jnp.zeros((1, T, S, S, 3)), train=False)).shape[1:])
    w = np.random.default_rng(23).normal(size=out_shape)

    def loss_fn(p, s, x):
        y, upd = jm64.apply({"params": p, "batch_stats": s}, x, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w)), upd["batch_stats"]

    tx = optax.chain(optax.add_decayed_weights(WD),
                     optax.sgd(lr, momentum=MOMENTUM))

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

    with x64():
        grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
        p, s = f64(params), f64(stats)
        opt = tx.init(p)
        first = None
        for _, x_j in batches:
            g, s = grad_fn(p, s, jnp.asarray(x_j, jnp.float64))
            first = g if first is None else first
            upd, opt = tx.update(g, opt, p)
            p = optax.apply_updates(p, upd)
        p, s, first = jax.tree.map(np.asarray, (p, s, first))
    return (net, _state64(params) | _state64(stats), _state64(first),
            _state64(p), _state64(s), w.transpose(0, 4, 1, 2, 3))


def _close_on_scale(got, want, floor, atol, key):
    scale = max(float(want.abs().max()), floor)
    assert scale > 0, key
    np.testing.assert_allclose((got / scale).numpy(), (want / scale).numpy(),
                               atol=atol, err_msg=key)


def _bitwise_zero(t: torch.Tensor) -> bool:
    return not t.detach().contiguous().view(torch.int64).any()


@pytest.mark.parametrize("bn_route", ["aten", "pallas"])
def test_three_sgd_steps_match_jax_in_float64(jax_run, bn_route,
                                              monkeypatch):
    net, start, grads_j, params_j, stats_j, w = jax_run
    if bn_route == "pallas":
        monkeypatch.setenv("DUALVAR_BN_STATS", "pallas")
    else:
        monkeypatch.delenv("DUALVAR_BN_STATS", raising=False)
    model, _ = select_backbone(net)
    model.double().train()
    model.load_state_dict(start)
    opt = torch.optim.SGD(model.parameters(), lr=NETS[net][1],
                          momentum=MOMENTUM, weight_decay=WD)
    w = torch.from_numpy(w)
    first = None
    for x_t, _ in _batches(net, 22):
        opt.zero_grad(set_to_none=True)
        (model(torch.from_numpy(x_t).double()) * w).sum().backward()
        if first is None:
            first = {n: p.grad.clone() for n, p in model.named_parameters()}
        opt.step()

    assert set(first) == set(grads_j)
    largest = max(float(g.abs().max()) for g in grads_j.values())
    for key, g in first.items():
        _close_on_scale(g, grads_j[key], GRAD_FLOOR * largest, 5e-6, key)
    state = model.state_dict()
    changes = {k: params_j[k] - start[k] for k in params_j}
    largest = max(float(c.abs().max()) for c in changes.values())
    for key, change in changes.items():
        _close_on_scale(state[key] - start[key], change,
                        GRAD_FLOOR * largest, 5e-6, key)
    for key, val in stats_j.items():
        np.testing.assert_allclose(state[key].numpy(), val.numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=key)

    blocks = pad_blocks(model)
    if net != "r21d_pad128":
        assert not blocks
        return
    # four entries for each of 11 of the 12 SpatioTemporalConvs: layer 4's
    # second conv has the formula width 1152, a multiple of 128 already
    assert len(blocks) == 4 * 11
    params = dict(model.named_parameters())
    for key, index in blocks.items():
        assert _bitwise_zero(state[key][index]), key
        if key in params:
            buf = opt.state[params[key]]["momentum_buffer"]
            assert _bitwise_zero(buf[index]), f"{key} momentum"
            assert _bitwise_zero(params_j[key][index]), f"{key} (JAX)"
