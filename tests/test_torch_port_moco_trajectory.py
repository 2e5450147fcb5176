"""A 20-step MoCo-TimeSeriesV4 trajectory of the port against the JAX
package, both in float64, in the manner of
tests/test_trajectory_parity.py:218 (``test_moco_tsv4_trajectory_parity``).

The port trains for 20 steps with its own optimizer (the preset's SGD with
momentum and weight decay). Before every step its current query encoder's
parameters are carried into the JAX package, whose ``moco_timeseries_forward``
runs the same step on the same block and segment permutation; every loss of
every step, and every fifth step the whole query gradient, must agree.
Meanwhile each package threads its own auxiliary state through all 20 steps:
the query encoder's batch-norm running statistics, the EMA key encoder (its
parameters and running statistics), both queues and the pointer (K=8 at
B=2: five wraps). At the end they must agree too. A slip in the threading
(the EMA at the wrong point, the enqueue before the loss, a wrong batch-norm
momentum, the pointer) compounds over the steps; float64 keeps the
arithmetic's own difference far below that (ROADMAP.md C.1: the JAX
package's float32 trajectory tests sit inside their float32 spread).
"Float64" is the JAX package's arrangement: the backbones in float64,
pooled features, heads, queues and losses float32; the port takes the same
(``backbone.double()``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from dualvar_tpu.models.ssl import moco as JM
from dualvar_tpu.train.tasks import total_loss as jax_total_loss
from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS
from dualvar_tpu_torch.core.convert import (_convert_leaf,
                                            from_jax_task_state,
                                            from_jax_variables)
from dualvar_tpu_torch.train.pretrain import make_optimizer
from dualvar_tpu_torch.train.tasks import make_task, total_loss

from torch_port_util import moco_numpy_state, x64

STEPS, B, T, S, K = 20, 2, 4, 16, 8
PRESET = "paper_table2_moco_r21d"
MODE = "clip-sr-tc"
GRAD_EVERY = 5
# losses and metrics: float32 heads and losses on float64 backbones (the
# band of tests/test_torch_port_dist_step.py); gradients on the scale of
# each tensor's largest entry and the state after the steps, the bands of
# tests/test_torch_port_moco_step.py
LOSS_ATOL, LOSS_RTOL = 2e-5, 1e-5
GRAD_ATOL = 5e-6
STATE_ATOL = STATE_RTOL = 1e-6


def _to_jax(template, state, prefix):
    """The port's tensors under ``prefix`` as a float64 flax tree shaped as
    ``template``: the inverse of ``core/convert.py``'s leaf mapping."""
    flat = {}
    for path, leaf in flatten_dict(template).items():
        key, _ = _convert_leaf(path, np.asarray(leaf))
        value = state[prefix + key].detach().double().numpy()
        if path[-1] == "kernel" and value.ndim == 5:
            value = value.transpose(2, 3, 4, 1, 0)
        elif path[-1] == "kernel":
            value = value.T
        flat[path] = jnp.asarray(value)
    return unflatten_dict(flat)


def _data(seed):
    rng = np.random.default_rng(seed)
    blocks = rng.normal(size=(STEPS, B, 3, T, S, S, 3))
    perms = np.stack([[rng.permutation(2) for _ in range(B)]
                      for _ in range(STEPS)]).astype(np.int32)
    return blocks, perms


def test_moco_tsv4_twenty_step_trajectory_matches_jax_in_float64():
    pcfg = PRETRAIN_PRESETS[PRESET]
    m = dataclasses.replace(pcfg.model, net="r3d", moco_k=K, mode=MODE,
                            dtype="float32")
    params0, stats0, moco0 = moco_numpy_state(
        JM.MoCoEncoder(network="r3d"), jnp.zeros((B, T, S, S, 3)), K,
        seed=51, ptr=0)
    blocks, perms = _data(52)

    task = make_task(m)
    model = task.model
    model.load_state_dict(from_jax_task_state(params0, stats0, moco0,
                                              module=model))
    model.train()
    model.encoder_q.backbone.double()
    model.encoder_k.backbone.double()
    optimizer, scheduler = make_optimizer(pcfg, task.parameters(), 1000)

    encoder = JM.MoCoEncoder(network="r3d", dtype=jnp.float64)

    def step(params, stats, mstate, block, perm):
        def loss_fn(p):
            ret, upd, new = JM.moco_timeseries_forward(
                encoder, {"params": p, "batch_stats": stats}, mstate, block,
                m.moco_m, m.moco_t, m.aligned_T, mode=MODE, perm=perm,
                train=True)
            losses = {k: v for k, v in ret.items() if k.endswith("_loss")}
            return jax_total_loss(ret), (losses, upd["batch_stats"], new)

        (_, (losses, stats, mstate)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return losses, stats, mstate, grads

    curve = []
    with x64():
        f64 = lambda tree: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), tree)
        step = jax.jit(step)
        stats = f64(stats0)
        mstate = JM.MoCoState(
            params_k=f64(moco0["params_k"]),
            batch_stats_k=f64(moco0["batch_stats_k"]),
            queue=jnp.asarray(moco0["queue"]),
            series_queue=jnp.asarray(moco0["series_queue"]),
            ptr=jnp.asarray(moco0["ptr"]))
        for s in range(STEPS):
            # the query side comes from the port's trajectory; everything
            # else each package threads on its own
            params = _to_jax(params0, model.state_dict(), "encoder_q.")
            losses, stats, mstate, grads = step(
                params, stats, mstate, jnp.asarray(blocks[s]),
                jnp.asarray(perms[s]))
            ret = task.forward(torch.from_numpy(blocks[s]),
                               perm=torch.from_numpy(perms[s]).long())
            optimizer.zero_grad(set_to_none=True)
            loss = total_loss(ret)
            loss.backward()
            assert set(losses) == {k for k in ret if k.endswith("_loss")}
            for key, want in losses.items():
                np.testing.assert_allclose(
                    float(ret[key].detach()), float(want), atol=LOSS_ATOL,
                    rtol=LOSS_RTOL, err_msg=f"step {s} {key}")
            if s % GRAD_EVERY == 0 or s == STEPS - 1:
                want_grads = from_jax_variables(
                    jax.tree.map(np.asarray, grads), {})
                named = dict(model.encoder_q.named_parameters())
                assert set(named) == set(want_grads)
                for key, p in named.items():
                    want = want_grads[key].double().numpy()
                    scale = np.abs(want).max()
                    np.testing.assert_allclose(
                        p.grad.double().numpy() / scale, want / scale,
                        atol=GRAD_ATOL, err_msg=f"step {s} {key}")
            optimizer.step()
            scheduler.step()
            curve.append(float(loss.detach()))
        end_j = jax.tree.map(np.asarray, (stats, {
            f: getattr(mstate, f) for f in ("params_k", "batch_stats_k",
                                            "queue", "series_queue",
                                            "ptr")}))

    # the trajectory trained: the losses moved
    assert np.std(curve) > 1e-3, curve
    # the auxiliary state after 20 steps, each package's own: the query
    # encoder's running statistics, the EMA key encoder, the queues and the
    # pointer (five wraps of K=8 at B=2)
    got = model.state_dict()
    want = from_jax_task_state(params0, end_j[0], end_j[1])
    assert int(got["queue_ptr"]) == int(want["queue_ptr"]) == STEPS * B % K
    start = from_jax_task_state(params0, stats0, moco0)
    for key, val in got.items():
        if key.startswith("encoder_q.") and "running_" not in key:
            continue  # the query parameters: the port's, carried over
        np.testing.assert_allclose(
            val.double().numpy(), want[key].double().numpy(),
            atol=STATE_ATOL, rtol=STATE_RTOL, err_msg=key)
    # the auxiliary state moved: EMA, running statistics, every queue row
    for key in ("encoder_k.backbone.conv1.weight",
                "encoder_k.backbone.bn1.running_mean",
                "encoder_q.backbone.bn1.running_var"):
        assert float((got[key].double() - start[key].double()).abs().max()
                     ) > 1e-6, key
    for key in ("queue", "series_queue"):
        assert bool((got[key] != start[key]).any(dim=1).all()), key
