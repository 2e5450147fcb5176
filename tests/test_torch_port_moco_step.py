"""Two whole MoCo train steps (mode ``clip-sr-dtw``) of the port against the
JAX package, in float64 in both, with the gradients of each step; and
the ``SimCLRNaked`` forward.

Float64 because the JAX package's float32 backward on XLA:CPU is off by
percents at this size (PERF.md, Findings; tests/test_torch_port_slice.py
does the same). "Float64" is what the JAX package makes of it: its backbone
follows the parameters' type, while the pooled features, the heads, the
queues and the losses stay float32 whatever the mode. The port is put into
the same arrangement here (backbone in double, the rest as it is), so the
two agree to float32 rounding of the loss arithmetic, which pins the order
of the step: momentum update from the query parameters before the optimizer
moves them, key pass, losses on the old queues, enqueue, dual pass, SGD on
the query encoder only.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from dualvar_tpu.core.config import PRETRAIN_PRESETS as JAX_PRESETS
from dualvar_tpu.models.ssl import moco as JM
from dualvar_tpu.models.ssl.simclr import SimCLRNaked as JaxNaked
from dualvar_tpu.train.pretrain import make_optimizer as jax_make_optimizer
from dualvar_tpu.train.tasks import total_loss as jax_total_loss
from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS, ModelConfig
from dualvar_tpu_torch.core.convert import (from_jax_task_state,
                                            from_jax_variables)
from dualvar_tpu_torch.train.pretrain import make_optimizer
from dualvar_tpu_torch.train.tasks import make_task, total_loss

from torch_port_util import moco_numpy_state, numpy_variables

B, T, S, K = 4, 8, 32, 16
PRESET = "paper_table2_moco_r21d"
PERMS = np.array([[[1, 0], [0, 1], [1, 0], [1, 0]],
                  [[0, 1], [1, 0], [1, 0], [0, 1]]], np.int32)


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _blocks(n_views, n=2, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, B, n_views, T, S, S, 3))


def _jax_two_steps(params, stats, moco, blocks, cfg):
    """Two train steps of the JAX package in float64 -> per step (params,
    batch_stats, MoCoState, gradients), as numpy trees."""
    m = cfg.model
    encoder = JM.MoCoEncoder(network="r21d", dtype=jnp.float64)
    tx, _ = jax_make_optimizer(cfg, steps_per_epoch=10)

    @jax.jit
    def step(params, stats, moco, opt_state, block, perm):
        def loss_fn(p):
            ret, upd, new = JM.moco_timeseries_forward(
                encoder, {"params": p, "batch_stats": stats}, moco, block,
                m.moco_m, m.moco_t, m.aligned_T, mode="clip-sr-dtw",
                dtw_gamma=m.dtw_gamma, perm=perm, train=True)
            return jax_total_loss(ret), (upd["batch_stats"], new)

        (_, (stats, moco)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), stats, moco, opt_state,
                grads)

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

    out = []
    with _x64():
        params, stats = f64(params), f64(stats)
        moco = JM.MoCoState(
            params_k=f64(moco["params_k"]),
            batch_stats_k=f64(moco["batch_stats_k"]),
            queue=jnp.asarray(moco["queue"]),
            series_queue=jnp.asarray(moco["series_queue"]),
            ptr=jnp.asarray(moco["ptr"]))
        opt_state = tx.init(params)
        for block, perm in zip(blocks, PERMS):
            params, stats, moco, opt_state, grads = step(
                params, stats, moco, opt_state, jnp.asarray(block),
                jnp.asarray(perm))
            out.append(jax.tree.map(np.asarray, (params, stats, {
                f: getattr(moco, f) for f in (
                    "params_k", "batch_stats_k", "queue", "series_queue",
                    "ptr")}, grads)))
    return out


def test_two_train_steps_and_gradients_match_jax_in_float64():
    jcfg = JAX_PRESETS[PRESET]
    jcfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, moco_k=K, mode="clip-sr-dtw"))
    pcfg = PRETRAIN_PRESETS[PRESET]
    assert dataclasses.asdict(pcfg.optim) == dataclasses.asdict(jcfg.optim)
    # the second step wraps the pointer to 0
    params, stats, moco = moco_numpy_state(
        JM.MoCoEncoder(network="r21d"), jnp.zeros((B, T, S, S, 3)), K,
        seed=31, ptr=K - B)
    blocks = _blocks(3)
    steps_j = _jax_two_steps(params, stats, moco, blocks, jcfg)

    task = make_task(dataclasses.replace(
        pcfg.model, moco_k=K, mode="clip-sr-dtw", dtype="float32"))
    model = task.model
    model.load_state_dict(
        from_jax_task_state(params, stats, moco, module=model))
    model.train()
    model.encoder_q.backbone.double()
    model.encoder_k.backbone.double()
    optimizer, scheduler = make_optimizer(pcfg, task.parameters(), 10)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    # the JAX results pass through float32 on their way into the port's
    # layout (6e-8 relative), inside what the comparisons allow
    for i, (block, perm) in enumerate(zip(blocks, PERMS)):
        params_j, stats_j, moco_j, grads_j = steps_j[i]
        ret = task.forward(torch.from_numpy(block),
                           perm=torch.from_numpy(perm))
        optimizer.zero_grad(set_to_none=True)
        total_loss(ret).backward()

        # gradients of the query encoder, every tensor, on the scale of its
        # largest entry (measured: 1.2e-6 at the first step, 2.5e-6 at the
        # second, whose inputs already differ by the first step's float32
        # loss arithmetic); none on the key encoder
        want_grads = from_jax_variables(grads_j, {})
        named = dict(model.encoder_q.named_parameters())
        assert set(named) == set(want_grads)
        for key, p in named.items():
            want = want_grads[key].double().numpy()
            scale = np.abs(want).max()
            assert scale > 0, key
            np.testing.assert_allclose(p.grad.numpy() / scale, want / scale,
                                       atol=5e-6, err_msg=f"step {i} {key}")
        assert all(p.grad is None for p in model.encoder_k.parameters())

        optimizer.step()
        scheduler.step()

        # the whole state after the step: query and key parameters, BN
        # statistics of both, both queues, the pointer
        want_state = from_jax_task_state(params_j, stats_j, moco_j)
        got_state = model.state_dict()
        assert set(got_state) == set(want_state)
        assert int(got_state["queue_ptr"]) == int(want_state["queue_ptr"]) \
            == (i * B) % K
        for key, want in want_state.items():
            np.testing.assert_allclose(
                got_state[key].numpy(), want.double().numpy(), atol=1e-6,
                rtol=1e-6, err_msg=f"step {i} {key}")

    # the steps moved what they should have, and nothing else of the queue
    end = model.state_dict()
    for key in ("encoder_q.backbone.conv1.spatial_conv.weight",
                "encoder_q.series_head.fc2.weight",
                "encoder_k.backbone.conv1.spatial_conv.weight",
                "encoder_k.backbone.bn1.running_mean"):
        assert float((end[key] - start[key]).abs().max()) > 1e-5, key
    for name in ("queue", "series_queue"):
        changed = (end[name] != start[name]).any(dim=1).numpy()
        rows = np.arange(K)
        np.testing.assert_array_equal(changed, (rows < B) | (rows >= K - B))


def test_simclr_naked_forward_matches_jax():
    jm = JaxNaked(network="r21d")
    block = np.random.default_rng(3).normal(
        size=(B, 2, T, S, S, 3)).astype(np.float32)
    params, stats = numpy_variables(jm, jnp.zeros(block.shape), seed=41,
                                    train=True)
    ret_j, upd = jax.jit(lambda v, blk: jm.apply(
        v, blk, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, jnp.asarray(block))

    task = make_task(ModelConfig(model="simclr_naked", dtype="float32"))
    assert task.n_views == 2
    task.model.load_state_dict(
        from_jax_variables(params, stats, module=task.model))
    task.model.train()
    ret_t = task.forward(torch.from_numpy(block))
    assert set(ret_t) == set(ret_j) == {
        "clip_logits", "clip_labels", "clip_contrast_loss"}
    assert ret_t["clip_logits"].shape == (2 * B, 1 + 2 * B)
    for key, want in ret_j.items():
        # the backbone band of tests/test_torch_port_slice.py
        np.testing.assert_allclose(ret_t[key].detach().numpy(),
                                   np.asarray(want), atol=5e-4, rtol=1e-3,
                                   err_msg=key)
    want_state = from_jax_variables(
        params, jax.tree.map(np.asarray, upd["batch_stats"]))
    for key, got in task.model.state_dict().items():
        if "running_" in key:
            np.testing.assert_allclose(got.numpy(), want_state[key].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=key)
    total_loss(ret_t).backward()
    assert all(p.grad is not None for p in task.parameters())
