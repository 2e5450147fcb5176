"""The port's MoCo models (dualvar_tpu_torch.models.ssl.moco) against the JAX
package on the CPU: one train-mode forward of each model at B=4, T=8, 32x32,
K=16 on r21d, with everything the forward changes — the losses and logits,
the key encoder after its momentum update, both queues and the pointer, the
BN running statistics of both encoders.

Weights and MoCo state are numpy-made and carried over with
``from_jax_task_state``; both sides get the same block, the same segment
permutation and, in the BN-shuffle mode, the same batch permutation. Mode
``clip-sr-dtw`` runs the plain soft-DTW recurrences on both sides (XLA in the
JAX package, ``soft_dtw_plain``'s in the port).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.models.ssl import moco as JM
from dualvar_tpu_torch.core.convert import (from_jax_task_state,
                                            from_jax_variables)
from dualvar_tpu_torch.models.ssl.moco import (MoCo, dequeue_and_enqueue,
                                               momentum_update)

from torch_port_util import moco_numpy_state

B, T, S, K = 4, 8, 32, 16
PTR = 4
M, TEMP, ALIGNED_T, GAMMA = 0.99, 0.07, 0.11, 0.1
PERM = np.array([[1, 0], [0, 1], [1, 0], [1, 0]], np.int32)

# float32 through 18 conv + BN layers whose deepest BNs normalise over a
# handful of values a channel, then cosine / 0.07: the band of
# tests/test_torch_port_slice.py
ATOL, RTOL = 5e-4, 1e-3


def _block(n_views, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, n_views, T, S, S, 3)).astype(np.float32)


def _jax_encoder(naked):
    return JM.MoCoEncoder(network="r21d", with_series=not naked)


@functools.lru_cache(maxsize=None)
def _state(naked):
    return moco_numpy_state(_jax_encoder(naked),
                            jnp.zeros((B, T, S, S, 3)), K, seed=21, ptr=PTR)


def _jax_moco_state(moco):
    return JM.MoCoState(**{k: None if v is None else jax.tree.map(
        jnp.asarray, v) for k, v in moco.items()})


def _jax_forward(naked, mode="clip-sr-tc", packed=False, groups=0, rng=None):
    """One train-mode forward of the JAX package -> (ret, new query
    batch_stats, new MoCoState), as numpy trees."""
    params, stats, moco = _state(naked)
    encoder = _jax_encoder(naked)
    variables = {"params": params, "batch_stats": stats}
    block = jnp.asarray(_block(2 if naked else 3))

    if naked:
        fn = jax.jit(lambda v, st, blk, key: JM.moco_naked_forward(
            encoder, v, st, blk, M, TEMP, train=True, rng=key,
            shuffle_bn_groups=groups))
    else:
        fn = jax.jit(lambda v, st, blk, key: JM.moco_timeseries_forward(
            encoder, v, st, blk, M, TEMP, ALIGNED_T, mode=mode,
            dtw_gamma=GAMMA, perm=jnp.asarray(PERM), rng=key, train=True,
            shuffle_bn_groups=groups, packed_encode=packed))
    key = jax.random.PRNGKey(0) if rng is None else rng
    ret, upd, new = fn(variables, _jax_moco_state(moco), block, key)
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(ret), to_np(upd["batch_stats"]), new


def _port_model(naked, mode="clip-sr-tc", packed=False, groups=0):
    params, stats, moco = _state(naked)
    model = MoCo(network="r21d", K=K, m=M, temperature=TEMP,
                 aligned_T=ALIGNED_T, mode=mode, dtw_gamma=GAMMA, naked=naked,
                 shuffle_bn_groups=groups, packed_encode=packed)
    model.load_state_dict(
        from_jax_task_state(params, stats, moco, module=model))
    return model.train()


def _compare_forward(model, ret_t, ret_j, stats_j, new_j):
    """Everything one train-mode forward returns and changes."""
    params, stats, moco = _state(model.naked)
    assert set(ret_t) == set(ret_j)
    for key, want in ret_j.items():
        got = ret_t[key].detach().numpy()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=key)

    new = {f: None if getattr(new_j, f) is None else jax.tree.map(
        np.asarray, getattr(new_j, f))
        for f in ("params_k", "batch_stats_k", "queue", "series_queue",
                  "ptr")}
    want_state = from_jax_task_state(params, stats_j, new)
    got_state = model.state_dict()
    assert set(got_state) == set(want_state)

    # the pointer, and exactly the rows [PTR, PTR + B) of each queue written
    assert int(got_state["queue_ptr"]) == int(new["ptr"]) == PTR + B
    for name in ("queue",) if model.naked else ("queue", "series_queue"):
        got, old = got_state[name].numpy(), moco[name]
        changed = (got != old).any(axis=1)
        np.testing.assert_array_equal(
            changed, (np.arange(K) >= PTR) & (np.arange(K) < PTR + B))
        # entries of unit vectors out of the key encoder (measured: 7e-6)
        np.testing.assert_allclose(got, want_state[name].numpy(), atol=1e-5,
                                   err_msg=name)

    for key, want in want_state.items():
        got = got_state[key].numpy()
        if "running_" in key:
            # both encoders' BN statistics after their train-mode passes
            np.testing.assert_allclose(got, want.numpy(), atol=2e-4,
                                       rtol=2e-4, err_msg=key)
        elif key.startswith("encoder_k."):
            # the momentum update: float32 rounding of m*k + (1-m)*q
            np.testing.assert_allclose(got, want.numpy(), atol=1e-6,
                                       err_msg=key)
        elif key.startswith("encoder_q."):
            np.testing.assert_array_equal(got, want.numpy(), err_msg=key)


@pytest.mark.parametrize("packed", [False, True], ids=["two-pass", "packed"])
@pytest.mark.parametrize("mode", ["clip-sr-tc", "clip-sr-dtw"])
def test_timeseries_forward_matches_jax(mode, packed):
    ret_j, stats_j, new_j = _jax_forward(False, mode, packed)
    model = _port_model(False, mode, packed)
    ret_t = model(torch.from_numpy(_block(3)), perm=torch.from_numpy(PERM))
    assert sorted(k for k in ret_t if k.endswith("loss")) == [
        "aug_ranking_margin_contrast_loss", "clip_contrast_loss",
        "tc_contrast_loss", "unaug_ranking_margin_contrast_loss"]
    assert ret_t["clip_logits"].shape == ret_t["tc_logits"].shape == (
        B, 1 + K)
    _compare_forward(model, ret_t, ret_j, stats_j, new_j)
    # the key encoder moved, by the momentum update alone
    start = _port_model(False).state_dict()
    moved = model.state_dict()
    key = "encoder_k.backbone.conv1.spatial_conv.weight"
    assert float((moved[key] - start[key]).abs().max()) > 1e-5


def test_naked_forward_matches_jax():
    ret_j, stats_j, new_j = _jax_forward(True)
    model = _port_model(True)
    assert not hasattr(model, "series_queue")
    assert not hasattr(model.encoder_q, "series_head")
    ret_t = model(torch.from_numpy(_block(2)))
    assert set(ret_t) == {"clip_logits", "clip_labels", "clip_contrast_loss"}
    _compare_forward(model, ret_t, ret_j, stats_j, new_j)


def test_bn_shuffle_mode_matches_jax_with_its_batch_permutation():
    """``moco_shuffle_bn``: the key batch permuted and encoded in two groups,
    each from the same running statistics, their mean kept. The batch
    permutation is the one the JAX package draws from its key."""
    rng = jax.random.PRNGKey(5)
    bn_perm = np.asarray(jax.random.permutation(jax.random.fold_in(rng, 7), B))
    assert sorted(bn_perm.tolist()) == list(range(B))
    ret_j, stats_j, new_j = _jax_forward(False, "clip-sr-dtw", groups=2,
                                         rng=rng)
    model = _port_model(False, "clip-sr-dtw", groups=2)
    ret_t = model(torch.from_numpy(_block(3)), perm=torch.from_numpy(PERM),
                  bn_perm=torch.from_numpy(bn_perm.copy()))
    _compare_forward(model, ret_t, ret_j, stats_j, new_j)
    # the mode is live: whole-batch BN gives other keys
    plain = _port_model(False, "clip-sr-dtw")
    plain(torch.from_numpy(_block(3)), perm=torch.from_numpy(PERM))
    assert float((plain.queue - model.queue).abs().max()) > 1e-4
    # without a given permutation one is drawn from the generator
    drawn = _port_model(False, "clip-sr-dtw", groups=2)
    drawn(torch.from_numpy(_block(3)),
          generator=torch.Generator().manual_seed(0))
    assert int(drawn.queue_ptr) == PTR + B


def test_loss_sees_the_queue_before_this_steps_keys_and_backward_works():
    model = _port_model(False, "clip-sr-dtw")
    old_queue = model.queue.clone()
    ret = model(torch.from_numpy(_block(3)), perm=torch.from_numpy(PERM))
    # logits column 1 + j is q . queue[j] / T for the OLD queue, also for
    # the rows this step has overwritten
    q_dot = ret["clip_logits"][:, 1 + PTR:1 + PTR + B].detach() * TEMP
    assert float(q_dot.abs().max()) <= 1.0 + 1e-5
    assert not torch.equal(model.queue[PTR:PTR + B], old_queue[PTR:PTR + B])
    # the in-place enqueue must not break the backward of q
    sum(v for k, v in ret.items() if k.endswith("loss")).backward()
    grads_q = [p.grad for p in model.encoder_q.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads_q)
    assert float(grads_q[0].abs().max()) > 0
    # the key encoder takes no gradient
    assert all(p.grad is None and not p.requires_grad
               for p in model.encoder_k.parameters())


def test_eval_mode_forward_changes_no_state():
    model = _port_model(False, "clip-sr-dtw").eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        ret = model(torch.from_numpy(_block(3)), perm=torch.from_numpy(PERM))
    assert all(torch.isfinite(v).all() for v in ret.values())
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_momentum_update_and_ring_buffer():
    lin_q, lin_k = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    want = [0.9 * k.detach() + 0.1 * q.detach()
            for q, k in zip(lin_q.parameters(), lin_k.parameters())]
    momentum_update(lin_q, lin_k, 0.9)
    for got, w in zip(lin_k.parameters(), want):
        np.testing.assert_allclose(got.detach().numpy(), w.numpy(),
                                   atol=1e-7)
    queue, ptr = torch.zeros(6, 2), torch.tensor(4)
    dequeue_and_enqueue(queue, ptr, torch.ones(2, 2))
    assert queue.sum(dim=1).tolist() == [0, 0, 0, 0, 2, 2]
    with pytest.raises(ValueError, match="divisible"):
        dequeue_and_enqueue(queue, ptr, torch.ones(4, 2))
    # the model's pointer wraps at K
    model = _port_model(True)
    model.queue_ptr.fill_(K - B)
    model.enqueue(torch.ones(B, 128), None)
    assert int(model.queue_ptr) == 0
    assert float(model.queue[K - B:].min()) == 1.0


def test_queues_are_drawn_from_the_generator_and_unit_norm():
    def build(seed):
        return MoCo(K=K, generator=torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    assert torch.equal(a.queue, b.queue)
    assert torch.equal(a.series_queue, b.series_queue)
    assert not torch.equal(a.queue, c.queue)
    np.testing.assert_allclose(a.queue.norm(dim=1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(
        a.series_queue.reshape(K, 2, 64).norm(dim=-1).numpy(), 1.0, atol=1e-6)
    assert int(a.queue_ptr) == 0 and a.queue_ptr.dtype == torch.long
    # the key encoder starts as a copy of the query encoder
    for (name, q), k in zip(a.encoder_q.state_dict().items(),
                            a.encoder_k.state_dict().values()):
        assert torch.equal(q, k), name


def test_from_jax_task_state_fills_every_key_and_checks_shapes():
    params, stats, moco = _state(False)
    model = _port_model(False)
    state = from_jax_task_state(params, stats, moco, module=model)
    assert set(state) == set(model.state_dict())
    n_leaves = 2 * (len(jax.tree.leaves(params))
                    + len(jax.tree.leaves(stats))) + 3
    assert len(state) == n_leaves  # every leaf consumed into its own key
    assert state["queue_ptr"].dtype == torch.long
    assert int(state["queue_ptr"]) == PTR
    np.testing.assert_array_equal(state["series_queue"].numpy(),
                                  moco["series_queue"])
    q_only = from_jax_variables(params, stats)
    assert all(torch.equal(state["encoder_q." + k], v)
               for k, v in q_only.items())
    key = "encoder_k.clip_head.fc1.weight"
    np.testing.assert_array_equal(
        state[key].numpy(), moco["params_k"]["clip_head"]["fc1"]["kernel"].T)
    with pytest.raises(ValueError, match="queue"):
        from_jax_task_state(params, stats, {**moco, "queue": moco["queue"][:8]},
                            module=model)
    with pytest.raises(KeyError, match="unfilled"):
        from_jax_task_state(params, stats, {**moco, "series_queue": None},
                            module=model)
    with pytest.raises(KeyError, match="unknown"):
        from_jax_task_state(params, stats, {**moco, "step": 3}, module=model)
