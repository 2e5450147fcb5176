"""MoCo's BN-shuffle mode (``moco_shuffle_bn`` > 0) across processes: two
gloo ranks with a batch of 4 each against the JAX package's grouped key pass
on the global batch of 8, in float64.

The reference shuffles the key batch across GPUs (``_batch_shuffle_ddp``,
SURVEY model/moco.py:128-173) so that each GPU's batch norm sees a random
subset; the JAX package computes that on the global batch
(``shuffled_key_encode``: permute, split into groups, encode each group
alone, unpermute, average the running statistics). The port's ranks gather
the key views, take the global permutation, encode their share of the
groups and gather the keys back (``models/ssl/moco.py``). With the JAX
package's own permutation (drawn from its key as its forward draws it) both
sides compute the same step: metrics, query gradients, both queues, the
pointer and the key encoder (its momentum update and running statistics)
are compared with the bands of ``tests/test_torch_port_moco_step.py`` and
``tests/test_torch_port_dist_step.py``, for MoCo-Naked and MoCo-TimeSeriesV4
at 2 and 4 groups. "Float64" is the JAX package's arrangement: the
backbones in float64, heads, queues and losses float32; the port takes the
same (``backbone.double()``).
"""

import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.models.ssl import moco as JM
from dualvar_tpu.train.pretrain import compute_metrics as jax_metrics
from dualvar_tpu.train.tasks import total_loss as jax_total_loss
from dualvar_tpu_torch.core.config import ModelConfig
from dualvar_tpu_torch.core.convert import (from_jax_task_state,
                                            from_jax_variables)
from dualvar_tpu_torch.train.tasks import make_task

from torch_port_util import launch_ranks, moco_numpy_state, x64

W, B, T, S, K = 2, 4, 4, 16, 16
N = W * B
M, TEMP, ALIGNED_T = 0.99, 0.07, 0.07
PTR = 4
SEED = 17
PERM = np.array([[1, 0], [0, 1], [1, 0], [1, 0],
                 [0, 1], [0, 1], [1, 0], [0, 1]], np.int32)
# R3D-18's batch norms
BATCH_NORMS = 12
CASES = {"naked_g2": ("moco_naked", 2), "naked_g4": ("moco_naked", 4),
         "tsv4_g2": ("moco_timeseriesv4", 2),
         "tsv4_g4": ("moco_timeseriesv4", 4)}


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jax_step(model, groups, params, stats, moco, block, rng):
    """The JAX package's forward with the grouped key pass on the global
    batch, and the gradient of its total loss, in float64 (the caller turns
    x64 on: it is a global flag, and the steps run in threads)."""
    naked = model == "moco_naked"
    encoder = JM.MoCoEncoder(network="r3d", with_series=not naked,
                             dtype=jnp.float64)

    def loss_fn(p):
        variables = {"params": p, "batch_stats": _f64(stats)}
        state = JM.MoCoState(
            params_k=_f64(moco["params_k"]),
            batch_stats_k=_f64(moco["batch_stats_k"]),
            queue=jnp.asarray(moco["queue"]),
            series_queue=None if naked else jnp.asarray(moco["series_queue"]),
            ptr=jnp.asarray(moco["ptr"]))
        if naked:
            ret, _, new = JM.moco_naked_forward(
                encoder, variables, state, block, M, TEMP, train=True,
                rng=rng, shuffle_bn_groups=groups)
        else:
            ret, _, new = JM.moco_timeseries_forward(
                encoder, variables, state, block, M, TEMP, ALIGNED_T,
                mode="clip-sr-tc", perm=jnp.asarray(PERM), rng=rng,
                train=True, shuffle_bn_groups=groups)
        return jax_total_loss(ret), (jax_metrics(ret), new)

    block = jnp.asarray(block)
    grads, (metrics, new) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        _f64(params))
    return jax.tree.map(np.asarray, (grads, metrics, {
        f: getattr(new, f) for f in ("params_k", "batch_stats_k", "queue",
                                     "series_queue", "ptr")}))


def _bn_perm(model, rng):
    """The batch permutation the JAX forward draws from ``rng``
    (``moco_timeseries_forward`` folds 7 in first)."""
    if model == "moco_timeseriesv4":
        rng = jax.random.fold_in(rng, 7)
    return np.asarray(jax.random.permutation(rng, N))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's two ranks and the four JAX steps, side by side: the JAX
    steps' compiles in threads (started first: they take longest), the
    ranks in their own processes. 2 and 4 groups of a model share their
    inputs."""
    made = {}
    for model in ("moco_naked", "moco_timeseriesv4"):
        naked = model == "moco_naked"
        i = int(naked)
        block = np.random.default_rng(SEED + i).normal(
            size=(N, 2 if naked else 3, T, S, S, 3))
        encoder = JM.MoCoEncoder(network="r3d", with_series=not naked)
        params, stats, moco = moco_numpy_state(
            encoder, jnp.zeros((N, T, S, S, 3)), K, seed=SEED + 10 * i,
            ptr=PTR)
        key = jax.random.PRNGKey(SEED + i)
        bn_perm = _bn_perm(model, key)
        assert sorted(bn_perm.tolist()) == list(range(N))
        made[model] = (params, stats, moco, block, key, bn_perm)
    directory = tmp_path_factory.mktemp("dist_shuffle_bn")
    with x64(), ThreadPoolExecutor(1 + len(CASES)) as pool:
        steps = {name: pool.submit(_jax_step, model, groups,
                                   *made[model][:5])
                 for name, (model, groups) in CASES.items()}
        inputs = {}
        for name, (model, groups) in CASES.items():
            params, stats, moco, block, _, bn_perm = made[model]
            port = make_task(ModelConfig(net="r3d", model=model, moco_k=K,
                                         dtype="float32")).model
            inputs[name] = {
                "model": model, "groups": groups,
                "state": from_jax_task_state(params, stats, moco,
                                             module=port),
                "block": torch.from_numpy(block),
                "perm": (None if model == "moco_naked"
                         else torch.from_numpy(PERM).long()),
                "bn_perm": torch.from_numpy(bn_perm.copy())}
        ranks = pool.submit(launch_ranks, "shuffle_bn", {
            "cases": inputs, "moco_k": K, "moco_m": M, "rows": B,
            "seed": SEED}, directory)
        want = {name: made[model][:2] + steps[name].result()
                for name, (model, _) in CASES.items()}
        outs = ranks.result()
    shutil.rmtree(directory, ignore_errors=True)
    return want, outs


@pytest.mark.parametrize("name", list(CASES))
def test_two_processes_equal_the_grouped_key_pass_of_jax(runs, name):
    want_all, outs = runs
    params, stats, grads_j, metrics_j, moco_j = want_all[name]
    want_state = from_jax_task_state(params, stats, moco_j)
    want_grads = from_jax_variables(grads_j, {})
    assert int(want_state["queue_ptr"]) == (PTR + N) % K
    for rank, out in enumerate(outs):
        got = out[name]
        assert set(got["metrics"]) == set(metrics_j)
        for key, w in metrics_j.items():
            np.testing.assert_allclose(float(got["metrics"][key]), float(w),
                                       atol=2e-5, rtol=1e-5,
                                       err_msg=f"rank {rank} {key}")
    # one state and one gradient: every rank enqueued the global keys,
    # averaged the running statistics of every group and the gradients
    got, other = outs[0][name], outs[1][name]
    for part in ("state", "grads"):
        assert set(got[part]) == set(other[part])
        for key, val in got[part].items():
            assert torch.equal(val, other[part][key]), (part, key)
    assert int(got["state"]["queue_ptr"]) == (PTR + N) % K
    assert set(got["state"]) <= set(want_state)
    for key, val in got["state"].items():
        np.testing.assert_allclose(
            val.double().numpy(), want_state[key].double().numpy(),
            atol=1e-6, rtol=1e-6, err_msg=key)
    assert set(got["grads"]) == set(want_grads)
    for key, w in want_grads.items():
        w = w.double().numpy()
        scale = np.abs(w).max()
        assert scale > 0, key
        np.testing.assert_allclose(got["grads"][key].double().numpy() / scale,
                                   w / scale, atol=5e-6, err_msg=key)
    # collectives of the step: the query encoder's synced batch norms (a
    # gather forward, an all-reduce backward; TimeSeriesV4's dual pass
    # twice as many); the key pass's gather of the views, one all-reduce of
    # the running statistics' sums (the float64 backbone's: the heads have
    # none) and the gather of the keys; the enqueue's gather; the gradient
    # (float64 backbone, float32 heads: two buckets). The permutation was
    # given: no broadcast.
    bn = BATCH_NORMS * (1 if name.startswith("naked") else 2)
    assert outs[0][name]["collectives"] == {"all_gather": bn + 3,
                                            "all_reduce": bn + 1 + 2}


def test_shuffle_mode_is_live_and_groups_differ(runs):
    """On the same inputs and permutation 2 and 4 groups give other keys
    (the batch norms see other batches), so the comparison above tells the
    group split apart."""
    want_all, _ = runs
    for model in ("naked", "tsv4"):
        q2 = want_all[f"{model}_g2"][4]["queue"]
        q4 = want_all[f"{model}_g4"][4]["queue"]
        rows = slice(PTR, PTR + N)
        assert not np.allclose(q2[rows], q4[rows], atol=1e-3), model


def test_rank_zero_draws_the_permutation_and_groups_must_be_shared(runs):
    """Without a given permutation rank 0 draws it from its generator (the
    generators are seeded ``seed + rank``) and broadcasts it: every rank
    holds the permutation one process would draw. A number of groups that
    is not a multiple of the world size raises on every rank."""
    _, outs = runs
    one_process = torch.randperm(N, generator=torch.Generator().manual_seed(
        SEED))
    for out in outs:
        assert torch.equal(out["drawn_bn_perm"], one_process)
        assert "multiple of the world size" in out["refused"]
