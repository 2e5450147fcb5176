"""The eighth slice as a whole: two gloo processes with a batch of 2 each
run the JAX package's step on the global batch of 4, in float64.

SimCLR-TimeSeriesV4 (``clip-sr-tc``, R3D-18 at 4x16x16) on both batch-norm
routes — ATen's (under a process group ``models/layers.py:_SyncBN``,
SyncBatchNorm's arithmetic) and the one-pass route (its sums through
``channel_sums``' plain version, added over the processes): every rank's
logits are the JAX logits' rows of its clips, the logged metrics (means
over the processes) the JAX metrics, every parameter's gradient (averaged
over the processes) the JAX gradient, the running statistics the JAX ones.
MoCo-TimeSeriesV4: after one forward the queues, the pointer (moved by
the global 4) and the key encoder (momentum update, batch norms over the
global batch) equal the JAX package's, and so do the metrics.

The JAX step runs jitted on the global batch sharded over 2 of the
conftest's virtual devices; the random decisions (the segment
permutation) are explicit arrays on both sides (ROADMAP.md, C.4). "Float64"
is the JAX package's arrangement: the backbone in float64, the pooled
features, heads, queues and losses float32; the port takes the same
(``backbone.double()``), as ``tests/test_torch_port_r3d_step.py`` does,
and the same tolerances.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dualvar_tpu.models.ssl import moco as JM
from dualvar_tpu.models.ssl.simclr import SimCLRTimeSeriesV4 as JaxTSV4
from dualvar_tpu.train.pretrain import compute_metrics as jax_metrics
from dualvar_tpu.train.tasks import total_loss as jax_total_loss
from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS, ModelConfig
from dualvar_tpu_torch.core.convert import (from_jax_task_state,
                                            from_jax_variables)
from dualvar_tpu_torch.train.tasks import make_task

from torch_port_util import (launch_ranks, moco_numpy_state,
                             numpy_variables, x64)

W, B, T, S, K = 2, 2, 4, 16, 8
N = W * B
PERM = np.array([[1, 0], [0, 1], [0, 1], [1, 0]], np.int64)
# R3D-18's batch norms
BATCH_NORMS = 12


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _sharded(x):
    """``x`` with its leading axis over 2 of the virtual devices."""
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    return jax.device_put(x, NamedSharding(mesh, P("data")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's SimCLR step and MoCo forward on the global batch,
    and the port's two processes on the same weights and decisions."""
    rng = np.random.default_rng(61)
    block = rng.normal(size=(N, 3, T, S, S, 3))
    moco_block = rng.normal(size=(N, 3, T, S, S, 3))
    params, stats = numpy_variables(
        JaxTSV4(network="r3d"), jnp.zeros((N, 3, T, S, S, 3)), seed=62,
        train=True)
    encoder = JM.MoCoEncoder(network="r3d")
    mparams, mstats, moco = moco_numpy_state(
        encoder, jnp.zeros((N, T, S, S, 3)), K, seed=63, ptr=4)
    m = PRETRAIN_PRESETS["paper_table2_moco_r21d"].model
    simclr = JaxTSV4(network="r3d", dtype=jnp.float64)
    encoder64 = JM.MoCoEncoder(network="r3d", dtype=jnp.float64)

    def loss_fn(p, s, x, perm):
        ret, upd = simclr.apply({"params": p, "batch_stats": s}, x,
                                perm=perm, train=True,
                                mutable=["batch_stats"])
        return jax_total_loss(ret), (ret, upd["batch_stats"])

    def moco_fwd(p, s, state, x, perm):
        ret, upd, new = JM.moco_timeseries_forward(
            encoder64, {"params": p, "batch_stats": s}, state, x, m.moco_m,
            m.moco_t, m.aligned_T, mode="clip-sr-tc", perm=perm, train=True)
        return jax_metrics(ret), upd["batch_stats"], new

    with x64():
        grads, (ret, new_stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            _f64(params), _f64(stats), _sharded(jnp.asarray(block)),
            _sharded(jnp.asarray(PERM, jnp.int32)))
        state = JM.MoCoState(
            params_k=_f64(moco["params_k"]),
            batch_stats_k=_f64(moco["batch_stats_k"]),
            queue=jnp.asarray(moco["queue"]),
            series_queue=jnp.asarray(moco["series_queue"]),
            ptr=jnp.asarray(moco["ptr"]))
        mmetrics, _, new = jax.jit(moco_fwd)(
            _f64(mparams), _f64(mstats), state,
            _sharded(jnp.asarray(moco_block)),
            _sharded(jnp.asarray(PERM, jnp.int32)))
        jax_out = _numpy({"ret": ret, "stats": new_stats, "grads": grads,
                          "metrics": jax_metrics(ret),
                          "moco_metrics": mmetrics,
                          "moco": {f: getattr(new, f) for f in (
                              "params_k", "batch_stats_k", "queue",
                              "series_queue", "ptr")}})

    port = make_task(ModelConfig(net="r3d", dtype="float32")).model
    mport = make_task(dataclasses.replace(
        m, net="r3d", dtype="float32", moco_k=K)).model
    inputs = {"state": from_jax_variables(params, stats, module=port),
              "moco_state": from_jax_task_state(mparams, mstats, moco,
                                                module=mport),
              "block": torch.from_numpy(block),
              "moco_block": torch.from_numpy(moco_block),
              "perm": torch.from_numpy(PERM), "moco_k": K}
    directory = tmp_path_factory.mktemp("dist_step")
    outs = launch_ranks("step", inputs, directory)
    # the ranks' outputs are loaded: their files (about 0.85 GB) go now,
    # not with pytest's basetemp three runs later
    shutil.rmtree(directory, ignore_errors=True)
    return params, mparams, mstats, jax_out, outs


def _rows(key, rank):
    """The rows of the JAX package's global logits that are ``rank``'s."""
    if "margin" in key:  # 2*n_series rows a clip
        per = 4
        return np.arange(rank * B * per, (rank + 1) * B * per)
    return np.r_[rank * B:(rank + 1) * B, N + rank * B:N + (rank + 1) * B]


@pytest.mark.parametrize("bn_stats", ["xla", "pallas"])
def test_two_processes_equal_the_global_step_of_jax(runs, bn_stats):
    params, _, _, want, outs = runs
    want_grads = from_jax_variables(want["grads"], {})
    want_state = from_jax_variables(params, want["stats"])
    for rank, out in enumerate(outs):
        got = out[bn_stats]
        assert set(got["ret"]) == set(want["ret"])
        for key, w in want["ret"].items():
            if key.endswith("logits"):
                # float32 heads and losses on float64 features
                np.testing.assert_allclose(
                    got["ret"][key].numpy(), w[_rows(key, rank)],
                    atol=2e-5, rtol=1e-5, err_msg=f"rank {rank} {key}")
        assert set(got["metrics"]) == set(want["metrics"])
        for key, w in want["metrics"].items():
            np.testing.assert_allclose(float(got["metrics"][key]), float(w),
                                       atol=2e-5, rtol=1e-5,
                                       err_msg=f"rank {rank} {key}")
        for key, w in want_state.items():
            if "running_" in key:
                np.testing.assert_allclose(
                    got["stats"][key].numpy(), w.numpy(), atol=1e-6,
                    rtol=1e-6, err_msg=f"rank {rank} {key}")
        assert set(got["grads"]) == set(want_grads)
        for key, w in want_grads.items():
            w = w.double().numpy()
            scale = np.abs(w).max()
            assert scale > 0, key
            np.testing.assert_allclose(
                got["grads"][key].numpy() / scale, w / scale, atol=5e-6,
                err_msg=f"rank {rank} {key}")
    # the ranks' averaged gradients are one gradient
    for key, g in outs[0][bn_stats]["grads"].items():
        assert torch.equal(g, outs[1][bn_stats]["grads"][key]), key
    # collectives of the step: the batch norms' (forward and backward, two
    # backbone passes: 3B views, then B shuffled clips), the two gathered
    # losses' (a gather forward, an all-reduce backward), the gradient
    # (float64 backbone, float32 heads: two buckets), the metrics
    bn = 2 * BATCH_NORMS
    want_counts = ({"all_reduce": 2 * bn + 2 + 2 + 1, "all_gather": 2}
                   if bn_stats == "pallas" else
                   {"all_reduce": bn + 2 + 2 + 1, "all_gather": bn + 2})
    assert outs[0][bn_stats]["collectives"] == want_counts


def test_moco_queue_and_pointer_equal_the_global_step_of_jax(runs):
    _, mparams, mstats, want, outs = runs
    want_state = from_jax_task_state(mparams, mstats, want["moco"])
    assert int(want_state["queue_ptr"]) == (4 + N) % K == 0
    for rank, out in enumerate(outs):
        got = out["moco"]
        assert int(got["state"]["queue_ptr"]) == 0, rank
        for key, val in got["state"].items():
            np.testing.assert_allclose(
                val.double().numpy(), want_state[key].double().numpy(),
                atol=1e-6, rtol=1e-6, err_msg=f"rank {rank} {key}")
        for key, w in want["moco_metrics"].items():
            np.testing.assert_allclose(float(got["metrics"][key]), float(w),
                                       atol=2e-5, rtol=1e-5,
                                       err_msg=f"rank {rank} {key}")
    # every rank enqueued the global batch's keys: the queues are one
    for key in ("queue", "series_queue"):
        assert torch.equal(outs[0]["moco"]["state"][key],
                           outs[1]["moco"]["state"][key])
