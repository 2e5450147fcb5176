"""``dualvar_tpu_torch/core/dist.py``: the launch-environment rules of
``init_distributed`` (the port of ``tests/test_multihost.py``'s patterns
for ``dualvar_tpu/core/mesh.py:init_distributed``), and the gathered
NT-Xent's gradient under two gloo processes.

The JAX package decides from a scheduler's variables whether to join a
cluster; the port reads torchrun's only. Its rules: no launch variable, one
process; any of them, a launch, which must be whole and valid and whose
rendezvous must succeed, or the call raises; on the card NCCL or nothing.
"""

import datetime

import numpy as np
import pytest
import torch

from dualvar_tpu_torch.core import dist
from dualvar_tpu_torch.models.ssl.losses import _nt_xent_from_sim, nt_xent_loss

from torch_port_util import launch_ranks

LAUNCH = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for k in LAUNCH + ("TPU_WORKER_HOSTNAMES", "SLURM_STEP_NODELIST"):
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    dist.destroy()


def test_without_launch_variables_one_process(clean_env):
    assert dist.init_distributed("cpu") is False
    assert not dist.active()
    assert (dist.rank(), dist.world_size(), dist.is_main()) == (0, 1, True)


def test_scheduler_hints_alone_are_no_launch(clean_env):
    """The variables the JAX package auto-detects a cluster from, single
    entries, lists and sentinel strings alike, start nothing: the port's
    launcher is torchrun, which sets its own variables."""
    for k, v in (("TPU_WORKER_HOSTNAMES", "localhost"),
                 ("TPU_WORKER_HOSTNAMES", "worker-0,worker-1"),
                 ("TPU_WORKER_HOSTNAMES",
                  "WARNING: could not determine TPU worker hostnames"),
                 ("SLURM_STEP_NODELIST", "node[01-04]")):
        clean_env.setenv(k, v)
        assert dist.init_distributed("cpu") is False
        assert not dist.active()


@pytest.mark.parametrize("env", [
    {"MASTER_ADDR": "localhost"},
    {"MASTER_ADDR": "localhost", "MASTER_PORT": "29500"},
    {"RANK": "0", "WORLD_SIZE": "2"},
    {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
     "MASTER_ADDR": "localhost"},
], ids=["addr", "addr-port", "no-local-rank", "no-port"])
def test_partial_launch_raises(clean_env, env):
    """A launch that names part of a rendezvous fails loudly on every
    process instead of running as one of N independent runs."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError, match="launch"):
        dist.init_distributed("cpu")
    assert not dist.active()


@pytest.mark.parametrize("env", [
    {"RANK": "WARNING: could not determine the rank"},
    {"MASTER_PORT": "not-a-port"},
    {"RANK": "2"},
], ids=["sentinel-rank", "bad-port", "rank-out-of-range"])
def test_invalid_launch_values_raise(clean_env, env):
    full = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
            "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}
    for k, v in {**full, **env}.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError):
        dist.init_distributed("cpu")
    assert not dist.active()


def test_failed_rendezvous_raises(clean_env, tmp_path):
    """Rank 0 of two, and rank 1 never comes: the rendezvous times out and
    raises; the process is left in no group."""
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0")):
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError):
        dist.init_distributed(
            "cpu", init_method=f"file://{tmp_path / 'store'}",
            timeout=datetime.timedelta(seconds=2))
    assert not dist.active()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds what happens on a machine without a card")
def test_cuda_launch_without_a_card_raises(clean_env, tmp_path):
    """A CUDA run never takes gloo in place of NCCL, nor the CPU in place of
    the card."""
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.init_distributed(
            "cuda", init_method=f"file://{tmp_path / 'store'}")
    assert not dist.active()


def test_world_of_one_joins_and_an_existing_group_is_kept(clean_env,
                                                          tmp_path):
    """torchrun at one process joins a group (its collectives run); a
    second call, as a second trainer call in the same process makes, keeps
    it."""
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        clean_env.setenv(k, v)
    store = f"file://{tmp_path / 'store'}"
    assert dist.init_distributed("cpu", init_method=store)
    assert dist.active() and dist.world_size() == 1 and dist.is_main()
    assert dist.init_distributed("cpu", init_method=store)
    t = torch.arange(3.0)
    assert torch.equal(dist.all_gather(t), t)
    dist.destroy()
    assert not dist.active()


def test_gathered_nt_xent_gradient_under_two_processes(tmp_path):
    """Two gloo processes, 3 clips each: the gradient of the global NT-Xent
    (the mean over the processes of each one's rows against the gathered
    columns) with respect to each process's rows equals the matching rows of
    the single-process gradient over all 6 clips; the logits are the
    matching rows, the loss the same. Without the sum over ranks in
    ``all_gather_with_grad``'s backward the gradient would be short by the
    other process's share (checked below on the same numbers)."""
    rng = np.random.default_rng(5)
    f = rng.normal(size=(6, 2, 16))
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    features = torch.from_numpy(f)
    outs = launch_ranks("gather_grad", {"features": features},
                        tmp_path / "ranks")

    x = features.clone().requires_grad_(True)
    ret = nt_xent_loss(x, 0.07)
    ret["clip_contrast_loss"].backward()
    N, B = 6, 3
    rows = lambda r: np.r_[r * B:(r + 1) * B, N + r * B:N + (r + 1) * B]
    for r, out in enumerate(outs):
        # float64 throughout: only the summation order differs
        np.testing.assert_allclose(out["grad"].numpy(),
                                   x.grad[r * B:(r + 1) * B].numpy(),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(out["logits"].detach().numpy(),
                                   ret["clip_logits"][rows(r)].detach(),
                                   rtol=1e-12, atol=1e-12)
        assert float(out["loss"]) == pytest.approx(
            ret["clip_contrast_loss"].item(), rel=1e-12)
        g, pos, ranks = out["gathered"]
        np.testing.assert_array_equal(g, f)
        assert pos.dtype == np.bool_ and np.array_equal(pos, f > 0)
        np.testing.assert_array_equal(ranks, [0, 1])
    # the gradient a rank's own loss alone sends to its rows is not it
    own = features[:B].clone().requires_grad_(True)
    cols = torch.cat([own, features[B:]])
    sim_rows = own.transpose(0, 1).reshape(2 * B, -1)
    sim = sim_rows @ cols.transpose(0, 1).reshape(2 * N, -1).T
    (_nt_xent_from_sim(sim, B, 0.07, "")["contrast_loss"] / 2).backward()
    assert float((own.grad - x.grad[:B]).abs().max()) > 1e-3
