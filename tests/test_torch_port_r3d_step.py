"""The third slice of the port as a whole — the SimCLR (``simclr_naked``)
step on R3D-18 — against the JAX package on the CPU, and the smoke presets
through ``train()``.

The step is compared in float64, as tests/test_torch_port_slice.py and
tests/test_torch_port_moco_step.py do: the JAX package's float32 backward
on XLA:CPU is no oracle at this size (ROADMAP.md, C.1). "Float64" is what
the JAX package makes of it: the backbone follows the parameters' type, the
pooled features, the head and the loss stay float32. The port is put into
the same arrangement (backbone in double).
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.models.ssl.simclr import SimCLRNaked as JaxNaked
from dualvar_tpu.train.tasks import total_loss as jax_total_loss
from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS, ModelConfig
from dualvar_tpu_torch.core.convert import from_jax_variables
from dualvar_tpu_torch.models import layers as TLy
from dualvar_tpu_torch.train.pretrain import train
from dualvar_tpu_torch.train.tasks import make_task, total_loss

from torch_port_util import numpy_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, S = 2, 8, 32


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def jax_step():
    """Weights, block, and the JAX package's float64 step on them: (ret,
    new batch_stats, gradients) as numpy trees."""
    params, stats = numpy_variables(
        JaxNaked(network="r3d"), jnp.zeros((B, 2, T, S, S, 3)), seed=21,
        train=True)
    block = np.random.default_rng(22).normal(size=(B, 2, T, S, S, 3))
    model = JaxNaked(network="r3d", dtype=jnp.float64)

    def loss_fn(p, s, x):
        ret, upd = model.apply({"params": p, "batch_stats": s}, x,
                               train=True, mutable=["batch_stats"])
        return jax_total_loss(ret), (ret, upd["batch_stats"])

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

    with _x64():
        grads, (ret, new_stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            f64(params), f64(stats), jnp.asarray(block))
        out = jax.tree.map(np.asarray, (ret, new_stats, grads))
    return params, stats, block, out


@pytest.mark.parametrize("bn_stats", ["xla", "pallas"])
def test_simclr_naked_r3d_step_matches_jax_in_float64(jax_step, monkeypatch,
                                                      bn_stats):
    """Losses, logits, the new BN running statistics and the gradient of
    every parameter, with the port's batch norm on ATen's path and on the
    one-pass path (whose float64 sums are torch's, as the JAX package
    routes float64)."""
    monkeypatch.setenv("DUALVAR_BN_STATS", bn_stats)
    params, stats, block, (ret_j, stats_j, grads_j) = jax_step
    task = make_task(ModelConfig(net="r3d", model="simclr_naked",
                                 dtype="float32"))
    model = task.model
    model.load_state_dict(from_jax_variables(params, stats, module=model))
    model.train()
    model.backbone.double()
    ret = task.forward(torch.from_numpy(block))
    total_loss(ret).backward()

    assert set(ret) == set(ret_j)
    for key, want in ret_j.items():
        got = ret[key].detach().numpy()
        assert got.shape == want.shape, key
        # float32 head and loss on float64 features: float32 rounding
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5,
                                   err_msg=key)
    want_state = from_jax_variables(params, stats_j)
    got_state = model.state_dict()
    for key in (k for k in got_state if "running_" in k):
        np.testing.assert_allclose(
            got_state[key].numpy(), want_state[key].numpy(), atol=1e-6,
            rtol=1e-6, err_msg=key)
    want_grads = from_jax_variables(grads_j, {})
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    for key, p in named.items():
        want = want_grads[key].numpy()
        scale = np.abs(want).max()
        assert scale > 0, key
        # the float32 head and loss feed the float64 backbone's backward
        np.testing.assert_allclose(p.grad.numpy() / scale, want / scale,
                                   atol=5e-6, err_msg=key)


def _smoke(preset, tmp_path, **model_kw):
    cfg = PRETRAIN_PRESETS[preset]
    assert cfg.model.net == "r3d"
    return cfg.replace(
        data=dataclasses.replace(cfg.data, img_dim=S, scale_hw=(40, 36),
                                 synthetic_videos=8),
        model=dataclasses.replace(cfg.model, **model_kw),
        run=dataclasses.replace(cfg.run, log_root=str(tmp_path)))


def _count_sums(monkeypatch):
    calls = []
    orig = TLy.channel_sums

    def counted(a, b, dim=-1):
        calls.append(a is b)
        return orig(a, b, dim)

    monkeypatch.setattr(TLy, "channel_sums", counted)
    return calls


@pytest.mark.parametrize("bn_stats", ["xla", "pallas"])
def test_smoke_preset_trains_on_cpu(tmp_path, monkeypatch, bn_stats):
    """``--preset smoke`` (SimCLRNaked on R3D): one step with the variable
    off and on. On, each of the 12 batch norms takes one forward and one
    backward reduction through ``channel_sums``."""
    monkeypatch.setenv("DUALVAR_BN_STATS", bn_stats)
    calls = _count_sums(monkeypatch)
    metrics = train(_smoke("smoke", tmp_path), max_steps=1, device="cpu")
    assert set(metrics) == {"clip_loss", "clip_top1", "clip_top5",
                            "total_loss"}
    assert all(np.isfinite(v) for v in metrics.values())
    if bn_stats == "pallas":
        assert calls == [True] * 12 + [False] * 12
    else:
        assert calls == []


@pytest.mark.parametrize("preset", ["smoke_dualvar", "smoke_moco"])
def test_r3d_smoke_presets_train_on_cpu(tmp_path, preset):
    metrics = train(_smoke(preset, tmp_path), max_steps=1, device="cpu")
    assert {"clip_loss", "tc_loss", "total_loss"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())


def test_pretrain_cli_runs_the_smoke_preset_on_cpu(tmp_path):
    """The documented command, at a 32-pixel crop."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "dualvar_tpu_torch.train.pretrain",
         "--preset", "smoke", "--device", "cpu", "--max_steps", "1",
         "--img_dim", "32"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert os.path.exists(os.path.join(
        tmp_path, "log", "smoke", "pretrain", "exp", "model",
        "latest", "epoch0.pth.tar"))
