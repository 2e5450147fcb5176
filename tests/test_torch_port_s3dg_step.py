"""The ``s3dg_k400`` pretrain step — SimCLR TimeSeriesV4 on S3D-G, mode
``clip-sr-tc`` — against the JAX package on the CPU, and the preset through
the port's ``train()`` with ``device="cpu"``.

The step is compared in float64, as tests/test_torch_port_r3d_step.py
compares its step: "float64" is what the JAX package makes of it (the
backbone in float64; pooled features, heads and losses float32), and the
port is put into the same arrangement (backbone in double). Both sides get
the same numpy-made weights, block and segment permutation, at B=2, T=8,
32x32 (S3D-G's last maps are 1x1x1 there).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.core.config import PRETRAIN_PRESETS as JAX_PRESETS
from dualvar_tpu.models.ssl.simclr import SimCLRTimeSeriesV4 as JaxTSV4
from dualvar_tpu.train.tasks import total_loss as jax_total_loss
from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS
from dualvar_tpu_torch.core.convert import from_jax_variables
from dualvar_tpu_torch.train.pretrain import train
from dualvar_tpu_torch.train.tasks import make_task, total_loss

from torch_port_util import GRAD_FLOOR, numpy_variables, x64

B, T, S = 2, 8, 32
PERM = np.array([[1, 0], [0, 1]], np.int32)
MODEL_FIELDS = ("net", "model", "mode", "n_series", "series_dim",
                "moco_dim", "moco_t", "aligned_T", "shufflerank_theta")


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """The checkpoints these tests write are 0.1-0.2 GB each (R3D-18 and
    its optimizer state); remove them when a test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_preset_model_matches_the_jax_preset():
    port = PRETRAIN_PRESETS["s3dg_k400"]
    ref = JAX_PRESETS["s3dg_k400"]
    for name in MODEL_FIELDS:
        assert getattr(port.model, name) == getattr(ref.model, name), name
    assert port.run.keep_all and ref.run.keep_all
    assert (port.optim.batch_size, port.data.ds) == (8, 4)


@pytest.fixture(scope="module")
def jax_step():
    """Weights, block and the JAX package's float64 step: (ret, new
    batch_stats, gradients) as numpy trees."""
    m = JAX_PRESETS["s3dg_k400"].model
    kwargs = dict(network=m.net, dim=m.moco_dim, temperature=m.moco_t,
                  n_series=m.n_series, series_dim=m.series_dim,
                  aligned_T=m.aligned_T, mode=m.mode,
                  shufflerank_theta=m.shufflerank_theta)
    params, stats = numpy_variables(
        JaxTSV4(**kwargs), jnp.zeros((B, 3, T, S, S, 3)), seed=31,
        train=True)
    block = np.random.default_rng(32).normal(size=(B, 3, T, S, S, 3))
    model = JaxTSV4(**kwargs, dtype=jnp.float64)

    def loss_fn(p, s, x, perm):
        ret, upd = model.apply({"params": p, "batch_stats": s}, x,
                               perm=perm, train=True,
                               mutable=["batch_stats"])
        return jax_total_loss(ret), (ret, upd["batch_stats"])

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

    with x64():
        grads, (ret, new_stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            f64(params), f64(stats), jnp.asarray(block), jnp.asarray(PERM))
        out = jax.tree.map(np.asarray, (ret, new_stats, grads))
    return params, stats, block, out


def test_s3dg_k400_step_matches_jax_in_float64(jax_step):
    """Losses and logits (float32 heads on float64 features: float32
    rounding), the new running statistics, and the gradient of every
    parameter on the scale of its largest entry (floored as
    ``check_backbone_train_step_float64`` floors it)."""
    params, stats, block, (ret_j, stats_j, grads_j) = jax_step
    cfg = PRETRAIN_PRESETS["s3dg_k400"]
    task = make_task(dataclasses.replace(cfg.model, dtype="float32"))
    model = task.model
    model.load_state_dict(from_jax_variables(params, stats, module=model))
    model.train()
    model.backbone.double()
    ret = task.forward(torch.from_numpy(block), perm=torch.from_numpy(PERM))
    total_loss(ret).backward()

    assert sorted(k for k in ret_j if k.endswith("loss")) == [
        "aug_ranking_margin_contrast_loss", "clip_contrast_loss",
        "tc_contrast_loss", "unaug_ranking_margin_contrast_loss"]
    assert set(ret) == set(ret_j)
    for key, want in ret_j.items():
        got = ret[key].detach().numpy()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5,
                                   err_msg=key)
    want_state = from_jax_variables(params, stats_j)
    for key, val in model.state_dict().items():
        if "running_" in key:
            np.testing.assert_allclose(val.numpy(), want_state[key].numpy(),
                                       atol=1e-6, rtol=1e-6, err_msg=key)
    want_grads = from_jax_variables(grads_j, {})
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    largest = max(float(v.abs().max()) for v in want_grads.values())
    for key, p in named.items():
        want = want_grads[key].numpy()
        scale = max(np.abs(want).max(), GRAD_FLOOR * largest)
        assert scale > 0, key
        # the float32 heads and losses feed the float64 backbone's backward
        np.testing.assert_allclose(p.grad.numpy() / scale, want / scale,
                                   atol=5e-6, err_msg=key)


def test_s3dg_k400_trains_on_cpu(tmp_path, monkeypatch):
    """``--preset s3dg_k400 --device cpu`` at a 32-pixel crop: two steps,
    finite losses, and with ``DUALVAR_BN_STATS=pallas`` each of S3D-G's 77
    batch norms takes one forward and one backward ``channel_sums`` call
    for each of the step's two backbone passes (the 3B views, then the B
    shuffled clips): 308 a step."""
    from dualvar_tpu_torch.models import layers as TLy

    monkeypatch.setenv("DUALVAR_BN_STATS", "pallas")
    calls = []
    orig = TLy.channel_sums
    monkeypatch.setattr(TLy, "channel_sums",
                        lambda a, b, dim=-1: calls.append(a is b)
                        or orig(a, b, dim))
    cfg = PRETRAIN_PRESETS["s3dg_k400"]
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic=True, seq_len=T,
                                 img_dim=S, scale_hw=(40, 36),
                                 synthetic_videos=4, workers=2),
        model=dataclasses.replace(cfg.model, dtype="float32"),
        optim=dataclasses.replace(cfg.optim, batch_size=2),
        run=dataclasses.replace(cfg.run, log_root=str(tmp_path),
                                print_freq=1))
    metrics = train(cfg, max_steps=2, device="cpu")
    assert {"clip_loss", "tc_loss", "aug_ranking_margin_loss",
            "unaug_ranking_margin_loss", "total_loss"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    assert len(calls) == 2 * 308
    assert calls[:154] == [True] * 154  # the two passes' forward sums
