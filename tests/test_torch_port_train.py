"""The port's pretraining entry point (dualvar_tpu_torch.train.pretrain) on the
CPU, its optimizer and learning-rate schedule against optax, and
its host loader against the JAX package's loader.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dualvar_tpu.core.config import PRETRAIN_PRESETS as JAX_PRESETS
from dualvar_tpu.data import loader as jax_loader
from dualvar_tpu.train.pretrain import make_optimizer as jax_make_optimizer
from dualvar_tpu.models.ssl.simclr import SimCLRTimeSeriesV4 as JaxTSV4
from dualvar_tpu_torch.core.config import (PRETRAIN_PRESETS, ModelConfig,
                                           PretrainConfig)
from dualvar_tpu_torch.core.convert import from_jax_variables
from dualvar_tpu_torch.data import loader as port_loader
from dualvar_tpu_torch.train.pretrain import make_optimizer, train
from dualvar_tpu_torch.train.tasks import make_task

from torch_port_util import numpy_variables

T, S = 8, 32


def test_two_sgd_steps_match_optax():
    """Two steps of SGD momentum 0.9 with weight decay 1e-4 added to the
    gradient, on every parameter (BN and bias included), against the JAX
    package's optimizer. Both get the same numpy-made gradients, so this
    holds the update rule alone; the gradients are held above."""
    params, stats = numpy_variables(
        JaxTSV4(network="r21d"), jnp.zeros((2, 3, T, S, S, 3)), seed=11,
        train=True)
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        for _ in range(2)]
    tx, _ = jax_make_optimizer(JAX_PRESETS["paper_table1_k400"],
                               steps_per_epoch=10)

    @jax.jit
    def jax_update(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    opt_state = tx.init(params)
    start_tree = params
    for g in grads:
        params, opt_state = jax_update(g, opt_state, params)

    task = make_task(ModelConfig(dtype="float32"))
    task.model.load_state_dict(
        from_jax_variables(start_tree, stats, module=task.model))
    named = dict(task.model.named_parameters())
    optimizer, scheduler = make_optimizer(
        PRETRAIN_PRESETS["paper_table1_k400"], task.model.parameters(), 10)
    start = {k: v.detach().clone() for k, v in named.items()}
    for g in grads:
        for key, val in from_jax_variables(g, {}).items():
            named[key].grad = val
        optimizer.step()
        scheduler.step()

    want = from_jax_variables(jax.tree.map(np.asarray, params), stats)
    for key, p in named.items():
        # moves are about lr * 2.9 * |g| ~ 1e-2; float32 rounding only
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                   atol=1e-7, rtol=1e-6, err_msg=key)
        assert float((p.detach() - start[key]).abs().max()) > 1e-3, key


def test_lr_schedule_matches_optax_boundaries():
    cfg = JAX_PRESETS["paper_table1_k400"]
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, schedule=(2, 3)))
    _, lr_fn = jax_make_optimizer(cfg, steps_per_epoch=3)
    pcfg = PRETRAIN_PRESETS["paper_table1_k400"]
    pcfg = pcfg.replace(optim=dataclasses.replace(pcfg.optim, schedule=(2, 3)))
    w = torch.nn.Parameter(torch.zeros(1))
    optimizer, scheduler = make_optimizer(pcfg, [w], 3)
    for step in range(12):
        # the lr the step-th update (0-based) is made with
        assert optimizer.param_groups[0]["lr"] == pytest.approx(
            float(lr_fn(step)), rel=1e-6), step
        optimizer.step()
        scheduler.step()
    with pytest.raises(NotImplementedError, match="sgd"):
        make_optimizer(pcfg.replace(optim=dataclasses.replace(
            pcfg.optim, optim="adam")), [w], 3)


def _smoke_cfg(tmp_path, **model_kw) -> PretrainConfig:
    cfg = PRETRAIN_PRESETS["paper_table1_k400"]
    return cfg.replace(
        data=dataclasses.replace(
            cfg.data, synthetic=True, synthetic_videos=8, synthetic_classes=2,
            seq_len=T, img_dim=S, scale_hw=(40, 36), workers=2),
        model=dataclasses.replace(cfg.model, dtype="float32", **model_kw),
        optim=dataclasses.replace(cfg.optim, batch_size=2),
        run=dataclasses.replace(cfg.run, print_freq=1,
                                log_root=str(tmp_path)))


def test_train_entry_point_runs_on_cpu(tmp_path):
    cfg = _smoke_cfg(tmp_path)
    metrics = train(cfg, max_steps=2, device="cpu")
    assert set(metrics) >= {"clip_loss", "tc_loss", "aug_ranking_margin_loss",
                            "unaug_ranking_margin_loss", "total_loss",
                            "clip_top1", "clip_top5"}
    assert all(np.isfinite(v) for v in metrics.values())
    ckpt = torch.load(os.path.join(
        tmp_path, cfg.run.prefix, "pretrain", cfg.run.name_prefix, "model",
        "epoch0.pth.tar"))
    assert set(ckpt) == {"epoch", "state_dict", "best_acc", "optimizer",
                         "iteration"}
    assert ckpt["iteration"] == 2 and ckpt["epoch"] == 0
    task = make_task(cfg.model)
    task.model.load_state_dict(ckpt["state_dict"])  # strict
    assert float(ckpt["state_dict"]["backbone.bn1.running_mean"].abs().max()) > 0


def test_train_refuses_a_missing_card_and_unported_models(tmp_path):
    cfg = _smoke_cfg(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(cfg, max_steps=1)  # device defaults to cuda
    for model in ("moco_timeseriesv4", "simclr_naked"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make_task(dataclasses.replace(cfg.model, model=model))
    with pytest.raises(NotImplementedError, match="soft-DTW"):
        train(_smoke_cfg(tmp_path, mode="clip-sr-dtw"), max_steps=1,
              device="cpu")


def test_host_loader_yields_the_jax_loaders_batch():
    def batch(mod):
        entries, class_index = mod.synthetic_entries(12, 3)
        ds = mod.PretrainDataset(
            entries=entries, class_index=class_index,
            source=mod.SyntheticFrameSource(scale=(40, 36)), num_frames=T,
            ds=2)
        loader = mod.HostLoader(ds, 4, shuffle=True, seed=5, num_workers=2)
        try:
            assert len(loader) == 3
            return [b for b in loader.epoch(1)]
        finally:
            loader.pool.shutdown()

    want, got = batch(jax_loader), batch(port_loader)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["frames"].dtype == np.uint8
        assert g["frames"].shape == (4, 3 * T, 40, 36, 3)
        np.testing.assert_array_equal(g["frames"], w["frames"])
        np.testing.assert_array_equal(g["label"], w["label"])
