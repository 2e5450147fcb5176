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
    # AdamW (ported since; its arithmetic is held against optax.adamw in
    # tests/test_torch_port_optim_remat.py) runs under the same schedule;
    # a name neither package knows is refused
    adam_opt, adam_sched = make_optimizer(pcfg.replace(
        optim=dataclasses.replace(pcfg.optim, optim="adam")), [w], 3)
    assert isinstance(adam_opt, torch.optim.AdamW)
    for step in range(12):
        assert adam_opt.param_groups[0]["lr"] == pytest.approx(
            float(lr_fn(step)), rel=1e-6), step
        adam_opt.step()
        adam_sched.step()
    with pytest.raises(ValueError, match="sgd"):
        make_optimizer(pcfg.replace(optim=dataclasses.replace(
            pcfg.optim, optim="lamb")), [w], 3)


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
        "latest", "epoch0.pth.tar"))
    assert set(ckpt) == {"epoch", "state_dict", "best_acc", "optimizer",
                         "scheduler", "generator", "iteration"}
    assert ckpt["iteration"] == 2 and ckpt["epoch"] == 0
    task = make_task(cfg.model)
    task.model.load_state_dict(ckpt["state_dict"])  # strict
    assert float(ckpt["state_dict"]["backbone.bn1.running_mean"].abs().max()) > 0


def test_train_refuses_a_missing_card_and_unported_models(tmp_path):
    cfg = _smoke_cfg(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(cfg, max_steps=1)  # device defaults to cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(_smoke_cfg(tmp_path, mode="clip-sr-dtw"), max_steps=1)
    with pytest.raises(NotImplementedError, match="unknown model"):
        make_task(dataclasses.replace(cfg.model, model="byol"))
    # a model config that names a backbone no registry has (the registry
    # variants, s3dg_packed among them, are ported)
    with pytest.raises(NotImplementedError, match="unknown backbone"):
        make_task(dataclasses.replace(cfg.model, net="s3dg_tiled"))


@pytest.mark.parametrize("model,n_views,cls", [
    ("simclr_naked", 2, "SimCLRNaked"),
    ("simclr_timeseriesv4", 3, "SimCLRTimeSeriesV4"),
    ("moco_naked", 2, "MoCo"),
    ("moco_timeseriesv4", 3, "MoCo"),
])
def test_make_task_builds_all_four_models(model, n_views, cls):
    cfg = ModelConfig(model=model, moco_k=16, dtw_gamma=0.3, moco_m=0.9,
                      moco_shuffle_bn=2)
    task = make_task(cfg, torch.Generator().manual_seed(0))
    assert type(task.model).__name__ == cls
    assert task.n_views == n_views
    trainable = list(task.parameters())
    assert trainable and all(p.requires_grad for p in trainable)
    if model.startswith("moco"):
        assert task.model.naked == (n_views == 2)
        assert task.model.queue.shape == (16, 128)
        assert (task.model.m, task.model.shuffle_bn_groups) == (0.9, 2)
        # the optimizer sees the query encoder only
        assert {id(p) for p in trainable} == {
            id(p) for p in task.model.encoder_q.parameters()}
        assert len(list(task.model.parameters())) == 2 * len(trainable)
    if model.endswith("timeseriesv4"):
        assert task.model.dtw_gamma == 0.3  # reaches the model from the config


def _smoke_moco_cfg(tmp_path, **model_kw) -> PretrainConfig:
    """Preset ``smoke_moco`` on the backbone that is ported."""
    cfg = PRETRAIN_PRESETS["smoke_moco"]
    return cfg.replace(
        model=dataclasses.replace(cfg.model, net="r21d", **model_kw),
        data=dataclasses.replace(cfg.data, img_dim=S, scale_hw=(40, 36)),
        run=dataclasses.replace(cfg.run, log_root=str(tmp_path)))


@pytest.mark.parametrize("mode", ["clip-sr-tc", "clip-sr-dtw"])
def test_train_runs_smoke_moco_on_cpu(tmp_path, mode):
    cfg = _smoke_moco_cfg(tmp_path, mode=mode)
    metrics = train(cfg, max_steps=2, device="cpu")
    assert set(metrics) >= {"clip_loss", "tc_loss", "aug_ranking_margin_loss",
                            "unaug_ranking_margin_loss", "total_loss",
                            "clip_top1", "clip_top5", "tc_top1"}
    assert all(np.isfinite(v) for v in metrics.values())
    ckpt = torch.load(os.path.join(
        tmp_path, cfg.run.prefix, "pretrain", cfg.run.name_prefix, "model",
        "latest", "epoch0.pth.tar"))
    state = ckpt["state_dict"]
    B, K = cfg.optim.batch_size, cfg.model.moco_k
    # the checkpoint carries the key encoder, both queues and the pointer
    task = make_task(cfg.model)
    task.model.load_state_dict(state)  # strict
    assert int(state["queue_ptr"]) == 2 * B
    assert state["queue"].shape == (K, 128)
    assert state["series_queue"].shape == (K, 128)
    written = state["series_queue"][:2 * B].reshape(2 * B, 2, 64)
    np.testing.assert_allclose(written.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    key = "backbone.conv1.spatial_conv.weight"
    assert not torch.equal(state["encoder_q." + key],
                           state["encoder_k." + key])
    # the optimizer holds momentum for the query encoder only
    n_q = len(list(task.model.encoder_q.parameters()))
    assert len(ckpt["optimizer"]["state"]) == n_q
    assert float(state["encoder_k.backbone.bn1.running_mean"].abs().max()) > 0


@pytest.mark.parametrize("model", ["simclr_naked", "moco_naked"])
def test_train_runs_the_naked_models_on_two_views(tmp_path, model):
    cfg = _smoke_moco_cfg(tmp_path, model=model)
    metrics = train(cfg, max_steps=2, device="cpu")
    assert set(metrics) == {"clip_loss", "clip_top1", "clip_top5",
                            "total_loss"}
    assert all(np.isfinite(v) for v in metrics.values())


def test_train_runs_simclr_in_mode_clip_sr_dtw_on_cpu(tmp_path):
    metrics = train(_smoke_cfg(tmp_path, mode="clip-sr-dtw", dtw_gamma=0.1),
                    max_steps=2, device="cpu")
    assert np.isfinite(metrics["tc_loss"])
    assert np.isfinite(metrics["total_loss"])


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
