"""The port's training options against the JAX package's, on the CPU:
``optim='adam'``, ``remat`` and the heads' ``nonlinear=False``.

* AdamW against ``optax.adamw`` in float64: on the pretrain task's
  parameters with shared gradients (the JAX float64 pretrain step keeps its
  heads in float32, whose gradients Adam's normalisation would amplify where
  they are near 0), and three whole classifier steps, each package's own
  train step on the same clips (everything float64), across a learning-rate
  drop; the Adam state through a checkpoint and ``--resume``, bitwise.
* Rematerialisation against none in float64: losses, gradients and running
  statistics bitwise equal on both batch-norm routes (and under a process
  group of one, ``_SyncBN``), with the statistics' sums and collectives
  issued as often as without it (JAX's remat throws the recomputed batch
  statistics away; the port's recomputation reuses the first forward's).

``nonlinear=False`` is in tests/test_torch_port_nonlinear.py.
"""

import contextlib
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.core.config import CLASSIFIER_PRESETS as JAX_CLF_PRESETS
from dualvar_tpu.core.config import PRETRAIN_PRESETS as JAX_PRESETS
from dualvar_tpu.models.backbones import select_backbone as jax_backbone
from dualvar_tpu.models.heads import LinearClassifier as JaxClassifier
from dualvar_tpu.train import classifier as JC
from dualvar_tpu.train.pretrain import make_optimizer as jax_make_optimizer
from dualvar_tpu_torch.aug.pipeline import AugConfig
from dualvar_tpu_torch.core import dist
from dualvar_tpu_torch.core.checkpoint import CheckpointStore
from dualvar_tpu_torch.core.config import (CLASSIFIER_PRESETS,
                                           PRETRAIN_PRESETS, ModelConfig)
from dualvar_tpu_torch.core.convert import from_jax_variables
from dualvar_tpu_torch.models import layers as TLy
from dualvar_tpu_torch.models.backbones import select_backbone
from dualvar_tpu_torch.models.heads import LinearClassifier
from dualvar_tpu_torch.models.ssl.moco import MoCo
from dualvar_tpu_torch.models.ssl.simclr import SimCLRTimeSeriesV4
from dualvar_tpu_torch.train import classifier as TC
from dualvar_tpu_torch.train import pretrain as TP
from dualvar_tpu_torch.train.tasks import make_task, total_loss

from torch_port_util import numpy_variables

B, T, S, NUM_CLASS = 2, 4, 32, 5


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _adam(cfg, schedule=(2,)):
    return cfg.replace(optim=dataclasses.replace(
        cfg.optim, optim="adam", schedule=schedule)) \
        if hasattr(cfg, "replace") else dataclasses.replace(
            cfg, optim=dataclasses.replace(cfg.optim, optim="adam",
                                           schedule=schedule))


def test_pretrain_adam_steps_match_optax_adamw_in_float64():
    """Three AdamW steps of the pretrain task's parameters (SimCLR on R3D,
    ``smoke``'s model), one step an epoch and the lr drop before the third,
    against the JAX package's ``make_optimizer`` (``optax.adamw``) on the
    same float64 parameters and gradients: 1e-12 relative."""
    pcfg = _adam(PRETRAIN_PRESETS["smoke"])
    jcfg = _adam(JAX_PRESETS["smoke"])
    task = make_task(pcfg.model)
    model = task.model.double()
    params = dict(model.named_parameters())
    rng = np.random.default_rng(4)
    grads = [{k: rng.standard_normal(tuple(p.shape), np.float32).astype(
        np.float64) * 10.0 ** rng.integers(-6, 1) for k, p in params.items()}
        for _ in range(3)]
    tx, lr_fn = jax_make_optimizer(jcfg, steps_per_epoch=1)
    optimizer, scheduler = TP.make_optimizer(pcfg, params.values(), 1)
    assert isinstance(optimizer, torch.optim.AdamW)
    with _x64():
        jparams = {k: jnp.asarray(p.detach().numpy()) for k, p in
                   params.items()}
        state = tx.init(jparams)

        @jax.jit
        def update(g, state, jparams):
            updates, state = tx.update(g, state, jparams)
            return {k: jparams[k] + updates[k] for k in jparams}, state

        for i, g in enumerate(grads):
            jparams, state = update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jparams)
            for k, p in params.items():
                p.grad = torch.from_numpy(g[k])
            assert optimizer.param_groups[0]["lr"] == pytest.approx(
                float(lr_fn(i)), rel=1e-12)
            optimizer.step()
            scheduler.step()
            np.testing.assert_allclose(
                torch.cat([p.detach().reshape(-1)
                           for p in params.values()]).numpy(),
                np.concatenate([np.asarray(jparams[k]).reshape(-1)
                                for k in params]),
                rtol=1e-12, atol=1e-15, err_msg=f"step {i}")


def _clf_cfgs():
    return (_adam(JAX_CLF_PRESETS["paper_table1_ucf_ft"], (1,)),
            _adam(CLASSIFIER_PRESETS["paper_table1_ucf_ft"], (1,)))


def test_classifier_adam_steps_match_jax_in_float64(monkeypatch):
    """Three finetune steps of each package's own classifier train step with
    ``optim='adam'`` (two steps an epoch, schedule (1,): the third at lr x
    0.1) on the same clips, everything float64: parameters and running
    statistics after each step at 1e-6 (the SGD steps' band,
    tests/test_torch_port_classifier_step.py)."""
    jcfg, pcfg = _clf_cfgs()
    jmodel = JaxClassifier(backbone=jax_backbone("r3d")[0], feature_size=512,
                           num_class=NUM_CLASS, use_dropout=False)
    params, stats = numpy_variables(jmodel, jnp.zeros((B, T, S, S, 3)),
                                    seed=21, train=True)
    rng = np.random.default_rng(5)
    clips = rng.normal(size=(3, B, T, S, S, 3))
    labels = rng.integers(0, NUM_CLASS, (3, B)).astype(np.int32)

    monkeypatch.setattr(JC, "classifier_train_batch",
                        lambda key, frames, cfg, mesh=None: frames)
    backbone, param = jax_backbone("r3d", dtype=jnp.float64)
    model = JaxClassifier(backbone=backbone, feature_size=512,
                          num_class=NUM_CLASS, use_dropout=False,
                          dtype=jnp.float64)
    tx, _ = JC.make_optimizer(jcfg, 2)
    step = jax.jit(JC.make_train_step(model, tx, None, "ft"))
    want = []
    with _x64():
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        state = JC.TrainState(step=jnp.zeros((), jnp.int32),
                              params=f64(params), batch_stats=f64(stats),
                              opt_state=tx.init(f64(params)))
        for x, y in zip(clips, labels):
            state, _ = step(state, jnp.asarray(x), jnp.asarray(y),
                            jax.random.PRNGKey(0))
            want.append(from_jax_variables(
                jax.tree.map(lambda a: np.asarray(a, np.float64),
                             state.params),
                jax.tree.map(lambda a: np.asarray(a, np.float64),
                             state.batch_stats)))

    monkeypatch.setattr(TC, "classifier_train_batch",
                        lambda generator, frames, cfg: frames)
    tbackbone, _ = select_backbone("r3d")
    tmodel = LinearClassifier(tbackbone, 512, num_class=NUM_CLASS,
                              use_dropout=False)
    tmodel.load_state_dict(from_jax_variables(params, stats, tmodel))
    tmodel.double()
    optimizer, scheduler = TC.make_optimizer(
        pcfg, TC.trainable_parameters(tmodel, "ft"), 2)
    tstep = TC.make_train_step(tmodel, optimizer, scheduler,
                               AugConfig(img_dim=S, seq_len=T), "ft")
    for i, (x, y) in enumerate(zip(clips, labels)):
        tstep(torch.from_numpy(x), torch.from_numpy(y).long(),
              torch.Generator().manual_seed(0))
        got = tmodel.state_dict()
        assert set(got) == set(want[i])
        for key, w in want[i].items():
            np.testing.assert_allclose(got[key].numpy(), w.numpy(),
                                       atol=1e-6, rtol=1e-6,
                                       err_msg=f"step {i}: {key}")


def _assert_bitwise(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for key in a:
            _assert_bitwise(a[key], b[key], f"{where}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{where}/{i}")
    else:
        assert a == b, where


@pytest.mark.parametrize("which", ["pretrain", "classifier"])
def test_adam_state_resumes_bitwise(tmp_path, which):
    """Two epochs straight, and one epoch then ``--resume auto``: the
    model, the Adam moments and step counts, the scheduler and the
    generator end bitwise equal."""
    trainer = TP if which == "pretrain" else TC

    def cfg(root, epochs, resume=""):
        base = (PRETRAIN_PRESETS["smoke"] if which == "pretrain"
                else CLASSIFIER_PRESETS["smoke"])
        return dataclasses.replace(
            base,
            data=dataclasses.replace(base.data, seq_len=4, img_dim=32,
                                     scale_hw=(40, 36), synthetic_videos=8),
            optim=dataclasses.replace(base.optim, optim="adam",
                                      epochs=epochs),
            run=dataclasses.replace(base.run, log_root=str(root),
                                    resume=resume, eval_freq=1,
                                    save_freq=1))

    def store(c):
        return CheckpointStore(os.path.join(trainer.set_path(c), "model"))

    try:
        straight = cfg(tmp_path / "straight", 2)
        trainer.train(straight, device="cpu")
        trainer.train(cfg(tmp_path / "cut", 1), device="cpu")
        trainer.train(cfg(tmp_path / "cut", 2, resume="auto"), device="cpu")
        want = store(straight).restore()
        got = store(cfg(tmp_path / "cut", 2)).restore()
        assert got["epoch"] == want["epoch"] == 1
        adam = got["optimizer"]["state"]
        assert adam and all({"exp_avg", "exp_avg_sq", "step"} <= set(s)
                            for s in adam.values())
        for key in ("state_dict", "optimizer", "scheduler", "generator"):
            _assert_bitwise(got[key], want[key], key)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _count_sums(monkeypatch):
    calls = []
    orig = TLy._sums

    def counted(a, b):
        calls.append(1)
        return orig(a, b)

    monkeypatch.setattr(TLy, "_sums", counted)
    return calls


def _double_backbones(model):
    """Backbones in float64, as the JAX package's float64 means: the SSL
    models cast the pooled features to float32 for their heads; the
    classifier's head follows its parameters, so it is made double whole."""
    if isinstance(model, LinearClassifier):
        return model.double()
    for name, module in model.named_modules():
        if name.endswith("backbone"):
            module.double()
    return model


def _remat_pair(build):
    """The same model without and with remat (the same weights), its
    backbones in float64."""
    torch.manual_seed(3)
    plain = _double_backbones(build(False))
    remat = _double_backbones(build(True))
    remat.load_state_dict(plain.state_dict())
    return plain, remat


def _run(model, forward, calls):
    """One train-mode forward and backward -> (losses, grads, state,
    sums calls, collectives)."""
    del calls[:]
    dist.collectives.clear()
    model.train()
    ret = forward(model)
    total_loss(ret).backward()
    return ({k: v.detach() for k, v in ret.items() if k.endswith("loss")},
            {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None},
            {k: v.clone() for k, v in model.state_dict().items()},
            len(calls), dict(dist.collectives))


MODELS = {
    "tsv4_r21d": (lambda remat: SimCLRTimeSeriesV4(network="r21d",
                                                   remat=remat),
                  lambda m, x: m(x, perm=torch.tensor([[1, 0], [0, 1]])), 3),
    "moco_r3d": (lambda remat: MoCo(network="r3d", K=8, remat=remat,
                                    generator=torch.Generator().manual_seed(
                                        0)),
                 lambda m, x: m(x, perm=torch.tensor([[1, 0], [0, 1]])), 3),
    "classifier_r3d": (
        lambda remat: LinearClassifier(select_backbone("r3d", remat=remat)[0],
                                       512, num_class=NUM_CLASS,
                                       use_dropout=False),
        lambda m, x: {"loss": cross_entropy(m(x[:, 0])[0])}, 1),
}


def cross_entropy(logits):
    return torch.nn.functional.cross_entropy(
        logits, torch.arange(logits.shape[0]) % NUM_CLASS)


@pytest.mark.parametrize("bn_stats", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_is_bitwise_no_remat_in_float64(name, bn_stats, monkeypatch):
    monkeypatch.setenv("DUALVAR_BN_STATS", bn_stats)
    build, forward, views = MODELS[name]
    plain, remat = _remat_pair(build)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(B, views, T, S, S, 3)))
    calls = _count_sums(monkeypatch)
    a = _run(plain, lambda m: forward(m, x), calls)
    b = _run(remat, lambda m: forward(m, x), calls)
    for i, what in enumerate(("losses", "grads", "state")):
        _assert_bitwise(b[i], a[i], what)
    # the one-pass route's sums: once a batch norm in the forward and once
    # in the backward, with remat as without
    assert b[3] == a[3] and (a[3] > 0) == (bn_stats == "pallas")
    assert a[4] == b[4] == {}
    backbone = remat.encoder_q.backbone if name.startswith("moco") \
        else remat.backbone
    assert type(backbone).__name__.startswith("Remat")


def test_remat_under_a_group_of_one_issues_the_collectives_once(tmp_path):
    """``_SyncBN`` (ATen's route under a process group): the recomputation
    reuses the first forward's gathered statistics, so each batch norm
    gathers once and all-reduces once a step, with remat as without."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        build, forward, views = MODELS["classifier_r3d"]
        plain, remat = _remat_pair(build)
        x = torch.from_numpy(np.random.default_rng(7).normal(
            size=(B, views, T, S, S, 3)))
        calls = []
        a = _run(plain, lambda m: forward(m, x), calls)
        b = _run(remat, lambda m: forward(m, x), calls)
        for i, what in enumerate(("losses", "grads", "state")):
            _assert_bitwise(b[i], a[i], what)
        n_bn = sum(isinstance(m, TLy.BatchNorm) for m in plain.modules())
        assert a[4] == b[4] == {"all_gather": n_bn, "all_reduce": n_bn}
    finally:
        torch.distributed.destroy_process_group()


def test_remat_config_reaches_every_model_and_visualize_refuses(tmp_path):
    for model in ("simclr_naked", "simclr_timeseriesv4", "moco_timeseriesv4"):
        task = make_task(ModelConfig(net="r3d", model=model, remat=True,
                                     moco_k=8))
        backbone = getattr(task.model, "encoder_q", task.model).backbone
        assert getattr(backbone, "remat", False), model
        with pytest.raises(ValueError, match="remat=False"):
            task.get_features(torch.zeros(1, 4, 32, 32, 3))
    clf = TC.build_model(dataclasses.replace(
        CLASSIFIER_PRESETS["smoke"], model=dataclasses.replace(
            CLASSIFIER_PRESETS["smoke"].model, remat=True)))
    assert clf.backbone.remat
    # the state_dict keys are the plain model's
    assert set(clf.state_dict()) == set(TC.build_model(
        CLASSIFIER_PRESETS["smoke"]).state_dict())
    cfg = PRETRAIN_PRESETS["paper_table1_k400"]
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=True),
                      run=dataclasses.replace(cfg.run,
                                              log_root=str(tmp_path)))
    with pytest.raises(ValueError, match="remat=False"):
        TP.visualize(cfg, device="cpu")
