"""Classifier train steps of the port against the JAX package, in float64:
three finetune (``'ft'``) steps across a learning-rate drop and two
linear-probe (``'last'``) steps, with the gradients of each step.

Float64 because the JAX package's float32 backward on XLA:CPU is off by
percents at this size (ROADMAP.md C.1: a float32 trajectory is no oracle).
"Float64" is what the JAX package makes of it: the backbone follows the
parameters' type, the pooled feature is cast to float32, and the head and
the loss follow the parameters again; the port's ``LinearClassifier``
does the same once made double. Both sides run their own train step
(``make_train_step``, ``make_optimizer``) on the same clips: the
augmentation is replaced by the identity in both classifier modules, so
the clips go in as they are.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.core.config import CLASSIFIER_PRESETS as JAX_PRESETS
from dualvar_tpu.models.backbones import select_backbone as jax_backbone
from dualvar_tpu.models.heads import LinearClassifier as JaxClassifier
from dualvar_tpu.models.ssl.losses import cross_entropy_from_logits
from dualvar_tpu.train import classifier as JC
from dualvar_tpu_torch.aug.pipeline import AugConfig
from dualvar_tpu_torch.core.config import CLASSIFIER_PRESETS
from dualvar_tpu_torch.core.convert import from_jax_variables
from dualvar_tpu_torch.models.backbones import select_backbone
from dualvar_tpu_torch.models.heads import LinearClassifier
from dualvar_tpu_torch.train import classifier as TC

from torch_port_util import numpy_variables

B, T, S, NUM_CLASS = 4, 4, 32, 5
STEPS_PER_EPOCH = 2  # schedule (1,): the third step runs at lr x 0.1
ATOL = RTOL = 1e-6


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _cfgs():
    jcfg = JAX_PRESETS["paper_table1_ucf_ft"]
    pcfg = CLASSIFIER_PRESETS["paper_table1_ucf_ft"]
    # the presets' optimizer settings are the same in both packages
    assert dataclasses.asdict(pcfg.optim) == dataclasses.asdict(jcfg.optim)
    optim = dict(schedule=(1,))
    return (dataclasses.replace(jcfg, optim=dataclasses.replace(
                jcfg.optim, **optim)),
            dataclasses.replace(pcfg, optim=dataclasses.replace(
                pcfg.optim, **optim)))


def _inputs(n_steps, seed=5):
    rng = np.random.default_rng(seed)
    clips = rng.normal(size=(n_steps, B, T, S, S, 3))
    labels = rng.integers(0, NUM_CLASS, (n_steps, B)).astype(np.int32)
    return clips, labels


def _jax_steps(params, stats, clips, labels, train_what, monkeypatch):
    """The JAX package's own train step, float64, on the given clips ->
    per step (params, batch_stats, grads, loss) as numpy."""
    monkeypatch.setattr(JC, "classifier_train_batch",
                        lambda key, frames, cfg, mesh=None: frames)
    jcfg, _ = _cfgs()
    backbone, param = jax_backbone("r3d", dtype=jnp.float64)
    model = JaxClassifier(backbone=backbone,
                          feature_size=param["feature_size"],
                          num_class=NUM_CLASS, use_dropout=False,
                          dtype=jnp.float64)
    tx, _ = JC.make_optimizer(jcfg, STEPS_PER_EPOCH)
    step = jax.jit(JC.make_train_step(model, tx, None, train_what))

    @jax.jit
    def grads_of(params, stats, x, y):
        # the gradient the step takes (dualvar_tpu/train/classifier.py:
        # 111-125)
        def loss_fn(p):
            (logit, _), _ = model.apply(
                {"params": p, "batch_stats": stats}, x,
                train=train_what == "ft", mutable=["batch_stats"])
            return cross_entropy_from_logits(logit, y)
        return jax.grad(loss_fn)(params)

    out = []
    with _x64():
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        params, stats = f64(params), f64(stats)
        state = JC.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=stats, opt_state=tx.init(params))
        key = jax.random.PRNGKey(0)
        for x, y in zip(clips, labels):
            x, y = jnp.asarray(x), jnp.asarray(y)
            grads = grads_of(state.params, state.batch_stats, x, y)
            state, metrics = step(state, x, y, key)
            out.append(jax.tree.map(np.asarray, (
                state.params, state.batch_stats, grads, metrics["loss"])))
    return out


def _port_steps(params, stats, clips, labels, train_what, monkeypatch):
    """The port's own train step on the same clips, the model in double
    -> per step (state_dict, grads by key, loss)."""
    monkeypatch.setattr(TC, "classifier_train_batch",
                        lambda generator, frames, cfg: frames)
    _, pcfg = _cfgs()
    backbone, param = select_backbone("r3d")
    model = LinearClassifier(backbone, param["feature_size"],
                             num_class=NUM_CLASS, use_dropout=False)
    model.load_state_dict(from_jax_variables(params, stats, model))
    model.double()
    optimizer, scheduler = TC.make_optimizer(
        pcfg, TC.trainable_parameters(model, train_what), STEPS_PER_EPOCH)
    step = TC.make_train_step(model, optimizer, scheduler,
                              AugConfig(img_dim=S, seq_len=T), train_what)
    out = []
    for x, y in zip(clips, labels):
        metrics = step(torch.from_numpy(x), torch.from_numpy(y).long(),
                       torch.Generator().manual_seed(0))
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        out.append(({k: v.clone() for k, v in model.state_dict().items()},
                    grads, float(metrics["loss"])))
    return out


def _as_state(params, stats):
    return from_jax_variables(
        jax.tree.map(lambda a: np.asarray(a, np.float64), params),
        jax.tree.map(lambda a: np.asarray(a, np.float64), stats))


def _close(got, want, what):
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(),
                               atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("train_what,n_steps", [("ft", 3), ("last", 2)])
def test_train_steps_and_gradients_match_jax_in_float64(train_what, n_steps,
                                                        monkeypatch):
    jmodel = JaxClassifier(backbone=jax_backbone("r3d")[0], feature_size=512,
                           num_class=NUM_CLASS, use_dropout=False)
    params, stats = numpy_variables(jmodel, jnp.zeros((B, T, S, S, 3)),
                                    seed=21, train=True)
    clips, labels = _inputs(n_steps)
    steps_j = _jax_steps(params, stats, clips, labels, train_what,
                         monkeypatch)
    steps_p = _port_steps(params, stats, clips, labels, train_what,
                          monkeypatch)
    init = from_jax_variables(params, stats)
    for i, ((jp, js, jg, jloss), (state, grads, loss)) in enumerate(
            zip(steps_j, steps_p)):
        assert abs(loss - float(jloss)) <= ATOL + RTOL * abs(float(jloss))
        want = _as_state(jp, js)
        assert set(want) == set(state)
        for key in want:
            _close(state[key], want[key], f"step {i}: {key}")
        jgrads = _as_state(jg, {})
        if train_what == "ft":
            assert set(grads) == set(jgrads)
        else:
            # the probe's optimizer holds the head only; the backbone has
            # no gradient in the port (requires_grad off) and a zeroed
            # update in the JAX package
            assert set(grads) == {"final_fc.weight", "final_fc.bias"}
        for key, g in grads.items():
            _close(g, jgrads[key], f"step {i}: grad {key}")
        if train_what == "last":
            # backbone weights and running statistics exactly as they were,
            # in both packages; the head moved
            for key, val in init.items():
                if key.startswith("backbone."):
                    assert torch.equal(state[key].float(), val), key
                    np.testing.assert_array_equal(
                        want[key].float().numpy(), val.numpy(), err_msg=key)
            assert not torch.equal(state["final_fc.weight"].float(),
                                   init["final_fc.weight"])
    if train_what == "ft":
        # the finetune moved the backbone and its running statistics
        assert not torch.equal(state["backbone.conv1.weight"].float(),
                               init["backbone.conv1.weight"])
        assert not torch.equal(state["backbone.bn1.running_mean"].float(),
                               init["backbone.bn1.running_mean"])
