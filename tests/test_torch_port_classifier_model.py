"""The port's ``LinearClassifier`` against the JAX package's, its weights
carried over by ``from_jax_variables``, and the pretrained-backbone graft
(``core/checkpoint.py``) against JAX ``merge_matching_leaves`` /
``load_pretrained_backbone``.

Tiny inputs (R3D-18 at full width on 4x32x32 clips, B=4), weights drawn by
numpy from a seed (``torch_port_util.numpy_variables``). Forward outputs and
running statistics within 2e-4, the backbone forward band of the JAX suite's
torch oracles (tests/test_torch_parity.py).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from dualvar_tpu.core.checkpoint import load_pretrained_backbone as jax_graft
from dualvar_tpu.core.checkpoint import merge_matching_leaves as jax_merge
from dualvar_tpu.models.backbones import select_backbone as jax_backbone
from dualvar_tpu.models.heads import LinearClassifier as JaxClassifier
from dualvar_tpu_torch.core.checkpoint import (checkpoint_file,
                                               load_pretrained_backbone,
                                               load_state_dict,
                                               merge_matching_leaves)
from dualvar_tpu_torch.core.convert import from_jax_variables
from dualvar_tpu_torch.models.backbones import select_backbone
from dualvar_tpu_torch.models.heads import LinearClassifier
from dualvar_tpu_torch.models.ssl.moco import MoCo
from dualvar_tpu_torch.models.ssl.simclr import SimCLRTimeSeriesV4

from torch_port_util import numpy_variables

B, T, S, NUM_CLASS = 4, 4, 32, 5
ATOL = 2e-4


def _jax_model(use_l2_norm, use_final_bn):
    backbone, param = jax_backbone("r3d")
    return JaxClassifier(backbone=backbone,
                         feature_size=param["feature_size"],
                         num_class=NUM_CLASS, use_dropout=False,
                         use_l2_norm=use_l2_norm, use_final_bn=use_final_bn)


def _port_model(use_l2_norm, use_final_bn):
    backbone, param = select_backbone("r3d")
    return LinearClassifier(backbone, param["feature_size"],
                            num_class=NUM_CLASS, use_dropout=False,
                            use_l2_norm=use_l2_norm,
                            use_final_bn=use_final_bn)


def _variables(model, seed=3):
    return numpy_variables(model, jnp.zeros((B, T, S, S, 3)), seed=seed,
                           train=True)


def _clips(seed=7):
    return np.random.default_rng(seed).normal(
        size=(B, T, S, S, 3)).astype(np.float32)


@pytest.mark.parametrize("use_l2_norm,use_final_bn",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_forward_matches_jax_in_train_and_eval_mode(use_l2_norm,
                                                    use_final_bn):
    jmodel = _jax_model(use_l2_norm, use_final_bn)
    params, stats = _variables(jmodel)
    x = _clips()
    for train in (True, False):
        model = _port_model(use_l2_norm, use_final_bn)
        model.load_state_dict(from_jax_variables(params, stats, model))
        model.train(train)
        with torch.no_grad():
            logit, feat = model(torch.from_numpy(x))
        (jlogit, jfeat), upd = jmodel.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            train=train, mutable=["batch_stats"])
        np.testing.assert_allclose(logit.numpy(), np.asarray(jlogit),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat),
                                   atol=ATOL, rtol=0)
        if use_l2_norm:
            np.testing.assert_allclose(feat.norm(dim=1).numpy(), 1.0,
                                       atol=1e-6)
        # every running statistic, final_bn's included, as JAX leaves them
        # (eval mode: unchanged in both)
        want = from_jax_variables(params, upd.get("batch_stats", stats))
        for key, val in model.state_dict().items():
            if "running_" in key:
                np.testing.assert_allclose(val.numpy(), want[key].numpy(),
                                           atol=ATOL, rtol=0, err_msg=key)
        if use_final_bn and train:
            assert not torch.equal(model.final_bn.running_mean,
                                   torch.from_numpy(np.asarray(
                                       stats["final_bn"]["mean"])))


def test_convert_fills_every_key_of_the_classifier():
    jmodel = _jax_model(False, True)
    params, stats = _variables(jmodel)
    model = _port_model(False, True)
    state = from_jax_variables(params, stats, model)  # checks keys, shapes
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(state["final_fc.weight"].numpy(),
                                  params["final_fc"]["kernel"].T)
    np.testing.assert_array_equal(state["final_bn.weight"].numpy(),
                                  params["final_bn"]["scale"])
    np.testing.assert_array_equal(state["final_bn.running_var"].numpy(),
                                  stats["final_bn"]["var"])
    # a leaf too many, or one missing, is refused
    extra = copy.deepcopy(params)
    extra["final_fc"]["extra"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError):
        from_jax_variables(extra, stats, model)
    short = copy.deepcopy(params)
    del short["final_bn"]
    with pytest.raises(KeyError):
        from_jax_variables(short, stats, model)


def test_fresh_head_init():
    torch.manual_seed(0)
    model = _port_model(False, False)
    w = model.final_fc.weight.detach()
    assert torch.equal(model.final_fc.bias, torch.zeros(NUM_CLASS))
    assert abs(float(w.std()) - 0.01) < 1e-3 and abs(float(w.mean())) < 1e-3
    assert not hasattr(model, "final_bn")


def _pretrain_trees(params, stats):
    """A pretrain variable tree built from a classifier's backbone: one
    leaf with another shape, one leaf the classifier lacks, a head the
    classifier lacks, and other values than the classifier's."""
    def shifted(tree):
        return unflatten_dict({k: v + np.float32(0.5)
                               for k, v in flatten_dict(tree).items()})

    rng = np.random.default_rng(11)
    pre_params = {"backbone": shifted(params["backbone"]),
                  "clip_head": {"fc1": {
                      "kernel": rng.normal(size=(512, 8)).astype(np.float32),
                      "bias": np.zeros(8, np.float32)}}}
    pre_stats = {"backbone": shifted(stats["backbone"])}
    pre_params["backbone"]["bn1"]["bn"]["scale"] = np.ones(32, np.float32)
    pre_params["backbone"]["extra"] = {
        "kernel": np.ones((4, 4), np.float32)}
    return pre_params, pre_stats


def _counts(report):
    return {k: len(v) for k, v in report.items()}


def test_graft_report_matches_jax_merge_matching_leaves():
    jmodel = _jax_model(False, False)
    params, stats = _variables(jmodel)
    pre_params, pre_stats = _pretrain_trees(params, stats)

    want = {"loaded": 0, "missing_in_src": 0, "unused_src": 0}
    for dst, src in ((params["backbone"], pre_params["backbone"]),
                     (stats["backbone"], pre_stats["backbone"])):
        _, rep = jax_merge(dst, src)
        for k in want:
            want[k] += len(rep[k])
    grafted_jax = jax_graft({"params": params, "batch_stats": stats},
                            {"params": pre_params, "batch_stats": pre_stats})

    model = _port_model(False, False)
    init = from_jax_variables(params, stats, model)
    pre_state = from_jax_variables(pre_params, pre_stats)
    state, report = load_pretrained_backbone(init, pre_state)
    assert _counts(report) == want
    assert want["missing_in_src"] == 1 and want["unused_src"] == 2
    assert report["missing_in_src"] == ["backbone.bn1.weight"]
    assert sorted(report["unused_src"]) == [
        "backbone.bn1.weight (shape (32,) vs (64,))",
        "backbone.extra.weight"]
    # the grafted state equals the JAX graft's, leaf for leaf
    expect = from_jax_variables(grafted_jax["params"],
                                grafted_jax["batch_stats"], model)
    assert set(state) == set(expect)
    for key in state:
        assert torch.equal(state[key], expect[key]), key
    assert torch.equal(state["backbone.bn1.weight"],
                       init["backbone.bn1.weight"])
    assert torch.equal(state["final_fc.weight"], init["final_fc.weight"])

    # strict=True refuses the mismatch in both packages
    with pytest.raises(ValueError, match="strict"):
        load_pretrained_backbone(init, pre_state, strict=True)
    with pytest.raises(ValueError, match="strict"):
        jax_merge(params["backbone"], pre_params["backbone"], strict=True)
    # and passes where the trees match
    exact = {k: v for k, v in pre_state.items()
             if k.startswith("backbone.") and k in init
             and v.shape == init[k].shape}
    exact["backbone.bn1.weight"] = init["backbone.bn1.weight"]
    _, rep = merge_matching_leaves(
        {k: v for k, v in init.items() if k.startswith("backbone.")}, exact,
        strict=True)
    assert not rep["missing_in_src"] and not rep["unused_src"]


def _check_grafted(state, report, backbone_state):
    assert not report["missing_in_src"] and not report["unused_src"]
    assert len(report["loaded"]) == len(backbone_state)
    for key, val in backbone_state.items():
        assert torch.equal(state["backbone." + key], val), key


def test_graft_from_simclr_and_moco_port_checkpoints(tmp_path):
    torch.manual_seed(0)
    clf = _port_model(False, False)
    init = clf.state_dict()

    simclr = SimCLRTimeSeriesV4(network="r3d")
    path = tmp_path / "simclr" / "model"
    path.mkdir(parents=True)
    for epoch in (4, 12):  # the directory's newest epoch is taken
        with torch.no_grad():
            for p in simclr.parameters():
                p.add_(0.01)
        torch.save({"epoch": epoch, "state_dict": simclr.state_dict()},
                   path / f"epoch{epoch}.pth.tar")
    assert checkpoint_file(str(path)).endswith("epoch12.pth.tar")
    state, report = load_pretrained_backbone(init,
                                             load_state_dict(str(path)))
    _check_grafted(state, report, simclr.backbone.state_dict())
    assert torch.equal(state["final_fc.weight"], init["final_fc.weight"])

    moco = MoCo(network="r3d", K=8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in moco.encoder_k.parameters():
            p.add_(1.0)  # the key encoder must not be the one grafted
    file = tmp_path / "moco.pth.tar"
    torch.save({"epoch": 0, "state_dict": moco.state_dict()}, file)
    state, report = load_pretrained_backbone(init, load_state_dict(str(file)))
    _check_grafted(state, report, moco.encoder_q.backbone.state_dict())

    with pytest.raises(KeyError, match="no backbone"):
        load_pretrained_backbone(init, {"clip_head.fc1.weight":
                                        torch.zeros(2, 2)})
    with pytest.raises(FileNotFoundError):
        checkpoint_file(str(tmp_path))


def test_eval_step_sums_equal_the_jax_masked_sums():
    """The port's eval step on a short batch against the JAX eval step on
    the same batch padded to the static size with mask-0 rows."""
    from dualvar_tpu.aug.pipeline import AugConfig as JaxAugConfig
    from dualvar_tpu.train.classifier import make_eval_step as jax_eval_step
    from dualvar_tpu_torch.aug.pipeline import AugConfig
    from dualvar_tpu_torch.train.classifier import make_eval_step

    jmodel = _jax_model(False, True)
    params, stats = _variables(jmodel)
    rng = np.random.default_rng(9)
    n = B - 1  # one row short of the static batch
    frames = rng.integers(0, 256, (n, T, 40, 36, 3), dtype=np.uint8)
    labels = np.array([0, 3, 4], np.int32)
    pad = lambda a: np.concatenate([a, a[-1:]])
    want = jax_eval_step(jmodel, JaxAugConfig(img_dim=S, seq_len=T))(
        params, stats, jnp.asarray(pad(frames)), jnp.asarray(pad(labels)),
        jnp.asarray([1.0] * n + [0.0]))
    model = _port_model(False, True)
    model.load_state_dict(from_jax_variables(params, stats, model))
    got = make_eval_step(model, AugConfig(img_dim=S, seq_len=T))(
        torch.from_numpy(frames), torch.from_numpy(labels))
    assert float(got["n"]) == float(want["n"]) == n
    for key in ("loss", "top1", "top5"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


def test_dropout_rate_scale_and_off_outside_finetune_training():
    """Dropout (off in every comparison with JAX above): in train mode about
    ``rate`` of the head's inputs are zeroed and the kept ones scaled by
    1/keep, the mask drawn from the generator; in eval mode and in a
    ``'last'`` (probe) train step it is off, so the head sees the pooled
    feature as it is; in an ``'ft'`` train step it is on."""
    from dualvar_tpu_torch.aug.pipeline import AugConfig
    from dualvar_tpu_torch.train.classifier import (make_train_step,
                                                    trainable_parameters)

    rate = 0.3
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        backbone, param = select_backbone("r3d")
        model = LinearClassifier(backbone, param["feature_size"],
                                 num_class=NUM_CLASS, dropout_rate=rate,
                                 use_dropout=True)
    heads, feats = [], []
    model.final_fc.register_forward_pre_hook(
        lambda m, args: heads.append(args[0].detach()))
    model.register_forward_hook(lambda m, args, out: feats.append(
        out[1].detach()))
    x = torch.from_numpy(_clips())

    model.train()
    with torch.no_grad():
        model(x, generator=torch.Generator().manual_seed(1))
        model(x, generator=torch.Generator().manual_seed(1))
    h, feat = heads[-1], feats[-1]
    assert torch.equal(heads[-2], h)  # the generator decides the mask
    live = feat != 0
    kept = (h != 0) & live
    # B x 512 = 2048 draws: the kept share's sd is about 0.01
    assert abs(float(kept.sum() / live.sum()) - (1 - rate)) < 0.05
    torch.testing.assert_close(h[kept], feat[kept] / (1 - rate),
                               atol=1e-6, rtol=1e-6)

    # the same weights and running statistics, no dropout
    plain = copy.deepcopy(model)
    plain.use_dropout = False
    model.eval()
    plain.eval()
    with torch.no_grad():
        want = plain(x)  # the copy carries the hooks: run it first
        got = model(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(heads[-1], feats[-1])

    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.integers(0, 256, (B, T, 40, 36, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(np.array([0, 1, 2, 3]))
    aug_cfg = AugConfig(img_dim=S, seq_len=T)
    for train_what, dropped in (("last", False), ("ft", True)):
        opt = torch.optim.SGD(trainable_parameters(model, train_what),
                              lr=0.0)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0)
        step = make_train_step(model, opt, sched, aug_cfg, train_what)
        step(frames, labels, torch.Generator().manual_seed(2))
        h, feat = heads[-1], feats[-1]
        assert model.training == dropped
        assert bool(((h == 0) & (feat != 0)).any()) == dropped, train_what
        if not dropped:
            assert torch.equal(h, feat)
