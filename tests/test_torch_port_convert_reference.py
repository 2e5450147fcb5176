"""Reference torch checkpoints into the port (dualvar_tpu_torch.core.convert),
held against the JAX package's converter on the CPU.

For every backbone family, JAX variables go through the JAX package's
``backbone_to_torch`` (its export in the reference's key grammar) and then
through the port's ``backbone_from_torch``; the result must be bitwise the
port's ``from_jax_variables`` of the same variables. The same for the
classifier (``classifier_to_torch``), and for whole SSL models, whose
reference state_dicts (1x1x1 conv heads, ``(dim, K)`` queues) are built in
the test. The export back (``backbone_to_torch``, ``classifier_to_torch``)
must give the JAX package's export key for key. No reference checkpoint is
in the repo. Last, the CLI writes a store that ``--pretrain`` and the test
protocols read, and ``--reverse`` writes it back in the reference's
format.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.core import convert as JC
from dualvar_tpu.models.backbones import select_backbone as jax_backbone
from dualvar_tpu.models.heads import LinearClassifier as JaxClassifier
from dualvar_tpu.models.ssl import moco as JM
from dualvar_tpu.models.ssl.simclr import SimCLRTimeSeriesV4 as JaxTSV4
from dualvar_tpu_torch.core import convert as C
from dualvar_tpu_torch.core.checkpoint import (load_pretrained_backbone,
                                               load_state_dict)
from dualvar_tpu_torch.core.config import CLASSIFIER_PRESETS, ModelConfig
from dualvar_tpu_torch.core.convert import (backbone_from_torch,
                                            classifier_from_torch,
                                            from_jax_task_state,
                                            from_jax_variables,
                                            ssl_from_torch)
from dualvar_tpu_torch.models.backbones import select_backbone
from dualvar_tpu_torch.models.heads import LinearClassifier
from dualvar_tpu_torch.train import classifier as TC
from dualvar_tpu_torch.train.tasks import make_task

from torch_port_util import moco_numpy_state, numpy_variables

NETS = ("r3d", "r21d", "c3d", "s3d", "s3dg", "r2d3d18", "r50")
T, S = 8, 32


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """The checkpoints these tests write are 0.1-0.2 GB each (R3D-18 and
    its optimizer state); remove them when a test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        assert torch.equal(got[key], val), key


def _variables(module, seed, batch=1):
    return numpy_variables(module, jnp.zeros((batch, T, S, S, 3)), seed=seed,
                           train=False)


@pytest.mark.parametrize("net", NETS)
def test_backbone_from_reference_keys_is_from_jax_variables(net):
    jm, _ = jax_backbone(net)
    params, stats = _variables(jm, seed=len(net))
    reference = JC.backbone_to_torch(params, stats, net)
    assert any(k.endswith("num_batches_tracked") for k in reference)
    if net.startswith("s3d"):
        # the reference's block1..block5 register the same modules again
        reference.update({"block1.0." + k[len("Conv_1a."):]: v
                          for k, v in reference.items()
                          if k.startswith("Conv_1a.")})
    got = backbone_from_torch(reference, net)
    module, _ = select_backbone(net)
    _assert_same(got, from_jax_variables(params, stats, module=module))
    module.load_state_dict(got)  # strict
    # and back: the port's export is the JAX package's, key for key
    _assert_same(C.backbone_to_torch(got, net),
                 _tensors(JC.backbone_to_torch(params, stats, net)))
    # DDP's module. prefix and a pretrain checkpoint's encoder_q.0. root
    wrapped = {"module.encoder_q.0." + k: torch.from_numpy(np.asarray(v))
               for k, v in reference.items()}
    _assert_same(backbone_from_torch(C.extract_backbone_state(wrapped), net),
                 got)


@pytest.mark.parametrize("use_final_bn", [False, True])
def test_classifier_from_reference_keys_is_from_jax_variables(use_final_bn):
    jbb, param = jax_backbone("s3dg")
    jmodel = JaxClassifier(backbone=jbb, feature_size=param["feature_size"],
                           num_class=7, use_dropout=False,
                           use_final_bn=use_final_bn)
    params, stats = numpy_variables(jmodel, jnp.zeros((2, T, S, S, 3)),
                                    seed=4, train=True)
    reference = JC.classifier_to_torch(params, stats, "s3dg")
    got = classifier_from_torch(reference, "s3dg")
    bb, _ = select_backbone("s3dg")
    model = LinearClassifier(bb, 1024, num_class=7, use_dropout=False,
                             use_final_bn=use_final_bn)
    _assert_same(got, from_jax_variables(params, stats, module=model))
    _assert_same(C.classifier_to_torch(got, "s3dg"), _tensors(reference))
    with pytest.raises(ValueError, match="backbone"):
        classifier_from_torch({"encoder_q.0.conv1.weight":
                               torch.zeros(1)}, "s3dg")


def _conv_head(head: dict, prefix: str, i0: int, i1: int) -> dict:
    """A port/flax MLP head as the reference's two 1x1x1 Conv3d layers."""
    out = {}
    for name, idx in (("fc1", i0), ("fc2", i1)):
        k = np.asarray(head[name]["kernel"])
        out[f"{prefix}.{idx}.weight"] = k.T.reshape(*k.T.shape, 1, 1, 1)
        out[f"{prefix}.{idx}.bias"] = np.asarray(head[name]["bias"])
    return out


def _reference_encoder(params, stats, prefix, series, net):
    sd = {f"{prefix}.0.{k}": v for k, v in JC.backbone_to_torch(
        params["backbone"], stats["backbone"], net).items()}
    sd.update(_conv_head(params["clip_head"], prefix, 2, 4))
    sd.update(_conv_head(params["series_head"], series, 0, 2))
    return sd


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def test_ssl_from_reference_simclr_state_dict():
    jm = JaxTSV4(network="c3d")
    params, stats = numpy_variables(jm, jnp.zeros((2, 3, T, S, S, 3)),
                                    seed=5, train=True)
    reference = _tensors(_reference_encoder(
        params, stats, "encoder_q", "series_proj_head", "c3d"))
    reference = {"module." + k: v for k, v in reference.items()}
    got = ssl_from_torch(reference, "c3d")
    task = make_task(ModelConfig(net="c3d", dtype="float32"))
    want = from_jax_variables(params, stats, module=task.model)
    _assert_same(got, want)
    # the JAX importer's trees of the same state_dict, carried over
    jax_out = JC.ssl_from_torch(
        {k: v.numpy() for k, v in reference.items()}, "c3d")
    _assert_same(got, from_jax_variables(jax_out["params"],
                                         jax_out["batch_stats"]))
    with pytest.raises(ValueError, match="encoder_q"):
        ssl_from_torch({"backbone.conv1.weight": torch.zeros(1)}, "c3d")


def test_ssl_from_reference_moco_state_dict():
    K = 32
    enc = JM.MoCoEncoder(network="r2d3d18", dim=128, n_series=2,
                         series_dim=64, with_series=True)
    params, stats, moco = moco_numpy_state(
        enc, jnp.zeros((2, T, S, S, 3)), K=K, seed=9, ptr=12)
    reference = _reference_encoder(params, stats, "encoder_q",
                                   "series_proj_head_q", "r2d3d18")
    reference.update(_reference_encoder(
        moco["params_k"], moco["batch_stats_k"], "encoder_k",
        "series_proj_head_k", "r2d3d18"))
    reference["queue"] = np.asarray(moco["queue"]).T
    reference["series_queue"] = np.asarray(moco["series_queue"]).T
    reference["queue_ptr"] = np.asarray([12], np.int64)
    reference = _tensors(reference)
    got = ssl_from_torch(reference, "r2d3d18")
    task = make_task(ModelConfig(net="r2d3d18", model="moco_timeseriesv4",
                                 moco_k=K, dtype="float32"))
    _assert_same(got, from_jax_task_state(params, stats, moco,
                                          module=task.model))
    task.model.load_state_dict(got)  # strict


def test_cli_writes_a_store_that_pretrain_and_the_protocols_read(tmp_path):
    """A reference pretrain checkpoint (DDP-wrapped, with heads) -> ``--what
    backbone`` -> grafted by the classifier and loaded by ``--pretrain``; a
    reference classifier checkpoint -> ``--what auto`` (classifier) -> read
    by a test protocol's ``--resume``."""
    from dualvar_tpu_torch.train.pretrain import load_pretrain_weights

    jm = JaxTSV4(network="r3d")
    params, stats = numpy_variables(jm, jnp.zeros((2, 3, T, S, S, 3)),
                                    seed=6, train=True)
    reference = _tensors(_reference_encoder(
        params, stats, "encoder_q", "series_proj_head", "r3d"))
    ckpt = tmp_path / "reference_pretrain.pth.tar"
    torch.save({"epoch": 199, "state_dict": {"module." + k: v
                                             for k, v in reference.items()},
                "optimizer": {}}, ckpt)
    out = tmp_path / "converted"
    C.main(["--ckpt", str(ckpt), "--net", "r3d", "--out", str(out)])
    backbone = from_jax_variables(params["backbone"], stats["backbone"])
    state = load_state_dict(str(out))
    assert set(state) == {"backbone." + k for k in backbone}

    clf_cfg = CLASSIFIER_PRESETS["smoke"]
    clf = TC.build_model(clf_cfg)
    grafted, report = load_pretrained_backbone(clf.state_dict(), state)
    assert not report["missing_in_src"] and not report["unused_src"]
    for key, val in backbone.items():
        assert torch.equal(grafted["backbone." + key], val), key

    task = make_task(ModelConfig(net="r3d", dtype="float32"))
    report = load_pretrain_weights(task.model, str(out))
    assert len(report["loaded"]) == len(backbone)
    for key, val in backbone.items():
        assert torch.equal(task.model.state_dict()["backbone." + key], val)

    # a finetuned reference classifier, read by the center-crop protocol
    jclf = JaxClassifier(backbone=jax_backbone("r3d")[0], feature_size=512,
                         num_class=4, use_dropout=False)
    cparams, cstats = numpy_variables(jclf, jnp.zeros((2, 4, S, S, 3)),
                                      seed=8, train=True)
    ref_clf = _tensors(JC.classifier_to_torch(cparams, cstats, "r3d"))
    clf_ckpt = tmp_path / "reference_clf.pth.tar"
    torch.save({"epoch": 3, "state_dict": ref_clf}, clf_ckpt)
    clf_out = tmp_path / "converted_clf"
    C.main(["--ckpt", str(clf_ckpt), "--net", "r3d", "--out", str(clf_out)])
    cfg = dataclasses.replace(
        clf_cfg,
        data=dataclasses.replace(clf_cfg.data, seq_len=4, ds=8, img_dim=S,
                                 scale_hw=(40, 36), synthetic_videos=4,
                                 synthetic_classes=4),
        optim=dataclasses.replace(clf_cfg.optim, batch_size=16),
        run=dataclasses.replace(clf_cfg.run, log_root=str(tmp_path / "log"),
                                resume=str(clf_out)))
    out_metrics = TC.test_multicrop(cfg, "center", device="cpu")
    assert 0.0 <= out_metrics["top1"] <= 1.0
    want = from_jax_variables(cparams, cstats)
    got = load_state_dict(str(clf_out))
    _assert_same(got, want)
    assert os.path.exists(os.path.join(str(clf_out), "best",
                                       "epoch3.pth.tar"))

    # --reverse: the stores back in the reference's format
    exported = tmp_path / "exported_clf.pth.tar"
    C.main(["--reverse", "--ckpt", str(clf_out), "--net", "r3d", "--what",
            "classifier", "--out", str(exported)])
    back = torch.load(exported)
    assert back["epoch"] == 3
    _assert_same(back["state_dict"], ref_clf)
    exported = tmp_path / "exported_backbone.pth.tar"
    C.main(["--reverse", "--ckpt", str(out), "--net", "r3d", "--out",
            str(exported)])
    _assert_same(torch.load(exported)["state_dict"], {
        k: v for k, v in reference.items() if k.startswith("encoder_q.0.")})
