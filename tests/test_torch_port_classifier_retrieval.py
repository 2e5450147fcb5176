"""The classifier's temporal 10-clip protocol and k-NN retrieval through the
port's protocol functions and the JAX package's, on the same tiny synthetic
config and the same weights (``torch_port_util.classifier_test_configs``); and the
multi-crop probabilities of both models on the same crops.

Accuracies and R@k must be equal; probabilities, features and similarities
within 1e-5 (float32 R3D forwards that sum in another order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.aug import pipeline as JP
from dualvar_tpu.train import classifier as JC
from dualvar_tpu_torch.aug.pipeline import (AugConfig, tenclip_batch,
                                            tencrop_batch)
from dualvar_tpu_torch.train import classifier as TC

from torch_port_util import classifier_test_configs

ATOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return classifier_test_configs(tmp_path_factory.mktemp("retrieval"))


def test_temporal_tenclip_matches_jax(setup):
    jcfg, pcfg, jmodel, variables, model = setup
    want = JC.test_temporal_tenclip(jcfg)
    got = TC.test_temporal_tenclip(pcfg, device="cpu")
    assert got["top1"] == want["top1"] and got["top5"] == want["top5"]
    assert got["classwise"] == want["classwise"]
    with open(os.path.join(TC.set_path(pcfg),
                           "prob-temporal_10_clip.json")) as f:
        assert json.load(f)["top1"] == got["top1"]
    # the per-video probabilities behind them, first two videos
    ds = TC.tenclip_dataset(pcfg, "test")
    frames = np.stack([ds(i, None)["frames"] for i in range(2)])
    clips = tenclip_batch(torch.from_numpy(frames),
                          AugConfig(img_dim=32, seq_len=4))
    logit, _ = TC._forward(model, clips.reshape(20, *clips.shape[2:]),
                           torch.float32)
    jclips = JP.tenclip_batch(jnp.asarray(frames),
                              JP.AugConfig(img_dim=32, seq_len=4))
    jlogit, _ = jmodel.apply(variables, jclips.reshape(20, *jclips.shape[2:]),
                             train=False)
    np.testing.assert_allclose(
        logit.softmax(-1).reshape(2, 10, -1).mean(1).numpy(),
        np.asarray(jax.nn.softmax(jlogit)).reshape(2, 10, -1).mean(1),
        atol=ATOL, rtol=0)


def _test_frames(cfg, n=2):
    ds = TC.classifier_dataset(cfg, "test")
    return np.stack([ds(i, np.random.default_rng(i))["frames"]
                     for i in range(n)])


@pytest.mark.parametrize("flip", [False, True])
def test_multicrop_probabilities_match_jax(setup, flip):
    jcfg, pcfg, jmodel, variables, model = setup
    frames = _test_frames(pcfg)
    acfg = AugConfig(img_dim=32, seq_len=4)
    jacfg = JP.AugConfig(img_dim=32, seq_len=4)
    for where in range(1, 6):
        logit, _ = TC._forward(
            model, tencrop_batch(torch.from_numpy(frames), acfg, where, flip),
            torch.float32)
        jlogit, _ = jmodel.apply(variables, JP.tencrop_batch(
            jnp.asarray(frames), jacfg, where, flip), train=False)
        np.testing.assert_allclose(
            logit.softmax(-1).numpy(), np.asarray(jax.nn.softmax(jlogit)),
            atol=ATOL, rtol=0, err_msg=f"where={where}")


def _dumps(cfg, set_path):
    d = os.path.join(set_path(cfg), cfg.dirname)
    return {name: np.load(os.path.join(d, name)) for name in os.listdir(d)
            if name.endswith(".npy")}, d


def test_retrieval_matches_jax(setup):
    jcfg, pcfg, _, _, _ = setup
    want = JC.test_retrieval(jcfg)
    got = TC.test_retrieval(pcfg, device="cpu")
    assert got == want
    assert set(got) == {"R@1", "R@5", "R@10", "R@20", "R@50"}
    # the same artifact set, the same values
    jdump, _ = _dumps(jcfg, JC.set_path)
    pdump, pdir = _dumps(pcfg, TC.set_path)
    assert set(pdump) == set(jdump) == {
        f"ucf101_{s}_{k}.npy" for s in ("test", "train")
        for k in ("feature", "per_feature", "label")} | {"ucf101_sim.npy"}
    for name, val in jdump.items():
        if name.endswith("label.npy"):
            np.testing.assert_array_equal(pdump[name], val)
        else:
            assert pdump[name].dtype == np.float32, name
            np.testing.assert_allclose(pdump[name], val, atol=ATOL, rtol=0,
                                       err_msg=name)
    for split in ("test", "train"):
        with open(os.path.join(pdir, f"ucf101_{split}_vname.json")) as f:
            assert len(json.load(f)) == pcfg.data.synthetic_videos
    with open(os.path.join(pdir, "retrieval.json")) as f:
        assert json.load(f) == got
