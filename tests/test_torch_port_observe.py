"""The port's observability surface against the JAX package on the CPU:
``core/utils.py:batch_denorm``, ``core/metrics_writer.py:MetricsWriter``,
the models' ``get_features``, the pretrain trainer's ``visualize`` and
``profile_steps``, and the metrics both trainers write.

``get_features`` is held against JAX's on the same numpy-made weights and
clip (B=1, T=4, 32x32, as ``tests/test_visualize.py``) at the backbone band
(atol 2e-4, rtol 1e-3); the writers' lines, tags and file names exactly.
"""

import dataclasses
import glob
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.core.metrics_writer import MetricsWriter as JaxWriter
from dualvar_tpu.core.utils import batch_denorm as jax_batch_denorm
from dualvar_tpu.models.ssl.moco import MoCoEncoder as JaxMoCoEncoder
from dualvar_tpu.models.ssl.simclr import SimCLRNaked as JaxNaked
from dualvar_tpu.models.ssl.simclr import SimCLRTimeSeriesV4 as JaxTSV4
from dualvar_tpu_torch.aug import functional as F
from dualvar_tpu_torch.core.config import (CLASSIFIER_PRESETS,
                                           PRETRAIN_PRESETS, ModelConfig)
from dualvar_tpu_torch.core.convert import from_jax_variables
from dualvar_tpu_torch.core.metrics_writer import MetricsWriter
from dualvar_tpu_torch.core.utils import batch_denorm
from dualvar_tpu_torch.models.ssl.moco import MoCoEncoder
from dualvar_tpu_torch.models.ssl.simclr import (SimCLRNaked,
                                                 SimCLRTimeSeriesV4)
from dualvar_tpu_torch.train import classifier as TC
from dualvar_tpu_torch.train import pretrain as TP

from torch_port_util import BACKBONE_ATOL, BACKBONE_RTOL, numpy_variables

T, S = 4, 32


def test_batch_denorm_inverts_normalize_and_matches_jax():
    x = np.random.default_rng(0).uniform(size=(2, T, 8, 8, 3)).astype(
        np.float32)  # channels-last, as the JAX package's clips
    normed = F.normalize(torch.from_numpy(x)).permute(0, 4, 1, 2, 3)
    got = batch_denorm(normed)  # NCTHW
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), x,
                               atol=1e-6)
    want = jax_batch_denorm(jnp.asarray(normed.permute(0, 2, 3, 4, 1)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want), atol=1e-7)


def _write_both(log_dir):
    """The same scalars and images through both packages' writers."""
    rng = np.random.default_rng(1)
    images = {"vis/sample0/input": rng.uniform(size=(16, 16, 3)),
              "gray_map": rng.uniform(size=(8, 8)).astype(np.float32),
              "u8": np.zeros((4, 4, 3), np.uint8),
              "one channel": rng.uniform(size=(5, 6, 1))}
    for cls, sub in ((JaxWriter, "jax"), (MetricsWriter, "port")):
        w = cls(os.path.join(log_dir, sub), use_tensorboard=False)
        w.add_scalar("local/clip_loss", 1.5, 3)
        w.add_scalar("global/clip_acc", np.float32(0.25), 0)
        for step, (tag, img) in enumerate(images.items()):
            w.add_image(tag, img, step)
        if cls is MetricsWriter:  # a tensor goes through the host
            w.add_image("tensor", torch.from_numpy(images["gray_map"]), 9)
        w.close()


def test_metrics_writer_lines_and_images_match_jax(tmp_path):
    _write_both(str(tmp_path))
    lines = {}
    for sub in ("jax", "port"):
        with open(tmp_path / sub / "metrics.jsonl") as fh:
            lines[sub] = [json.loads(line) for line in fh]
    assert [set(x) for x in lines["port"]] == [{"tag", "value", "step",
                                                "ts"}] * 2
    strip = [[{k: v for k, v in x.items() if k != "ts"} for x in lines[s]]
             for s in ("jax", "port")]
    assert strip[0] == strip[1] == [
        {"tag": "local/clip_loss", "value": 1.5, "step": 3},
        {"tag": "global/clip_acc", "value": 0.25, "step": 0}]
    from PIL import Image

    names = sorted(os.listdir(tmp_path / "port" / "img"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "img")
                           + ["tensor_9.png"])
    assert "vis_sample0_input_0.png" in names
    for name in os.listdir(tmp_path / "jax" / "img"):
        a = np.asarray(Image.open(tmp_path / "jax" / "img" / name))
        b = np.asarray(Image.open(tmp_path / "port" / "img" / name))
        assert np.array_equal(a, b), name
    b = np.asarray(Image.open(tmp_path / "port" / "img" / "tensor_9.png"))
    assert np.array_equal(b, np.asarray(
        Image.open(tmp_path / "port" / "img" / "gray_map_1.png")))


def test_metrics_writer_falls_back_to_npy_without_pillow(tmp_path,
                                                         monkeypatch):
    """With pillow not importable both writers dump ``.npy`` files of the
    uint8 image under the same names."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    _write_both(str(tmp_path))
    jax_names = sorted(os.listdir(tmp_path / "jax" / "img"))
    assert jax_names and all(n.endswith(".npy") for n in jax_names)
    assert sorted(os.listdir(tmp_path / "port" / "img")) == sorted(
        jax_names + ["tensor_9.npy"])
    for name in jax_names:
        a = np.load(tmp_path / "jax" / "img" / name)
        b = np.load(tmp_path / "port" / "img" / name)
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


def _features_pair(kind):
    """(JAX maps, port maps, port model) for one model family on the same
    numpy-made weights and clip."""
    x = np.random.default_rng(2).uniform(size=(1, T, S, S, 3)).astype(
        np.float32)
    if kind == "moco":
        jm = JaxMoCoEncoder(network="r21d")
        params, stats = numpy_variables(jm, jnp.asarray(x), seed=3,
                                        train=True)
        want = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), False,
                        method=JaxMoCoEncoder.get_features)
        model = MoCoEncoder(network="r21d")
    else:
        jcls, cls, views = {"naked": (JaxNaked, SimCLRNaked, 2),
                            "tsv4": (JaxTSV4, SimCLRTimeSeriesV4, 3)}[kind]
        jm = jcls(network="r21d")
        block = jnp.tile(jnp.asarray(x)[:, None], (1, views, 1, 1, 1, 1))
        params, stats = numpy_variables(jm, block, seed=3, train=True)
        want = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), train=False,
                        method=jcls.get_features)
        model = cls(network="r21d")
    model.load_state_dict(from_jax_variables(params, stats, module=model))
    model.train()
    got = model.get_features(torch.from_numpy(x))
    return [np.asarray(w) for w in want], got, model


@pytest.mark.parametrize("kind", ["naked", "tsv4", "moco"])
def test_get_features_match_jax(kind):
    """Per-stage channel-mean maps (B, T', H', W') of the four r21d
    stages, in eval mode and without a gradient; the model's mode is kept."""
    want, got, model = _features_pair(kind)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dim() == 4 and tuple(g.shape) == w.shape
        assert not g.requires_grad and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=BACKBONE_ATOL,
                                   rtol=BACKBONE_RTOL)
    assert model.training and model.backbone.training


def _visualize_cfg(log_root, net="r21d"):
    cfg = PRETRAIN_PRESETS["smoke_dualvar"]
    return cfg.replace(
        data=dataclasses.replace(cfg.data, seq_len=T, img_dim=S,
                                 scale_hw=(40, 36), workers=2,
                                 synthetic_videos=8),
        model=ModelConfig(net=net, model="simclr_timeseriesv4",
                          dtype="float32"),
        run=dataclasses.replace(cfg.run, log_root=str(log_root)))


def test_visualize_writes_the_jax_file_names(tmp_path):
    """``visualize`` as the JAX package's ``--visualize`` (its test,
    tests/test_visualize.py): the input frame and one map a stage for each
    sample, as PNGs under ``{exp}/img/``, named as JAX names them."""
    from PIL import Image

    from dualvar_tpu.core.config import PRETRAIN_PRESETS as JAX_PRESETS
    from dualvar_tpu.core.config import ModelConfig as JaxModelConfig
    from dualvar_tpu.train.pretrain import set_path as jax_set_path

    written = TP.visualize(_visualize_cfg(tmp_path), n_samples=2,
                           device="cpu")
    assert len(written) == 2 * (1 + 4)
    assert all(os.path.exists(p) for p in written)
    exp = TP.set_path(_visualize_cfg(tmp_path), create=False)
    on_disk = sorted(glob.glob(os.path.join(exp, "img", "*.png")))
    assert on_disk == sorted(written)
    jcfg = JAX_PRESETS["smoke_dualvar"]
    jcfg = jcfg.replace(
        model=JaxModelConfig(net="r21d", model="simclr_timeseriesv4",
                             dtype="float32"),
        run=dataclasses.replace(jcfg.run, log_root=str(tmp_path)))
    # the JAX trainer's names, relative to its own experiment path
    jax_exp = jax_set_path(jcfg)
    want = sorted([f"vis_sample{i}_input_0.png" for i in range(2)]
                  + [f"vis_sample{i}_stage{s}_0.png" for i in range(2)
                     for s in range(4)])
    assert sorted(os.path.basename(p) for p in written) == want
    assert os.path.relpath(exp, str(tmp_path)) == os.path.relpath(
        jax_exp, str(tmp_path))
    img = np.asarray(Image.open(os.path.join(exp, "img",
                                             "vis_sample0_input_0.png")))
    assert img.shape == (S, S, 3) and img.dtype == np.uint8
    stage = np.asarray(Image.open(os.path.join(
        exp, "img", "vis_sample0_stage0_0.png")))
    assert stage.ndim == 2 and stage.max() == 255  # min-max scaled

    with pytest.raises(ValueError, match="multi_level"):
        TP.visualize(_visualize_cfg(tmp_path, net="r3d"), device="cpu")


def test_visualize_needs_pillow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="pillow"):
        TP.visualize(_visualize_cfg(tmp_path), device="cpu")


def _smoke_pretrain_cfg(log_root):
    cfg = PRETRAIN_PRESETS["smoke"]
    return cfg.replace(
        data=dataclasses.replace(cfg.data, seq_len=T, img_dim=S,
                                 scale_hw=(40, 36), workers=2,
                                 synthetic_videos=8),
        optim=dataclasses.replace(cfg.optim, batch_size=2, epochs=1),
        run=dataclasses.replace(cfg.run, log_root=str(log_root),
                                print_freq=1))


def _tags(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _trace_convs(cfg):
    """The convolution events of the run's profiler trace."""
    path = os.path.join(TP.set_path(cfg, create=False), "img", "profile",
                        "rank0.pt.trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sum(e.get("name") == "aten::conv3d" for e in events)


def test_pretrain_profile_steps_and_metrics(tmp_path):
    """``profile_steps=2`` traces steps 1 and 2 of 4 (the JAX trainer's
    window) into ``{exp}/img/profile``, a Chrome trace of the CPU's ops;
    ``metrics.jsonl`` holds ``local/<metric>`` at every logged step and
    ``global/<name>_loss``, ``global/<name>_acc`` at the epoch's end, as
    the JAX trainer writes them."""
    cfg = _smoke_pretrain_cfg(tmp_path)
    metrics = TP.train(cfg, max_steps=4, device="cpu", profile_steps=2)
    assert _trace_convs(cfg) > 0
    exp = TP.set_path(cfg, create=False)
    lines = _tags(os.path.join(exp, "img", "pretrain", "metrics.jsonl"))
    local = [x for x in lines if x["tag"].startswith("local/")]
    assert {x["tag"] for x in local} == {f"local/{k}" for k in metrics}
    assert sorted({x["step"] for x in local}) == [0, 1, 2, 3]
    last = {x["tag"][6:]: x["value"] for x in local if x["step"] == 3}
    assert last == pytest.approx(metrics)
    glob_tags = {x["tag"] for x in lines if x["tag"].startswith("global/")}
    losses = {k[:-5] for k in metrics if k.endswith("_loss")}
    accs = {k[:-5] for k in metrics if k.endswith("top1")}
    assert glob_tags == {f"global/{k}_loss" for k in losses} | {
        f"global/{k}_acc" for k in accs}
    assert "global/clip_loss" in glob_tags and "global/clip_acc" in glob_tags


def test_profile_window_counts_steps_and_ends_with_the_run(tmp_path):
    """A window of 2 steps holds twice the convolutions of a window of 1;
    a window past the run's end writes the one step it traced."""
    counts = []
    for name, max_steps, window in (("two", 4, 2), ("past_end", 2, 5)):
        cfg = _smoke_pretrain_cfg(tmp_path / name)
        TP.train(cfg, max_steps=max_steps, device="cpu", profile_steps=window)
        counts.append(_trace_convs(cfg))
    assert counts[1] > 0 and counts[0] == 2 * counts[1]


def test_classifier_writes_local_and_val_metrics(tmp_path):
    cfg = CLASSIFIER_PRESETS["smoke"]
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, seq_len=T, img_dim=S,
                                      scale_hw=(40, 36), workers=2,
                                      synthetic_videos=4),
        optim=dataclasses.replace(cfg.optim, batch_size=2),
        run=dataclasses.replace(cfg.run, log_root=str(tmp_path),
                                print_freq=1))
    final = TC.train(cfg, max_steps=2, device="cpu")
    exp = TC.set_path(cfg, create=False)
    lines = _tags(os.path.join(exp, "img", "train", "metrics.jsonl"))
    assert [(x["tag"], x["step"]) for x in lines] == [
        ("local/loss", 0), ("local/top1", 0), ("local/top5", 0),
        ("local/loss", 1), ("local/top1", 1), ("local/top5", 1),
        ("val/top1", 0)]
    assert lines[-1]["value"] == pytest.approx(final["val_top1"])
