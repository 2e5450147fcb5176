"""The serving export (``dualvar_tpu_torch/export.py``) against the JAX
package's ``dualvar_tpu/export.py`` on the CPU.

The classifier is the ``smoke`` preset's (R3D, 4 classes, float32) at the
port tests' small clip size (T=4, 32x32 crops of 40x36 frames), with
numpy-made weights carried across by ``from_jax_variables``; frames are
numpy-made uint8. ``make_serving_fn`` is held against JAX's at the band of
the classifier forward (``tests/test_torch_port_classifier_model.py``:
2e-4 for logits and features, 1e-5 for the probabilities); the exported
artifact, saved and loaded, against the eager function bitwise (the same
CPU kernels run), and in a process that imports torch only.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.aug.pipeline import AugConfig as JaxAugConfig
from dualvar_tpu.core.config import CLASSIFIER_PRESETS as JAX_PRESETS
from dualvar_tpu.export import make_serving_fn as jax_serving_fn
from dualvar_tpu.train.classifier import build_model as jax_build_model
from dualvar_tpu_torch.aug.pipeline import AugConfig
from dualvar_tpu_torch.core.checkpoint import CheckpointStore
from dualvar_tpu_torch.core.config import CLASSIFIER_PRESETS
from dualvar_tpu_torch.core.convert import (classifier_to_torch,
                                            from_jax_variables)
from dualvar_tpu_torch.export import (export_serving, load_serving, main,
                                      make_serving_fn)
from dualvar_tpu_torch.train.classifier import build_model

from torch_port_util import TORCH_THREADS, numpy_variables

T, D, HW = 4, 32, (40, 36)
ATOL, RTOL = 2e-4, 1e-3


def _tiny(cfg):
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, seq_len=T, img_dim=D, scale_hw=HW))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, port model in eval mode) with the same
    numpy-made weights."""
    jcfg = _tiny(JAX_PRESETS["smoke"])
    jmodel = jax_build_model(jcfg)
    params, stats = numpy_variables(jmodel, jnp.zeros((1, T, D, D, 3)),
                                    seed=41, train=False)
    model = build_model(_tiny(CLASSIFIER_PRESETS["smoke"]))
    model.load_state_dict(from_jax_variables(params, stats, module=model))
    return jmodel, {"params": params, "batch_stats": stats}, model.eval()


def _frames(n_clips, batch=2, seed=0, hw=HW, t=T):
    return np.random.default_rng(seed).integers(
        0, 256, (batch, n_clips * t, *hw, 3), dtype=np.uint8)


@pytest.mark.parametrize("ten_clip", [False, True], ids=["single", "ten"])
def test_serving_fn_matches_jax(pair, ten_clip):
    jmodel, variables, model = pair
    frames = _frames(10 if ten_clip else 1, seed=1)
    want = jax_serving_fn(jmodel, variables, JaxAugConfig(img_dim=D,
                                                          seq_len=T),
                          ten_clip=ten_clip)(jnp.asarray(frames))
    with torch.no_grad():
        got = make_serving_fn(model, AugConfig(img_dim=D, seq_len=T),
                              ten_clip=ten_clip)(torch.from_numpy(frames))
    for name, g, w, atol in zip(("probs", "logits", "feat"), got, want,
                                (1e-5, ATOL, ATOL)):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=RTOL, err_msg=name)
    probs, logits = got[0], got[1]
    assert probs.shape == (2, 4)
    np.testing.assert_allclose(probs.sum(dim=1).numpy(), 1.0, atol=1e-6)
    if ten_clip:
        # the clip-averaged probabilities are the mean of the per-clip
        # softmax (the temporal ten-clip protocol)
        assert torch.allclose(probs, logits.softmax(-1).mean(1), atol=1e-7)


_FRESH = """
import sys, torch
path, frames_path, out_path = sys.argv[1:]
served = torch.export.load(path).module()
with torch.inference_mode():
    out = served(torch.load(frames_path))
torch.save([o.clone() for o in out], out_path)
bad = sorted(m for m in sys.modules if m.startswith("dualvar_tpu"))
assert not bad, bad
"""


@pytest.mark.parametrize("ten_clip", [False, True], ids=["single", "ten"])
def test_export_save_load_equals_eager_in_a_torch_only_process(
        pair, ten_clip, tmp_path):
    _, _, model = pair
    aug = AugConfig(img_dim=D, seq_len=T)
    frames = torch.from_numpy(_frames(10 if ten_clip else 1, seed=2))
    path = str(tmp_path / "serving.pt2")
    program = export_serving(model, aug, tuple(frames.shape), path,
                             ten_clip=ten_clip)
    # the artifact holds the weights, not the (zero) example input
    assert program.example_inputs is None
    assert 0 < os.path.getsize(path) < 1.05 * sum(
        t.numel() * t.element_size() for t in model.state_dict().values())
    with torch.no_grad():
        want = make_serving_fn(model, aug, ten_clip=ten_clip)(frames)
        got = load_serving(path)(frames)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    torch.save(frames, tmp_path / "frames.pt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(TORCH_THREADS)
    run = subprocess.run(
        [sys.executable, "-c", _FRESH, path, str(tmp_path / "frames.pt"),
         str(tmp_path / "out.pt")], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    for g, w in zip(torch.load(tmp_path / "out.pt"), want):
        assert torch.equal(g, w)


def test_cli_from_a_store_a_port_file_and_a_reference_checkpoint(tmp_path,
                                                                  capsys):
    """``python -m dualvar_tpu_torch.export`` at the smoke preset's own
    sizes, from the three checkpoint forms, each artifact equal to the
    eager function of the same weights."""
    cfg = CLASSIFIER_PRESETS["smoke"]
    model = build_model(cfg, seed=3).eval()
    state = model.state_dict()
    store = CheckpointStore(str(tmp_path / "model"), async_save=False)
    store.save(0, {"epoch": 0, "state_dict": state})
    store.close()
    torch.save({"epoch": 0, "state_dict": state}, tmp_path / "port.pth.tar")
    torch.save({"epoch": 0, "state_dict": classifier_to_torch(
        state, cfg.model.net)}, tmp_path / "reference.pth.tar")
    frames = torch.from_numpy(_frames(1, seed=4, hw=cfg.data.scale_hw,
                                      t=cfg.data.seq_len))
    aug = AugConfig(img_dim=cfg.data.img_dim, seq_len=cfg.data.seq_len)
    with torch.no_grad():
        want = make_serving_fn(model, aug)(frames)
    for ckpt, source in ((tmp_path / "model", "checkpoint store"),
                         (tmp_path / "port.pth.tar", "port checkpoint file"),
                         (tmp_path / "reference.pth.tar",
                          "reference checkpoint")):
        out = str(tmp_path / f"{ckpt.name}.pt2")
        main(["--preset", "smoke", "--ckpt", str(ckpt), "--out", out,
              "--batch", "2", "--device", "cpu"])
        assert source in capsys.readouterr().out
        with torch.no_grad():
            got = load_serving(out)(frames)
        for g, w in zip(got, want):
            assert torch.equal(g, w), ckpt.name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--ckpt", str(tmp_path / "model"), "--out",
                  str(tmp_path / "x.pt2")])
