"""The trainers' bfloat16 step on the CPU (``train/tasks.py:step_context``).

oneDNN, the CPU's default convolution route, computes the bfloat16 weight
gradient of R(2+1)D-18's ``layer2_block0.conv2.temporal_conv`` at 4x16x16
clips (input (8, 288, 2, 4, 4), weight (128, 288, 3, 1, 1), padding (1, 0,
0)) as NaN, inf or far off, so a bfloat16 pretrain on the CPU could take a
garbage step. ``step_context`` turns oneDNN off for the forward and the
backward of a CPU bfloat16 step; it changes nothing on CUDA or in float32.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dualvar_tpu_torch.train.tasks import step_context

import torch_port_util  # noqa: F401  (caps torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X_SHAPE, W_SHAPE, PADDING = (8, 288, 2, 4, 4), (128, 288, 3, 1, 1), (1, 0, 0)
# four bfloat16 ulps at 1, of the largest |gradient|: the inputs' rounding
# alone leaves 2.4e-3 and ATen's bfloat16 route 0.7-0.9e-2 (float64
# reference)
BF16_BAND = 4 * 2.0 ** -7
TRIES = 5


def _weight_grad(x, w, g):
    w = w.clone().requires_grad_(True)
    torch.nn.functional.conv3d(x, w, padding=PADDING).backward(g)
    return w.grad


def test_bf16_weight_gradient_of_the_faulty_shape_is_within_band():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(X_SHAPE))
    w = torch.from_numpy(rng.standard_normal(W_SHAPE) / np.sqrt(288 * 3))
    g = torch.from_numpy(rng.standard_normal(
        (X_SHAPE[0], W_SHAPE[0], *X_SHAPE[2:])))
    want = _weight_grad(x, w, g)
    scale = float(want.abs().max())
    for _ in range(TRIES):
        with step_context("cpu", torch.bfloat16) as autocast:
            assert not torch.backends.mkldnn.enabled
            with autocast():
                got = _weight_grad(*(t.to(torch.bfloat16) for t in (x, w, g)))
        assert got.dtype == torch.bfloat16
        assert torch.isfinite(got).all()
        err = float((got.double() - want).abs().max())
        assert err <= BF16_BAND * scale, (err, scale)


@pytest.mark.parametrize("device_type,dtype", [
    ("cpu", torch.float32), ("cuda", torch.bfloat16),
    ("cuda", torch.float32)])
def test_the_context_is_the_autocast_alone_elsewhere(device_type, dtype):
    """oneDNN stays as it is outside a CPU bfloat16 step, and the flag is
    as found after every step."""
    assert torch.backends.mkldnn.enabled
    with step_context(device_type, dtype) as autocast:
        assert torch.backends.mkldnn.enabled
        assert callable(autocast)
    with pytest.raises(RuntimeError):
        with step_context("cpu", torch.bfloat16):
            raise RuntimeError
    assert torch.backends.mkldnn.enabled


STEP = """
import json, os, sys
import torch
torch.set_num_threads(2)
from dualvar_tpu_torch.core.checkpoint import load_state_dict
from dualvar_tpu_torch.train import pretrain as TP
cfg, args = TP.config_from_argv(sys.argv[1:])
metrics = TP.train(cfg, max_steps=args.max_steps, device=args.device)
state = load_state_dict(os.path.join(TP.set_path(cfg), "model"))
finite = all(bool(torch.isfinite(v).all()) for v in state.values()
             if v.is_floating_point())
print(json.dumps({"loss": metrics["total_loss"], "finite": finite}))
"""


def test_chain_pretrain_step_in_bf16_is_finite_and_repeatable(tmp_path):
    """Two steps of the paper chain's pretrain (``paper_table1_k400``,
    R(2+1)D-18 at its widths, bfloat16 autocast) at 4x16x16 clips, each in a
    fresh process: the parameters after them finite, the second step's loss
    the same in both."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", STEP, "--preset", "paper_table1_k400",
         "--device", "cpu", "--synthetic", "1", "--max_steps", "2",
         "--print_freq", "1", "--seq_len", "4", "--img_dim", "16",
         "--prefix", f"run{i}"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr[-3000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    assert all(o["finite"] for o in outs), outs
    assert outs[0]["loss"] == outs[1]["loss"], outs
