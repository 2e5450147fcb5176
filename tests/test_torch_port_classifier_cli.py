"""The port's classifier from the command line, on the CPU: a short
finetune run, then retrieval from the checkpoint it wrote; the flags that
were refused before the port had what they need, each reaching the
config; a ``--resume`` without a checkpoint, and a missing card, refused."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from dualvar_tpu_torch.core.config import CLASSIFIER_PRESETS
from dualvar_tpu_torch.train import classifier as TC

from torch_port_util import TORCH_THREADS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=REPO,
               OMP_NUM_THREADS=str(TORCH_THREADS))
    return subprocess.run(
        [sys.executable, "-m", "dualvar_tpu_torch.train.classifier",
         "--preset", "smoke", "--device", "cpu", "--seq_len", "4",
         "--img_dim", "32", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)


def test_cli_trains_and_tests_on_the_cpu(tmp_path):
    run = _cli(tmp_path, "--max_steps", "2")
    assert run.returncode == 0, run.stderr[-2000:]
    exp = tmp_path / "log" / "smoke" / "ft" / "exp" / "ucf"
    ckpt = torch.load(exp / "model" / "latest" / "epoch0.pth.tar",
                      map_location="cpu")
    assert ckpt["iteration"] == 2 and "final_fc.weight" in ckpt["state_dict"]
    run = _cli(tmp_path, "--test", "retrieval", "--resume",
               str(exp / "model"))
    assert run.returncode == 0, run.stderr[-2000:]
    with open(exp / "feature" / "retrieval.json") as f:
        out = json.load(f)
    assert all(0.0 <= v <= 1.0 for v in out.values())


@pytest.mark.parametrize("args", [
    ("--optim", "adam"), ("--remat",), ("--fast_decode", "1")])
def test_cli_flags_reach_the_config(args, monkeypatch):
    """The three flags were refused before the port had AdamW,
    rematerialisation and the native decoder; now each reaches the config
    ``train`` gets (and is at its default without the flag)."""
    seen = []
    monkeypatch.setattr(TC, "train", lambda cfg, **kw: seen.append(cfg))
    TC.main(["--preset", "smoke", "--device", "cpu", *args])
    TC.main(["--preset", "smoke", "--device", "cpu"])
    read = {"--optim": lambda c: c.optim.optim,
            "--remat": lambda c: c.model.remat,
            "--fast_decode": lambda c: c.data.fast_decode}[args[0]]
    want = {"--optim": ("adam", "sgd"), "--remat": (True, False),
            "--fast_decode": (True, False)}[args[0]]
    assert (read(seen[0]), read(seen[1])) == want


def test_train_refuses_resume_and_a_missing_card(tmp_path):
    """``--resume <dir>`` of a directory that holds no checkpoint is an
    error, not a run from scratch."""
    cfg = CLASSIFIER_PRESETS["smoke"]
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, log_root=str(tmp_path),
        resume=str(tmp_path / "some" / "model")))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        TC.train(cfg, max_steps=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.train(cfg, max_steps=1)
