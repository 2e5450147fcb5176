"""The ``paper_table1_k400`` chain of ``scripts/paper_torch/`` replayed end
to end on the CPU through ``dualvar_tpu_torch/tools/paper_chain.py:
run_chain``: pretrain -> finetune -> temporal 10-clip test -> retrieval, the
commands recorded from ``run.sh`` with the HMDB stages left out (as
``tests/test_cli_chain.py`` leaves them out), each with ``--device cpu
--synthetic 1 --epochs 1 --max_steps 2 --print_freq 1`` and the smallest
R(2+1)D clip the port's CPU tests use (4 frames of 16x16). The preset's
widths and its 64 synthetic videos stay. The replay's directory is removed
when the module's tests end."""

import json
import logging
import math
import os
import shutil

import numpy as np
import pytest
import torch

from dualvar_tpu_torch.core.checkpoint import (checkpoint_file,
                                               load_state_dict,
                                               pretrain_backbone)
from dualvar_tpu_torch.tools import paper_chain as PC
from dualvar_tpu_torch.train import classifier as TC

import torch_port_util  # noqa: F401  (caps torch's threads)

CHAIN = "paper_table1_k400"
EXTRA = ["--device", "cpu", "--synthetic", "1", "--epochs", "1",
         "--max_steps", "2", "--print_freq", "1", "--seq_len", "4",
         "--img_dim", "16"]
TSV4_LOSSES = ("clip_loss", "tc_loss", "aug_ranking_margin_loss",
               "unaug_ranking_margin_loss")


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """(the replay's directory, its stages, the states the classifier had
    after each graft and after each test stage's load, by path)."""
    stages = [(m, argv) for m, argv in PC.chain_commands(CHAIN)
              if "hmdb" not in " ".join(argv)]
    cwd = str(tmp_path_factory.mktemp("paper_chain"))
    seen = {"graft": [], "test": {}}
    graft, load_test = TC.graft_pretrained, TC._load_test_state

    def snapshot(model):
        return {k: v.clone() for k, v in model.state_dict().items()}

    def grafted(model, path, logger=None):
        report = graft(model, path, logger)
        seen["graft"].append((path, snapshot(model)))
        return report

    def loaded(cfg, model, logger):
        load_test(cfg, model, logger)
        if cfg.run.resume:
            seen["test"][cfg.run.resume] = snapshot(model)

    TC.graft_pretrained, TC._load_test_state = grafted, loaded
    logger = logging.getLogger(PC.LOGGER)
    found = lambda: (os.getcwd(), list(logger.handlers), logger.level,  # noqa
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision(),
                     torch.backends.mkldnn.enabled,
                     os.environ.get("DUALVAR_BN_STATS"))
    seen["before"] = found()
    try:
        stages = PC.run_chain(stages, EXTRA, cwd=cwd)
        seen["after"] = found()
        yield cwd, stages, seen
    finally:
        TC.graft_pretrained, TC._load_test_state = graft, load_test
        shutil.rmtree(cwd, ignore_errors=True)


def test_the_stages_are_the_chain(replay):
    _, stages, _ = replay
    assert [PC.stage_name(s.module, s.argv) for s in stages] == [
        "pretrain paper_table1_k400", "classifier paper_table1_ucf_ft",
        "classifier paper_table1_ucf_ft temporal_ten_clip",
        "classifier paper_table1_ucf_ft retrieval"]
    for s in stages:
        assert s.argv[-len(EXTRA):] == EXTRA and s.seconds > 0
        assert s.launches == {}


def test_replay_leaves_the_process_as_found(replay):
    """The working directory, the logger, the backend flags (oneDNN's too,
    which each bfloat16 step on the CPU turns off for its duration) and the
    batch norm's variable, after four stages that each set up a logger and
    the cuDNN flags."""
    _, _, seen = replay
    assert seen["after"] == seen["before"]


def test_pretrain_saves_its_checkpoint(replay):
    cwd, (pre, *_), _ = replay
    assert pre.directory == os.path.join(cwd, "log", CHAIN, "pretrain", "exp")
    assert all(math.isfinite(pre.result[k]) for k in TSV4_LOSSES)
    assert any(line.startswith("saved checkpoint epoch 0")
               for line in pre.log)
    ckpt = torch.load(checkpoint_file(os.path.join(pre.directory, "model")),
                      map_location="cpu")
    assert ckpt["iteration"] == 2 and ckpt["epoch"] == 0
    # the stage logged to its own directory
    assert os.path.exists(os.path.join(pre.directory, "log"))


def test_finetune_grafts_the_pretrain_backbone(replay):
    cwd, (pre, ft, *_), seen = replay
    path = ft.config.run.pretrain
    assert os.path.join(cwd, path) == os.path.join(pre.directory, "model")
    assert f"=> loaded pretrained checkpoint '{path}'" in ft.log
    assert any(line.startswith("saved checkpoint epoch 0") for line in ft.log)
    assert math.isfinite(ft.result["loss"])
    # the graft the finetune started from: every backbone entry bitwise the
    # pretrain checkpoint's, the head at its init
    graft_path, state = seen["graft"][0]
    assert graft_path == path
    source = pretrain_backbone(load_state_dict(os.path.join(cwd, path)))
    backbone = {k: v for k, v in state.items() if k.startswith("backbone.")}
    assert len(backbone) == len(source)
    for k, v in backbone.items():
        assert torch.equal(v, source[k[len("backbone."):]]), k
    fresh = TC.build_model(ft.config, ft.config.run.seed).state_dict()
    for k in (k for k in fresh if not k.startswith("backbone.")):
        assert torch.equal(state[k], fresh[k]), k


def test_test_stage_runs_the_finetuned_state_bitwise(replay):
    cwd, (_, ft, test, _), seen = replay
    resume = test.config.run.resume
    assert os.path.join(cwd, resume) == os.path.join(ft.directory, "model")
    assert f"=> loaded test checkpoint '{resume}'" in test.log
    saved = torch.load(checkpoint_file(os.path.join(ft.directory, "model")),
                       map_location="cpu")["state_dict"]
    ran = seen["test"][resume]
    assert set(ran) == set(saved)
    for k in saved:
        assert torch.equal(ran[k], saved[k]), k
    assert 0.0 <= test.result["top1"] <= 1.0
    with open(os.path.join(ft.directory, "prob-temporal_10_clip.json")) as f:
        assert json.load(f)["top1"] == test.result["top1"]


def test_retrieval_writes_its_dumps(replay):
    retrieval = replay[1][3]
    assert set(retrieval.result) == {"R@1", "R@5", "R@10", "R@20", "R@50"}
    assert all(0.0 <= v <= 1.0 for v in retrieval.result.values())
    feat = os.path.join(retrieval.directory, "feature")
    for split in ("test", "train"):
        f = np.load(os.path.join(feat, f"ucf101_{split}_feature.npy"))
        per = np.load(os.path.join(feat, f"ucf101_{split}_per_feature.npy"))
        labels = np.load(os.path.join(feat, f"ucf101_{split}_label.npy"))
        with open(os.path.join(feat, f"ucf101_{split}_vname.json")) as fh:
            names = json.load(fh)
        assert f.shape == (64, 512) and per.shape == (64, 10, 512)
        assert labels.shape == (64,) and len(names) == 64
        assert np.isfinite(f).all()
    assert np.load(os.path.join(feat, "ucf101_sim.npy")).shape == (64, 64)
    with open(os.path.join(feat, "retrieval.json")) as fh:
        assert json.load(fh) == retrieval.result


def test_replay_refuses_an_input_no_stage_wrote(tmp_path):
    """Before a stage runs: an input that does not exist, and one that
    exists but no earlier stage of the replay wrote."""
    stages = PC.chain_commands(CHAIN, "test.sh")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        PC.run_chain(stages, EXTRA, cwd=str(tmp_path))
    os.makedirs(tmp_path / "log" / CHAIN / "ft" / "exp" / "ucf" / "model")
    with pytest.raises(ValueError, match="no earlier stage"):
        PC.run_chain(stages, EXTRA, cwd=str(tmp_path))
    assert os.getcwd() != str(tmp_path)
