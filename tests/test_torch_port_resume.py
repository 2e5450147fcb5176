"""Resume and ``--pretrain`` of the port's trainers on the CPU.

A run of two epochs straight through, and the same run stopped after its
first epoch and resumed with ``--resume auto``, end bitwise equal: the
model's ``state_dict`` (for MoCo the key encoder, both queues and the
pointer), the optimizer's state, the scheduler's and the run generator's
— for pretrain SimCLR (``smoke``), pretrain MoCo (``smoke_moco``) and the
classifier (``smoke``). ``--pretrain`` loads weights only: a fresh
optimizer and scheduler, epoch 0."""

import dataclasses
import logging
import os
import shutil

import pytest
import torch

from dualvar_tpu_torch.core.checkpoint import CheckpointStore
from dualvar_tpu_torch.core.config import CLASSIFIER_PRESETS, PRETRAIN_PRESETS
from dualvar_tpu_torch.train import classifier as TC
from dualvar_tpu_torch.train import pretrain as TP

import torch_port_util  # noqa: F401  (caps torch's threads)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """The checkpoints these tests write are 0.1-0.2 GB each (R3D-18 and
    its optimizer state); remove them when a test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _pretrain_cfg(preset, root, epochs, resume="", pretrain=""):
    cfg = PRETRAIN_PRESETS[preset]
    return cfg.replace(
        data=dataclasses.replace(cfg.data, img_dim=32, scale_hw=(40, 36),
                                 synthetic_videos=8),
        optim=dataclasses.replace(cfg.optim, epochs=epochs),
        run=dataclasses.replace(cfg.run, log_root=str(root), resume=resume,
                                pretrain=pretrain, eval_freq=1,
                                save_freq=1))


def _classifier_cfg(root, epochs, resume=""):
    cfg = CLASSIFIER_PRESETS["smoke"]
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, seq_len=4, img_dim=32,
                                 scale_hw=(40, 36), synthetic_videos=8),
        optim=dataclasses.replace(cfg.optim, epochs=epochs),
        run=dataclasses.replace(cfg.run, log_root=str(root), resume=resume,
                                eval_freq=1))


def _store(trainer, cfg):
    return CheckpointStore(os.path.join(trainer.set_path(cfg), "model"))


def _assert_bitwise(a, b, where=""):
    """Two checkpoint trees equal: tensors bitwise, the rest by value."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
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


def _check_resume(trainer, make_cfg, tmp_path):
    straight = make_cfg(tmp_path / "straight", 2)
    trainer.train(straight, device="cpu")
    cut = make_cfg(tmp_path / "cut", 1)
    trainer.train(cut, device="cpu")
    first = _store(trainer, cut).restore()
    assert first["epoch"] == 0
    trainer.train(make_cfg(tmp_path / "cut", 2, resume="auto"), device="cpu")
    want = _store(trainer, straight).restore()
    got = _store(trainer, cut).restore()
    assert got["epoch"] == want["epoch"] == 1
    assert got["iteration"] == want["iteration"] == 2 * first["iteration"]
    for key in ("state_dict", "optimizer", "scheduler", "generator",
                "best_acc"):
        _assert_bitwise(got[key], want[key], key)
    return got


@pytest.mark.parametrize("preset", ["smoke", "smoke_moco"])
def test_pretrain_resume_is_bitwise_the_straight_run(tmp_path, preset):
    got = _check_resume(
        TP, lambda root, epochs, resume="": _pretrain_cfg(
            preset, root, epochs, resume), tmp_path)
    assert got["optimizer"]["state"]  # momentum buffers came along
    if preset == "smoke_moco":
        assert int(got["state_dict"]["queue_ptr"]) == 16


def test_classifier_resume_is_bitwise_the_straight_run(tmp_path):
    got = _check_resume(TC, _classifier_cfg, tmp_path)
    assert "final_fc.weight" in got["state_dict"]


def test_resume_from_another_directory_and_a_missing_one(tmp_path):
    """``--resume <dir>`` reads that store (and the run writes its own);
    resumed again into its own store, which already holds the epoch it
    would save, the store keeps its file and the trainer logs the skipped
    save as a warning, not as saved; a directory without a checkpoint is
    an error."""
    source = _pretrain_cfg("smoke", tmp_path / "a", 1)
    TP.train(source, device="cpu")
    model_dir = os.path.join(TP.set_path(source), "model")
    cfg = _pretrain_cfg("smoke", tmp_path / "b", 2, resume=model_dir)
    TP.train(cfg, device="cpu")
    store = _store(TP, cfg)
    assert store.latest_epoch() == 1 and store.restore()["iteration"] == 4
    kept = store.restore()
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("dualvar_tpu_torch")
    logger.addHandler(handler)
    try:
        TP.train(cfg, device="cpu")
    finally:
        logger.removeHandler(handler)
    lines = [r.getMessage() for r in records]
    assert "[warning] checkpoint epoch 1 not saved: the store already " \
        "holds epoch 1" in lines
    assert not any(line.startswith("saved checkpoint") for line in lines)
    _assert_bitwise(_store(TP, cfg).restore(), kept)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        TP.train(_pretrain_cfg("smoke", tmp_path / "c", 1,
                               resume=str(tmp_path / "nothing")),
                 device="cpu")


@pytest.mark.parametrize("source,target", [
    ("smoke_moco", "smoke_moco"), ("smoke_dualvar", "smoke_moco"),
    ("smoke_moco", "smoke_dualvar")])
def test_pretrain_flag_loads_weights_only(tmp_path, source, target):
    """The target's model holds the source checkpoint's entries (MoCo:
    query and key encoders, queues, pointer; across families: the query
    encoder is what a SimCLR model holds); its optimizer and scheduler are
    fresh and it starts at epoch 0."""
    src_cfg = _pretrain_cfg(source, tmp_path / "src", 1)
    TP.train(src_cfg, max_steps=1, device="cpu")
    src = _store(TP, src_cfg).restore()["state_dict"]
    path = os.path.join(TP.set_path(src_cfg), "model")

    cfg = _pretrain_cfg(target, tmp_path / "dst", 1, pretrain=path)
    setup = TP.setup_training(cfg, "cpu")
    setup.loader.close()
    report = TP.load_pretrain_weights(setup.model, path)
    state = setup.model.state_dict()
    q = "encoder_q."
    for key, val in state.items():
        if key in src:
            want = src[key]
        elif key.startswith(q) and key[len(q):] in src:
            want = src[key[len(q):]]
        elif q + key in src:
            want = src[q + key]
        else:
            continue
        assert torch.equal(val, want), key
    assert report["loaded"]
    if source == target:
        assert not report["missing_in_src"] and not report["unused_src"]
    assert setup.optimizer.state_dict()["state"] == {}
    assert setup.scheduler.last_epoch == 0

    TP.train(cfg, max_steps=1, device="cpu")
    ckpt = _store(TP, cfg).restore()
    assert (ckpt["epoch"], ckpt["iteration"]) == (0, 1)


def test_pretrain_cli_resume_and_async_flags(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--preset", "smoke", "--device", "cpu", "--img_dim", "32",
            "--epochs", "1", "--async_ckpt", "0"]
    TP.main(args)
    TP.main(args[:-4] + ["--epochs", "2", "--resume", "auto"])
    cfg = PRETRAIN_PRESETS["smoke"]
    store = CheckpointStore(os.path.join(
        "log", cfg.run.prefix, "pretrain", cfg.run.name_prefix, "model"))
    assert store.latest_epoch() == 1
    assert store.restore()["iteration"] == 2 * store.restore(0)["iteration"]
