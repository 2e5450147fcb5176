"""Resume under two gloo processes: the pretrain smoke presets (SimCLR
and MoCo on R3D, batch 2 a process, 2 steps an epoch) run straight for
three steps,
and the same run stopped after its first epoch and resumed with
``--resume auto``. The resumed step's logged metrics equal the
uninterrupted run's bitwise on both processes, and the checkpoints the two
runs end with are bitwise equal: the model, the optimizer, the scheduler
and every process's generator state (``generators``, one a rank); for
MoCo also both queues, fed by both processes, and the pointer. The
counterpart of ``scripts/multihost_ckpt_check.py``."""

import dataclasses
import shutil

import pytest
import torch

from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS

from torch_port_util import launch_ranks
from test_torch_port_resume import _assert_bitwise

STEPS_PER_EPOCH = 2


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """The R3D-18 checkpoints are 0.1-0.2 GB each: removed when a test
    ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("preset", ["smoke", "smoke_moco"])
def test_resume_under_two_processes_is_bitwise(tmp_path, preset):
    cfg = PRETRAIN_PRESETS[preset]
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, img_dim=32, scale_hw=(40, 36),
                                 synthetic_videos=2 * 2 * STEPS_PER_EPOCH),
        optim=dataclasses.replace(cfg.optim, epochs=2, batch_size=2,
                                  schedule=(1,)),
        run=dataclasses.replace(cfg.run, log_root=str(tmp_path / "log"),
                                eval_freq=1, save_freq=1, print_freq=1))
    outs = launch_ranks("resume", {"cfg": cfg, "steps": STEPS_PER_EPOCH},
                        tmp_path / "run")
    for rank, out in enumerate(outs):
        straight, resumed = out["straight"]["metrics"], \
            out["resumed"]["metrics"]
        assert {"clip_loss", "clip_top1", "total_loss"} <= set(straight)
        assert straight == resumed, rank
    assert outs[0]["straight"]["metrics"] == outs[1]["straight"]["metrics"]
    a, b = outs[0]["straight"], outs[0]["resumed"]
    assert a["epoch"] == b["epoch"] == 1
    assert a["ckpt"]["iteration"] == STEPS_PER_EPOCH + 1
    _assert_bitwise(a["ckpt"], b["ckpt"])
    if preset == "smoke_moco":  # three steps of the global 4 keys
        assert int(a["ckpt"]["state_dict"]["queue_ptr"]) == 3 * 4
    gens = a["ckpt"]["generators"]
    assert len(gens) == 2 and not torch.equal(gens[0], gens[1])
    assert torch.equal(gens[0], a["ckpt"]["generator"])
