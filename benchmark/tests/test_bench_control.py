"""The check's control and faults, at a size a test run holds, on the CPU.

* The control: the reference put in the program's place and computed one
  precision step below the configuration's (fp8 products, bfloat16
  augmentation planes) must come out not correct against the cell's
  limits.
* The faults: the rest of a run (``cell.run``, the look for a card
  skipped) with the program's step broken underneath must come out not
  correct: a step that returns its state unchanged, and a step that leaves
  half of its batch out and takes the mean over the rest.
"""

import dataclasses
import os
import time

import pytest
import torch

from benchmark import check, spec
from benchmark import cell as cell_mod

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def tiny(name):
    c = spec.cell(name)
    cfg = {**c.config, "img_dim": 32, "seq_len": 8, "frames_hw": [40, 36],
           "dtype": "float32"}
    tr = {**c.traffic, "batch_per_process": 2, "pool_batches": 2,
          "sync_every": 2, "trace_steps": 1}
    return dataclasses.replace(c, config=cfg, traffic=tr)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    c = tiny(name)
    dev = torch.device("cpu")
    ref = cell_mod.reference_readings(c, 2 ** 31 + 11, dev)
    ctrl = cell_mod.reference_readings(c, 2 ** 31 + 11, dev, "fp8",
                                       torch.bfloat16)
    correct, rows = check.judge(check.numbers(ctrl, ref), c.limits)
    assert not correct, rows


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(fault):
    name = "k400_simclr_r21d.b32"
    c = tiny(name)
    result = cell_mod.run(name, 2 ** 31 + 29, 0.5, False, time.time(),
                          "cpu", c, fault=fault)
    assert result["correct"] is False, result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_four_processes_on_the_cpu(fault):
    """The four-process path (traffic ``ddp4x8``, limits of its cell, which
    ``BENCHMARK.json`` does not list yet), gloo in place of NCCL: every
    process runs its shard, process 0's readings are held against the
    reference's step on the global batch. Sound in float32 at this size,
    it passes its step-1 numbers; without the gradient's exchange it is
    not correct."""
    name = "k400_simclr_r21d.ddp4x8"
    b8 = tiny("k400_simclr_r21d.b8")
    traffic = spec._json(os.path.join(spec.HERE, "traffic", "ddp4x8.json"))
    c = dataclasses.replace(
        b8, name=name, chips=4,
        traffic={**traffic, **{k: b8.traffic[k] for k in (
            "batch_per_process", "pool_batches", "sync_every")}},
        limits=spec._json(os.path.join(spec.HERE, "limits", name + ".json")))
    result = cell_mod.run(name, 2 ** 31 + 41, 0.5, False, time.time(), "cpu",
                          c, fault=fault)
    rows = result["checks"]
    if fault is None:
        assert result["device"]["count"] == 4
        assert rows["block"]["value"] == 0.0
        assert rows["loss1"]["value"] < 1e-4
        assert rows["grad1_median"]["value"] < 1e-3
    else:
        assert result["correct"] is False, rows
        assert rows["grad1_median"]["value"] > rows["grad1_median"]["limit"]
