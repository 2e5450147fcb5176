"""The S3D-G cell ``k400_simclr_s3dg.b192`` and what it reads of the port,
on the CPU at tiny sizes:

* ``models/layers.py:MaxPool3d`` is ``F.max_pool3d``, bit for bit, forward
  and backward, on NCDHW and ``channels_last_3d`` maps; every backbone that
  pools does it through such modules (S3D-G 13 a pass), which hold no
  state;
* one S3D-G TSV4 step through ``make_train_step`` counts 72 ``gates`` (36
  a backbone pass), which ``backbone.gates`` reads; a step without gates
  reads None, as the parent's program does;
* ``pools.pool_bytes`` against a hand count, for one pool and for the
  cell's whole step;
* the readers' arithmetic on hand-made traces;
* ``BENCHMARK.json`` finds the cell's configuration, traffic, limits and
  readers by name; each limit lies between its readings, and where the
  control is its upper reading, that reading is three times the lower;
* ``calibrate_rounding.compare_leaves`` on hand-made gradients.
"""

import dataclasses
import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

import torch_port_util  # noqa: F401  (caps torch's threads)
from dualvar_tpu_torch.core import spans
from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS
from dualvar_tpu_torch.models.backbones import select_backbone
from dualvar_tpu_torch.models.layers import MaxPool3d
from dualvar_tpu_torch.train import pretrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import calibrate_rounding, counts, pools, spec  # noqa: E402

CELL = "k400_simclr_s3dg.b192"
NEW = ("backbone.pool_ms", "backbone.pool_roofline", "backbone.gating_ms",
       "backbone.gates")


@pytest.fixture(autouse=True)
def fresh_record():
    spans.reset()
    yield
    spans.reset()


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    s = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module


@pytest.mark.parametrize("layout", ["ncdhw", "channels_last_3d"])
@pytest.mark.parametrize("args", [(3, 1, 1), ((1, 3, 3), (1, 2, 2), (0, 1, 1)),
                                  (3, 2, 1), (2, 2, 0)])
def test_maxpool3d_is_f_max_pool3d_bit_for_bit(layout, args):
    x = torch.randn(2, 5, 6, 9, 7, generator=torch.Generator().manual_seed(4))
    if layout == "channels_last_3d":
        x = x.contiguous(memory_format=torch.channels_last_3d)
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    ya, yb = MaxPool3d(*args)(a), F.max_pool3d(b, *args)
    assert torch.equal(ya, yb)
    assert ya.stride() == yb.stride()
    g = torch.randn(ya.shape, generator=torch.Generator().manual_seed(5))
    ya.backward(g)
    yb.backward(g)
    assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("net,pools_a_pass", [
    ("s3dg", 13), ("s3d", 13), ("s3dg_packed", 13), ("c3d", 4),
    ("r2d3d18", 1)])
def test_every_pool_is_a_module_with_no_state(net, pools_a_pass):
    module, _ = select_backbone(net)
    found = [m for m in module.modules() if isinstance(m, MaxPool3d)]
    assert len(found) == pools_a_pass
    assert not any("pool" in k.lower() or "branch3_0" in k
                   for k in module.state_dict())
    calls = []
    for m in found:
        m.register_forward_hook(lambda *a: calls.append(1))
    with torch.no_grad():
        module.eval()(torch.zeros(1, 3, 8, 32, 32))
    assert len(calls) == pools_a_pass


def _s3dg_step():
    cfg = PRETRAIN_PRESETS["s3dg_k400"]
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, seq_len=8, img_dim=32,
                                 scale_hw=(40, 36)),
        optim=dataclasses.replace(cfg.optim, batch_size=2),
        model=dataclasses.replace(cfg.model, dtype="float32"))
    task = pretrain.build_task(cfg)
    optimizer, scheduler = pretrain.make_optimizer(cfg, task.parameters(),
                                                   10)
    step = pretrain.make_train_step(task, optimizer, scheduler,
                                    pretrain.aug_config(cfg), None)
    frames = torch.randint(0, 256, (2, 3 * 8, 40, 36, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    return step, frames, torch.Generator().manual_seed(2)


def test_one_s3dg_step_counts_72_gates():
    step, frames, gen = _s3dg_step()
    ctx = SimpleNamespace(window={"steps": 2})
    gates = _reader("backbone.gates")
    assert gates.read(ctx) is None  # no step yet
    step(frames, gen)
    step(frames, gen)
    (a, b) = spans.steps()
    assert a["counts"]["gates"] == b["counts"]["gates"] == 72
    assert gates.read(ctx) == 72.0


def test_gates_reader_is_none_without_gates(monkeypatch):
    """A step that counts no gate (another backbone, or a program that
    does not count them) reads None; a program without ``spans.count``
    too."""
    for _ in range(3):
        with spans.span(spans.STEP):
            spans.count("nchw_convs", 2)
    ctx = SimpleNamespace(window={"steps": 3})
    gates = _reader("backbone.gates")
    assert gates.read(ctx) is None
    with spans.span(spans.STEP):
        spans.count("gates", 36)
    assert gates.read(ctx) == pytest.approx(12.0)
    monkeypatch.delattr(spans, "count")
    assert gates.read(ctx) is None


def _cell_config():
    return spec.cell(CELL).config


def test_pool_bytes_of_one_pool_by_hand():
    """One 3x3x3 pool, stride 1, padding 1, over (2, 4, 3, 5, 5): 600
    elements in, 600 out, forward and backward at 2 bytes."""
    mode = pools._PoolElements()
    x = torch.empty(2, 4, 3, 5, 5, device="meta")
    with mode:
        F.max_pool3d(x, 3, 1, 1)
    assert mode.elements == 1200
    mode = pools._PoolElements()
    with mode:
        F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))  # out 3x3 a frame
    assert mode.elements == 600 + 2 * 4 * 3 * 3 * 3


def test_pool_bytes_of_the_cell_by_hand():
    """The 13 pools of one 16x112x112 clip (C, T, H, W in and out), in
    elements; a sample is 4 clips (3 views and the shuffled one)."""
    by_hand = [
        (64 * 8 * 56 * 56, 64 * 8 * 28 * 28),  # MaxPool_2a
        (192 * 8 * 28 * 28, 192 * 8 * 14 * 14),  # MaxPool_3a
        (192 * 8 * 14 * 14,) * 2,  # Mixed_3b.branch3_0
        (256 * 8 * 14 * 14,) * 2,  # Mixed_3c
        (480 * 8 * 14 * 14, 480 * 4 * 7 * 7),  # MaxPool_4a
        (480 * 4 * 7 * 7,) * 2,  # Mixed_4b
        (512 * 4 * 7 * 7,) * 2, (512 * 4 * 7 * 7,) * 2,  # 4c, 4d
        (512 * 4 * 7 * 7,) * 2, (528 * 4 * 7 * 7,) * 2,  # 4e, 4f
        (832 * 4 * 7 * 7, 832 * 2 * 3 * 3),  # MaxPool_5a
        (832 * 2 * 3 * 3,) * 2, (832 * 2 * 3 * 3,) * 2,  # 5b, 5c
    ]
    clip = sum(a + b for a, b in by_hand)
    assert clip == 6_999_168
    cfg = _cell_config()
    assert pools.pool_bytes(cfg, 1) == 4 * clip * 2 * 2
    assert pools.pool_bytes(cfg, 192) == 192 * pools.pool_bytes(cfg, 1)


def test_readers_on_a_hand_made_trace():
    trace = {"steps": 3, "group_s": {"pool": 0.3, "gating": 0.06,
                                     "conv": 1.0}}
    ctx = SimpleNamespace(trace=trace, config=_cell_config(), batch=192)
    assert _reader("backbone.pool_ms").read(ctx) == pytest.approx(100.0)
    assert _reader("backbone.gating_ms").read(ctx) == pytest.approx(20.0)
    need = pools.pool_bytes(ctx.config, 192)
    assert _reader("backbone.pool_roofline").read(ctx) == pytest.approx(
        100 * need / counts.HBM_BYTES_PER_S / 0.1)
    for name, group in (("backbone.pool_ms", "pool"),
                        ("backbone.pool_roofline", "pool"),
                        ("backbone.gating_ms", "gating")):
        assert _reader(name).HOOKS == {group: {
            "pool": {"MaxPool3d"}, "gating": {"SelfGating"}}[group]}
        empty = SimpleNamespace(trace={"steps": 3, "group_s": {}},
                                config=ctx.config, batch=192)
        assert _reader(name).read(empty) is None  # no such modules


def test_the_cell_is_found_by_name():
    bench = spec.benchmark()
    cell = spec.cell(CELL)
    assert cell.chips == 1
    assert {k: cell.traffic[k] for k in (
        "batch_per_process", "processes", "pool_batches", "compared_steps",
        "sync_every", "trace_steps")} == {
        "batch_per_process": 192, "processes": 1, "pool_batches": 4,
        "compared_steps": 3, "sync_every": 20, "trace_steps": 3}
    assert cell.config["backbone"] == "s3dg_blocked"
    assert cell.config["reduced"] == ["dataset", "batch_size"]
    # the unentered file's model keys, unchanged
    with open(os.path.join(spec.HERE, "configs",
                           "k400_simclr_s3dg.json")) as fh:
        plain = json.load(fh)
    for k, v in plain.items():
        if k not in ("backbone", "batch_size", "assumed"):
            assert cell.config[k] == v, k
    entry = next(c for c in bench["configs"] if c["name"] == "k400_simclr_s3dg")
    assert entry["reduced"] == ["dataset", "batch_size"]
    assert all(set(v) >= {"limit", "lower", "upper", "upper_from", "seeds"}
               for v in cell.limits.values())
    traced = [m["name"] for m in spec.metrics(CELL, True)]
    assert set(NEW) <= set(traced)
    for name in NEW:
        m = next(x for x in bench["per_layer"] if x["name"] == name)
        assert m["workloads"] == [CELL] and m["moves"] == "samples_per_s"
        assert callable(spec.reader(name).read)
    for other in ("k400_simclr_r21d.b32", "k400_simclr_r21d.b8"):
        assert not set(NEW) & {m["name"] for m in spec.metrics(other, True)}


def test_the_cell_limits_lie_between_their_readings():
    limits = spec.cell(CELL).limits
    assert set(limits) == {"block", "loss1", "grad1_median", "change",
                           "change_median"}
    for name, v in limits.items():
        assert v["lower"] < v["limit"] < v["upper"], name
        if v["upper_from"] == "control":
            assert v["upper"] >= 3 * v["lower"], name


def test_compare_leaves_on_hand_made_gradients():
    ref = {"grad1": {"a": 1.0, "b": 1.0, "c": 2.0}}
    prog = {"grad1": {"a": 1.5, "b": 1.01, "c": 2.0}}
    rnd = {"grad1": {"a": 1.05, "b": 1.3, "c": 2.2}}
    out = calibrate_rounding.compare_leaves(prog, rnd, ref, moved=rnd, n=2)
    # gaps over max(leaf, median leaf = 1.0)
    assert [k for k, _, _ in out["program_worst"]] == ["a", "b"]
    assert out["program_worst"][0][1:] == pytest.approx((0.5, 0.05))
    assert [k for k, _, _ in out["rounding_worst"]] == ["b", "c"]
    assert out["rounding_worst"][1][1:] == pytest.approx((0.1, 0.0))
    # a: program 10x past; b: rounding 30x past; c: rounding alone, 0.1
    assert out["past_5x"] == [1, 2]
    assert out["apart"] == pytest.approx([0.45, 0.29])
    # a realisation equal to the first parts from it nowhere
    assert out["moved"][:2] == [0.0, 0.0]
    assert [k for k, _ in out["moved"][2:]] == ["a", "b"]
    assert [g for _, g in out["moved"][2:]] == pytest.approx([0.05, 0.3])
