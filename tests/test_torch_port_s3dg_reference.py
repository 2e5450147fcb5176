"""The S3D-G cell's references in ``benchmark/reference/s3dg_blocked.py``,
on the CPU at tiny sizes:

* the blocked reference (the backbone stage by stage under activation
  recomputation) equals ``reference/s3dg.py`` over 2 SGD steps on seeded
  random weights: losses, every gradient leaf, every parameter and
  running statistic after the steps (the recomputation folds nothing);
* on the meta device it counts ``s3dg``'s FLOPs (``counts.step_flops``);
* the autocast-rounding reference, the same with float8 operands, and the
  precision control (float8 wherever the rounding reference holds
  bfloat16, and float8 operands) read in that order against float32, on
  the stem's two stages in train mode: the rounding reference's output off
  by bf16 rounding, the others' by an order more, and the same order in
  the weight gradients. (Past the stem, a batch norm over a few values a
  channel at these sizes turns any rounding into gaps of order 1, so the
  whole model cannot rank them here: the cell's own readings do, on the
  card.)
* ``"moved"`` moves the backbone's input by one fixed draw of that size
  relative, and nothing when absent.
"""

import json
import os
import sys

import pytest
import torch

import torch_port_util  # noqa: F401  (caps torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import counts, synth  # noqa: E402
from benchmark.reference import s3dg_blocked  # noqa: E402
from benchmark.reference.layers import Numerics  # noqa: E402
from benchmark.reference.tsv4 import SGD  # noqa: E402
from benchmark.reference.train import build  # noqa: E402

CONFIG = os.path.join(ROOT, "benchmark", "configs",
                      "k400_simclr_s3dg_blocked.json")


def config(**kw):
    with open(CONFIG) as fh:
        return {**json.load(fh), **kw}


def tiny(backbone):
    return config(backbone=backbone, img_dim=32, seq_len=8,
                  frames_hw=[40, 36])


def _steps(cfg, state, blocks, perms):
    """Two SGD steps from ``state``: each step's losses and gradients, and
    the state after."""
    model = build(cfg, state, "cpu")
    params = dict(model.named_parameters())
    opt = SGD(params.values(), cfg["lr"], cfg["momentum"], cfg["wd"])
    losses, grads = [], []
    for block, perm in zip(blocks, perms):
        out = model(block, perm)
        for p in params.values():
            p.grad = None
        sum(out.values()).backward()
        losses.append({k: v.detach() for k, v in out.items()})
        grads.append({k: p.grad.clone() for k, p in params.items()})
        opt.step()
    return losses, grads, model.state_dict()


def test_the_blocked_reference_is_the_s3dg_reference():
    plain, blocked = tiny("s3dg"), tiny("s3dg_blocked")
    state = synth.make_state(plain, 2 ** 32 + 3, "cpu")
    assert set(state) == set(synth.make_state(blocked, 5, "cpu"))
    g = torch.Generator().manual_seed(11)
    blocks = [torch.rand(4, 3, 8, 32, 32, 3, generator=g) for _ in range(2)]
    perms = [torch.tensor([[1, 0], [0, 1], [1, 0], [1, 0]])] * 2
    lp, gp, sp = _steps(plain, state, blocks, perms)
    lb, gb, sb = _steps(blocked, state, blocks, perms)
    for a, b in zip(lp, lb):
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=1e-6, atol=0)
    for a, b in zip(gp, gb):
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(
                b[k], a[k], rtol=1e-5, atol=1e-6 * a[k].abs().max().item())
    assert sp.keys() == sb.keys()
    moved = 0
    for k in sp:
        torch.testing.assert_close(sb[k], sp[k], rtol=1e-6, atol=1e-9)
        moved += k.endswith("running_mean") and not torch.equal(sp[k],
                                                                state[k])
    assert moved == 77  # every batch norm's running mean folded


def test_the_blocked_reference_counts_the_s3dg_flops():
    cfg = config()
    plain = config(backbone="s3dg")
    for batch in (1, 192):
        assert counts.step_flops(cfg, batch) == counts.step_flops(plain,
                                                                  batch)
        assert counts.conv_flops(cfg, batch) == counts.conv_flops(plain,
                                                                  batch)
    assert counts.step_flops(cfg, 192) == 19_906_202_566_656


def test_rounding_is_refused_unless_bfloat16():
    with pytest.raises(ValueError):
        s3dg_blocked.build(Numerics(), {"rounding": "float16"})


def _stem(numerics, rounding, state, x, cot):
    """The stem's two stages in train mode: output, and the stem's first
    convolution's and batch norm's weight gradients for cotangent
    ``cot``."""
    m = s3dg_blocked.Backbone(Numerics(numerics), rounding)
    m.load_state_dict(state)
    m.train()
    first, second = m.stages()[:2]
    y = second(first(x))
    (y * cot).sum().backward()
    return (y.detach(), m.Conv_1a.conv1.weight.grad,
            m.Conv_1a.bn1.weight.grad)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rounding_then_controls_against_float32(seed):
    full = synth.make_state(config(), seed, "cpu")
    state = {k[len("backbone."):]: v for k, v in full.items()
             if k.startswith("backbone.")}
    x = torch.randn(2, 3, 8, 32, 32, generator=torch.Generator()
                    .manual_seed(seed))
    # the stem's output: (1,2,2) and (2,1,1) strides, then a (1,2,2) pool
    cot = torch.randn(2, 64, 4, 8, 8, generator=torch.Generator()
                      .manual_seed(seed + 100))
    ref = _stem("float32", None, state, x, cot)
    rnd = _stem("float32", "bfloat16", state, x, cot)
    ops = _stem("fp8", "bfloat16", state, x, cot)
    ctl = _stem("fp8", "float8", state, x, cot)

    def gap(a, b):
        return float((a - b).norm() / b.norm())

    out_r = gap(rnd[0], ref[0])
    # bf16 keeps 8 significant bits: a relative rounding error of 2^-9
    assert 2 ** -10 < out_r < 2 ** -7
    assert 4 * out_r < gap(ops[0], ref[0]) < gap(ctl[0], ref[0])
    for i in (1, 2):
        assert 0 < gap(rnd[i], ref[i]) < gap(ops[i], ref[i]) < gap(
            ctl[i], ref[i])


def test_a_moved_input_is_one_fixed_draw():
    full = synth.make_state(config(), 1, "cpu")
    state = {k[len("backbone."):]: v for k, v in full.items()
             if k.startswith("backbone.")}
    x = torch.randn(2, 3, 8, 32, 32, generator=torch.Generator()
                    .manual_seed(1))

    def first_input(cfg):
        m = s3dg_blocked.build(Numerics("float32"), cfg)
        m.load_state_dict(state)
        seen = []
        m.Conv_1a.conv1.register_forward_pre_hook(
            lambda mod, args: seen.append(args[0].detach().clone()))
        m(x)
        return seen[0]

    assert torch.equal(first_input({}), x)
    assert torch.equal(first_input({"moved": 0.0}), x)
    a, b = first_input({"moved": 1e-6}), first_input({"moved": 1e-6})
    assert torch.equal(a, b)
    rel = (a - x) / x
    assert 0.5e-6 < float(rel.std()) < 2e-6
    assert float(rel.abs().max()) < 1e-5
