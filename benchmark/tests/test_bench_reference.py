"""The plain reference against the port at a tiny size on the CPU: the
draws and the augmentation, the model's losses and gradients (float64),
SGD, and the harness's readings of both sides end to end."""

import dataclasses
import json
import os

import pytest
import torch

from benchmark import cell as cell_mod
from benchmark import check, spec, synth
from benchmark.reference import aug
from benchmark.reference import train as reference
from benchmark.reference.tsv4 import SGD


def config(net):
    """A configuration's file by name; S3D-G's has no cell yet (PERF.md §7),
    its reference is held to the port all the same."""
    name = f"k400_simclr_{net}"
    with open(os.path.join(spec.HERE, "configs", f"{name}.json")) as fh:
        return {**json.load(fh), "name": name}


def tiny(net, dtype="float32"):
    c = spec.cell("k400_simclr_r21d.b32")
    cfg = {**config(net), "img_dim": 32, "seq_len": 8, "frames_hw": [40, 36],
           "dtype": dtype}
    tr = {**c.traffic, "batch_per_process": 2, "pool_batches": 2,
          "sync_every": 2, "trace_steps": 1}
    return dataclasses.replace(c, config=cfg, traffic=tr)


def test_draws_and_augmentation_match_the_port():
    from dualvar_tpu_torch.aug.pipeline import AugConfig, pretrain_batch
    from dualvar_tpu_torch.models.ssl.simclr import random_segment_perms

    frames = torch.randint(0, 256, (3, 3 * 8, 40, 36, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    g_port = torch.Generator().manual_seed(2 ** 33 + 5)
    g_ref = torch.Generator().manual_seed(2 ** 33 + 5)
    cfg = AugConfig(img_dim=32, seq_len=8, jitter_order="sample")
    port = pretrain_batch(g_port, frames, cfg)
    perm_port = random_segment_perms(g_port, 3, 2)
    params = aug.draw_clip_params(g_ref, 3, 3, 40, 36, 32)
    ref = aug.augment(frames, params, 8, 32)
    perm_ref = aug.segment_perms(g_ref, 3, 2)
    torch.testing.assert_close(port, ref, rtol=0, atol=1e-6)
    assert torch.equal(perm_port, perm_ref)
    assert torch.equal(g_port.get_state(), g_ref.get_state())


@pytest.mark.parametrize("net", ["r21d", "s3dg"])
def test_model_losses_and_gradients_match_the_port(net):
    """Backbones in float64, heads and losses in float32 (the port casts the
    pooled features to float32): losses and gradients to float32's
    rounding."""
    from dualvar_tpu_torch.models.ssl.simclr import SimCLRTimeSeriesV4

    c = tiny(net)
    state = synth.make_state(c.config, 9, "cpu")
    port = SimCLRTimeSeriesV4(network=net).train()
    port.load_state_dict(state)
    ref = reference.build(c.config, state, "cpu")
    port.backbone.double()
    ref.backbone.double()
    block = torch.randn(2, 3, 8, 32, 32, 3, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(3))
    perm = torch.tensor([[1, 0], [0, 1]])
    lp = port(block, perm=perm)
    lr = ref(block, perm)
    names = {"clip_loss": "clip_contrast_loss", "tc_loss": "tc_contrast_loss",
             "aug_ranking_margin_loss": "aug_ranking_margin_contrast_loss",
             "unaug_ranking_margin_loss":
                 "unaug_ranking_margin_contrast_loss"}
    for k, pk in names.items():
        torch.testing.assert_close(lp[pk], lr[k], rtol=1e-5, atol=1e-6)
    sum(v for k, v in lp.items() if k.endswith("loss")).backward()
    sum(lr.values()).backward()
    gp = dict(port.named_parameters())
    for k, p in ref.named_parameters():
        torch.testing.assert_close(gp[k].grad, p.grad, rtol=1e-4,
                                   atol=1e-5 * p.grad.abs().max().item())
    sp = port.state_dict()
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(sp[k], v, rtol=1e-9, atol=1e-12)


def test_sgd_matches_torch():
    w1 = torch.randn(5, 4, dtype=torch.float64, requires_grad=True)
    w2 = w1.detach().clone().requires_grad_(True)
    opt = torch.optim.SGD([w1], lr=0.003, momentum=0.9, weight_decay=1e-4)
    ref = SGD([w2], 0.003, 0.9, 1e-4)
    for i in range(3):
        g = torch.randn(5, 4, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(i))
        w1.grad, w2.grad = g.clone(), g.clone()
        opt.step()
        ref.step()
    torch.testing.assert_close(w1, w2, rtol=1e-12, atol=0)


def test_readings_of_the_port_and_the_reference_agree_in_float32():
    """The harness's own readings of both sides, the program's step on the
    CPU in float32: step 1 agrees to float32's rounding."""
    c = tiny("r21d")
    dev = torch.device("cpu")
    prog = cell_mod.Program(c, 2 ** 32 + 17, dev).first_steps(3)
    ref = cell_mod.reference_readings(c, 2 ** 32 + 17, dev)
    nums = check.numbers(prog, ref)
    assert nums["block"] == 0.0
    assert nums["loss1"] < 1e-4
    assert nums["grad1_median"] < 1e-3
    assert set(prog["change"]) == set(ref["change"])
