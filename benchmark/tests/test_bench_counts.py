"""The yardstick's FLOP and byte functions at small shapes, against hand
counts."""

import json
import math
import os

import pytest
import torch

from benchmark import counts, spec
from benchmark.reference.layers import Conv3d, Numerics
from benchmark.reference.tsv4 import TSV4


def config(net):
    """A configuration's file by name; S3D-G's has no cell yet (PERF.md §7),
    its counts are held to a hand count all the same."""
    name = f"k400_simclr_{net}"
    with open(os.path.join(spec.HERE, "configs", f"{name}.json")) as fh:
        return {**json.load(fh), "name": name}


def small(net):
    cfg = config(net)
    cfg.update(img_dim=32, seq_len=8)
    return cfg


def hand_conv_flops(cfg, batch):
    """2 * MACs of each convolution's forward, the same again for its weight
    gradient, and again for its data gradient unless it is the stem (whose
    input, the augmented block, needs none)."""
    with torch.device("meta"):
        model = TSV4(cfg, Numerics())
    seen = []

    def hook(mod, args, out):
        w = mod.weight
        macs = out.numel() * w[0].numel()
        needs_dx = args[0].requires_grad
        seen.append(2 * macs * (2 + needs_dx))

    for m in model.modules():
        if isinstance(m, Conv3d):
            m.register_forward_hook(hook)
    T, d = cfg["seq_len"], cfg["img_dim"]
    block = torch.empty(batch, 3, T, d, d, 3, device="meta")
    perm = torch.arange(cfg["n_series"], device="meta").expand(batch, -1)
    model(block, perm)
    return sum(seen)


@pytest.mark.parametrize("net", ["r21d", "s3dg"])
def test_conv_flops_match_a_hand_count(net):
    cfg = small(net)
    assert counts.conv_flops(cfg, 2) == hand_conv_flops(cfg, 2)


def test_step_flops_add_the_heads_and_losses():
    cfg = small("r21d")
    B = 2
    extra = counts.step_flops(cfg, B) - counts.conv_flops(cfg, B)
    # heads: fc1 512x512 and fc2 on 3B + B pooled rows (clip head on the
    # 3B only), forward, weight and data gradients; the losses' products
    clip = 3 * B * (512 * 512 + 512 * 128)
    series = 4 * B * (512 * 512 + 512 * 128)
    heads = 2 * 3 * (clip + series)
    assert heads <= extra <= heads * 1.01


def test_one_conv_by_hand():
    with torch.device("meta"):
        conv = Conv3d(Numerics(), 3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3))
    out = (8, 16, 16)  # T, ceil(32 / 2) twice
    macs = 45 * math.prod(out) * 3 * 49
    with torch.device("meta"):
        y = conv(torch.empty(1, 3, 8, 32, 32))
    assert y.shape[1:] == (45, *out)
    assert 2 * macs == 2 * y.numel() * conv.weight[0].numel()


def test_aug_bytes_by_hand():
    cfg = spec.cell("k400_simclr_r21d.b32").config
    clips = 32 * 3
    elems = clips * 3 * 16 * 112 * 112
    assert counts.aug_bytes(cfg, 32, 4) == elems * 5 == 289013760
    assert counts.aug_bytes(cfg, 8, 2) == elems // 4 * 3


def test_flagship_step_matches_the_torch_count():
    """16.25 TFLOP at B=32, the count of FlopCounterMode over the port's own
    call (PERF.md): the same products at the same shapes."""
    cfg = spec.cell("k400_simclr_r21d.b32").config
    assert counts.step_flops(cfg, 32) == pytest.approx(16.25e12, rel=1e-3)
