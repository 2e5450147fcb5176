"""The port's S3D and S3D-G backbones (dualvar_tpu_torch.models.backbones.
s3dg) against the JAX package on the CPU.

S3D's widths are fixed by ``MIX_PLANES``, so the input is small instead:
B=2, T=8, 32x32. Every pool still has an output there (the last maps are
1x1x1). Weights and inputs are numpy-made (``tests/torch_port_util.py``);
the eval-mode forward is compared in float32 at the backbone band, one
train-mode step in float64 on both sides (see
``check_backbone_train_step_float64``).
"""

import pytest
import torch

from dualvar_tpu_torch.models.backbones.s3dg import (S3D, STConv3d,
                                                     SelfGating)

from torch_port_util import (backbone_pair, check_backbone_eval_forward,
                             check_backbone_train_step_float64)

SIZE = (2, 8, 32)  # B, T, S


@pytest.mark.parametrize("net", ["s3d", "s3dg"])
def test_eval_forward_matches_jax(net):
    got = check_backbone_eval_forward(
        *backbone_pair(net, SIZE, seed=1 + len(net)), SIZE, seed=2)
    assert tuple(got.shape) == (2, 1024, 1, 1, 1)


@pytest.mark.parametrize("net", ["s3d", "s3dg"])
def test_train_step_forward_stats_and_gradients_match_jax_in_float64(net):
    check_backbone_train_step_float64(
        *backbone_pair(net, SIZE, seed=5 + len(net)), SIZE, seed=6)


def test_every_stage_has_an_output_at_the_test_size_and_full_size():
    """The shapes between the stages: the stem's temporal stride 2 (the
    int stride on both factors), the (1,3,3) pools, the 3x3x3 stride-2 pool
    and the final 2x2x2 pool; at 16x112x112 the reference's (2, 3, 3)."""
    seen = []
    model = S3D(gating=True).eval()
    for name in ("Conv_1a", "Conv_2c", "Mixed_3c", "Mixed_4f", "Mixed_5c"):
        getattr(model, name).register_forward_hook(
            lambda mod, args, out: seen.append(tuple(out.shape[2:])))
    with torch.no_grad():
        model(torch.zeros(1, 3, 8, 32, 32))
        assert seen == [(4, 16, 16), (4, 8, 8), (4, 4, 4), (2, 2, 2),
                        (1, 1, 1)]
        seen.clear()
        model(torch.zeros(1, 3, 16, 112, 112))
    assert seen == [(8, 56, 56), (8, 28, 28), (8, 14, 14), (4, 7, 7),
                    (2, 3, 3)]


def test_stconv_stride_int_on_both_factors_tuple_splits_them():
    x = torch.zeros(1, 3, 8, 16, 16)
    with torch.no_grad():
        both = STConv3d(3, 4, 7, stride=2, padding=3).eval()(x)
        slow = STConv3d(3, 4, 7, stride=(1, 2, 2), padding=3).eval()(x)
    assert tuple(both.shape) == (1, 4, 4, 8, 8)
    assert tuple(slow.shape) == (1, 4, 8, 8, 8)


def test_self_gating_takes_the_mean_of_a_bf16_map_in_float32():
    """Under bf16 autocast the gate's (T, H, W) mean is a float32 mean of
    the bf16 map, then the Linear runs in bf16."""
    gen = torch.Generator().manual_seed(0)
    gate = SelfGating(16)
    x = (torch.randn(2, 16, 4, 6, 6, generator=gen) * 3 + 100).bfloat16()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = gate(x)
        want = torch.sigmoid(gate.fc(x.float().mean(dim=(2, 3, 4))))[
            :, :, None, None, None] * x
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
