"""The port's C3D, R2D3D-18 and R2D3D-50 backbones
(dualvar_tpu_torch.models.backbones.{c3d,resnet_2d3d}) against the JAX
package on the CPU, and the registry's parameter goldens for every family.

Both sides get the same numpy-made weights (through ``from_jax_variables``)
and the same numpy-made input (``tests/torch_port_util.py``). The eval-mode
forward is compared in float32 at the backbone band of
tests/test_torch_parity.py; one train-mode step (features, running
statistics, every gradient) in float64 on both sides: the JAX package's
float32 results on XLA:CPU are no oracle for it (ROADMAP.md C.1, and
``check_backbone_train_step_float64``).
"""

import pytest

from dualvar_tpu.models.backbones import select_backbone as jax_backbone
from dualvar_tpu_torch.models.backbones import select_backbone
from dualvar_tpu_torch.models.layers import BatchNorm

from torch_port_util import (backbone_pair, check_backbone_eval_forward,
                             check_backbone_train_step_float64)

# name -> (parameters, feature_size, batch norms) of the JAX registry
GOLDENS = {"r3d": (14_361_792, 512, 12), "r21d": (14_365_303, 512, 24),
           "c3d": (27_661_440, 512, 8), "s3d": (7_910_048, 1024, 77),
           "s3dg": (9_098_000, 1024, 77), "r2d3d18": (5_210_176, 256, 20),
           "r50": (17_401_920, 1024, 53)}
B, T, S = 2, 8, 32
NETS = ("c3d", "r2d3d18", "r50")


@pytest.mark.parametrize("net", sorted(GOLDENS))
def test_registry_builds_every_family_with_the_jax_goldens(net):
    params, feature_size, batch_norms = GOLDENS[net]
    module, meta = select_backbone(net)
    assert sum(p.numel() for p in module.parameters()) == params
    assert meta == {"feature_size": feature_size}
    assert sum(isinstance(m, BatchNorm) for m in module.modules()) \
        == batch_norms
    _, jax_meta = jax_backbone(net)
    assert jax_meta == meta


@pytest.mark.parametrize("net", NETS)
def test_eval_forward_matches_jax(net):
    got = check_backbone_eval_forward(
        *backbone_pair(net, (B, T, S), seed=len(net)), (B, T, S), seed=3)
    assert got.shape[1] == GOLDENS[net][1]


@pytest.mark.parametrize("net", NETS)
def test_train_step_forward_stats_and_gradients_match_jax_in_float64(net):
    check_backbone_train_step_float64(
        *backbone_pair(net, (B, T, S), seed=10 + len(net)), (B, T, S),
        seed=4)
