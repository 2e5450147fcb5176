"""The backbone registry's variants (``r21d_pad128``, ``r21d_tiled``,
``s3d_packed``, ``s3dg_packed``) against the JAX package on the CPU.

Weights are numpy-made (``tests/torch_port_util.py``) the way each variant
gets its weights in use: the packed S3Ds from a standard S3D's, packed by
the JAX package's ``pack_s3d_params``; ``r21d_pad128`` from an ``r21d``'s,
embedded by its ``embed_formula_tree`` (pad blocks zero); ``r21d_tiled``
directly. Both sides get the same weights through ``from_jax_variables``
and the same numpy-made input (B=2, T=8, 32x32). The forwards are compared
at the backbone band of ``tests/test_torch_parity.py`` (atol 2e-4, rtol
1e-3): eval mode in float32, train mode in float64 (see its test); the
converters exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.models.backbones import select_backbone as jax_backbone
from dualvar_tpu.models.backbones.r21d import \
    embed_formula_tree as jax_embed
from dualvar_tpu.models.backbones.r21d import \
    intermed_channels as jax_intermed_channels
from dualvar_tpu.models.backbones.s3dg import pack_s3d_params as jax_pack
from dualvar_tpu_torch.core.convert import from_jax_variables
from dualvar_tpu_torch.models.backbones import select_backbone
from dualvar_tpu_torch.models.backbones.r21d import (R2Plus1DNet,
                                                     SpatioTemporalConv,
                                                     embed_formula_state,
                                                     intermed_channels)
from dualvar_tpu_torch.models.backbones.s3dg import (pack_s3d_params,
                                                     unpack_s3d_params)

from torch_port_util import (BACKBONE_ATOL, BACKBONE_RTOL, backbone_input,
                             numpy_variables, x64)

SIZE = (2, 8, 32)  # B, T, S
VARIANTS = ("r21d_pad128", "r21d_tiled", "s3d_packed", "s3dg_packed")
JAX_NAMES = ("s3d", "s3dg", "s3d_packed", "s3dg_packed", "c3d", "r3d",
             "r21d", "r21d_tiled", "r21d_pad128", "r2d3d18", "r50")


def _jax_shapes(jm):
    _, T, S = SIZE
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: jm.init(key, jnp.zeros((1, T, S, S, 3)),
                                          train=False))


def variant_variables(net, seed):
    """(JAX module, params, batch_stats) of ``net`` as numpy trees, made as
    the module docstring says."""
    _, T, S = SIZE
    jm, _ = jax_backbone(net)
    if net == "r21d_tiled":
        params, stats = numpy_variables(jm, jnp.zeros((1, T, S, S, 3)),
                                        seed=seed, train=False)
        return jm, params, stats
    source = {"s3d_packed": "s3d", "s3dg_packed": "s3dg",
              "r21d_pad128": "r21d"}[net]
    params, stats = numpy_variables(jax_backbone(source)[0],
                                    jnp.zeros((1, T, S, S, 3)), seed=seed,
                                    train=False)
    if net == "r21d_pad128":
        shapes = _jax_shapes(jm)
        params = jax_embed(params, shapes["params"])
        stats = jax_embed(stats, shapes["batch_stats"])
    else:
        params, stats = jax_pack(params), jax_pack(stats)
    return jm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray,
                                                              stats)


def variant_pair(net, seed):
    jm, params, stats = variant_variables(net, seed)
    tm, _ = select_backbone(net)
    tm.load_state_dict(from_jax_variables(params, stats, module=tm))
    return jm, params, stats, tm


def _ncdhw(y):
    return np.asarray(y).transpose(0, 4, 1, 2, 3)


@pytest.mark.parametrize("net", JAX_NAMES)
def test_registry_accepts_every_jax_name(net):
    """Every name of the JAX registry builds, with its feature size and
    the JAX module's parameter count."""
    jm, meta = jax_backbone(net)
    tm, ours = select_backbone(net)
    assert ours == meta
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        _jax_shapes(jm)["params"]))
    assert sum(p.numel() for p in tm.parameters()) == want


@pytest.mark.parametrize("net", VARIANTS)
def test_eval_forward_matches_jax(net):
    jm, params, stats, tm = variant_pair(net, seed=11)
    x_t, x_j = backbone_input(SIZE, seed=12)
    want = _ncdhw(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x_j)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x_t))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=BACKBONE_ATOL,
                               rtol=BACKBONE_RTOL)


@pytest.mark.parametrize("net", VARIANTS)
def test_train_forward_and_running_stats_match_jax_in_float64(net):
    """Train mode (batch statistics), both packages in float64: the
    features at the band, the running statistics folded in at 1e-6. In
    float32 neither side is an oracle here: at B=2 the deepest S3D batch
    norms see 2 values a channel and turn float32 conv rounding into
    differences of order 1 (the JAX package's tests/test_s3d_packed.py
    compares its own train mode in float64 for this reason)."""
    jm, params, stats, tm = variant_pair(net, seed=13)
    jm64, _ = jax_backbone(net, dtype=jnp.float64)
    x_t, x_j = backbone_input(SIZE, seed=14)

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

    with x64():
        want, updated = jax.tree.map(np.asarray, jax.jit(
            lambda v, x: jm64.apply(v, x, train=True,
                                    mutable=["batch_stats"]))(
            {"params": f64(params), "batch_stats": f64(stats)},
            jnp.asarray(x_j, jnp.float64)))
    tm.double().train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x_t).double())
    np.testing.assert_allclose(got.numpy(), _ncdhw(want), atol=BACKBONE_ATOL,
                               rtol=BACKBONE_RTOL)
    want_state = from_jax_variables(params, updated["batch_stats"])
    for key, val in tm.state_dict().items():
        if "running_" in key:
            np.testing.assert_allclose(val.numpy(), want_state[key].numpy(),
                                       atol=1e-6, rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("mode", ["formula", "tile128", "pad128"])
@pytest.mark.parametrize("args", [(3, 64, (3, 7, 7)), (64, 64, 3),
                                  (64, 128, 3), (128, 256, 3), (256, 512, 3),
                                  (64, 128, 1), (256, 512, 1)])
def test_intermed_channels_modes_match_jax(args, mode):
    assert intermed_channels(*args, mid_mode=mode) == \
        jax_intermed_channels(*args, mid_mode=mode)


def test_mid_widths_of_the_three_modes():
    """The formula's widths 83/144/230/460/921 (stem, then the first conv
    of each stage), snapped by tile128 and padded by pad128."""
    firsts = ((3, 64, (3, 7, 7)), (64, 64, 3), (64, 128, 3), (128, 256, 3),
              (256, 512, 3))
    got = {m: [intermed_channels(*a, mid_mode=m) for a in firsts]
           for m in ("formula", "tile128", "pad128")}
    assert got == {"formula": [83, 144, 230, 460, 921],
                   "tile128": [128, 128, 256, 512, 896],
                   "pad128": [128, 256, 256, 512, 1024]}
    with pytest.raises(ValueError, match="mid_mode"):
        intermed_channels(3, 64, 3, mid_mode="tile64")


def test_pad128_blocks_zero_at_init_and_the_logical_init_bound():
    """Every SpatioTemporalConv of a fresh r21d_pad128: the spatial conv's
    output channels and the temporal conv's input rows past the logical
    width are 0; the temporal conv's logical block is drawn within
    1/sqrt(kt * logical), a bound its largest entry comes near (above the
    bound of the physical fan-in)."""
    torch.manual_seed(0)
    model = R2Plus1DNet(mid_mode="pad128")
    convs = [m for m in model.modules() if isinstance(m, SpatioTemporalConv)]
    assert len(convs) == 1 + 2 * 4 + 3  # stem, two a block, 3 shortcuts
    for conv in convs:
        sp = conv.spatial_conv.weight.detach()
        tc = conv.temporal_conv.weight.detach()
        mid, logical = sp.shape[0], conv.logical
        assert mid == -(-logical // 128) * 128
        assert not sp[logical:].any() and not tc[:, logical:].any()
        kt = tc.shape[2]
        largest = float(tc[:, :logical].abs().max())
        assert largest <= 1 / np.sqrt(kt * logical)
        if kt > 1 and mid > logical:
            assert largest > 1 / np.sqrt(kt * mid)


def test_embed_formula_state_gives_the_r21d_function_and_matches_jax():
    """An r21d state embedded into r21d_pad128: the same eval and train
    forward in float32 (the padded reductions regroup the sums: 1e-5), and
    the same state the JAX package's ``embed_formula_tree`` makes from the
    same arrays, exactly."""
    _, T, S = SIZE
    jr, _ = jax_backbone("r21d")
    params, stats = numpy_variables(jr, jnp.zeros((1, T, S, S, 3)), seed=15,
                                    train=False)
    formula, _ = select_backbone("r21d")
    formula.load_state_dict(from_jax_variables(params, stats))
    padded, _ = select_backbone("r21d_pad128")
    embedded = embed_formula_state(formula.state_dict(), padded.state_dict())
    padded.load_state_dict(embedded)

    shapes = _jax_shapes(jax_backbone("r21d_pad128")[0])
    want = from_jax_variables(jax_embed(params, shapes["params"]),
                              jax_embed(stats, shapes["batch_stats"]))
    assert set(want) == set(embedded)
    for key, val in embedded.items():
        assert torch.equal(val, want[key]), key

    x = torch.from_numpy(backbone_input(SIZE, seed=16)[0])
    for train in (False, True):
        with torch.no_grad():
            a = formula.train(train)(x)
            b = padded.train(train)(x)
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                   rtol=1e-5)
    with pytest.raises(KeyError, match="key mismatch"):
        embed_formula_state({}, padded.state_dict())


@pytest.mark.parametrize("gating", [False, True])
def test_pack_unpack_round_trip_and_match_jax(gating):
    """``pack_s3d_params`` of a port state_dict equals the JAX package's
    ``pack_s3d_params`` of the same arrays, carried over; unpacking gives
    the standard state back bitwise, under any key prefix; and the packed
    model computes the standard model's function."""
    net = "s3dg" if gating else "s3d"
    _, T, S = SIZE
    params, stats = numpy_variables(jax_backbone(net)[0],
                                    jnp.zeros((1, T, S, S, 3)), seed=17,
                                    train=False)
    standard = from_jax_variables(params, stats)
    packed = pack_s3d_params(standard)
    want = from_jax_variables(jax_pack(params), jax_pack(stats))
    assert set(packed) == set(want)
    for key, val in packed.items():
        assert torch.equal(val, want[key]), key
    back = unpack_s3d_params(packed)
    assert set(back) == set(standard)
    assert all(torch.equal(back[k], standard[k]) for k in standard)
    prefixed = {"backbone." + k: v for k, v in standard.items()}
    assert set(unpack_s3d_params(pack_s3d_params(prefixed))) == set(prefixed)

    std_model, _ = select_backbone(net)
    std_model.load_state_dict(standard)
    pkd_model, _ = select_backbone(net + "_packed")
    pkd_model.load_state_dict(packed)
    x = torch.from_numpy(backbone_input(SIZE, seed=18)[0])
    with torch.no_grad():
        a = std_model.eval()(x)
        b = pkd_model.eval()(x)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-6, rtol=0)


def test_packed_block_diagonal_zeros_get_no_gradient():
    """The block-diagonal kernels are built in the forward from their two
    blocks: the blocks are the only parameters, each gets its gradient."""
    torch.manual_seed(0)
    model, _ = select_backbone("s3d_packed")
    names = {n.split(".", 1)[1] for n, _ in model.named_parameters()
             if n.startswith("Mixed_3b.")}
    assert {"conv1x1_kernel", "spatial_b1_kernel", "spatial_b2_kernel",
            "temporal_b1_kernel", "temporal_b2_kernel", "bn1x1.weight",
            "bn_spatial.weight", "bn_temporal.weight"} <= names
    block = model.Mixed_5c.train()
    x = torch.randn(2, block.conv1x1_kernel.shape[1], 2, 3, 3)
    block(x).square().sum().backward()
    for name in ("spatial_b1_kernel", "spatial_b2_kernel",
                 "temporal_b1_kernel", "temporal_b2_kernel"):
        grad = getattr(block, name).grad
        assert grad is not None and grad.abs().sum() > 0, name
