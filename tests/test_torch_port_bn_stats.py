"""The port's channel sums (dualvar_tpu_torch.ops.bn_stats) and its one-pass
batch norm (models/layers.py:_OnePassBN) against the JAX package's
``channel_sums`` (Pallas kernel in interpret mode) and ``_bn_train_fused``
with its Pallas statistics, on the CPU.

On CPU tensors ``channel_sums`` takes its plain version; the CUDA kernel is
held against that version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.models import layers as JLy
from dualvar_tpu.ops import bn_stats as JB
from dualvar_tpu_torch.models import layers as TLy
from dualvar_tpu_torch.ops import bn_stats as TB

import torch_port_util  # noqa: F401  (caps torch's threads)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(shape, dtype, seed):
    """The same values as a JAX array and a torch tensor of ``dtype``: both
    round the same float32 numbers to nearest even."""
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(a).astype(_JDT[dtype]), torch.from_numpy(a).to(
        _TDT[dtype])


# the shape / dtype cases and tolerances of tests/test_bn_stats.py
@pytest.mark.parametrize("shape,dtype", [
    ((4, 6, 8, 8, 64), "float32"),
    ((2, 3, 5, 7, 128), "bfloat16"),
    ((16, 512), "float32"),
    ((7, 64), "bfloat16"),
])
def test_channel_sums_plain_matches_jax_interpret(shape, dtype):
    ja, ta = _pair(shape, dtype, 0)
    jb, tb = _pair(shape, dtype, 1)
    want1, want2 = JB.channel_sums(ja, jb, interpret=True)
    got1, got2 = TB.channel_sums(ta, tb)  # CPU tensors: the plain version
    assert got1.dtype == got2.dtype == torch.float32
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=2e-6,
                               atol=2e-4)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=2e-6,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_sums_over_dim_1_of_ncdhw_equals_channels_last(dtype):
    """The batch norm's form, dim=1 of (N, C, T, H, W), in NCDHW and in
    channels_last_3d memory, against the JAX package's channels-last form;
    and a = b (the forward statistics)."""
    ja, ta = _pair((2, 3, 5, 7, 16), dtype, 2)
    jb, tb = _pair((2, 3, 5, 7, 16), dtype, 3)
    want1, want2 = JB.channel_sums(ja, jb, interpret=True)
    ncdhw_a, ncdhw_b = ta.permute(0, 4, 1, 2, 3), tb.permute(0, 4, 1, 2, 3)
    for a, b in ((ncdhw_a.contiguous(), ncdhw_b.contiguous()),
                 (ncdhw_a.contiguous(memory_format=torch.channels_last_3d),
                  ncdhw_b.contiguous(memory_format=torch.channels_last_3d))):
        got1, got2 = TB.channel_sums(a, b, dim=1)
        np.testing.assert_allclose(got1.numpy(), np.asarray(want1),
                                   rtol=2e-6, atol=2e-4)
        np.testing.assert_allclose(got2.numpy(), np.asarray(want2),
                                   rtol=2e-6, atol=2e-4)
    sq1, sq2 = TB.channel_sums(ncdhw_a, ncdhw_a, dim=1)
    want_sq = JB.channel_sums(ja, ja, interpret=True)
    np.testing.assert_allclose(sq1.numpy(), np.asarray(want_sq[0]),
                               rtol=2e-6, atol=2e-4)
    np.testing.assert_allclose(sq2.numpy(), np.asarray(want_sq[1]),
                               rtol=2e-6, atol=2e-4)


def test_channel_sums_plain_keeps_float64():
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 4, 5)))
    s1, s2 = TB.channel_sums_plain(x, x, dim=1)
    assert s1.dtype == s2.dtype == torch.float64
    np.testing.assert_allclose(s1.numpy(), x.numpy().sum(axis=(0, 2)),
                               rtol=1e-14)
    np.testing.assert_allclose(s2.numpy(), (x.numpy() ** 2).sum(axis=(0, 2)),
                               rtol=1e-14)


def test_channel_sums_refuses_mismatched_inputs():
    a = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="must match"):
        TB.channel_sums(a, torch.zeros(2, 3, 5))
    with pytest.raises(ValueError, match="must match"):
        TB.channel_sums(a, a.to(torch.bfloat16))


@pytest.mark.parametrize("shape,memory_format,want", [
    ((16, 64, 16, 56, 56), torch.contiguous_format, (16, 64, 50176)),
    ((16, 64, 16, 56, 56), torch.channels_last_3d, (802816, 64, 1)),
    ((16, 512, 2, 7, 7), torch.contiguous_format, (16, 512, 98)),
    ((16, 512, 2, 7, 7), torch.channels_last_3d, (1568, 512, 1)),
])
def test_kernel_view_of_the_r3d_maps(shape, memory_format, want):
    """(outer, C, inner) as the kernel reads a batch norm's map, for path
    R's largest and smallest maps in both layouts (meta tensors: no data)."""
    x = torch.empty(shape, device="meta").contiguous(
        memory_format=memory_format)
    assert TB._view(x, 1) == want


def test_kernel_view_refuses_other_layouts():
    x = torch.empty(4, 8, 6, device="meta").transpose(0, 2)
    with pytest.raises(ValueError, match="contiguous or channels-last"):
        TB._view(x, 1)


@pytest.mark.parametrize("outer,C,inner,vec", [
    (16, 64, 50176, 8),      # path R, stem / layer 1, NCDHW
    (16, 128, 6272, 8),      # layer 2
    (16, 256, 784, 8),       # layer 3
    (16, 512, 98, 1),        # layer 4: 98 is no multiple of 8
    (802816, 64, 1, 8),      # layer 1, channels_last_3d
    (1568, 512, 1, 8),       # layer 4, channels_last_3d
    (1003, 24, 1, 1),        # rows no multiple of any block size
    (3, 4096, 1, 8),         # more columns than a block has threads
    (1, 3, 5, 1),
])
def test_kernel_grid_covers_every_element_once(outer, C, inner, vec):
    """The grid the wrapper gives the kernel: every row and every vector of
    the reduced axes falls in exactly one block, and the large maps get
    enough blocks to fill 132 SMs."""
    p0, p1, isplit, nsplit, ncolgroups = TB._grid(outer, C, inner, vec)
    if inner == 1:
        cols = C // vec
        per_iter = 256 // min(256, cols)
        assert p1 % per_iter == 0 and isplit == 1
        assert (nsplit - 1) * p1 < outer <= nsplit * p1
        assert (ncolgroups - 1) * 256 < cols <= ncolgroups * 256
        blocks = nsplit * ncolgroups
    else:
        nvec = inner // vec
        assert (isplit - 1) * p1 < nvec <= isplit * p1
        osplit = nsplit // isplit
        assert nsplit % isplit == 0
        assert (osplit - 1) * p0 < outer <= osplit * p0
        blocks = nsplit * C
    if outer * C * inner >= 1 << 20:
        assert blocks >= 132, blocks


def _jax_bn_pallas(monkeypatch):
    """``_bn_train_fused`` with its statistics through the Pallas kernel in
    interpret mode, set up as tests/test_bn_stats.py does."""
    monkeypatch.setenv("DUALVAR_BN_STATS", "pallas")
    orig = JB._channel_sums_2d
    monkeypatch.setattr(JB, "_channel_sums_2d",
                        lambda a2, b2, interpret=False: orig(
                            a2, b2, interpret=True))


def test_one_pass_bn_matches_jax_with_pallas_stats(monkeypatch):
    """(y, mu, var) and, under a fixed cotangent, (dx, dscale, dbias) of the
    port's one-pass batch norm (plain sums, float32) against the JAX
    package's, with the tolerances of tests/test_bn_stats.py."""
    import jax

    _jax_bn_pallas(monkeypatch)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 3, 5, 5, 64)).astype(np.float32)  # NTHWC
    scale = np.full(64, 1.3, np.float32)
    bias = np.full(64, 0.2, np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)

    yj, muj, varj = JLy._bn_train_fused(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(bias), 1e-5)

    def f(xx, sc, bi):
        y, _, _ = JLy._bn_train_fused(xx, sc, bi, 1e-5)
        return jnp.sum(y * ct)

    dxj, dscj, dbij = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))

    xt = torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    yt, mut, vart = TLy._OnePassBN.apply(xt, st, bt, 1e-5)
    (yt * torch.from_numpy(ct.transpose(0, 4, 1, 2, 3).copy())).sum() \
        .backward()
    np.testing.assert_allclose(mut.numpy(), np.asarray(muj), atol=1e-5)
    np.testing.assert_allclose(vart.numpy(), np.asarray(varj), atol=1e-5)
    np.testing.assert_allclose(yt.detach().numpy().transpose(0, 2, 3, 4, 1),
                               np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 4, 1),
                               np.asarray(dxj), atol=2e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(dscj), atol=2e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(dbij), atol=2e-4)
    assert not mut.requires_grad and not vart.requires_grad


def _counting_sums(monkeypatch):
    calls = []
    orig = TLy.channel_sums

    def counted(a, b, dim=-1):
        calls.append((tuple(a.shape), a is b))
        return orig(a, b, dim)

    monkeypatch.setattr(TLy, "channel_sums", counted)
    return calls


def test_variable_switches_batchnorm_and_running_stats_agree(monkeypatch):
    """DUALVAR_BN_STATS=pallas sends BatchNorm's two reductions through
    channel_sums (forward with a = b, backward with (g, x)); unset, ATen's
    batch norm runs and channel_sums is not called. Outputs, gradients and
    the running statistics agree between the two."""
    calls = _counting_sums(monkeypatch)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(1.0, 2.0, (3, 8, 2, 4, 5))
                         .astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    results = {}
    for flag in ("xla", "pallas"):
        monkeypatch.setenv("DUALVAR_BN_STATS", flag)
        assert TB.use_kernel_stats() == (flag == "pallas")
        torch.manual_seed(0)
        bn = TLy.BatchNorm(8)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_()
        bn.train()
        xx = x.clone().requires_grad_()
        del calls[:]
        y = bn(xx)
        n_fwd = len(calls)
        (y * ct).sum().backward()
        results[flag] = (y.detach(), xx.grad, bn.weight.grad, bn.bias.grad,
                         bn.running_mean.clone(), bn.running_var.clone())
        if flag == "pallas":
            assert n_fwd == 1 and calls[0] == ((3, 8, 2, 4, 5), True)
            assert len(calls) == 2 and calls[1] == ((3, 8, 2, 4, 5), False)
        else:
            assert calls == []
    for got, want in zip(results["pallas"], results["xla"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                   rtol=1e-5)
    monkeypatch.delenv("DUALVAR_BN_STATS")
    assert not TB.use_kernel_stats()  # off by default


def test_one_pass_bn_on_channels_last_3d_maps(monkeypatch):
    """A channels_last_3d map (the layout a later PR may adopt) gives the
    same y and gradients as the NCDHW one; a gradient arriving in the other
    layout is brought to the map's before the sums."""
    monkeypatch.setenv("DUALVAR_BN_STATS", "pallas")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 16, 3, 4, 5)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    out = []
    for fmt in (torch.contiguous_format, torch.channels_last_3d):
        bn = TLy.BatchNorm(16).train()
        xx = x.clone(memory_format=fmt).requires_grad_()
        y = bn(xx)
        (y * ct).sum().backward()  # ct is NCDHW: the other layout for CL
        assert xx.grad.shape == x.shape
        out.append((y.detach(), xx.grad, bn.weight.grad, bn.running_var))
    for got, want in zip(*out):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_float64_takes_the_torch_sums_as_the_jax_package_does(monkeypatch):
    """Float64 maps keep float64 sums and never reach channel_sums, the JAX
    package's own rule (``_use_pallas_stats``)."""
    calls = _counting_sums(monkeypatch)
    monkeypatch.setenv("DUALVAR_BN_STATS", "pallas")
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 4, 3, 3, 3))).requires_grad_()
    bn = TLy.BatchNorm(4).double().train()
    bn(x).square().sum().backward()
    assert calls == []
    mean = x.detach().numpy().mean(axis=(0, 2, 3, 4))
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean,
                               rtol=1e-12)
