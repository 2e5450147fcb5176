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


def _chunks(esize: int, bits: int) -> int:
    """Elements a chunk of the plan: 16 bytes' worth, or one."""
    return 16 // esize if bits & 2 else 1


def _run_chunks(inner: int, vec: int, nch: int, rho: int, aligned: bool):
    """[lo, hi) of chunks k = 0..nch-1 of a run of ``inner`` elements that
    starts ``rho`` elements past a chunk boundary, relative to the run, as
    the planar kernel reads them (empty where the chunk misses the run)."""
    out = []
    for k in range(nch):
        q = k * vec if aligned else -rho + k * vec
        out.append((max(0, q), min(inner, q + vec)))
    return out


# (outer, C, inner, esize, mis): path R's maps at B=8 (16 clips) in both
# layouts, path G's (S3D-G at B=8: 24 clips, then 8), short and ragged runs,
# data off a 16-byte boundary, one channel, more channels than a block
_PLAN_CASES = [
    (16, 64, 50176, 2, 0),    # path R, stem / layer 1, NCDHW
    (16, 128, 6272, 2, 0),    # layer 2
    (16, 256, 784, 2, 0),     # layer 3
    (16, 512, 98, 2, 0),      # layer 4: a run of 98 (no whole chunks)
    (802816, 64, 1, 2, 0),    # layer 1, channels_last_3d
    (1568, 512, 1, 2, 0),     # layer 4, channels_last_3d
    (1003, 24, 1, 4, 0),      # rows no multiple of any block size
    (3, 4096, 1, 2, 0),       # more columns than a block has threads
    (1, 3, 5, 4, 0),
    (24, 64, 50176, 2, 0),    # path G, Conv_1a (its largest map)
    (24, 16, 1568, 2, 0),     # path G, width 16
    (8, 384, 18, 2, 0),       # path G, width 384: runs of 18
    (24, 320, 196, 2, 0),     # path G, runs of 196
    (16, 512, 98, 2, 3),      # off a 16-byte boundary
    (5, 1, 777, 4, 1),        # one channel, ragged, off a boundary
]


@pytest.mark.parametrize("outer,C,inner,esize,mis", _PLAN_CASES)
@pytest.mark.parametrize("same", [True, False])
def test_kernel_grid_covers_every_element_once(outer, C, inner, esize, mis,
                                               same):
    """The plan the wrapper gives the kernel: every slot (chunk of a run)
    of a channel falls in exactly one block, the chunks of every run
    (at each offset its rows take against a 16-byte boundary) cover each of
    its elements exactly once, every channels-last row falls in exactly one
    block, and a map of 132 blocks' worth of bytes (one batch a block,
    planar) gets at least 132 blocks."""
    bits, pmis, nch, per, nsplit = TB._plan(outer, C, inner, esize, mis,
                                            True, same)
    vec = _chunks(esize, bits)
    assert vec == 16 // esize  # a and b alike: always 16-byte chunks
    if inner == 1:
        assert (nsplit - 1) * per < outer <= nsplit * per
        cols = C // vec
        groups = -(-cols // 256)
        assert groups * 256 >= cols
        assert 2 * nsplit * C <= TB._PARTIALS
        blocks = nsplit * groups
    else:
        aligned = bool(bits & 4)
        assert aligned == (mis == 0 and inner % vec == 0) and pmis == mis
        nslots = outer * nch
        assert (nsplit - 1) * per < nslots <= nsplit * per
        assert 2 * nsplit * C <= TB._PARTIALS and nsplit <= TB._MAX_SPLIT
        batch = TB._THREADS * TB._UNROLL
        if C * nslots > TB._FILL_BLOCKS * batch:  # one wave of long blocks
            assert C * nsplit <= max(C, TB._FILL_BLOCKS)
        elif nsplit > 1:  # blocks of one batch; up to two in one block
            assert per == batch and nslots > 2 * batch
        # the offsets runs start at: (row * inner + mis) mod vec
        for rho in {(r * inner + mis) % vec for r in range(min(outer * C,
                                                               vec))}:
            seen = np.zeros(inner, np.int64)
            for lo, hi in _run_chunks(inner, vec, nch, rho, aligned):
                seen[max(lo, 0):max(hi, 0)] += 1
            assert (seen == 1).all()
        blocks = C * nsplit
        # 132 blocks' worth of one batch each
        if C * nslots >= 132 * TB._THREADS * TB._UNROLL:
            assert blocks >= 132, blocks
    if inner == 1 and outer * C * esize * (1 if same else 2) >= (
            132 * TB._ROWS_BLOCK_BYTES):
        assert blocks >= 132, blocks


def _fma(x, y, s):
    """fmaf in float32 (the product is exact in float64)."""
    return (x.astype(np.float64) * y + s).astype(np.float32)


def _warp_sum(v):
    """Lane 0 of the kernel's shuffle-down tree over 32 lanes."""
    v = v.astype(np.float32).copy()
    for off in (16, 8, 4, 2, 1):
        v[:32 - off] = v[:32 - off] + v[off:32]
    return v[0]


def _block_sum(v):
    """Thread 0 of the kernel's ``block_sum``: each warp's tree, then the
    warps in order."""
    total = np.float32(0)
    for w in range(0, TB._THREADS, 32):
        total = np.float32(total + _warp_sum(v[w:w + 32]))
    return total


def _emulate_planar(a, b, outer, C, inner, plan, esize):
    """channel_sums_planar_kernel in numpy float32, in its order: each
    block's threads add their chunks (``_UNROLL`` slots a thread a batch,
    the elements of a chunk inside its run in order), the block's fixed
    tree; a channel of several blocks: its last block adds the partials
    thread by thread in split order, then its tree."""
    bits, mis, nch, per, nsplit = plan
    vec = _chunks(esize, bits)
    aligned = bool(bits & 4) or vec == 1
    nslots = outer * nch
    threads = np.arange(TB._THREADS)
    out = np.zeros((2, C), np.float32)
    for c in range(C):
        partial = np.zeros((nsplit, 2), np.float32)
        for s in range(nsplit):
            j0, j1 = s * per, min(nslots, (s + 1) * per)
            s1 = np.zeros(TB._THREADS, np.float32)
            s2 = np.zeros(TB._THREADS, np.float32)
            for base in range(j0, j1, TB._THREADS * TB._UNROLL):
                for u in range(TB._UNROLL):
                    j = base + u * TB._THREADS + threads
                    valid = j < j1
                    o, k = j // nch, j % nch
                    run = (o * C + c) * inner
                    if aligned:
                        q = run + k * vec
                    else:
                        q = (run + mis) // vec * vec - mis + k * vec
                    for t in range(vec):
                        e = q + t
                        m = valid & (e >= run) & (e < run + inner)
                        e = np.clip(e, 0, a.size - 1)
                        x, y = a[e], b[e]
                        s1 = np.where(m, s1 + x, s1)
                        s2 = np.where(m, _fma(x, y, s2), s2)
            partial[s] = _block_sum(s1), _block_sum(s2)
        if nsplit == 1:
            out[:, c] = partial[0]
            continue
        t = np.zeros((TB._THREADS, 2), np.float32)
        for i in range(nsplit):
            t[i % TB._THREADS] = t[i % TB._THREADS] + partial[i]
        out[:, c] = _block_sum(t[:, 0]), _block_sum(t[:, 1])
    return out


def _emulate_rows(a, b, rows, C, plan, esize):
    """channel_sums_rows_kernel in numpy float32, in its order: each
    thread's columns over its rows, the block's rows of sums by channel in
    order, then the column group's last block: tps threads a sum over the
    splits sub, sub + tps, ..., and their sums in order."""
    bits, _, _, per, nsplit = plan
    vec = _chunks(esize, bits)
    a2, b2 = a.reshape(rows, C), b.reshape(rows, C)
    out = np.zeros((2, C), np.float32)
    cols = C // vec
    for col0 in range(0, cols, 256):
        cols_blk = min(256, cols - col0)
        rpi = 256 // cols_blk
        ng = cols_blk * vec
        chans = col0 * vec + np.arange(ng)
        partial = np.zeros((nsplit, 2, ng), np.float32)
        for s in range(nsplit):
            r0, r1 = s * per, min(rows, (s + 1) * per)
            # red[k][q, j]: thread (q, j // vec)'s sum of channel j
            red = np.zeros((2, rpi, ng), np.float32)
            for q in range(rpi):
                for r in range(r0 + q, r1, rpi):
                    x, y = a2[r, chans], b2[r, chans]
                    red[0, q] = red[0, q] + x
                    red[1, q] = _fma(x, y, red[1, q])
            acc = np.zeros((2, ng), np.float32)
            for q in range(rpi):
                acc = acc + red[:, q]
            partial[s] = acc
        if nsplit == 1:
            out[:, chans] = partial[0]
            continue
        tps = 1
        while 2 * tps * 2 * ng <= 256:
            tps *= 2
        total = np.zeros((2, ng), np.float32)
        for sub in range(tps):
            part = np.zeros((2, ng), np.float32)
            for q in range(sub, nsplit, tps):
                part = part + partial[q]
            total = total + part
        out[:, chans] = total
    return out


def _emulate(a, b, dim, mis=0):
    """The kernel's sums of torch tensors ``a``, ``b`` (CPU, float32 or
    bfloat16, contiguous or channels_last_3d) by the wrapper's plan, with
    the data taken to start ``mis`` elements past a 16-byte boundary."""
    outer, C, inner = TB._view(a, dim)
    esize = a.element_size()
    plan = TB._plan(outer, C, inner, esize, mis,
                    inner > 1 or C % (16 // esize) == 0, b is a)
    # memory order, as float32 values
    mem = [t.float().permute(*_memory_perm(t)).contiguous().numpy().ravel()
           for t in (a, b)]
    if inner == 1:
        return _emulate_rows(mem[0], mem[1], outer, C, plan, esize), plan
    return _emulate_planar(mem[0], mem[1], outer, C, inner, plan,
                           esize), plan


def _memory_perm(t):
    """The dimension order of ``t``'s memory, outermost first."""
    return sorted(range(t.dim()), key=lambda d: -t.stride()[d])


def _magnitudes(a, b, dim):
    """float64 reference sums and summed magnitudes over every axis but
    ``dim``."""
    a64, b64 = a.double(), b.double()
    dims = [d for d in range(a.dim()) if d != dim % a.dim()]
    return ((a64.sum(dims), (a64 * b64).sum(dims)),
            (a64.abs().sum(dims), (a64 * b64).abs().sum(dims)))


# (shape, dtype, memory format, mis, split): NCDHW maps with runs of 98,
# 18, 196, whole chunks and ragged ones, channels-last rows, one channel, a
# map smaller than one block, data off a 16-byte boundary; split: several
# blocks a channel (or a column group), combined
_EMU_CASES = [
    ((2, 8, 2, 7, 7), "bfloat16", torch.contiguous_format, 0, False),
    ((3, 16, 2, 3, 3), "bfloat16", torch.contiguous_format, 0, False),
    ((96, 3, 4, 7, 7), "bfloat16", torch.contiguous_format, 5, True),
    ((16, 12, 4, 7, 7), "bfloat16", torch.contiguous_format, 5, False),
    ((4, 3, 8, 28, 30), "bfloat16", torch.contiguous_format, 0, True),
    ((2, 2, 20, 50, 60), "bfloat16", torch.contiguous_format, 0, True),
    ((2, 3, 5, 31, 37), "float32", torch.contiguous_format, 3, True),
    ((4, 1, 3, 5, 7), "float32", torch.contiguous_format, 1, False),
    ((2, 8, 1, 3, 5), "bfloat16", torch.contiguous_format, 0, False),
    ((3, 24, 7, 11, 13), "bfloat16", torch.channels_last_3d, 0, True),
    ((3, 24, 7, 11, 13), "float32", torch.channels_last_3d, 0, True),
    ((2, 3, 5, 7, 11), "float32", torch.channels_last_3d, 0, False),
]


@pytest.mark.parametrize("shape,dtype,fmt,mis,split", _EMU_CASES)
@pytest.mark.parametrize("same", [True, False])
def test_kernel_plan_emulation_matches_plain(shape, dtype, fmt, mis, split,
                                             same):
    """The kernel's arithmetic replayed in numpy, block by block in its own
    order and combined as it combines, against float64 sums and against
    ``channel_sums_plain``: within 1e-6 of the summed magnitudes."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.normal(size=shape) * 2 + 0.5).astype(
        np.float32)).to(_TDT[dtype]).contiguous(memory_format=fmt)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        _TDT[dtype]).contiguous(memory_format=fmt)
    a, b = (x, x) if same else (g, x)
    got, plan = _emulate(a, b, 1, mis)
    (r1, r2), (m1, m2) = _magnitudes(a, b, 1)
    p1, p2 = TB.channel_sums_plain(a, b, dim=1)
    for k, (ref, mag, plain) in enumerate(((r1, m1, p1), (r2, m2, p2))):
        tol = 1e-6 * mag.numpy()
        assert (np.abs(got[k] - ref.numpy()) <= tol).all(), (k, plan)
        assert (np.abs(got[k] - plain.numpy()) <= tol).all(), (k, plan)
    assert (plan[4] > 1) == split, plan


@pytest.mark.parametrize("shape,dtype", [
    ((4, 6, 8, 8, 64), "float32"),
    ((2, 3, 5, 7, 128), "bfloat16"),
    ((16, 512), "float32"),
    ((3, 2, 7, 7, 24), "bfloat16"),
])
def test_kernel_plan_emulation_matches_jax_interpret(shape, dtype):
    """The kernel's arithmetic replayed in numpy against the JAX package's
    Pallas kernel in interpret mode, on its channels-last arrays (dim -1)
    and on the port's NCDHW form of the same values (dim 1)."""
    ja, ta = _pair(shape, dtype, 0)
    jb, tb = _pair(shape, dtype, 1)
    want = np.stack([np.asarray(w) for w in JB.channel_sums(
        ja, jb, interpret=True)])
    got, _ = _emulate(ta, tb, -1)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-4)
    if len(shape) == 5:
        perm = (0, 4, 1, 2, 3)
        got, _ = _emulate(ta.permute(perm).contiguous(),
                          tb.permute(perm).contiguous(), 1, mis=1)
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-4)


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
