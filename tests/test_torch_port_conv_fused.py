"""The port's 3x3x3 conv + BN-statistics function
(dualvar_tpu_torch.ops.conv_fused) against the JAX package's
``_fused_fwd`` (Pallas kernel in interpret mode), ``conv3d_bn_stats_xla``
and the custom-VJP backward ``_bwd``, on the CPU.

On CPU tensors the forward takes its plain version; the CUDA kernels are
held against that version, and against float64 sums of their own output, on
the card by ``chip_smoke.py``. What the kernels' index plans do is held here
instead: ``_emulate_tensor_cores`` replays the bfloat16 route's blocks, boxes
and packed weights in float32, and ``_emulate_split_tf32`` the float32
route's split-TF32 arithmetic (test-only emulations; nothing on the main
path calls them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.ops import conv_fused as JC
from dualvar_tpu_torch.ops import conv_fused as TC

import torch_port_util  # noqa: F401  (caps torch's threads)

SHAPE, WSHAPE = (2, 3, 6, 6, 8), (3, 3, 3, 8, 8)  # tests/test_conv_fused.py


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    w = (rng.standard_normal(WSHAPE) * 0.2).astype(np.float32)
    return x, w


def test_plain_matches_jax_interpret_kernel_and_xla():
    """With the tolerances of tests/test_conv_fused.py."""
    x, w = _inputs(0)
    got = TC.conv3d_bn_stats_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got[0].shape == SHAPE and got[1].dtype == torch.float32
    for want in (JC._fused_fwd(jnp.asarray(x), jnp.asarray(w),
                               interpret=True),
                 JC.conv3d_bn_stats_xla(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=1e-4)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   atol=1e-3)


def test_forward_on_cpu_is_the_plain_version_without_a_graph():
    x, w = (torch.from_numpy(a).requires_grad_() for a in _inputs(1))
    got = TC.conv3d_bn_stats_forward(x, w)
    want = TC.conv3d_bn_stats_plain(x.detach(), w.detach())
    for g, wnt in zip(got, want):
        assert not g.requires_grad
        assert torch.equal(g, wnt)
    # no kernel of either route on the CPU
    assert TC.tensor_core_forward.launches == 0
    assert TC.split_tf32_forward.launches == 0


def test_backward_matches_jax_bwd_on_the_same_residuals():
    """The port's backward against ``conv_fused._bwd`` driven with the same
    residuals (x, w, y) and cotangents, tolerances of
    tests/test_conv_fused.py."""
    x, w = _inputs(2)
    y, s1, _ = JC.conv3d_bn_stats_xla(jnp.asarray(x), jnp.asarray(w))
    cots = (jnp.cos(y), jnp.full_like(s1, 0.3), jnp.full_like(s1, 0.1))
    gx_j, gw_j = JC._bwd((jnp.asarray(x), jnp.asarray(w), y), cots)
    gx_t, gw_t = TC.conv3d_bn_stats_backward(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(np.array(y)),
        *(torch.from_numpy(np.array(c)) for c in cots))
    assert gx_t.shape == SHAPE and gw_t.shape == WSHAPE
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), atol=2e-4)
    np.testing.assert_allclose(gw_t.numpy(), np.asarray(gw_j), atol=2e-3)


def test_autograd_matches_jax_grad_of_the_xla_contract():
    """The differentiable function end to end: d/dx and d/dw of
    sum(sin y) + 0.3 sum(s1) + 0.1 sum(s2) against jax.grad of the same
    loss on ``conv3d_bn_stats_xla``."""
    x, w = _inputs(3)

    def loss_ref(x, w):
        y, s1, s2 = JC.conv3d_bn_stats_xla(x, w)
        return jnp.sum(jnp.sin(y)) + jnp.sum(s1 * 0.3) + jnp.sum(s2 * 0.1)

    gx_j, gw_j = jax.grad(loss_ref, argnums=(0, 1))(jnp.asarray(x),
                                                     jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y, s1, s2 = TC.conv3d_bn_stats(xt, wt)
    (y.sin().sum() + 0.3 * s1.sum() + 0.1 * s2.sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=2e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=2e-3)


def test_channels_last_3d_map_is_the_jax_layout_without_a_copy():
    """An NCDHW map in channels_last_3d memory, permuted to (N, T, H, W, C),
    is contiguous: the kernel takes it as it is."""
    x, w = _inputs(4)
    ncdhw = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous(
        memory_format=torch.channels_last_3d)
    view = ncdhw.permute(0, 2, 3, 4, 1)
    assert view.is_contiguous() and view.data_ptr() == ncdhw.data_ptr()
    got = TC.conv3d_bn_stats_plain(view, torch.from_numpy(w))
    want = TC.conv3d_bn_stats_plain(torch.from_numpy(x), torch.from_numpy(w))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt.numpy(), atol=1e-5)


def test_refuses_what_is_not_a_3x3x3_conv():
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match=r"\(3, 3, 3, C, Co\)"):
        TC.conv3d_bn_stats_forward(x, torch.zeros(1, 3, 3, 8, 8))
    with pytest.raises(ValueError, match=r"\(3, 3, 3, C, Co\)"):
        TC.conv3d_bn_stats_forward(x, torch.zeros(3, 3, 3, 4, 8))


@pytest.mark.parametrize("dims,want", [
    ((16, 16, 56, 56, 64, 64), (2, 64, 16 * 16 * 14)),   # path R's layer 1
    ((16, 8, 28, 28, 128, 128), (4, 128, 16 * 8 * 7)),  # layer 2
    ((16, 2, 7, 7, 512, 512), (16, 512, 16 * 2 * 2)),   # layer 4
    ((1, 4, 12, 70, 128, 96), (4, 128, 4 * 3 * 2)),     # two w tiles, Co 96
    ((2, 5, 9, 13, 24, 40), (1, 64, 2 * 5 * 3)),        # ragged
])
def test_tiling_fits_a_block(dims, want):
    """The float32 route's plan: (32-channel chunks, padded Co, blocks of 4
    rows x 64 w along the positions); its two 96 KB stages, with the
    block's 4 KB of sums, fit a block's 227 KB of shared memory."""
    assert TC._f32_plan(*dims) == want
    assert TC._F32_SMEM == 2 * 98304 + 1024
    assert TC._F32_SMEM + 2 * 8 * 64 * 4 <= TC._MAX_SMEM


def _box(x, n, t, h0, w0, c0, rows):
    """What one TMA load of the bfloat16 route brings: x[n, t, h0 : h0 +
    rows, w0 : w0 + 64, c0 : c0 + 64] with zeros wherever the coordinates
    fall outside x (negative ones included), as (rows, 64, 64)."""
    _, T, H, W, C = x.shape
    box = torch.zeros(rows, TC._TC_W, TC._TC_C, dtype=x.dtype)
    if not 0 <= t < T:
        return box
    hs, ws, cs = (range(max(a, 0), min(a + k, m)) for a, k, m in
                  ((h0, rows, H), (w0, TC._TC_W, W), (c0, TC._TC_C, C)))
    if len(hs) and len(ws) and len(cs):
        box[hs.start - h0:hs.stop - h0, ws.start - w0:ws.stop - w0,
            cs.start - c0:cs.stop - c0] = x[n, t, hs.start:hs.stop,
                                           ws.start:ws.stop, cs.start:cs.stop]
    return box


def _emulate_tensor_cores(x, w):
    """The bfloat16 route's plan in plain torch, in x's dtype with float32
    sums: blocks of 8 output rows x 64 w of one (n, t) and 64 output
    channels, decoded from the block index as the kernel does (w tile
    fastest); K-steps (chunk, dt, dw), frames outside the clip skipped; ONE
    box a step, rows h0 - 1 .. h0 + 8, whose rows r + dh feed output row r
    with the packed weight of tap (3 dt + dw) 3 + dh; y rounded to x's
    dtype; per-block sums of the rounded y over the valid positions, added
    in block order. Returns (y, s1, s2)."""
    N, T, H, W, C = x.shape
    Co = w.shape[4]
    rows, bw, bc, bco = TC._TC_ROWS, TC._TC_W, TC._TC_C, TC._TC_CO
    nchunk, co_pad, grid_x = TC._tc_plan(N, T, H, W, C, Co)
    # w used in x's dtype, as the kernel's bf16 operands use it
    wp = TC.pack_weight(w, nchunk * bc, co_pad, dtype=x.dtype).float()
    nwt, nhb = -(-W // bw), -(-H // rows)
    y = torch.zeros((N, T, H, W, Co), dtype=x.dtype)
    partial = torch.zeros((2, Co, grid_x))
    for blk in range(grid_x):
        wt, hb = blk % nwt, (blk // nwt) % nhb
        t, n = (blk // (nwt * nhb)) % T, blk // (nwt * nhb * T)
        h0, w0 = hb * rows, wt * bw
        nh, nw = min(rows, H - h0), min(bw, W - w0)
        dts = [dt for dt in range(3) if 0 <= t + dt - 1 < T]
        for co0 in range(0, co_pad, bco):
            acc = torch.zeros(rows, bw, bco)
            for c0 in range(0, nchunk * bc, bc):
                for dt in dts:
                    for dw in range(3):
                        box = _box(x, n, t + dt - 1, h0 - 1, w0 + dw - 1, c0,
                                   rows + 2).float()
                        for dh in range(3):
                            wtap = wp[(3 * dt + dw) * 3 + dh,
                                      co0:co0 + bco, c0:c0 + bc]
                            acc += box[dh:dh + rows] @ wtap.T
            out = acc.to(x.dtype)[:nh, :nw, :max(0, min(bco, Co - co0))]
            y[n, t, h0:h0 + nh, w0:w0 + nw, co0:co0 + out.shape[-1]] = out
            r = out.float().reshape(-1, out.shape[-1])
            partial[0, co0:co0 + r.shape[1], blk] = r.sum(0)
            partial[1, co0:co0 + r.shape[1], blk] = (r * r).sum(0)
    return y, partial[0].sum(-1), partial[1].sum(-1)


@pytest.mark.parametrize("shape,Co", [
    ((2, 5, 9, 13, 24), 40),   # ragged: C < 64, Co < 64, H not a band multiple
    ((1, 3, 4, 70, 16), 16),   # W > 64: two w tiles, the second of 6
    ((1, 2, 3, 5, 72), 8),     # C > 64: two channel chunks, the second of 8
])
def test_tensor_core_plan_emulation_matches_plain_and_xla(shape, Co):
    """The bfloat16 route's boxes, taps and packed weights, replayed in
    float32, give the plain version and the JAX ``conv3d_bn_stats_xla``
    (tolerances of tests/test_conv_fused.py)."""
    rng = np.random.default_rng(sum(shape) + Co)
    C = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    # y of about unit size, so the float32 sums stay inside the tolerances
    w = (rng.standard_normal((3, 3, 3, C, Co))
         * 0.5 / np.sqrt(27 * C)).astype(np.float32)
    got = _emulate_tensor_cores(torch.from_numpy(x), torch.from_numpy(w))
    plain = TC.conv3d_bn_stats_plain(torch.from_numpy(x), torch.from_numpy(w))
    xla = JC.conv3d_bn_stats_xla(jnp.asarray(x), jnp.asarray(w))
    for want in (tuple(t.numpy() for t in plain),
                 tuple(np.asarray(t) for t in xla)):
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-4)
        np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-3)


def test_tensor_core_plan_emulation_in_bfloat16_matches_plain():
    """In bfloat16 the emulation rounds the same float32 sums as the plain
    version (a float32 conv of the rounded inputs): y within one bf16 ulp,
    the sums within an ulp of the summed magnitudes."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 3, 9, 13, 24)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, 24, 16))
                          / np.sqrt(27 * 24)).astype(np.float32))
    y, s1, s2 = _emulate_tensor_cores(x, w)
    ref = TC.conv3d_bn_stats_plain(x.float(), w.to(torch.bfloat16).float())[0]
    assert y.dtype == torch.bfloat16
    assert float(((y.float() - ref).abs()
                  / (2.0 ** -8 * ref.abs() + 1e-4)).max()) <= 1.0
    yf = y.float().reshape(-1, 16)
    assert torch.allclose(s1, yf.sum(0), atol=1e-4)
    assert torch.allclose(s2, (yf * yf).sum(0), rtol=1e-5, atol=1e-4)


def test_pack_weight_orders_taps_dt_dw_dh_and_pads_with_zeros():
    w = torch.arange(3 * 3 * 3 * 5 * 6, dtype=torch.float32).reshape(
        3, 3, 3, 5, 6)
    wp = TC.pack_weight(w, 64, 64, dtype=torch.float32)
    assert wp.shape == (27, 64, 64) and wp.is_contiguous()
    for dt, dh, dw in ((0, 0, 0), (0, 2, 1), (1, 1, 2), (2, 0, 1)):
        tap = (3 * dt + dw) * 3 + dh
        assert torch.equal(wp[tap, :6, :5], w[dt, dh, dw].T)
    assert not wp[:, 6:].any() and not wp[:, :, 5:].any()
    assert TC.pack_weight(w, 64, 64).dtype == torch.bfloat16


@pytest.mark.parametrize("dims,want", [
    ((16, 16, 56, 56, 64, 64), (1, 64, 16 * 16 * 7)),   # path R's layer 1
    ((16, 8, 28, 28, 128, 128), (2, 128, 16 * 8 * 4)),  # layer 2
    ((2, 5, 9, 13, 24, 40), (1, 64, 2 * 5 * 2)),        # ragged
    ((1, 3, 4, 130, 16, 72), (1, 128, 3 * 3)),          # three w tiles
    ((0, 3, 4, 4, 8, 8), (1, 64, 0)),                   # empty
])
def test_tensor_core_plan(dims, want):
    """(channel chunks, padded Co, blocks along the positions)."""
    assert TC._tc_plan(*dims) == want


@pytest.mark.parametrize("x_dtype,C,Co,w_dtype,want", [
    (torch.bfloat16, 64, 64, torch.float32, "tensor_cores"),
    (torch.bfloat16, 24, 40, torch.bfloat16, "tensor_cores"),
    (torch.float32, 4, 8, torch.float32, "split_tf32"),
    (torch.float32, 64, 64, torch.bfloat16, "split_tf32"),
    (torch.bfloat16, 12, 64, torch.float32, ValueError),   # C % 8
    (torch.bfloat16, 64, 36, torch.float32, ValueError),   # Co % 8
    (torch.float32, 64, 12, torch.float32, ValueError),    # Co % 8
    (torch.float32, 3, 8, torch.float32, ValueError),      # C % 4
    (torch.float32, 24, 40, torch.float32, "split_tf32"),  # the ragged case
    (torch.float16, 64, 64, torch.float32, TypeError),
    (torch.float64, 64, 64, torch.float64, TypeError),
    (torch.bfloat16, 64, 64, torch.float16, TypeError),
])
def test_route_by_dtype(x_dtype, C, Co, w_dtype, want):
    """bf16 x -> the bf16 tensor-core kernel, float32 x -> the split-TF32
    one, each where TMA's 16-byte strides allow it; anything else raises:
    no route falls back to another."""
    x = torch.zeros((1, 2, 3, 4, C), dtype=x_dtype)
    w = torch.zeros((3, 3, 3, C, Co), dtype=w_dtype)
    if isinstance(want, str):
        assert TC._route(x, w) == want
    else:
        with pytest.raises(want):
            TC._route(x, w)


# ---------------------------------------------------------------------------
# the float32 route: split TF32
# ---------------------------------------------------------------------------

def _emulate_split_tf32(x, w, products=3):
    """The float32 route's arithmetic in plain torch, float32 throughout:
    x and the packed weight (``pack_weight_split``) split into tf32 hi and
    lo parts by the kernel's bit rule; for each output, K-steps in the
    kernel's order (32-channel chunk, dt, dw), each chunk in two halves of
    two K-steps of 8 (``_f32_k_order``); a half's products go into a fresh
    float32 sum, x_lo w_hi and x_hi w_lo for each (K-step, dh) first, then
    x_hi w_hi for each, an 8-term float32 product each, and that sum is
    added to the output's float32 accumulator. Frames outside the clip and
    SAME padding add zeros, which leave a float32 sum as it is.
    ``products=1``: x_hi w_hi alone, a plain TF32 convolution. Returns (y,
    s1, s2), the sums of y in float64 cast to float32."""
    N, T, H, W, C = x.shape
    Co = w.shape[4]
    nchunk, co_pad, _ = TC._f32_plan(N, T, H, W, C, Co)
    c_pad = nchunk * TC._F32_C
    wp = TC.pack_weight_split(w, c_pad, co_pad)
    xhi, xlo = TC.split_tf32(torch.nn.functional.pad(
        x.float(), (0, c_pad - C, 1, 1, 1, 1, 1, 1)))
    order = TC._f32_k_order().tolist()
    acc = torch.zeros((N, T, H, W, co_pad))

    def product(xs, tap, k, c0, dt, dh, dw):
        idx = torch.tensor([c0 + order[8 * k + j] for j in range(8)])
        win = (slice(None), slice(dt, dt + T), slice(dh, dh + H),
               slice(dw, dw + W))
        return xs[win].index_select(-1, idx) @ wp[
            tap, :, c0 + 8 * k:c0 + 8 * k + 8].T

    for c0 in range(0, c_pad, TC._F32_C):
        for dt in range(3):
            for dw in range(3):
                for half in range(2):
                    part = torch.zeros_like(acc)
                    steps = [(k, dh, (3 * dt + dw) * 3 + dh)
                             for k in (2 * half, 2 * half + 1)
                             for dh in range(3)]
                    if products == 3:
                        for k, dh, tap in steps:
                            part += product(xlo, tap, k, c0, dt, dh, dw)
                            part += product(xhi, 27 + tap, k, c0, dt, dh, dw)
                    for k, dh, tap in steps:
                        part += product(xhi, tap, k, c0, dt, dh, dw)
                    acc += part
    y = acc[..., :Co].contiguous()
    y64 = y.double()
    return (y, y64.sum(dim=(0, 1, 2, 3)).float(),
            (y64 * y64).sum(dim=(0, 1, 2, 3)).float())


def _conv64(x, w):
    """The convolution in float64: the reference both sides are held to."""
    return TC.conv3d_bn_stats_plain(torch.from_numpy(x).double(),
                                    torch.from_numpy(w).double())[0]


@pytest.mark.parametrize("shape,Co", [
    ((2, 5, 9, 13, 24), 40),   # ragged: C < 32, Co < 64, H not a block multiple
    ((1, 4, 8, 8, 64), 64),    # path R's layer-1 width: two chunks, K = 1728
])
def test_split_tf32_emulation_matches_plain_and_jax(shape, Co):
    """The float32 route's split, replayed, against the plain version, the
    JAX package's ``conv3d_bn_stats_xla`` and (square maps only) its
    Pallas kernel in interpret mode, on seeded numpy inputs: y within 1e-5
    (about ten float32 ulps of the largest |y|, 2.6), s1 and s2 within
    tests/test_conv_fused.py's tolerances; the emulation itself within 5e-6
    of a float64 convolution, as the plain float32 one is (measured 1.2e-6
    and 1.5e-6 against the plain version's 2.4e-6 and 0.5e-6)."""
    rng = np.random.default_rng(sum(shape) + Co)
    C = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, C, Co))
         * 0.5 / np.sqrt(27 * C)).astype(np.float32)
    got = _emulate_split_tf32(torch.from_numpy(x), torch.from_numpy(w))
    plain = TC.conv3d_bn_stats_plain(torch.from_numpy(x), torch.from_numpy(w))
    wants = [tuple(t.numpy() for t in plain),
             tuple(np.asarray(t) for t in JC.conv3d_bn_stats_xla(
                 jnp.asarray(x), jnp.asarray(w)))]
    if shape[2] == shape[3]:
        wants.append(tuple(np.asarray(t) for t in JC._fused_fwd(
            jnp.asarray(x), jnp.asarray(w), interpret=True)))
    for want in wants:
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-4)
        np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-3)
    ref = _conv64(x, w)
    assert float((got[0].double() - ref).abs().max()) <= 5e-6
    assert float((plain[0].double() - ref).abs().max()) <= 5e-6


def test_tf32_alone_breaks_the_float32_tolerance_where_the_split_holds():
    """Why the float32 route is not plain TF32: at K = 27 * 64 = 1728 and
    y of unit size (chip_smoke.py's inputs), x_hi w_hi alone lands more
    than ``CONV_ATOL`` = 1e-4 from a float64 convolution (1.4e-3 here), the
    split products over ten times inside it (3.4e-6, float32 accumulation's
    own error)."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 4, 8, 8, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 64, 64))
         / np.sqrt(27 * 64)).astype(np.float32)
    ref = _conv64(x, w)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    tf32 = float((_emulate_split_tf32(xt, wt, products=1)[0].double()
                  - ref).abs().max())
    split = float((_emulate_split_tf32(xt, wt)[0].double() - ref).abs().max())
    assert tf32 > 1e-4 > 10 * split, (tf32, split)


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    """``_tf32`` keeps 10 mantissa bits, rounding to the nearest (ties away
    from zero) as the kernel's ``tf32_rna``; hi + lo gives back v within
    2**-21 of |v|."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy((rng.standard_normal(100000)
                          * 2.0 ** rng.integers(-20, 20, 100000)).astype(
                              np.float32))
    hi, lo = TC.split_tf32(v)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    spacing = torch.exp2(torch.floor(torch.log2(v.abs())) - 10)
    assert bool(((v - hi).abs() <= spacing / 2).all())
    assert bool(((v.double() - hi.double() - lo.double()).abs()
                 <= v.double().abs() * 2.0 ** -21).all())
    # exactly half-way between two tf32 numbers: away from zero
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 3 * 2.0 ** -11])
    assert TC._tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                      1.0 + 2.0 ** -9]


def test_f32_k_order_is_what_a_threads_loads_give_the_wgmma_columns():
    """Thread (g, q) of a warp loads the 16-byte chunk 2 q + half of its
    positions (channels 8 q + 4 half .. + 3), and K-step 2 half + s of the
    chunk puts channels 8 q + 4 half + 2 s and + 1 in its A columns q and
    q + 4 (wgmma's tf32 fragment): the packed weight's column order. The
    eight lanes of each quarter-warp load eight different 16-byte bank
    groups of the 128-byte-swizzled box."""
    order = TC._f32_k_order().tolist()
    assert sorted(order) == list(range(32))
    for q in range(4):
        for half in range(2):
            for s in range(2):
                k = 2 * half + s
                assert order[8 * k + q] == 8 * q + 4 * half + 2 * s
                assert order[8 * k + q + 4] == 8 * q + 4 * half + 2 * s + 1
    for half in range(2):
        for quarter in range(4):
            lanes = range(8 * quarter, 8 * quarter + 8)
            groups = {(2 * (lane % 4) + half) ^ (lane // 4) for lane in lanes}
            assert len(groups) == 8


def test_pack_weight_split_holds_both_parts_in_k_order():
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 40, 24)).astype(
        np.float32))
    wp = TC.pack_weight_split(w, 64, 64)
    assert wp.shape == (54, 64, 64) and wp.dtype == torch.float32
    assert wp.is_contiguous()
    hi, lo = TC.split_tf32(w)
    order = TC._f32_k_order().tolist()
    for dt, dh, dw in ((0, 0, 0), (1, 2, 1), (2, 1, 2)):
        tap = (3 * dt + dw) * 3 + dh
        for part, off in ((hi, 0), (lo, 27)):
            for c0 in (0, 32):
                for pos, c in enumerate(order):
                    if c0 + c < 40:
                        assert torch.equal(wp[off + tap, :24, c0 + pos],
                                           part[dt, dh, dw, c0 + c])
                    else:
                        assert not wp[off + tap, :, c0 + pos].any()
    assert not wp[:, 24:].any()
    assert torch.allclose(wp[:27] + wp[27:],
                          TC.pack_weight(w, 64, 64, torch.float32).index_select(
                              2, torch.tensor([c0 + c for c0 in (0, 32)
                                               for c in order])),
                          rtol=2.0 ** -21, atol=0.0)
