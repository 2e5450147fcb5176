"""The port's augmentation (dualvar_tpu_torch.aug, .ops.aug_fused) against
the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
port runs the plain version of its kernel (CPU tensors); the JAX side runs
``aug_fused(..., interpret=True)`` as tests/test_aug_fused.py does. The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``; its band plan (a frame's rows cut into the blocks of one
cluster, which share the frame mean and the blur's W-pass rows) is replayed
here by the test-only ``_emulate_bands``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.aug import functional as JF
from dualvar_tpu.ops.aug_fused import aug_fused as jax_aug_fused
from dualvar_tpu_torch.aug import functional as TF
from dualvar_tpu_torch.aug.pipeline import (AugConfig, _draw_clip_params,
                                            _pretrain_batch_unfused,
                                            _use_fused, pretrain_batch,
                                            pretrain_batch_fused)
from dualvar_tpu_torch.ops.aug_fused import (_band_plan, aug_fused,
                                             aug_fused_plain)

import torch_port_util  # noqa: F401  (caps torch's threads)

T, H0, W0, SIZE = 4, 40, 36, 32  # sizes of tests/test_aug_fused.py

# Float32 elementwise chains that differ only in rounding order (x*(1/255)
# vs x/255, fma, reassociated sums): the band tests/test_aug_fused.py uses.
ATOL = 2e-5
# bf16 output: both sides round a float32 value that may differ by ATOL, so
# they can land one bf16 ulp apart; the normalised range is |x| < 4, where
# one ulp is 2**-6.
BF16_ATOL = 2.0 ** -6


def _clip(seed=0, t=T, s=SIZE):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (t, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("name,factor", [
    ("adjust_brightness", 0.3), ("adjust_brightness", 1.7),
    ("adjust_contrast", 0.4), ("adjust_contrast", 1.6),
    ("adjust_saturation", 0.25), ("adjust_saturation", 1.8),
    ("adjust_hue", -0.2), ("adjust_hue", 0.15), ("adjust_hue", 0.0),
])
def test_colour_op_matches_jax(name, factor):
    clip = _clip(1)
    # gray pixels and saturated primaries exercise the hue sector selects
    clip[0, 0, :4] = 0.5
    clip[0, 1, 0] = (1.0, 0.0, 0.0)
    clip[0, 1, 1] = (0.0, 1.0, 0.0)
    clip[0, 1, 2] = (0.0, 0.0, 1.0)
    want = np.asarray(getattr(JF, name)(jnp.asarray(clip), factor))
    got = getattr(TF, name)(torch.from_numpy(clip), factor).numpy()
    # same formulas in float32; 2e-6 covers one rounding of a value <= 6
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_grayscale_normalize_to_float_match_jax():
    u8 = np.random.default_rng(2).integers(0, 256, (T, SIZE, SIZE, 3),
                                           dtype=np.uint8)
    f_j = JF.to_float(jnp.asarray(u8))
    f_t = TF.to_float(torch.from_numpy(u8))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(TF.grayscale(f_t).numpy(),
                               np.asarray(JF.grayscale(f_j)), atol=1e-6)
    np.testing.assert_allclose(TF.normalize(f_t).numpy(),
                               np.asarray(JF.normalize(f_j)), atol=1e-6)
    assert TF._GRAY_W == JF._GRAY_W
    assert TF.IMAGENET_MEAN == JF.IMAGENET_MEAN
    assert TF.IMAGENET_STD == JF.IMAGENET_STD


@pytest.mark.parametrize("sigma", [0.1, 0.7, 2.0])
def test_gaussian_blur_matches_jax(sigma):
    clip = _clip(3)
    want = np.asarray(JF.gaussian_blur(jnp.asarray(clip), sigma))
    got = TF.gaussian_blur(torch.from_numpy(clip), sigma).numpy()
    # 2 x 13-tap float32 sums in another order (banded matmul vs stencil)
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_gaussian_blur_off_is_bit_exact_and_per_clip():
    clips = torch.from_numpy(np.stack([_clip(4), _clip(5)]))
    out = TF.gaussian_blur(clips, torch.tensor([1.0, 0.5]),
                           on=torch.tensor([False, True]))
    assert torch.equal(out[0], clips[0])
    want = TF.gaussian_blur(clips[1], 0.5)
    assert torch.equal(out[1], want)
    assert not torch.equal(out[1], clips[1])


def _kernel_inputs(n, seed):
    """Every op order (n >= 24), blur on/off with small and large sigma, hue
    shifts of both signs, and one identity (null-pipeline) clip."""
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 256, (n, 3, T, SIZE, SIZE), dtype=np.uint8)
    perms = list(itertools.permutations(range(4)))
    orders = np.array([perms[i % 24] for i in range(n)], np.int32)
    factors = rng.uniform(0.2, 1.8, (n, 4)).astype(np.float32)
    factors[:, 3] = rng.uniform(-0.2, 0.2, n)
    factors[0, 3], factors[1, 3] = -0.2, 0.2
    sigma = rng.uniform(0.1, 2.0, n).astype(np.float32)
    sigma[1], sigma[3] = 0.1, 2.0
    on = (np.arange(n) % 2).astype(np.float32)
    factors[2] = (1.0, 1.0, 1.0, 0.0)  # identity pipeline, blur off
    blur = np.stack([sigma, on], axis=1)
    return clips, orders, factors, blur


@pytest.mark.parametrize("normalize", [True, False])
def test_aug_fused_plain_matches_jax_kernel_all_orders(normalize):
    clips, orders, factors, blur = _kernel_inputs(24, 0)
    assert len({tuple(o) for o in orders}) == 24
    want = np.asarray(jax_aug_fused(
        jnp.asarray(clips), jnp.asarray(orders), jnp.asarray(factors),
        jnp.asarray(blur), normalize=normalize, interpret=True))
    got = aug_fused_plain(*map(torch.from_numpy,
                               (clips, orders, factors, blur)),
                          normalize=normalize)
    assert got.dtype == torch.float32 and got.shape == clips.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    if not normalize:
        assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0 + 1e-6


def test_aug_fused_identity_clip_is_plain_normalisation():
    clips, orders, factors, blur = map(torch.from_numpy, _kernel_inputs(6, 1))
    out = aug_fused(clips, orders, factors, blur)
    want = TF.normalize(TF.to_float(clips[2].permute(1, 2, 3, 0)))
    # the hue round trip at factor 0 is not bit-exact: HSV and back in f32
    np.testing.assert_allclose(out[2].permute(1, 2, 3, 0).numpy(),
                               want.numpy(), atol=ATOL)


def test_aug_fused_bf16_output_matches_jax():
    clips, orders, factors, blur = _kernel_inputs(6, 2)
    want = jax_aug_fused(
        jnp.asarray(clips), jnp.asarray(orders), jnp.asarray(factors),
        jnp.asarray(blur), out_dtype=jnp.bfloat16, interpret=True)
    got = aug_fused(*map(torch.from_numpy, (clips, orders, factors, blur)),
                    out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=BF16_ATOL)


def test_aug_fused_wrapper_rejects_bad_arguments():
    clips, orders, factors, blur = map(torch.from_numpy, _kernel_inputs(4, 3))
    bad = orders.clone()
    bad[1] = torch.tensor([0, 1, 1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="permutation"):
        aug_fused(clips, bad, factors, blur)
    with pytest.raises(ValueError, match="permutation"):
        aug_fused(clips, orders + 1, factors, blur)
    with pytest.raises(TypeError, match="orders"):
        aug_fused(clips, orders.long(), factors, blur)
    with pytest.raises(TypeError, match="uint8"):
        aug_fused(clips.float(), orders, factors, blur)
    with pytest.raises(ValueError, match="factors"):
        aug_fused(clips, orders, factors[:3], blur)
    with pytest.raises(ValueError, match="contiguous"):
        aug_fused(clips.transpose(3, 4), orders, factors, blur)
    with pytest.raises(ValueError, match=r"\(N, 3, T, S, S\)"):
        aug_fused(clips[:, :2], orders, factors, blur)
    with pytest.raises(TypeError, match="out_dtype"):
        aug_fused(clips, orders, factors, blur, out_dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="bfloat16 compute"):
        aug_fused(clips, orders, factors, blur,
                  compute_dtype=torch.bfloat16)


def _jax_fused_batch(frames, crops, orders, factors, blurs, cfg):
    """The JAX package's crop + planar transpose + kernel + transpose back
    (aug/pipeline.py:295-320) on explicit decision arrays."""
    B, VT, h0, w0, C = frames.shape
    Tn, d = cfg.seq_len, cfg.img_dim
    V = VT // Tn
    clips = jnp.asarray(frames).reshape(B * V, Tn, h0, w0, C)

    def crop_one(clip, cr):
        return jax.lax.dynamic_slice(clip, (0, cr[0], cr[1], 0), (Tn, d, d, C))

    cropped = jax.vmap(crop_one)(clips, jnp.asarray(crops).reshape(B * V, 2))
    out = jax_aug_fused(
        cropped.transpose(0, 4, 1, 2, 3),
        jnp.asarray(orders).reshape(B * V, 4),
        jnp.asarray(factors).reshape(B * V, 4),
        jnp.asarray(blurs).reshape(B * V, 2), interpret=True)
    return np.asarray(
        out.reshape(B, V, C, Tn, d, d).transpose(0, 1, 3, 4, 5, 2))


def test_pretrain_batch_fused_explicit_decisions_match_jax():
    B, V = 2, 3
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (B, V * T, H0, W0, 3), dtype=np.uint8)
    crops = np.stack([rng.integers(0, H0 - SIZE + 1, (B, V)),
                      rng.integers(0, W0 - SIZE + 1, (B, V))], axis=-1)
    crops[0, 0] = (0, 0)
    crops[1, 2] = (H0 - SIZE, W0 - SIZE)  # both window extremes
    _, orders, factors, blurs = _kernel_inputs(B * V, 5)
    orders, factors, blurs = (a.reshape(B, V, -1)
                              for a in (orders, factors, blurs))
    cfg = AugConfig(img_dim=SIZE, seq_len=T)
    want = _jax_fused_batch(frames, crops, orders, factors, blurs, cfg)
    got = pretrain_batch_fused(
        None, torch.from_numpy(frames), cfg,
        crops=torch.from_numpy(crops), orders=torch.from_numpy(orders),
        factors=torch.from_numpy(factors), blurs=torch.from_numpy(blurs))
    assert tuple(got.shape) == (B, V, T, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # the result is a channels-last view of the planar kernel output
    assert got.permute(0, 1, 5, 2, 3, 4).is_contiguous()


@pytest.mark.parametrize("jitter_order", ["batch", "sample"])
def test_draw_clip_params_distributions_and_gates(jitter_order):
    cfg = AugConfig(img_dim=SIZE, seq_len=T, jitter_order=jitter_order)
    g = torch.Generator().manual_seed(0)
    B, V = 4000, 3
    crops, orders, factors, blurs = _draw_clip_params(g, cfg, B, V, H0, W0)
    assert crops.shape == (B, V, 2) and orders.shape == (B, V, 4)
    assert orders.dtype == torch.int32 and factors.dtype == torch.float32
    assert int(crops[..., 0].min()) == 0 and int(crops[..., 0].max()) == H0 - SIZE
    assert int(crops[..., 1].min()) == 0 and int(crops[..., 1].max()) == W0 - SIZE
    assert torch.equal(orders.sort(dim=-1).values,
                       torch.arange(4, dtype=torch.int32).expand(B, V, 4))
    n_orders = len({tuple(o) for o in orders.reshape(-1, 4).tolist()})
    assert n_orders == 24 if jitter_order == "sample" else n_orders <= V
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0])
    applied = ~(factors == ident).all(dim=-1)  # (B, V)
    # views 1, 2: 0.8 * 0.8 = 0.64; view 0: another 0.8 -> 0.512 (+-4 sigma)
    assert abs(float(applied[:, 1:].float().mean()) - 0.64) < 0.03
    assert abs(float(applied[:, 0].float().mean()) - 0.512) < 0.04
    f = factors[applied]
    assert 0.2 <= float(f[:, :3].min()) and float(f[:, :3].max()) <= 1.8
    assert -0.2 <= float(f[:, 3].min()) and float(f[:, 3].max()) <= 0.2
    assert float(f[:, :3].max()) > 1.7 and float(f[:, 3].min()) < -0.19
    blur_on = blurs[..., 1] > 0
    assert abs(float(blur_on[:, 1:].float().mean()) - 0.5) < 0.03
    assert abs(float(blur_on[:, 0].float().mean()) - 0.4) < 0.04
    assert 0.1 <= float(blurs[..., 0].min()) and float(blurs[..., 0].max()) <= 2.0
    # the same seed gives the same draws
    again = _draw_clip_params(torch.Generator().manual_seed(0), cfg, B, V,
                              H0, W0)
    assert all(torch.equal(a, b) for a, b in
               zip((crops, orders, factors, blurs), again))


def test_pretrain_batch_dispatch_and_unported_modes():
    """Before the unfused path was ported, the per-frame jitter modes and
    'off' on the card were refused; now 'auto' / 'on' take the fused path
    (on CPU frames the kernel's plain version), 'off' and per-frame jitter
    the unfused path (``_pretrain_batch_unfused``), and 'on' with per-frame
    jitter raises ``ValueError`` as in the JAX package."""
    frames = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 3 * T, H0, W0, 3), dtype=np.uint8))
    outs = [pretrain_batch(torch.Generator().manual_seed(9), frames,
                           AugConfig(img_dim=SIZE, seq_len=T, fused=fused))
            for fused in ("auto", "on", "off")]
    cfg = AugConfig(img_dim=SIZE, seq_len=T)
    fused = pretrain_batch_fused(torch.Generator().manual_seed(9), frames,
                                 cfg, kernel=False)
    unfused = _pretrain_batch_unfused(torch.Generator().manual_seed(9),
                                      frames, cfg)
    assert torch.equal(outs[0], fused) and torch.equal(outs[1], fused)
    assert torch.equal(outs[2], unfused)
    # the same decisions: the two paths agree to the kernel's band
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), atol=ATOL)
    assert tuple(outs[0].shape) == (2, 3, T, SIZE, SIZE, 3)
    frame_cfg = AugConfig(img_dim=SIZE, seq_len=T, aug_temp_consist=False)
    out = pretrain_batch(torch.Generator().manual_seed(9), frames, frame_cfg)
    assert torch.equal(out, _pretrain_batch_unfused(
        torch.Generator().manual_seed(9), frames, frame_cfg))
    with pytest.raises(ValueError, match="clip-consistent"):
        pretrain_batch(torch.Generator(), frames,
                       AugConfig(img_dim=SIZE, seq_len=T, fused="on",
                                 aug_temp_consist=False))
    with pytest.raises(ValueError, match="auto/on/off"):
        pretrain_batch(torch.Generator(), frames,
                       AugConfig(img_dim=SIZE, seq_len=T, fused="maybe"))
    assert _use_fused(AugConfig(fused="auto"))
    assert _use_fused(AugConfig(fused="on"))
    assert not _use_fused(AugConfig(fused="off"))


def _w_pass(x, k):
    """The blur's W pass of (..., W, 3) rows: clamped neighbours, taps added
    in order, as aug/functional.py:gaussian_blur adds them."""
    W = x.shape[-2]
    pos = torch.arange(W)
    acc = torch.zeros_like(x)
    for j in range(k.numel()):
        acc = acc + k[j] * x[..., (pos - 6 + j).clamp(0, W - 1), :]
    return acc


def _emulate_bands(clips_u8, orders, factors, blur, normalize=True,
                   whole_frame_mean=False):
    """The kernel's band plan in plain torch (the ops of aug/functional.py),
    clip by clip: each band of ``_band_plan`` runs the ops before contrast on
    its own rows and sums their gray; the frame mean is the sum of the band
    sums in band order over S*S; contrast and the ops after it run on the
    band's rows; a blurred clip's band runs the W pass on its rows, and the
    H pass of its rows reads the W pass of frame rows clamp(y - 6 + j) from
    the bands that own them (the cluster's distributed shared memory).
    ``whole_frame_mean`` takes the mean as ``adjust_contrast`` does instead,
    to isolate the band plan from the mean's summation order."""
    N, _, T, S, _ = clips_u8.shape
    nb, br, _ = _band_plan(S)
    ops = (TF.adjust_brightness, None, TF.adjust_saturation, TF.adjust_hue)
    out = torch.empty(N, T, S, S, 3)
    for i in range(N):
        x = TF.to_float(clips_u8[i].permute(1, 2, 3, 0))  # (T, S, S, 3)
        order = orders[i].tolist()
        f = factors[i]
        c_slot = order.index(1)
        bands, sums = [], torch.zeros(T)
        for b in range(nb):
            sub = x[:, b * br:(b + 1) * br]
            for op in order[:c_slot]:
                sub = ops[op](sub, f[op])
            sums += TF.grayscale(sub).sum(dim=(1, 2, 3))
            bands.append(sub)
        mean = (sums * (1.0 / (S * S))).reshape(T, 1, 1, 1)
        if whole_frame_mean:
            pre = x
            for op in order[:c_slot]:
                pre = ops[op](pre, f[op])
            mean = TF.grayscale(pre).mean(dim=(-3, -2), keepdim=True)
        for b, sub in enumerate(bands):
            sub = TF._blend(sub, mean, f[1])
            for op in order[c_slot + 1:]:
                sub = ops[op](sub, f[op])
            bands[b] = sub
        if bool(blur[i, 1] > 0):
            r = torch.arange(-6, 7, dtype=torch.float32)
            k = torch.exp(-0.5 * (r / blur[i, 0].clamp_min(1e-6)) ** 2)
            k = k / k.sum()
            wrows = torch.cat([_w_pass(sub, k) for sub in bands], dim=1)
            for b in range(nb):
                ys = torch.arange(b * br, min((b + 1) * br, S))
                acc = torch.zeros(T, len(ys), S, 3)
                for j in range(13):
                    acc = acc + k[j] * wrows[:, (ys - 6 + j).clamp(0, S - 1)]
                bands[b] = acc
        out[i] = torch.cat(bands, dim=1)
    if normalize:
        out = TF.normalize(out)
    return out.permute(0, 4, 1, 2, 3).contiguous()


@pytest.mark.parametrize("n,size", [(24, SIZE), (6, 20)])
@pytest.mark.parametrize("normalize", [True, False])
def test_band_emulation_matches_plain_and_jax(n, size, normalize):
    """Every op order, blur on and off. With the plain version's frame mean
    the band plan (rows, the W-pass rows read across bands, clamped edges)
    gives the plain version to 1e-6; with the fixed-order sum of the
    band sums it gives the plain version and the JAX kernel (interpret
    mode) within ATOL: the mean then differs by float32 summation order,
    which hue's divisions magnify near grays."""
    clips, orders, factors, blur = _kernel_inputs(n, 7)
    clips = np.ascontiguousarray(clips[..., :size, :size])
    args = tuple(map(torch.from_numpy, (clips, orders, factors, blur)))
    plain = aug_fused_plain(*args, normalize=normalize)
    same_mean = _emulate_bands(*args, normalize=normalize,
                               whole_frame_mean=True)
    np.testing.assert_allclose(same_mean.numpy(), plain.numpy(), atol=1e-6)
    got = _emulate_bands(*args, normalize=normalize)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    want = np.asarray(jax_aug_fused(
        jnp.asarray(clips), jnp.asarray(orders), jnp.asarray(factors),
        jnp.asarray(blur), normalize=normalize, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_band_sums_give_the_frame_mean():
    """The fixed-order sum of the band sums over S*S is the frame's mean
    gray to float32 rounding (1e-6 relative), for every band plan of the
    test sizes."""
    rng = np.random.default_rng(8)
    for S in (SIZE, 20, 9, 112):
        x = torch.from_numpy(rng.uniform(0, 1, (3, S, S, 3)).astype(
            np.float32))
        gray = TF.grayscale(x)
        nb, br, _ = _band_plan(S)
        sums = torch.zeros(3)
        for b in range(nb):
            sums += gray[:, b * br:(b + 1) * br].sum(dim=(1, 2, 3))
        want = gray.double().mean(dim=(1, 2, 3))
        assert torch.allclose(sums.double() / (S * S), want, rtol=1e-6)


@pytest.mark.parametrize("S,want", [
    (112, (8, 14, 18816)),    # the presets' crop: 8 bands of 14 rows
    (32, (8, 4, 1536)),       # the test size: the blur reaches 2 bands away
    (20, (7, 3, 720)),        # a short last band (2 rows)
    (9, (5, 2, 216)),
    (1, (1, 1, 12)),
    (256, (8, 32, 98304)),    # the largest crop
])
def test_band_plan(S, want):
    """(bands, rows a band, shared-memory bytes): at most one cluster of 8
    blocks a frame, every frame row owned by exactly one band."""
    bands, rows, smem = _band_plan(S)
    assert (bands, rows, smem) == want
    owned = [y for b in range(bands) for y in range(b * rows,
                                                     min((b + 1) * rows, S))]
    assert owned == list(range(S))
    assert bands <= 8 and (bands - 1) * rows < S


def test_band_plan_refuses_a_crop_larger_than_a_round():
    with pytest.raises(ValueError, match="crop size 257"):
        _band_plan(257)
