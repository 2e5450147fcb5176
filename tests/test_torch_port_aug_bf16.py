"""The fused augmentation's bfloat16 compute route (``compute_dtype=
torch.bfloat16``, ``AugConfig.fused_compute='bfloat16'``) against the JAX
package on the CPU.

The port runs the plain version of its kernel's bfloat16 route
(``aug_fused_plain_bf16``: each plane op rounded to bfloat16 where the JAX
kernel's bfloat16 mode rounds it); the JAX side runs its kernel with
``compute_dtype=bfloat16`` in interpret mode, as tests/test_aug_fused.py
does, on the same crop / order / factor / blur arrays. XLA:CPU may keep more
than bfloat16 precision between the ops it fuses (its normalisation's
product and sum reach a float32 output unrounded: 12 % of those outputs are
not bfloat16 numbers), so the comparison is on the distribution of the
error, as tests/test_aug_fused.py:54-59 states its bfloat16 bounds: the
mean, the 99th quantile and the share of elements more than one bfloat16
ulp (of the JAX value's own magnitude) apart.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dualvar_tpu.aug.pipeline import AugConfig as JaxAugConfig
from dualvar_tpu.aug.pipeline import _pretrain_batch_unfused as jax_unfused
from dualvar_tpu.aug.pipeline import pretrain_batch_fused as jax_fused_batch
from dualvar_tpu.ops.aug_fused import aug_fused as jax_aug_fused
from dualvar_tpu_torch.aug.pipeline import (AugConfig,
                                            _pretrain_batch_unfused,
                                            classifier_train_batch,
                                            classifier_train_batch_fused,
                                            pretrain_batch,
                                            pretrain_batch_fused)
from dualvar_tpu_torch.ops.aug_fused import (aug_fused, aug_fused_plain,
                                             aug_fused_plain_bf16)

from test_torch_port_aug import SIZE, T, _kernel_inputs
import torch_port_util  # noqa: F401  (caps torch's threads)

# Against the JAX interpret-mode kernel in bfloat16 (measured on this
# input: normalised, mean 5.9e-4, 99th quantile 2**-7, 7.1e-5 of the
# elements beyond one ulp, where XLA kept the normalisation in float32;
# unnormalised, 1e-4 of the elements one ulp apart and none beyond): the
# mean within a tenth of a bfloat16 ulp at 0.5 (2**-9 / 10 ... 2e-3 for the
# normalised range, whose values reach 2.6), the 99th quantile within one
# bfloat16 ulp at the top of the range, and at most 1e-3 of the elements
# more than one ulp apart (1e-4 unnormalised).
BOUNDS = {True: dict(mean=2e-3, q99=2.0 ** -6, beyond=1e-3),
          False: dict(mean=2e-4, q99=2.0 ** -8, beyond=1e-4)}
# Against the float32 unfused pipeline: tests/test_aug_fused.py's own bounds
# for the JAX kernel's bfloat16 route (mean of about 0.8 u8 levels of
# rounding noise in the normalised space; hue-sector flips make a tail)
F32_MEAN, F32_Q99 = 0.025, 0.15


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _distribution(got: np.ndarray, want: np.ndarray) -> dict:
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return {"mean": float(err.mean()), "q99": float(np.quantile(err, 0.99)),
            "beyond": float((err > _bf16_ulp(want)).mean()),
            "max": float(err.max())}


def _is_bf16(x: np.ndarray) -> bool:
    return bool((x.astype(ml_dtypes.bfloat16).astype(np.float32) == x).all())


@pytest.mark.parametrize("normalize,out_dtype", [
    (True, "float32"), (True, "bfloat16"), (False, "float32")])
def test_bf16_route_matches_the_jax_kernel_in_interpret_mode(normalize,
                                                             out_dtype):
    """Every op order, blur on and off, hue shifts of both signs and the
    identity clip (``_kernel_inputs``)."""
    arrays = _kernel_inputs(24, 0)
    want = np.asarray(jax_aug_fused(
        *map(jnp.asarray, arrays), out_dtype=jnp.dtype(out_dtype),
        compute_dtype=jnp.bfloat16, normalize=normalize, interpret=True),
        np.float32)
    got = aug_fused(*map(torch.from_numpy, arrays),
                    out_dtype=getattr(torch, out_dtype),
                    compute_dtype=torch.bfloat16, normalize=normalize)
    assert got.dtype == getattr(torch, out_dtype)
    assert got.shape == arrays[0].shape
    got = got.float().numpy()
    # every output of the port's route is a bfloat16 number, f32 out too
    assert _is_bf16(got)
    dist = _distribution(got, want)
    for key, bound in BOUNDS[normalize].items():
        assert dist[key] <= bound, (key, dist)
    if not normalize:
        # the planes stay in [0, 1], and nowhere more than one ulp apart
        assert 0.0 <= got.min() and got.max() <= 1.0
        assert dist["max"] <= 2.0 ** -8, dist


def test_bf16_route_rounds_where_the_jax_kernel_rounds():
    """The route is not the float32 chain cast at the end: on the same
    input it differs from it (and from its bfloat16 output) by the
    rounding of every plane op, and the JAX kernel's bfloat16 mode differs
    from its float32 mode by about as much."""
    arrays = _kernel_inputs(24, 1)
    tensors = tuple(map(torch.from_numpy, arrays))
    f32 = aug_fused_plain(*tensors).numpy()
    f32_out16 = aug_fused_plain(*tensors,
                                out_dtype=torch.bfloat16).float().numpy()
    bf = aug_fused_plain(*tensors, compute_dtype=torch.bfloat16).numpy()
    assert np.array_equal(bf, aug_fused_plain_bf16(*tensors).numpy())
    jax32 = np.asarray(jax_aug_fused(*map(jnp.asarray, arrays),
                                     interpret=True))
    jax16 = np.asarray(jax_aug_fused(*map(jnp.asarray, arrays),
                                     compute_dtype=jnp.bfloat16,
                                     interpret=True))
    port_gap = np.abs(bf - f32).mean()
    jax_gap = np.abs(jax16 - jax32).mean()
    assert port_gap > 5 * np.abs(f32_out16 - f32).mean()
    assert 0.8 < port_gap / jax_gap < 1.25, (port_gap, jax_gap)


def _frames(seed, views=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (3, views * T, 40, 36, 3), dtype=np.uint8)


def test_both_packages_bf16_route_against_the_float32_unfused_pipeline():
    """tests/test_aug_fused.py's ``test_fused_bf16_compute_close`` for both
    packages: the fused batch with bfloat16 compute against the unfused
    float32 pipeline on the same decisions, at the JAX test's bounds."""
    frames = _frames(5, views=2)
    key = jax.random.PRNGKey(11)
    jcfg = dict(img_dim=SIZE, seq_len=T)
    jax_bf = np.asarray(jax_fused_batch(
        key, jnp.asarray(frames),
        JaxAugConfig(**jcfg, fused="on", fused_compute="bfloat16")))
    jax_ref = np.asarray(jax_unfused(key, jnp.asarray(frames),
                                     JaxAugConfig(**jcfg, fused="off")))
    torch_frames = torch.from_numpy(frames)
    port_bf = pretrain_batch_fused(
        torch.Generator().manual_seed(11), torch_frames,
        AugConfig(**jcfg, fused_compute="bfloat16")).numpy()
    port_ref = _pretrain_batch_unfused(torch.Generator().manual_seed(11),
                                       torch_frames, AugConfig(**jcfg))
    for got, ref in ((jax_bf, jax_ref), (port_bf, port_ref.numpy())):
        assert got.shape == ref.shape == (3, 2, T, SIZE, SIZE, 3)
        err = np.abs(got - ref)
        assert err.mean() < F32_MEAN, err.mean()
        assert np.quantile(err, 0.99) < F32_Q99, np.quantile(err, 0.99)


def test_fused_compute_is_threaded_through_both_pipelines():
    """``AugConfig.fused_compute`` reaches the kernel's ``compute_dtype`` in
    the pretrain and the classifier batch (the JAX package's
    ``pipeline.py:309/314`` and ``:366/371``); the unfused path ignores it;
    an unknown name raises."""
    frames = torch.from_numpy(_frames(6))
    cfg = AugConfig(img_dim=SIZE, seq_len=T, fused_compute="bfloat16")
    got = pretrain_batch(torch.Generator().manual_seed(3), frames, cfg)
    plain32 = pretrain_batch(torch.Generator().manual_seed(3), frames,
                             AugConfig(img_dim=SIZE, seq_len=T))
    want = pretrain_batch_fused(torch.Generator().manual_seed(3), frames,
                                cfg, kernel=False)
    assert torch.equal(got, want) and not torch.equal(got, plain32)
    assert _is_bf16(got.numpy())
    clips = frames[:, :T].contiguous()
    ccfg = AugConfig(img_dim=SIZE, seq_len=T, rand_flip=True,
                     fused_compute="bfloat16")
    got_c = classifier_train_batch(torch.Generator().manual_seed(4), clips,
                                   ccfg)
    want_c = classifier_train_batch_fused(torch.Generator().manual_seed(4),
                                          clips, ccfg, kernel=False)
    assert torch.equal(got_c, want_c) and _is_bf16(got_c.numpy())
    off = AugConfig(img_dim=SIZE, seq_len=T, fused="off",
                    fused_compute="bfloat16")
    assert torch.equal(
        pretrain_batch(torch.Generator().manual_seed(3), frames, off),
        pretrain_batch(torch.Generator().manual_seed(3), frames,
                       AugConfig(img_dim=SIZE, seq_len=T, fused="off")))
    for bad in ("float16", "bf16"):
        with pytest.raises(ValueError, match="fused_compute"):
            pretrain_batch(torch.Generator(), frames,
                           AugConfig(img_dim=SIZE, seq_len=T,
                                     fused_compute=bad))
        with pytest.raises(ValueError, match="fused_compute"):
            classifier_train_batch(
                torch.Generator(), clips,
                AugConfig(img_dim=SIZE, seq_len=T, fused_compute=bad))


# ---------------------------------------------------------------------------
# the kernel's pair arithmetic (csrc/aug_fused.cu, aug_bf16_band_kernel)
# ---------------------------------------------------------------------------

def _round_bf16_exact(v: np.ndarray) -> np.ndarray:
    """float64 values rounded once to the nearest bfloat16 (8 significant
    bits, ties to even): what ``mul.rn.bf16x2`` / ``add.rn.bf16x2`` make of
    the exact product or sum. Normal range only."""
    m, e = np.frexp(v)
    return np.ldexp(np.round(m * 256.0), e - 8)


def _bf16_values(rng, n, lo, hi):
    return torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("op", ["mul", "add"])
def test_pair_ops_round_as_the_float32_op_then_bfloat16(op):
    """The kernel's ``mul2`` / ``add2`` round the exact product or sum of
    two bfloat16 numbers once; the JAX kernel's bfloat16 mode (and
    ``aug_fused_plain_bf16``, a bfloat16 op of PyTorch) rounds the float32
    result. The two agree on every pair of the chain's ranges (planes in [0,
    1], factors, 1 - f, the gray's weights, the normalisation's scale and
    bias) and where the operands' exponents lie far apart."""
    rng = np.random.default_rng(8)
    ranges = [(0.0, 1.0), (0.2, 1.8), (-0.8, 0.8), (0.1, 0.6), (4.3, 4.5),
              (-2.2, -1.7), (1e-6, 1e-4)]
    a = torch.cat([_bf16_values(rng, 20000, *r) for r in ranges])
    b = torch.cat([_bf16_values(rng, 20000, *r) for r in ranges[::-1]])
    far = torch.tensor([1.0, 1.0, -1.0, 0.5], dtype=torch.bfloat16)
    tiny = torch.tensor([2.0 ** -17, -2.0 ** -17, 2.0 ** -9, 2.0 ** -20],
                        dtype=torch.bfloat16)
    a, b = torch.cat([a, far]), torch.cat([b, tiny])
    a64, b64 = a.double().numpy(), b.double().numpy()
    if op == "mul":
        got = (a * b).double().numpy()
        exact = a64 * b64
    else:
        got = (a + b).double().numpy()
        exact = a64 + b64
    nonzero = exact != 0
    want = np.where(nonzero, _round_bf16_exact(np.where(nonzero, exact, 1.0)),
                    0.0)
    assert np.array_equal(got, want)


def test_brightness_as_the_product_alone():
    """The pair route's brightness is clip(bf16(x fb)): the blend with
    zeros adds bf16(0 * omf) = +-0 to bf16(x fb), which changes no value,
    for every bfloat16 plane value in [0, 1] and factors in [0, 2]."""
    bits = torch.arange(0, 0x3F81, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)[None, :]  # every bf16 in [0, 1]
    f = torch.linspace(0.0, 2.0, 257).to(torch.bfloat16)[:, None]
    omf = (1.0 - f).to(torch.bfloat16)
    blend = (x * f + torch.zeros_like(x) * omf).clamp(0.0, 1.0)
    alone = (x * f).clamp(0.0, 1.0)
    assert torch.equal(blend.view(torch.int16), alone.view(torch.int16))


def _pair_route(clips, orders, factors, blur, normalize=True):
    """The bfloat16 route as ``aug_bf16_band_kernel`` stages it, in plain
    torch: the chain's values staged before contrast (the frame mean's
    input) and before the blur, the blur's W pass (float32), and the
    output, each op a bfloat16 op of PyTorch (the pair ops' rounding) but
    brightness the product alone. Returns (out, staged, w_pass)."""
    from dualvar_tpu_torch.aug import functional as F

    bf = torch.bfloat16
    x = (clips.permute(0, 2, 3, 4, 1).float() * (1.0 / 255.0)).to(bf)
    H, W = x.shape[-3], x.shape[-2]
    gw = [torch.tensor(v, dtype=bf) for v in F._GRAY_W]
    staged, w_pass = [], []

    def gray(s):
        return s[..., 0:1] * gw[0] + s[..., 1:2] * gw[1] + s[..., 2:3] * gw[2]

    def blend(s, other, f):
        return (s * f + other * (1.0 - f)).clamp(0.0, 1.0)

    out = torch.empty_like(x)
    for n in range(x.shape[0]):
        s = x[n:n + 1]
        fb = factors[n, :3].to(bf)
        order = orders[n].tolist()
        for op in order:
            if op == 1:
                staged.append(s)
                g = gray(s)
                m = (g.float().sum(dim=(-3, -2), keepdim=True)
                     * (1.0 / (H * W))).to(bf)
                s = blend(s, m, fb[1])
            elif op == 0:
                s = (s * fb[0]).clamp(0.0, 1.0)
            elif op == 2:
                s = blend(s, gray(s), fb[2])
            else:
                s = F.adjust_hue(s.float(), factors[n, 3]).to(bf)
        staged.append(s)
        if blur[n, 1] > 0:
            # the blur's two passes in float32, the W pass kept
            w_pass.append(_w_pass(s.float(), blur[n, 0]))
            s = F.gaussian_blur(s.float(), blur[n, 0], taps=13).to(bf)
        out[n:n + 1] = s
    if normalize:
        out = (out * torch.tensor([1.0 / v for v in F.IMAGENET_STD], dtype=bf)
               + torch.tensor([-m / v for m, v in zip(F.IMAGENET_MEAN,
                                                      F.IMAGENET_STD)],
                              dtype=bf))
    return out.permute(0, 4, 1, 2, 3).float(), staged, w_pass


def _w_pass(x, sigma):
    """``gaussian_blur``'s W pass alone (13 taps, edge replication)."""
    r = 6
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, dtype=torch.float32)
                          / sigma.clamp_min(1e-6)) ** 2)
    k = k / k.sum()
    n = x.shape[-2]
    pos = torch.arange(n)
    acc = torch.zeros_like(x)
    for j in range(13):
        acc = acc + k[j] * x.index_select(-2, (pos - r + j).clamp(0, n - 1))
    return acc


@pytest.mark.parametrize("normalize", [True, False])
def test_pair_route_is_the_plain_bf16_route_and_stages_bf16_numbers(
        normalize):
    """What licenses the kernel's bfloat16 staging: every value it stages in
    shared memory (the planes before contrast, whose gray makes the frame
    mean, and before the blur) is a bfloat16 number, and the route built
    from them is ``aug_fused_plain_bf16`` bit for bit (every op order, blur
    on and off). The blur's W pass is not: most of its float32 values (83 %
    here; all of a clip whose sigma of 0.1 leaves one tap) are not bfloat16
    numbers, so they stay in a float32 plane."""
    arrays = tuple(map(torch.from_numpy, _kernel_inputs(24, 2)))
    got, staged, w_pass = _pair_route(*arrays, normalize=normalize)
    want = aug_fused_plain_bf16(*arrays, normalize=normalize)
    assert torch.equal(got, want)
    assert len(staged) > 24 and all(s.dtype == torch.bfloat16
                                    for s in staged)
    assert w_pass and all(w.dtype == torch.float32 for w in w_pass)
    values = torch.cat([w.flatten() for w in w_pass]).numpy()
    bf_share = float((values.astype(ml_dtypes.bfloat16).astype(np.float32)
                      == values).mean())
    assert bf_share < 0.25, bf_share


def _hue_terms_all(r, g, b):
    """The hue's sector sum as the plain version (and the kernel's float32
    route) forms it: all three quotients, two of the terms masked to 0."""
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    cr = maxc - minc
    crd = np.where(maxc == minc, np.float32(1), cr)
    rc, gc, bc = ((maxc - c) / crd for c in (r, g, b))
    zero = np.float32(0)
    hr = np.where(maxc == r, bc - gc, zero)
    hg = np.where((maxc == g) & (maxc != r), (np.float32(2) + rc) - bc, zero)
    hb = np.where((maxc != g) & (maxc != r), (np.float32(4) + gc) - rc, zero)
    return (hr + hg) + hb


def _hue_terms_chosen(r, g, b):
    """``csrc/aug_fused.cu:hue_rn``: the two numerators the maximum's channel
    needs chosen first, two divisions."""
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    crd = np.where(maxc == minc, np.float32(1), maxc - minc)
    is_r = maxc == r
    is_g = ~is_r & (maxc == g)
    na = np.where(is_r, b, np.where(is_g, r, g))
    nb = np.where(is_r, g, np.where(is_g, b, r))
    base = np.where(is_r, np.float32(0),
                    np.where(is_g, np.float32(2), np.float32(4)))
    return (base + (maxc - na) / crd) - (maxc - nb) / crd


def test_hue_divides_only_the_two_quotients_it_keeps():
    """The bfloat16 route's hue divides only the two numerators the sector
    uses; float32 throughout (numpy rounds each op to nearest), the sector
    sum is the three-quotient one bit for bit on every kind of bfloat16
    triple: random, ties between channels, grays, zeros."""
    rng = np.random.default_rng(12)
    v = torch.from_numpy(rng.uniform(0, 1, (3, 200000)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    v[1, :1000] = v[0, :1000]          # r == g
    v[2, 1000:2000] = v[0, 1000:2000]  # r == b
    v[2, 2000:3000] = v[1, 2000:3000]  # g == b
    v[:, 3000:4000] = v[0, 3000:4000]  # gray
    v[:, 4000:4100] = 0.0
    r, g, b = v
    old = _hue_terms_all(r, g, b)
    new = _hue_terms_chosen(r, g, b)
    assert old.dtype == new.dtype == np.float32
    assert np.array_equal(old.view(np.int32), new.view(np.int32))
