"""The port's unfused per-frame augmentation against the JAX package's, on
the CPU.

Every per-sample op of ``dualvar_tpu_torch/aug/functional.py`` against its
JAX counterpart on the same numpy clips, with the JAX op's own random
decisions (read from its key by the JAX package's splits) handed to the
port's decision seams; the port runs several clips in one call (one decision
a clip), JAX one clip a call. Then the unfused pretrain and classifier
batches with explicit decisions against the JAX package's unfused batches,
and the fused-vs-unfused dispatch against the JAX package's, case by case.

Tolerances, float32: 1e-5 absolute on the ops' values in [0, 1]; 2e-5 on
the normalised batches (|x| < 3: the ImageNet std divides by about 0.23),
the band of tests/test_aug_fused.py. Both cover the same formulas in
another rounding order (resampling sums, the blur's taps, the HSV round
trip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.aug import functional as JF
from dualvar_tpu.aug import pipeline as JP
from dualvar_tpu_torch.aug import functional as TF
from dualvar_tpu_torch.aug import pipeline as TP

import torch_port_util  # noqa: F401  (caps torch's threads)

ATOL = 1e-5
NORM_ATOL = 2e-5
T, H, W = 4, 24, 32
KEYS = [jax.random.PRNGKey(s) for s in (3, 11, 29)]


def _clips(n=3, t=T, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (n, t, h, w, 3)).astype(np.float32)


def _jax_each(fn, clips):
    """fn(key, clip) for each clip with its own key (one jitted vmap, as
    the JAX package runs its per-sample ops) -> stacked numpy."""
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.stack(KEYS),
                                             jnp.asarray(clips)))


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("n_seqblock", [0, 3])
def test_random_crop(n_seqblock):
    clips = _clips()
    size = 16
    want = _jax_each(lambda k, c: JF.random_crop(k, c, size, n_seqblock),
                     clips)

    def offsets(key):
        ky, kx = jax.random.split(key)
        shape = (-(-T // n_seqblock),) if n_seqblock else ()
        return np.stack([np.asarray(jax.random.randint(ky, shape, 0,
                                                       H - size + 1)),
                         np.asarray(jax.random.randint(kx, shape, 0,
                                                       W - size + 1))], -1)

    offs = torch.from_numpy(np.stack([offsets(k) for k in KEYS]))
    got = TF.random_crop(None, torch.from_numpy(clips), size, n_seqblock,
                         offsets=offs)
    np.testing.assert_array_equal(got.numpy(), want)
    u8 = torch.from_numpy((clips * 255).astype(np.uint8))
    assert TF.random_crop(torch.Generator().manual_seed(0), u8,
                          size).dtype == torch.uint8


@pytest.mark.parametrize("seq_len", [0, 2])
def test_random_hflip(seq_len):
    clips = _clips()
    want = _jax_each(lambda k, c: JF.random_hflip(k, c, 0.5, seq_len), clips)

    def flips(key):
        shape = (-(-T // seq_len),) if 0 < seq_len < T else ()
        return np.asarray(jax.random.uniform(key, shape) < 0.5)

    got = TF.random_hflip(None, torch.from_numpy(clips), 0.5, seq_len,
                          flip=torch.from_numpy(np.stack([flips(k)
                                                          for k in KEYS])))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("out_hw", [(12, 20), (40, 48), (24, 17)])
def test_resize(method, out_hw):
    clips = _clips(2)
    want = np.stack([np.asarray(JF.resize(jnp.asarray(c), *out_hw, method))
                     for c in clips])
    _close(TF.resize(torch.from_numpy(clips), *out_hw, method), want)


@pytest.mark.parametrize("block", [1, 2])
def test_random_gray_channel_split(block):
    clips = _clips()
    want = _jax_each(lambda k, c: JF.random_gray_channel_split(
        k, c, 0.8, block), clips)

    def draws(key):
        keys = jax.random.split(key, block * block) if block > 1 else [key]
        ch, do = [], []
        for k in keys:
            kc, kp = jax.random.split(k)
            ch.append(int(jax.random.randint(kc, (), 0, 3)))
            do.append(bool(jax.random.uniform(kp) < 0.8))
        return ch, do

    ch, do = zip(*[draws(k) for k in KEYS])
    ch, do = torch.tensor(ch), torch.tensor(do)
    if block == 1:
        ch, do = ch[:, 0], do[:, 0]
    got = TF.random_gray_channel_split(None, torch.from_numpy(clips), 0.8,
                                       block, channel=ch, apply=do)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block,p", [(1, 0.75), (1, 0.8), (4, 0.75)])
def test_channel_mask(block, p):
    clips = _clips()
    want = _jax_each(lambda k, c: JF.channel_mask(k, c, p, block), clips)

    def draw(key):
        keys = jax.random.split(key, block * block) if block > 1 else [key]
        return [float(jax.random.uniform(jax.random.split(k, 1)[0]))
                for k in keys]

    u = torch.tensor([draw(k) for k in KEYS])
    if block == 1:
        u = u[:, 0]
    got = TF.channel_mask(None, torch.from_numpy(clips), p, block, draw=u)
    np.testing.assert_array_equal(got.numpy(), want)


def test_channel_mask_masks_one_channel_or_none():
    clips = torch.ones(64, 1, 2, 2, 3)
    out = TF.channel_mask(torch.Generator().manual_seed(0), clips, 0.75)
    zeros = (out[:, 0, 0, 0] == 0).sum(dim=-1)
    assert set(zeros.tolist()) <= {0, 1} and 0 < int(zeros.sum()) < 64


@pytest.mark.parametrize("size,p", [(16, 1.0), (16, 0.0), (30, 1.0)])
def test_random_sized_crop(size, p):
    clips = _clips()
    want = _jax_each(lambda k, c: JF.random_sized_crop(k, c, size, p),
                     clips)

    def draws(key):
        kp, ka, kr, ks, kx, ky = jax.random.split(key, 6)
        return {"p": jax.random.uniform(kp),
                "area": jax.random.uniform(ka, minval=0.5, maxval=1.0),
                "ratio": jax.random.uniform(kr, minval=3 / 4, maxval=4 / 3),
                "swap": jax.random.uniform(ks), "x": jax.random.uniform(kx),
                "y": jax.random.uniform(ky)}

    d = [draws(k) for k in KEYS]
    d = {name: torch.tensor([float(x[name]) for x in d]) for name in d[0]}
    _close(TF.random_sized_crop(None, torch.from_numpy(clips), size, p,
                                draws=d), want)


@pytest.mark.parametrize("p", [1.0, 0.0])
def test_random_rotation(p):
    clips = _clips()
    want = _jax_each(lambda k, c: JF.random_rotation(k, c, 15.0, p), clips)

    def draws(key):
        kp, kd = jax.random.split(key)
        return (float(jax.random.uniform(kp)),
                float(jax.random.uniform(kd, minval=-15.0, maxval=15.0)))

    u, deg = zip(*[draws(k) for k in KEYS])
    got = TF.random_rotation(None, torch.from_numpy(clips), 15.0, p,
                             draws={"p": torch.tensor(u),
                                    "degree": torch.tensor(deg)})
    _close(got, want)


def test_pad_frames():
    clip = _clips(1)[0]
    np.testing.assert_array_equal(
        TF.pad_frames(torch.from_numpy(clip), 3, 0.25).numpy(),
        np.asarray(JF.pad_frames(jnp.asarray(clip), 3, 0.25)))


def _jax_jitter_decisions(key, mode, p=0.8):
    """The draws of the JAX package's color_jitter from ``key``."""
    k_apply, k_factors, k_order = jax.random.split(key, 3)
    f = JF.sample_jitter_factors(k_factors, T, 0.8, 0.8, 0.8, 0.2, mode)
    return (bool(jax.random.uniform(k_apply) < p),
            np.stack([np.asarray(f[n]) for n in TF.JITTER_NAMES]),
            np.asarray(jax.random.permutation(k_order, 4)))


@pytest.mark.parametrize("mode", ["consistent", "frame", "grad"])
@pytest.mark.parametrize("gate", [True, False])
def test_color_jitter(mode, gate):
    clips = _clips()
    clips[0, 0, :2, :2] = 0.5  # gray pixels: the hue sector selects
    want = _jax_each(lambda k, c: JF.color_jitter(
        k, c, p=0.8, mode=mode, gate=gate), clips)
    apply, factors, order = zip(*[_jax_jitter_decisions(k, mode)
                                  for k in KEYS])
    got = TF.color_jitter(None, torch.from_numpy(clips), p=0.8, mode=mode,
                          gate=gate, apply=torch.tensor(apply),
                          factors=torch.from_numpy(np.stack(factors)),
                          order=torch.from_numpy(np.stack(order)))
    _close(got, want)


def test_color_jitter_blockwise_and_shared_order():
    clips = _clips()
    order = jnp.asarray([3, 1, 0, 2])
    want = _jax_each(lambda k, c: JF.color_jitter(
        k, c, p=1.0, mode="frame", block=2, order=order), clips)

    def cells(key):
        per = [_jax_jitter_decisions(k, "frame", p=1.0)
               for k in jax.random.split(key, 4)]
        return [x[0] for x in per], np.stack([x[1] for x in per])

    apply, factors = zip(*[cells(k) for k in KEYS])
    got = TF.color_jitter(None, torch.from_numpy(clips), p=1.0, mode="frame",
                          block=2, order=torch.tensor([3, 1, 0, 2]),
                          apply=torch.tensor(apply),
                          factors=torch.from_numpy(np.stack(factors)))
    _close(got, want)


def test_sample_jitter_factors_modes():
    """tests/test_aug.py's checks of the three modes: shapes, ranges, one
    draw a clip, a draw a frame, a linear ramp."""
    g = torch.Generator().manual_seed(0)
    cons = TF.sample_jitter_factors(g, 5, mode="consistent", shape=(64,))
    frame = TF.sample_jitter_factors(g, 5, mode="frame", shape=(64,))
    grad = TF.sample_jitter_factors(g, 5, mode="grad", shape=(64,))
    for out in (cons, frame, grad):
        assert list(out) == list(TF.JITTER_NAMES)
        for name, (lo, hi) in zip(TF.JITTER_NAMES, TF.jitter_ranges()):
            assert out[name].shape == (64, 5)
            assert float(out[name].min()) >= lo
            assert float(out[name].max()) <= hi
    for name in TF.JITTER_NAMES:
        assert torch.equal(cons[name], cons[name][:, :1].expand(64, 5))
        assert float((frame[name][:, 1:] - frame[name][:, :1]).abs().max()) \
            > 1e-3
        steps = grad[name].diff(dim=1)
        torch.testing.assert_close(steps, steps[:, :1].expand(64, 4),
                                   atol=1e-6, rtol=0)
    # the JAX package's ramp arithmetic on the same end points, to one
    # float32 ulp of 2 (XLA may fuse the blend into a fused multiply-add)
    start, stop = torch.tensor([0.3, 1.7]), torch.tensor([1.2, 0.2])
    np.testing.assert_allclose(
        TF.linspace_frames(start, stop, 6).numpy(),
        np.asarray(jnp.linspace(jnp.asarray(start.numpy()),
                                jnp.asarray(stop.numpy()), 6, axis=-1)),
        atol=2.0 ** -22, rtol=0)
    # consistent-mode identical frames stay identical after the jitter
    frame0 = torch.rand(1, 1, 10, 12, 3, generator=g)
    out = TF.color_jitter(g, frame0.expand(1, 5, 10, 12, 3), p=1.0)
    assert float((out - out[:, :1]).abs().max()) < 1e-6
    with pytest.raises(ValueError):
        TF.sample_jitter_factors(g, 5, mode="block")


B, V, H0, W0, SIZE = 2, 3, 40, 36, 32


def _jax_pretrain_decisions(key, frames, cfg):
    """The decisions of the JAX package's unfused pretrain batch from
    ``key``: ``pretrain_batch_fused``'s draws (its ``_draw_clip_params``
    mirrors the unfused key splits), per-frame factors (B, V, 4, T)."""
    k_batch, k_order = jax.random.split(key)
    shared = None
    if cfg.jitter_order == "batch":
        shared = jnp.stack([
            jax.random.permutation(jax.random.fold_in(k_order, v), 4)
            for v in range(V)])

    def draw_sample(k):
        ks = jax.random.split(k, V + 1)
        per_view = []
        for v in range(V):
            use_aug = (jax.random.uniform(ks[V]) < 0.8 if v == 0
                       else jnp.bool_(True))
            per_view.append(JP._draw_clip_params(
                ks[v], cfg, use_aug, H0, W0,
                None if shared is None else shared[v]))
        return tuple(jnp.stack(x) for x in zip(*per_view))

    out = jax.vmap(draw_sample)(jax.random.split(k_batch, B))
    return [torch.from_numpy(np.array(a)) for a in out]


@pytest.mark.parametrize("jitter,jitter_order", [
    (dict(), "sample"), (dict(), "batch"),
    (dict(aug_temp_consist=False), "sample"),
    (dict(aug_temp_grad_consist=True), "batch")])
def test_pretrain_batch_unfused_explicit_decisions_match_jax(jitter,
                                                             jitter_order):
    frames = np.random.default_rng(1).integers(
        0, 256, (B, V * T, H0, W0, 3), dtype=np.uint8)
    jcfg = JP.AugConfig(img_dim=SIZE, seq_len=T, jitter_order=jitter_order,
                        **jitter)
    tcfg = TP.AugConfig(img_dim=SIZE, seq_len=T, jitter_order=jitter_order,
                        **jitter)
    key = jax.random.PRNGKey(5)
    want = np.asarray(JP._pretrain_batch_unfused(key, jnp.asarray(frames),
                                                 jcfg))
    crops, orders, factors, blurs = _jax_pretrain_decisions(
        key, frames, jcfg)
    got = TP._pretrain_batch_unfused(None, torch.from_numpy(frames), tcfg,
                                     crops=crops, orders=orders,
                                     factors=factors, blurs=blurs)
    assert got.shape == (B, V, T, SIZE, SIZE, 3)
    _close(got, want, NORM_ATOL)
    if jitter or jitter_order == "batch":
        return
    # bf16 out: both sides round values that may differ by NORM_ATOL
    jb = JP.AugConfig(img_dim=SIZE, seq_len=T, jitter_order=jitter_order,
                      out_dtype="bfloat16", **jitter)
    tb = TP.AugConfig(img_dim=SIZE, seq_len=T, jitter_order=jitter_order,
                      out_dtype="bfloat16", **jitter)
    want = np.asarray(JP._pretrain_batch_unfused(key, jnp.asarray(frames),
                                                 jb).astype(jnp.float32))
    got = TP._pretrain_batch_unfused(None, torch.from_numpy(frames), tb,
                                     crops=crops, orders=orders,
                                     factors=factors, blurs=blurs)
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, atol=2.0 ** -6)


def test_unfused_draws_follow_the_jitter_mode():
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (B, V * T, H0, W0, 3), dtype=np.uint8))
    for jitter, shape in ((dict(), (B, V, 4)),
                          (dict(aug_temp_consist=False), (B, V, 4, T)),
                          (dict(aug_temp_grad_consist=True), (B, V, 4, T))):
        cfg = TP.AugConfig(img_dim=SIZE, seq_len=T, **jitter)
        _, orders, factors, _ = TP._draw_clip_params(
            torch.Generator().manual_seed(0), cfg, 64, V, H0, W0)
        assert tuple(factors.shape) == (64,) + shape[1:]
        out = TP.pretrain_batch(torch.Generator().manual_seed(0), frames, cfg)
        assert out.shape == (B, V, T, SIZE, SIZE, 3)
        assert bool(torch.isfinite(out).all())
    # the per-sample entry points draw as the batch does for a batch of one
    cfg = TP.AugConfig(img_dim=SIZE, seq_len=T, aug_temp_consist=False)
    one = TP.pretrain_sample(torch.Generator().manual_seed(4), frames[0], cfg)
    batch = TP._pretrain_batch_unfused(torch.Generator().manual_seed(4),
                                       frames[:1], cfg)
    assert torch.equal(one, batch[0])
    plain = TP._augmented_clip(torch.Generator().manual_seed(4),
                               frames[0, :T], cfg, use_aug=False)
    assert plain.shape == (T, SIZE, SIZE, 3)
    # the null pipeline: no blur, identity factors (only the HSV round
    # trip, a few float32 ulps)
    y0x0 = TP._draw_clip_params(torch.Generator().manual_seed(4), cfg, 1, 1,
                                H0, W0, use_aug=torch.zeros(1, 1, dtype=bool)
                                )[0][0, 0]
    crop = frames[0, :T, y0x0[0]:y0x0[0] + SIZE, y0x0[1]:y0x0[1] + SIZE]
    _close(plain, TF.to_float(crop).numpy(), atol=2e-6)


@pytest.mark.parametrize("rand_flip,with_jitter", [(True, True),
                                                   (False, False)])
def test_classifier_batch_unfused_explicit_decisions_match_jax(
        rand_flip, with_jitter):
    frames = np.random.default_rng(3).integers(
        0, 256, (B, T, H0, W0, 3), dtype=np.uint8)
    kw = dict(img_dim=SIZE, seq_len=T, rand_flip=rand_flip,
              with_color_jitter=with_jitter, jitter_order="sample")
    jcfg, tcfg = JP.AugConfig(**kw), TP.AugConfig(**kw)
    key = jax.random.PRNGKey(8)
    want = np.asarray(JP._classifier_train_batch_unfused(
        key, jnp.asarray(frames), jcfg))

    def draw(k):  # the JAX package's classifier_train_batch_fused draws
        k_crop, k_flip, k_jit = jax.random.split(k, 3)
        ky, kx = jax.random.split(k_crop)
        y0 = jax.random.randint(ky, (), 0, H0 - SIZE + 1)
        x0 = jax.random.randint(kx, (), 0, W0 - SIZE + 1)
        flip = (jax.random.uniform(k_flip) < 0.5) & rand_flip
        k_apply, k_factors, k_order = jax.random.split(k_jit, 3)
        f = JF.sample_jitter_factors(k_factors, T, 0.8, 0.8, 0.8, 0.2,
                                     "consistent")
        apply = jax.random.uniform(k_apply) < 0.8
        ident = dict(brightness=1.0, contrast=1.0, saturation=1.0, hue=0.0)
        factors = jnp.stack([jnp.where(apply, f[n][0], ident[n])
                             for n in TF.JITTER_NAMES])
        return (jnp.stack([y0, x0]), flip, jax.random.permutation(k_order, 4),
                factors)

    k_batch, _ = jax.random.split(key)
    crops, flips, orders, factors = (
        torch.from_numpy(np.array(a)) for a in jax.vmap(draw)(
            jax.random.split(k_batch, B)))
    got = TP._classifier_train_batch_unfused(
        None, torch.from_numpy(frames), tcfg, crops=crops, flips=flips,
        orders=orders, factors=factors)
    _close(got, want, NORM_ATOL)
    one = TP.classifier_train_sample(torch.Generator().manual_seed(1),
                                     torch.from_numpy(frames[0]), tcfg)
    assert torch.equal(one, TP._classifier_train_batch_unfused(
        torch.Generator().manual_seed(1), torch.from_numpy(frames[:1]),
        tcfg)[0])


@pytest.mark.parametrize("fused", ["auto", "on", "off", "maybe"])
@pytest.mark.parametrize("jitter", [
    dict(), dict(aug_temp_consist=False), dict(aug_temp_grad_consist=True)])
@pytest.mark.parametrize("check", [True, False])
def test_use_fused_dispatch_matches_jax(fused, jitter, check, monkeypatch):
    """JAX on one TPU (its backend read as 'tpu') against the port on the
    card, case by case: the result, or the error's type."""
    monkeypatch.setattr(JP.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(JP.jax, "device_count", lambda: 1)

    def outcome(fn, cfg):
        try:
            return fn(cfg)
        except ValueError:
            return ValueError

    want = outcome(lambda c: JP._use_fused(c, None, check),
                   JP.AugConfig(fused=fused, **jitter))
    got = outcome(lambda c: TP._use_fused(c, check),
                  TP.AugConfig(fused=fused, **jitter))
    if fused == "maybe":  # JAX reads an unknown name as 'not on'
        assert want is False and got is ValueError
    else:
        assert got == want


def _tag(scale):
    """A keyless per-clip transform of both packages: clip * scale."""
    return (lambda key, c: c * scale), (lambda g, c: c * scale)


def test_composers_match_jax():
    frames = _clips(1, t=2 * T)[0]
    jf, tf = zip(*[_tag(s) for s in (2.0, 3.0, 5.0)])
    key = jax.random.PRNGKey(2)
    jframes, tframes = jnp.asarray(frames), torch.from_numpy(frames)
    # transform_controller: the pick is one uniform draw after a split
    k_pick, _ = jax.random.split(key)
    u = float(jax.random.uniform(k_pick))
    for weights in ([0.2, 0.3, 0.5], [1.0, 0.0, 0.0]):
        want = np.asarray(JP.transform_controller(key, jframes, jf, weights))
        got = TP.transform_controller(None, tframes, tf, weights, pick=u)
        np.testing.assert_array_equal(got.numpy(), want)
    # randomized / two-clip: one pick a clip
    picks = [float(jax.random.uniform(jax.random.split(k)[0]))
             for k in jax.random.split(key, 2)]
    want = np.asarray(JP.two_clip_transform(key, jframes, jf[0], jf[1], T))
    got = TP.two_clip_transform(None, tframes, tf[0], tf[1], T, picks=picks)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(JP.randomized_transform(
        key, jframes, jf, [[0.1, 0.8, 0.1], [0.5, 0.0, 0.5]], T))
    got = TP.randomized_transform(None, tframes, tf,
                                  [[0.1, 0.8, 0.1], [0.5, 0.0, 0.5]], T,
                                  picks=picks)
    np.testing.assert_array_equal(got.numpy(), want)
    # one-clip: which half, then the order
    k_half, k_order, _, _ = jax.random.split(key, 4)
    want = np.asarray(JP.one_clip_transform(key, jframes, jf[0], jf[1], T))
    got = TP.one_clip_transform(None, tframes, tf[0], tf[1], T,
                                half=float(jax.random.uniform(k_half)),
                                swap=float(jax.random.uniform(k_order)))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(JP.multiple_clip_transform(key, jframes, jf[:2], T))
    got = TP.multiple_clip_transform(None, tframes, tf[:2], T)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(JP.two_crops_transform(key, jframes[:T], jf[2]))
    got = TP.two_crops_transform(None, tframes[:T], tf[2])
    np.testing.assert_array_equal(got.numpy(), want)
    # drawn from a generator: the same seed, the same composition
    g = [torch.Generator().manual_seed(7) for _ in range(2)]
    a, b = (TP.randomized_transform(gi, tframes, tf, [0.3, 0.3, 0.4], T)
            for gi in g)
    assert torch.equal(a, b)
