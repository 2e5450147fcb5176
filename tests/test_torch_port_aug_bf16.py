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
