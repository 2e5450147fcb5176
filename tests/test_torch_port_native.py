"""The port's native JPEG decoder (dualvar_tpu_torch.native) against the JAX
package's (dualvar_tpu.native) and PIL, on the CPU.

Both libraries are built here with g++ and libjpeg from their own copies of
``decoder.cpp`` with the same flags, so they must decode the same files to
the same bytes. Against PIL the bands are those of tests/test_native.py
(PIL's resampler accumulates in fixed point).
"""

import os

import numpy as np
import pytest

from dualvar_tpu import native as jax_native
from dualvar_tpu_torch import native

import torch_port_util  # noqa: F401  (caps torch's threads)

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _built():
    """Decided when the tests run, not when the module is imported: every
    worker collects the same tests."""
    if not (native.available() and jax_native.available()):
        pytest.skip("g++ or libjpeg missing: the native decoders cannot be "
                    "built")


@pytest.fixture(scope="module")
def noise_jpegs(tmp_path_factory):
    """Six 320x240 noise frames at JPEG quality 80 (UCF101's extracted
    size)."""
    d = tmp_path_factory.mktemp("noise")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(6):
        img = rng.randint(0, 255, (240, 320, 3), dtype=np.uint8)
        p = str(d / f"f{i}.jpg")
        Image.fromarray(img).save(p, quality=80)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def smooth_jpegs(tmp_path_factory):
    """Smooth frames (natural-image statistics), where the DCT-scaled fast
    decode is close to the exact one."""
    d = tmp_path_factory.mktemp("smooth")
    y, x = np.mgrid[0:240, 0:320].astype(np.float32)
    paths = []
    for i in range(4):
        img = np.stack([
            127 + 100 * np.sin(x / (23.0 + i) + c) * np.cos(y / 31.0 - c)
            for c in range(3)], -1).clip(0, 255).astype(np.uint8)
        p = str(d / f"s{i}.jpg")
        Image.fromarray(img).save(p, quality=80)
        paths.append(p)
    return paths


@pytest.mark.parametrize("fast", [False, True])
def test_decode_is_bitwise_the_jax_packages(noise_jpegs, smooth_jpegs, fast):
    paths = noise_jpegs + smooth_jpegs
    got = native.decode_jpeg_files(paths, (171, 128), n_threads=3, fast=fast)
    want = jax_native.decode_jpeg_files(paths, (171, 128), n_threads=2,
                                        fast=fast)
    assert got.shape == (10, 171, 128, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    into = np.empty_like(got)
    assert native.decode_jpeg_files_into(paths, into, n_threads=4, fast=fast)
    np.testing.assert_array_equal(into, want)


def test_resize_is_bitwise_the_jax_packages():
    rng = np.random.RandomState(1)
    for shape, out in (((50, 40, 3), (100, 90)), ((240, 320, 3), (128, 171)),
                       ((37, 61, 3), (37, 20))):
        img = rng.randint(0, 255, shape, dtype=np.uint8)
        np.testing.assert_array_equal(native.resize_bicubic(img, out),
                                      jax_native.resize_bicubic(img, out))


def test_decode_matches_pil(noise_jpegs):
    out = native.decode_jpeg_files(noise_jpegs, (171, 128), n_threads=4)
    pil = np.stack([
        np.asarray(Image.open(p).convert("RGB").resize((128, 171),
                                                       Image.BICUBIC))
        for p in noise_jpegs])
    diff = np.abs(out.astype(int) - pil.astype(int))
    # tests/test_native.py's band: PIL accumulates in fixed point
    assert diff.mean() < 0.6 and diff.max() <= 8


def test_fast_decode_is_close_to_the_exact_one(smooth_jpegs):
    exact = native.decode_jpeg_files(smooth_jpegs, (171, 128))
    fast = native.decode_jpeg_files(smooth_jpegs, (171, 128), fast=True)
    diff = np.abs(exact.astype(int) - fast.astype(int))
    assert 0 < diff.max() and diff.mean() < 2.0


def test_a_missing_file_is_zero_filled(noise_jpegs, tmp_path):
    broken = str(tmp_path / "broken.jpg")
    with open(broken, "wb") as fh:
        fh.write(b"not a jpeg")
    paths = [noise_jpegs[0], str(tmp_path / "missing.jpg"), broken,
             noise_jpegs[1]]
    out = native.decode_jpeg_files(paths, (48, 40))
    assert not out[1].any() and not out[2].any()
    assert out[0].std() > 5 and out[3].std() > 5
    np.testing.assert_array_equal(
        out[[0, 3]], native.decode_jpeg_files([paths[0], paths[3]], (48, 40)))


def test_readahead_counts_the_files_it_advised(noise_jpegs, tmp_path):
    missing = str(tmp_path / "missing.jpg")
    assert native.readahead_files(noise_jpegs + [missing]) == len(noise_jpegs)
    assert native.readahead_files([]) == 0


def test_library_is_built_under_build_native_and_nowhere_in_the_package():
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "native")
    assert os.path.exists(path)
    assert os.path.basename(path).startswith("libdvnative_")
    package = os.path.join(ROOT, "dualvar_tpu_torch")
    built = [os.path.join(base, n) for base, _, names in os.walk(package)
             for n in names if n.endswith(".so")]
    assert built == []
    # the name changes with the source: a stale library is never loaded
    assert len(os.path.basename(path)) == len("libdvnative_") + 12 + 3
