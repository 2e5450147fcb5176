"""ctypes bindings for the host-side JPEG decoder (``decoder.cpp``).

Own copy of ``dualvar_tpu/native``: the same C++ source and the same API
(``available``, ``decode_jpeg_files``, ``decode_jpeg_files_into``,
``readahead_files``, ``resize_bicubic``). This is host code, not a device
kernel: it is compiled with ``g++`` against libjpeg at first use into
``build/native/`` beside the package (an ignored directory), never next to
the source. The library's file name carries a hash of the source and of the
compiler flags, so an edited source or new flags give a new library and a
stale one is never loaded (as ``ops/build.py`` does for the CUDA kernels).

The flags are the JAX package's (no ``-march=native``): the same source built
with the same flags decodes to the same bytes in both packages.

Where ``g++`` or libjpeg is missing the build fails, ``available()`` is false
and every function returns ``None`` / ``False`` / 0; ``JpegFrameSource`` then
decodes with PIL (and refuses ``fast_decode``, which only this library has).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "decoder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the library of ``decoder.cpp`` lives: its name carries a hash
    of the source and of the flags."""
    digest = hashlib.sha1()
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read() + b"\0")
    digest.update("\0".join(GXX_FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR, f"libdvnative_{digest.hexdigest()[:12]}.so")


def _build(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, SOURCE, "-o", tmp, *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, OSError):
        return False
    os.replace(tmp, path)  # atomic: a concurrent process loads a whole file
    return True


def lib():
    """The loaded native library, or None when it cannot be built here."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            L = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        L.dv_decode_files.restype = ctypes.c_int
        L.dv_decode_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int,
        ]
        L.dv_decode_buffers.restype = ctypes.c_int
        L.dv_decode_buffers.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
            ctypes.c_int,
        ]
        L.dv_readahead_files.restype = ctypes.c_int
        L.dv_readahead_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ]
        L.dv_resize_bicubic.restype = None
        L.dv_resize_bicubic.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int,
        ]
        _lib = L
        return _lib


def available() -> bool:
    return lib() is not None


def _paths_arg(paths: list[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def _decode_into(L, paths: list[str], out: np.ndarray, n_threads: int,
                 fast: bool) -> int:
    n, H, W, _ = out.shape
    return L.dv_decode_files(
        _paths_arg(paths), n, H, W,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads,
        int(fast))


def decode_jpeg_files(paths: list[str], out_hw: tuple[int, int],
                      n_threads: int = 8, fast: bool = False
                      ) -> np.ndarray | None:
    """Decode and resize JPEG files to a (n, H, W, 3) uint8 batch; None if
    the library is unavailable. A frame that fails to decode (a missing or
    broken file) comes back zero-filled. ``fast=True`` decodes at the
    smallest k/8 DCT scale that covers ``out_hw`` (most of the IDCT work is
    skipped): the pixels are close to, not bitwise equal with, the exact
    decode."""
    L = lib()
    if L is None:
        return None
    H, W = out_hw
    out = np.empty((len(paths), H, W, 3), dtype=np.uint8)
    _decode_into(L, paths, out, n_threads, fast)
    return out


def decode_jpeg_files_into(paths: list[str], out: np.ndarray,
                           n_threads: int = 8, fast: bool = False) -> bool:
    """Decode and resize JPEG files straight into a caller's (n, H, W, 3)
    C-contiguous uint8 buffer: the batch assembler's route, one native call
    a batch, the thread pool balancing over every frame of every sample.
    Returns False when the library is unavailable. ``fast`` as in
    ``decode_jpeg_files``."""
    L = lib()
    if L is None:
        return False
    n, H, W, C = out.shape
    assert C == 3 and len(paths) == n and out.dtype == np.uint8
    assert out.flags["C_CONTIGUOUS"]
    _decode_into(L, paths, out, n_threads, fast)
    return True


def readahead_files(paths: list[str]) -> int:
    """Ask the kernel to pull these files into the page cache
    (``posix_fadvise`` WILLNEED; returns at once): the loader hints the
    batches one prefetch window ahead, so cold-cache reads overlap the
    decode of the current batch. Returns the number of files advised (0
    when the library is unavailable: a no-op hint)."""
    L = lib()
    if L is None or not paths:
        return 0
    return L.dv_readahead_files(_paths_arg(paths), len(paths))


def resize_bicubic(img: np.ndarray, out_hw: tuple[int, int]
                   ) -> np.ndarray | None:
    """(H, W, 3) uint8 -> (out_h, out_w, 3) uint8 through the library's
    resampler; None if the library is unavailable."""
    L = lib()
    if L is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W = out_hw
    out = np.empty((H, W, 3), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    L.dv_resize_bicubic(img.ctypes.data_as(u8p), img.shape[0], img.shape[1],
                        out.ctypes.data_as(u8p), H, W)
    return out
