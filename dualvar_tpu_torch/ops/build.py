"""Build and load the package's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface (it may
include headers ``csrc/*.cuh``). It is compiled at first use with ``nvcc``
for sm_90a into a shared library under ``build/kernels/`` beside the package
(an ignored directory) and loaded with ``ctypes``: seconds to build, no
PyTorch headers. A failed build raises. ptxas's report of the build
(registers, stack frame, spills of every kernel) is kept beside the library
as ``<library>.ptxas.log``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

from ..core import spans

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# a kernel's own nvcc flags beside NVCC_FLAGS, by name: for example
# ("-I/usr/local/cutlass/include",) for a source that includes CuTe. None of
# the package's kernels needs any today.
KERNEL_FLAGS: dict[str, tuple[str, ...]] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under "
            f"{cuda_home}); the CUDA kernels cannot be built here")
    return path


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def _source(name: str, source: str | None) -> str:
    return source or os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str, source: str | None = None) -> str:
    """Where the library of ``csrc/<name>.cu`` (or of ``source``, another
    file built with kernel ``name``'s flags) lives: its file name carries a
    hash of the source, of every ``csrc/*.cuh`` header and of the nvcc
    flags, so an edited source or header, or new flags, give a new library
    and a stale one is never loaded."""
    digest = hashlib.sha1()
    for path in [_source(name, source),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + fh.read() + b"\0")
    digest.update("\0".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def ptxas_log_path(name: str, source: str | None = None) -> str:
    """ptxas's report of the build of ``library_path(name, source)``."""
    return library_path(name, source) + ".ptxas.log"


@functools.lru_cache(maxsize=None)
def load_library(name: str, source: str | None = None) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (or ``source`` with kernel ``name``'s
    flags) if its library or the library's ptxas log is missing, and load
    it, in the span ``dualvar.setup.kernel_load``."""
    with spans.span("dualvar.setup.kernel_load"):
        src = _source(name, source)
        lib = library_path(name, source)
        log = ptxas_log_path(name, source)
        if not (os.path.exists(lib) and os.path.exists(log)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *_flags(name), "-Xptxas", "-v", "-o", tmp, src],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            with open(log, "w") as fh:
                fh.write(proc.stderr)
            # atomic: a concurrent process loads a whole file
            os.replace(tmp, lib)
        return ctypes.CDLL(lib)
