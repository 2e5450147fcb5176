"""Build and load the package's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. It is
compiled at first use with ``nvcc`` for sm_90a into a shared library under
``build/kernels/`` beside the package (an ignored directory) and loaded with
``ctypes``: seconds to build, no PyTorch headers. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under "
            f"{cuda_home}); the CUDA kernels cannot be built here")
    return path


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, and load it.

    The library's file name carries a hash of the source, so an edited
    source is rebuilt and a stale library is never loaded."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha1(fh.read()).hexdigest()[:12]
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        with open(os.path.join(BUILD_DIR, f"{name}.ptxas.log"), "w") as fh:
            fh.write(proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent process loads a whole file
    return ctypes.CDLL(lib)
