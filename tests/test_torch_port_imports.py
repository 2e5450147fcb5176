"""The port stands alone: importing every module of ``dualvar_tpu_torch``
pulls in neither JAX nor the JAX package, needs no CUDA toolchain, and
starts nothing; ``chip_smoke.py`` imports none of them either and refuses to
run without a card.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package, its dependencies, and the scripts beside it (which
# import the JAX package)
FORBIDDEN = ("jax", "flax", "optax", "orbax", "dualvar_tpu", "scripts")


def _run(code, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_every_port_module_imports_without_jax():
    code = """
import importlib, pkgutil, sys
import dualvar_tpu_torch
names = ["dualvar_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    dualvar_tpu_torch.__path__, "dualvar_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in %r)
assert not bad, bad
assert "triton" not in sys.modules
print("\\n".join(names))
""" % (FORBIDDEN,)
    out = _run(code)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 25  # the slices' modules were all seen
    assert {"dualvar_tpu_torch.ops.aug_fused", "dualvar_tpu_torch.ops.soft_dtw",
            "dualvar_tpu_torch.ops.bn_stats", "dualvar_tpu_torch.ops.conv_fused",
            "dualvar_tpu_torch.models.backbones.r3d",
            "dualvar_tpu_torch.models.backbones.c3d",
            "dualvar_tpu_torch.models.backbones.s3dg",
            "dualvar_tpu_torch.models.backbones.resnet_2d3d",
            "dualvar_tpu_torch.core.checkpoint",
            "dualvar_tpu_torch.core.dist",
            "dualvar_tpu_torch.core.convert",
            "dualvar_tpu_torch.core.metrics_writer",
            "dualvar_tpu_torch.core.utils",
            "dualvar_tpu_torch.export",
            "dualvar_tpu_torch.models.ssl.moco",
            "dualvar_tpu_torch.native",
            "dualvar_tpu_torch.data.prep.write_csv",
            "dualvar_tpu_torch.data.prep.extract_frames",
            "dualvar_tpu_torch.tools.learning_check",
            "dualvar_tpu_torch.tools.paper_chain",
            "dualvar_tpu_torch.tools.soak",
            "dualvar_tpu_torch.tools.moco_soak",
            "dualvar_tpu_torch.train.pretrain"} <= set(names)
    # the kernels' sources are data beside the package, not modules of it
    assert not any("csrc" in name for name in names)
    assert sorted(os.listdir(os.path.join(ROOT, "dualvar_tpu_torch", "csrc"))) \
        == ["aug_fused.cu", "bn_stats.cu", "conv_fused.cu", "soft_dtw.cu"]


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _port_sources():
    for base, _, files in os.walk(os.path.join(ROOT, "dualvar_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_names_no_forbidden_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    import shutil

    from dualvar_tpu_torch.ops import build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("aug_fused")
    assert os.listdir(tmp_path) == []


def test_library_name_covers_source_headers_and_flags(tmp_path, monkeypatch):
    """The cached library's name changes with the kernel's source, with any
    ``csrc/*.cuh`` header's bytes and with the kernel's nvcc flags, and not
    with another kernel's source: an edited header is never loaded from a
    stale library. No nvcc needed."""
    from dualvar_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(build, "KERNEL_FLAGS", {})
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "other.cu").write_text("// another kernel\n")
    (csrc / "h.cuh").write_text("#define X 1\n")
    first = build.library_path("k")
    assert os.path.dirname(first) == str(tmp_path / "kernels")
    assert os.path.basename(first).startswith("libk_")
    (csrc / "other.cu").write_text("// edited\n")
    assert build.library_path("k") == first
    (csrc / "h.cuh").write_text("#define X 2\n")
    second = build.library_path("k")
    assert second != first
    (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    third = build.library_path("k")
    assert third not in (first, second)
    monkeypatch.setattr(build, "KERNEL_FLAGS", {"k": ("-DEXTRA",)})
    assert build.library_path("k") not in (first, second, third)
    monkeypatch.setattr(build, "KERNEL_FLAGS", {"other": ("-DEXTRA",)})
    assert build.library_path("k") == third


def test_other_source_and_ptxas_log_are_keyed_like_the_library(
        tmp_path, monkeypatch):
    """Another source built with a kernel's flags gets a library of its
    own, and the kernel's own source given by path gets the kernel's; each
    library's ptxas log lies beside it and carries its hash, so a cached
    library is never described by the log of another build. No nvcc
    needed."""
    from dualvar_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    (csrc / "k.cu").write_text("// the kernel\n")
    other = tmp_path / "other.cu"
    other.write_text("// a variant\n")
    lib = build.library_path("k")
    assert build.library_path("k", str(csrc / "k.cu")) == lib
    assert build.library_path("k", str(other)) != lib
    assert build.ptxas_log_path("k") == lib + ".ptxas.log"
    assert build.ptxas_log_path("k", str(other)) == \
        build.library_path("k", str(other)) + ".ptxas.log"


def test_top_level_api_is_the_jax_packages_and_lazy():
    """``dualvar_tpu_torch.<name>`` for the JAX package's eleven top-level
    names, each the port's object, imported at first use; importing the
    package alone loads no model or kernel module (in a fresh process)."""
    import dualvar_tpu
    import dualvar_tpu_torch

    jax_names = set(ast.literal_eval(next(
        n.value for n in ast.walk(ast.parse(open(dualvar_tpu.__file__).read()))
        if isinstance(n, ast.Assign) and n.targets[0].id == "exports")))
    assert set(dualvar_tpu_torch._EXPORTS) == jax_names
    assert len(jax_names) == 11
    import importlib

    for name in sorted(jax_names):
        module, attr = dualvar_tpu_torch._EXPORTS[name]
        assert module.startswith("dualvar_tpu_torch."), (name, module)
        assert getattr(dualvar_tpu_torch, name) is getattr(
            importlib.import_module(module), attr)
    with pytest.raises(AttributeError):
        dualvar_tpu_torch.not_a_name  # noqa: B018
    out = _run("import sys, dualvar_tpu_torch; print(sorted(m for m in "
               "sys.modules if m.startswith('dualvar_tpu_torch')))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['dualvar_tpu_torch']"]
