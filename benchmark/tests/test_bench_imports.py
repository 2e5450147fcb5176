"""No module under benchmark/ imports JAX or the JAX package (top-level
names compared whole: ``dualvar_tpu_torch`` is the program, ``dualvar_tpu``
is not), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "dualvar_tpu"}


def sources():
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


def test_the_names_are_compared_whole():
    assert "dualvar_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(top_level_imports(os.path.join(ref, f)))
            assert not names & {"dualvar_tpu_torch", "dualvar_tpu"}, f
            assert "benchmark" not in names, f  # relative imports only


def test_a_run_loads_no_jax_module():
    """The harness's modules and the program's step, imported in a fresh
    process, leave no JAX module in ``sys.modules``."""
    code = ("import sys; sys.path.insert(0, {root!r});"
            "import benchmark.cell, benchmark.calibrate;"
            "import dualvar_tpu_torch.train.pretrain;"
            "from benchmark.cell import _forbidden_modules;"
            "print(_forbidden_modules())").format(root=spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "k400_simclr_r21d.b32", "--seed", str(2 ** 31 + 3),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=spec.ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
