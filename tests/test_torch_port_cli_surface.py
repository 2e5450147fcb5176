"""The port's command lines have the JAX package's flags.

The flags are read with ``ast`` from the ``add_argument`` calls of both
packages' parsers (the JAX package is the reference and is not changed):
the port's set is the JAX set plus the flags only the port has (``--device``
everywhere, ``--synthetic``, and pretrain's ``--dtype``), and for the export
``--device`` in place of JAX's ``--platforms``. ``--remat`` and
``--fast_decode`` reach the pretrain config (they were refused before the
port had them); ``--fused_aug`` reaches the classifier's augmentation.
"""

import ast
import os

import pytest
from dualvar_tpu_torch.aug.pipeline import _use_fused
from dualvar_tpu_torch.train import classifier as TC
from dualvar_tpu_torch.train import pretrain as TP

import torch_port_util  # noqa: F401  (caps torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flags(path: str) -> set[str]:
    with open(os.path.join(ROOT, path)) as fh:
        tree = ast.parse(fh.read())
    return {a.value for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)}


@pytest.mark.parametrize("module,only_jax,only_port", [
    ("train/pretrain.py", set(), {"--device", "--dtype", "--synthetic"}),
    ("train/classifier.py", set(), {"--device", "--synthetic"}),
    ("export.py", {"--platforms"}, {"--device"}),
])
def test_port_flags_are_the_jax_flags(module, only_jax, only_port):
    jax_flags = _flags(os.path.join("dualvar_tpu", module))
    port_flags = _flags(os.path.join("dualvar_tpu_torch", module))
    assert port_flags - jax_flags == only_port
    assert jax_flags - port_flags == only_jax


@pytest.mark.parametrize("args", [("--remat",), ("--fast_decode", "1")])
def test_pretrain_flags_reach_the_config(args, monkeypatch):
    """Both flags were refused before the port had rematerialisation and
    the native decoder; now each reaches the config ``train`` gets, and is
    off without the flag."""
    seen = []
    monkeypatch.setattr(TP, "train", lambda cfg, **kw: seen.append(cfg))
    TP.main(["--preset", "smoke", "--device", "cpu", *args])
    TP.main(["--preset", "smoke", "--device", "cpu"])
    flag = {"--remat": lambda c: c.model.remat,
            "--fast_decode": lambda c: c.data.fast_decode}[args[0]]
    assert flag(seen[0]) is True and flag(seen[1]) is False


def test_classifier_fused_aug_reaches_the_augmentation(monkeypatch):
    """``--fused_aug off`` sets the classifier's augmentation to the
    unfused path on any device (``_use_fused`` false); the default is the
    fused path."""
    seen = []
    monkeypatch.setattr(TC, "train", lambda cfg, **kw: seen.append(cfg))
    TC.main(["--preset", "smoke", "--device", "cpu", "--fused_aug", "off"])
    aug = TC._aug_config(seen[0])
    assert aug.fused == "off"
    assert _use_fused(aug, check_jitter_mode=False) is False
    TC.main(["--preset", "smoke", "--device", "cpu"])
    assert TC._aug_config(seen[1]).fused == "auto"
    assert _use_fused(TC._aug_config(seen[1]), check_jitter_mode=False)
