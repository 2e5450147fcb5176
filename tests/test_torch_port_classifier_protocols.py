"""The classifier's multi-crop test protocols (center, five, ten crop)
through the port's protocol functions and the JAX package's, on the same
tiny config and the same weights (``torch_port_util.classifier_test_configs``).

Accuracies must be equal. The probabilities behind them (the same weights
and crops through both models), the temporal 10-clip and retrieval protocols
are in ``test_torch_port_classifier_retrieval.py``: one JAX ten-crop pass
compiles ten programs, which is this file's time.
"""

import os

import pytest

from dualvar_tpu.train import classifier as JC
from dualvar_tpu_torch.train import classifier as TC

from torch_port_util import classifier_test_configs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return classifier_test_configs(tmp_path_factory.mktemp("protocols"))


@pytest.fixture(scope="module")
def jax_ten(setup):
    return JC.test_multicrop(setup[0], "ten")


@pytest.mark.parametrize("protocol", ["center", "five", "ten"])
def test_multicrop_accuracies_equal_jax(setup, jax_ten, protocol):
    """One JAX ten-crop pass gives the nested center / five / ten groups;
    each port protocol must give the same accuracies for its groups."""
    got = TC.test_multicrop(setup[1], protocol, device="cpu")
    groups = ["center", "five", "ten"][
        : ["center", "five", "ten"].index(protocol) + 1]
    for g in groups:
        for k in ("top1", "top5"):
            assert got[f"{g}_{k}"] == jax_ten[f"{g}_{k}"], (g, k)
    assert got["top1"] == jax_ten[f"{protocol}_top1"]
    assert 0.0 <= got["top1"] <= 1.0
    path = os.path.join(TC.set_path(setup[1]), f"prob-{protocol}.json")
    assert os.path.exists(path)
