"""The heads' ``nonlinear=False`` of the port against the JAX package's, on
the CPU: without the clip head the embedding is the l2-normalised pooled
feature (reference model/simclr.py:167-170). SimCLRNaked, SimCLR
TimeSeriesV4 and MoCoEncoder train-mode forwards from the same numpy
weights and clips at 2e-4 (float32), MoCo's queue as wide as the feature,
and the reference converter's refusal of the nonlinear classifier head, as
the JAX converter refuses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.core import convert as JCV
from dualvar_tpu.models.ssl.moco import MoCoEncoder as JaxMoCoEncoder
from dualvar_tpu.models.ssl.simclr import SimCLRNaked as JaxNaked
from dualvar_tpu.models.ssl.simclr import SimCLRTimeSeriesV4 as JaxTSV4
from dualvar_tpu_torch.core import convert as TCV
from dualvar_tpu_torch.core.convert import from_jax_variables
from dualvar_tpu_torch.models.ssl.moco import MoCo, MoCoEncoder
from dualvar_tpu_torch.models.ssl.simclr import SimCLRNaked, SimCLRTimeSeriesV4

from torch_port_util import numpy_variables

B, T, S = 2, 4, 32


def _embed_jax(model, variables, x, **kw):
    return jax.jit(lambda v, x, kw: model.apply(
        v, x, train=True, mutable=["batch_stats"], **kw)[0])(
            variables, jnp.asarray(x), kw)


@pytest.mark.parametrize("which", ["naked", "tsv4", "moco_encoder"])
def test_nonlinear_false_forward_matches_jax(which):
    rng = np.random.default_rng(9)
    if which == "naked":
        jm, tm = JaxNaked(network="r3d", nonlinear=False), \
            SimCLRNaked(network="r3d", nonlinear=False)
        x = rng.normal(size=(B, 2, T, S, S, 3)).astype(np.float32)
    elif which == "tsv4":
        jm = JaxTSV4(network="r3d", nonlinear=False)
        tm = SimCLRTimeSeriesV4(network="r3d", nonlinear=False)
        x = rng.normal(size=(B, 3, T, S, S, 3)).astype(np.float32)
    else:
        jm = JaxMoCoEncoder(network="r3d", nonlinear=False)
        tm = MoCoEncoder(network="r3d", nonlinear=False)
        x = rng.normal(size=(B, T, S, S, 3)).astype(np.float32)
    assert not hasattr(tm, "clip_head")
    params, stats = numpy_variables(jm, jnp.asarray(x), seed=12, train=True)
    assert "clip_head" not in params
    tm.load_state_dict(from_jax_variables(params, stats, module=tm))
    tm.train()
    variables = {"params": params, "batch_stats": stats}
    perm = np.array([[1, 0], [0, 1]])
    if which == "moco_encoder":
        want = _embed_jax(jm, variables, x)
        got = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        assert got[0].shape == (B, 512)  # the pooled feature's width
        pairs = list(zip(got, want))
    else:
        kw = {"perm": jnp.asarray(perm)} if which == "tsv4" else {}
        want = _embed_jax(jm, variables, x, **kw)
        tkw = {"perm": torch.from_numpy(perm)} if which == "tsv4" else {}
        got = tm(torch.from_numpy(x), **tkw)
        assert set(got) == set(want)
        pairs = [(got[k], want[k]) for k in sorted(want)]
    for g, w in pairs:
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=2e-4, rtol=0)


def test_moco_without_heads_queues_the_pooled_feature():
    model = MoCo(network="r3d", K=8, nonlinear=False, naked=True,
                 generator=torch.Generator().manual_seed(0))
    assert model.queue.shape == (8, 512)
    ret = model(torch.rand(2, 2, T, S, S, 3))
    assert torch.isfinite(ret["clip_contrast_loss"])
    assert int(model.queue_ptr) == 2


def test_converter_refuses_the_nonlinear_classifier_head_as_jax_does():
    sd = {"backbone.conv1.weight": np.zeros((64, 3, 3, 7, 7), np.float32),
          "final_fc.1.weight": np.zeros((8, 512), np.float32),
          "final_fc.3.weight": np.zeros((5, 8), np.float32)}
    with pytest.raises(ValueError, match="nonlinear"):
        JCV.classifier_from_torch(sd, "r3d")
    with pytest.raises(ValueError, match="nonlinear"):
        TCV.classifier_from_torch(sd, "r3d")
