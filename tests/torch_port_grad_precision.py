"""How precise each package's float32 backward pass is on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_port_grad_precision.py

At the size of tests/test_torch_port_slice.py (B=2, T=8, 32x32, the same
numpy-made weights, block and segment permutation) this computes the gradient
of the SimCLR-TimeSeriesV4 total loss four ways — the JAX package and the
PyTorch port, each in float32 and in float64 — and prints, per parameter
tensor, the largest deviation from the port's float64 gradient on the scale
of that tensor's largest entry. It is a diagnostic, not a test: it explains
why the slice test takes its gradient oracle from JAX in float64.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import conftest  # noqa: E402,F401  (the suite's jax configuration)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from dualvar_tpu.models.ssl.simclr import SimCLRTimeSeriesV4 as JaxTSV4  # noqa: E402
from dualvar_tpu.train.tasks import total_loss as jax_total_loss  # noqa: E402
from dualvar_tpu_torch.core.config import ModelConfig  # noqa: E402
from dualvar_tpu_torch.core.convert import from_jax_variables  # noqa: E402
from dualvar_tpu_torch.models.layers import global_avg_pool3d  # noqa: E402
from dualvar_tpu_torch.train.tasks import make_task, total_loss  # noqa: E402
from torch_port_util import numpy_variables  # noqa: E402

B, T, S = 2, 8, 32
PERM = np.array([[1, 0], [0, 1]], np.int32)
KEYS = ("backbone.conv1.spatial_conv.weight",
        "backbone.layer1_block0.conv1.spatial_conv.weight",
        "backbone.layer4_block0.conv2.temporal_conv.weight",
        "clip_head.fc1.weight")


def port_grads(weights, block, dtype):
    task = make_task(ModelConfig(dtype="float32"))
    task.model.load_state_dict(from_jax_variables(*weights))
    task.model.train().to(dtype)
    # keep the pooled features in the working type (the model casts them to
    # float32, which would cut the float64 run short)
    task.model.pool_backbone = lambda x: global_avg_pool3d(
        task.model.backbone(x))
    ret = task.forward(torch.from_numpy(block).to(dtype),
                       perm=torch.from_numpy(PERM))
    total_loss(ret).backward()
    return {k: p.grad.double().numpy()
            for k, p in task.model.named_parameters()}


def jax_grads(weights, block, dtype):
    model = JaxTSV4(network="r21d", dtype=dtype)

    def loss_fn(params, stats):
        ret, _ = model.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(block, dtype), perm=jnp.asarray(PERM),
                             train=True, mutable=["batch_stats"])
        return jax_total_loss(ret)

    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    grads = jax.jit(jax.grad(loss_fn))(cast(weights[0]), cast(weights[1]))
    grads = jax.tree.map(lambda a: np.asarray(a, np.float64), grads)
    return {k: v.double().numpy()
            for k, v in from_jax_variables(grads, {}).items()}


def main():
    weights = numpy_variables(JaxTSV4(network="r21d"),
                              jnp.zeros((B, 3, T, S, S, 3)), seed=11,
                              train=True)
    block = np.random.default_rng(0).normal(
        size=(B, 3, T, S, S, 3)).astype(np.float32)
    runs = {"port f32": port_grads(weights, block, torch.float32),
            "jax f32": jax_grads(weights, block, jnp.float32)}
    ref = port_grads(weights, block, torch.float64)
    jax.config.update("jax_enable_x64", True)
    runs["jax f64"] = jax_grads(weights, block, jnp.float64)

    def dev(run, key):
        return np.abs(runs[run][key] - ref[key]).max() / np.abs(ref[key]).max()

    print("largest |g - g_port_f64| / max|g_port_f64| per tensor")
    for key in KEYS:
        print(f"{key:52s} " + "  ".join(
            f"{run} {dev(run, key):.2e}" for run in runs))
    for run in runs:
        worst = max(ref, key=lambda k: dev(run, k))
        print(f"worst over all tensors, {run}: {dev(run, worst):.2e} ({worst})")


if __name__ == "__main__":
    main()
