"""Shared helpers of the tests/test_torch_port_*.py files: JAX variable trees
filled with seeded numpy values, so both packages start from the same
weights without compiling a JAX initialiser."""

import jax
import numpy as np
from flax.traverse_util import flatten_dict, unflatten_dict


def numpy_variables(model, example, seed, **init_kwargs):
    """The variable tree of a flax ``model`` (shapes from ``jax.eval_shape``
    of its init on ``example``) with every leaf drawn by numpy from ``seed``:
    kernels ~ N(0, 1/fan_in), BN scale and var ~ U(0.5, 1.5), biases and
    means ~ N(0, 0.1). Returns (params, batch_stats) as nested dicts of
    float32 numpy arrays."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: model.init({"params": key, "shuffle": key}, example,
                           **init_kwargs))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in sorted(flatten_dict(shapes).items()):
        name = path[-1]
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            val = rng.normal(0.0, 1.0 / np.sqrt(fan_in), leaf.shape)
        elif name in ("scale", "var"):
            val = rng.uniform(0.5, 1.5, leaf.shape)
        else:  # bias, mean
            val = rng.normal(0.0, 0.1, leaf.shape)
        flat[path] = val.astype(np.float32)
    tree = unflatten_dict(flat)
    return tree["params"], tree.get("batch_stats", {})
