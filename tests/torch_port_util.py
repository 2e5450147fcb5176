"""Shared helpers of the tests/test_torch_port_*.py files: JAX variable trees
filled with seeded numpy values, so both packages start from the same
weights without compiling a JAX initialiser."""

import jax
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

# Every tests/test_torch_port_*.py file imports this module, so this caps
# torch's intra-op threads in each test process. The suite runs in six
# worker processes beside XLA's own thread pools; torch's default of one
# thread a core oversubscribes the machine several times over. Not 1: one
# thread sums float32 in an order that moves one float32-vs-float64
# gradient comparison out of its band (ROADMAP.md, C).
TORCH_THREADS = 2
torch.set_num_threads(TORCH_THREADS)


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


def moco_numpy_state(encoder, example, K, seed, ptr=4):
    """A whole JAX MoCo ``TaskState`` as numpy: query and key variable trees
    of the flax ``encoder`` drawn from different seeds (so the momentum
    update moves the key encoder), both queues unit-norm per segment, and a
    pointer that is not 0. Returns (params, batch_stats, moco) with ``moco``
    a dict of the ``MoCoState`` fields; ``series_queue`` is None for an
    encoder without a series head."""
    params, stats = numpy_variables(encoder, example, seed=seed, train=True)
    params_k, stats_k = numpy_variables(encoder, example, seed=seed + 1,
                                        train=True)
    rng = np.random.default_rng(seed + 2)

    def unit(shape):
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    series_queue = None
    if encoder.with_series:
        series_queue = unit((K, encoder.n_series, encoder.series_dim)).reshape(
            K, encoder.n_series * encoder.series_dim)
    moco = {"params_k": params_k, "batch_stats_k": stats_k,
            "queue": unit((K, encoder.dim)), "series_queue": series_queue,
            "ptr": np.asarray(ptr, np.int32)}
    return params, stats, moco


def classifier_test_configs(tmp_path):
    """The same tiny classifier test setup in both packages: the smoke
    preset at ``tests/test_protocols.py``'s sizes (R3D, 4x32x32 clips, 2
    classes), 4 synthetic videos at ds 8 (a few test windows each, not
    dozens), batch 64: each pass is one batch, so the JAX protocols, which
    do not pad a short last batch, compile one program a pass. The JAX
    protocols test the random init they build from ``PRNGKey(0)``
    (``_load_test_state``); the same variables go through
    ``from_jax_variables`` into a port classifier checkpoint, which the
    port's config reads as ``--resume``.

    Returns (JAX config, port config, JAX model, its variables, the port
    model holding the same weights, in eval mode)."""
    import dataclasses

    import jax.numpy as jnp

    from dualvar_tpu.core.config import CLASSIFIER_PRESETS as JAX_PRESETS
    from dualvar_tpu.core.config import ModelConfig as JaxModelConfig
    from dualvar_tpu.train import classifier as JC
    from dualvar_tpu_torch.core.config import CLASSIFIER_PRESETS, ModelConfig
    from dualvar_tpu_torch.core.convert import from_jax_variables
    from dualvar_tpu_torch.train import classifier as TC

    def tiny(cfg, model_cfg, log_root, ckpt=""):
        return dataclasses.replace(
            cfg, num_class=2,
            data=dataclasses.replace(
                cfg.data, seq_len=4, ds=8, img_dim=32, scale_hw=(40, 36),
                synthetic_videos=4, synthetic_classes=2, workers=2),
            model=model_cfg,
            optim=dataclasses.replace(cfg.optim, batch_size=64),
            run=dataclasses.replace(cfg.run, log_root=str(log_root),
                                    resume=ckpt))

    jcfg = tiny(JAX_PRESETS["smoke"],
                JaxModelConfig(net="r3d", dtype="float32"), tmp_path / "jax")
    jmodel = JC.build_model(jcfg)
    key = jax.random.PRNGKey(0)
    variables = jmodel.init(
        {"params": key, "dropout": key},
        jnp.zeros((1, jcfg.data.seq_len, jcfg.data.img_dim,
                   jcfg.data.img_dim, 3), jnp.float32), train=True)
    ckpt = str(tmp_path / "port_init.pth.tar")
    pcfg = tiny(CLASSIFIER_PRESETS["smoke"],
                ModelConfig(net="r3d", dtype="float32"), tmp_path / "port",
                ckpt)
    model = TC.build_model(pcfg)
    state = from_jax_variables(variables["params"], variables["batch_stats"],
                               model)
    torch.save({"epoch": 0, "state_dict": state}, ckpt)
    model.load_state_dict(state)
    return jcfg, pcfg, jmodel, variables, model.eval()
