"""Shared helpers of the tests/test_torch_port_*.py files: JAX variable trees
filled with seeded numpy values, so both packages start from the same
weights without compiling a JAX initialiser."""

import contextlib

import jax
import jax.numpy as jnp
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


# -- backbones against the JAX package -------------------------------------

# the backbone band of tests/test_torch_parity.py: float32 convolutions
# summed in another order through up to 53 conv + BN layers
BACKBONE_ATOL, BACKBONE_RTOL = 2e-4, 1e-3
# float64 on both sides; the JAX gradient reaches the comparison through
# from_jax_variables, which stores float32: its rounding, 6e-8 of the scale
BACKBONE_GRAD_ATOL = 1e-6
# a parameter whose effect a train-mode batch norm downstream removes (a
# conv bias ahead of a batch norm; S3D's Mixed_4f.branch1_1.bn2.bias, under
# the pool to 1x1x1, 1x1 convs and batch norms of Mixed_5b) has a gradient
# of 0 up to the float64 rounding of the larger ones it sums: 3.7e-9 there
# against a largest gradient of 3e8, the two packages' values 3.6e-9 apart;
# C3D's conv biases 1e-13 against 97, 1.1e-13 apart. Such a gradient is
# compared on this share of the network's largest gradient instead of its
# own largest entry: within 1e-14 of the largest gradient, where float64
# rounding over some 1e5 summed terms lands.
GRAD_FLOOR = 1e-8


@contextlib.contextmanager
def x64():
    """JAX's float64 switched on inside the block."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def backbone_pair(net, size, seed):
    """(net, JAX backbone, params, batch_stats, port backbone) with the same
    numpy-made weights; ``size`` is the (B, T, S) of the inputs."""
    from dualvar_tpu.models.backbones import select_backbone as jax_backbone
    from dualvar_tpu_torch.core.convert import from_jax_variables
    from dualvar_tpu_torch.models.backbones import select_backbone

    _, T, S = size
    jm, _ = jax_backbone(net)
    params, stats = numpy_variables(jm, jnp.zeros((1, T, S, S, 3)),
                                    seed=seed, train=False)
    tm, _ = select_backbone(net)
    tm.load_state_dict(from_jax_variables(params, stats, module=tm))
    return net, jm, params, stats, tm


def backbone_input(size, seed):
    """A numpy clip batch of ``size`` (B, T, S): (NCDHW, NTHWC)."""
    B, T, S = size
    x = np.random.default_rng(seed).normal(
        size=(B, 3, T, S, S)).astype(np.float32)
    return x, x.transpose(0, 2, 3, 4, 1)


def _ncdhw(y):
    return np.asarray(y).transpose(0, 4, 1, 2, 3)


def check_backbone_eval_forward(net, jm, params, stats, tm, size, seed):
    """Eval mode (running statistics), float32 on both sides, within the
    backbone band. Returns the port's output."""
    x_t, x_j = backbone_input(size, seed)
    want = _ncdhw(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x_j)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x_t))
    assert got.shape == want.shape, net
    np.testing.assert_allclose(got.numpy(), want, atol=BACKBONE_ATOL,
                               rtol=BACKBONE_RTOL)
    return got


def check_backbone_train_step_float64(net, jm, params, stats, tm, size,
                                      seed):
    """One train-mode step of sum(features * w), both packages in float64:
    the features (the backbone band), the running mean and biased running
    variance folded in (1e-6), and the gradient of every parameter
    (``BACKBONE_GRAD_ATOL`` of its largest entry, or of ``GRAD_FLOOR`` of
    the network's largest gradient where that is more). Float64 because the JAX package's float32 train-mode forward
    is no oracle either: for r50 at (2, 8, 32), whose last 16 batch norms
    see 16 values a channel, it lies 3.3e-3 from its own float64 result
    (the port's float32: 8.2e-4)."""
    from dualvar_tpu.models.backbones import select_backbone as jax_backbone
    from dualvar_tpu_torch.core.convert import from_jax_variables

    x_t, x_j = backbone_input(size, seed)
    jm64, _ = jax_backbone(net, dtype=jnp.float64)
    with torch.no_grad():
        out_shape = tm.eval()(torch.from_numpy(x_t)).shape
    w = np.random.default_rng(seed + 1).normal(size=out_shape)

    def loss_fn(p, s, x):
        y, upd = jm64.apply({"params": p, "batch_stats": s}, x, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w.transpose(0, 2, 3, 4, 1))), (
            y, upd["batch_stats"])

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

    with x64():
        grads, (y, new_stats) = jax.tree.map(np.asarray, jax.jit(jax.grad(
            loss_fn, has_aux=True))(f64(params), f64(stats),
                                    jnp.asarray(x_j, jnp.float64)))
    tm.double().train()
    got = tm(torch.from_numpy(x_t).double())
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _ncdhw(y),
                               atol=BACKBONE_ATOL, rtol=BACKBONE_RTOL)
    want_state = from_jax_variables(params, new_stats)
    for key, val in tm.state_dict().items():
        if "running_" in key:
            np.testing.assert_allclose(val.numpy(), want_state[key].numpy(),
                                       atol=1e-6, rtol=1e-6, err_msg=key)
    want = from_jax_variables(grads, {})
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    largest = max(float(v.abs().max()) for v in want.values())
    for key, p in named.items():
        ref = want[key].double().numpy()
        scale = max(np.abs(ref).max(), GRAD_FLOOR * largest)
        assert scale > 0, key
        np.testing.assert_allclose(p.grad.numpy() / scale, ref / scale,
                                   atol=BACKBONE_GRAD_ATOL, err_msg=key)
