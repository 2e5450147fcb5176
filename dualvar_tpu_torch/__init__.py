"""PyTorch / CUDA port of ``dualvar_tpu`` for NVIDIA Hopper.

The layout mirrors the JAX package file by file so each counterpart is easy
to find. Nothing here imports ``jax`` or ``dualvar_tpu``; the JAX package is
the reference the port is tested against (tests/test_torch_port_*.py).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

The top-level names below are imported lazily, at first use, as in the JAX
package, so ``import dualvar_tpu_torch`` stays light.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "select_backbone": ("dualvar_tpu_torch.models.backbones",
                        "select_backbone"),
    "SimCLRNaked": ("dualvar_tpu_torch.models.ssl.simclr", "SimCLRNaked"),
    "SimCLRTimeSeriesV4": ("dualvar_tpu_torch.models.ssl.simclr",
                           "SimCLRTimeSeriesV4"),
    "MoCoEncoder": ("dualvar_tpu_torch.models.ssl.moco", "MoCoEncoder"),
    "LinearClassifier": ("dualvar_tpu_torch.models.heads", "LinearClassifier"),
    "soft_dtw": ("dualvar_tpu_torch.ops.soft_dtw", "soft_dtw"),
    "soft_dtw_sequences": ("dualvar_tpu_torch.ops.soft_dtw",
                           "soft_dtw_sequences"),
    "PRETRAIN_PRESETS": ("dualvar_tpu_torch.core.config", "PRETRAIN_PRESETS"),
    "CLASSIFIER_PRESETS": ("dualvar_tpu_torch.core.config",
                           "CLASSIFIER_PRESETS"),
    "PretrainConfig": ("dualvar_tpu_torch.core.config", "PretrainConfig"),
    "ClassifierConfig": ("dualvar_tpu_torch.core.config", "ClassifierConfig"),
}


def __getattr__(name):
    """Lazy top-level API."""
    import importlib

    if name in _EXPORTS:
        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'dualvar_tpu_torch' has no attribute {name!r}")
