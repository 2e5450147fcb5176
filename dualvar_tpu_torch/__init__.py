"""PyTorch / CUDA port of ``dualvar_tpu`` for NVIDIA Hopper.

The layout mirrors the JAX package file by file so each counterpart is easy
to find. Nothing here imports ``jax`` or ``dualvar_tpu``; the JAX package is
the reference the port is tested against (tests/test_torch_port_*.py).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
