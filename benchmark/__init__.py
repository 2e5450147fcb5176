"""The benchmark of the PyTorch/CUDA port (``dualvar_tpu_torch``): see
README.md."""
