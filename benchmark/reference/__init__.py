"""The plain float32 reference of the benchmark's configurations: the
models, the augmentation, the losses and SGD in plain PyTorch. It imports
nothing of the program under test."""
