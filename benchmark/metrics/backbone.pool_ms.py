"""Device milliseconds a step inside the max pools' spans (the program's
``MaxPool3d`` modules, ``models/layers.py``), forward and backward,
whatever kernels compute them. None from a program whose pools are no
modules."""

HOOKS = {"pool": {"MaxPool3d"}}


def read(ctx):
    t = ctx.trace["group_s"].get("pool", 0.0)
    steps = ctx.trace["steps"]
    return t / steps * 1e3 if t and steps else None
