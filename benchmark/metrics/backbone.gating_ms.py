"""Device milliseconds a step inside S3D-G's self-gates' spans (the
program's ``SelfGating`` modules: the mean, the fully connected layer, the
sigmoid and the product), forward and backward, whatever kernels compute
them."""

HOOKS = {"gating": {"SelfGating"}}


def read(ctx):
    t = ctx.trace["group_s"].get("gating", 0.0)
    steps = ctx.trace["steps"]
    return t / steps * 1e3 if t and steps else None
