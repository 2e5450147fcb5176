"""Device milliseconds a step inside the batch-norm modules' spans,
forward and backward, whatever kernels compute them."""

HOOKS = {"bn": {"BatchNorm", "BatchNorm3d", "SyncBatchNorm"}}


def read(ctx):
    t = ctx.trace["group_s"].get("bn", 0.0)
    steps = ctx.trace["steps"]
    return t / steps * 1e3 if t and steps else None
