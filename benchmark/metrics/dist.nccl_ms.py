"""Device milliseconds a step in NCCL's kernels on process 0 (the batch
norms' statistics, the gathered negatives, the gradient all-reduce)."""

import re

NCCL = re.compile("nccl", re.IGNORECASE)


def read(ctx):
    t = sum(s for name, s in ctx.trace["by_kernel"].items()
            if NCCL.search(name))
    steps = ctx.trace["steps"]
    return t / steps * 1e3 if t and steps else None
