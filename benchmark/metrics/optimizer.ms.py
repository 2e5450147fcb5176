"""Device milliseconds a step under the optimizer's own profiler span
(``Optimizer.step#SGD.step``)."""


def read(ctx):
    t, steps = ctx.trace["optimizer_s"], ctx.trace["steps"]
    return t / steps * 1e3 if t and steps else None
