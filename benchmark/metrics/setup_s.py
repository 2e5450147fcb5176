"""Seconds from the process's start to the window's first step: imports,
kernels loaded (or built) into the checkout's cache, the model, the frame
pool and the first steps at the cell's shapes."""


def read(ctx):
    return ctx.setup_s
