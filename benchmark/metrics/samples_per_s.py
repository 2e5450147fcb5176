"""Training samples completed a second: every sample of every step of the
window over the window's host seconds (a sample is one video's three
clips; on several processes, the global batch's)."""


def read(ctx):
    w = ctx.window
    samples = w["steps"] * ctx.batch * ctx.processes
    return samples / w["seconds"] if w["steps"] else None
