"""Collectives a step that process 0 issued, all kinds together: the
program's own counter (``core/dist.py:collectives``) over the window."""


def read(ctx):
    n = ctx.counters.get("collectives_per_step")
    return n if n else None
