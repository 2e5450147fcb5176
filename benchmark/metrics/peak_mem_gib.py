"""The device memory the window's steps hold at their peak
(``max_memory_allocated`` after a reset at the window's start), GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
