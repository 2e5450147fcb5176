"""The share of the traced window in which no kernel, copy or fill runs on
the device (the union of their intervals)."""


def read(ctx):
    t = ctx.trace
    if not t["window_s"]:
        return None
    return 100 * (1 - t["busy_s"] / t["window_s"])
