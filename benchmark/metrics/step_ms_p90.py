"""The 90th percentile of the window's step intervals, from one step's
end event on the device to the next's."""

import statistics


def read(ctx):
    iv = ctx.window["intervals_ms"]
    if len(iv) < 10:
        return None
    return statistics.quantiles(iv, n=10, method="inclusive")[-1]
