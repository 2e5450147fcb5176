"""Host milliseconds a step call takes (the trainer's enqueue of one
step, and whatever it waits for), the mean over the traced run's window,
taken before the profiler starts."""


def read(ctx):
    host = ctx.window["host_s"]
    return sum(host) / len(host) * 1e3 if host else None
