"""Host milliseconds a step spent waiting for the device: the program's
``dualvar.sync.*`` spans (``dualvar_tpu_torch/core/spans.py``), the mean
over the window's steps as the program's record keeps them (its last 256
steps at most)."""


def read(ctx):
    try:
        from dualvar_tpu_torch.core import spans
    except ImportError:  # a program without the record
        return None
    n = ctx.window["steps"]
    steps = [v for v in spans.steps() if not v["profiled"]][-n:] if n else []
    if not steps:
        return None
    return sum(ms for v in steps for name, ms in v["host_ms"].items()
               if name.startswith(spans.SYNC)) / len(steps)
