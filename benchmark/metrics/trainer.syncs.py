"""Host syncs a step: the program's count ``host_syncs``
(``dualvar_tpu_torch/core/spans.py``, one for each call on the step's path
that makes the host wait for the device), the mean over the window's
steps as the program's record keeps them (its last 256 steps at most)."""


def read(ctx):
    try:
        from dualvar_tpu_torch.core import spans
    except ImportError:  # a program without the record
        return None
    n = ctx.window["steps"]
    steps = [v for v in spans.steps() if not v["profiled"]][-n:] if n else []
    if not steps:
        return None
    return sum(v["counts"].get("host_syncs", 0) for v in steps) / len(steps)
