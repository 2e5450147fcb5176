"""Stream milliseconds a step of the heads and the loss terms' forward: the
program's ``dualvar.losses`` spans (``dualvar_tpu_torch/core/spans.py``)
timed by CUDA events on the step's stream in the traced steps."""


def read(ctx):
    try:
        from dualvar_tpu_torch.core import spans
    except ImportError:  # a program without the record
        return None
    n = ctx.trace["steps"] if ctx.trace else 0
    steps = [v for v in spans.steps() if v["profiled"]][-n:] if n else []
    times = [v["stream_ms"]["dualvar.losses"] for v in steps
             if "dualvar.losses" in v["stream_ms"]]
    return sum(times) / len(times) if times else None
