"""Stream milliseconds a step of the augmentation stage: the program's
``dualvar.step.aug`` span (``dualvar_tpu_torch/core/spans.py``) timed by
CUDA events on the step's stream in the traced steps: the draws, the crop
gather, the kernel, and the stream's idle time inside the stage."""


def read(ctx):
    try:
        from dualvar_tpu_torch.core import spans
    except ImportError:  # a program without the record
        return None
    n = ctx.trace["steps"] if ctx.trace else 0
    steps = [v for v in spans.steps() if v["profiled"]][-n:] if n else []
    times = [v["stream_ms"]["dualvar.step.aug"] for v in steps
             if "dualvar.step.aug" in v["stream_ms"]]
    return sum(times) / len(times) if times else None
