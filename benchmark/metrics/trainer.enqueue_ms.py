"""Host milliseconds a step spent issuing work: the program's
``dualvar.step`` span less the ``dualvar.sync.*`` spans inside it
(``dualvar_tpu_torch/core/spans.py``), launches held by a full queue
included; the mean over the window's steps as the program's record keeps
them (its last 256 steps at most)."""


def read(ctx):
    try:
        from dualvar_tpu_torch.core import spans
    except ImportError:  # a program without the record
        return None
    n = ctx.window["steps"]
    steps = [v for v in spans.steps() if not v["profiled"]][-n:] if n else []
    if not steps:
        return None
    return sum(v["host_ms"][spans.STEP]
               - sum(ms for name, ms in v["host_ms"].items()
                     if name.startswith(spans.SYNC))
               for v in steps) / len(steps)
