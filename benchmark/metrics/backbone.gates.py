"""Self-gates a step: the program's count ``gates``
(``dualvar_tpu_torch/core/spans.py``, one for each call of S3D-G's
``SelfGating``), the mean over the window's steps as the program's record
keeps them (its last 256 steps at most). None from a program that counts
no gate."""


def read(ctx):
    try:
        from dualvar_tpu_torch.core import spans
    except ImportError:  # a program without the record
        return None
    if not hasattr(spans, "count"):
        return None
    n = ctx.window["steps"]
    steps = [v for v in spans.steps() if not v["profiled"]][-n:] if n else []
    if not any("gates" in v["counts"] for v in steps):
        return None
    return sum(v["counts"].get("gates", 0) for v in steps) / len(steps)
