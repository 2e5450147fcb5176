"""Convolutions a step whose input is not in ``channels_last_3d`` memory:
the program's count ``nchw_convs`` (``dualvar_tpu_torch/core/spans.py``,
counted by ``models/layers.py:Conv3d``; on the card each is a call that
cuDNN transposes to NHWC and back), the mean over the window's steps as
the program's record keeps them (its last 256 steps at most). None from a
program that does not count it (no ``spans.count``)."""


def read(ctx):
    try:
        from dualvar_tpu_torch.core import spans
    except ImportError:  # a program without the record
        return None
    if not hasattr(spans, "count"):
        return None
    n = ctx.window["steps"]
    steps = [v for v in spans.steps() if not v["profiled"]][-n:] if n else []
    if not steps:
        return None
    return sum(v["counts"].get("nchw_convs", 0) for v in steps) / len(steps)
