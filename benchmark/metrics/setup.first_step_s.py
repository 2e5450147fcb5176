"""Host seconds of the program's first ``dualvar.step`` span
(``dualvar_tpu_torch/core/spans.py``): the step's first call, which warms
up its shapes (kernels loaded or built, cuDNN's plans, the allocator)."""


def read(ctx):
    try:
        from dualvar_tpu_torch.core import spans
    except ImportError:  # a program without the record
        return None
    ms = spans.first_ms(spans.STEP)
    return ms / 1e3 if ms is not None else None
