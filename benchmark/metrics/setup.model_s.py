"""Host seconds of the program's first ``dualvar.setup.build_task`` span
(``dualvar_tpu_torch/core/spans.py``): the model drawn from its seed."""


def read(ctx):
    try:
        from dualvar_tpu_torch.core import spans
    except ImportError:  # a program without the record
        return None
    ms = spans.first_ms("dualvar.setup.build_task")
    return ms / 1e3 if ms is not None else None
