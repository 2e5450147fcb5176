"""Host seconds of the program's ``dualvar.setup.kernel_load`` spans over
the process (``dualvar_tpu_torch/core/spans.py``, opened by
``ops/build.py:load_library``): each kernel library loaded, and built by
nvcc where ``build/kernels/`` does not hold it yet. Inside the first step
(``setup.first_step_s``) where a step loads it."""


def read(ctx):
    try:
        from dualvar_tpu_torch.core import spans
    except ImportError:  # a program without the record
        return None
    ms = spans.setup_ms("dualvar.setup.kernel_load")
    return ms / 1e3 if ms is not None else None
