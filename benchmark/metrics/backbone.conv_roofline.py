"""The backbone's convolutions' share of the bf16 peak: their forward and
backward FLOPs counted from the cell's shapes (``counts.conv_flops``)
over the device time spent inside the convolution modules' spans, forward
and backward, whatever kernels compute them; on several processes,
process 0's batch and kernels."""

from benchmark import counts

HOOKS = {"conv": {"Conv3d"}}


def read(ctx):
    t = ctx.trace["group_s"].get("conv", 0.0)
    if not t or not ctx.trace["steps"]:
        return None
    flops = counts.conv_flops(ctx.config, ctx.batch)
    return 100 * flops / counts.BF16_FLOPS_PER_S / (t / ctx.trace["steps"])
