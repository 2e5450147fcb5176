"""The whole step's share of the bf16 peak of the chips it runs on: one
step's FLOPs on the global batch, counted from the cell's shapes
(``counts.step_flops``: both backbone passes, heads and losses, forward
and backward), over the window's mean step time and the chips' peak."""

from benchmark import counts


def read(ctx):
    w = ctx.window
    if not w["steps"]:
        return None
    per_step = w["seconds"] / w["steps"]
    flops = counts.step_flops(ctx.config, ctx.batch * ctx.processes)
    peak = counts.BF16_FLOPS_PER_S * ctx.processes
    return 100 * flops / peak / per_step
