"""The max pools' share of their roofline: the bytes the step's pools need
(``pools.pool_bytes``: each pool's input read once and output written
once, forward and backward, 2 bytes an element, from the cell's shapes) at
the card's HBM bandwidth, over the device time inside the pools' spans
(``backbone.pool_ms``'s)."""

from benchmark import counts, pools

HOOKS = {"pool": {"MaxPool3d"}}


def read(ctx):
    t = ctx.trace["group_s"].get("pool", 0.0)
    if not t or not ctx.trace["steps"]:
        return None
    need = pools.pool_bytes(ctx.config, ctx.batch)
    return 100 * need / counts.HBM_BYTES_PER_S / (t / ctx.trace["steps"])
