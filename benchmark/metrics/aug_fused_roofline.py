"""The fused augmentation kernel's share of its roofline: the bytes the
step's augmentation needs (``counts.aug_bytes``: the cropped uint8 clips
read once, the block written once) at the card's HBM bandwidth, over the
device time of the kernels of that name; on several processes, process
0's batch and kernels."""

import re

from benchmark import counts

KERNEL = re.compile(r"\baug_(bf16_)?band_kernel\b")


def read(ctx):
    t = sum(s for name, s in ctx.trace["by_kernel"].items()
            if KERNEL.search(name))
    if not t or not ctx.trace["steps"]:
        return None
    need = counts.aug_bytes(ctx.config, ctx.batch, ctx.out_bytes)
    return 100 * need / counts.HBM_BYTES_PER_S / (t / ctx.trace["steps"])
