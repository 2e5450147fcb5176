"""The yardstick's arithmetic: published peaks of the card, and the
operations and bytes of a cell's step counted from its shapes, never from
the program's calls.

FLOPs are counted by ``FlopCounterMode`` over one forward and backward of
the reference model on the meta device (no memory, no time): convolutions,
matrix products and their backward passes at the shapes the step runs, a
multiply-add counted as two. The stem's data gradient is not counted, its
input needing none; nothing is recomputed, so nothing recomputed is
counted. Elementwise work, batch norms, pooling and the augmentation are
not counted, as in every model-FLOP count.
"""

from __future__ import annotations

import functools

import torch

from .reference.layers import Numerics
from .reference.tsv4 import TSV4

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=None)
def _step_flops(cfg_items: tuple, batch: int) -> tuple[int, int]:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dict(cfg_items)
    T, d, s = cfg["seq_len"], cfg["img_dim"], cfg["n_series"]
    with torch.device("meta"):
        model = TSV4(cfg, Numerics())
        block = torch.empty(batch, cfg["views"], T, d, d, 3)
        perm = torch.arange(s).expand(batch, s).contiguous()
    counter = FlopCounterMode(display=False)
    with counter:
        losses = model(block, perm)
        sum(losses.values()).backward()
    total = int(counter.get_total_flops())
    conv = sum(int(v) for op, v in counter.get_flop_counts()["Global"].items()
               if "convolution" in str(op))
    return total, conv


def _key(cfg: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in cfg.items()
                        if isinstance(v, (int, float, str, list))))


def step_flops(cfg: dict, batch: int) -> int:
    """One train step's FLOPs at ``batch`` samples: both backbone passes
    (3B clips and the B shuffled ones), heads and losses, forward and
    backward."""
    return _step_flops(_key(cfg), batch)[0]


def conv_flops(cfg: dict, batch: int) -> int:
    """The convolutions' share of ``step_flops``, forward and backward."""
    return _step_flops(_key(cfg), batch)[1]


def aug_bytes(cfg: dict, batch: int, out_bytes: int) -> int:
    """The fused augmentation's bytes for one step: every byte of the
    cropped uint8 clips read once, every output element (``out_bytes``
    each) written once."""
    elems = batch * cfg["views"] * 3 * cfg["seq_len"] * cfg["img_dim"] ** 2
    return elems * (1 + out_bytes)
