"""The bytes of a step's max pools, counted from the cell's shapes, never
from the program's calls: the reference model's forward on the meta
device (no memory, no time), each max pool's input and output element
counted where ATen computes it, whatever implements it in the program."""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .counts import _key
from .reference.layers import Numerics
from .reference.tsv4 import TSV4

POOL_OPS = (torch.ops.aten.max_pool3d_with_indices,
            torch.ops.aten.max_pool3d)
ELEMENT_BYTES = 2  # bfloat16 maps under the configurations' autocast


class _PoolElements(TorchDispatchMode):
    """Adds up the input and output elements of every max pool."""

    def __init__(self):
        super().__init__()
        self.elements = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in POOL_OPS:
            y = out[0] if isinstance(out, (tuple, list)) else out
            self.elements += args[0].numel() + y.numel()
        return out


@functools.lru_cache(maxsize=None)
def _forward_elements(cfg_items: tuple, batch: int) -> int:
    cfg = dict(cfg_items)
    T, d, s = cfg["seq_len"], cfg["img_dim"], cfg["n_series"]
    with torch.device("meta"):
        model = TSV4(cfg, Numerics())
        block = torch.empty(batch, cfg["views"], T, d, d, 3)
        perm = torch.arange(s).expand(batch, s).contiguous()
    mode = _PoolElements()
    with torch.no_grad(), mode:
        model(block, perm)
    return mode.elements


def pool_bytes(cfg: dict, batch: int) -> int:
    """One train step's max-pool bytes at ``batch`` samples (both backbone
    passes): in the forward each pool reads its input and writes its
    output once; in the backward it reads the output's gradient and writes
    the input's once; 2 bytes an element."""
    return 2 * ELEMENT_BYTES * _forward_elements(_key(cfg), batch)
