"""The reference's first training steps and the readings the check
compares: the augmented block of step 1, each step's losses, each leaf's
gradient norm at step 1 (as the optimizer receives it) and each leaf's
change after the steps (parameters and batch-norm running statistics).

Imports nothing of the program: it is given the initial state, the uint8
batches and a generator seeded as the run's, and works the rest out again.
"""

from __future__ import annotations

import torch

from . import aug
from .layers import Numerics
from .tsv4 import SGD, TSV4


def build(cfg: dict, state: dict, device, numerics: str = "float32") -> TSV4:
    with torch.device("meta"):
        model = TSV4(cfg, Numerics(numerics))
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model.train()


def readings(cfg: dict, state: dict, batches, generators,
             numerics: str = "float32",
             plane_dtype: torch.dtype = torch.float32) -> dict:
    """Train ``len(batches)`` steps from ``state``. A step's batch is the
    processes' uint8 shards (one process: one shard), each augmented with
    the draws of its process's generator as the program's step draws them
    there; the step runs on the global batch, their concatenation. The
    block read is process 0's."""
    device = batches[0][0].device
    model = build(cfg, state, device, numerics)
    params = dict(model.named_parameters())
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = SGD(params.values(), cfg["lr"], cfg["momentum"], cfg["wd"])
    out = {"losses": [], "grad1": {}, "change": {}}
    T, d = cfg["seq_len"], cfg["img_dim"]
    for step, shards in enumerate(batches):
        blocks, perms = [], []
        for frames, g in zip(shards, generators):
            B, VT, H0, W0, _ = frames.shape
            with torch.no_grad():
                drawn = aug.draw_clip_params(g, B, VT // T, H0, W0, d)
                blocks.append(aug.augment(frames, drawn, T, d, plane_dtype))
            perms.append(aug.segment_perms(g, B, cfg["n_series"]))
        block, perm = torch.cat(blocks), torch.cat(perms)
        losses = model(block, perm)
        total = sum(losses.values())
        losses = {k: v.detach() for k, v in losses.items()}
        for p in params.values():
            p.grad = None
        total.backward()
        if step == 0:
            out["block"] = blocks[0].cpu()
            out["grad1"] = {k: float(p.grad.norm()) for k, p in params.items()}
        out["losses"].append({k: v.item() for k, v in losses.items()})
        opt.step()
        del block, blocks, losses, total
    with torch.no_grad():
        out["change"] = {k: float((v - start[k]).norm())
                         for k, v in model.state_dict().items()}
    return out
