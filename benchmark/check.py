"""How ``correct`` is decided: the program's first training steps against
the plain float32 reference's, by numbers each held to its limit. A
cell's limits file (``limits/<cell>.json``) names the numbers it compares.

* ``block``: the augmented block of step 1, the largest gap of an element
  over the reference block's largest magnitude;
* ``loss``: each loss term at each step, the largest gap over the
  reference's value; ``loss1`` the same at step 1 alone;
* ``grad1``: each leaf's gradient at step 1 as the optimizer receives it,
  the gap between the two norms over the larger of the reference leaf's
  norm and the median leaf's, for the worst leaf; ``grad1_median`` that
  gap for the median leaf;
* ``change``: each leaf's change over the steps (parameters and batch-norm
  running statistics), measured alike, for the worst leaf;
  ``change_median`` for the median leaf.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of ``grad1`` and ``change`` by that rule (none is by
name): their moves are round-off. A number that is not finite reads inf.
"""

from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("block", "loss", "loss1", "grad1", "grad1_median", "change",
           "change_median")
TINY_GRAD = 1e-3  # of the median leaf's reference gradient


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _leaf_gaps(prog: dict, ref: dict, keys) -> list[float]:
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    return [_finite(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median))
            for k in keys]


def _loss_gap(prog_losses: list, ref_losses: list) -> float:
    if len(prog_losses) != len(ref_losses):
        return math.inf
    gap = 0.0
    for lp, lr in zip(prog_losses, ref_losses):
        for k, v in lr.items():
            gap = max(gap, _finite(abs(lp[k] - v) / max(abs(v), 1e-12)))
    return gap


def numbers(prog: dict, ref: dict) -> dict[str, float]:
    """The four numbers of a run's readings against the reference's
    (``reference/train.py:readings``)."""
    bp, br = prog["block"].float(), ref["block"].float()
    block = (_finite(float((bp - br).abs().max() / br.abs().max()))
             if bp.shape == br.shape else math.inf)
    median = statistics.median(ref["grad1"].values())
    kept = [k for k, v in ref["grad1"].items() if v >= TINY_GRAD * median]
    buffers = [k for k in ref["change"] if k not in ref["grad1"]]
    grad1 = _leaf_gaps(prog["grad1"], ref["grad1"], kept)
    change = _leaf_gaps(prog["change"], ref["change"], kept + buffers)
    return {"block": block,
            "loss": _loss_gap(prog["losses"], ref["losses"]),
            "loss1": _loss_gap(prog["losses"][:1], ref["losses"][:1]),
            "grad1": max(grad1), "grad1_median": statistics.median(grad1),
            "change": max(change),
            "change_median": statistics.median(change)}


def worst_leaves(prog: dict, ref: dict, what: str, n: int = 4) -> list:
    """The ``n`` leaves of ``what`` ('grad1' or 'change') with the largest
    gaps, as (gap, leaf, program's norm, reference's norm)."""
    median = statistics.median(ref[what].values())
    gaps = [(abs(prog[what].get(k, 0.0) - v) / max(v, median), k,
             prog[what].get(k, 0.0), v) for k, v in ref[what].items()]
    return sorted(gaps, reverse=True)[:n]


def judge(nums: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(every number the limits name within its limit, {name: {"value",
    "limit"}})."""
    rows = {k: {"value": nums[k], "limit": limits[k]["limit"]}
            for k in limits}
    return all(r["value"] <= r["limit"] for r in rows.values()), rows


def norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    """Each tensor's norm, read in one transfer."""
    keys = list(tensors)
    if not keys:
        return {}
    vals = torch.stack([tensors[k].detach().float().norm() for k in keys])
    return dict(zip(keys, vals.tolist()))
