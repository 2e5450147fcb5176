#!/usr/bin/env python3
"""The readings that a cell's limits are set from, where the cell's
reference backbone takes a ``rounding`` (``reference/s3dg_blocked.py``):
the program and the faults as ``calibrate.py`` reads them, and besides
them

* ``rounding``: the autocast-rounding reference (bfloat16 wherever the
  program's autocast leaves a bfloat16 tensor, float32 accumulation),
  what the program would read if bfloat16 rounding were all that parts it
  from the float32 reference;
* ``control``: the precision control below the configuration's bfloat16
  autocast: float8 wherever the rounding reference holds bfloat16 (e4m3
  tensors, e5m2 gradients, ``"rounding": "float8"``), float8 operands in
  every convolution and linear layer, bfloat16 augmentation planes;
* ``rounding_moved``: the rounding reference on its input block moved by
  ``MOVED`` relative (``reference/s3dg_blocked.py``'s ``"moved"``), another
  realisation of the same rounding: how far two realisations part.

Each reading is held against the float32 reference (``check.numbers``).
Where the program and the rounding reference read the same seed, a line
``leaves`` compares their step-1 gradients leaf by leaf (``compare_leaves``),
against how far the moved realisation parts from the rounding reference.

    python3 benchmark/calibrate_rounding.py --workload k400_simclr_s3dg.b192 \\
        --seeds 101-112 --control 3 --out build/calibration.jsonl

One JSON line a reading, and a summary (the largest program reading and
the smallest of every other kind, each number) at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KINDS = ("program", "rounding", "rounding_moved", "control", "half_batch",
         "unchanged")
# relative: about what the program's augmentation leaves its block off the
# reference's (``block`` 4-8e-6 at its largest element)
MOVED = 1e-6


def rounded(cell, rounding="bfloat16", moved=0.0):
    return dataclasses.replace(
        cell, config={**cell.config, "rounding": rounding, "moved": moved})


def reference(cell, seed, device, numerics="float32", planes=None):
    import torch

    from benchmark.calibrate import _free
    from benchmark.cell import reference_readings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = reference_readings(cell, seed, device, numerics,
                             planes or torch.float32)
    _free(device)
    return out


def leaf_gaps(readings, ref, other=None) -> dict[str, float]:
    """Each leaf's step-1 gradient gap between ``readings`` and ``other``
    (by default the float32 reference ``ref``), as ``check.numbers``
    measures it: over the larger of ``ref``'s leaf norm and its median
    leaf's."""
    import statistics

    other = other or ref
    median = statistics.median(ref["grad1"].values())
    return {k: abs(readings["grad1"].get(k, 0.0) - other["grad1"][k])
            / max(v, median) for k, v in ref["grad1"].items()}


def compare_leaves(prog, rnd, ref, moved=None, n=8, big=0.1) -> dict:
    """The program's and the rounding reference's step-1 gradients leaf by
    leaf, each against the float32 reference ``ref``:

    * ``program_worst`` / ``rounding_worst``: each one's ``n`` worst
      leaves, as (leaf, its gap, the other's gap on that leaf);
    * ``past_5x``: how many leaves the program reads more than 5x past the
      rounding reference, and the reverse, where the larger gap is at
      least ``big``: as many each way where the two are alike;
    * ``apart``: the worst and the median leaf of their gap to each other;
    * with ``moved`` (the rounding reference's second realisation),
      ``moved``: the worst and the median leaf of its gap to the first,
      and its gap to ``ref`` on the program's worst leaves.
    """
    import statistics

    gp, gr = leaf_gaps(prog, ref), leaf_gaps(rnd, ref)

    def worst(g, h):
        return [(k, g[k], h[k]) for k in sorted(g, key=g.get,
                                                reverse=True)[:n]]

    def spread(g):
        return [max(g.values()), statistics.median(g.values())]

    big_leaves = [k for k in gp if max(gp[k], gr[k]) >= big]
    out = {"program_worst": worst(gp, gr), "rounding_worst": worst(gr, gp),
           "past_5x": [sum(gp[k] > 5 * gr[k] for k in big_leaves),
                       sum(gr[k] > 5 * gp[k] for k in big_leaves)],
           "apart": spread(leaf_gaps(prog, ref, rnd))}
    if moved is not None:
        gm = leaf_gaps(moved, ref)
        out["moved"] = spread(leaf_gaps(moved, ref, rnd)) + [
            [k, gm[k]] for k, _, _ in out["program_worst"]]
    return out


def calibrate(cell, seeds, n_control, kinds, device, emit):
    import torch

    from benchmark import check
    from benchmark.calibrate import program_readings

    refs, progs = {}, {}

    def ref(seed):
        if seed not in refs:
            refs[seed] = reference(cell, seed, device)
        return refs[seed]

    def emit_numbers(kind, seed, readings):
        emit({"kind": kind, "seed": seed,
              **check.numbers(readings, ref(seed)),
              "worst": {w: check.worst_leaves(readings, ref(seed), w)
                        for w in ("grad1", "change")},
              "losses": [readings["losses"], ref(seed)["losses"]]})

    few = seeds[:n_control]
    if "program" in kinds:
        for seed in seeds:
            progs[seed] = program_readings(cell, seed, device)
            emit_numbers("program", seed, progs[seed])
            if seed not in few:
                del progs[seed]
    for seed in few:
        if "rounding" in kinds:
            rnd = reference(rounded(cell), seed, device)
            emit_numbers("rounding", seed, rnd)
            moved = None
            if "rounding_moved" in kinds:
                moved = reference(rounded(cell, moved=MOVED), seed, device)
                emit_numbers("rounding_moved", seed, moved)
            if seed in progs:
                emit({"kind": "leaves", "seed": seed,
                      **compare_leaves(progs[seed], rnd, ref(seed), moved)})
        if "control" in kinds:
            emit_numbers("control", seed, reference(
                rounded(cell, "float8"), seed, device, "fp8",
                torch.bfloat16))
        for name in ("half_batch", "unchanged"):
            if name in kinds:
                emit_numbers(name, seed,
                             program_readings(cell, seed, device, name))


def main() -> int:
    import torch

    from benchmark import check, spec
    from benchmark.calibrate import _seeds

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="a-b or a,b,c")
    p.add_argument("--control", type=int, default=3,
                   help="seeds of every kind but the program")
    p.add_argument("--kinds", default=",".join(KINDS))
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    rows = []
    fh = open(args.out, "a") if args.out else None

    def emit(row):
        row = {"workload": args.workload, **row}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if fh:
            fh.write(line + "\n")
            fh.flush()

    try:
        calibrate(cell, _seeds(args.seeds), args.control,
                  args.kinds.split(","), torch.device("cuda"), emit)
    finally:
        if fh:
            fh.close()
    summary = {k: {kind: (max if kind == "program" else min)(
        r[k] for r in rows if r["kind"] == kind)
        for kind in KINDS if any(r["kind"] == kind for r in rows)}
        for k in check.NUMBERS}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
