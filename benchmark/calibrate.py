#!/usr/bin/env python3
"""The readings that the limits of the correctness check are set from, for
one cell at its own sizes, in one process (the benchmark's runs never call
this):

* the program's four numbers (``check.numbers``) on each of ``--seeds``;
* the control's, on the first ``--control`` of them: the reference put in
  the program's place with fp8 products and bfloat16 augmentation planes;
* each fault's of ``faults.py`` named in ``--kinds``, on the same seeds;
* ``program_f32``: the program with the configuration's autocast off and
  TF32 off, a witness of what the program computes without bfloat16.

    python3 benchmark/calibrate.py --workload k400_simclr_r21d.b32 \\
        --seeds 101-112 --control 3 --out build/calibration.jsonl

One JSON line a reading, and a summary (the largest program reading and
the smallest control and fault readings of each number) at the end.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def program_readings(cell, seed, device, fault=None):
    """The program's readings of its first steps, as a run takes them (its
    processes and all), with ``fault`` planted."""
    import time

    from benchmark.cell import collect

    out = collect(cell, seed, 0.0, False, time.time(), device,
                  fault)[0]["readings"]
    _free(device)
    return out


def witness_readings(cell, seed, device):
    """The program in one process with autocast and TF32 off."""
    import dataclasses

    from benchmark.cell import Program

    f32 = dataclasses.replace(cell, config={**cell.config, "dtype": "float32"})
    prog = Program(f32, seed, device, tf32=False)
    out = prog.first_steps(cell.traffic["compared_steps"])
    del prog
    _free(device)
    return out


def reference(cell, seed, device, control=False):
    import torch

    from benchmark.cell import reference_readings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = (reference_readings(cell, seed, device, "fp8", torch.bfloat16)
           if control else reference_readings(cell, seed, device))
    _free(device)
    return out


def calibrate(cell, seeds, n_control, kinds, device, emit):
    from benchmark import check, faults

    refs = {}

    def ref(seed):
        if seed not in refs:
            refs[seed] = reference(cell, seed, device)
        return refs[seed]

    def emit_numbers(kind, seed, readings):
        emit({"kind": kind, "seed": seed, **check.numbers(readings, ref(seed)),
              "worst": {w: check.worst_leaves(readings, ref(seed), w)
                        for w in ("grad1", "change")},
              "losses": [readings["losses"], ref(seed)["losses"]]})

    if "program" in kinds:
        for seed in seeds:
            emit_numbers("program", seed, program_readings(cell, seed, device))
    few = seeds[:n_control]
    if "control" in kinds:
        for seed in few:
            emit_numbers("control", seed,
                         reference(cell, seed, device, control=True))
    for name in faults.NAMES:
        if name in kinds:
            for seed in few:
                emit_numbers(name, seed,
                             program_readings(cell, seed, device, name))
    if "program_f32" in kinds:
        for seed in few:
            emit_numbers("program_f32", seed,
                         witness_readings(cell, seed, device))


def _seeds(text: str) -> list[int]:
    if "-" in text:
        lo, hi = map(int, text.split("-"))
        return list(range(lo, hi + 1))
    return [int(s) for s in text.split(",")]


def main() -> int:
    import torch

    from benchmark import check, faults, spec

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="a-b or a,b,c")
    p.add_argument("--control", type=int, default=3,
                   help="seeds of the control, the faults and program_f32")
    p.add_argument("--kinds", default="program,control,half_batch,unchanged")
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
    summary = {}
    for k in check.NUMBERS:
        summary[k] = {kind: (max if kind == "program" else min)(
            r[k] for r in rows if r["kind"] == kind)
            for kind in ("program", "control", *faults.NAMES, "program_f32")
            if any(r["kind"] == kind for r in rows)}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
