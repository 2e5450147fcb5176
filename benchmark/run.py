#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last line
of standard output (see README.md):

    python3 benchmark/run.py --workload k400_simclr_r21d.b32 --seed 7 \\
        --seconds 40 --trace 0

Needs as many CUDA devices as the cell asks for; exits non-zero with no
result otherwise, and when the check finds a module of JAX or of the JAX
package loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "--id=0"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    import torch

    from benchmark import cell as cell_mod
    from benchmark import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", file=sys.stderr, flush=True)
    result = cell_mod.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START, "cuda", cell)
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    for k, row in checks.items():
        print(f"check {k}: {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
