"""Time another ``soft_dtw.cu``'s kernels beside this tree's on one GPU.

Run from the repo root (it reuses ``chip_smoke.py``'s shapes, inputs and
timing) on a machine with a CUDA card:

    python3 -m dualvar_tpu_torch.tools.soft_dtw_against OTHER.cu
    python3 -m dualvar_tpu_torch.tools.soft_dtw_against --without-bucket \\
        OLD.cu

``OTHER.cu`` is built with the soft-DTW kernel's nvcc flags
(``ops/build.py:load_library("soft_dtw", source)``): a variant of this
tree's source, or an earlier commit's (``git show
<commit>:dualvar_tpu_torch/csrc/soft_dtw.cu``; ``--without-bucket`` when its
entry points take no column bucket, as before the buckets). At every
``chip_smoke.DTW_TIMED`` shape the two are timed on the same copies of the
inputs, out of L2 (``chip_smoke.time_cuda_graph_cold``), in turns: other,
this, this, other. The other's R and dD are compared with this tree's and
the difference printed, not checked: a variant that leaves out part of the
work, to time the rest, gives another result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("source", help="the other soft_dtw.cu")
    parser.add_argument("--without-bucket", action="store_true",
                        help="its entry points take no column bucket")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("soft_dtw_against: needs a CUDA device")
    import chip_smoke as cs

    from ..ops import build
    from ..ops import soft_dtw as mod

    print(f"device: {cs.device_line()}", flush=True)
    source = os.path.abspath(args.source)
    other = build.load_library("soft_dtw", source)
    with open(build.ptxas_log_path("soft_dtw", source)) as fh:
        print("other soft_dtw ptxas: " + " | ".join(
            line.strip() for line in fh
            if "registers" in line or "stack" in line), flush=True)
    bucket = [] if args.without_bucket else [ctypes.c_int]
    for fn, n_ptr in ((other.soft_dtw_fwd_launch, 3),
                      (other.soft_dtw_bwd_launch, 4)):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 2 + bucket + [ctypes.c_void_p])

    def launcher(fn, copies):
        def launch(c):
            P, N, M = copies[c][0].shape
            extra = [] if args.without_bucket else [mod._column_bucket(M)]
            err = fn(*(t.data_ptr() for t in copies[c]), P, N, M, 0.1, 0.0,
                     *extra, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the other kernel failed: CUDA error {err}")
        return launch

    def gap(a, b):
        same = (a == b) | (a.isnan() & b.isnan())
        return float((a - b).abs().masked_fill(same, 0.0).nan_to_num(
            math.inf).max())

    for label, (P, N, M) in cs.DTW_TIMED:
        D, g = cs.dtw_inputs(torch, P, N, M, 7, "cuda")
        _, R = mod.soft_dtw_forward(D, 0.1, 0.0)
        for name, backward in (("soft_dtw_fwd", False),
                               ("soft_dtw_bwd", True)):
            n = cs.cold_copies(torch, cs.dtw_bytes(P, N, M, backward))
            copies = cs.dtw_copies(torch, D, R, g, backward, n)
            fn = other.soft_dtw_bwd_launch if backward \
                else other.soft_dtw_fwd_launch
            theirs = launcher(fn, copies)
            ours = cs.dtw_launcher(mod, copies, backward)
            t = [cs.time_cuda_graph_cold(torch, f, n)
                 for f in (theirs, ours, ours, theirs)]
            out = 3 if backward else 1  # dD, or R
            theirs(0)
            got = copies[0][out].clone()
            ours(0)
            torch.cuda.synchronize()
            row = {"shape": [P, N, M], "other_ms": [t[0], t[3]],
                   "this_ms": [t[1], t[2]],
                   "bound_ms": cs.dtw_bound_ms(P, N, M, backward)[0],
                   "copies": n,
                   "max_abs_diff": gap(got, copies[0][out])}
            print(f"soft_dtw against {args.source}: {name}, {label}: "
                  + json.dumps(row), flush=True)
            del copies, got
        del D, g, R
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
