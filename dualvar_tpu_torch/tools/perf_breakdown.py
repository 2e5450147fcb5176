"""Where the R3D-18 SimCLR step's time goes, the coarse cut: the
augmentation alone, the augmentation and the forward, the full step at
B=128, and the full step at B=256 where it fits. Counterpart of the JAX
package's ``scripts/perf_breakdown.py``; ``tools/step_breakdown.py`` has the
fine cut and the segments' definitions (``aug_fwd`` is its forward fed by a
fresh augmentation each call).

Each segment builds its own model and batch, runs 3 warm-up steps (the first
under ``tools/timing.py:step_flops``), then ``--chains`` chains of ``--steps``
steps (the JAX script's one chain of 10 by default). B=256 is searched like
every bench's batch: out of device memory, its record says so
(``did_not_fit``); any other failure ends the run with a non-zero exit.
The records go to ``--out`` (default ``build/bench/perf_breakdown.json``)
and, as a list, to the last line of standard output.

Usage (on the card, from the repo root)::

    python3 -m dualvar_tpu_torch.tools.perf_breakdown [segment ...]
        [--steps 10] [--chains 1] [--out PATH] [--device cuda] [--smoke]
"""

from __future__ import annotations

import sys

from .step_breakdown import BATCH, main_of


def plan() -> list[tuple[str, str, tuple[int, ...]]]:
    return [("aug", "aug", (BATCH,)), ("aug_fwd", "aug_fwd", (BATCH,)),
            ("step", "step", (BATCH,)),
            ("step_b256", "step", (2 * BATCH,))]


def main(argv: list[str] | None = None) -> int:
    return main_of(__doc__, plan(), 10, "perf_breakdown.json", argv)


if __name__ == "__main__":
    sys.exit(main())
