"""On the card only: one short run of the cheapest cell prints a whole
result line and comes out correct."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "k400_simclr_r21d.b8", "--seed", str(2 ** 31 + 77),
                          "--seconds", "5", "--trace", "1"],
                         capture_output=True, text=True, timeout=600,
                         cwd=spec.ROOT, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["busy_s"] > 0
