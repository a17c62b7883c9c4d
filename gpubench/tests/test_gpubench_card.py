"""On the card: each one-card cell runs a short window from the command line
and comes out correct, untraced and traced."""

import json
import subprocess
import sys

import pytest

from gpubench import common

CELLS = [w["name"] for w in common.benchmark()["workloads"] if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
                          "2147483999", "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=common.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
