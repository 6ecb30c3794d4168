"""On a card: every cell of BENCHMARK.json runs as the check runs it (a
short window, both trace settings) and prints a correct result line.
Skips without a card; run on the card with
``python -m pytest portbench/tests -m card``."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.HERE)


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest(ROOT)["workloads"]])
def test_cell_runs_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(2**32 + 101), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["metrics"]
    if trace:
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
