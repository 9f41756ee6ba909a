"""A short run of each cell on the card (skips without one)."""

import json
import os
import subprocess
import sys

import pytest
from conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["kd_40k", "kd_10k"])
def test_cell_runs_correct_on_the_card(card, workload):
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                        "--workload", workload, "--seed", "2147483777", "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
