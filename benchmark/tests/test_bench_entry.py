"""The command's refusals: no card, and a directory without the program."""

import os
import shutil
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

ARGS = ["--workload", "kd_10k", "--seed", "2147483999", "--seconds", "1", "--trace", "0"]


def run_in(root):
    return subprocess.run([sys.executable, os.path.join(root, "benchmark", "run.py"), *ARGS],
                          cwd=root, capture_output=True, text=True, timeout=300)


def test_no_card_gives_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this refusal needs its absence")
    p = run_in(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    p = run_in(str(tmp_path))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
