"""Shared pieces of the benchmark's own tests (``pytest benchmark/tests``):
the benchmark's directory on the import path, and a small test cell."""

import json
import os
import sys
import types

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def load(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


def small_cell(config: str = "notebook_kd"):
    """A cell of the benchmark's harness at 2562 vertices, for the CPU; the
    configuration from ``configs/``, or else from the fixtures."""
    path = os.path.join(BENCH_DIR, "configs", f"{config}.json")
    if not os.path.isfile(path):
        path = os.path.join(FIXTURES, f"{config}.json")
    with open(path) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return types.SimpleNamespace(
        name=f"test_{config}", config=cfg, traffic=load("tiny_2k.json"),
        limits=load("limits_tiny_2k.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if "workloads" not in m],
        per_layer=[])


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
