"""BENCHMARK.json against the contract's forms, and the files it names."""

import copy
import json
import os

import pytest
from conftest import BENCH_DIR, ROOT

from harness import spec


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_are_allowed():
    assert spec.check_names(bench()) == []


@pytest.mark.parametrize("section,key,value", [
    ("workloads", "name", "kd 10k"), ("workloads", "name", "kd,10k"),
    ("workloads", "name", "kd/10k"), ("workloads", "name", ".kd"),
    ("workloads", "name", "k" * 65), ("workloads", "name", "kd_10µ"),
    ("workloads", "traffic", "bones 10k"), ("workloads", "config", ""),
    ("configs", "name", "note book"), ("end_to_end", "name", "pairs per s"),
    ("per_layer", "name", "stage ms"), ("end_to_end", "unit", "pairs per second"),
    ("per_layer", "unit", "µs"), ("per_layer", "unit", "x" * 17),
    ("end_to_end", "unit", ""),
])
def test_bad_names_and_units_are_rejected(section, key, value):
    b = copy.deepcopy(bench())
    b[section][0][key] = value
    assert spec.check_names(b) != []


def test_bad_reduced_key_is_rejected():
    b = copy.deepcopy(bench())
    b["configs"][0]["reduced"] = ["num layers"]
    assert spec.check_names(b) != []


def test_every_named_file_exists():
    b = bench()
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        cell = spec.Cell(b, w["name"])
        assert set(cell.limits) == {"icp", "eig_val", "eig_vec", "sort", "cpd", "corr",
                                    "smooth", "final"}
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "pairs_per_s"}
        assert cell.per_layer
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"))
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for s in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[s]]
    assert len(names) == len(set(names))
    assert all(w["chips"] in (1, 4) for w in b["workloads"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    assert len(json.dumps(b)) < 64 * 1024
