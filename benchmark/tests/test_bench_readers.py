"""Each per-layer reader on a recorded trace (one 'kd' pair of the card's
traced run, ``fixtures/trace_kd_10k.json.gz``) and on a hand-made one."""

import gzip
import json
import os
import shutil

import pytest
from conftest import BENCH_DIR, FIXTURES

from harness import trace as T
from roofline import knn

METRICS = os.path.join(BENCH_DIR, "metrics")


def reader(name):
    return T.load_reader(METRICS, name)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    with gzip.open(os.path.join(FIXTURES, "trace_kd_10k.json.gz"), "rb") as src, \
            open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return T.load(str(path))


def test_recorded_trace_is_one_kd_pair(recorded):
    assert recorded["pairs"] == 1 and recorded["calls"][0]["initial"] == "kd"
    assert any(e["kind"] == "cuda" for e in recorded["events"])
    assert not any(e["kind"] == "cuda" and e["name"].startswith(T.HOST_PREFIX)
                   for e in recorded["events"])


@pytest.mark.parametrize("stage", ["icp", "spectra", "cpd", "smoothing"])
def test_stage_ms(recorded, stage):
    want = sum(e["dur"] for e in recorded["events"]
               if e["kind"] == "cpu" and e["name"] == f"register_pair/{stage}") / 1e3
    got = reader(f"stage_ms.{stage}")(recorded)
    assert want > 0 and got == pytest.approx(want)


def test_spectra_device_ms(recorded):
    (spectra,) = [e for e in recorded["events"] if e["name"] == "register_pair/spectra"]
    got = reader("spectra_device_ms")(recorded)
    assert got == pytest.approx(spectra["device_us"] / 1e3)
    assert 0 < got < spectra["dur"] / 1e3


def test_knn_roofline(recorded):
    call = recorded["calls"][0]
    n = call["n_target"]
    bound = (call["icp_iterations"] * knn.bound_s(2000, n, 3, 1) + 2 * knn.bound_s(n, n, 3, 1)
             + knn.bound_s(10000, 10000, 3, 1) + knn.bound_s(n, n, 3, 3))
    busy = sum(e["dur"] for e in recorded["events"]
               if e["kind"] == "cuda" and "knn_kernel" in e["name"]) / 1e6
    got = reader("knn_roofline")(recorded)
    assert got == pytest.approx(100 * bound / busy)
    assert 0 < got <= 100


def test_device_idle_share(recorded):
    got = reader("device_idle_share")(recorded)
    assert got == pytest.approx(1 - recorded["busy_s"] / recorded["window_s"])
    assert 0 < got < 1


def hand_made():
    ev = [
        {"name": "register_pair/correspondences", "kind": "cpu", "ts": 0.0, "dur": 2000.0,
         "device_us": 0.0},
        {"name": "lse_rows_kernel(float const*)", "kind": "cuda", "ts": 10.0, "dur": 200.0,
         "device_us": 0.0},
        {"name": "lse_cols_partial_kernel(float const*)", "kind": "cuda", "ts": 300.0,
         "dur": 150.0, "device_us": 0.0},
        {"name": "lse_cols_finish_kernel(float const*)", "kind": "cuda", "ts": 450.0,
         "dur": 50.0, "device_us": 0.0},
        {"name": "lse_rows_kernel(float const*)", "kind": "cuda", "ts": 600.0, "dur": 200.0,
         "device_us": 0.0},
        {"name": "void jv_cluster_kernel<4>(float const*)", "kind": "cuda", "ts": 900.0,
         "dur": 1000.0, "device_us": 0.0},
    ]
    calls = [{"icp_iterations": 0, "n_target": 1000, "n_source": 1000, "icp_rows": 1000,
              "eigsort_rows": 1000, "initial": "hungarian"}]
    return {"events": ev, "calls": calls, "pairs": 1, "window_s": 0.002,
            "busy_s": T.busy_seconds(ev)}


def test_busy_and_idle_hand_made():
    t = hand_made()
    assert t["busy_s"] == pytest.approx(1.6e-3)  # 200 + 200 + 200 + 1000 us, none overlapping
    assert reader("device_idle_share")(t) == pytest.approx(0.2)
    gaps = dict(T.breakdown(t["events"])["idle_gaps"])
    assert gaps["register_pair/correspondences"] == pytest.approx(0.4e-3)


def test_readers_find_nothing_without_device_events():
    t = hand_made()
    t["events"] = [e for e in t["events"] if e["kind"] == "cpu"]
    t["busy_s"] = 0.0
    for name in ("knn_roofline", "device_idle_share"):
        assert reader(name)(t) is None


def test_every_benchmark_metric_has_a_reader():
    with open(os.path.join(os.path.dirname(BENCH_DIR), "BENCHMARK.json")) as f:
        for m in json.load(f)["per_layer"]:
            assert callable(reader(m["name"]))
