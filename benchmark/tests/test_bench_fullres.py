"""The pieces of the full-resolution cell (``fullres_10k``, configuration
``fullres_kd``): the E-step's roofline against its hand count, the readers
``estep_roofline`` and ``gram_ms`` on hand-made records and traces, and a
sound run of the configuration on the CPU at 2562 vertices (n_reg = N),
with the route thresholds lowered so that it takes the routes a
10242-vertex pair takes: the Gram in row tiles, the streamed E-step (its
plain version) and the tiled warp."""

import collections
import os
import sys
import time

import pytest
import torch
from conftest import BENCH_DIR, small_cell

import run
from harness import trace as T
from pyfocusr_tpu_torch.utils import spans
from roofline import estep, peaks

METRICS = os.path.join(BENCH_DIR, "metrics")
P = peaks()


def reader(name):
    return T.load_reader(METRICS, name)


# -- the roofline ------------------------------------------------------------


def test_estep_floors_at_10242_squared_d3_are_the_docstring_count():
    f = estep.floors_s(10242, 10242, 3)
    pairs = 10242 * 10242
    # two exponentials a pair over 16 x 132 x 1.98e9 a second: 50.17 us
    assert estep.SFU_EXP_PER_S == pytest.approx(4.18176e12)
    assert f["exp"] == pytest.approx(pairs * 2 / 4.18176e12)
    assert f["exp"] == pytest.approx(50.17e-6, rel=1e-3)
    # one exponential plus P written and read once is longer: 275.6 us
    one_exp = pairs / 4.18176e12 + 8 * pairs / P["hbm_bytes_per_s"]
    assert one_exp == pytest.approx(275.6e-6, rel=1e-3) and one_exp > f["exp"]
    # 5 D + 3 = 18 instructions a pair over 3.345408e13 a second: 56.44 us
    assert estep.instructions_per_pair(3) == 18
    assert f["instructions"] == pytest.approx(pairs * 18 / 3.345408e13)
    assert f["instructions"] == pytest.approx(56.44e-6, rel=1e-3)
    # X and TY read, Pt1, P1 and PX written, f32: 450 648 bytes
    assert f["bytes"] == pytest.approx(450_648 / 3.35e12)
    assert estep.bound_s(10242, 10242, 3, 1) == pytest.approx(f["instructions"])
    assert estep.bound_s(10242, 10242, 3, 300) == pytest.approx(300 * f["instructions"])


def test_estep_floors_at_one_dimension_are_exponential_bound():
    # D = 1: 8 instructions a pair, under the two exponentials' time
    f = estep.floors_s(5000, 5000, 1)
    assert estep.instructions_per_pair(1) == 8
    assert f["exp"] > f["instructions"]
    assert estep.bound_s(5000, 5000, 1, 2) == pytest.approx(2 * f["exp"])


# -- the readers -------------------------------------------------------------


def record(em, gram_ms, streamed=1, gram_tiles=24, rows=10242, d=3):
    """A call's record: CPD at rows x rows in d dimensions, ``em`` EM
    iterations, the ``cpd/gram`` span ``gram_ms`` long."""
    rec = spans.CallRecord(1)
    rec.completed = True
    rec.counters = {"inputs": {"target_rows": rows, "source_rows": rows},
                    "icp": {"icp_iterations": 40},
                    "cpd": {"cpd_rows": rows, "cpd_cols": rows, "cpd_dims": d,
                            "estep_streamed": streamed, "em_iterations": em}}
    if gram_tiles:
        rec.counters["cpd"]["gram_tiles"] = gram_tiles
    rec.spans.append(("cpd/gram", "register_pair/cpd", 0, int(gram_ms * 1e6)))
    return rec


def kernel(name, dur_us, ts=0.0):
    return {"name": name, "kind": "cuda", "ts": ts, "dur": dur_us, "device_us": 0.0}


def traced(monkeypatch, recs, events, rows=10242):
    monkeypatch.setattr(spans, "RECORDS", collections.deque(recs, maxlen=32))
    return {"events": events, "pairs": len(recs), "window_s": 1.0, "busy_s": 0.5,
            "calls": [{"icp_iterations": 40, "n_target": rows, "n_source": rows}
                      for _ in recs]}


def test_estep_roofline_counts_the_iterations_that_worked(monkeypatch):
    # Two pairs of 80 and 100 iterations; each E-step's kernels took 0.1 ms,
    # and 4 masked replays after each stop 1 us each: no work, no bound.
    den = "void estep_den_kernel<4, 4>(Args, float, float*, float*)"
    row = "void estep_row_kernel<4, 4>(Args, float*, float*)"
    events = [kernel(den, 40.0), kernel(row, 60.0)] * 180 + [kernel(den, 0.5),
                                                            kernel(row, 0.5)] * 8
    events.append(kernel("void (anonymous namespace)::knn_kernel<1, 3, 4>(...)", 500.0))
    t = traced(monkeypatch, [record(80, 30.0), record(100, 34.0)], events)
    want = 100.0 * estep.bound_s(10242, 10242, 3, 180) / ((180 * 100.0 + 8) / 1e6)
    assert reader("estep_roofline")(t) == pytest.approx(want)
    assert 0 < want < 100


def test_estep_roofline_none_where_no_call_streamed(monkeypatch):
    events = [kernel("void estep_den_kernel<4, 4>(...)", 40.0)]
    dense = [record(80, 3.0, streamed=0, gram_tiles=0, rows=1000)]
    assert reader("estep_roofline")(traced(monkeypatch, dense, events, rows=1000)) is None
    # streamed calls, but no E-step kernel in the trace
    t = traced(monkeypatch, [record(80, 30.0)], [kernel("void knn_kernel<1>(...)", 5.0)])
    assert reader("estep_roofline")(t) is None


def test_gram_ms_over_the_tiled_pairs(monkeypatch):
    t = traced(monkeypatch, [record(80, 30.0), record(100, 34.0)], [])
    assert reader("gram_ms")(t) == pytest.approx(32.0)
    mixed = traced(monkeypatch, [record(80, 30.0), record(90, 3.0, gram_tiles=0)], [])
    assert reader("gram_ms")(mixed) == pytest.approx(30.0)
    none = traced(monkeypatch, [record(90, 3.0, gram_tiles=0)], [])
    assert reader("gram_ms")(none) is None


@pytest.mark.parametrize("name", ["estep_roofline", "gram_ms"])
def test_new_readers_find_nothing_in_a_program_without_the_counters(monkeypatch, name):
    # The program before the counters: records with no CPD shape or tiles.
    old = record(80, 30.0)
    old.counters["cpd"] = {"em_iterations": 80}
    events = [kernel("void estep_den_kernel<4, 4>(...)", 40.0)]
    assert reader(name)(traced(monkeypatch, [old], events)) is None
    # and a program without the records
    t = traced(monkeypatch, [record(80, 30.0)], events)
    monkeypatch.setitem(sys.modules, "pyfocusr_tpu_torch.utils.spans", None)
    assert reader(name)(t) is None


# -- a sound run on the CPU ----------------------------------------------------


def test_fullres_sound_run_is_correct(monkeypatch):
    """``fullres_kd`` (every vertex in CPD, alpha 0.1) on the 2562-vertex
    test traffic, judged by ``fixtures/limits_tiny_2k.json``: correct, with
    the full-resolution routes in the call record."""
    from pyfocusr_tpu_torch.ops import cpd as TC

    # 2562 points: Gram tiled above 2048, E-step streamed above 2000^2
    # pairs, warp tiled above 4M entries.
    monkeypatch.setattr(TC, "_DENSE_GRAM_MAX_M", 2048)
    monkeypatch.setattr(TC, "_STREAM_PAIRS", 2000**2)
    monkeypatch.setattr(TC, "_TRANSFORM_MAX_ELEMS", 4 * 10**6)
    torch.set_num_threads(4)
    cell = small_cell("fullres_kd")
    assert cell.config["pipeline_config"]["n_coords_spectral_registration"] >= 2562
    result, checks = run.execute(cell, 2**31 + 17, 0.0, False, "cpu", time.perf_counter())
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    cpd = spans.RECORDS[-1].counters["cpd"]
    assert cpd["cpd_rows"] == cpd["cpd_cols"] == 2562 and cpd["estep_streamed"] == 1
    assert cpd["gram_tiles"] == 8 and cpd["transform_tiles"] == 2
