"""The judgement of `correct`: a sound run passes, the control and each
fault a cell can have fail.

Each case drives the rest of a run (``run.execute``: set-up, the window,
the judgement) on the CPU at 2562 vertices, past the harness's look for a
card, with the limits of ``fixtures/limits_tiny_2k.json``.  The faults are
planted in the program underneath the timed path:

* a step that returns its state unchanged: ICP's update leaves the moved
  source, R and t as they were (only its count and stop flag move);
* half of the batch left out, the mean taken over the rest: the smoothing
  averages each vertex over half of its neighbours;
* an answer altered where it is produced: the final k = 3 query's nearest
  neighbour of one row changed ('kd'), or two rows of the assignment
  swapped ('hungarian', in the configuration of
  ``fixtures/notebook_hungarian.json``).

The exchange between chips does not exist in these one-card cells.
"""

import math
import time

import pytest
import torch
from conftest import small_cell

import run
from harness import drive
from harness import judge as J


def execute(cell):
    torch.set_num_threads(4)
    result, checks = run.execute(cell, 2**31 + 17, 0.0, False, "cpu", time.perf_counter())
    return result, {n: (v, lim) for n, v, lim in checks}


@pytest.fixture(scope="module")
def sound():
    return execute(small_cell())


def test_sound_run_is_correct(sound):
    result, checks = sound
    assert result["correct"], checks
    assert result["attempted"] == 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"setup_s", "pairs_per_s"}


def test_fault_state_unchanged(monkeypatch):
    from pyfocusr_tpu_torch.ops import umeyama_kernel

    def frozen_step(target, idx, src, mask, wn, mu_s, var_s, state, ctrl, threshold,
                    max_iterations, with_scale):
        if bool(ctrl[1] != 0):
            return
        ctrl[0] += 1
        ctrl[1] = int(int(ctrl[0]) >= max_iterations)

    monkeypatch.setattr(umeyama_kernel, "icp_step", frozen_step)
    result, checks = execute(small_cell())
    assert not result["correct"]
    assert checks["icp"][0] > checks["icp"][1]


def test_fault_half_the_neighbours(monkeypatch):
    from pyfocusr_tpu_torch.ops import graph_ops

    real = graph_ops.mean_filter_chebyshev

    def half(neighbors, weights, values, iterations, overflow=None, ov_w=None):
        w = weights.clone()
        w[:, 1::2] = 0.0
        return real(neighbors, w, values, iterations, overflow, ov_w)

    monkeypatch.setattr(graph_ops, "mean_filter_chebyshev", half)
    result, checks = execute(small_cell())
    assert not result["correct"]
    assert checks["smooth"][0] > checks["smooth"][1]


def test_fault_final_answer_altered(monkeypatch):
    from pyfocusr_tpu_torch import pipeline

    real = pipeline.knn3_masked

    def altered(ref, mask, query):
        d, i = real(ref, mask, query)
        i = i.clone()
        i[7, 0] = (i[7, 0] + 1) % ref.shape[0]
        return d, i

    monkeypatch.setattr(pipeline, "knn3_masked", altered)
    result, checks = execute(small_cell())
    assert not result["correct"]
    assert checks["final"][0] > checks["final"][1]


def test_fault_assignment_altered(monkeypatch):
    from pyfocusr_tpu_torch import pipeline

    real = pipeline._hungarian

    def altered(ref_pts, query_pts):
        a = real(ref_pts, query_pts).clone()
        a[[3, 900]] = a[[900, 3]]
        return a

    monkeypatch.setattr(pipeline, "_hungarian", altered)
    result, checks = execute(small_cell("notebook_hungarian"))
    assert not result["correct"]
    assert checks["corr"][0] > checks["corr"][1]


def test_control_fails():
    """The reference in TF32 products, put in the program's place stage by
    stage, comes out as not correct (each number over its limit here)."""
    import pyfocusr_tpu_torch as tp

    torch.set_num_threads(4)
    cell = small_cell()
    entry = drive.load_entry("register_pair").Entry(tp, cell.config["pipeline_config"],
                                                    cell.traffic, "cpu")
    entry.seed(5)
    item = entry.deck[drive.Order(len(entry.deck), 5).next()]
    kept, _ = entry.call(item)
    out = entry.judge_pair(item, kept, control=True)
    ok, ctl = out["program"], out["control"]
    for n in J.NUMBERS:
        assert ok[n] <= cell.limits[n], (n, ok[n])
        assert ctl[n] > cell.limits[n], (n, ctl[n])
        assert not math.isnan(ctl[n])
