"""The port's span and counter record (``pyfocusr_tpu_torch/utils/spans.py``)
on one registration of the 2562-vertex synthetic bone pair on the CPU, and
on the API's own cases.

* The record holds ``inputs`` and the seven stages in order, each ending
  where the next begins, with every nested span inside its parent; the
  caller's draws before the call (``register_pair/draws``) are a profiler
  range only.
* Its counters equal what the loops and solves returned: ICP's and EM's
  iterations, the device loops' flag reads, each solve's chunks
  (``eigen.SOLVES``); each host read of the device counts under its stage
  and site, as many times as the path reads.
* Under a CPU ``torch.profiler`` no two top-level ``register_pair/`` ranges
  overlap and no nested span's range starts with ``register_pair/``: the
  benchmark puts each idle gap of the device down to the top-level range
  open at its midpoint.
* On a card (``gpu`` marker, skips here): the record's host reads equal
  the reads ``torch.cuda.set_sync_debug_mode("warn")`` reports for the
  pair.  Runs without this directory's conftest (which loads JAX):
  ``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_spans.py -m gpu``.
"""

import collections
import inspect
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch.ops import assignment as TA
from pyfocusr_tpu_torch.ops import cpd as TC
from pyfocusr_tpu_torch.ops import eigen as TE
from pyfocusr_tpu_torch.ops import icp as TI
from pyfocusr_tpu_torch.utils import spans
from pyfocusr_tpu_torch.utils.logging import StageTimer

STAGES = ["inputs", "icp", "spectra", "eigsort", "cpd", "correspondences", "smoothing",
          "final_knn"]
NESTED = {"spectra/setup": "spectra", "spectra/warm_map": "spectra",
          "spectra/chunk": "spectra", "spectra/filter": "spectra",
          "spectra/svqb_rr": "spectra", "spectra/top_up_gate": "spectra",
          "icp/loop": "icp", "cpd/gram": "cpd", "cpd/em_loop": "cpd",
          "smoothing/chebyshev": "smoothing"}
# The upstream notebook's settings with 'kd' correspondences (the
# benchmark's configuration), at the synthetic pair's size.
KD = dict(icp_register_first=True, icp_registration_mode="rigid", icp_iterations=100,
          icp_n_landmarks=2000, initial_correspondence_type="kd",
          final_correspondence_type="kd", n_spectral_features=3, n_extra_spectral=3,
          n_coords_spectral_ordering=10000, n_coords_spectral_registration=1000,
          get_weighted_spectral_coords=False, non_rigid_alpha=0.01, non_rigid_beta=50.0,
          non_rigid_max_iterations=300, non_rigid_tolerance=1e-8,
          graph_smoothing_iterations=600, projection_smooth_iterations=1,
          smoothing_method="chebyshev", eig_method="chebyshev", eig_warm_start=True)


def _pair(device):
    cfg = TP.pipeline.PipelineConfig(**KD)
    t, s = (TP.mesh_to_graph_arrays(chip_smoke.synthetic_bone(TP, seed, levels=4),
                                    device=device) for seed in (2, 1))
    return cfg, t, s


def _draws(cfg, t, s, seed=7):
    return TP.pipeline.make_draws(seed, cfg, t.n_points, s.n_points)


@pytest.fixture(scope="module")
def traced(monkeypatch_module):
    """One pair under a CPU profiler: the record, the profiler's events,
    and what the EM loops, ICP and the solves returned."""
    from torch.profiler import ProfilerActivity, profile

    cfg, t, s = _pair("cpu")
    em_runs = []
    em_loop = TC._em_loop
    # The brute-force k-NN on every query: the first call of a shape class
    # would race it against the grid, whose reads ``test_grid_reads`` counts.
    monkeypatch_module.setenv("PYFOCUSR_TPU_KNN_GRID", "off")

    def counted(*args, **kwargs):
        em_runs.append(em_loop(*args, **kwargs))
        return em_runs[-1]

    monkeypatch_module.setattr(TC, "_em_loop", counted)
    TE.SOLVES.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        draws = _draws(cfg, t, s)
        TP.register_pair(t, s, cfg, draws=draws)
    rec = spans.RECORDS[-1]
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    return dict(rec=rec, events=events, em_runs=em_runs, cfg=cfg, draws=draws,
                icp=dict(TI.ICP_STATS), em=dict(TC.EM_STATS), solves=list(TE.SOLVES))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_record_holds_the_stages_in_order(traced):
    rec = traced["rec"]
    assert rec.completed and rec is spans.RECORDS[-1]
    top = [sp for sp in rec.spans if sp[1] is None]
    assert [sp[0] for sp in top] == [spans.STAGE_PREFIX + st for st in STAGES]
    for a, b in zip(top, top[1:]):
        assert a[3] == b[2]  # consecutive: each stage ends where the next begins


def test_nested_spans_lie_inside_their_stages(traced):
    rec = traced["rec"]
    named = collections.defaultdict(list)
    for sp in rec.spans:
        named[sp[0]].append(sp)
    assert set(NESTED) <= set(named)
    for name, parent, t0, t1 in rec.spans:
        assert not (parent is not None and name.startswith(spans.STAGE_PREFIX))
        if parent is None:
            continue
        assert any(p0 <= t0 and t1 <= p1 for _, _, p0, p1 in named[parent]), name
    for name, stage in NESTED.items():
        root = name
        while not root.startswith(spans.STAGE_PREFIX):
            root = next(sp[1] for sp in rec.spans if sp[0] == root)
        assert root == spans.STAGE_PREFIX + stage
    assert {sp[1] for sp in named["spectra/filter"] + named["spectra/svqb_rr"]} == {
        "spectra/chunk"}


def test_counters_equal_what_the_loops_returned(traced):
    rec = traced["rec"]
    assert traced["em_runs"] and rec.total("em_iterations") == sum(traced["em_runs"])
    assert rec.counter("cpd", "em_iterations") == traced["em"]["iterations"]
    assert rec.counter("icp", "icp_iterations") == traced["icp"]["iterations"] > 0
    assert rec.syncs[("icp", "flag_read")][0] == traced["icp"]["host_reads"]
    assert rec.syncs[("cpd", "flag_read")][0] == traced["em"]["host_reads"]
    assert traced["em"]["read_ms"] <= rec.syncs[("cpd", "flag_read")][1] / 1e6
    assert rec.counter("inputs", "target_rows") == rec.counter("inputs", "source_rows") == 2562
    assert rec.counter("inputs", "deferred_draws") == sum(
        isinstance(v, TP.pipeline.NormalDraw) for v in traced["draws"].values()) == 2


def test_chunks_equal_the_solves(traced):
    rec = traced["rec"]
    assert [{k: v for k, v in sv.items() if k != "stage"} for sv in rec.solves] == \
        traced["solves"]
    assert [sv["stage"] for sv in rec.solves] == ["spectra", "spectra"]
    assert [sv["warm"] for sv in rec.solves] == [False, True]
    assert rec.span_count("spectra/chunk") == sum(sv["chunks"] for sv in rec.solves)


def test_every_host_read_counts_under_its_stage(traced):
    rec, cfg = traced["rec"], traced["cfg"]
    target, warm = rec.solves
    extra = cfg.eig_wide_chunks - cfg.eig_wide_chunks_warm
    chunks = target["chunks"] + warm["chunks"]
    want = {
        ("inputs", "n_real_vertices"): 1,
        # The index arrays; the float starts are drawn on the device.
        ("inputs", "draws_copy"): sum(isinstance(v, np.ndarray)
                                      for v in traced["draws"].values()),
        ("icp", "scalar_copy"): 1,
        ("icp", "flag_read"): traced["icp"]["host_reads"],
        ("spectra", "eigh"): 2 * chunks,
        ("spectra", "svqb_rank"): chunks,
        ("spectra", "scalar_copy"): 2,
        ("spectra", "top_up_gate"): warm["top_up_chunks"] + (warm["top_up_chunks"] < extra),
        ("eigsort", "perms_copy"): 1,
        ("eigsort", "perms_index"): 1,
        ("cpd", "eigh"): 1,
        ("cpd", "flag_read"): traced["em"]["host_reads"],
        ("smoothing", "coeffs_copy"): 1,
    }
    assert {key: c for key, (c, _) in rec.syncs.items()} == want
    assert all(ns >= 0 for _, ns in rec.syncs.values())
    assert rec.host_syncs() == sum(want.values())
    assert rec.host_syncs("spectra") == 3 * chunks + 2 + want[("spectra", "top_up_gate")]
    assert rec.host_wait_ms() == pytest.approx(sum(ns for _, ns in rec.syncs.values()) / 1e6)


def test_profiler_ranges_keep_the_top_level_consecutive(traced):
    ranges = [e for e in traced["events"] if e[0].startswith(spans.STAGE_PREFIX)]
    top = sorted((e for e in ranges if not e[0].startswith(spans.STAGE_PREFIX + "lap_")),
                 key=lambda e: e[1])
    assert [e[0] for e in top] == ["register_pair/draws"] + [
        sp[0] for sp in traced["rec"].spans if sp[1] is None]
    for a, b in zip(top, top[1:]):
        assert a[2] <= b[1], (a, b)
    names = {e[0] for e in traced["events"]}
    # Each nested span opened its range, but the warm map's, which opens none.
    assert set(NESTED) - names == {"spectra/warm_map"}
    nested = {sp[0] for sp in traced["rec"].spans if sp[1] is not None}
    assert not any(n.startswith(spans.STAGE_PREFIX) for n in nested)


def test_spans_outside_a_call_record_nothing():
    before = len(spans.RECORDS), spans.RECORDS[-1] if spans.RECORDS else None
    with spans.span("spectra/chunk"), spans.host_read("eigh"):
        spans.count("em_iterations", 3)
        spans.solve(10, False, 1, 0)
    assert spans.current() is None
    assert (len(spans.RECORDS), spans.RECORDS[-1] if spans.RECORDS else None) == before


def test_before_call_is_the_next_records_first_span():
    """Outside a call ``before_call`` is a profiler range alone: no record
    takes it, so draws made long before their call (a cohort's) attach to
    no other call.  Inside a call it is a nested span of the record."""
    n = len(spans.RECORDS)
    with spans.before_call("draws"):
        pass
    assert len(spans.RECORDS) == n and spans.current() is None
    with spans.call() as rec:
        rec.stage("inputs")
        with spans.before_call("draws"):  # inside a call: a nested span
            with spans.host_read("draws_copy", 3):
                pass
        spans.count("em_iterations", torch.tensor(4))
        spans.count("em_iterations", 5)
    names = [(sp[0], sp[1]) for sp in rec.spans]
    assert names == [("draws", "register_pair/inputs"), ("register_pair/inputs", None)]
    assert rec.syncs[("inputs", "draws_copy")][0] == 3
    assert rec.counter("inputs", "em_iterations") == 9 and rec.total("em_iterations") == 9
    assert rec.completed and spans.current() is None


def test_a_failed_call_is_kept_incomplete(traced):
    cfg, t, s = _pair("cpu")
    with pytest.raises(ValueError, match="landmark_pairs must be"):
        TP.register_pair(t, s, cfg, draws=_draws(cfg, t, s),
                         landmark_pairs=np.zeros((3, 3), np.int64))
    rec = spans.RECORDS[-1]
    assert not rec.completed and spans.current() is None
    assert [sp[0] for sp in rec.spans if sp[1] is None][-1] == "register_pair/inputs"
    assert rec.call_id > traced["rec"].call_id
    assert spans.RECORDS.maxlen == 32


def test_grid_reads():
    from pyfocusr_tpu_torch.ops import grid_knn

    rng = np.random.default_rng(5)
    ref = torch.from_numpy(rng.random((3000, 3)).astype(np.float32))
    query = torch.from_numpy(rng.random((500, 3)).astype(np.float32))
    with spans.call() as rec:
        rec.stage("correspondences")
        grid_knn.knn_grid(ref, query, 3)
    passes = 1 + (grid_knn.last_stats["pass1_unresolved"] > 0)
    reads = {site: c for (_, site), (c, _) in rec.syncs.items()}
    assert reads["grid_bincount"] == 2 * passes
    # finite mask, sample distances, box, exactness (each pass)
    assert reads["grid_read"] == 4 + passes
    assert reads["grid_copy"] >= 2 + 4 * passes


@pytest.mark.parametrize("budget,hit", [(None, 0), (1, 1)])
def test_lap_counters(budget, hit):
    rng = np.random.default_rng(3)
    cost = torch.from_numpy(rng.random((512, 512)).astype(np.float32))
    with spans.call() as rec:
        rec.stage("correspondences")
        out = TA.sinkhorn_jv_lap(cost, levels=2, iters_per_level=2, max_total_steps=budget)
    assert sorted(out.tolist()) == list(range(512))
    steps = rec.counter("correspondences", "jv_steps")
    free = rec.counter("correspondences", "jv_free_rows")
    assert 0 < free <= 512 and 0 < steps
    assert steps <= (budget if budget is not None else 60 * 512)
    assert rec.counter("correspondences", "jv_budget_hit") == hit
    assert rec.counter("correspondences", "sinkhorn_passes") == 2 * 2 * 2
    assert rec.syncs[("correspondences", "lap_spread")][0] == 1
    names = [sp[0] for sp in rec.spans]
    assert names[:3] == ["lap/warm_start", "lap/bulk_match", "lap/jv"]


def test_stage_timer_times_the_class_api_spans():
    assert list(inspect.signature(StageTimer).parameters) == ["verbose"]
    timer = StageTimer()
    for name in ("a", "b", "a"):
        with timer.span(name):
            pass
    assert [n for n, _ in timer.spans] == ["a", "b", "a"]
    assert set(timer.totals()) == {"a", "b"}


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["auto", "on"])
def test_host_syncs_equal_the_sync_warnings_on_the_card(monkeypatch, grid):
    """Runs on a CUDA card only: the record's host reads of one pair equal
    the synchronizing operations CUDA's sync debug mode reports, with the
    k-NN routed as by default (the brute-force kernel at this size) and
    with the grid taking every query it can."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("PYFOCUSR_TPU_KNN_GRID", grid)
    cfg, t, s = _pair("cuda")
    TP.register_pair(t, s, cfg, draws=_draws(cfg, t, s, seed=8))  # builds and loads
    torch.cuda.synchronize()
    draws = _draws(cfg, t, s)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            TP.register_pair(t, s, cfg, draws=draws)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    rec = spans.RECORDS[-1]
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    where = collections.Counter(f"{w.filename}:{w.lineno}" for w in syncs)
    counted = {f"{st}/{site}": c for (st, site), (c, _) in rec.syncs.items()}
    print("warnings by line:", dict(where), "\nrecord by site:", counted)
    assert rec.completed
    assert rec.host_syncs() == len(syncs)


def _moved(draws, device):
    """``draws`` moved to ``device`` as ``register_pair`` moves them, with
    the record of that move."""
    with spans.call() as rec:
        rec.stage("inputs")
        moved = TP.pipeline._draws_to(draws, device)
    return moved, rec


@pytest.mark.gpu
def test_deferred_draws_become_tensors_on_the_card():
    """Runs on a CUDA card only: at 40962 vertices the float starts are
    drawn on the card, the move copies the five index arrays alone, and a
    seed gives the same values twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = TP.pipeline.PipelineConfig(**KD)
    draws = TP.pipeline.make_draws(19_001_000, cfg, 40962, 40962)
    moved, rec = _moved(draws, "cuda")
    block = moved["eig_block_target"]
    assert block.is_cuda and block.dtype == torch.float32 and tuple(block.shape) == (40962, 128)
    assert moved["cpd_omega"].is_cuda and tuple(moved["cpd_omega"].shape) == (1000, 116)
    assert rec.counter("inputs", "deferred_draws") == 2
    assert rec.syncs[("inputs", "draws_copy")][0] == 5
    again, _ = _moved(TP.pipeline.make_draws(19_001_000, cfg, 40962, 40962), "cuda")
    for k in draws:
        assert torch.equal(moved[k], again[k]), k
    assert abs(float(block.mean())) < 0.01 and abs(float(block.std()) - 1.0) < 0.01
