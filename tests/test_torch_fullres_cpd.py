"""Full-resolution CPD in the port: every point of the spectral clouds in
CPD (``n_coords_spectral_registration`` >= N), as the benchmark's
``fullres_kd`` configuration runs it, at a size the CPU takes in seconds.

The route thresholds of ``ops/cpd.py`` are lowered so that ~1200-2562
points take the three routes a 10242-vertex pair takes: the Gram applied in
row tiles (``gaussian_matvec_tiled``, more than one tile), the streamed
E-step (its plain version on the CPU) and the tiled out-of-sample warp.

* The CPD stage (low-rank Gram, EM, warp) against the benchmark's plain
  reference (``benchmark/reference/stages.py``, loaded by path: it imports
  neither JAX nor the port) in float64, from a seeded pair of spectral
  clouds.
* ``register_pair`` at full resolution records CPD's shape, route and
  tiles in the call record (``utils/spans.py``).
* The default 'kd' path (1000 points, dense E-step) records
  ``estep_streamed`` 0, and the counters add no host read.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch.ops import cpd as TC
from pyfocusr_tpu_torch.utils import spans

STAGES_PY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmark", "reference", "stages.py")
# The counters this file checks; a run without them is a run of the
# program as it was before they were added.
NEW_COUNTERS = ("cpd_rows", "cpd_cols", "cpd_dims", "estep_streamed", "gram_tiles",
                "transform_tiles")
# The benchmark configuration's CPD settings (benchmark/configs/fullres_kd.json).
ALPHA, BETA, N_EIG, MAX_IT, TOL = 0.1, 50.0, 100, 300, 1e-8
# The upstream notebook's 'kd' settings at the synthetic pair's size, as
# tests/test_torch_spans.py runs them.
KD = dict(icp_register_first=True, icp_registration_mode="rigid", icp_iterations=100,
          icp_n_landmarks=2000, initial_correspondence_type="kd",
          final_correspondence_type="kd", n_spectral_features=3, n_extra_spectral=3,
          n_coords_spectral_ordering=10000, n_coords_spectral_registration=1000,
          get_weighted_spectral_coords=False, non_rigid_alpha=0.01, non_rigid_beta=BETA,
          non_rigid_max_iterations=MAX_IT, non_rigid_tolerance=TOL,
          graph_smoothing_iterations=600, projection_smooth_iterations=1,
          smoothing_method="chebyshev", eig_method="chebyshev", eig_warm_start=True)
# Full resolution, CPD capped at 10 EM iterations: the counters, not the
# fit, are under test there.
FULLRES = dict(KD, n_coords_spectral_registration=10242, non_rigid_alpha=ALPHA,
               non_rigid_max_iterations=10)
# The port's CPD stage against the float64 reference, max |warp gap| over
# the moved points (the spectral coordinates span [-0.5, 0.5]).  It holds:
# the port runs in float32 with distances as direct differences, and reads
# 7.2e-5 to 9.4e-5 on four seeds at 1000-1500 points (the same iteration
# count on both sides).  The control (stages.Arith("ctl"): float32 with
# every matrix product's operands rounded to TF32, 10 mantissa bits) reads
# 0.10-0.11 on the same seeds: its distance identity |y|^2 + |x|^2 - 2 x.y
# rounds at ~5e-4 of terms near 1, against sigma2 of a few 1e-3 once the
# clouds align, so its responsibilities and warp move by a tenth.
CPD_TOL = 1e-3


def _stages():
    spec = importlib.util.spec_from_file_location("bench_reference_stages", STAGES_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lower_routes(mp, gram_max_m: int, stream_pairs: int, transform_elems: int,
                  tile: int = 2048):
    """The full-resolution routes at ``tile``-row tiles, from smaller sizes."""
    mp.setattr(TC, "_DENSE_GRAM_MAX_M", gram_max_m)
    mp.setattr(TC, "_STREAM_PAIRS", stream_pairs)
    mp.setattr(TC, "_TRANSFORM_MAX_ELEMS", transform_elems)
    mp.setattr(TC, "_TRANSFORM_TILE", tile)
    mp.setattr(TC, "gaussian_matvec_tiled",
               functools.partial(TC.gaussian_matvec_tiled, tile=tile))


def _spectral_pair(n: int, seed: int):
    """A target spectral cloud (each column min-max scaled to [-0.5, 0.5],
    as the pipeline's) and the source: a smooth warp of it with noise,
    rescaled; the CPD draws as permutations of all rows (n_reg = N)."""
    rng = np.random.default_rng(seed)

    def unit(v):
        return (v - v.min(0)) / (v.max(0) - v.min(0)) - 0.5

    tgt = unit(rng.uniform(-1.0, 1.0, (n, 3)))
    src = unit(tgt + 0.08 * np.sin(3.0 * tgt[:, [1, 2, 0]]) + 0.02 * tgt**2
               + 0.003 * rng.standard_normal((n, 3)))
    X = src[rng.permutation(n)].astype(np.float32)
    Y = tgt[rng.permutation(n)].astype(np.float32)
    omega = rng.standard_normal((n, N_EIG + 16)).astype(np.float32)
    return X, Y, tgt.astype(np.float32), omega


@pytest.mark.parametrize("n,seed", [(1200, 0), (1500, 2)])
def test_cpd_stage_matches_the_float64_reference(monkeypatch, n, seed):
    tile = 512
    _lower_routes(monkeypatch, gram_max_m=tile, stream_pairs=tile * tile,
                  transform_elems=10**6, tile=tile)
    X, Y, points, omega = _spectral_pair(n, seed)
    Xt, Yt, Pt = (torch.from_numpy(a) for a in (X, Y, points))
    with spans.call() as rec:
        rec.stage("cpd")
        with spans.span("cpd/gram"):
            Q, lam = TC.low_rank_gaussian(Yt, BETA, N_EIG, torch.from_numpy(omega))
        route = TC._estep_route(n, n, None)
        _, z, _, it = TC._deformable_cpd_run(Xt, Yt, Q, lam, ALPHA, MAX_IT, TOL,
                                             estep_impl=route)
        moved = TC.lowrank_transform(Pt, Yt, Q, lam, z, BETA)
    tiles = -(-n // tile)
    assert route == "streamed" and 0 < it < MAX_IT
    assert rec.counters["cpd"] == {"gram_tiles": 4 * tiles, "em_iterations": it,
                                   "transform_tiles": tiles}

    st = _stages()

    def warp(ar):
        # The reference's EM run to the port's iteration count.
        Qm, sl, zs, _, _ = st.cpd_em(ar, X, Y, ALPHA, BETA, N_EIG, it, TOL, run_out=True)
        return st.cpd_warp(ar, points, st.cpd_basis(ar, points, Y, Qm, BETA), sl,
                           zs[-1]).double()

    ref = warp(st.Arith("ref", "cpu"))
    gap = float((moved.double() - ref).abs().max())
    ctl_gap = float((warp(st.Arith("ctl", "cpu")) - ref).abs().max())
    assert gap < CPD_TOL < ctl_gap, (gap, ctl_gap)


@pytest.fixture(scope="module")
def bones():
    t, s = (TP.mesh_to_graph_arrays(chip_smoke.synthetic_bone(TP, seed, levels=4),
                                    device="cpu") for seed in (2, 1))
    return t, s


def _register(t, s, settings, drop_new_counters=False):
    """One ``register_pair`` on the CPU, its draws and generator seeded, with
    the grid k-NN off (its first call of a shape class would add reads of
    its own); the call's record."""
    cfg = TP.pipeline.PipelineConfig(**settings)
    draws = TP.pipeline.make_draws(7, cfg, t.n_points, s.n_points)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYFOCUSR_TPU_KNN_GRID", "off")
        if drop_new_counters:
            count = spans.count
            mp.setattr(spans, "count",
                       lambda name, value=1: None if name in NEW_COUNTERS else count(name, value))
        TP.register_pair(t, s, cfg, generator=torch.Generator().manual_seed(7), draws=draws)
    return spans.RECORDS[-1]


def test_fullres_register_pair_records_shape_route_and_tiles(monkeypatch, bones):
    t, s = bones
    n = t.n_points
    assert n == 2562
    # 2562 points: Gram tiled above 2048 (two tiles of 2048), E-step
    # streamed above 2000^2 pairs, warp tiled above 4M entries (two tiles).
    _lower_routes(monkeypatch, gram_max_m=2048, stream_pairs=2000**2, transform_elems=4 * 10**6)
    rec = _register(t, s, FULLRES)
    assert rec.completed
    cpd = rec.counters["cpd"]
    assert cpd["cpd_rows"] == cpd["cpd_cols"] == n and cpd["cpd_dims"] == 3
    assert cpd["estep_streamed"] == 1
    assert cpd["gram_tiles"] == 4 * 2 and cpd["transform_tiles"] == 2
    assert 0 < rec.counter("cpd", "em_iterations") <= FULLRES["non_rigid_max_iterations"]
    assert rec.span_count("cpd/gram") == 1


def test_kd_path_records_dense_route_and_no_new_host_read(bones):
    t, s = bones
    rec = _register(t, s, KD)
    cpd = rec.counters["cpd"]
    assert cpd["estep_streamed"] == 0
    assert cpd["cpd_rows"] == cpd["cpd_cols"] == 1000 and cpd["cpd_dims"] == 3
    assert "gram_tiles" not in cpd and "transform_tiles" not in cpd
    without = _register(t, s, KD, drop_new_counters=True)
    assert not any(name in without.counters.get("cpd", {}) for name in NEW_COUNTERS)
    assert {k: c for k, (c, _) in rec.syncs.items()} == \
        {k: c for k, (c, _) in without.syncs.items()}
    assert rec.host_syncs() == without.host_syncs() > 0
