"""Port parity for the whole slice: ``pyfocusr_tpu_torch.register_pair``
against ``pyfocusr_tpu.pipeline.register_pair`` on the 2562-vertex synthetic
bone pair (``mesh_5k_target`` / ``mesh_5k_source``), plus the port's entry
points and its import isolation.

JAX runs its own ``register_pair`` with ``PRNGKey(0)``; the port is fed the
draws JAX made internally, rebuilt here with ``jax.random`` from the same
key splits (``_jax_draws``).  Both packages get the same graph through
``graph_arrays_from_numpy`` (the JAX graph is built without a patch plan,
so both run the same ELL filter operator).

Gates, and why they are not tighter:
* eigenvalues rtol 1e-4 and eigenvectors |cos| >= 0.9999 (mean-centred
  columns): the spectra are solved from the same blocks;
* final correspondences agree on >= 95% of source vertices, unique fraction
  within 0.02: the nearest-neighbour searches differ on near-ties (JAX on
  the CPU uses the matmul identity, the port direct differences), and the
  eigenvector signs each framework's eigh returns may differ, which moves
  the eigsort cost Q without changing the matching;
* |delta weighted_points|: median <= 1e-3 mm, mean <= 0.1 mm (bone scale
  ~80 mm, edges ~2 mm): where the correspondences agree the final
  locations agree to f32 noise; the few percent of vertices whose
  neighbour changed move by up to an edge length (measured means
  0.006-0.054 mm).

'hungarian' correspondences (``HUNGARIAN``: both correspondence types, one
run) are held to the JAX run like this.  Both packages' Sinkhorn warm start
is shortened to 5 levels x 6 iterations for the run (the default 14 x 30
schedule costs ~2 minutes here in single-threaded torch, and
tests/test_torch_assignment.py runs it once at n = 600); the solve stays
exact, only the augmentation gets longer.  Gates:
* both results are permutations, initial and final;
* the port's solver on the JAX run's own spectral coordinates (the same
  cost) returns JAX's assignment (>= 99.9% equal; measured 100%) and its
  objective within 1e-6 relative, and the port's assignment is scipy's
  optimum of the port's cost within 1e-5 relative;
* across the two runs the costs differ (the CPD fits differ in f32 noise,
  and a global optimum moves in chains where a nearest neighbour moves
  alone): objectives within 2e-3 relative (measured 5.1e-4 initial, 1.2e-3
  final) and assignments equal on >= 90% of source vertices (measured 93.5%
  initial, 92.5% final; the 'kd' runs reach 99% against their 95% gate);
  |delta weighted_points| median <= 1e-3 mm, mean <= 0.2 mm (measured
  2.6e-5 and 0.115).

The runs stop CPD at |delta sigma2| <= 1e-6 instead of the default 1e-8:
at 1e-8 the stop test sits in the f32 noise of sigma2, so the two
frameworks (or one framework with another thread count) can stop at
different iterations (measured under similarity ICP: 69% agreement at
1e-8, 99.5% at 1e-6; rigid: 94-99% at 1e-8 depending on torch's thread
count).  ``get_weighted_spectral_coords`` is held to the
JAX run at the level of registration quality only: its weights
exp(-(Q lam)^2 / 2 sigma^2) amplify the eigsort cost Q, and Q depends on the
eigenvector signs each framework's eigh picks (measured: the weights differ
by up to 6%, correspondences agree on 42%, unique fraction within 0.012).
"""

import dataclasses
import functools
import hashlib
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pyfocusr_tpu import metrics as JMET
from pyfocusr_tpu import pipeline as JP
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
import pyfocusr_tpu_torch as TP

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

FAST = dict(
    icp_iterations=30,
    non_rigid_max_iterations=40,
    graph_smoothing_iterations=50,
    projection_smooth_iterations=1,
    n_coords_spectral_registration=500,
    non_rigid_tolerance=1e-6,
)
BRANCHES = dict(
    FAST,
    icp_registration_mode="similarity",
    icp_reg_target_to_source=True,
    target_eigenmap_as_reference=False,
    compute_mutual_consistency=True,
    smoothing_method="exact",
)
WEIGHTED = dict(FAST, get_weighted_spectral_coords=True)
HUNGARIAN = dict(FAST, initial_correspondence_type="hungarian",
                 final_correspondence_type="hungarian")


def _eig_block(key, n, cfg):
    """The initial block chebyshev_eigpairs_wide draws from ``key``
    (eigen.py:404-405)."""
    return np.asarray(jax.random.normal(
        jax.random.split(key)[1], (n, cfg.eig_wide_block), jnp.float32))


def _jax_draws(key, cfg, tg, sg, n_landmarks=0):
    """The random inputs JAX's register_pair draws from ``key``
    (pipeline.py:1407,1423,1520-1521,1619,1632,1642; eigen.py:404-405;
    cpd.py:237); with landmarks the target subsample has n_reg - L rows.
    The source's block only where its solve is not warm-started; a side
    whose solve is narrow or Lanczos also gets its ``eig_start_<side>``."""
    keys = jax.random.split(key, 8)

    def ri(k, g, m):
        return np.asarray(JP._rand_idxs(k, g.valid_mask, min(m, g.n_points)))

    moving = tg if cfg.icp_reg_target_to_source else sg
    n_reg = min(cfg.n_coords_spectral_registration, tg.n_points, sg.n_points)
    p = min(min(cfg.non_rigid_n_eigens, n_reg) + 16, n_reg)
    draws = {
        "icp_landmarks": ri(keys[7], moving, cfg.icp_n_landmarks),
        "eigsort_target": ri(keys[2], tg, cfg.n_coords_spectral_ordering),
        "eigsort_source": ri(keys[3], sg, cfg.n_coords_spectral_ordering),
        "cpd_source": ri(keys[4], sg, n_reg),
        "cpd_target": ri(keys[5], tg, n_reg - n_landmarks),
        "eig_block_target": _eig_block(keys[0], tg.n_points, cfg),
        "cpd_omega": np.asarray(jax.random.normal(keys[6], (n_reg, p), jnp.float32)),
    }
    if not JP._warm_supported(cfg, tg, sg):
        draws["eig_block_source"] = _eig_block(keys[1], sg.n_points, cfg)
    tcfg = TP.config_from_dict(dataclasses.asdict(cfg))
    for side, key_, g in (("target", keys[0], tg), ("source", keys[1], sg)):
        solver = TP.pipeline._solver(tcfg, g.n_points)
        if solver != "wide":
            draws[f"eig_start_{side}"] = _solve_start(key_, g.n_points, cfg, solver)
    return draws


def _solve_start(key, n, cfg, solver):
    """The start of a narrow solve (its block, eigen.py:583) or of a
    Lanczos one (its power-iteration and start vectors, eigen.py:108,175),
    as the port's [N, w] draw."""
    if solver == "narrow":
        return np.asarray(jax.random.normal(key, (n, cfg.n_total + 8), jnp.float32))
    return np.stack([np.asarray(jax.random.normal(k, (n,), jnp.float32))
                     for k in (key, jax.random.fold_in(key, 1))], axis=1)


def _fields(ga):
    return {k: np.asarray(v) for k, v in dataclasses.asdict(ga).items()
            if k != "patch_plan"}


@pytest.fixture(scope="module")
def jax_pair(mesh_5k_target, mesh_5k_source):
    return (JP.mesh_to_graph_arrays(mesh_5k_target, patch_blocks=False),
            JP.mesh_to_graph_arrays(mesh_5k_source, patch_blocks=False))


def _run_both(jax_pair, kw, landmark_pairs=None):
    tg, sg = jax_pair
    cfg = JP.PipelineConfig(**kw)
    key = jax.random.PRNGKey(0)
    n_lm = 0 if landmark_pairs is None else len(landmark_pairs)
    jax_lm = None if landmark_pairs is None else jnp.asarray(landmark_pairs, jnp.int32)
    want = jax.tree.map(np.asarray, JP.register_pair(tg, sg, cfg, key,
                                                     landmark_pairs=jax_lm))
    got = TP.register_pair(
        TP.graph_arrays_from_numpy(_fields(tg), device="cpu"),
        TP.graph_arrays_from_numpy(_fields(sg), device="cpu"),
        TP.config_from_dict(dataclasses.asdict(cfg)),
        draws=_jax_draws(key, cfg, tg, sg, n_lm),
        landmark_pairs=landmark_pairs,
    )
    return want, got


@pytest.fixture(scope="module")
def default_runs(jax_pair):
    return _run_both(jax_pair, FAST)


@pytest.fixture(scope="module")
def branch_runs(jax_pair):
    return _run_both(jax_pair, BRANCHES)


@pytest.fixture(scope="module")
def weighted_runs(jax_pair):
    return _run_both(jax_pair, WEIGHTED)


@pytest.fixture(scope="module")
def hungarian_runs(jax_pair):
    """Both packages with both correspondence types 'hungarian' and the
    Sinkhorn schedule shortened to 5 x 6 (see the module docstring)."""
    from pyfocusr_tpu.ops import assignment as JA

    short = dict(levels=5, iters_per_level=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "sinkhorn_jv_lap",
                   functools.partial(JA.sinkhorn_jv_lap, **short))
        mp.setattr(TP.pipeline, "sinkhorn_jv_lap",
                   functools.partial(TP.pipeline.sinkhorn_jv_lap, **short))
        return _run_both(jax_pair, HUNGARIAN)


def _check_spectra(want, g):
    for side in ("target", "source"):
        np.testing.assert_allclose(g[f"eig_vals_{side}"], want[f"eig_vals_{side}"],
                                   rtol=1e-4)
    for key_ in ("eig_vecs_target", "eig_vecs_source_sorted"):
        for c in range(want[key_].shape[1]):
            a = want[key_][:, c] - want[key_][:, c].mean()
            b = g[key_][:, c] - g[key_][:, c].mean()
            cos = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
            assert cos >= 0.9999, (key_, c, cos)


def _check_slice(want, got):
    assert set(got) == set(want)
    assert got["correspondences"].dtype == torch.int64
    g = {k: v.numpy() for k, v in got.items()}
    _check_spectra(want, g)
    agree = (g["correspondences"] == want["correspondences"]).mean()
    assert agree >= 0.95, agree
    n = len(want["correspondences"])
    uj = len(np.unique(want["correspondences"])) / n
    ut = len(np.unique(g["correspondences"])) / n
    assert abs(uj - ut) <= 0.02, (uj, ut)
    dw = np.linalg.norm(g["weighted_points"] - want["weighted_points"], axis=1)
    assert np.median(dw) <= 1e-3 and dw.mean() <= 0.1, (np.median(dw), dw.mean())
    assert np.all(np.isfinite(g["weighted_points"]))
    return g


def test_register_pair_matches_jax(default_runs, mesh_5k_target):
    want, got = default_runs
    g = _check_slice(want, got)
    tgt = np.asarray(mesh_5k_target.points, np.float32)
    np.testing.assert_array_equal(g["nearest_points"], tgt[g["correspondences"]])


def test_register_pair_small_branches_match_jax(branch_runs):
    """similarity ICP moving the target, eigsort on the target's maps,
    mutual consistency and exact smoothing."""
    want, got = branch_runs
    _check_slice(want, got)
    mj, mt = want["mutual_consistency"], got["mutual_consistency"].numpy()
    assert abs(mj.mean() - mt.mean()) <= 0.02


def test_weighted_spectral_coords_quality_matches_jax(
        weighted_runs, mesh_5k_target, mesh_5k_source):
    want, got = weighted_runs
    qj = JMET.registration_quality(mesh_5k_target, mesh_5k_source, want)
    qt = TP.registration_quality(mesh_5k_target, mesh_5k_source, got)
    assert abs(qj["unique_fraction"] - qt["unique_fraction"]) <= 0.02
    assert abs(qj["symmetric_surface_dist_mm"]
               - qt["symmetric_surface_dist_mm"]) <= 0.05
    # The weighting the port applied is the JAX formula on the port's own
    # Q and eigenvalues (pipeline.py:1543-1549).
    q, lt, ls = got["Q"][:3], got["eig_vals_target"][:3], got["eig_vals_source"][:3]
    w = q * torch.maximum(lt, ls)
    wspec = torch.exp(-(w**2) / (2.0 * w.mean() ** 2))
    plain = got["eig_vecs_source_sorted"][:, :3]
    torch.testing.assert_close(got["spectral_coords_source"], plain * wspec,
                               rtol=1e-6, atol=1e-7)


def _lap_objective(query, ref, corr):
    """The 'hungarian' objective of an assignment: summed Euclidean
    distances from each query row to its assigned reference row (f64)."""
    q, r = np.asarray(query, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(q - r[corr], axis=1).sum()


# (objective's query coords, its reference coords, the assignment)
_LAPS = {
    "initial": ("spectral_coords_source", "spectral_coords_target",
                "initial_correspondences"),
    "final": ("source_projected_on_target", "smoothed_target_coords",
              "correspondences"),
}


@pytest.mark.parametrize("which", sorted(_LAPS))
def test_hungarian_correspondences_match_jax(hungarian_runs, which):
    want, got = hungarian_runs
    assert set(got) == set(want)
    g = {k: v.numpy() for k, v in got.items()}
    _check_spectra(want, g)
    q, r, c = _LAPS[which]
    n = len(want[c])
    for res in (want, g):
        assert sorted(res[c].tolist()) == list(range(n))  # one-to-one
    obj = [_lap_objective(res[q], res[r], res[c]) for res in (want, g)]
    assert abs(obj[0] - obj[1]) <= 2e-3 * obj[0], obj
    agree = (g[c] == want[c]).mean()
    assert agree >= 0.90, agree
    dw = np.linalg.norm(g["weighted_points"] - want["weighted_points"], axis=1)
    assert np.median(dw) <= 1e-3 and dw.mean() <= 0.2, (np.median(dw), dw.mean())
    assert np.all(np.isfinite(g["weighted_points"]))


@pytest.mark.parametrize("which", sorted(_LAPS))
def test_hungarian_solver_matches_jax_on_the_same_cost(hungarian_runs, which):
    """The port's solver, cold-started, on the Euclidean cost of the JAX
    run's coordinates: the same cost gives the same optimum."""
    from pyfocusr_tpu_torch.ops.knn import pairwise_sq_dists

    want, _ = hungarian_runs
    q, r, c = _LAPS[which]
    cost = torch.sqrt(pairwise_sq_dists(torch.tensor(want[q]), torch.tensor(want[r])))
    got = TP.pipeline.sinkhorn_jv_lap(cost, warm_start=False).numpy()
    assert (got == want[c]).mean() >= 0.999
    obj = _lap_objective(want[q], want[r], got)
    assert obj == pytest.approx(_lap_objective(want[q], want[r], want[c]), rel=1e-6)


def test_hungarian_initial_correspondences_are_optimal(hungarian_runs):
    """The port's assignment is the optimum of its own cost: scipy's
    objective on the same Euclidean cost, within 1e-5 relative."""
    from scipy.optimize import linear_sum_assignment
    from scipy.spatial.distance import cdist

    _, got = hungarian_runs
    src = got["spectral_coords_source"].double().numpy()
    tgt = got["spectral_coords_target"].double().numpy()
    corr = got["initial_correspondences"].numpy()
    C = cdist(src, tgt)
    ri, ci = linear_sum_assignment(C)
    ref = C[ri, ci].sum()
    assert abs(_lap_objective(src, tgt, corr) - ref) <= 1e-5 * ref


def test_hungarian_final_correspondences_index_the_target(hungarian_runs, mesh_5k_target):
    _, got = hungarian_runs
    tgt = np.asarray(mesh_5k_target.points, np.float32)
    np.testing.assert_array_equal(got["nearest_points"].numpy(),
                                  tgt[got["correspondences"].numpy()])


def test_hungarian_rejects_unequal_vertex_counts(torch_pair):
    tg, sg = torch_pair
    shorter = dataclasses.replace(
        sg, points=sg.points[:-2], neighbors=sg.neighbors[:-2] % (sg.n_points - 2),
        nbr_mask=sg.nbr_mask[:-2], valid_mask=sg.valid_mask[:-2],
        null_indicators=sg.null_indicators[:-2],
        node_features=sg.node_features[:-2])
    for kw in (dict(initial_correspondence_type="hungarian"),
               dict(final_correspondence_type="hungarian")):
        with pytest.raises(ValueError, match="must be 'kd' and not 'hungarian'"):
            TP.register_pair(tg, shorter, TP.PipelineConfig(**kw))


def test_registration_quality_matches_jax(default_runs, mesh_5k_target, mesh_5k_source):
    # Same result through both readouts; the JAX one's XLA nearest-neighbour
    # distances carry the matmul identity's ~1e-5 mm error before rounding
    # to 4 decimals, hence abs 2e-4.
    _, got = default_runs
    res_np = {k: v.numpy() for k, v in got.items()}
    want = JMET.registration_quality(mesh_5k_target, mesh_5k_source, res_np)
    have = TP.registration_quality(mesh_5k_target, mesh_5k_source, got)
    assert have.keys() == want.keys()
    for k in want:
        assert have[k] == pytest.approx(want[k], abs=2e-4), k


def test_graph_arrays_and_config_round_trip(jax_pair, mesh_5k_target):
    tg, _ = jax_pair
    t = TP.graph_arrays_from_numpy(_fields(tg), device="cpu")
    for name, arr in _fields(tg).items():
        got = getattr(t, name).numpy()
        np.testing.assert_array_equal(got, arr)
        assert got.dtype == (np.int64 if name in ("neighbors", "overflow")
                             else np.float32)
    built = TP.mesh_to_graph_arrays(
        TP.TriMesh(np.asarray(mesh_5k_target.points),
                   np.asarray(mesh_5k_target.triangles)), device="cpu")
    for name, arr in _fields(tg).items():
        np.testing.assert_array_equal(getattr(built, name).numpy(), arr)
    jcfg = JP.PipelineConfig(**BRANCHES, feature_weights_diag=(1.0, 2.0),
                             initial_correspondence_type="hungarian",
                             final_correspondence_type="hungarian")
    tcfg = TP.config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert TP.PipelineConfig() == TP.config_from_dict(
        dataclasses.asdict(JP.PipelineConfig()))
    with pytest.raises(ValueError, match="unknown"):
        TP.config_from_dict({"not_a_field": 1})


def test_entry_points_build_on_the_card_unless_asked_for_the_cpu(mesh_5k_target):
    """``device=None`` means the CUDA card, and raises when there is none;
    the CPU is taken only when named."""
    mesh = TP.TriMesh(np.asarray(mesh_5k_target.points),
                      np.asarray(mesh_5k_target.triangles))
    pts = np.asarray(mesh_5k_target.points, np.float32)
    on_cpu = TP.mesh_to_graph_arrays(mesh, device="cpu")
    assert on_cpu.device.type == "cpu"
    fields = {name: getattr(on_cpu, name).numpy() for name in TP.pipeline.TENSOR_FIELDS}
    if torch.cuda.is_available():
        assert TP.mesh_to_graph_arrays(mesh).device.type == "cuda"
        assert TP.graph_arrays_from_numpy(fields).device.type == "cuda"
    else:
        for call in (lambda: TP.mesh_to_graph_arrays(mesh),
                     lambda: TP.graph_arrays_from_numpy(fields),
                     lambda: TP.surface_distance(pts, pts)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    # Tensors are measured where they lie; arrays where the caller says.
    assert TP.surface_distance(torch.tensor(pts), pts) == (0.0, 0.0)
    assert TP.surface_distance(pts, pts, device="cpu") == (0.0, 0.0)


@pytest.mark.parametrize("kw", [
    dict(n_spectral_features=0), dict(non_rigid_outlier_w=1.0),
    dict(icp_registration_mode="affine"), dict(smoothing_method="fast"),
    dict(initial_correspondence_type="x"), dict(eig_wide_chunks=0),
])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JP.PipelineConfig(**kw)
    with pytest.raises(ValueError):
        TP.PipelineConfig(**kw)


@pytest.fixture(scope="module")
def torch_pair(jax_pair):
    tg, sg = jax_pair
    return (TP.graph_arrays_from_numpy(_fields(tg), device="cpu"),
            TP.graph_arrays_from_numpy(_fields(sg), device="cpu"))


@pytest.mark.parametrize("cfg_kw,call_kw,item", [
    (dict(eig_method="lanczos"), {}, "3"),
    (dict(eig_method="chebyshev-narrow"), {}, "3"),
])
def test_unported_configurations_raise(jax_pair, cfg_kw, call_kw, item):
    """The configurations that raised until ROADMAP Queue 1 item ``item``
    landed, now held to JAX's ``register_pair`` at the pipeline gates
    (``_check_slice``), from the draws JAX made (``_jax_draws`` gives each
    narrow or Lanczos solve its start)."""
    want, got = _run_both(jax_pair, dict(FAST, **cfg_kw), **call_kw)
    _check_slice(want, got)


@pytest.fixture(scope="module")
def jax_pair_642():
    out = []
    for seed in (2, 1):
        m = chip_smoke.synthetic_bone(TP, seed, levels=3)
        out.append(JP.mesh_to_graph_arrays(JTriMesh(m.points, m.triangles, {}),
                                           patch_blocks=False))
    return tuple(out)


def test_register_pair_on_a_642_pair_matches_jax(jax_pair_642):
    """Under 2048 vertices 'chebyshev' takes the narrow solver.  Three
    eigenpairs (``n_extra_spectral=0``): at 642 vertices the sixth
    eigenvalue lies above lam_max * 2e-2 / 1.5, where the narrow solver's
    cut saturates at its clip (``pyfocusr_tpu/ops/eigen.py:612``), and
    JAX's own solve leaves that pair unconverged (0.0411 against 0.0333
    here; the port's, from the same start, 0.0388), so no two runs agree
    on it.  The third eigenvalue is well inside the clip."""
    assert TP.pipeline._solver(TP.PipelineConfig(), 642) == "narrow"
    want, got = _run_both(jax_pair_642, dict(FAST, n_extra_spectral=0))
    _check_slice(want, got)


def test_small_and_padded_meshes_raise(torch_pair):
    """A 2000-row source (narrow solver) beside the 2562 target (wide)
    registers; on a padded graph the JAX package's padding guards raise:
    'hungarian' correspondences, and a subsample above the real vertex
    count (the default 5000-point eigsort subsample here)."""
    tg, sg = torch_pair
    small = dataclasses.replace(
        sg, points=sg.points[:2000], neighbors=sg.neighbors[:2000] % 2000,
        nbr_mask=sg.nbr_mask[:2000], valid_mask=sg.valid_mask[:2000],
        null_indicators=sg.null_indicators[:2000],
        node_features=sg.node_features[:2000])
    cfg = TP.PipelineConfig(**FAST)
    draws = TP.make_draws(0, cfg, tg.n_points, small.n_points)
    assert draws["eig_start_source"].shape == (2000, cfg.n_total + 8)
    assert draws["eig_block_target"].shape == (tg.n_points, cfg.eig_wide_block)
    res = TP.register_pair(tg, small, cfg, draws=draws)
    assert res["correspondences"].shape == (2000,)
    assert torch.isfinite(res["weighted_points"]).all()
    assert (res["eig_vals_source"] > 0).all()
    padded = _padded(sg, sg.n_points + 40)
    for target, kw, match in (
            (tg, dict(FAST, n_coords_spectral_ordering=2000,
                      final_correspondence_type="hungarian"),
             "'hungarian' correspondences need unpadded graphs: source"),
            (_padded(tg, tg.n_points + 40), FAST,
             "n_coords_spectral_ordering=5000 exceeds the target")):
        with pytest.raises(ValueError, match=match):
            TP.register_pair(target, padded, TP.PipelineConfig(**kw))


def _padded(graph, n_pad):
    """``graph`` padded to ``n_pad`` rows as ``mesh_to_graph_arrays(
    pad_n_points=n_pad)`` pads it."""
    extra, width = n_pad - graph.n_points, graph.neighbors.shape[1]

    def rows(x, fill=0.0):
        return torch.cat([x, torch.full((extra, *x.shape[1:]), fill, dtype=x.dtype)])

    own = torch.arange(graph.n_points, n_pad)[:, None].expand(extra, width)
    return TP.GraphArrays(
        points=rows(graph.points), neighbors=torch.cat([graph.neighbors, own]),
        nbr_mask=rows(graph.nbr_mask), valid_mask=rows(graph.valid_mask),
        null_indicators=rows(graph.null_indicators), overflow=graph.overflow,
        node_features=rows(graph.node_features))


# The padded pair: eigsort on 2000 points (the default 5000 exceeds the
# real vertex count, which the padding guard refuses).
PADDED = dict(FAST, n_coords_spectral_ordering=2000)


def test_padded_pair_matches_jax(mesh_5k_target, mesh_5k_source):
    """Both meshes padded (target to 2600 rows, source to 2650) through
    each package's ``register_pair``, the port on JAX's draws
    (``_jax_draws`` draws from ``valid_mask``), at ``_check_slice``'s
    gates; no output row of a padding row points at padding."""
    tg = JP.mesh_to_graph_arrays(mesh_5k_target, pad_n_points=2600, patch_blocks=False)
    sg = JP.mesh_to_graph_arrays(mesh_5k_source, pad_n_points=2650, patch_blocks=False)
    want, got = _run_both((tg, sg), PADDED)
    g = _check_slice(want, got)
    n_t, n_s = mesh_5k_target.n_points, mesh_5k_source.n_points
    assert g["correspondences"][:n_s].max() < n_t
    for k in ("correspondences", "weighted_points", "eig_vecs_source_sorted"):
        assert not np.any(g[k][n_s:]), k
    assert not np.any(g["eig_vecs_target"][n_t:])


def test_padded_pair_equals_the_unpadded_pair_on_real_rows(torch_pair):
    """The 2562 pair (wide solver) padded by 38 and 88 rows, on draws that
    equal the unpadded run's on every real row, against the unpadded
    pair: the CUDA-vs-CPU gates of ``chip_smoke.agreement_checks``
    (eigenvalues rtol 1e-4, |cos| >= 0.9999, >= 95% equal
    correspondences, unique fraction within 0.02) on the real rows."""
    tg, sg = torch_pair
    cfg = TP.PipelineConfig(**PADDED)
    draws = TP.make_draws(0, cfg, tg.n_points, sg.n_points)
    ptg, psg = _padded(tg, 2600), _padded(sg, 2650)
    assert TP.pipeline._solver(cfg, ptg.n_points) == "wide"
    pdraws = dict(draws)
    pdraws["eig_block_target"] = np.concatenate([
        draws["eig_block_target"].draw("cpu").numpy(),
        np.random.default_rng(1).standard_normal((38, cfg.eig_wide_block), np.float32)])
    plain = TP.register_pair(tg, sg, cfg, draws=draws)
    padded = TP.register_pair(ptg, psg, cfg, draws=pdraws)
    cut = chip_smoke.real_rows(padded, tg.n_points, sg.n_points)
    assert cut["correspondences"].max() < tg.n_points
    chip_smoke.agreement_checks(chip_smoke.compare_runs(cut, plain),
                                "padded vs unpadded pair")


def test_make_draws_shapes_and_determinism():
    cfg = TP.PipelineConfig(n_coords_spectral_ordering=3000)
    a = TP.make_draws(0, cfg, 2562, 2700)
    b = TP.make_draws(0, cfg, 2562, 2700)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["icp_landmarks"].shape == (2000,)
    np.testing.assert_array_equal(a["eigsort_target"], np.arange(2562))
    np.testing.assert_array_equal(a["eigsort_source"], np.arange(2700))
    assert len(np.unique(a["cpd_source"])) == 1000 and a["cpd_source"].max() < 2700
    assert a["eig_block_target"].shape == (2562, 128)
    assert "eig_block_source" not in a  # warm-started from the target block
    assert a["cpd_omega"].shape == (1000, 116)
    cold = TP.make_draws(0, TP.PipelineConfig(eig_warm_start=False), 2562, 2700)
    assert cold["eig_block_source"].shape == (2700, 128)
    # Narrow and Lanczos starts come after every other draw.
    for kw, width in ((dict(eig_method="chebyshev-narrow"), 14),
                      (dict(eig_method="lanczos"), 2)):
        d = TP.make_draws(0, TP.PipelineConfig(n_coords_spectral_ordering=3000, **kw),
                          2562, 2700)
        assert list(d)[-2:] == ["eig_start_target", "eig_start_source"]
        assert d["eig_start_target"].shape == (2562, width)
        assert "eig_block_target" not in d and "eig_block_source" not in d
        for k in ("icp_landmarks", "eigsort_target", "cpd_source", "cpd_target"):
            np.testing.assert_array_equal(d[k], a[k])
        assert d["cpd_omega"] == a["cpd_omega"]


INDEX_DRAWS = ("icp_landmarks", "eigsort_target", "eigsort_source", "cpd_source",
               "cpd_target")
FLOAT_DRAWS = ("eig_block_target", "eig_block_source", "cpd_omega", "eig_start_target",
               "eig_start_source")


def _index_digest(draws):
    h = hashlib.sha256()
    for k in INDEX_DRAWS:
        if k in draws:
            a = np.ascontiguousarray(draws[k])
            h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()[:16]


# (seed, config, n_target, n_source, n_landmarks, real_target, real_source,
# the digest of the index draws that numpy drew for them when every draw
# was a numpy array).
INDEX_CASES = [
    (0, {}, 2562, 2700, 0, None, None, "6d740439fb3ce48d"),
    (19_001_000, dict(n_coords_spectral_ordering=10000), 10242, 10242, 0, None, None,
     "93589594d60c3bd7"),
    (2**62 - 7, dict(icp_reg_target_to_source=True, n_coords_spectral_ordering=3000),
     5000, 4000, 10, None, None, "3dd760c1c6d5bb25"),
    (123456789, dict(n_coords_spectral_ordering=2000), 2600, 2650, 0, 2562, 2600,
     "5ffbf5c0f1c1b994"),
    (7, dict(eig_method="lanczos", icp_register_first=False), 2562, 2700, 0, None, None,
     "366a4b8d42274290"),
]


@pytest.mark.parametrize("case", INDEX_CASES, ids=lambda c: str(c[0]))
def test_index_draws_keep_their_numpy_values(case):
    """Every index draw is the value numpy drew for it when the float
    starts were host arrays too (padded rows, landmarks, a moving target,
    no ICP and the Lanczos starts included); every float draw is deferred,
    of the shape and dtype it had."""
    seed, kw, n_t, n_s, n_lm, real_t, real_s, digest = case
    cfg = TP.PipelineConfig(**kw)
    d = TP.make_draws(seed, cfg, n_t, n_s, n_lm, real_target=real_t, real_source=real_s)
    assert _index_digest(d) == digest
    for k in INDEX_DRAWS:
        if k in d:
            assert isinstance(d[k], np.ndarray) and d[k].dtype == np.int64, k
    floats = [k for k in d if k not in INDEX_DRAWS]
    assert floats and set(floats) <= set(FLOAT_DRAWS)
    for k in floats:
        v = d[k]
        assert isinstance(v, TP.pipeline.NormalDraw) and v.dtype == np.float32, k
        assert not hasattr(v, "__array__"), k
    assert d["cpd_omega"].shape[0] == min(cfg.n_coords_spectral_registration, n_t, n_s)
    for k, n in (("eig_block_target", n_t), ("eig_start_target", n_t),
                 ("eig_block_source", n_s), ("eig_start_source", n_s)):
        if k in d:
            assert d[k].shape[0] == n, k  # padded row count


def test_deferred_draws_are_fixed_by_the_seed_and_drawn_on_the_device():
    """A float draw is the same for a seed, another for another seed or
    another draw, independent of which other draws a call makes, and
    becomes f32 standard normals on the device it is moved to."""
    cfg = TP.PipelineConfig(n_coords_spectral_ordering=3000)
    a, b = TP.make_draws(5, cfg, 2562, 2700), TP.make_draws(5, cfg, 2562, 2700)
    other = TP.make_draws(6, cfg, 2562, 2700)
    with_block = TP.make_draws(5, cfg, 2562, 2700, source_block=True)
    for k in ("eig_block_target", "cpd_omega"):
        assert a[k] == b[k] and hash(a[k]) == hash(b[k])
        assert a[k] != other[k] and a[k].seed != other[k].seed
        assert with_block[k] == a[k]
    assert with_block["eig_block_source"].shape == (2700, 128)
    seeds = {with_block[k].seed for k in ("eig_block_target", "eig_block_source", "cpd_omega")}
    assert len(seeds) == 3
    block = TP.pipeline._tensor_to(a["eig_block_target"], "cpu")
    assert block.dtype == torch.float32 and block.device.type == "cpu"
    assert tuple(block.shape) == (2562, 128)
    assert abs(float(block.mean())) < 0.01 and abs(float(block.std()) - 1.0) < 0.01
    assert torch.equal(block, TP.pipeline._tensor_to(b["eig_block_target"], "cpu"))
    assert not torch.equal(block, TP.pipeline._tensor_to(other["eig_block_target"], "cpu"))
    omega = TP.pipeline._tensor_to(a["cpd_omega"], "cpu")
    assert not torch.equal(omega[:, :16], block[:1000, :16])
    host = TP.pipeline.host_draws(a)
    assert host["eig_block_target"].dtype == np.float32
    np.testing.assert_array_equal(host["eig_block_target"], block.numpy())
    for k in INDEX_DRAWS:
        np.testing.assert_array_equal(host[k], a[k])


def test_register_pair_draws_deferred_starts_on_its_device(torch_pair):
    """``register_pair`` on ``make_draws`` output draws the two float
    starts on the graphs' device (``deferred_draws`` 2) and copies the
    five index arrays; on explicit arrays (the same values, drawn on the
    host by ``host_draws``) it draws nothing, copies all seven and gives
    the same bits."""
    from pyfocusr_tpu_torch.utils import spans

    tg, sg = torch_pair
    cfg = TP.PipelineConfig(**dict(FAST, icp_iterations=3, non_rigid_max_iterations=5,
                                   eig_wide_chunks=2, eig_wide_chunks_warm=1))
    draws = TP.make_draws(11, cfg, tg.n_points, sg.n_points)
    deferred = TP.register_pair(tg, sg, cfg, draws=draws)
    rec = spans.RECORDS[-1]
    assert rec.completed and rec.total("deferred_draws") == 2
    assert rec.syncs[("inputs", "draws_copy")][0] == len(INDEX_DRAWS)
    host = TP.pipeline.host_draws(draws)
    given = TP.register_pair(tg, sg, cfg, draws=host)
    rec = spans.RECORDS[-1]
    assert rec.total("deferred_draws") == 0
    assert rec.syncs[("inputs", "draws_copy")][0] == len(draws) == 7
    for k in deferred:
        assert torch.equal(deferred[k], given[k]), k


def test_lane_generator_hashes_deferred_draws_by_identity():
    """Cohort's ``lane_generator`` seeds from a deferred draw's seed, shape
    and dtype: stable for a seed, another for another seed."""
    from pyfocusr_tpu_torch.parallel import cohort as TC

    cfg = TP.PipelineConfig(n_coords_spectral_ordering=3000)
    seed = TC.lane_generator(TP.make_draws(3, cfg, 2562, 2700)).initial_seed()
    assert TC.lane_generator(TP.make_draws(3, cfg, 2562, 2700)).initial_seed() == seed
    assert TC.lane_generator(TP.make_draws(4, cfg, 2562, 2700)).initial_seed() != seed
    d = TP.make_draws(3, cfg, 2562, 2700)
    moved = dict(d, cpd_omega=TP.pipeline.NormalDraw(d["cpd_omega"].seed + 1,
                                                      d["cpd_omega"].shape))
    assert TC.lane_generator(moved).initial_seed() != seed


def test_draws_from_generator_are_reproducible(torch_pair):
    """draws=None takes every draw from the generator: the same seed gives
    the same registration."""
    tg, sg = torch_pair
    cfg = TP.PipelineConfig(**dict(FAST, icp_iterations=3,
                                   non_rigid_max_iterations=5,
                                   eig_wide_chunks=2, eig_wide_chunks_warm=1))
    r1 = TP.register_pair(tg, sg, cfg, generator=torch.Generator().manual_seed(5))
    r2 = TP.register_pair(tg, sg, cfg, generator=torch.Generator().manual_seed(5))
    assert torch.equal(r1["correspondences"], r2["correspondences"])


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter with jax and pyfocusr_tpu made unimportable,
    every module of the port imports, and neither appears in sys.modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "pyfocusr_tpu"):
            sys.modules[name] = None  # any import of them now raises
        import pyfocusr_tpu_torch
        for m in pkgutil.walk_packages(pyfocusr_tpu_torch.__path__, "pyfocusr_tpu_torch."):
            importlib.import_module(m.name)
        bad = [n for n, mod in sys.modules.items() if mod is not None and (
            n.split(".")[0] in ("jax", "jaxlib") or n.startswith("pyfocusr_tpu.")
            or n == "pyfocusr_tpu")]
        assert not bad, bad
        print("ok")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
