"""Port parity for multi-resolution registration:
``pyfocusr_tpu_torch.multires`` against ``pyfocusr_tpu.multires`` on JAX
CPU, on the synthetic bone pair (``chip_smoke.synthetic_bone``: 2562
vertices at 4 subdivisions, 10242 at 5).

Gates:
* ``decimate`` returns JAX's bits (coarse points and triangles,
  fine_to_coarse, coarse_rep) with and without the caller's edges, and on
  the row-unique branch; ``_luby_mis_numpy`` equals JAX's on a graph with
  isolated vertices; ``_aggregate_features`` and ``_map_landmarks`` equal
  JAX's; ``build_topology`` labels the components of a multi-component
  mesh as JAX's does;
* the refine from JAX's own prolonged initial correspondences, plain and
  with ``include_features_in_adj_matrix``: smoothed target within 1e-5 of
  the mesh's extent, correspondences equal and weighted points within 1e-4
  of the extent on >= 99% of vertices (JAX's k-NN uses the matmul identity
  on the CPU, the port direct differences, so a near-tie may swap a
  neighbour: then the weighted point moves by up to an edge length);
* ``register_pair_multires`` end to end with JAX's coarse draws (the
  ``draws`` hook), single-jump and multi-level: the same level sizes,
  correspondences equal on >= 95% of vertices, unique fractions within
  0.01.  JAX's own multi-level test (``n // 16``, level_ratio 8) would put
  the coarse mesh near 640 vertices, where the narrow eigensolver leaves its
  last pair unconverged in both packages; here coarse_n 2500 keeps it near
  2700;
* checkpoints: a resume returns the first call's bits without re-solving
  or re-smoothing, a changed input recomputes, and stage files load in the
  other package's ``load_results``;
* JAX's input errors, with JAX's messages (the sharded refine itself:
  ``tests/test_torch_sharded.py``, ``tests/test_torch_bigmesh.py``).
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu import multires as JMR
from pyfocusr_tpu import pipeline as JP
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
from pyfocusr_tpu.mesh import build_topology as j_build_topology
from pyfocusr_tpu.utils import checkpoint as JCK
from pyfocusr_tpu_torch import multires as TMR
from pyfocusr_tpu_torch.utils import checkpoint as TCK
from test_torch_pipeline import FAST, _jax_draws

torch.set_num_threads(1)

COARSE_N = 2500
# The checkpoint runs' configuration: FAST with shorter ICP, CPD and
# eigensolves (the checks are of bits, not of registration quality).
CHEAP = dict(FAST, icp_iterations=5, non_rigid_max_iterations=5,
             eig_wide_chunks=2, eig_wide_chunks_warm=1)


def _jmesh(m):
    return JTriMesh(np.asarray(m.points), np.asarray(m.triangles))


@pytest.fixture(scope="module")
def bones():
    return {lv: (chip_smoke.synthetic_bone(TP, 2, lv), chip_smoke.synthetic_bone(TP, 1, lv))
            for lv in (3, 4, 5)}


def _bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# --- Decimation ---

@pytest.mark.parametrize("levels, target_n", [(4, 600), (5, COARSE_N)])
@pytest.mark.parametrize("with_edges", [False, True])
def test_decimate_bit_equal(bones, levels, target_n, with_edges):
    mesh = bones[levels][0]
    tris = np.asarray(mesh.triangles)
    jt = j_build_topology(tris, mesh.n_points) if with_edges else None
    tt = TP.build_topology(tris, mesh.n_points) if with_edges else None
    jc, jf, jr = JMR.decimate(_jmesh(mesh), target_n, 3,
                              edges=None if jt is None else jt.edges)
    tc, tf, tr = TP.decimate(mesh, target_n, 3, edges=None if tt is None else tt.edges)
    assert 0.4 * target_n <= tc.n_points <= 1.5 * target_n
    _bytes_equal(tc.points, jc.points)
    _bytes_equal(tc.triangles, jc.triangles)
    _bytes_equal(tf, jf)
    _bytes_equal(tr, jr)


def test_decimate_row_unique_branch_equals_packed_key(bones, monkeypatch):
    mesh = bones[4][0]
    jc, jf, jr = JMR.decimate(_jmesh(mesh), 600, 0)
    monkeypatch.setattr(TMR, "_PACKED_KEY_MAX_NC", 0)
    tc, tf, tr = TP.decimate(mesh, 600, 0)
    _bytes_equal(tc.triangles, jc.triangles)
    _bytes_equal(tc.points, jc.points)
    _bytes_equal(tf, jf)
    _bytes_equal(tr, jr)


def test_luby_mis_with_isolated_vertices():
    """The graph of ``tests/test_multires.py:140``: a triangle fan over
    vertices 0-8 with 3, 5, 7 and 9 isolated.  The port's MIS equals the
    JAX package's (its numpy rounds and, where built, its native greedy
    pass), is independent and maximal; one aggregation round equals JAX's."""
    from pyfocusr_tpu import native

    tris = np.array([[0, 1, 2], [1, 2, 4], [2, 4, 6], [4, 6, 8]])
    e = np.unique(np.sort(np.concatenate(
        [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]), axis=1), axis=0)
    u, v = e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)
    pts = np.random.default_rng(0).normal(size=(10, 3))
    for seed in range(6):
        prio = np.random.default_rng(seed).permutation(10).astype(np.int64)
        state = TMR._luby_mis_numpy(u, v, 10, prio)
        _bytes_equal(state, JMR._luby_mis_numpy(u, v, 10, prio))
        greedy = native.mis_greedy_native(u, v, 10, prio)
        if greedy is not None:
            _bytes_equal(state, greedy)
        seed_v = state == 1
        assert not (seed_v[u] & seed_v[v]).any()
        blocked = np.flatnonzero(state == -1)
        assert all(seed_v[np.concatenate([v[u == b], u[v == b]])].any() for b in blocked)
        assert seed_v[[3, 5, 7, 9]].all()
        got = TMR._aggregate_once(pts, tris, np.random.default_rng(seed))
        want = JMR._aggregate_once(pts, tris, np.random.default_rng(seed))
        for a, b in zip(got, want):
            _bytes_equal(a, b)


def test_aggregate_features_and_map_landmarks_bit_equal(bones):
    t, s = bones[4]
    ct, map_t, _ = TP.decimate(t, 600, 0)
    cs, map_s, _ = TP.decimate(s, 600, 1)
    feats = np.random.default_rng(1).normal(size=(t.n_points, 2)).astype(np.float32)
    _bytes_equal(TMR._aggregate_features(feats, map_t, ct.n_points),
                 JMR._aggregate_features(feats, map_t, ct.n_points))
    # Pins 5 and 6 of the source usually share a cluster: the first is kept.
    lm = np.array([[5, 5], [6, 6], [150, 150], [2000, 17], [6, 900]], np.int64)
    got = TMR._map_landmarks(lm, map_t, map_s, t, s)
    _bytes_equal(got, JMR._map_landmarks(lm, map_t, map_s, _jmesh(t), _jmesh(s)))
    assert len(got) < len(lm)


def test_topology_components_of_a_multi_component_mesh(bones):
    """Three copies of the 642 bone with interleaved vertex ids and two
    isolated vertices: the components are numbered by their lowest vertex,
    as the JAX package's label propagation numbers them."""
    m = bones[3][0]
    n = m.n_points
    perm = np.random.default_rng(2).permutation(3 * n + 2)
    tris = np.concatenate([perm[np.asarray(m.triangles) + c * n] for c in range(3)])
    jt = j_build_topology(tris, 3 * n + 2)
    tt = TP.build_topology(tris, 3 * n + 2)
    _bytes_equal(tt.component_labels, jt.component_labels)
    assert tt.n_components == jt.n_components == 5


# --- The refine ---

def _thickness(mesh):
    f = np.asarray(mesh.point_data[chip_smoke.FEATURE], np.float64)
    return ((f - f.min()) / (f.max() - f.min())).astype(np.float32)[:, None]


@pytest.mark.parametrize("features", [False, True])
def test_refine_matches_jax(bones, jax_runs, features):
    t, s = bones[5]
    cfg = JP.PipelineConfig(**dict(FAST, projection_smooth_iterations=20,
                                   include_features_in_adj_matrix=features))
    nf = (_thickness(t), _thickness(s)) if features else (None, None)
    jt = JP.mesh_to_graph_arrays(_jmesh(t), node_features=nf[0], patch_blocks=False)
    js = JP.mesh_to_graph_arrays(_jmesh(s), node_features=nf[1], patch_blocks=False)
    init = jax_runs["single"][0]["initial_correspondences"]
    want = jax.tree.map(np.asarray, JMR._refine_fine_level(
        jt, js, jnp.asarray(init, jnp.int32), cfg))
    tt = TP.mesh_to_graph_arrays(t, node_features=nf[0], device="cpu")
    ts = TP.mesh_to_graph_arrays(s, node_features=nf[1], device="cpu")
    got = TMR._refine_fine_level(tt, ts, torch.from_numpy(init.astype(np.int64)),
                                 TP.config_from_dict(dataclasses.asdict(cfg)))
    assert set(got) == set(want)
    scale = float(np.ptp(np.asarray(t.points), axis=0).max())
    smooth_err = np.abs(got["smoothed_target_coords"].numpy()
                        - want["smoothed_target_coords"]).max()
    assert smooth_err <= 1e-5 * scale, smooth_err
    agree = (got["correspondences"].numpy() == want["correspondences"]).mean()
    assert agree >= 0.99, agree
    w_diff = np.abs(got["weighted_points"].numpy() - want["weighted_points"]).max(axis=1)
    within = (w_diff <= 1e-4 * scale).mean()
    assert within >= 0.99, within
    _bytes_equal(got["initial_correspondences"].numpy(), init.astype(np.int64))


# --- End to end ---

class _Spy:
    """Records each ``decimate`` call's mesh size, target and result size."""

    def __init__(self, mod):
        self.mod, self.real, self.calls = mod, mod.decimate, []

    def __call__(self, mesh, n, seed=0, edges=None):
        out = self.real(mesh, n, seed, edges=edges)
        self.calls.append((mesh.n_points, n, out[0].n_points))
        return out


def _run_jax(t, s, cfg, level_ratio):
    spy = _Spy(JMR)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMR, "decimate", spy)
        fine, coarse = JMR.register_pair_multires(
            _jmesh(t), _jmesh(s), cfg, jax.random.PRNGKey(0), coarse_n=COARSE_N,
            level_ratio=level_ratio)
    return jax.tree.map(np.asarray, fine), jax.tree.map(np.asarray, coarse), spy.calls


def _run_port(t, s, cfg, level_ratio):
    key = jax.random.PRNGKey(0)

    def draws(ct, cs, n_lm):
        def jax_side(g):
            return types.SimpleNamespace(n_points=g.n_points,
                                         valid_mask=jnp.asarray(g.valid_mask.numpy()))
        return _jax_draws(key, cfg, jax_side(ct), jax_side(cs), n_lm)

    spy = _Spy(TMR)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TMR, "decimate", spy)
        fine, coarse = TP.register_pair_multires(
            t, s, TP.config_from_dict(dataclasses.asdict(cfg)), coarse_n=COARSE_N,
            level_ratio=level_ratio, draws=draws, device="cpu")
    return fine, coarse, spy.calls


@pytest.fixture(scope="module")
def jax_runs(bones):
    t, s = bones[5]
    cfg = JP.PipelineConfig(**FAST)
    return {"single": _run_jax(t, s, cfg, 100.0), "multi": _run_jax(t, s, cfg, 2.0)}


@pytest.mark.parametrize("mode, level_ratio", [("single", 100.0), ("multi", 2.0)])
def test_register_pair_multires_matches_jax(bones, jax_runs, mode, level_ratio):
    t, s = bones[5]
    j_fine, j_coarse, j_levels = jax_runs[mode]
    t_fine, t_coarse, t_levels = _run_port(t, s, JP.PipelineConfig(**FAST), level_ratio)
    assert t_levels == j_levels
    if mode == "multi":  # an intermediate level near 2700 whose solve is the coarse one
        assert len(t_levels) == 4 and t_levels[2][0] == t_levels[2][2]
    else:
        assert len(t_levels) == 2
    assert set(t_fine) == set(j_fine) and set(t_coarse) == set(j_coarse)
    for fine_t, fine_j in ((t_fine, j_fine), (t_coarse, j_coarse)):
        a = fine_t["correspondences"].numpy()
        b = fine_j["correspondences"]
        assert (a == b).mean() >= 0.95, (a == b).mean()
        ua, ub = len(np.unique(a)) / len(a), len(np.unique(b)) / len(b)
        assert abs(ua - ub) <= 0.01, (ua, ub)
        assert np.isfinite(fine_t["weighted_points"].numpy()).all()


# --- Checkpoints ---

def _serve_spy(monkeypatch):
    """The stages ``StageCheckpointer.load`` serves, recorded."""
    served, real = [], TCK.StageCheckpointer.load

    def load(ckpt, stage):
        val = real(ckpt, stage)
        if val is not None:
            served.append(stage)
        return val

    monkeypatch.setattr(TCK.StageCheckpointer, "load", load)
    return served


def _ckpt_run(bones, ck, seed=0):
    t, s = bones[5]
    return TP.register_pair_multires(
        t, s, TP.PipelineConfig(**CHEAP), torch.Generator().manual_seed(seed),
        coarse_n=COARSE_N, checkpoint_dir=ck, device="cpu")


@pytest.fixture(scope="module")
def first_ckpt_run(bones, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("multires_ck"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TMR, "_STAGED_REFINE_N", 1)  # save both smoothings
        return ck, _ckpt_run(bones, ck)


def test_checkpoint_resume_is_bit_equal(bones, first_ckpt_run, monkeypatch):
    ck, (fine, coarse) = first_ckpt_run
    assert sorted(os.listdir(ck)) == ["coarse.npz", "refine_projected.npz",
                                      "refine_smoothed_target.npz"]
    monkeypatch.setattr(TMR, "_STAGED_REFINE_N", 1)
    served = _serve_spy(monkeypatch)

    def boom(*a, **k):
        raise AssertionError("a stage re-ran on resume")

    monkeypatch.setattr(TMR, "register_pair", boom)
    monkeypatch.setattr(TMR, "_smooth", boom)
    fine2, coarse2 = _ckpt_run(bones, ck)
    assert sorted(served) == ["coarse", "refine_projected", "refine_smoothed_target"]
    for a, b in ((fine, fine2), (coarse, coarse2)):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_checkpoint_changed_input_recomputes(bones, first_ckpt_run, monkeypatch):
    ck, _ = first_ckpt_run
    t, s = bones[5]
    fp = TMR._run_fingerprint(t, s, TP.PipelineConfig(**CHEAP),
                              torch.Generator().manual_seed(1), COARSE_N, 0,
                              None, None, 100.0)
    assert TCK.StageCheckpointer(ck, fp).load("coarse") is None
    solves = []
    real = TMR.register_pair
    monkeypatch.setattr(TMR, "register_pair",
                        lambda *a, **k: solves.append(1) or real(*a, **k))
    fine, _ = _ckpt_run(bones, ck, seed=1)
    assert solves == [1]
    assert TCK.StageCheckpointer(ck, fp).load("coarse") is not None
    assert np.isfinite(fine["weighted_points"].numpy()).all()


def test_stage_files_load_in_either_package(first_ckpt_run, tmp_path):
    ck, (fine, coarse) = first_ckpt_run
    flat = JCK.load_results(os.path.join(ck, "refine_projected.npz"))
    vals = {JCK._attr_from_path(k): v for k, v in flat.items()}
    assert set(vals) == {"__value__", "__fingerprint__"}
    np.testing.assert_array_equal(vals["__value__"],
                                  fine["source_projected_on_target"].numpy())
    flat = JCK.load_results(os.path.join(ck, "coarse.npz"))
    got = {JCK._attr_from_path(k) for k in flat}
    assert set(coarse) | {"__init_fine__", "__coarse_source_n__", "__fingerprint__"} == got
    # The reverse: a stage the JAX package saved.
    j = JCK.StageCheckpointer(str(tmp_path), "fp-1")
    j.save("stage", {"a": jnp.arange(5, dtype=jnp.int32), "b": jnp.ones((2, 3))})
    flat = TCK.load_results(str(tmp_path / "stage.npz"))
    assert {TCK._attr_from_path(k) for k in flat} == {"a", "b", "__fingerprint__"}
    loaded = TCK.StageCheckpointer(str(tmp_path), "fp-1").load("stage")
    assert torch.equal(loaded["a"], torch.arange(5, dtype=torch.int32))
    assert torch.equal(loaded["b"], torch.ones((2, 3)))
    assert TCK.StageCheckpointer(str(tmp_path), "fp-2").load("stage") is None


# --- Input errors ---

def _error_case(name, bones):
    """(target, source, cfg fields, keyword arguments) of one bad call."""
    t, s = bones[3]
    if name == "hungarian_final":
        return t, s, dict(final_correspondence_type="hungarian"), {}
    if name == "hungarian_initial":
        return t, s, dict(initial_correspondence_type="hungarian"), {}
    if name in ("use_features_as_coords", "use_features_in_graph",
                "include_features_in_adj_matrix"):
        return t, s, {name: True}, {}
    if name == "features_shape":
        return t, s, dict(use_features_as_coords=True), dict(
            node_features=(np.zeros((t.n_points, 1)), np.zeros((s.n_points + 1, 1))))
    if name == "landmark_range":
        return t, s, {}, dict(coarse_n=300, landmark_pairs=np.array([[10_000, 0]]))
    if name == "landmark_shape":
        return t, s, {}, dict(coarse_n=300, landmark_pairs=np.zeros((2, 3), np.int64))
    if name == "landmarks_exceed_subsample":
        return t, s, dict(n_coords_spectral_registration=50), dict(
            coarse_n=40, landmark_pairs=np.stack([np.arange(0, 260, 2)] * 2, axis=1))
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "hungarian_final", "hungarian_initial", "use_features_as_coords",
    "use_features_in_graph", "include_features_in_adj_matrix", "features_shape",
    "landmark_range", "landmark_shape", "landmarks_exceed_subsample"])
def test_input_errors_match_jax(bones, name):
    t, s, fields, kw = _error_case(name, bones)
    with pytest.raises(ValueError) as want:
        JMR.register_pair_multires(_jmesh(t), _jmesh(s), JP.PipelineConfig(**fields),
                                   jax.random.PRNGKey(0), **kw)
    with pytest.raises(ValueError) as got:
        TP.register_pair_multires(t, s, TP.PipelineConfig(**fields), device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_device_mesh_and_draws_with_checkpoints_raise(bones, tmp_path):
    """A mesh with ``include_features_in_adj_matrix`` raises JAX's error
    before anything runs (any mesh object: the check reads the config)."""
    t, s = bones[3]
    cfg = TP.PipelineConfig()
    feats = tuple(np.ones((m.n_points, 1), np.float32) for m in (t, s))
    fcfg = dataclasses.replace(cfg, include_features_in_adj_matrix=True)
    with pytest.raises(ValueError) as want:
        JMR.register_pair_multires(_jmesh(t), _jmesh(s), JP.PipelineConfig(
            include_features_in_adj_matrix=True), jax.random.PRNGKey(0),
            device_mesh=object(), node_features=feats)
    with pytest.raises(ValueError) as got:
        TP.register_pair_multires(t, s, fcfg, device_mesh=object(), node_features=feats,
                                  device="cpu")
    assert str(got.value) == str(want.value) and "device_mesh" in str(got.value)
    with pytest.raises(ValueError, match="draws callable"):
        TP.register_pair_multires(t, s, cfg, checkpoint_dir=str(tmp_path),
                                  draws=lambda *a: {}, device="cpu")
