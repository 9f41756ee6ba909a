"""Port parity for the host-side mesh code, ICP, CPD and eigsort of
``pyfocusr_tpu_torch`` against ``pyfocusr_tpu`` on the same inputs.

* ``build_topology`` and ``subdivide`` are numpy on both sides and must be
  byte-equal (same dtypes, same bytes).
* ``icp`` must stop at the same iteration as the JAX ``while_loop``, with
  R within 1e-4 and t within 1e-4 relative to the data scale: the
  per-iteration matches agree exactly, so R and t differ only by f32
  rounding in the 3x3 SVD and the centroid sums.
* ``low_rank_gaussian`` from the same ``omega``: eigenvalues and the rank-k
  Gram reconstruction within 1e-4 of the top eigenvalue (f32 QR/eigh in two
  LAPACK builds); eigenvector signs may differ, which the reconstruction
  does not see.
* ``_deformable_cpd_run`` from the same Q, lam: same iteration count, moved
  cloud within 1e-3 of the unit-scale clouds.  Each M-step solves
  (S C S + alpha sigma2 I) z = S Q^T F with alpha sigma2 ~ 1e-6 here, which
  amplifies the f32 rounding of the E-step sums (summed in another order by
  each framework) to a measured 3.5e-4 after the run.
* ``sort_eigenmaps``: the same permutation and flips (exact), Q within
  rtol 1e-4.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfocusr_tpu import mesh as JM
from pyfocusr_tpu import multires as JMR
from pyfocusr_tpu.ops import assignment as JA
from pyfocusr_tpu.ops import cpd as JC
from pyfocusr_tpu.ops import icp as JI
from pyfocusr_tpu.ops import wasserstein as JW
from pyfocusr_tpu.spectral.eigsort_jax import sort_eigenmaps_jit
from pyfocusr_tpu_torch import mesh as TM
from pyfocusr_tpu_torch import multires as TMR
from pyfocusr_tpu_torch.ops import assignment as TA
from pyfocusr_tpu_torch.ops import cpd as TC
from pyfocusr_tpu_torch.ops import icp as TI
from pyfocusr_tpu_torch.ops import wasserstein as TW
from pyfocusr_tpu_torch.spectral.eigsort_device import sort_eigenmaps

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _meshes(mesh_5k_source):
    from test_curvature_icp import make_sphere

    pts, tris = make_sphere(n_theta=16, n_phi=48)
    return [
        (np.asarray(mesh_5k_source.points), np.asarray(mesh_5k_source.triangles), 24),
        (pts.astype(np.float32), tris, 24),  # pole hubs spill overflow edges
        (pts.astype(np.float32), tris, None),  # uncapped
    ]


def test_build_topology_byte_equal(mesh_5k_source):
    for pts, tris, cap in _meshes(mesh_5k_source):
        jt = JM.build_topology(tris, len(pts), degree_cap=cap)
        tt = TM.build_topology(tris, len(pts), degree_cap=cap)
        for f in ("edges", "neighbors", "nbr_mask", "edge_faces",
                  "component_labels", "overflow_edges"):
            _bytes_equal(getattr(tt, f), getattr(jt, f))
        assert (tt.max_degree, tt.n_components) == (jt.max_degree, jt.n_components)


def test_subdivide_byte_equal(mesh_5k_source):
    pts = np.asarray(mesh_5k_source.points)[:1000]
    tris = np.asarray(mesh_5k_source.triangles)
    tris = tris[(tris < 1000).all(axis=1)]
    data = {"f": np.linspace(0, 1, 1000).astype(np.float32)}
    jm = JM.TriMesh(pts, tris, data)
    tm = TM.TriMesh(pts, tris, data)
    for _ in range(2):
        jm, tm = JMR.subdivide(jm), TMR.subdivide(tm)
        _bytes_equal(tm.points, jm.points)
        _bytes_equal(tm.triangles, jm.triangles)
        _bytes_equal(tm.point_data["f"], jm.point_data["f"])


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    a = np.deg2rad(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


@pytest.mark.parametrize("mode,scale", [("rigid", 1.0), ("similarity", 1.04)])
def test_icp_matches_jax(mesh_5k_target, mode, scale):
    tgt = np.asarray(mesh_5k_target.points, np.float32)
    rng = np.random.default_rng(0)
    lm = rng.choice(len(tgt), 700, replace=False)
    R0 = _rot([0.3, 1.0, 0.2], 8.0)
    src = (scale * tgt[lm] @ R0.T + np.array([3.0, -2.0, 5.0])
           + rng.normal(scale=0.05, size=(700, 3))).astype(np.float32)
    (ts, tR, tt), tmoved, it = TI.icp(torch.tensor(src), torch.tensor(tgt),
                                      mode=mode, max_iterations=100,
                                      return_iterations=True)
    assert 1 < it < 100

    def jax_icp(max_it):
        (s, R, t), moved = JI.icp(jnp.asarray(src), jnp.asarray(tgt), mode=mode,
                                  max_iterations=max_it)
        return np.asarray(s), np.asarray(R), np.asarray(t), np.asarray(moved)

    at_it, at_max = jax_icp(it), jax_icp(100)
    # JAX stopped at or before ``it``: running longer changes nothing ...
    for a, b in zip(at_it, at_max):
        np.testing.assert_array_equal(a, b)
    # ... and not before: its mean motion in iteration it-1 was still above
    # the stop threshold 1e-5 * scale (icp.py:110).
    m2, m1 = jax_icp(it - 2)[3], jax_icp(it - 1)[3]
    threshold = 1e-5 * (np.abs(tgt).max() + 1.0)
    assert np.linalg.norm(m1 - m2, axis=1).mean() > threshold
    data_scale = float(np.abs(tgt).max())
    np.testing.assert_allclose(tR.numpy(), at_it[1], atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), at_it[2], atol=1e-4 * data_scale)
    np.testing.assert_allclose(float(ts), float(at_it[0]), rtol=1e-4)


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(11)
    Y = rng.uniform(-0.5, 0.5, size=(250, 3)).astype(np.float32)
    warp = 0.08 * np.sin(3.0 * Y[:, [1, 2, 0]])
    X = (Y + warp + rng.normal(scale=0.01, size=Y.shape)).astype(np.float32)
    return X, Y


@pytest.mark.parametrize("beta", [2.0, 50.0])
def test_low_rank_gaussian_same_omega(clouds, beta):
    _, Y = clouds
    num_eig = 60
    key = jax.random.PRNGKey(6)
    p = min(num_eig + 16, Y.shape[0])
    omega = np.asarray(jax.random.normal(key, (Y.shape[0], p), jnp.float32))
    jQ, jl = JC.low_rank_gaussian(jnp.asarray(Y), beta, num_eig, key)
    tQ, tl = TC.low_rank_gaussian(torch.tensor(Y), beta, num_eig, torch.tensor(omega))
    jQ, jl, tQ, tl = np.asarray(jQ), np.asarray(jl), tQ.numpy(), tl.numpy()
    tol = 1e-4 * float(jl[0])
    np.testing.assert_allclose(tl, jl, atol=tol)
    np.testing.assert_allclose((tQ * tl) @ tQ.T, (jQ * jl) @ jQ.T, atol=tol)


def test_deformable_cpd_and_transform_match_jax(clouds):
    X, Y = clouds
    beta, num_eig = 2.0, 60
    jQ, jl = JC.low_rank_gaussian(jnp.asarray(Y), beta, num_eig, jax.random.PRNGKey(1))
    # tolerance 1e-6: the stop test |delta sigma2| <= tol then fires well
    # above the f32 noise of sigma2 (~1e-4 here), so both loops stop at the
    # same iteration; at 1e-8 the test sits in that noise.
    jTY, jz, js2, jit = JC._deformable_cpd_run(
        jnp.asarray(X), jnp.asarray(Y), jQ, jl, 0.01, 60, 1e-6
    )
    tQ, tl = torch.tensor(np.asarray(jQ)), torch.tensor(np.asarray(jl))
    tTY, tz, ts2, tit = TC._deformable_cpd_run(
        torch.tensor(X), torch.tensor(Y), tQ, tl, 0.01, 60, 1e-6
    )
    assert tit == int(jit) < 60
    np.testing.assert_allclose(tTY.numpy(), np.asarray(jTY), atol=1e-3)
    np.testing.assert_allclose(float(ts2), float(js2), rtol=1e-3)
    pts = np.random.default_rng(2).uniform(-0.5, 0.5, (900, 3)).astype(np.float32)
    jm = JC.lowrank_transform(jnp.asarray(pts), jnp.asarray(Y), jQ, jl, jz, beta)
    tm = TC.lowrank_transform(torch.tensor(pts), torch.tensor(Y), tQ, tl,
                              torch.tensor(np.asarray(jz)), beta)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-3)


def _eigmaps(points, cols, flips, noise, rng):
    p = (points - points.mean(0)) / np.abs(points).max()
    basis = np.stack([p[:, 2], p[:, 0], p[:, 1], p[:, 2] * p[:, 0],
                      p[:, 0] * p[:, 1], p[:, 1] ** 2 - p[:, 2] ** 2], axis=1)
    v = basis[:, cols] * flips + noise * rng.normal(size=(len(p), 6))
    v = (v - v.min(0)) / (v.max(0) - v.min(0)) - 0.5
    return v.astype(np.float32)


@pytest.mark.parametrize("n_s,target_ref", [(2562, True), (2562, False), (2000, True)])
def test_sort_eigenmaps_matches_jax(mesh_5k_target, mesh_5k_source, n_s, target_ref):
    rng = np.random.default_rng(n_s)
    pt = np.asarray(mesh_5k_target.points, np.float32)
    ps = np.asarray(mesh_5k_source.points, np.float32)[:n_s]
    vt = _eigmaps(pt, [0, 1, 2, 3, 4, 5], np.ones(6), 0.01, rng)
    vs = _eigmaps(ps, [1, 0, 2, 4, 3, 5], np.array([1, -1, 1, -1, 1, 1]), 0.01, rng)
    lt = np.array([1.0, 1.4, 2.2, 3.1, 3.3, 4.0], np.float32) * 1e-3
    ls = lt * np.array([1.02, 0.97, 1.01, 1.03, 0.98, 1.0], np.float32)
    normed = lambda x: (x - x.min(0)) / (x.max(0) - x.min(0))  # noqa: E731
    args = (lt, ls, vt, vs, normed(pt), normed(ps), vs if target_ref else vt)
    jv, jq = sort_eigenmaps_jit(*map(jnp.asarray, args), target_as_reference=target_ref)
    tv, tq = sort_eigenmaps(*map(torch.tensor, args), target_as_reference=target_ref)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4)


def test_exact_lap_small_and_wasserstein_match_jax():
    rng = np.random.default_rng(3)
    for k in (1, 3, 6):
        cost = rng.uniform(size=(k, k)).astype(np.float32)
        np.testing.assert_array_equal(
            TA.exact_lap_small(torch.tensor(cost)).numpy(),
            np.asarray(JA.exact_lap_small(jnp.asarray(cost))),
        )
    for nu, nv in ((500, 500), (500, 377)):
        u = rng.normal(size=nu).astype(np.float32)
        v = rng.normal(loc=0.3, size=nv).astype(np.float32)
        np.testing.assert_allclose(
            float(TW.wasserstein_1d(torch.tensor(u), torch.tensor(v))),
            float(JW.wasserstein_1d(jnp.asarray(u), jnp.asarray(v))),
            rtol=1e-5,
        )
