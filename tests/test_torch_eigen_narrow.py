"""Port parity: the narrow Chebyshev solver and shift-invert Lanczos of
``pyfocusr_tpu_torch`` against ``pyfocusr_tpu``'s on the synthetic bone
meshes (642 vertices: ``tests/conftest.py:77`` subdivided 3 times; 2562:
4 times), from the same random starts.

The JAX solvers draw their starts from their key: the narrow block from
``key`` (``eigen.py:583``), its power-iteration vector from ``fold_in(key,
7)`` (:557), Lanczos's power-iteration vector from ``key`` (:108, :160) and
its start from ``fold_in(key, 1)`` (:175).  The test draws them with
``jax.random`` and hands them to the port.

Gates: eigenvalues within rtol 1e-4 (the port's eigen gate); each
eigenvector whose relative gap to its neighbours exceeds 1e-3 within |cos|
>= 0.9999 (narrow) or 0.999 (Lanczos, whose f32 Krylov basis and CG solves
carry more rounding), up to sign, on mean-centred columns; inside tighter
clusters the smallest singular value of the cross-Gram of the two bases
>= 0.999.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pyfocusr_tpu_torch as TPkg
from pyfocusr_tpu import pipeline as JP
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
from pyfocusr_tpu.ops import eigen as JE
from pyfocusr_tpu.ops import graph_ops as JG
from pyfocusr_tpu_torch import pipeline as TP
from pyfocusr_tpu_torch.ops import eigen as TE
from pyfocusr_tpu_torch.ops import graph_ops as TG

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

K = 6
LAM_RTOL = 1e-4
GAP_MIN = 1e-3
SUBSPACE_MIN = 0.999


def _jax_mesh(mesh):
    return JTriMesh(np.asarray(mesh.points), np.asarray(mesh.triangles), {})


def _to_torch(ga):
    return TP.graph_arrays_from_numpy(
        {k: np.asarray(v) for k, v in dataclasses.asdict(ga).items()},
        device="cpu",
    )


@pytest.fixture(scope="module")
def graphs():
    """JAX graphs of the 642- and 2562-vertex seed-2 bones."""
    out = {}
    for levels in (3, 4):
        mesh = chip_smoke.synthetic_bone(TPkg, 2, levels=levels)
        out[mesh.n_points] = JP.mesh_to_graph_arrays(_jax_mesh(mesh), patch_blocks=False)
    return out


def narrow_start(key, n, k=K):
    """The narrow solver's start block (eigen.py:583)."""
    return np.asarray(jax.random.normal(key, (n, k + 8), jnp.float32))


def lanczos_start(key, n):
    """Lanczos's power-iteration and start vectors as the port's [N, 2]."""
    return np.stack([np.asarray(jax.random.normal(key, (n,), jnp.float32)),
                     np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (n,),
                                                  jnp.float32))], axis=1)


def assert_eigpairs(got_l, got_v, want_l, want_v, cos_min, centre=True):
    """Eigenvalues by rtol; separated eigenvectors by |cos|, clusters by the
    subspace angle."""
    np.testing.assert_allclose(got_l, want_l, rtol=LAM_RTOL)
    a = np.asarray(want_v, np.float64)
    b = np.asarray(got_v, np.float64)
    if centre:
        a, b = a - a.mean(0), b - b.mean(0)
    a, b = a / np.linalg.norm(a, axis=0), b / np.linalg.norm(b, axis=0)
    lam = np.asarray(want_l, np.float64)
    groups, cur = [], [0]
    for c in range(1, len(lam)):
        if (lam[c] - lam[c - 1]) / lam[c] <= GAP_MIN:
            cur.append(c)
        else:
            groups.append(cur)
            cur = [c]
    groups.append(cur)
    for grp in groups:
        if len(grp) == 1:
            cos = abs(a[:, grp[0]] @ b[:, grp[0]])
            assert cos >= cos_min, (grp, cos)
        else:
            sv = np.linalg.svd(a[:, grp].T @ b[:, grp], compute_uv=False)
            assert sv.min() >= SUBSPACE_MIN, (grp, sv)


@pytest.mark.parametrize("n,method", [(642, "chebyshev"), (642, "chebyshev-narrow"),
                                      (2562, "chebyshev-narrow")])
def test_narrow_spectrum_matches_jax(graphs, n, method):
    """``_spectrum`` on the narrow path: 'chebyshev-narrow', or 'chebyshev'
    under 2048 vertices."""
    g = graphs[n]
    key = jax.random.PRNGKey(5)
    cfg = JP.PipelineConfig(eig_method=method)
    jl, jv, _ = JP._spectrum(g, K, key, cfg)
    tcfg = TP.PipelineConfig(eig_method=method)
    assert TP._solver(tcfg, n) == "narrow"
    tl, tv, _ = TP._spectrum(_to_torch(g), K, tcfg, narrow_start(key, n))
    assert_eigpairs(tl.numpy(), tv.numpy(), np.asarray(jl), np.asarray(jv), 0.9999)


@pytest.mark.parametrize("n", [642, 2562])
def test_lanczos_spectrum_matches_jax(graphs, n):
    g = graphs[n]
    key = jax.random.PRNGKey(6)
    cfg = JP.PipelineConfig(eig_method="lanczos")
    jl, jv, _ = JP._spectrum(g, K, key, cfg)
    tl, tv, _ = TP._spectrum(_to_torch(g), K, TP.PipelineConfig(eig_method="lanczos"),
                             lanczos_start(key, n))
    assert_eigpairs(tl.numpy(), tv.numpy(), np.asarray(jl), np.asarray(jv), 0.999)


def _operators(g):
    """The symmetrized Laplacian of a JAX graph as each package's matvec,
    its kernel basis, and sqrt(g)."""
    w = JG.edge_weights(g.points, g.neighbors, g.nbr_mask)
    ov_w = JG.overflow_weights(g.points, g.overflow)
    d = JG.degree_vector(w, g.overflow, ov_w)
    gv = (d + JG.DEGREE_EPS) ** -1
    s = jnp.sqrt(gv)
    null = g.null_indicators * (1.0 / s)[:, None]

    def jmv(x):
        return JG.sym_laplacian_matvec(g.neighbors, w, gv, x, g.overflow, ov_w, degrees=d)

    t = {name: torch.tensor(np.asarray(v)) for name, v in dict(
        w=w, ov_w=ov_w, d=d, g=gv, nbrs=g.neighbors, ov=g.overflow).items()}
    t["nbrs"], t["ov"] = t["nbrs"].long(), t["ov"].long()

    def tmv(X):
        return TG.sym_laplacian_matvec(t["nbrs"], t["w"], t["g"], X, t["ov"],
                                       t["ov_w"], degrees=t["d"])

    return jmv, tmv, null, np.asarray(s)


@pytest.mark.parametrize("resid_tol", [0.0, 1e-6])
def test_narrow_solver_without_bound_matches_jax(graphs, resid_tol):
    """``chebyshev_eigpairs`` itself with the power-iteration lam_max (no
    bound given) and, at resid_tol > 0, the adaptive stop, on the 2562
    mesh.  At 642 vertices the JAX solver itself leaves its sixth pair
    unconverged without the Gershgorin bound for three of the keys 0-5
    (residual 0.017-0.21): the 1.3x power-iteration pad widens the filter's
    amplification disparity past f32 resolution, the failure its comments
    (``eigen.py:620-628``) describe, and which run survives depends on
    rounding.  The pipeline and ``Graph`` always pass the bound."""
    g = graphs[2562]
    jmv, tmv, null, _ = _operators(g)
    key = jax.random.PRNGKey(7)
    jl, jv, _ = JE.chebyshev_eigpairs(jmv, null, key, K, resid_tol=resid_tol)
    power = np.asarray(jax.random.normal(jax.random.fold_in(key, 7), (g.n_points,),
                                         jnp.float32))
    tl, tv, tr = TE.chebyshev_eigpairs(
        tmv, torch.tensor(np.asarray(null)), K, torch.tensor(narrow_start(key, g.n_points)),
        power_vec=torch.tensor(power), resid_tol=resid_tol)
    assert_eigpairs(tl.numpy(), tv.numpy(), np.asarray(jl), np.asarray(jv), 0.9999,
                    centre=False)
    assert torch.isfinite(tr).all()


def test_power_iteration_and_cg_match_jax(graphs):
    g = graphs[642]
    jmv, tmv, null, _ = _operators(g)
    key = jax.random.PRNGKey(8)
    v = np.asarray(jax.random.normal(key, (g.n_points,), jnp.float32))
    want = float(JE._estimate_lambda_max(jmv, g.n_points, key))
    got = float(TE._estimate_lambda_max(tmv, torch.tensor(v)))
    assert abs(got - want) <= 1e-5 * want
    v0 = null / jnp.linalg.norm(null, axis=0, keepdims=True)
    b = np.asarray(jax.random.normal(jax.random.fold_in(key, 2), (g.n_points,), jnp.float32))
    sigma = 2e-3 * want
    want_x = np.asarray(JE._cg_solve(lambda x: jmv(x) + sigma * x, jnp.asarray(b), 300, v0))
    got_x = TE._cg_solve(lambda X: tmv(X) + sigma * X, torch.tensor(b)[:, None], 300,
                         torch.tensor(np.asarray(v0)))[:, 0].numpy()
    assert np.linalg.norm(got_x - want_x) <= 1e-4 * np.linalg.norm(want_x)


def test_smallest_nonzero_eigpairs_matches_jax(graphs):
    """The Lanczos entry point with its back-transform u = s v."""
    g = graphs[642]
    jmv, tmv, null, s = _operators(g)
    key = jax.random.PRNGKey(9)
    jl, jv, _ = JE.smallest_nonzero_eigpairs(jmv, jnp.asarray(s), null, K, key)
    start = torch.tensor(lanczos_start(key, g.n_points))
    tl, tv, _ = TE.smallest_nonzero_eigpairs(
        tmv, torch.tensor(s), torch.tensor(np.asarray(null)), K, start[:, 0], start[:, 1])
    assert_eigpairs(tl.numpy(), tv.numpy(), np.asarray(jl), np.asarray(jv), 0.999,
                    centre=False)
    np.testing.assert_allclose(tv.norm(dim=0).numpy(), 1.0, rtol=1e-5)


def test_non_wide_paths_refuse_warm_start_arguments(graphs):
    """JAX's ValueError when the wide path's hooks reach another solver."""
    g = _to_torch(graphs[642])
    cfg = TP.PipelineConfig()
    start = narrow_start(jax.random.PRNGKey(0), 642)
    for kw in (dict(return_block=True), dict(x0=torch.zeros(642, 128)),
               dict(chunks=2), dict(degree=20)):
        with pytest.raises(ValueError, match="wide Chebyshev"):
            TP._spectrum(g, K, cfg, start, **kw)
