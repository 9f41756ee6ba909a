"""Port parity: ``pyfocusr_tpu_torch/ops/patch_dense.py`` against
``pyfocusr_tpu/ops/patch_dense.py`` on the 2562-vertex synthetic bone
(``tests/conftest.py:77-107``), with its ELL table as built (no overflow
edges) and capped at degree 5 (overflow edges; the subdivided icosahedron's
degrees are 5 and 6, so JAX's cap of 6 on the bundled mesh spills nothing
here):

* the plan equal to JAX's array for array, built directly and through each
  package's ``mesh_to_graph_arrays`` (``degree_cap``, ``patch_blocks``);
* the gates of ``tests/test_patch_dense.py:98-108`` (a padded graph, a
  100-vertex table, the residual-width cap on a UV sphere's hubs);
* one filter step against the port's ELL operator
  (``pipeline.ell_filter_factory``) and JAX's patch-dense operator, within
  2e-6 of scale (``tests/test_patch_dense.py:79``);
* ``_spectrum`` with and without the plan against JAX's ``_spectrum`` with
  JAX's plan, from the same start block: eigenvalues rtol 1e-4, |cos| >=
  0.9999 on mean-centred columns.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pyfocusr_tpu import pipeline as JP
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
from pyfocusr_tpu.ops import graph_ops as JG
from pyfocusr_tpu.ops import patch_dense as JPD
from pyfocusr_tpu_torch import pipeline as TP
from pyfocusr_tpu_torch.ops import graph_ops as TG
from pyfocusr_tpu_torch.ops import patch_dense as TPD
from pyfocusr_tpu_torch.parallel.cohort import _lane, stack_graph_arrays

torch.set_num_threads(1)

OP_TOL_OF_SCALE = 2e-6
LAM_RTOL = 1e-4
COS_MIN = 0.9999
K = 6


@pytest.fixture(scope="module", params=[24, 5], ids=["bone", "bone_cap5"])
def graphs(request, mesh_5k_target):
    """(JAX graph, port graph) of the bone at ``degree_cap``, plans on."""
    pts, tris = np.asarray(mesh_5k_target.points), np.asarray(mesh_5k_target.triangles)
    jg = JP.mesh_to_graph_arrays(JTriMesh(pts, tris), degree_cap=request.param,
                                 patch_blocks=True)
    tg = TP.mesh_to_graph_arrays(TP.TriMesh(pts, tris), degree_cap=request.param,
                                 device="cpu")
    assert (request.param == 5) == (jg.overflow.shape[0] > 0)
    return jg, tg


def _jax_plan(jg):
    return {k: np.asarray(v) for k, v in jg.patch_plan.items()}


def test_plan_equals_jax(graphs):
    jg, tg = graphs
    want = _jax_plan(jg)
    direct = TPD.build_patch_plan(tg.neighbors, tg.nbr_mask, tg.overflow)
    assert set(direct) == set(want) == set(tg.patch_plan)
    for name, arr in want.items():
        assert direct[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(direct[name], arr, err_msg=name)
        np.testing.assert_array_equal(tg.patch_plan[name].numpy(), arr, err_msg=name)
    # The plan is not part of the graph's identity, in either package.
    assert TP._graph_fingerprint(tg) == JP._graph_fingerprint(jg)
    moved = tg.to("cpu")
    for name, t in tg.patch_plan.items():
        assert torch.equal(moved.patch_plan[name], t)


def test_plan_gates(mesh_5k_target):
    pts, tris = np.asarray(mesh_5k_target.points), np.asarray(mesh_5k_target.triangles)
    mesh = TP.TriMesh(pts, tris)
    assert TP.mesh_to_graph_arrays(mesh, device="cpu").patch_plan is not None
    assert TP.mesh_to_graph_arrays(mesh, device="cpu", patch_blocks=False).patch_plan is None
    padded = TP.mesh_to_graph_arrays(mesh, device="cpu", pad_n_points=len(pts) + 64)
    assert padded.patch_plan is None
    assert JP.mesh_to_graph_arrays(JTriMesh(pts, tris),
                                   pad_n_points=len(pts) + 64).patch_plan is None
    empty = (np.zeros((100, 8), np.int32), np.zeros((100, 8), np.float32))
    assert TPD.build_patch_plan(*empty) is None and JPD.build_patch_plan(*empty) is None
    # A UV sphere whose poles touch 160 vertices, more than a patch holds:
    # their cross-patch degree passes DR_MAX, and both packages decline.
    hub = chip_smoke.uv_sphere(TP, 10, 160)
    jplan = JP.mesh_to_graph_arrays(JTriMesh(hub.points, hub.triangles)).patch_plan
    assert jplan is None and TP.mesh_to_graph_arrays(hub, device="cpu").patch_plan is None
    assert (TPD.BLOCK, TPD.PATCH_DENSE_MAX_N, TPD.DR_MAX) == (
        JPD.BLOCK, JPD.PATCH_DENSE_MAX_N, JPD.DR_MAX)


def test_stacked_plans_follow_jax(mesh_5k_target):
    """``stack_graph_arrays`` keeps the plans of one topology and drops
    mixed ones (``pyfocusr_tpu/parallel/cohort.py:86-105``)."""
    pts, tris = np.asarray(mesh_5k_target.points), np.asarray(mesh_5k_target.triangles)
    a = TP.mesh_to_graph_arrays(TP.TriMesh(pts, tris), device="cpu")
    b = TP.mesh_to_graph_arrays(TP.TriMesh(pts * 1.01, tris), device="cpu")
    both = stack_graph_arrays([a, b])
    assert torch.equal(_lane(both, 1).patch_plan["perm"], b.patch_plan["perm"])
    assert torch.equal(_lane(both, 0).points, a.points)
    none = dataclasses.replace(b, patch_plan=None)
    assert stack_graph_arrays([a, none]).patch_plan is None


def _torch_pieces(g):
    mask = g.valid_mask
    w = TG.edge_weights(g.points, g.neighbors, g.nbr_mask)
    ov = g.overflow
    ov_w = TG.overflow_weights(g.points, ov)
    d = TG.degree_vector(w, ov, ov_w)
    s = torch.sqrt(torch.where(mask > 0, (d + TG.DEGREE_EPS) ** -1, torch.ones_like(d)))
    sw = s[:, None] * w * s[g.neighbors]
    sd = s * s * d * mask
    ov_sw = ov_w * s[ov[:, 0]] * s[ov[:, 1]] if ov.shape[0] else None
    return sw, ov_sw, sd, mask


def _jax_pieces(g):
    mask = g.valid_mask
    w = JG.edge_weights(g.points, g.neighbors, g.nbr_mask)
    ov = g.overflow
    ov_w = JG.overflow_weights(g.points, ov)
    d = JG.degree_vector(w, ov, ov_w)
    s = jnp.sqrt(jnp.where(mask > 0, (d + JG.DEGREE_EPS) ** -1, 1.0))
    sw = s[:, None] * w * s[g.neighbors]
    sd = s * s * d * mask
    ov_sw = (ov_w * s[ov[:, 0]] * s[ov[:, 1]] if ov.shape[0]
             else jnp.zeros((0,), sw.dtype))
    return sw, ov_sw, sd, mask


def test_operator_matches_ell_and_jax(graphs):
    jg, tg = graphs
    c, e = 0.7, 1.3
    T = np.random.default_rng(0).standard_normal((tg.n_points, 16)).astype(np.float32)
    pieces = _torch_pieces(tg)
    got = TPD.patch_filter_factory(tg.patch_plan, *pieces)(
        torch.tensor(c), torch.tensor(e))(torch.from_numpy(T)).numpy()
    ell = TP.ell_filter_factory(tg.neighbors, tg.overflow, *pieces)(
        torch.tensor(c), torch.tensor(e))(torch.from_numpy(T)).numpy()
    want = np.asarray(jax.jit(JPD.patch_filter_factory(jg.patch_plan, *_jax_pieces(jg))(c, e))(
        jnp.asarray(T)))
    scale = np.abs(ell).max()
    np.testing.assert_allclose(got, ell, atol=OP_TOL_OF_SCALE * scale)
    np.testing.assert_allclose(got, want, atol=OP_TOL_OF_SCALE * scale)


def _init_block(key, n, b=128):
    """The block chebyshev_eigpairs_wide draws from ``key``."""
    _, k0 = jax.random.split(key)
    return np.asarray(jax.random.normal(k0, (n, b), dtype=jnp.float32))


def test_spectrum_with_and_without_plan_matches_jax(graphs):
    jg, tg = graphs
    cfg = JP.PipelineConfig()
    key = jax.random.PRNGKey(0)
    want_l, want_v, _ = JP._spectrum(jg, K, key, cfg)
    want_l, want_v = np.asarray(want_l), np.asarray(want_v)
    tcfg = TP.config_from_dict(dataclasses.asdict(cfg))
    start = torch.from_numpy(_init_block(key, tg.n_points).copy())
    for g in (tg, dataclasses.replace(tg, patch_plan=None)):
        got_l, got_v, _ = TP._spectrum(g, K, tcfg, start)
        np.testing.assert_allclose(got_l.numpy(), want_l, rtol=LAM_RTOL)
        for col in range(K):
            a = want_v[:, col] - want_v[:, col].mean()
            b = got_v[:, col].numpy() - got_v[:, col].numpy().mean()
            cos = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
            assert cos >= COS_MIN, (g.patch_plan is None, col, cos)
