"""The wide eigensolver's one filter operator in ``pyfocusr_tpu_torch``: the
ELL table, every chunk through ``ops/cheb_step_kernel.chebyshev_ell`` on
every device, against the JAX package's default graph, which carries its
patch-dense plan (``pyfocusr_tpu/ops/patch_dense.py``).  On the 2562-vertex
synthetic bone (``tests/conftest.py:77-107``), with its ELL table as built
(no overflow edges) and capped at degree 5 (overflow edges; the subdivided
icosahedron's degrees are 5 and 6, so JAX's cap of 6 on the bundled mesh
spills nothing here):

* one filter step of the port's ELL factory against JAX's patch-dense
  operator and its ELL operator (``pyfocusr_tpu/pipeline.py:590-605``),
  within 2e-6 of scale (``tests/test_patch_dense.py:79``);
* ``_spectrum`` of the port's default graph against JAX's ``_spectrum`` of
  JAX's default graph, plan included, from the same start block:
  eigenvalues rtol 1e-4, |cos| >= 0.9999 on mean-centred columns;
* ``graph_arrays_from_numpy`` of JAX's default graph's fields, plan
  included, equal field for field to the graph built without the plan and
  to the port's own graph;
* ``stack_graph_arrays`` then ``_lane`` giving back every field;
* the CPU ``_spectrum`` of an unpadded, a padded and a hub graph (overflow
  edges) running every chunk, top-ups included, through ``chebyshev_ell``.
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
from pyfocusr_tpu_torch.parallel.cohort import _lane, stack_graph_arrays
from pyfocusr_tpu_torch.utils import spans

torch.set_num_threads(1)

OP_TOL_OF_SCALE = 2e-6
LAM_RTOL = 1e-4
COS_MIN = 0.9999
K = 6


@pytest.fixture(scope="module", params=[24, 5], ids=["bone", "bone_cap5"])
def graphs(request, mesh_5k_target):
    """(JAX default graph, with its plan; port graph) of the bone at
    ``degree_cap``."""
    pts, tris = np.asarray(mesh_5k_target.points), np.asarray(mesh_5k_target.triangles)
    jg = JP.mesh_to_graph_arrays(JTriMesh(pts, tris), degree_cap=request.param)
    tg = TP.mesh_to_graph_arrays(TP.TriMesh(pts, tris), degree_cap=request.param,
                                 device="cpu")
    assert jg.patch_plan is not None
    assert (request.param == 5) == (jg.overflow.shape[0] > 0)
    return jg, tg


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


def _jax_ell_op(g, pieces, c, e):
    """The JAX package's ELL filter op, as ``pyfocusr_tpu/pipeline.py:590-605``
    builds it inside ``_spectrum``."""
    sw, ov_sw, sd, mask = pieces
    alpha = 2.0 / e
    w_hat, a_diag = alpha * sw, alpha * (sd - c * mask)
    ov = g.overflow

    def op(T):
        y = a_diag[:, None] * T - jnp.einsum("nd,ndc->nc", w_hat, T[g.neighbors])
        if ov.shape[0]:
            y = y.at[ov[:, 0]].add(-(alpha * ov_sw)[:, None] * T[ov[:, 1]])
        return y

    return op


def test_operator_matches_ell_and_jax(graphs):
    jg, tg = graphs
    c, e = 0.7, 1.3
    T = np.random.default_rng(0).standard_normal((tg.n_points, 16)).astype(np.float32)
    chunk = TP.ell_filter_factory(tg.neighbors, tg.overflow, *_torch_pieces(tg))(
        torch.tensor(c), torch.tensor(e))
    got = 2.0 * chunk(torch.from_numpy(T), 1).numpy()  # t_1 = 0.5 step(T)
    pieces = _jax_pieces(jg)
    patch = np.asarray(jax.jit(JPD.patch_filter_factory(jg.patch_plan, *pieces)(c, e))(
        jnp.asarray(T)))
    ell = np.asarray(jax.jit(_jax_ell_op(jg, pieces, c, e))(jnp.asarray(T)))
    scale = np.abs(ell).max()
    np.testing.assert_allclose(got, ell, atol=OP_TOL_OF_SCALE * scale)
    np.testing.assert_allclose(got, patch, atol=OP_TOL_OF_SCALE * scale)


def _init_block(key, n, b=128):
    """The block chebyshev_eigpairs_wide draws from ``key``."""
    _, k0 = jax.random.split(key)
    return np.asarray(jax.random.normal(k0, (n, b), dtype=jnp.float32))


def test_spectrum_matches_jax_with_its_plan(graphs):
    jg, tg = graphs
    cfg = JP.PipelineConfig()
    key = jax.random.PRNGKey(0)
    want_l, want_v, _ = JP._spectrum(jg, K, key, cfg)
    want_l, want_v = np.asarray(want_l), np.asarray(want_v)
    tcfg = TP.config_from_dict(dataclasses.asdict(cfg))
    start = torch.from_numpy(_init_block(key, tg.n_points).copy())
    got_l, got_v, _ = TP._spectrum(tg, K, tcfg, start)
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=LAM_RTOL)
    for col in range(K):
        a = want_v[:, col] - want_v[:, col].mean()
        b = got_v[:, col].numpy() - got_v[:, col].numpy().mean()
        cos = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= COS_MIN, (col, cos)


def test_graph_from_jax_fields_ignores_the_plan(graphs):
    jg, tg = graphs
    fields = dataclasses.asdict(jg)
    assert fields["patch_plan"] is not None
    with_plan = TP.graph_arrays_from_numpy(fields, device="cpu")
    without = TP.graph_arrays_from_numpy(
        {k: v for k, v in fields.items() if k != "patch_plan"}, device="cpu")
    for name in TP.TENSOR_FIELDS:
        got = getattr(with_plan, name)
        assert torch.equal(got, getattr(without, name)), name
        assert torch.equal(got, getattr(tg, name)), name


def test_stack_and_lane_give_back_every_field(mesh_5k_target):
    pts, tris = np.asarray(mesh_5k_target.points), np.asarray(mesh_5k_target.triangles)
    cohort = [TP.mesh_to_graph_arrays(TP.TriMesh(pts * scale, tris), device="cpu",
                                      node_features=pts[:, 0] * scale)
              for scale in (1.0, 1.01)]
    stacked = stack_graph_arrays(cohort)
    assert stacked.points.shape == (2, len(pts), 3)
    for i, g in enumerate(cohort):
        lane = _lane(stacked, i)
        for name in TP.TENSOR_FIELDS:
            assert torch.equal(getattr(lane, name), getattr(g, name)), (i, name)


def _spectrum_graph(name, mesh):
    if name == "hub":
        g = TP.mesh_to_graph_arrays(chip_smoke.uv_sphere(TP, *chip_smoke.CHEB_HUB),
                                    device="cpu")
        assert g.overflow.shape[0] > 0
        return g
    g = TP.mesh_to_graph_arrays(TP.TriMesh(np.asarray(mesh.points),
                                           np.asarray(mesh.triangles)), device="cpu")
    if name == "padded":
        n, d = g.neighbors.shape
        g = TP._pad_graph_arrays(g, n + 37, d + 2, g.null_indicators.shape[1] + 1)
    return g


@pytest.mark.parametrize("name", ["unpadded", "padded", "hub"])
def test_cpu_spectrum_runs_every_chunk_through_chebyshev_ell(monkeypatch, mesh_5k_target,
                                                             name):
    g = _spectrum_graph(name, mesh_5k_target)
    cfg = TP.PipelineConfig()
    assert TP._solver(cfg, g.n_points) == "wide"
    real, degrees = TP.chebyshev_ell, []
    monkeypatch.setattr(TP, "chebyshev_ell",
                        lambda X, deg, *a: degrees.append(deg) or real(X, deg, *a))
    start = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (g.n_points, cfg.eig_wide_block)).astype(np.float32))
    with spans.call() as rec:
        rec.stage("spectra")
        lams, _, _ = TP._spectrum(g, K, cfg, start, extra_chunks=2)
    (solve,) = rec.solves
    assert solve["chunks"] == cfg.eig_wide_chunks + solve["top_up_chunks"]
    assert degrees == [cfg.eig_wide_degree] * solve["chunks"]
    assert bool(torch.isfinite(lams).all()) and rec.total("cheb_steps_fused") == 0
