"""Port parity for the vertex-sharded fine refine:
``pyfocusr_tpu_torch.parallel.bigmesh`` on four gloo ranks on the CPU
(``parallel/distributed.spawn``) against ``pyfocusr_tpu.parallel.bigmesh``
on JAX's virtual 8-device CPU mesh (``tests/conftest.py``), on
``tests/test_bigmesh.py``'s sphere pair (182 vertices: not divisible by
four, so the rows are padded).

Gates are ``tests/test_bigmesh.py``'s: correspondences agree on >= 99% of
vertices, the float keys within rtol 2e-4 / atol 2e-5; without smoothing
the correspondences are equal.  JAX's k = 3 query takes the route it takes
on a TPU, its Pallas kernel (here in interpret mode): the direct
differences the port computes.  Its CPU route, the matmul identity, breaks
the sphere's many equal-distance ties the other way (measured: 5% of the
weighted points off by up to 0.05 without smoothing).  Cases: both smoothing methods, hub
overflow (``degree_cap=6``), no smoothing.  The port's sharded refine is
also held to its one-device refine (``multires._refine_fine_level``) at
the same gates, every rank must return the same arrays, and the planning
helpers equal JAX's arrays exactly.

The ranks run in one spawned group for the whole file (``ranks``
fixture); this module imports no JAX at its top, because every rank
imports it to find its function.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch.mesh import build_topology
from pyfocusr_tpu_torch.multires import _refine_fine_level
from pyfocusr_tpu_torch.parallel import bigmesh as TB
from pyfocusr_tpu_torch.parallel import distributed

torch.set_num_threads(1)

N_RANKS = 4
CFG_KW = dict(graph_smoothing_iterations=25, projection_smooth_iterations=4)
# name -> (degree cap, config changes): test_bigmesh.py's four refines.
CASES = {
    "chebyshev": (24, dict(smoothing_method="chebyshev")),
    "exact": (24, dict(smoothing_method="exact")),
    "hub_overflow": (6, {}),
    "no_smoothing": (24, dict(smooth_correspondences=False)),
}
FLOAT_KEYS = ("weighted_points", "average_points", "smoothed_target_coords",
              "source_projected_on_target")


def _sphere(warp=0.0):
    """test_bigmesh.py's sphere: tests/test_curvature_icp.make_sphere
    (10 x 20, 182 vertices), optionally warped."""
    from test_curvature_icp import make_sphere

    pts, tris = make_sphere(n_theta=10, n_phi=20, r=1.0)
    if warp:
        pts = pts * (1.0 + warp * np.sin(3.0 * pts[:, [1]]))
    return np.asarray(pts, np.float32), np.asarray(tris)


def _port_graph(pts, tris, cap):
    return TP.mesh_to_graph_arrays(
        TP.TriMesh(pts, tris), device="cpu",
        topology=build_topology(tris, pts.shape[0], degree_cap=cap))


def _to_numpy(res):
    return {k: v.numpy() for k, v in res.items()}


def _rank_refines(inputs):
    """One rank: every case's sharded refine, and the error of a two-axis
    mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (N_RANKS,), mesh_dim_names=("verts",))
    out = {name: _to_numpy(TB.refine_fine_level_sharded(tg, sg, init, cfg, mesh))
           for name, (tg, sg, init, cfg) in inputs.items()}
    mesh2 = init_device_mesh("cpu", (2, N_RANKS // 2), mesh_dim_names=("verts", "model"))
    tg, sg, init, cfg = inputs["chebyshev"]
    try:
        TB.refine_fine_level_sharded(tg, sg, init, cfg, mesh2)
        out["two_axes"] = None
    except ValueError as exc:
        out["two_axes"] = str(exc)
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX's target, source, initial correspondences) per degree cap, and
    the port's graphs of the same meshes."""
    import jax.numpy as jnp

    from pyfocusr_tpu.mesh import TriMesh as JTriMesh
    from pyfocusr_tpu.ops.knn import SENTINEL, nn_query
    from pyfocusr_tpu.pipeline import mesh_to_graph_arrays

    (tp_, tt), (sp, st) = _sphere(), _sphere(warp=0.06)
    out = {}
    for cap in (24, 6):
        jt = mesh_to_graph_arrays(JTriMesh(jnp.asarray(tp_), jnp.asarray(tt)), degree_cap=cap)
        js = mesh_to_graph_arrays(JTriMesh(jnp.asarray(sp), jnp.asarray(st)), degree_cap=cap)
        _, init = nn_query(jnp.where(jt.valid_mask[:, None] > 0, jt.points, SENTINEL), js.points)
        out[cap] = (jt, js, np.asarray(init), _port_graph(tp_, tt, cap),
                    _port_graph(sp, st, cap))
    return out


def _port_inputs(pair):
    return {name: (pair[cap][3], pair[cap][4], torch.from_numpy(pair[cap][2].copy()),
                   TP.PipelineConfig(**CFG_KW, **kw))
            for name, (cap, kw) in CASES.items()}


@pytest.fixture(scope="module")
def ranks(pair):
    return distributed.spawn(_rank_refines, N_RANKS, args=(_port_inputs(pair),), threads=1)


def _compare(ref, got):
    agree = np.mean(np.asarray(ref["correspondences"]) == got["correspondences"])
    assert agree >= 0.99, f"correspondence agreement {agree}"
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(np.asarray(ref[k]), got[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


@pytest.fixture
def jax_kernel_route(monkeypatch):
    """JAX's k-NN queries through its Pallas kernel in interpret mode, in
    programs traced afresh (JAX caches its sharded refines per config)."""
    from pyfocusr_tpu.ops import pallas_kernels as JPK
    from pyfocusr_tpu.parallel import bigmesh as JB

    real = JPK.knn_pallas
    monkeypatch.setenv("PYFOCUSR_TPU_KNN", "pallas")
    monkeypatch.setattr(JPK, "knn_pallas",
                        lambda ref, query, k: real(ref, query, k, interpret=True))
    monkeypatch.setattr(JB, "_PROGRAM_CACHE", {})


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_refine_matches_jax_sharded(pair, ranks, name, jax_kernel_route):
    import jax
    from jax.sharding import Mesh

    from pyfocusr_tpu import pipeline as JP
    from pyfocusr_tpu.parallel.bigmesh import refine_fine_level_sharded

    cap, kw = CASES[name]
    jt, js, init = pair[cap][:3]
    assert jt.n_points % N_RANKS != 0  # the rows are padded
    if name == "hub_overflow":
        assert int(jt.overflow.shape[0]) > 0
    mesh8 = Mesh(np.asarray(jax.devices()[:8]).reshape(8), ("verts",))
    want = refine_fine_level_sharded(jt, js, init, JP.PipelineConfig(**CFG_KW, **kw), mesh8)
    got = ranks[0][name]
    _compare(want, got)
    if name == "no_smoothing":
        np.testing.assert_array_equal(np.asarray(want["correspondences"]),
                                      got["correspondences"])
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == np.asarray(want[k]).shape, k


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_refine_matches_port_one_device(pair, ranks, name):
    cap, kw = CASES[name]
    tg, sg, init, cfg = _port_inputs(pair)[name]
    want = _to_numpy(_refine_fine_level(tg, sg, init, cfg))
    got = ranks[0][name]
    assert list(got) == list(want)
    _compare(want, got)
    np.testing.assert_array_equal(want["initial_correspondences"],
                                  got["initial_correspondences"])


def test_every_rank_returns_the_global_arrays(ranks):
    for other in ranks[1:]:
        for name in CASES:
            for k, v in ranks[0][name].items():
                np.testing.assert_array_equal(v, other[name][k], err_msg=f"{name} {k}")


def test_two_axis_mesh_raises_jax_message(ranks):
    import jax
    from jax.sharding import Mesh

    from pyfocusr_tpu import pipeline as JP
    from pyfocusr_tpu.mesh import TriMesh as JTriMesh
    from pyfocusr_tpu.parallel.bigmesh import refine_fine_level_sharded

    pts, tris = _sphere()
    g = JP.mesh_to_graph_arrays(JTriMesh(pts, tris))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("verts", "model"))
    with pytest.raises(ValueError) as want:
        refine_fine_level_sharded(g, g, np.zeros(g.n_points, np.int32), JP.PipelineConfig(),
                                  mesh)
    assert all(r["two_axes"] == str(want.value) for r in ranks)


def _jax_graph_fields(g):
    return {f.name: np.asarray(getattr(g, f.name)) for f in dataclasses.fields(g)
            if f.name != "patch_plan" and getattr(g, f.name) is not None}


@pytest.mark.parametrize("n_shards", [8, 7, 13])
def test_pad_rows_for_sharding_matches_jax(pair, n_shards):
    from pyfocusr_tpu.parallel.bigmesh import pad_rows_for_sharding

    jt, port = pair[6][0], pair[6][3]
    want, n_want = pad_rows_for_sharding(jt, n_shards)
    got, n_got = TB.pad_rows_for_sharding(port, n_shards)
    assert n_got == n_want == port.n_points
    assert got.n_points % n_shards == 0
    for name, w in _jax_graph_fields(want).items():
        g = getattr(got, name).numpy()
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)


def _overflow_cases():
    rng = np.random.default_rng(0)
    e = rng.integers(0, 64, size=(37, 2))
    e = e[e[:, 0] != e[:, 1]]
    with_pad = np.concatenate([e, [[5, 5], [40, 40]]])
    return {"random": (e, 64, 8), "padding_rows": (with_pad, 64, 8),
            "empty": (np.zeros((0, 2), np.int64), 64, 8), "one_shard": (e, 64, 1),
            "skewed": (np.stack([np.zeros(9, np.int64), np.arange(1, 10)], 1), 60, 4)}


@pytest.mark.parametrize("name", sorted(_overflow_cases()))
def test_partition_overflow_by_owner_matches_jax(name):
    import jax.numpy as jnp

    from pyfocusr_tpu.parallel.bigmesh import partition_overflow_by_owner

    e, n_rows, n_shards = _overflow_cases()[name]
    want = np.asarray(partition_overflow_by_owner(jnp.asarray(e, jnp.int32), n_rows, n_shards))
    got = TB.partition_overflow_by_owner(torch.from_numpy(np.asarray(e, np.int64)), n_rows,
                                         n_shards)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
