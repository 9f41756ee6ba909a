"""Port parity: ``pyfocusr_tpu_torch.ops.graph_ops`` against
``pyfocusr_tpu.ops.graph_ops`` on the same graphs — the 2562-vertex
synthetic bone mesh (``mesh_5k_source``) and a UV sphere whose poles spill
hub-vertex overflow edges past the degree cap.

Tolerance rtol 1e-5: both sides evaluate the same f32 formulas, but the
gather-einsum reductions and the overflow scatter-adds sum in a different
order (and on CUDA the port's ``index_add_`` uses atomics, whose order
changes from run to run), so results agree to a few f32 ulps per term, not
bitwise.  Iterated operators (smoothing) get the same relative bound.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfocusr_tpu.mesh import build_topology
from pyfocusr_tpu.ops import graph_ops as JG
from pyfocusr_tpu_torch.ops import graph_ops as TG

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RTOL = 1e-5


def _graph(points, tris, degree_cap=24):
    topo = build_topology(np.asarray(tris), len(points), degree_cap=degree_cap)
    pts = np.asarray(points, np.float32)
    return {
        "pts": pts,
        "nbrs": topo.neighbors,
        "mask": topo.nbr_mask,
        "ov": topo.overflow_edges,
    }


@pytest.fixture(scope="module", params=["bone", "uv_sphere"])
def graph(request, mesh_5k_source):
    if request.param == "bone":
        return _graph(mesh_5k_source.points, mesh_5k_source.triangles)
    from test_curvature_icp import make_sphere

    pts, tris = make_sphere(n_theta=16, n_phi=48)
    g = _graph(pts * 10.0, tris)
    assert g["ov"].shape[0] > 0  # the pole degree (48) exceeds the cap
    return g


def _both(g):
    j = {k: jnp.asarray(v) for k, v in g.items()}
    t = {k: torch.tensor(v) for k, v in g.items()}
    t["nbrs"] = t["nbrs"].long()
    t["ov"] = t["ov"].long()
    return j, t


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _weights(j, t):
    jw = JG.edge_weights(j["pts"], j["nbrs"], j["mask"])
    jo = JG.overflow_weights(j["pts"], j["ov"])
    tw = TG.edge_weights(t["pts"], t["nbrs"], t["mask"])
    to = TG.overflow_weights(t["pts"], t["ov"])
    return (jw, jo), (tw, to)


def test_edge_and_overflow_weights(graph):
    j, t = _both(graph)
    (jw, jo), (tw, to) = _weights(j, t)
    _close(tw, jw)
    _close(to, jo)
    assert torch.all(tw[t["mask"] == 0] == 0)


def test_degree_vector(graph):
    j, t = _both(graph)
    (jw, jo), (tw, to) = _weights(j, t)
    _close(TG.degree_vector(tw, t["ov"], to), JG.degree_vector(jw, j["ov"], jo))


@pytest.mark.parametrize("cols", [0, 5])
def test_spmv(graph, cols):
    j, t = _both(graph)
    (jw, jo), (tw, to) = _weights(j, t)
    rng = np.random.default_rng(cols)
    shape = (len(graph["pts"]),) + ((cols,) if cols else ())
    x = rng.normal(size=shape).astype(np.float32)
    got = TG.spmv(t["nbrs"], tw, torch.tensor(x), t["ov"], to)
    want = JG.spmv(j["nbrs"], jw, jnp.asarray(x), j["ov"], jo)
    # A signed sum cancels: bound the error by the magnitude of its terms.
    scale = float(np.abs(np.asarray(jw)).sum(axis=1).max() * np.abs(x).max())
    _close(got, want, atol=RTOL * scale)


def test_sym_laplacian_matvec_and_quad_form(graph):
    j, t = _both(graph)
    (jw, jo), (tw, to) = _weights(j, t)
    d_j = JG.degree_vector(jw, j["ov"], jo)
    d_t = TG.degree_vector(tw, t["ov"], to)
    g_j = (d_j + JG.DEGREE_EPS) ** -1
    g_t = (d_t + TG.DEGREE_EPS) ** -1
    rng = np.random.default_rng(1)
    x = rng.normal(size=(len(graph["pts"]), 4)).astype(np.float32)
    x /= np.linalg.norm(x, axis=0, keepdims=True)
    got = TG.sym_laplacian_matvec(t["nbrs"], tw, g_t, torch.tensor(x), t["ov"], to, degrees=d_t)
    want = JG.sym_laplacian_matvec(j["nbrs"], jw, g_j, jnp.asarray(x), j["ov"], jo, degrees=d_j)
    # D x - W x cancels: absolute bound at the scale of the diagonal term.
    _close(got, want, atol=RTOL * float(np.abs(np.asarray(want)).max() + np.abs(x).max()))
    got_q = TG.sym_laplacian_quad_form(t["nbrs"], tw, torch.sqrt(g_t), torch.tensor(x), t["ov"], to)
    want_q = JG.sym_laplacian_quad_form(j["nbrs"], jw, jnp.sqrt(g_j), jnp.asarray(x), j["ov"], jo)
    _close(got_q, want_q)


@pytest.mark.parametrize("p_function", ["none", "exp", "log", "square", "shift"])
def test_g_vector(graph, p_function):
    j, t = _both(graph)
    (jw, jo), (tw, to) = _weights(j, t)
    d_j = JG.degree_vector(jw, j["ov"], jo)
    d_t = TG.degree_vector(tw, t["ov"], to)
    n = len(graph["pts"])
    rng = np.random.default_rng(4)
    feats = rng.uniform(-1, 1, size=(2, n)).astype(np.float32)
    fw = np.diag([1.0, 0.5]).astype(np.float32)
    mask = np.ones((n,), np.float32)
    mask[:3] = 0.0
    use = p_function != "none"
    pf = p_function if use else "exp"
    got = TG.g_vector(torch.tensor(feats), d_t, torch.tensor(fw), p_function=pf,
                      include_features=use, valid_mask=torch.tensor(mask))
    want = JG.g_vector(jnp.asarray(feats), d_j, jnp.asarray(fw), p_function=pf,
                       include_features=use, valid_mask=jnp.asarray(mask))
    _close(got, want)


def test_chebyshev_power_coeffs_identical():
    np.testing.assert_array_equal(
        TG._chebyshev_power_coeffs(600, 60), JG._chebyshev_power_coeffs(600, 60)
    )


@pytest.mark.parametrize("method,iters", [
    ("exact", 7), ("chebyshev", 50), ("chebyshev", 1), ("chebyshev", 0),
])
def test_mean_filters(graph, method, iters):
    j, t = _both(graph)
    (jw, jo), (tw, to) = _weights(j, t)
    vals = graph["pts"]
    if method == "exact":
        got = TG.mean_filter(t["nbrs"], tw, t["pts"], iters, t["ov"], to)
        want = JG.mean_filter(j["nbrs"], jw, j["pts"], iters, j["ov"], jo)
    else:
        got = TG.mean_filter_chebyshev(t["nbrs"], tw, t["pts"], iters, t["ov"], to)
        want = JG.mean_filter_chebyshev(j["nbrs"], jw, j["pts"], iters, j["ov"], jo)
    _close(got, want, atol=RTOL * float(np.abs(vals).max()))
    one = TG.mean_filter(t["nbrs"], tw, t["pts"][:, 0], 3, t["ov"], to)
    assert one.shape == (len(vals),)
