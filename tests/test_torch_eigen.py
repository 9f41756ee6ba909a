"""Port parity: the wide Chebyshev eigensolver of ``pyfocusr_tpu_torch``
against ``pyfocusr_tpu``'s on the 2562-vertex synthetic bone meshes, cold
and warm-started, from the same starting block, through each package's
``pipeline._spectrum`` (the fused ELL filter operator and the
cancellation-free quadratic form that ``chebyshev_eigpairs_wide`` takes).

The JAX solver draws its initial [N, 128] block from its key
(``eigen.py:404-405``); the test draws that block with ``jax.random`` from
the same key split and hands it to the port.  The warm start passes the
same x0 of width 128 to both, which replaces the whole random block, so
both solves start equal.

Gates: eigenvectors |cos| >= 0.9999 up to sign (the ROADMAP gate), on
mean-centred columns because the pipeline min-max normalizes them;
eigenvalues within rtol 1e-4 — tighter than the rtol 1e-2 that
tests/test_eigen.py:39 allows against ARPACK, since both sides solve the
same f32 operator and differ only in summation order and in the LAPACK
eigh/QR each framework calls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfocusr_tpu import pipeline as JP
from pyfocusr_tpu_torch import pipeline as TP

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

K = 6
COS_MIN = 0.9999
LAM_RTOL = 1e-4


def _to_torch(ga):
    return TP.graph_arrays_from_numpy(
        {k: np.asarray(v) for k, v in dataclasses.asdict(ga).items()},
        device="cpu",
    )


def _init_block(key, n, b=128):
    """The block chebyshev_eigpairs_wide draws from ``key``."""
    _, k0 = jax.random.split(key)
    return np.asarray(jax.random.normal(k0, (n, b), dtype=jnp.float32))


def _assert_eigpairs(got_l, got_v, want_l, want_v):
    np.testing.assert_allclose(got_l, want_l, rtol=LAM_RTOL)
    for c in range(want_v.shape[1]):
        a = want_v[:, c] - want_v[:, c].mean()
        b = got_v[:, c] - got_v[:, c].mean()
        cos = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= COS_MIN, (c, cos)


@pytest.fixture(scope="module")
def pair(mesh_5k_target, mesh_5k_source):
    # The target's ELL degree is capped at 4, so its solve also runs the
    # fused filter's hub-overflow scatter-add; the source keeps the
    # default cap (no overflow edges), like the main path's meshes.
    tg = JP.mesh_to_graph_arrays(mesh_5k_target, degree_cap=4, patch_blocks=False)
    sg = JP.mesh_to_graph_arrays(mesh_5k_source, patch_blocks=False)
    assert tg.overflow.shape[0] > 0 and sg.overflow.shape[0] == 0
    return tg, sg


@pytest.fixture(scope="module")
def cold_target(pair):
    tg, _ = pair
    cfg = JP.PipelineConfig()
    key = jax.random.PRNGKey(3)
    jl, jv, _, jblk = JP._spectrum(tg, K, key, cfg, return_block=True)
    tl, tv, _, tblk = TP._spectrum(
        _to_torch(tg), K, TP.PipelineConfig(),
        torch.tensor(_init_block(key, tg.n_points)), return_block=True,
    )
    return (np.asarray(jl), np.asarray(jv), np.asarray(jblk)), (
        tl.numpy(), tv.numpy(), tblk.numpy())


def test_cold_spectrum_matches_jax(cold_target):
    (jl, jv, jblk), (tl, tv, tblk) = cold_target
    _assert_eigpairs(tl, tv, jl, jv)
    assert tblk.shape == jblk.shape == (jv.shape[0], 128)


def test_warm_spectrum_matches_jax(pair, cold_target):
    """Source solve warm-started from the target's block (the default
    pipeline's second eigensolve), with the residual-gated top-up."""
    tg, sg = pair
    (_, _, jblk), _ = cold_target
    x0 = np.asarray(JP._warm_x0(jnp.asarray(jblk), tg.points, tg.valid_mask,
                                sg.points))
    cfg = JP.PipelineConfig()
    kw = dict(chunks=cfg.eig_wide_chunks_warm,
              extra_chunks=cfg.eig_wide_chunks - cfg.eig_wide_chunks_warm,
              degree=cfg.eig_wide_degree_warm)
    jl, jv, _ = JP._spectrum(sg, K, jax.random.PRNGKey(4), cfg,
                             x0=jnp.asarray(x0), **kw)
    tl, tv, _ = TP._spectrum(_to_torch(sg), K, TP.PipelineConfig(), None,
                             x0=torch.tensor(x0), **kw)
    _assert_eigpairs(tl.numpy(), tv.numpy(), np.asarray(jl), np.asarray(jv))


def test_warm_map_matches_jax(pair, cold_target):
    tg, sg = pair
    (_, _, jblk), _ = cold_target
    want = JP._warm_x0(jnp.asarray(jblk), tg.points, tg.valid_mask, sg.points)
    t_tg, t_sg = _to_torch(tg), _to_torch(sg)
    got = TP._warm_x0(torch.tensor(jblk), t_tg.points, t_tg.valid_mask, t_sg.points)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
