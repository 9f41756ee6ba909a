"""Port parity for ``pyfocusr_tpu_torch/experiments.py`` and the narrow
solver's union-graph mode (``ops/eigen.chebyshev_eigpairs(partition_masks=,
filter_op_factory=)``) against ``pyfocusr_tpu/experiments.py`` on the
synthetic bones: the 2562-vertex target (``tests/conftest.py:77-107``) and
the 10242-vertex seed-1 bone (``chip_smoke.synthetic_bone``) decimated to
2372 vertices, so the batched solve pads rows.

Both packages start from the same blocks: the union solve's [Nt + Ns, 2k +
8] block is JAX's ``normal(key, ...)`` (``eigen.py:583``), the batched
solves' [N_pad, 128] blocks the wide solver's draws from each key
(``eigen.py:404-405``).  Gates against JAX: eigenvalues rtol 1e-4,
eigenvectors |cos| >= 0.9999 on mean-centred columns.  The union solve
against two separate solves: JAX's gates, rtol 1e-3 and |cos| > 0.999
(``tests/test_pipeline.py:166-175``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfocusr_tpu import experiments as JX
from pyfocusr_tpu import pipeline as JP
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
import chip_smoke
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch import experiments as TX
from pyfocusr_tpu_torch.ops import eigen as TE

torch.set_num_threads(1)

K = 6
KEY = jax.random.PRNGKey(0)


def _cos_check(want, got, cos_min, what):
    for c in range(want.shape[1]):
        a = want[:, c] - want[:, c].mean()
        b = got[:, c] - got[:, c].mean()
        cos = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= cos_min, (what, c, cos)


def _fields(ga):
    return {k: np.asarray(v) for k, v in dataclasses.asdict(ga).items()
            if k != "patch_plan"}


@pytest.fixture(scope="module")
def pair(mesh_5k_target):
    """(JAX target, JAX source, port target, port source), no plans."""
    small, _, _ = TP.decimate(chip_smoke.synthetic_bone(TP, 1, 5), 2300)
    assert 2048 <= small.n_points < mesh_5k_target.n_points
    tg = JP.mesh_to_graph_arrays(mesh_5k_target, patch_blocks=False)
    sg = JP.mesh_to_graph_arrays(JTriMesh(small.points, small.triangles),
                                 patch_blocks=False)
    return (tg, sg, TP.graph_arrays_from_numpy(_fields(tg), device="cpu"),
            TP.graph_arrays_from_numpy(_fields(sg), device="cpu"))


@pytest.fixture(scope="module")
def union(pair):
    tg, sg, ttg, tsg = pair
    cfg = JP.PipelineConfig()
    want = [np.asarray(x) for x in JX.spectrum_union(tg, sg, K, KEY, cfg)]
    start = np.asarray(jax.random.normal(KEY, (tg.n_points + sg.n_points, 2 * K + 8),
                                         jnp.float32))
    got = [x.numpy() for x in TX.spectrum_union(
        ttg, tsg, K, start, TP.config_from_dict(dataclasses.asdict(cfg)))]
    return want, got


def test_spectrum_union_matches_jax(union):
    want, got = union
    assert got[0].shape == (2, K)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    _cos_check(want[1], got[1], 0.9999, "target")
    _cos_check(want[2], got[2], 0.9999, "source")


def test_spectrum_union_matches_separate_solves(pair, union):
    _, _, ttg, tsg = pair
    cfg = TP.PipelineConfig()
    _, (lams, vt, vs) = union
    for i, (g, v) in enumerate(((ttg, vt), (tsg, vs))):
        start = torch.from_numpy(np.random.default_rng(i).standard_normal(
            (g.n_points, cfg.eig_wide_block)).astype(np.float32))
        sl, sv, _ = TP.pipeline._spectrum(g, K, cfg, start)
        np.testing.assert_allclose(lams[i], sl.numpy(), rtol=1e-3)
        _cos_check(sv.numpy(), v, 0.999, i)


def test_spectrum_union_refuses_feature_graphs(pair):
    _, _, ttg, tsg = pair
    for kw in (dict(include_features_in_adj_matrix=True), dict(use_features_in_graph=True)):
        with pytest.raises(ValueError, match="xyz-only Laplacian"):
            TX.spectrum_union(ttg, tsg, K, None, TP.PipelineConfig(**kw))


def test_spectrum_batched_matches_jax(pair):
    tg, sg, ttg, tsg = pair
    cfg = JP.PipelineConfig()
    keys = jax.random.split(KEY, 2)
    want = [np.asarray(x) for x in JX.spectrum_batched(tg, sg, K, keys, cfg)]
    n_pad = max(tg.n_points, sg.n_points)
    starts = [np.asarray(jax.random.normal(jax.random.split(k)[1], (n_pad, 128), jnp.float32))
              for k in keys]
    got = [x.numpy() for x in TX.spectrum_batched(
        ttg, tsg, K, starts, TP.config_from_dict(dataclasses.asdict(cfg)))]
    assert got[1].shape == (tg.n_points, K) and got[3].shape == (sg.n_points, K)
    for i in (0, 2):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4)
        _cos_check(want[i + 1], got[i + 1], 0.9999, i)


def test_pad_graph_arrays_matches_jax(pair):
    tg, sg, ttg, tsg = pair
    shape = (2600, 9, 3, tg.overflow.shape[0] + 5)
    want = _fields(JP._pad_graph_arrays(sg, *shape))
    got = TP.pipeline._pad_graph_arrays(tsg, *shape)
    for name, arr in want.items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), arr, err_msg=name)


def test_narrow_solver_fused_factory_equals_its_matvec_filter(pair):
    """``filter_op_factory`` replaces the filter built from ``matvec``: the
    same step gives the same bits."""
    _, _, ttg, _ = pair
    g, mask = ttg, ttg.valid_mask
    w = TP.pipeline.graph_ops.edge_weights(g.points, g.neighbors, g.nbr_mask)
    d = TP.pipeline.graph_ops.degree_vector(w, g.overflow, None)
    gv = (d + TP.pipeline.graph_ops.DEGREE_EPS) ** -1

    def matvec(X):
        return TP.pipeline.graph_ops.sym_laplacian_matvec(g.neighbors, w, gv, X)

    def factory(c, e):
        return lambda T: (2.0 / e) * (matvec(T) - c * T)

    s = torch.sqrt(gv)
    null = g.null_indicators / s[:, None]
    start = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (g.n_points, K + 8)).astype(np.float32))
    kw = dict(degree=40, sweeps=3, refine_cg_iters=20, subspace_mask=mask,
              lam_max_bound=2.0)
    plain = TE.chebyshev_eigpairs(matvec, null, K, start, **kw)
    fused = TE.chebyshev_eigpairs(matvec, null, K, start, filter_op_factory=factory, **kw)
    for a, b in zip(plain, fused):
        assert torch.equal(a, b)
