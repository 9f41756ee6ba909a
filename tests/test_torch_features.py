"""Port parity for the three node-feature flags of ``PipelineConfig``:
``use_features_as_coords`` (smoothed, rescaled features appended to the
spectral coordinates, ``pyfocusr_tpu/pipeline.py:1563-1590``),
``use_features_in_graph`` (G of L = G (D - W) from the features, :527-540)
and ``include_features_in_adj_matrix`` (edge weights on xyz and the
features, :514-522), on the 2562-vertex synthetic bone pair with its
``thickness_change_(mm)`` scalar as the one feature.

Each flag's ``register_pair`` runs in both packages from the same draws
(``_jax_draws``) under the gates of ``tests/test_torch_pipeline.py``
(``_check_slice``); ``_spectrum`` alone under the two flags that change the
operator is held to eigenvalues rtol 1e-4 and |cos| >= 0.9999 from one
starting block, as ``tests/test_torch_eigen.py`` holds the plain operator.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pyfocusr_tpu import pipeline as JP
from test_torch_pipeline import FAST, _check_slice, _eig_block, _fields, _jax_draws
import pyfocusr_tpu_torch as TP

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
FEATURE = "thickness_change_(mm)"
FLAGS = ("use_features_as_coords", "use_features_in_graph",
         "include_features_in_adj_matrix")


@pytest.fixture(scope="module")
def graphs(mesh_5k_target, mesh_5k_source):
    """(JAX target, JAX source, port target, port source), each with the
    mesh's thickness scalar as its node feature."""
    tg, sg = (JP.mesh_to_graph_arrays(m, node_features=m.point_data[FEATURE],
                                      patch_blocks=False)
              for m in (mesh_5k_target, mesh_5k_source))
    assert tg.node_features.shape == (tg.n_points, 1)
    return (tg, sg, *(TP.graph_arrays_from_numpy(_fields(g), device="cpu")
                      for g in (tg, sg)))


@pytest.mark.parametrize("flag", FLAGS)
def test_feature_flag_matches_jax(graphs, flag):
    tg, sg, ttg, tsg = graphs
    kw = dict(FAST, **{flag: True})
    jcfg = JP.PipelineConfig(**kw)
    want = {k: np.asarray(v) for k, v in JP.register_pair(tg, sg, jcfg, KEY).items()}
    got = TP.register_pair(ttg, tsg, TP.PipelineConfig(**kw),
                           draws=_jax_draws(KEY, jcfg, tg, sg))
    _check_slice(want, got)
    k_use = jcfg.n_spectral_features
    n_cols = k_use + (1 if flag == "use_features_as_coords" else 0)
    assert got["spectral_coords_source"].shape[1] == n_cols
    if flag == "use_features_as_coords":
        # The appended column spans [0, ptp of the spectral columns].
        col = got["spectral_coords_source"][:, k_use]
        spec = got["spectral_coords_source"][:, :k_use]
        assert float(col.min()) == 0.0
        assert float(col.max()) == pytest.approx(float(spec.max() - spec.min()),
                                                 rel=1e-6)


@pytest.mark.parametrize("flag", FLAGS[1:])
def test_feature_spectrum_matches_jax(graphs, flag):
    """The operator the flag builds: the same eigenpairs from one block,
    and not those of the feature-free operator."""
    tg, _, ttg, _ = graphs
    k = JP.PipelineConfig().n_total
    key = jax.random.PRNGKey(3)
    jcfg = JP.PipelineConfig(**{flag: True})
    jl, jv, _ = JP._spectrum(tg, k, key, jcfg)
    block = torch.tensor(_eig_block(key, tg.n_points, jcfg))
    tl, tv, _ = TP.pipeline._spectrum(ttg, k, TP.PipelineConfig(**{flag: True}), block)
    jl, jv = np.asarray(jl), np.asarray(jv)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4)
    for c in range(k):
        a = jv[:, c] - jv[:, c].mean()
        b = tv[:, c].numpy() - tv[:, c].numpy().mean()
        cos = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.9999, (c, cos)
    plain, _, _ = TP.pipeline._spectrum(ttg, k, TP.PipelineConfig(), block)
    assert not np.allclose(plain.numpy(), jl, rtol=1e-2)


def test_feature_count_mismatch_raises_as_jax(graphs):
    tg, sg, ttg, tsg = graphs
    two = np.concatenate([np.asarray(sg.node_features)] * 2, axis=1)
    sg2 = dataclasses.replace(sg, node_features=jax.numpy.asarray(two))
    tsg2 = dataclasses.replace(tsg, node_features=torch.tensor(two))
    kw = dict(FAST, use_features_as_coords=True)
    with pytest.raises(Exception, match="dont match") as want:
        JP.register_pair(tg, sg2, JP.PipelineConfig(**kw), KEY)
    with pytest.raises(ValueError, match="dont match") as got:
        TP.register_pair(ttg, tsg2, TP.PipelineConfig(**kw))
    assert str(got.value) == str(want.value)


def test_mesh_to_graph_arrays_feature_layouts(mesh_5k_target):
    """[N], [N, K] and [K, N] features, as the JAX package accepts them."""
    mesh = TP.TriMesh(np.asarray(mesh_5k_target.points),
                      np.asarray(mesh_5k_target.triangles))
    f = np.asarray(mesh_5k_target.point_data[FEATURE])
    two = np.stack([f, 2 * f], axis=1)
    for given, want in ((None, np.zeros((len(f), 0))), (f, f[:, None]),
                        (two, two), (two.T, two)):
        got = TP.mesh_to_graph_arrays(mesh, node_features=given, device="cpu")
        np.testing.assert_array_equal(got.node_features.numpy(), want)
        jg = JP.mesh_to_graph_arrays(mesh_5k_target, node_features=given,
                                     patch_blocks=False)
        np.testing.assert_array_equal(np.asarray(jg.node_features), want)
