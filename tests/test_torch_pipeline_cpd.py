"""Port parity for the CPD configurations of ``register_pair`` on the
2562-vertex synthetic pair: the affine pre-pass
(``rigid_before_non_rigid_reg``), landmarks (MAP CPD, with
``landmark_pairs_from_positions``) and xyz appended as features (both
``norm_physical_and_spectral`` branches, D = 6 in CPD), against
``pyfocusr_tpu.pipeline.register_pair`` fed the same draws.

The gates are those of ``tests/test_torch_pipeline.py`` (``_check_slice``:
eigenpairs, >= 95% equal final correspondences, unique fraction within
0.02, weighted points median <= 1e-3 mm and mean <= 0.1 mm), with the CPD
stop tolerance at 1e-6 for the reason given there. The affine pre-pass
moves the whole target spectral cloud, so its runs are also held on the
moved cloud (``spectral_coords_target``) to 1e-3, up to each column's
eigenvector sign. Snap distances of ``landmark_pairs_from_positions`` are
held to 1e-3 mm: JAX's XLA nearest-neighbour distances carry the matmul
identity's error (~1e-4 mm^2 in d^2 at |x|^2 ~ 1.4e3 mm^2, measured 3.9e-4
mm at 0.3 mm); the snapped vertices are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfocusr_tpu import pipeline as JP
from test_torch_pipeline import FAST, _check_slice, _run_both
import pyfocusr_tpu_torch as TP

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

CONFIGS = {
    "affine_prepass": dict(FAST, rigid_before_non_rigid_reg=True,
                           rigid_tolerance=1e-6),
    "xyz_features_normed": dict(FAST, include_points_as_features=True),
    "xyz_features_physical": dict(FAST, include_points_as_features=True,
                                  norm_physical_and_spectral=False),
}

# Landmark vertices: the two meshes share the icosphere's vertex order, so
# one index names roughly corresponding points on both.
LANDMARK_VERTS = np.array([0, 11, 640, 1300, 2561])


@pytest.fixture(scope="module")
def jax_pair(mesh_5k_target, mesh_5k_source):
    return (JP.mesh_to_graph_arrays(mesh_5k_target, patch_blocks=False),
            JP.mesh_to_graph_arrays(mesh_5k_source, patch_blocks=False))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def config_runs(request, jax_pair):
    return request.param, _run_both(jax_pair, CONFIGS[request.param])


def test_cpd_configurations_match_jax(config_runs):
    name, (want, got) = config_runs
    g = _check_slice(want, got)
    if name.startswith("xyz"):  # xyz columns reached CPD and the outputs
        assert g["spectral_coords_source"].shape[1] == 6
    if name == "affine_prepass":
        # Up to the eigenvector sign each framework's eigh picked per column
        # (the affine map B absorbs it).
        a, b = g["spectral_coords_target"], want["spectral_coords_target"]
        sign = np.sign((a * b).sum(axis=0))
        np.testing.assert_allclose(a * sign, b, atol=1e-3)


def test_landmark_pairs_from_positions_matches_jax(mesh_5k_target, mesh_5k_source):
    rng = np.random.default_rng(3)
    sp = (np.asarray(mesh_5k_source.points)[LANDMARK_VERTS]
          + rng.normal(scale=0.3, size=(5, 3))).astype(np.float32)
    tp = (np.asarray(mesh_5k_target.points)[LANDMARK_VERTS]
          + rng.normal(scale=0.3, size=(5, 3))).astype(np.float32)
    want_pairs, want_d = JP.landmark_pairs_from_positions(mesh_5k_source,
                                                          mesh_5k_target, sp, tp)
    got_pairs, got_d = TP.landmark_pairs_from_positions(mesh_5k_source,
                                                        mesh_5k_target, sp, tp,
                                                        device="cpu")
    assert got_pairs.dtype == torch.int64 and got_pairs.device.type == "cpu"
    np.testing.assert_array_equal(got_pairs.numpy(), np.asarray(want_pairs))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-3)
    with pytest.raises(ValueError, match=r"\[L, 3\]"):
        TP.landmark_pairs_from_positions(mesh_5k_source, mesh_5k_target, sp,
                                         tp[:4], device="cpu")


@pytest.fixture(scope="module")
def landmark_runs(jax_pair, mesh_5k_target, mesh_5k_source):
    pairs, _ = TP.landmark_pairs_from_positions(
        mesh_5k_source, mesh_5k_target,
        np.asarray(mesh_5k_source.points)[LANDMARK_VERTS],
        np.asarray(mesh_5k_target.points)[LANDMARK_VERTS], device="cpu")
    return pairs.numpy(), _run_both(jax_pair, FAST, landmark_pairs=pairs.numpy())


def test_landmarks_match_jax(landmark_runs):
    pairs, (want, got) = landmark_runs
    np.testing.assert_array_equal(pairs, np.stack([LANDMARK_VERTS] * 2, axis=1))
    _check_slice(want, got)


def test_landmark_pairs_are_validated(jax_pair):
    tg, sg = jax_pair

    def fields(ga):
        return {k: np.asarray(v) for k, v in dataclasses.asdict(ga).items()
                if k != "patch_plan"}

    t = TP.graph_arrays_from_numpy(fields(tg), device="cpu")
    s = TP.graph_arrays_from_numpy(fields(sg), device="cpu")
    cfg = TP.PipelineConfig(n_coords_spectral_registration=4)
    with pytest.raises(ValueError, match="fewer than"):
        TP.register_pair(t, s, cfg, landmark_pairs=np.zeros((4, 2), np.int64))
    with pytest.raises(ValueError, match=r"\[L, 2\]"):
        TP.register_pair(t, s, cfg, landmark_pairs=np.zeros((3,), np.int64))
    with pytest.raises(ValueError, match="fewer than"):  # a tensor, as built
        TP.register_pair(t, s, cfg, landmark_pairs=torch.zeros((4, 2), dtype=torch.int64))
    draws = TP.make_draws(0, TP.PipelineConfig(), t.n_points, s.n_points)
    with pytest.raises(ValueError, match="cpd_target"):  # sized for no landmarks
        TP.register_pair(t, s, TP.PipelineConfig(), draws=draws,
                         landmark_pairs=np.zeros((3, 2), np.int64))
    with_lm = TP.make_draws(0, TP.PipelineConfig(), t.n_points, s.n_points,
                            n_landmarks=3)
    assert with_lm["cpd_target"].shape == (997,)
    assert with_lm["cpd_source"].shape == (1000,)
    # JAX raises the same way when the landmarks fill the subsample.
    with pytest.raises(ValueError, match="fewer than"):
        JP.register_pair(tg, sg, JP.PipelineConfig(n_coords_spectral_registration=4),
                         jax.random.PRNGKey(0),
                         landmark_pairs=jnp.zeros((4, 2), jnp.int32))
