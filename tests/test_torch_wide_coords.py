"""Port parity for the class API's output stage with wide spectral
coordinates: ``Focusr(n_spectral_features=14 | 16,
include_points_as_features=True).align_maps()`` (D = 17 | 19 coordinates,
past the 16 of the k-NN kernel), then
``get_weighted_final_node_locations(n_closest_pts=8)``,
``transfer_point_data`` and a ``save_mesh`` / ``load_mesh`` round trip,
against ``pyfocusr_tpu`` on the 642-vertex synthetic bone pair (seeds 2
target, 1 source) from the same draws.

Where D > 16 the initial correspondences take the port of JAX's XLA path
(``ops/knn.nn_tiled``, the matmul identity in full f32), as JAX's do; the
CPD runs stay dense at 642 points (the streamed E-step's D > 16 instance
is held in ``tests/test_torch_cpd.py``).

Gates, and why (``tests/test_torch_focusr.py``'s module docstring has the
measurements):
* both packages start from JAX's eigenpairs (``jax_spectra_in_port``):
  the two ``eigh`` choose different eigenvector signs and the eigsort is
  not sign-invariant, so weighted coordinates from each package's own
  spectra match at quality level only; from the same eigenpairs the final
  correspondences are >= 95% equal, the unique fractions within 0.02, and
  the registrations' symmetric surface distances within 0.05 mm.  CPD
  stops at 1e-6 (at 1e-8 the stop sits in f32 noise);
* the k = 8 weighted final locations from the same smoothed target and
  projected source: JAX's query taken by the route it takes on a TPU (its
  Pallas kernel in interpret mode, the port's direct differences), so the
  same neighbours and the locations within 1e-5 of the coordinates' scale
  (the two sum the weighted mean in other orders);
* the transferred thickness from the same correspondences and geometry,
  'nearest' equal, 'idw' within 1e-5 of its scale.
"""

import numpy as np
import pytest
import torch

import pyfocusr_tpu_torch as TP
from pyfocusr_tpu.mesh import load_mesh as j_load_mesh
from pyfocusr_tpu.ops import pallas_kernels as JPK
from pyfocusr_tpu_torch.ops import knn as TK
from test_torch_focusr import (  # noqa: F401  (fixtures)
    FEATURE,
    STOP,
    _bones,
    _check_focusr,
    _focusr_pair,
    jax_draws_in_port,
    jax_spectra_in_port,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bones_642():
    return _bones(3)


def _take_jax_geometry(got, want):
    """The port's object takes JAX's correspondences, smoothed target and
    projected source: the final locations and the transfer are then
    computed from the same inputs."""
    for name in ("smoothed_target_coords", "source_projected_on_target"):
        setattr(got, name, torch.tensor(np.asarray(getattr(want, name))))
    got.corresponding_target_idx_for_each_source_pt = np.asarray(
        want.corresponding_target_idx_for_each_source_pt)


@pytest.mark.parametrize("n_spectral", [14, 16])
def test_wide_coordinates_focusr_matches_jax(bones_642, jax_draws_in_port,
                                             jax_spectra_in_port, n_spectral, capsys,
                                             monkeypatch, tmp_path):
    kw = dict(STOP, n_spectral_features=n_spectral, include_points_as_features=True)
    tiled = []
    real_tiled = TK.nn_tiled
    monkeypatch.setattr(TK, "nn_tiled", lambda r, q: tiled.append(r.shape) or real_tiled(r, q))
    got, want = _focusr_pair(bones_642, kw, "align_maps")
    capsys.readouterr()
    assert got.source_spectral_coords.shape[1] == n_spectral + 3 > 16
    assert tiled and all(shape[1] == n_spectral + 3 for shape in tiled), tiled
    _check_focusr(got, want, quality_only=False)
    qt, qj = got.registration_quality(), want.registration_quality()
    assert abs(qt["symmetric_surface_dist_mm"] - qj["symmetric_surface_dist_mm"]) <= 0.05

    # JAX's k-NN from here on as on a TPU (``test_torch_transfer``'s
    # jax_kernel_route, taken only now: in interpret mode JAX's ICP inside
    # align_maps would take minutes).
    real_pallas = JPK.knn_pallas
    monkeypatch.setenv("PYFOCUSR_TPU_KNN", "pallas")
    monkeypatch.setattr(JPK, "knn_pallas",
                        lambda ref, query, k: real_pallas(ref, query, k, interpret=True))
    _take_jax_geometry(got, want)
    got.get_weighted_final_node_locations(n_closest_pts=8)
    want.get_weighted_final_node_locations(n_closest_pts=8)
    w = np.asarray(want.weighted_avg_transformed_points)
    np.testing.assert_allclose(got.weighted_avg_transformed_points.numpy(), w,
                               rtol=0, atol=1e-5 * np.abs(w).max())

    for method in ("idw", "nearest"):
        g = got.transfer_point_data(names=[FEATURE], method=method)[FEATURE]
        j = np.asarray(want.transfer_point_data(names=[FEATURE], method=method)[FEATURE])
        if method == "nearest":
            np.testing.assert_array_equal(g, j)
        else:
            np.testing.assert_allclose(g, j, rtol=0, atol=1e-5 * np.abs(j).max())

    for ext in (".vtk", ".vtp"):
        path = str(tmp_path / f"avg{ext}")
        avg = got.get_average_shape()
        TP.save_mesh(path, avg)
        back, jback = TP.load_mesh(path), j_load_mesh(path)
        np.testing.assert_array_equal(back.points, np.asarray(jback.points))
        np.testing.assert_allclose(back.points, avg.points.numpy(), rtol=1e-6, atol=1e-5)
