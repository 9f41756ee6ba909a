"""Port parity for full-resolution CPD through ``register_pair``: the
10242-vertex synthetic pair (the 2562 pair of ``tests/conftest.py`` one
subdivision further, as ``chip_smoke.py`` builds it) with
``n_coords_spectral_registration`` = 10242, so the CPD subsample exceeds
3000^2 pairs and 8192 control points. The port then takes the streamed
E-step (``cpd_estep_kernel.cpd_estep``: its plain version on the CPU) and
the tiled Gram (``gaussian_matvec_tiled``); JAX takes ``cpd_estep_tiled``
and its own ``gaussian_matvec_tiled``.

Both sides cap CPD at 3 EM iterations (each is two passes over 10242^2
pairs; the cap keeps the two loops in step and the test near a minute), and
are fed the same draws. Gates, and why they are looser than the 2562
pair's (``tests/test_torch_pipeline.py``):
* the streamed E-step ran once per EM iteration and the tiled Gram four
  times (the subspace iteration's products);
* eigenvalues rtol 1e-4 and eigenvector |cos| >= 0.9999, as at 2562;
* the moved target spectral cloud (CPD's output) within 2e-3 up to each
  column's eigenvector sign (measured 7.5e-4);
* every initial correspondence is a nearest neighbour of both runs up to
  the coordinates' difference: JAX's pick lies within 2e-3 of the port's
  nearest distance, in the port's coordinates (measured at most 4.6e-4,
  against spectral distances ~0.2). With CPD stopped after 3 iterations
  the clouds are not yet aligned, so many targets lie at nearly the same
  distance, and 22% of the picks differ between the two runs; every
  difference is such a near-tie. The two eigensolvers' source coordinates
  differ by up to 9e-4 at 10242 vertices before CPD runs;
* final unique fraction within 0.02 (measured 0.012), |delta
  weighted_points| median <= 0.15 mm and mean <= 0.25 mm (measured 0.068
  and 0.137; a changed correspondence moves a point by up to an edge,
  ~1 mm at this resolution).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pyfocusr_tpu import pipeline as JP
from pyfocusr_tpu.mesh import TriMesh
from test_torch_pipeline import FAST, _check_spectra, _run_both
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch.ops import cpd as TC
from pyfocusr_tpu_torch.ops import cpd_estep_kernel as EK

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

EM_CAP = 3
FULLRES = dict(FAST, n_coords_spectral_registration=10242,
               non_rigid_max_iterations=EM_CAP, non_rigid_alpha=0.1)


def _bone_10242(seed: int):
    """``chip_smoke.py``'s 10242-vertex synthetic bone (the formula of
    ``tests/conftest.py`` with five subdivisions) as the JAX package's
    ``TriMesh``."""
    mesh = chip_smoke.synthetic_bone(TP, seed)
    return TriMesh(np.asarray(mesh.points), np.asarray(mesh.triangles), {})


@pytest.fixture(scope="module")
def fullres_runs():
    pair = tuple(JP.mesh_to_graph_arrays(_bone_10242(seed), patch_blocks=False)
                 for seed in (2, 1))
    assert pair[0].n_points == 10242
    calls = {"estep": 0, "gram": 0}
    estep, gram = EK.cpd_estep_plain, TC.gaussian_matvec_tiled

    def counted_estep(*a, **k):
        calls["estep"] += 1
        return estep(*a, **k)

    def counted_gram(*a, **k):
        calls["gram"] += 1
        return gram(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(EK, "cpd_estep_plain", counted_estep)
        mp.setattr(TC, "gaussian_matvec_tiled", counted_gram)
        want, got = _run_both(pair, FULLRES)
    return want, got, calls


def test_fullres_register_pair_matches_jax(fullres_runs):
    want, got, calls = fullres_runs
    assert calls == {"estep": EM_CAP, "gram": 4}
    assert set(got) == set(want)
    g = {k: v.numpy() for k, v in got.items()}
    _check_spectra(want, g)
    a, b = g["spectral_coords_target"], want["spectral_coords_target"]
    np.testing.assert_allclose(a * np.sign((a * b).sum(axis=0)), b, atol=2e-3)
    src, tgt = g["spectral_coords_source"], g["spectral_coords_target"]
    cj, ct = want["initial_correspondences"], g["initial_correspondences"]
    gap = (np.linalg.norm(src - tgt[cj], axis=1)
           - np.linalg.norm(src - tgt[ct], axis=1))
    assert gap.max() <= 2e-3, (gap.max(), (cj != ct).mean())
    n = len(want["correspondences"])
    uj = len(np.unique(want["correspondences"])) / n
    ut = len(np.unique(g["correspondences"])) / n
    assert abs(uj - ut) <= 0.02, (uj, ut)
    dw = np.linalg.norm(g["weighted_points"] - want["weighted_points"], axis=1)
    assert np.median(dw) <= 0.15 and dw.mean() <= 0.25, (np.median(dw), dw.mean())
    assert np.all(np.isfinite(g["weighted_points"]))
