"""The ``pyfocusr_torch`` drop-in alias: the three tests of
``tests/test_pyfocusr_alias.py`` on the port (every import style of the
reference's ``pyfocusr`` resolves to ``pyfocusr_tpu_torch``; the reference
notebook's construction runs, here with ``device="cpu"``), and the alias
imports neither jax, the JAX package nor its ``pyfocusr`` alias."""

import os
import subprocess
import sys

import numpy as np


def test_flat_imports_match_reference_surface():
    import pyfocusr_torch
    import pyfocusr_tpu_torch

    assert pyfocusr_torch.Focusr is pyfocusr_tpu_torch.Focusr
    assert pyfocusr_torch.Graph is pyfocusr_tpu_torch.Graph
    assert pyfocusr_torch.eigsort is pyfocusr_tpu_torch.eigsort
    assert pyfocusr_torch.recursive_eig is pyfocusr_tpu_torch.recursive_eig
    assert pyfocusr_torch.print_header is pyfocusr_tpu_torch.print_header
    assert pyfocusr_torch.__version__ == pyfocusr_tpu_torch.__version__
    import pyfocusr

    # The same flat names as the JAX package's alias.
    jax_names = {n for n in vars(pyfocusr) if not n.startswith("_")}
    torch_names = {n for n in vars(pyfocusr_torch) if not n.startswith("_")}
    assert jax_names - torch_names == set()


def test_submodule_import_styles():
    from pyfocusr_torch.eigsort import eigsort
    from pyfocusr_torch.focusr import Focusr
    from pyfocusr_torch.graph import Graph, features_dictionary, recursive_eig
    from pyfocusr_torch.main import print_header
    from pyfocusr_torch.vtk_functions import read_vtk_mesh

    import pyfocusr_torch.vtk_functions as vf
    import pyfocusr_tpu_torch

    assert Focusr is pyfocusr_tpu_torch.Focusr
    assert Graph is pyfocusr_tpu_torch.Graph
    assert eigsort is pyfocusr_tpu_torch.eigsort
    assert callable(recursive_eig) and callable(print_header)
    assert set(features_dictionary) == {
        "curvature",
        "min_curvature",
        "max_curvature",
    }
    assert vf.read_vtk_mesh is read_vtk_mesh


def test_reference_style_usage_runs():
    """The reference notebook's import and construction pattern on a tiny
    synthetic pair, on the CPU."""
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_curvature_icp import make_sphere

    from pyfocusr_torch import Focusr, TriMesh

    p1, t1 = make_sphere(n_theta=8, n_phi=16)
    p2 = p1 * (1.0 + 0.04 * np.sin(3 * p1[:, [1]]))
    reg = Focusr(
        vtk_mesh_target=TriMesh(p1.astype(np.float32), np.asarray(t1)),
        vtk_mesh_source=TriMesh(p2.astype(np.float32), np.asarray(t1)),
        get_weighted_spectral_coords=False,
        non_rigid_max_iterations=10,
        graph_smoothing_iterations=5,
        projection_smooth_iterations=2,
        n_coords_spectral_registration=100,
        seed=0,
        device="cpu",
    )
    reg.align_maps()
    corr = np.asarray(reg.corresponding_target_idx_for_each_source_pt)
    assert corr.shape == (len(p1),)
    assert len(np.unique(corr)) > 0.5 * len(p1)


def test_alias_imports_no_jax():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'pyfocusr_tpu', 'pyfocusr'):\n"
            "    sys.modules[name] = None\n"
            "import pyfocusr_torch\n"
            "from pyfocusr_torch.graph import recursive_eig\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
