"""Drop-in alias for the reference package name ``pyfocusr``, over the
PyTorch port.

Counterpart of ``pyfocusr/__init__.py`` (which re-exports the JAX package):
code written against the reference's import paths runs on
:mod:`pyfocusr_tpu_torch` with the package name changed::

    from pyfocusr_torch import Focusr, Graph
    from pyfocusr_torch.vtk_functions import read_vtk_mesh, icp_transform
    from pyfocusr_torch.graph import recursive_eig, features_dictionary
    from pyfocusr_torch.eigsort import eigsort

The same flat names as the JAX alias, and the submodules the reference had
(``focusr``, ``graph``, ``eigsort``, ``vtk_functions``, ``main``) registered
in ``sys.modules`` under this package.  The port's entry points build on
the CUDA card unless given ``device="cpu"``.
"""

import sys as _sys

from pyfocusr_tpu_torch import (  # noqa: F401
    Focusr,
    Graph,
    GraphArrays,
    PipelineConfig,
    TriMesh,
    __version__,
    as_trimesh,
    eigsort,
    features_dictionary,
    load_mesh,
    mesh_to_graph_arrays,
    print_header,
    recursive_eig,
    register_pair,
    save_mesh,
    vtk_functions,
)
from pyfocusr_tpu_torch import focusr, main  # noqa: F401
from pyfocusr_tpu_torch.spectral import eigsort as _eigsort_module
from pyfocusr_tpu_torch.spectral import graph  # noqa: F401

# ``from pyfocusr.graph import recursive_eig`` worked in the reference
# (``graph.py:357``); the port's function lives at the package root.
if not hasattr(graph, "recursive_eig"):
    graph.recursive_eig = recursive_eig

for _name, _mod in {
    "focusr": focusr,
    "graph": graph,
    "eigsort": _eigsort_module,
    "vtk_functions": vtk_functions,
    "main": main,
}.items():
    _sys.modules[__name__ + "." + _name] = _mod
