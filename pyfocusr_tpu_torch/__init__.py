"""pyfocusr_tpu_torch: the FOCUSR spectral surface registration in PyTorch,
with hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

The port of ``pyfocusr_tpu`` (JAX on a TPU, which stays the reference).
Module paths mirror that package; each module's docstring names its
counterpart.  This package imports torch and numpy, never jax.  Its entry
points build on the CUDA card unless the caller passes ``device="cpu"``.

Entry points:

* :class:`PipelineConfig`, :class:`GraphArrays`,
  :func:`mesh_to_graph_arrays` and :func:`register_pair` — the
  ``register_pair`` path (``pyfocusr_tpu/pipeline.py:842``) with 'kd' or
  'hungarian' correspondences, CPD at any subsample size up to full
  resolution, the affine pre-pass, landmarks and xyz-as-features;
* :func:`landmark_pairs_from_positions` — ``landmark_pairs`` from picked
  landmark coordinates;
* :func:`make_draws` — the random inputs of ``register_pair``, from a seed;
* :func:`graph_arrays_from_numpy` / :func:`config_from_dict` — build the
  inputs from the JAX package's ``GraphArrays`` fields and config dict;
* :func:`registration_quality` / :func:`surface_distance`.
"""

from .mesh import MeshTopology, TriMesh, build_topology
from .metrics import registration_quality, surface_distance
from .multires import subdivide
from .pipeline import (
    GraphArrays,
    PipelineConfig,
    config_from_dict,
    graph_arrays_from_numpy,
    landmark_pairs_from_positions,
    make_draws,
    mesh_to_graph_arrays,
    register_pair,
)

__all__ = [
    "GraphArrays",
    "MeshTopology",
    "PipelineConfig",
    "TriMesh",
    "build_topology",
    "config_from_dict",
    "graph_arrays_from_numpy",
    "landmark_pairs_from_positions",
    "make_draws",
    "mesh_to_graph_arrays",
    "register_pair",
    "registration_quality",
    "subdivide",
    "surface_distance",
]
