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
  resolution, the affine pre-pass, landmarks, xyz-as-features and the
  three node-feature flags;
* :func:`landmark_pairs_from_positions` — ``landmark_pairs`` from picked
  landmark coordinates;
* template serving (``pyfocusr_tpu/pipeline.py:915-1376``):
  :func:`prepare_target` / :func:`register_pair_prepared` (one template as
  the target of many pairs), :func:`prepare_source` /
  :func:`register_pair_prepared_source` (one template as the source),
  :func:`warm_block_from_prepared` (a class-template seed for
  ``register_pair(warm_block=...)``) and :func:`save_prepared_target` /
  :func:`load_prepared_target` (``.npz`` files either package loads);
* :func:`make_draws` — the random inputs of ``register_pair``, from a seed;
* :func:`graph_arrays_from_numpy` / :func:`config_from_dict` — build the
  inputs from the JAX package's ``GraphArrays`` fields and config dict;
* :func:`registration_quality` / :func:`surface_distance`;
* the class API (``pyfocusr_tpu/focusr.py`` and the modules it drives):
  :class:`Focusr` (``Focusr(target, source, ...).align_maps()``, or
  ``.align_maps_pipeline()`` over ``register_pair``), :class:`Graph`,
  :class:`eigsort`, the cycpd-compatible :class:`affine_registration` and
  :class:`deformable_registration`, and :func:`linear_sum_assignment`.
"""

from .focusr import Focusr
from .mesh import MeshTopology, TriMesh, as_trimesh, build_topology
from .metrics import registration_quality, surface_distance
from .multires import subdivide
from .ops.assignment import linear_sum_assignment
from .ops.cpd import affine_registration, deformable_registration
from .pipeline import (
    GraphArrays,
    PipelineConfig,
    config_from_dict,
    graph_arrays_from_numpy,
    landmark_pairs_from_positions,
    load_prepared_target,
    make_draws,
    mesh_to_graph_arrays,
    prepare_source,
    prepare_target,
    register_pair,
    register_pair_prepared,
    register_pair_prepared_source,
    save_prepared_target,
    source_spectrum_hoistable,
    warm_block_from_prepared,
)
from .spectral.eigsort import eigsort
from .spectral.graph import Graph

__all__ = [
    "Focusr",
    "Graph",
    "GraphArrays",
    "MeshTopology",
    "PipelineConfig",
    "TriMesh",
    "affine_registration",
    "as_trimesh",
    "build_topology",
    "config_from_dict",
    "deformable_registration",
    "eigsort",
    "graph_arrays_from_numpy",
    "landmark_pairs_from_positions",
    "linear_sum_assignment",
    "load_prepared_target",
    "make_draws",
    "mesh_to_graph_arrays",
    "prepare_source",
    "prepare_target",
    "register_pair",
    "register_pair_prepared",
    "register_pair_prepared_source",
    "registration_quality",
    "save_prepared_target",
    "source_spectrum_hoistable",
    "subdivide",
    "surface_distance",
    "warm_block_from_prepared",
]
