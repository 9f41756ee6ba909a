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
* multi-resolution registration (``pyfocusr_tpu/multires.py``):
  :func:`decimate` and :func:`register_pair_multires` (decimate, register
  the coarse pair, prolong, refine at full resolution; stage checkpoints);
  the refine's k=3 query takes the exact voxel-grid route of
  ``ops/grid_knn.py`` where ``ops/knn.py``'s measured planner sends it;
* the class API (``pyfocusr_tpu/focusr.py`` and the modules it drives):
  :class:`Focusr` (``Focusr(target, source, ...).align_maps()``, or
  ``.align_maps_pipeline()`` over ``register_pair``), :class:`Graph`,
  :class:`eigsort`, the cycpd-compatible :class:`affine_registration` and
  :class:`deformable_registration`, and :func:`linear_sum_assignment`;
* cohort registration and the statistical shape model
  (``pyfocusr_tpu/parallel/cohort.py``): :func:`pad_cohort`
  and :func:`stack_graph_arrays` (padded graphs, ``mesh_to_graph_arrays
  (pad_n_points=...)``), :func:`register_cohort` (the template's solve
  hoisted, one pair per subject), :func:`make_cohort_draws`,
  :func:`iterate_template` / :func:`build_ssm_template` (the groupwise
  loop with its Procrustes close), :func:`cohort_shape_modes`,
  :func:`ssm_project`, :func:`ssm_sample`, :func:`fit_subject_to_ssm`,
  :func:`cohort_mean_shape` and :func:`all_pairs_surface_errors`;
* the output surface (``pyfocusr_tpu/__init__.py``): :func:`load_mesh` /
  :func:`save_mesh` (.vtk, .vtp, .ply, .obj, .stl over copies of the JAX
  package's numpy readers and writers in ``io/``), the ``vtk_functions``
  module, :func:`transfer_point_data`, :func:`mesh_with_transferred_data`
  and :func:`cohort_point_data_matrix` (``Focusr.transfer_point_data`` on
  top), :func:`recursive_eig`, :func:`print_header` and
  ``features_dictionary``;
* the viewers (``Focusr.view_*`` / ``export_viewer_html`` and ``Graph``'s,
  over ``utils/viz.py`` and ``utils/html_viewer.py``), and groupwise
  registration in ``parallel/groupwise.py`` (not exported here, as in the
  JAX package);
* every ``device_mesh`` of the JAX package, over ``torch.distributed``
  (``parallel/distributed.py``: a ``DeviceMesh`` named with JAX's axis
  names, one process a rank, ``spawn`` to start them): the vertex-sharded
  fine refine of ``parallel/bigmesh.py`` (``register_pair_multires``), the
  cohort over ``'cohort'`` and all-pairs over ``'pairs'``, and the CLI's
  sharded commands;
* the JAX package's remaining schedules: the split-spectra schedule of
  the pair entry points from 65000 vertices,
  ``experiments.spectrum_union`` / ``spectrum_batched`` and
  ``ops.assignment.auction_lap`` (not exported here, as in the JAX
  package); ``pyfocusr_torch`` is the reference-name alias over this
  package.

The host-side fast paths (topology, the decimator's MIS, ``lap_host``, the
ASCII ``.vtk`` parse) run in C++ compiled with g++ at first use
(``native.py``).
"""

from . import vtk_functions
from .focusr import Focusr
from .mesh import MeshTopology, TriMesh, as_trimesh, build_topology, load_mesh, save_mesh
from .metrics import registration_quality, surface_distance
from .multires import decimate, register_pair_multires, subdivide
from .ops.assignment import linear_sum_assignment
from .ops.cpd import affine_registration, deformable_registration
from .parallel.cohort import (
    all_pairs_surface_errors,
    build_ssm_template,
    check_cohort_config,
    cohort_mean_shape,
    cohort_shape_modes,
    fit_subject_to_ssm,
    iterate_template,
    make_cohort_draws,
    pad_cohort,
    register_cohort,
    ssm_project,
    ssm_sample,
    stack_graph_arrays,
)
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
from .spectral.graph import Graph, features_dictionary
from .transfer import cohort_point_data_matrix, mesh_with_transferred_data, transfer_point_data
from .utils.logging import print_header


__version__ = "0.1.0"


def recursive_eig(matrix, k, n_k_needed, k_buffer=1, sigma=1e-10, which="LM"):
    """The reference's ``recursive_eig`` (``graph.py:357-389``; JAX
    ``pyfocusr_tpu/__init__.py:46-72``): the ``n_k_needed`` smallest
    eigenpairs with eigenvalue > 1e-10 of an explicit (scipy sparse or
    dense) matrix, as numpy.  Small matrices only: it densifies and runs
    O(N^3) ``np.linalg.eig``; at mesh scale use ``Graph.get_graph_spectrum``."""
    import numpy as np

    min_eig_val = 1e-10
    dense = matrix.toarray() if hasattr(matrix, "toarray") else np.asarray(matrix)
    vals, vecs = np.linalg.eig(dense)
    order = np.argsort(np.abs(vals - sigma))
    vals, vecs = vals[order], vecs[:, order]
    keep = np.where(vals.real > min_eig_val)[0][: max(k, n_k_needed)]
    keep = keep[np.argsort(vals.real[keep])][:n_k_needed]
    return np.real(vals[keep]), np.real(vecs[:, keep])


__all__ = [
    "__version__",
    "Focusr",
    "Graph",
    "GraphArrays",
    "MeshTopology",
    "PipelineConfig",
    "TriMesh",
    "affine_registration",
    "all_pairs_surface_errors",
    "as_trimesh",
    "build_ssm_template",
    "build_topology",
    "check_cohort_config",
    "cohort_mean_shape",
    "cohort_point_data_matrix",
    "cohort_shape_modes",
    "config_from_dict",
    "decimate",
    "deformable_registration",
    "eigsort",
    "features_dictionary",
    "fit_subject_to_ssm",
    "graph_arrays_from_numpy",
    "iterate_template",
    "landmark_pairs_from_positions",
    "linear_sum_assignment",
    "load_mesh",
    "load_prepared_target",
    "make_cohort_draws",
    "make_draws",
    "mesh_to_graph_arrays",
    "mesh_with_transferred_data",
    "pad_cohort",
    "prepare_source",
    "prepare_target",
    "print_header",
    "recursive_eig",
    "register_cohort",
    "register_pair",
    "register_pair_multires",
    "register_pair_prepared",
    "register_pair_prepared_source",
    "registration_quality",
    "save_mesh",
    "save_prepared_target",
    "source_spectrum_hoistable",
    "ssm_project",
    "ssm_sample",
    "stack_graph_arrays",
    "subdivide",
    "surface_distance",
    "transfer_point_data",
    "vtk_functions",
    "warm_block_from_prepared",
]
