"""The FOCUSR registration of one mesh pair, end to end on one device, and
template serving.

Counterpart of ``pyfocusr_tpu/pipeline.py``: ``PipelineConfig`` (:74),
``GraphArrays`` (:292), ``mesh_to_graph_arrays`` (:349, with its padding
and ``degree_cap``; JAX's patch-dense plan is not built, see below),
``_masked_minmax_norm`` (:483), ``_spectrum`` (:495: the wide Chebyshev
path over the ELL filter operator of :590-605 on every graph, the narrow
Chebyshev and shift-invert Lanczos paths of :623-650, and the feature
branches of :511-541), ``_pad_graph_arrays`` (:657), ``_normed``
(:702), ``landmark_pairs_from_positions`` (:709), ``_n_real_vertices`` and
``_check_padding_hazards`` (:737-787), ``_warm_supported`` (:790),
``_warm_x0`` (:801), the split-spectra schedule (``_SPLIT_SPECTRA_N``,
``_want_split``, :822-840), ``register_pair`` (:842), the serving entry
points (:915-1376: ``warm_block_from_prepared``, ``prepare_target``,
``register_pair_prepared``, ``source_spectrum_hoistable``,
``prepare_source``, ``register_pair_prepared_source``, the fingerprints,
``save_prepared_target`` and ``load_prepared_target``) and the branches of
``_register_pair_jit`` (:1381-1764) listed below:

    ICP -> spectra (target cold, source warm-started from the target's
    block; or either side taken from prepared state, or both warm from a
    class template's block, :1445-1512) -> eigsort -> spectral coords
    (optionally weighted, optionally with smoothed features and xyz
    appended, :1562-1613) -> CPD: landmark rows forced into the
    control subsample (:1619-1643), optional affine pre-pass (:1645-1651),
    low-rank deformable CPD with the dense E-step, or the streamed one
    when the subsample exceeds 3000^2 pairs (:1653-1671; the port streams
    the affine pre-pass's E-step above that size too, where JAX keeps the
    dense one) ->
    correspondences ('kd': nearest neighbour; 'hungarian': one-to-one
    assignment, :1677-1733) -> Chebyshev graph smoothing (or the prepared
    target's smoothed points) -> k=3 IDW final locations.

PyTorch runs eagerly, so the JAX package's single jitted program is a
sequence of tensor operations on the device the inputs lie on.  On a CUDA
device every nearest-neighbour query goes through the CUDA k-NN kernel,
'hungarian' correspondences through the Sinkhorn and Jonker-Volgenant CUDA
kernels (``ops/assignment.sinkhorn_jv_lap``), and the streamed CPD E-step
through the CUDA E-step kernel (``ops/cpd_estep_kernel``).  Every wide
eigensolve runs its Chebyshev chunks over the ELL table through
``ops/cheb_step_kernel.chebyshev_ell``, on every device: the JAX package's
patch-dense operator, dense 128 x 128 blocks for the TPU's matrix unit, is
not ported, and neither is the host BFS that plans it.

Randomness is an input.  ``jax.random`` cannot be reproduced in torch, so
every random draw the JAX program makes internally is an entry of
``draws`` (see :func:`make_draws`): the ICP landmark subsample, the eigsort
and CPD subsamples, the eigensolves' initial blocks and the CPD
Gram's ``omega``.  Feeding the same draws to both packages makes their runs
comparable.  :func:`make_draws` gives the index draws as host arrays and
the float starts as :class:`NormalDraw` s, which the call draws on its
own device as it moves the draws there (``_tensor_to``); arrays passed in
are used as given.

From ``_SPLIT_SPECTRA_N`` = 65000 vertices on either mesh (the variable
``PYFOCUSR_TPU_SPLIT_SPECTRA_N``, 0 for never) every pair entry point takes
the JAX package's split-spectra schedule (:889-908, :1078-1090,
:1196-1201): the spectra it was not given are solved first, as the
serving entry points solve them, and the source is then solved from the
unmoved points, cold under ICP.  That is not the fused schedule's source
solve (warm from the target's block through the moved points), so on such
meshes the two schedules agree to solver tolerance, not bit for bit; the
target side is equal.  The JAX package split to work around XLA's schedule
on a TPU; the port splits at the same size so that both packages compute
the same values.

Padded graphs (``mesh_to_graph_arrays(pad_n_points=...)``, the cohort's
``parallel.cohort.pad_cohort``) carry their padding rows at the tail with
``valid_mask`` 0: the spectra, the subsamples, the nearest-neighbour
queries and the outputs all leave those rows out, and the draws index real
rows only.  'hungarian' correspondences and subsamples larger than a
graph's real vertex count raise on a padded graph, as in the JAX package.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os

import numpy as np
import torch

from .mesh import TriMesh, build_topology
from .ops import cpd as cpd_ops
from .ops import graph_ops
from .ops.assignment import sinkhorn_jv_lap
from .ops.cheb_step_kernel import chebyshev_ell
from .ops.eigen import chebyshev_eigpairs_wide, narrow_or_lanczos
from .ops.icp import apply_rigid
from .ops.icp import icp as icp_fit
from .ops.knn import (
    SENTINEL,
    idw_from_knn,
    knn3_masked,
    nn_query,
    pairwise_sq_dists,
)
from .spectral.eigsort_device import sort_eigenmaps
from .utils import spans
from .utils.checkpoint import load_results, save_results
from .utils.device import resolve_device
from .utils.precision import f32_matmuls

__all__ = [
    "PipelineConfig",
    "GraphArrays",
    "mesh_to_graph_arrays",
    "graph_arrays_from_numpy",
    "config_from_dict",
    "landmark_pairs_from_positions",
    "NormalDraw",
    "make_draws",
    "host_draws",
    "register_pair",
    "warm_block_from_prepared",
    "prepare_target",
    "register_pair_prepared",
    "source_spectrum_hoistable",
    "prepare_source",
    "register_pair_prepared_source",
    "save_prepared_target",
    "load_prepared_target",
]


@dataclasses.dataclass(frozen=True, eq=True)
class PipelineConfig:
    """Registration configuration: the same fields, defaults and validation
    as ``pyfocusr_tpu/pipeline.py:74-283`` (see there for each knob's
    meaning and measurements)."""

    icp_register_first: bool = True
    icp_registration_mode: str = "rigid"
    icp_iterations: int = 100
    icp_n_landmarks: int = 2000
    initial_correspondence_type: str = "kd"
    final_correspondence_type: str = "kd"
    use_features_as_coords: bool = False
    feature_smoothing_iterations: int = 40
    include_points_as_features: bool = False
    norm_physical_and_spectral: bool = True
    use_features_in_graph: bool = False
    include_features_in_adj_matrix: bool = False
    G_matrix_p_function: str = "exp"
    feature_weights_diag: tuple = ()
    icp_reg_target_to_source: bool = False
    target_eigenmap_as_reference: bool = True
    landmark_weight: float = 100.0
    n_spectral_features: int = 3
    n_extra_spectral: int = 3
    n_coords_spectral_ordering: int = 5000
    n_coords_spectral_registration: int = 1000
    get_weighted_spectral_coords: bool = False
    rigid_before_non_rigid_reg: bool = False
    rigid_reg_max_iterations: int = 100
    rigid_tolerance: float = 1e-8
    non_rigid_max_iterations: int = 300
    non_rigid_tolerance: float = 1e-8
    non_rigid_alpha: float = 0.01
    non_rigid_beta: float = 50.0
    non_rigid_n_eigens: int = 100
    non_rigid_outlier_w: float = 0.0
    smooth_correspondences: bool = True
    graph_smoothing_iterations: int = 300
    projection_smooth_iterations: int = 40
    smoothing_method: str = "chebyshev"
    compute_mutual_consistency: bool = False
    eig_method: str = "chebyshev"
    eig_cg_iters: int = 300
    eig_lanczos_iters: int = 0
    eig_cheb_degree: int = 75
    eig_cheb_sweeps: int = 6
    eig_cheb_refine_cg: int = 40
    eig_wide_block: int = 128
    eig_wide_degree: int = 33
    eig_wide_chunks: int = 5
    eig_warm_start: bool = True
    eig_wide_chunks_warm: int = 2
    eig_wide_degree_warm: int = 33
    eig_warm_resid_tol: float = 3e-4

    def __post_init__(self):
        if self.n_spectral_features < 1:
            raise ValueError("n_spectral_features must be >= 1")
        if self.n_extra_spectral < 0:
            raise ValueError("n_extra_spectral must be >= 0")
        if self.icp_register_first:
            if self.icp_n_landmarks < 3:
                raise ValueError(
                    "icp_n_landmarks must be >= 3 (a rigid fit needs at "
                    "least 3 points; 0 would produce a silent NaN transform)"
                )
            if self.icp_iterations < 1:
                raise ValueError("icp_iterations must be >= 1")
        if self.projection_smooth_iterations < 0:
            raise ValueError("projection_smooth_iterations must be >= 0")
        if self.icp_registration_mode not in ("rigid", "similarity"):
            raise ValueError("Error invalid transform mode")
        if self.eig_method not in ("chebyshev", "chebyshev-narrow", "lanczos"):
            raise ValueError(
                "eig_method must be 'chebyshev', 'chebyshev-narrow' or 'lanczos'"
            )
        if self.smoothing_method not in ("chebyshev", "exact"):
            raise ValueError("smoothing_method must be 'chebyshev' or 'exact'")
        if self.G_matrix_p_function not in ("exp", "log", "square", "shift"):
            raise ValueError(
                "G_matrix_p_function must be 'exp', 'log', 'square' or 'shift'"
            )
        for name in ("initial_correspondence_type", "final_correspondence_type"):
            if getattr(self, name) not in ("kd", "hungarian"):
                raise ValueError(f"{name} must be 'kd' or 'hungarian'")
        if self.non_rigid_alpha <= 0 or self.non_rigid_beta <= 0:
            raise ValueError("non_rigid_alpha/beta must be positive")
        if not 0.0 <= self.non_rigid_outlier_w < 1.0:
            raise ValueError("non_rigid_outlier_w must be in [0, 1)")
        if self.landmark_weight <= 0:
            raise ValueError("landmark_weight must be positive")
        for name in (
            "n_coords_spectral_ordering",
            "n_coords_spectral_registration",
            "non_rigid_max_iterations",
            "graph_smoothing_iterations",
            "feature_smoothing_iterations",
            "eig_wide_block",
            "eig_wide_degree",
            "eig_wide_chunks",
            "eig_wide_chunks_warm",
            "eig_wide_degree_warm",
        ):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    @property
    def n_total(self) -> int:
        return self.n_spectral_features + self.n_extra_spectral


def config_from_dict(d) -> PipelineConfig:
    """``PipelineConfig`` from ``dataclasses.asdict`` of the JAX package's
    config (plain values); unknown keys raise."""
    names = {f.name for f in dataclasses.fields(PipelineConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown PipelineConfig fields: {sorted(unknown)}")
    kw = dict(d)
    if "feature_weights_diag" in kw:
        kw["feature_weights_diag"] = tuple(kw["feature_weights_diag"])
    return PipelineConfig(**kw)


_INT_FIELDS = ("neighbors", "overflow")
_FLOAT_FIELDS = (
    "points", "nbr_mask", "valid_mask", "null_indicators", "node_features",
)

@dataclasses.dataclass(frozen=True)
class GraphArrays:
    """Device-resident graph of one mesh (tensors on one device)."""

    points: torch.Tensor  # f32 [N, 3]
    neighbors: torch.Tensor  # int64 [N, D]
    nbr_mask: torch.Tensor  # f32 [N, D]
    valid_mask: torch.Tensor  # f32 [N]  1 = real vertex, 0 = padding
    null_indicators: torch.Tensor  # f32 [N, C] per-component indicators
    overflow: torch.Tensor = None  # int64 [E_o, 2] hub-vertex spill edges
    node_features: torch.Tensor = None  # f32 [N, K]

    def __post_init__(self):
        dev = self.points.device
        if self.node_features is None:
            object.__setattr__(
                self, "node_features",
                torch.zeros((self.points.shape[0], 0), dtype=torch.float32, device=dev),
            )
        if self.overflow is None:
            object.__setattr__(
                self, "overflow", torch.zeros((0, 2), dtype=torch.int64, device=dev)
            )

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def to(self, device) -> "GraphArrays":
        return GraphArrays(**{name: getattr(self, name).to(device)
                              for name in TENSOR_FIELDS})


# The fields of a GraphArrays, in declaration order.
TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(GraphArrays))


def graph_arrays_from_numpy(d, device=None) -> GraphArrays:
    """``GraphArrays`` from the JAX package's ``GraphArrays`` fields given as
    numpy arrays (a mapping name -> array; other keys, such as the JAX
    package's patch-dense plan, are ignored), on ``device``: the CUDA card by
    default (see ``utils.device.resolve_device``)."""
    device = resolve_device(device)
    kw = {}
    for name in _FLOAT_FIELDS + _INT_FIELDS:
        if d.get(name) is None:
            continue
        dtype = torch.int64 if name in _INT_FIELDS else torch.float32
        kw[name] = torch.tensor(np.asarray(d[name])).to(dtype=dtype, device=device)
    return GraphArrays(**kw)


def _widen(topo, pad_degree: int):
    """A given topology's ELL table widened to ``pad_degree`` columns by
    self-loop slots of mask 0 (``pyfocusr_tpu/pipeline.py:366-397``)."""
    cur_d = topo.neighbors.shape[1]
    if pad_degree is None or pad_degree == cur_d:
        return topo
    if pad_degree < cur_d:
        raise ValueError(
            f"pad_degree={pad_degree} narrower than the provided "
            f"topology's ELL width {cur_d}"
        )
    n, extra = topo.neighbors.shape[0], pad_degree - cur_d
    own = np.tile(np.arange(n, dtype=topo.neighbors.dtype)[:, None], (1, extra))
    return dataclasses.replace(
        topo,
        neighbors=np.concatenate([topo.neighbors, own], axis=1),
        nbr_mask=np.concatenate(
            [topo.nbr_mask, np.zeros((n, extra), topo.nbr_mask.dtype)], axis=1),
        max_degree=pad_degree,
    )


def mesh_to_graph_arrays(mesh: TriMesh, node_features=None,
                         device=None, topology=None, pad_n_points: int = None,
                         pad_degree: int = None, pad_components: int = None,
                         pad_overflow: int = None, degree_cap: int = 24) -> GraphArrays:
    """Build the pipeline tensors of one mesh on ``device``, the CUDA card
    by default (see ``utils.device.resolve_device``): ELL degree capped at
    ``degree_cap`` with hub overflow edges (passed to ``build_topology``
    when no ``topology`` is given).  ``null_indicators``
    holds one indicator column per connected component (the Laplacian
    kernel the eigensolver deflates).  ``node_features``: optional per-vertex
    features, [N], [N, K] or [K, N] (the JAX package's rules, :413-420).
    ``topology``: the mesh's ``build_topology`` result, when the caller
    already has it (its ELL table is widened to ``pad_degree`` if needed).

    ``pad_*``: pad to a fixed size for stacking, as the JAX package does
    (:349-476): rows up to ``pad_n_points`` are self-loops with mask 0 and
    zero points, features and indicator columns (``valid_mask`` 0), the
    ELL table is ``pad_degree`` wide, there are ``pad_components``
    indicator columns and ``pad_overflow`` overflow edges (the added ones
    ``src == dst``, so their weight is 0).

    The JAX package's patch-dense plan (:454-470), the host BFS behind its
    TPU filter operator, is not built: every wide solve here runs the ELL
    operator (:func:`ell_filter_factory`)."""
    n = mesh.n_points
    if topology is not None:
        topo = _widen(topology, pad_degree)
    else:
        topo = build_topology(np.asarray(mesh.triangles), n, pad_degree,
                              degree_cap=degree_cap)
    points = mesh.points
    if torch.is_tensor(points):
        points = points.detach().cpu().numpy()
    points = np.asarray(points, np.float32)
    neighbors, nbr_mask = topo.neighbors, topo.nbr_mask
    overflow = topo.overflow_edges
    if pad_overflow is not None and pad_overflow > overflow.shape[0]:
        overflow = np.concatenate([overflow, np.zeros(
            (pad_overflow - overflow.shape[0], 2), overflow.dtype)])
    valid = np.ones((n,), np.float32)
    n_comp = max(topo.n_components, 1)
    indicators = np.zeros((n, n_comp), np.float32)
    indicators[np.arange(n), topo.component_labels] = 1.0
    if node_features is None:
        feats = np.zeros((n, 0), np.float32)
    else:
        feats = np.asarray(node_features, np.float32)
        if feats.ndim == 1:
            feats = feats[:, None]
        if feats.shape[0] != n:  # [K, N]
            feats = feats.T
    if pad_n_points is not None and pad_n_points > n:
        extra = pad_n_points - n
        width = neighbors.shape[1]
        points = np.concatenate([points, np.zeros((extra, 3), np.float32)])
        feats = np.concatenate([feats, np.zeros((extra, feats.shape[1]), np.float32)])
        neighbors = np.concatenate([neighbors, np.tile(
            np.arange(n, pad_n_points, dtype=neighbors.dtype)[:, None], (1, width))])
        nbr_mask = np.concatenate([nbr_mask, np.zeros((extra, width), np.float32)])
        valid = np.concatenate([valid, np.zeros((extra,), np.float32)])
        indicators = np.concatenate([indicators, np.zeros((extra, n_comp), np.float32)])
    if pad_components is not None and pad_components > indicators.shape[1]:
        indicators = np.concatenate([indicators, np.zeros(
            (indicators.shape[0], pad_components - indicators.shape[1]), np.float32)],
            axis=1)
    return graph_arrays_from_numpy(
        {
            "points": points,
            "neighbors": neighbors,
            "nbr_mask": nbr_mask,
            "valid_mask": valid,
            "null_indicators": indicators,
            "overflow": overflow,
            "node_features": feats,
        },
        device=device,
    )


def _masked_minmax_norm(vecs, mask):
    """Column min-max over real vertices only -> [-0.5, 0.5]."""
    with spans.host_read("scalar_copy"):
        inf = torch.tensor(float("inf"), device=vecs.device)
    mn = torch.where(mask[:, None] > 0, vecs, inf).min(dim=0).values
    mx = torch.where(mask[:, None] > 0, vecs, -inf).max(dim=0).values
    out = (vecs - mn) / torch.clamp(mx - mn, min=1e-30) - 0.5
    return out * mask[:, None]


# Columns the narrow solver adds to the k wanted ones (the JAX default).
_NARROW_EXTRA = 8


def _solver(cfg: PipelineConfig, n_points: int) -> str:
    """The eigensolver a mesh of ``n_points`` vertices takes: 'wide' (the
    default 'chebyshev' from 2048 vertices), 'narrow' ('chebyshev-narrow',
    or 'chebyshev' below 2048) or 'lanczos'."""
    if cfg.eig_method == "lanczos":
        return "lanczos"
    if cfg.eig_method == "chebyshev" and n_points >= 2048:
        return "wide"
    return "narrow"


def _start_width(cfg: PipelineConfig, n_points: int) -> int:
    """Columns of a solve's random start: the wide block, the narrow block
    (k + 8), or Lanczos's power-iteration and start vectors (2)."""
    return {"wide": cfg.eig_wide_block, "narrow": cfg.n_total + _NARROW_EXTRA,
            "lanczos": 2}[_solver(cfg, n_points)]


def ell_filter_factory(neighbors, overflow, sw, ov_sw, sd, mask):
    """The wide solver's filter factory over the ELL table
    (``pyfocusr_tpu/pipeline.py:590-605``): ``factory(c, e) -> chunk`` with
    ``chunk(X, deg)`` the degree-``deg`` Chebyshev recurrence from X on
    ``op(T) = (2/e) (A - c I) T``, ``A x = sd x - W_sym x`` (with overflow
    edges where ``ov_sw`` is not None), run by
    ``ops/cheb_step_kernel.chebyshev_ell``: one kernel launch a step on CUDA
    tensors, ``cheb_step_plain`` on CPU tensors.  JAX's factory gives the
    step op instead, and its solver runs the recurrence."""
    nbrs = neighbors.to(torch.int32) if neighbors.is_cuda else neighbors

    def factory(c, e):
        alpha = 2.0 / e
        w_hat = alpha * sw
        a_diag = alpha * (sd - c * mask)
        ov_coef = None if ov_sw is None else -(alpha * ov_sw)[:, None]
        return lambda X, deg: chebyshev_ell(X, deg, nbrs, w_hat, a_diag, overflow, ov_coef)

    return factory


def _spectrum(graph: GraphArrays, k: int, cfg: PipelineConfig, init_block,
              x0=None, return_block: bool = False, chunks: int = None,
              extra_chunks: int = 0, degree: int = None, generator=None):
    """k smallest nonzero Laplacian eigenpairs of one mesh, eigvecs min-max
    normalized to [-0.5, 0.5], by the solver :func:`_solver` picks: the wide
    Chebyshev solver, its chunks through :func:`ell_filter_factory` (on CUDA
    tensors one kernel launch a step, ``ops/cheb_step_kernel.py``), the
    narrow one, or shift-invert Lanczos.  ``init_block``: the solve's
    random start, [N, :func:`_start_width`] (for Lanczos the
    power-iteration vector, then the start vector).  ``x0``, ``return_block``, ``chunks`` and ``degree``
    exist on the wide path only, as in the JAX package.
    ``include_features_in_adj_matrix`` builds the edge weights on xyz and
    the node features, ``use_features_in_graph`` takes G from the features
    (``graph_ops.g_vector``).  Returns (lams, vecs, (w, overflow, ov_w))
    and, with ``return_block``, the final filtered block."""
    solver = _solver(cfg, graph.n_points)
    if solver != "wide" and (return_block or x0 is not None or chunks is not None
                             or degree is not None):
        raise ValueError(
            "return_block/x0/chunks/degree need the wide Chebyshev "
            "path (eig_method='chebyshev', n_points >= 2048)"
        )
    with spans.span("spectra/setup"):
        mask = graph.valid_mask
        nbrs = graph.neighbors
        feats = graph.node_features
        has_feats = feats.shape[1] > 0
        coords = graph.points
        if cfg.include_features_in_adj_matrix and has_feats:
            # Edge weights on xyz with the features, scaled by the mean axis
            # range, appended as further coordinates.
            mean_range = _normed_points(graph)[1]
            coords = torch.cat([graph.points, feats * mean_range * mask[:, None]], dim=1)
        w = graph_ops.edge_weights(coords, nbrs, graph.nbr_mask)
        ov = graph.overflow
        ov_w = graph_ops.overflow_weights(coords, ov)
        d = graph_ops.degree_vector(w, ov, ov_w)
        if cfg.use_features_in_graph and has_feats:
            # The feature G of L = G (D - W); the operator, its bound, the
            # fused filter and the null basis below all take s = sqrt(g).
            if cfg.feature_weights_diag:
                with spans.host_read("config_copy"):
                    fw = torch.diag(torch.tensor(cfg.feature_weights_diag,
                                                 dtype=torch.float32, device=d.device))
            else:
                fw = torch.eye(feats.shape[1], dtype=torch.float32, device=d.device)
            g_feat = graph_ops.g_vector(
                feats.T, d, fw, p_function=cfg.G_matrix_p_function,
                include_features=True, valid_mask=mask,
            )
            g = torch.where(mask > 0, torch.clamp(g_feat, min=1e-30), torch.ones_like(d))
        else:
            g = torch.where(mask > 0, (d + graph_ops.DEGREE_EPS) ** -1, torch.ones_like(d))
        s = torch.sqrt(g)

        def matvec(X):
            ax = graph_ops.sym_laplacian_matvec(
                nbrs, w, g, X * mask[:, None], ov, ov_w, degrees=d
            )
            return ax * mask[:, None]

        def quad_form(V):
            return graph_ops.sym_laplacian_quad_form(
                nbrs, w, s, V * mask[:, None], ov, ov_w
            )

        null_basis = graph.null_indicators * (1.0 / s)[:, None] * mask[:, None]
        # Gershgorin bound of A = S(D-W)S: max_i s_i (s_i d_i + (W s)_i).
        ws = graph_ops.spmv(nbrs, w, s, ov, ov_w)
        lam_bound = (mask * s * (s * d + ws)).max()
        if solver == "wide":
            # Fused filter operator: sw_ij = s_i w_ij s_j and s_i^2 d_i precomputed.
            sw = s[:, None] * w * s[nbrs]
            sd = s * s * d * mask
            ov_sw = ov_w * s[ov[:, 0]] * s[ov[:, 1]] if ov.shape[0] > 0 else None
            factory = ell_filter_factory(nbrs, ov, sw, ov_sw, sd, mask)
    if solver in ("narrow", "lanczos"):
        solver_kw = (dict(cg_iters=cfg.eig_cg_iters, lanczos_iters=cfg.eig_lanczos_iters)
                     if solver == "lanczos" else
                     dict(block_extra=_NARROW_EXTRA, degree=cfg.eig_cheb_degree,
                          sweeps=cfg.eig_cheb_sweeps, refine_cg_iters=cfg.eig_cheb_refine_cg))
        lams, vecs = narrow_or_lanczos(
            solver, matvec, quad_form, s, null_basis, k,
            _tensor_to(init_block, graph.device), lam_bound, subspace_mask=mask,
            **solver_kw)
        return lams, _masked_minmax_norm(vecs, mask), (w, ov, ov_w)
    out = chebyshev_eigpairs_wide(
        matvec, null_basis, k, lam_bound, factory, quad_form,
        init_block=init_block,
        block_width=cfg.eig_wide_block,
        chunk_degree=cfg.eig_wide_degree if degree is None else degree,
        chunks=cfg.eig_wide_chunks if chunks is None else chunks,
        subspace_mask=mask,
        x0=x0, return_block=return_block,
        extra_chunks=extra_chunks,
        extra_resid_tol=cfg.eig_warm_resid_tol,
        generator=generator,
    )
    lams, vecs_a = out[0], out[1]
    vecs = vecs_a * s[:, None]
    vecs = vecs / vecs.norm(dim=0, keepdim=True)
    vecs = _masked_minmax_norm(vecs, mask)
    if return_block:
        return lams, vecs, (w, ov, ov_w), out[3]
    return lams, vecs, (w, ov, ov_w)


def _pad_graph_arrays(g: GraphArrays, n_pad: int, d_pad: int, c_pad: int,
                      e_pad: int = None) -> GraphArrays:
    """``g`` padded to ``n_pad`` points, ``d_pad`` ELL columns and ``c_pad``
    indicator columns (and ``e_pad`` overflow edges), as
    ``pyfocusr_tpu/pipeline.py:657-682`` pads a graph inside a trace: dead
    rows are self-loops of mask 0 with ``valid_mask`` 0, the added ELL
    columns point at row 0 with mask 0, the added overflow edges are
    (0, 0) (weight 0)."""
    n, d = g.neighbors.shape
    extra_n, extra_d = n_pad - n, d_pad - d

    def rows(x):
        return torch.cat([x, x.new_zeros((extra_n,) + tuple(x.shape[1:]))])

    self_idx = torch.arange(n, n_pad, dtype=g.neighbors.dtype,
                            device=g.device)[:, None].expand(extra_n, d_pad)
    neighbors = torch.cat([torch.nn.functional.pad(g.neighbors, (0, extra_d)), self_idx])
    nulls = rows(torch.nn.functional.pad(
        g.null_indicators, (0, c_pad - g.null_indicators.shape[1])))
    ov = g.overflow
    if e_pad is not None and e_pad > ov.shape[0]:
        ov = torch.cat([ov, ov.new_zeros((e_pad - ov.shape[0], 2))])
    return GraphArrays(
        points=rows(g.points), neighbors=neighbors,
        nbr_mask=rows(torch.nn.functional.pad(g.nbr_mask, (0, extra_d))),
        valid_mask=rows(g.valid_mask), null_indicators=nulls, overflow=ov,
        node_features=rows(g.node_features))


def _normed(pts):
    mn = pts.min(dim=0).values
    return (pts - mn) / torch.clamp(pts.max(dim=0).values - mn, min=1e-30)


def landmark_pairs_from_positions(source_mesh, target_mesh, source_positions,
                                  target_positions, device=None):
    """``register_pair``'s ``landmark_pairs`` from physical landmark
    positions: each f32 [L, 3] position snaps to the nearest vertex of its
    mesh (objects with ``.points``).  Built on ``device``, the CUDA card by
    default (see ``utils.device.resolve_device``).  Returns (pairs int64
    [L, 2] as (source vertex, target vertex), snap distances f32 [L, 2]);
    large distances flag landmarks that do not lie on the surfaces."""
    device = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    sp, tp = f32(source_positions), f32(target_positions)
    if sp.shape != tp.shape or sp.dim() != 2 or sp.shape[1] != 3:
        raise ValueError(
            "source/target landmark positions must both be [L, 3]; got "
            f"{tuple(sp.shape)} and {tuple(tp.shape)}"
        )
    d_s, idx_s = nn_query(f32(source_mesh.points), sp)
    d_t, idx_t = nn_query(f32(target_mesh.points), tp)
    return torch.stack([idx_s, idx_t], dim=1), torch.stack([d_s, d_t], dim=1)


def _warm_supported(cfg: PipelineConfig, n_a: int, n_b: int) -> bool:
    """Whether the cross-mesh spectral warm start applies (wide-chebyshev
    path on both sides)."""
    return (
        cfg.eig_warm_start
        and cfg.eig_method == "chebyshev"
        and n_a >= 2048
        and n_b >= 2048
    )


def _warm_x0(block, from_points, from_mask, to_points):
    """Map a filtered eigensolver block between meshes: each ``to`` vertex
    takes the block row of its spatially nearest ``from`` vertex.  Padded
    ``from`` rows are pushed to ``SENTINEL`` so no real vertex seeds from
    a dead row at the origin; padded ``to`` rows take whatever real row is
    nearest, which the solver's ``subspace_mask`` zeroes."""
    # No profiler range: a range here would take the k-NN's ctypes launch
    # as its own and add it to the spectra stage's device time, which
    # counts the stage's torch operators.
    with spans.span("spectra/warm_map", profiled=False):
        ref = torch.where(
            from_mask[:, None] > 0, from_points, torch.full_like(from_points, SENTINEL)
        )
        _, idx = nn_query(ref, to_points)
        return block[idx]


# From this many vertices on either mesh, the entry points hoist each
# eigensolve out of the pair (the JAX package's ``_SPLIT_SPECTRA_N``,
# :822-840, read from the same variable; 0 turns the split off).  The JAX
# package set it on a TPU, where compiling both solves into one program
# ran 3.4x slower at 122k vertices.  Read at import: tests patch the
# module attribute.
_SPLIT_SPECTRA_N = int(os.environ.get("PYFOCUSR_TPU_SPLIT_SPECTRA_N", "65000"))


def _want_split(n_target: int, n_source: int) -> bool:
    """Whether a pair of these vertex counts takes the split-spectra
    schedule (``pyfocusr_tpu/pipeline.py:833-839``)."""
    return _SPLIT_SPECTRA_N > 0 and max(n_target, n_source) >= _SPLIT_SPECTRA_N


def _choice(rng, n: int, m: int, n_real: int = None) -> np.ndarray:
    """m of the first ``n_real`` (the real rows; all n when None) of n
    indices, uniformly without replacement; all n, in order, when m >= n
    (the JAX package's ``_rand_idxs`` rule, :685-700)."""
    if m >= n:
        return np.arange(n, dtype=np.int64)
    return rng.choice(n if n_real is None else n_real, size=m,
                      replace=False).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class NormalDraw:
    """A deferred draw of i.i.d. standard normals: its own ``seed``, its
    ``shape`` and ``dtype`` (f32).  :meth:`draw` makes the values on the
    device that consumes them (``torch.randn`` from a generator of that
    device seeded ``seed``): on a CUDA device one Philox launch, with no
    host array and no copy.  The values are fixed by the seed and the
    device type; a CPU draw and a CUDA draw of one seed differ.

    Two draws compare equal when seed, shape and dtype do.  There is no
    host view of the values (no ``__array__``): a host copy would differ
    from what a CUDA device draws; :func:`host_draws` draws them on the
    host where one set of values must feed runs on different devices."""

    seed: int
    shape: tuple
    dtype = np.dtype(np.float32)  # a class constant, not a field

    def draw(self, device) -> torch.Tensor:
        device = torch.device(device)
        generator = torch.Generator(device=device).manual_seed(self.seed)
        return torch.randn(self.shape, generator=generator, device=device,
                           dtype=torch.float32)


# Each float draw's seed is derived from the draws' seed and the draw's own
# number here, so it does not depend on which other draws a call makes.
_NORMAL_DRAWS = ("eig_block_target", "eig_block_source", "cpd_omega",
                 "eig_start_target", "eig_start_source")


def _normal_draw(seed: int, name: str, shape) -> NormalDraw:
    state = np.random.SeedSequence([seed, _NORMAL_DRAWS.index(name)]).generate_state(
        1, np.uint64)
    return NormalDraw(int(state[0]) >> 1, tuple(int(n) for n in shape))


def make_draws(seed: int, cfg: PipelineConfig, n_target: int, n_source: int,
               n_landmarks: int = 0, source_block: bool = False,
               real_target: int = None, real_source: int = None):
    """Every random input of ``register_pair`` from ``seed``: the index
    draws as numpy arrays, drawn on the host, and the float starts as
    :class:`NormalDraw` s, drawn on the device the call runs on when it
    moves them there (so their values depend on the device type as well as
    the seed; :func:`host_draws` draws them on the host for runs on
    different devices that must see the same inputs):

    icp_landmarks    int64 [min(icp_n_landmarks, N_moving)]
    eigsort_target   int64 [min(n_coords_spectral_ordering, N_t)]
    eigsort_source   int64 [min(n_coords_spectral_ordering, N_s)]
    cpd_source       int64 [n_reg]   rows of the source spectral cloud (X)
    cpd_target       int64 [n_reg - n_landmarks]  rows of the target
                                     spectral cloud (Y) after the landmark
                                     rows of ``landmark_pairs``
    eig_block_target f32 [N_t, eig_wide_block]  initial block of a wide
                                                 eigensolve
    eig_block_source f32 [N_s, eig_wide_block]  only when the source's wide
                                                 solve is not warm-started,
                                                 with ``source_block``, or
                                                 under the split-spectra
                                                 schedule (:func:`_want_split`)
    cpd_omega        f32 [n_reg, p]  Gram subspace-iteration start
    eig_start_target f32 [N_t, w]  start of a narrow (w = k + 8) or
    eig_start_source f32 [N_s, w]  Lanczos (w = 2: the power-iteration
                                   vector, then the Lanczos start) solve

    Each ``eig_*`` draw is made only for a mesh whose solve reads it.  The
    index draws are the first of ``seed``'s numpy stream; each float draw
    has a seed of its own, derived from ``seed`` and its name, so no draw
    changes with the presence of another.

    The serving entry points read: :func:`prepare_target` the
    ``eig_block_target`` draw, :func:`prepare_source` the
    ``eig_block_source`` one (``source_block=True`` gives it when the pair's
    warm start is on; the split-spectra schedule, whose hoisted source
    solve may run cold, draws it there too);
    :func:`register_pair_prepared`
    reads no ``eig_block_target`` and :func:`register_pair_prepared_source`
    no ``eig_block_source``.

    ``real_target`` / ``real_source``: a padded side's real vertex count
    (its first rows); the index draws then take real rows only, while the
    ``eig_*`` draws keep the padded row count (the solver masks those
    rows).  Unpadded sides draw the same values as without them.
    """
    with spans.before_call("draws"):
        rng = np.random.default_rng(seed)
        draws = {}
        if cfg.icp_register_first:
            n_moving, real_moving = ((n_target, real_target) if cfg.icp_reg_target_to_source
                                     else (n_source, real_source))
            draws["icp_landmarks"] = _choice(rng, n_moving, cfg.icp_n_landmarks,
                                             real_moving)
        draws["eigsort_target"] = _choice(rng, n_target, cfg.n_coords_spectral_ordering,
                                          real_target)
        draws["eigsort_source"] = _choice(rng, n_source, cfg.n_coords_spectral_ordering,
                                          real_source)
        n_reg = min(cfg.n_coords_spectral_registration, n_target, n_source)
        draws["cpd_source"] = _choice(rng, n_source, n_reg, real_source)
        draws["cpd_target"] = _choice(rng, n_target, n_reg - n_landmarks, real_target)
        wide_t = _solver(cfg, n_target) == "wide"
        wide_s = _solver(cfg, n_source) == "wide"
        if wide_t:
            draws["eig_block_target"] = _normal_draw(
                seed, "eig_block_target", (n_target, cfg.eig_wide_block))
        if wide_s and not _warm_supported(cfg, n_target, n_source):
            draws["eig_block_source"] = _normal_draw(
                seed, "eig_block_source", (n_source, cfg.eig_wide_block))
        p = min(min(cfg.non_rigid_n_eigens, n_reg) + 16, n_reg)
        draws["cpd_omega"] = _normal_draw(seed, "cpd_omega", (n_reg, p))
        if ((source_block or _want_split(n_target, n_source)) and wide_s
                and "eig_block_source" not in draws):
            draws["eig_block_source"] = _normal_draw(
                seed, "eig_block_source", (n_source, cfg.eig_wide_block))
        for side, n, wide in (("target", n_target, wide_t), ("source", n_source, wide_s)):
            if not wide:
                draws[f"eig_start_{side}"] = _normal_draw(
                    seed, f"eig_start_{side}", (n, _start_width(cfg, n)))
        return draws


def host_draws(draws) -> dict:
    """``draws`` as host numpy arrays, each :class:`NormalDraw` drawn on the
    CPU: one set of values for runs on different devices to share."""
    return {name: _tensor_to(v, "cpu").numpy() for name, v in draws.items()}


def draw_seed(generator: torch.Generator) -> int:
    """The seed of the draws an entry point makes from ``generator``."""
    with spans.host_read("draw_seed"):
        return int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device))


def _tensor_to(v, device):
    """A numpy array or tensor on ``device``: floats f32, integers int64.  A
    :class:`NormalDraw` is drawn on ``device`` (counted as
    ``deferred_draws``)."""
    if isinstance(v, NormalDraw):
        spans.count("deferred_draws")
        return v.draw(device)
    t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
    dtype = torch.float32 if t.is_floating_point() else torch.int64
    return t.to(dtype=dtype, device=device)


def _host_arrays(values, device) -> int:
    """How many of ``values`` a move to ``device`` copies from the host's
    pageable memory: those not already tensors on ``device``, nor drawn
    there (:class:`NormalDraw`)."""
    device = torch.device(device)
    return sum(1 for v in values if not (isinstance(v, NormalDraw) or (
        torch.is_tensor(v) and v.device == device)))


def _draws_to(draws, device):
    with spans.host_read("draws_copy", _host_arrays(draws.values(), device)):
        return {name: _tensor_to(v, device) for name, v in draws.items()}


def _use_hungarian(cfg: PipelineConfig) -> bool:
    return "hungarian" in (cfg.initial_correspondence_type,
                           cfg.final_correspondence_type)


def _hungarian(ref_pts, query_pts):
    """One-to-one correspondences: the reference row assigned to each query
    row by the exact LAP on Euclidean (not squared) distances, the
    objective of the reference's cdist + linear_sum_assignment."""
    cost = torch.sqrt(torch.clamp(pairwise_sq_dists(query_pts, ref_pts), min=0.0))
    return sinkhorn_jv_lap(cost)


def _n_reg(cfg: PipelineConfig, target: GraphArrays, source: GraphArrays) -> int:
    """Size of the CPD control subsample."""
    return min(cfg.n_coords_spectral_registration, target.n_points,
               source.n_points)


def _n_real_vertices(*graphs) -> list:
    """Each graph's real vertex count (rows with ``valid_mask`` > 0), read
    from the device in one transfer."""
    counts = torch.stack([(g.valid_mask > 0).sum() for g in graphs])
    with spans.host_read("n_real_vertices"):
        return [int(n) for n in counts.tolist()]


def _check_padding_hazards(target: GraphArrays, source: GraphArrays,
                           cfg: PipelineConfig, n_real):
    """The JAX package's guards against padding rows entering a
    registration (``pyfocusr_tpu/pipeline.py:746-787``), with its messages:
    'hungarian' on a padded graph (the assignment is one-to-one over all
    rows), and a subsample larger than a padded graph's real vertex count
    (the draw would take padding rows).  ``n_real``: the graphs' real
    vertex counts (:func:`_n_real_vertices`)."""
    for graph, name, real in ((target, "target", n_real[0]),
                              (source, "source", n_real[1])):
        if real == graph.n_points:
            continue
        if _use_hungarian(cfg):
            raise ValueError(
                f"'hungarian' correspondences need unpadded graphs: {name} "
                f"graph has {real} real vertices padded to "
                f"{graph.n_points}; assignment is one-to-one over ALL rows, "
                "so padding would participate. Rebuild without padding or "
                "use correspondence type 'kd'."
            )
        knobs = ["n_coords_spectral_ordering", "n_coords_spectral_registration"]
        if cfg.icp_register_first:
            knobs.append("icp_n_landmarks")
        for knob in knobs:
            if getattr(cfg, knob) > real:
                raise ValueError(
                    f"{knob}={getattr(cfg, knob)} exceeds the {name} graph's "
                    f"real vertex count {real} (padded to {graph.n_points}); "
                    "the subsample would draw padding rows. Lower it to "
                    f"<= {real}."
                )


def _check_supported(target: GraphArrays, source: GraphArrays,
                     cfg: PipelineConfig, landmark_pairs, n_real):
    _check_padding_hazards(target, source, cfg, n_real)
    if landmark_pairs is not None and (
            landmark_pairs.dim() != 2 or landmark_pairs.shape[1] != 2):
        raise ValueError(
            f"landmark_pairs must be [L, 2], got {tuple(landmark_pairs.shape)}"
        )
    if landmark_pairs is not None and landmark_pairs.shape[0] >= _n_reg(
            cfg, target, source):
        raise ValueError(
            "landmark_pairs must be fewer than n_coords_spectral_registration"
        )
    if _use_hungarian(cfg) and target.n_points != source.n_points:
        # The reference's guard: assignment is one-to-one over all rows.
        raise ValueError(
            "If number vertices between source & target don't match, "
            "correspondence type must be 'kd' and not 'hungarian'."
        )
    n_ft, n_fs = target.node_features.shape[1], source.node_features.shape[1]
    if cfg.use_features_as_coords and n_ft > 0 and n_ft != n_fs:
        raise ValueError(
            f"Number of extra features between target ({n_ft}) and source "
            f"({n_fs}) dont match!"
        )


def _warm_block_to(warm_block, device):
    """A ``warm_block`` dict checked as the JAX package checks it
    (:867-888), its tensors f32 on ``device``."""
    missing = [k for k in ("points", "block", "valid_mask") if k not in warm_block]
    if missing:
        raise ValueError(
            f"warm_block is missing key(s) {missing}: build it with "
            "warm_block_from_prepared"
        )
    n_t, n_b = warm_block["points"].shape[0], warm_block["block"].shape[0]
    if n_t != n_b or warm_block["valid_mask"].shape[0] != n_t:
        raise ValueError(
            f"warm_block is inconsistent: points has {n_t} rows, "
            f"block {n_b}, valid_mask "
            f"{warm_block['valid_mask'].shape[0]} — build it with "
            "warm_block_from_prepared"
        )
    keys = ("points", "block", "valid_mask")
    with spans.host_read("warm_block_copy", _host_arrays([warm_block[k] for k in keys], device)):
        return {k: _tensor_to(warm_block[k], device) for k in keys}


def register_pair(target: GraphArrays, source: GraphArrays,
                  cfg: PipelineConfig, generator: torch.Generator = None,
                  draws=None, landmark_pairs=None, warm_block=None):
    """Full registration of one mesh pair on the device the graphs lie on.
    From ``_SPLIT_SPECTRA_N`` vertices the spectra take the split-spectra
    schedule (see the module docstring).

    ``draws``: the random inputs (see :func:`make_draws`); when None they
    are drawn from ``generator`` (a fresh generator seeded 0 when that is
    None too).  ``generator`` also feeds the eigensolver's SVQB refill
    noise, drawn only for a rank-deficient block.

    ``landmark_pairs``: optional int [L, 2] known correspondences (source
    vertex, target vertex), L < n_reg (see
    :func:`landmark_pairs_from_positions`).  The target vertices become the
    first L CPD control points and pull toward their source vertices' spectral
    coordinates with weight ``cfg.landmark_weight`` (MAP CPD); ``draws``
    then holds n_reg - L ``cpd_target`` rows.

    ``warm_block``: a class-template seed from
    :func:`warm_block_from_prepared` (a prepared mesh of the same anatomy,
    roughly aligned with this pair's frame).  The target eigensolve then
    also starts from the template's filtered block, mapped through a
    spatial nearest neighbour, and runs the warm schedule
    (``eig_wide_chunks_warm`` chunks and the residual-gated top-up), so
    neither solve of a never-seen pair runs cold.  Ignored when ICP moves
    the target or the warm start does not apply.

    Returns a dict with the JAX package's keys:
    correspondences / initial_correspondences int64 [Ns],
    nearest_points / weighted_points / average_points f32 [Ns, 3],
    eig_vals_{target,source} [k], eig_vecs_target, eig_vecs_source_sorted,
    spectral_coords_{target,source}, smoothed_target_coords,
    source_projected_on_target, Q, and mutual_consistency when asked.
    """
    return _run(target, source, cfg, generator, draws, landmark_pairs,
                warm_block=warm_block)


@f32_matmuls
def _run(target, source, cfg, generator, draws, landmark_pairs, pre=None,
         pre_src=None, warm_block=None):
    """The checks and inputs every registration entry point shares, in
    the call's record (``utils/spans.py``): its stages from ``inputs``
    (these checks, the draws' copy to the device and the split spectra) to
    ``final_knn``, each a ``register_pair/<stage>`` profiler range."""
    with spans.call() as rec:
        rec.stage("inputs")
        spans.count("target_rows", target.n_points)
        spans.count("source_rows", source.n_points)
        if target.device != source.device:
            raise ValueError(
                f"target on {target.device} but source on {source.device}"
            )
        device = target.device
        if landmark_pairs is not None:
            with spans.host_read("landmarks_copy", _host_arrays([landmark_pairs], device)):
                landmark_pairs = torch.as_tensor(landmark_pairs).to(
                    dtype=torch.int64, device=device)
        n_real = _n_real_vertices(target, source)
        _check_supported(target, source, cfg, landmark_pairs, n_real)
        if warm_block is not None:
            warm_block = _warm_block_to(warm_block, device)
        for state, graph, name in ((pre, target, "target"), (pre_src, source, "source")):
            if state is not None and state["vecs"].shape[0] != graph.n_points:
                raise ValueError(
                    f"prepared {name} state has {state['vecs'].shape[0]} rows but "
                    f"the {name} mesh has {graph.n_points} vertices"
                )
        n_lm = 0 if landmark_pairs is None else landmark_pairs.shape[0]
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if draws is None:
            draws = make_draws(draw_seed(generator), cfg, target.n_points, source.n_points, n_lm,
                               real_target=n_real[0], real_source=n_real[1])
        draws = _draws_to(draws, device)
        n_cpd_target = _n_reg(cfg, target, source) - n_lm
        if draws["cpd_target"].shape[0] != n_cpd_target:
            raise ValueError(
                f"draws['cpd_target'] has {draws['cpd_target'].shape[0]} rows; "
                f"n_reg - len(landmark_pairs) = {n_cpd_target}"
            )
        if _want_split(target.n_points, source.n_points):
            pre, pre_src = _split_spectra(target, source, cfg, generator, draws, pre,
                                          pre_src, warm_block)
        return _register_pair(target, source, cfg, generator, draws, rec.stage,
                              landmark_pairs, pre=pre, pre_src=pre_src,
                              warm_block=warm_block)


def _split_spectra(target, source, cfg, generator, draws, pre, pre_src, warm_block):
    """The split-spectra schedule (``pyfocusr_tpu/pipeline.py:889-908``,
    :1078-1090, :1195-1199): the spectra a pair's entry point has not been
    given are solved before the pair, as :func:`prepare_target` and
    :func:`prepare_source` solve them.  The target is hoisted unless ICP
    moves it; the source when :func:`source_spectrum_hoistable`, warm from
    the hoisted target's block through the unmoved points when the warm
    start applies and ICP is off, else cold (with ICP the fused schedule
    maps through the moved points, which do not exist yet).  A target left
    inline then starts from the hoisted source's block where the warm start
    applies (``_register_pair``).  Each solve reads the draw it reads in
    the fused schedule.  Returns (pre, pre_src)."""
    moves_target = cfg.icp_register_first and cfg.icp_reg_target_to_source
    if pre is None and not moves_target:
        wide_warm = warm_block is not None and _keeps_block(cfg, target)
        init = (draws.get("eig_block_target") if wide_warm
                else _start(draws, "target", cfg, target))
        pre = _prepare_target(target, cfg, init, warm_block, generator)
    if pre_src is None and source_spectrum_hoistable(cfg):
        x0 = None
        if (pre is not None and pre.get("block") is not None
                and _warm_supported(cfg, target.n_points, source.n_points)
                and not cfg.icp_register_first):
            x0 = _warm_x0(pre["block"], target.points, target.valid_mask, source.points)
        init = (draws.get("eig_block_source") if x0 is not None
                else _start(draws, "source", cfg, source))
        pre_src = _prepare_source(source, cfg, init, generator, x0=x0)
    return pre, pre_src


def warm_block_from_prepared(prep, template: GraphArrays = None):
    """The ``register_pair(warm_block=...)`` seed from a prepared template
    (``pyfocusr_tpu/pipeline.py:915-969``): the template's geometry and its
    filtered eigensolver block (:func:`prepare_target` keeps it when
    ``eig_warm_start`` is on; saves carry it).  ``template`` may be omitted
    when ``prep`` was loaded from a save that embeds the template geometry
    (:func:`save_prepared_target` with ``target=``).  A block whose rows do
    not match the template raises, as in the JAX package."""
    if prep.get("block") is None:
        raise ValueError(
            "prepared state carries no filtered block — re-run "
            "prepare_target with eig_warm_start=True (wide-chebyshev path)"
        )
    if template is None:
        if prep.get("warm_points") is None:
            raise ValueError(
                "prepared state does not embed the template geometry — "
                "pass the template GraphArrays, or re-save with "
                "save_prepared_target(..., target=template)"
            )
        if prep["block"].shape[0] != prep["warm_points"].shape[0]:
            raise ValueError(
                f"prepared block has {prep['block'].shape[0]} rows but the "
                f"embedded template geometry has "
                f"{prep['warm_points'].shape[0]} — corrupt or hand-edited "
                "save"
            )
        return {
            "points": prep["warm_points"],
            "valid_mask": prep["warm_valid_mask"],
            "block": prep["block"],
        }
    if prep["block"].shape[0] != template.points.shape[0]:
        raise ValueError(
            f"prepared block has {prep['block'].shape[0]} rows but the "
            f"template mesh has {template.points.shape[0]} vertices — "
            "the prepared state belongs to a different mesh"
        )
    return {
        "points": template.points,
        "valid_mask": template.valid_mask,
        "block": prep["block"],
    }


def _init_block(init_block, graph: GraphArrays, cfg: PipelineConfig, generator):
    """The eigensolve's random start on the graph's device: the caller's
    draw, or standard normals from ``generator``."""
    if init_block is None:
        init_block = torch.randn(
            (graph.n_points, _start_width(cfg, graph.n_points)),
            generator=generator, device=generator.device)
    return _tensor_to(init_block, graph.device)


def _keeps_block(cfg: PipelineConfig, graph: GraphArrays) -> bool:
    """Whether a prepared solve keeps its filtered block (the JAX gates of
    ``pipeline.py:977, 1099-1102``): the warm start on, on the wide path."""
    return cfg.eig_warm_start and _solver(cfg, graph.n_points) == "wide"


def _start(draws, side: str, cfg: PipelineConfig, graph: GraphArrays):
    """A side's cold-solve start from ``draws``: ``eig_block_<side>`` on the
    wide path, ``eig_start_<side>`` on the others."""
    name = ("eig_block_" if _solver(cfg, graph.n_points) == "wide"
            else "eig_start_") + side
    if name not in draws:
        raise ValueError(
            f"the {side} eigensolve runs cold here: draws need {name!r}, see "
            "make_draws (with source_block=True for a wide source block)"
        )
    return draws[name]


def _smooth_fn(cfg: PipelineConfig):
    return (graph_ops.mean_filter_chebyshev if cfg.smoothing_method == "chebyshev"
            else graph_ops.mean_filter)


def _warm_schedule(cfg: PipelineConfig):
    """The truncated schedule of a warm-started solve."""
    return dict(chunks=cfg.eig_wide_chunks_warm,
                extra_chunks=max(cfg.eig_wide_chunks - cfg.eig_wide_chunks_warm, 0),
                degree=cfg.eig_wide_degree_warm)


def prepare_target(target: GraphArrays, cfg: PipelineConfig, init_block=None,
                   warm_block=None, generator: torch.Generator = None):
    """The target-only state for template serving
    (``pyfocusr_tpu/pipeline.py:974-1054``): the target's spectrum, graph
    operators and smoothed points, and, when ``eig_warm_start`` is on, its
    filtered eigensolver block (it seeds each served pair's source solve).
    Pass it to :func:`register_pair_prepared`; persist it with
    :func:`save_prepared_target`.

    ``init_block``: the eigensolve's random start, ``make_draws(...)
    ["eig_block_target"]`` on the wide path, ``["eig_start_target"]`` on
    the narrow or Lanczos one (standard normals from ``generator``, a fresh
    one seeded 0, when None).  With the same draws,
    ``register_pair_prepared(prepare_target(t, cfg, draws["eig_block_target"]),
    t, s, cfg, draws=draws)`` equals ``register_pair(t, s, cfg,
    draws=draws)`` bit for bit on the CPU.

    ``warm_block``: a class-template seed from
    :func:`warm_block_from_prepared`; this solve then starts warm and runs
    the truncated schedule (wide path only).  ``icp_reg_target_to_source=True``
    moves the target per pair and is rejected."""
    if cfg.icp_register_first and cfg.icp_reg_target_to_source:
        raise ValueError(
            "prepare_target requires a fixed target; "
            "icp_reg_target_to_source=True moves the target per pair"
        )
    if warm_block is not None:
        warm_block = _warm_block_to(warm_block, target.device)
    if generator is None:
        generator = torch.Generator(device=target.device).manual_seed(0)
    init_block = _init_block(init_block, target, cfg, generator)
    return _prepare_target(target, cfg, init_block, warm_block, generator)


@f32_matmuls
def _prepare_target(target, cfg, init_block, warm_block, generator):
    k_total = cfg.n_total
    blk = None
    with spans.span("prepare_target/spectra"):
        if _keeps_block(cfg, target):
            x0, sched = None, {}
            if warm_block is not None:
                x0 = _warm_x0(warm_block["block"], warm_block["points"],
                              warm_block["valid_mask"], target.points)
                sched = _warm_schedule(cfg)
            lams, vecs, w, blk = _spectrum(
                target, k_total, cfg, init_block, x0=x0, return_block=True,
                generator=generator, **sched,
            )
        else:
            lams, vecs, w = _spectrum(target, k_total, cfg, init_block,
                                      generator=generator)
    smoothed = target.points
    if cfg.smooth_correspondences:
        with spans.span("prepare_target/smoothing"):
            smoothed = _smooth_fn(cfg)(
                target.neighbors, w[0], target.points,
                cfg.graph_smoothing_iterations, w[1], w[2],
            )
    out = {"lams": lams, "vecs": vecs, "w": w, "smoothed_points": smoothed}
    if blk is not None:
        out["block"] = blk
    return out


def register_pair_prepared(prep, target: GraphArrays, source: GraphArrays,
                           cfg: PipelineConfig, generator: torch.Generator = None,
                           draws=None, landmark_pairs=None):
    """Register ``source`` onto a target prepared by :func:`prepare_target`
    (``pyfocusr_tpu/pipeline.py:1057-1093``): the contract of
    :func:`register_pair` without the target's eigensolve and smoothing.
    Reads no ``draws["eig_block_target"]``.  From ``_SPLIT_SPECTRA_N``
    vertices the source solve is hoisted before the pair (see the module
    docstring): warm from the prepared block through the unmoved points
    without ICP, cold from ``draws["eig_block_source"]`` with it."""
    if cfg.icp_register_first and cfg.icp_reg_target_to_source:
        raise ValueError(
            "register_pair_prepared requires a fixed target (prepared state "
            "was computed from the unmoved target); "
            "icp_reg_target_to_source=True moves it per pair"
        )
    return _run(target, source, cfg, generator, draws, landmark_pairs, pre=prep)


def source_spectrum_hoistable(cfg: PipelineConfig) -> bool:
    """Whether the source spectrum and operators are pair-independent under
    ``cfg`` (``pyfocusr_tpu/pipeline.py:1125-1142``): rigid motion keeps
    the edge weights, 'similarity' ICP moving the source rescales them and
    so the smoothing operator."""
    return not (
        cfg.icp_register_first
        and not cfg.icp_reg_target_to_source
        and cfg.icp_registration_mode != "rigid"
    )


def prepare_source(source: GraphArrays, cfg: PipelineConfig, init_block=None,
                   generator: torch.Generator = None):
    """The source-only state (spectrum and graph operators) for the
    cohort direction of template serving, one template as the source
    (``pyfocusr_tpu/pipeline.py:1145-1173``).  The solve runs cold from
    ``init_block`` (``make_draws(..., source_block=True)
    ["eig_block_source"]`` on the wide path, ``["eig_start_source"]`` on the
    others; standard normals from ``generator`` when None) and keeps its
    filtered block when ``eig_warm_start`` is on and the solve is wide.

    With ``icp_register_first=False`` and ``eig_warm_start=False`` and the
    same draws, :func:`register_pair_prepared_source` equals
    :func:`register_pair` bit for bit on the CPU; with the warm start on,
    the pair's own source solve would start from the target's block, so
    the two agree to solver tolerance."""
    if not source_spectrum_hoistable(cfg):
        raise ValueError(
            "prepare_source requires pair-independent source operators; "
            "icp_registration_mode='similarity' with the source moving "
            "per pair rescales the smoothing operator. Use rigid ICP, "
            "icp_reg_target_to_source=True, or icp_register_first=False."
        )
    if generator is None:
        generator = torch.Generator(device=source.device).manual_seed(0)
    init_block = _init_block(init_block, source, cfg, generator)
    return _prepare_source(source, cfg, init_block, generator)


@f32_matmuls
def _prepare_source(source, cfg, init_block, generator, x0=None):
    with spans.span("prepare_source/spectra"):
        if x0 is not None:
            # Warm from a hoisted target's block (the split-spectra
            # schedule): the truncated schedule, and no block kept.
            lams, vecs, w = _spectrum(source, cfg.n_total, cfg, init_block, x0=x0,
                                      generator=generator, **_warm_schedule(cfg))
            return {"lams": lams, "vecs": vecs, "w": w}
        if _keeps_block(cfg, source):
            lams, vecs, w, blk = _spectrum(source, cfg.n_total, cfg, init_block,
                                           return_block=True, generator=generator)
            return {"lams": lams, "vecs": vecs, "w": w, "block": blk}
        lams, vecs, w = _spectrum(source, cfg.n_total, cfg, init_block,
                                  generator=generator)
        return {"lams": lams, "vecs": vecs, "w": w}


def register_pair_prepared_source(prep_src, target: GraphArrays,
                                  source: GraphArrays, cfg: PipelineConfig,
                                  generator: torch.Generator = None, draws=None,
                                  landmark_pairs=None):
    """Register onto ``target`` with a source prepared by
    :func:`prepare_source` (``pyfocusr_tpu/pipeline.py:1176-1202``): the
    contract of :func:`register_pair` without the source's eigensolve; the
    target solve starts from the prepared block when the warm start
    applies.  Reads no ``draws["eig_block_source"]``.  From
    ``_SPLIT_SPECTRA_N`` vertices a fixed target is solved cold before the
    pair (see the module docstring) and seeds nothing from the prepared
    block."""
    if not source_spectrum_hoistable(cfg):
        raise ValueError(
            "register_pair_prepared_source: cfg is not source-hoistable "
            "(similarity ICP moving the source per pair); see prepare_source"
        )
    return _run(target, source, cfg, generator, draws, landmark_pairs,
                pre_src=prep_src)


def _jax_array(x) -> np.ndarray:
    """A tensor or array as the JAX package holds it: floats f32,
    integers int32."""
    a = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return a.astype(np.int32 if a.dtype.kind in "iu" else np.float32)


def _graph_fingerprint(graph: GraphArrays) -> str:
    """Content hash of a graph's geometry, topology and features
    (``pyfocusr_tpu/pipeline.py:1205-1220``), over the arrays in the JAX
    package's dtypes (the port's int64 neighbours and overflow edges as
    int32), so a graph hashes the same in both packages."""
    h = hashlib.sha256()
    for arr in (graph.points, graph.neighbors, graph.nbr_mask,
                graph.valid_mask, graph.overflow, graph.node_features):
        a = _jax_array(arr)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# Knobs that never change the prepared state itself, kept out of the
# fingerprint (``pyfocusr_tpu/pipeline.py:1223-1238``): the per-run CPD
# landmark weight, and the warm-start knobs, which decide whether the block
# is attached and how a pair's solve consumes it.
_FP_SKIP = frozenset((
    "landmark_weight", "eig_warm_start", "eig_wide_chunks_warm",
    "eig_wide_degree_warm", "eig_warm_resid_tol",
))


def _cfg_fingerprint(cfg: PipelineConfig) -> str:
    """Canonical config string (``pyfocusr_tpu/pipeline.py:1241-1259``):
    the fields that differ from their defaults, sorted by name, without
    ``_FP_SKIP``."""
    fields = PipelineConfig.__dataclass_fields__
    parts = [
        f"{name}={getattr(cfg, name)!r}"
        for name in sorted(fields)
        if name not in _FP_SKIP and getattr(cfg, name) != fields[name].default
    ]
    return "PipelineConfig(" + ", ".join(parts) + ")"


def _fingerprint_matches(stored: str, cfg: PipelineConfig) -> bool:
    """Whether a stored fingerprint denotes the same prepared state as
    ``cfg`` (``pyfocusr_tpu/pipeline.py:1262-1298``): the canonical form, or
    an older full-``repr`` one reduced the same way."""
    if stored == _cfg_fingerprint(cfg):
        return True
    fields = PipelineConfig.__dataclass_fields__
    try:
        call = ast.parse(stored.strip(), mode="eval").body
        if not isinstance(call, ast.Call) or any(
            kw.arg is None for kw in call.keywords
        ):
            return False
        kept = {}
        for kw in call.keywords:
            val = ast.literal_eval(kw.value)
            if kw.arg in _FP_SKIP:
                continue
            if kw.arg in fields and val == fields[kw.arg].default:
                continue
            kept[kw.arg] = val
    except (SyntaxError, ValueError):
        return False
    current = {
        name: getattr(cfg, name)
        for name in fields
        if name not in _FP_SKIP and getattr(cfg, name) != fields[name].default
    }
    return kept == current


def _text(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8).copy()


def save_prepared_target(path: str, prep, cfg: PipelineConfig = None,
                         target: GraphArrays = None) -> None:
    """Persist a :func:`prepare_target` state to ``.npz``
    (``pyfocusr_tpu/pipeline.py:1301-1330``), in the JAX package's layout
    and dtypes (the overflow edges ``w[1]`` as int32), so either package
    loads it.  ``cfg`` embeds a config fingerprint, ``target`` a mesh
    fingerprint and the template geometry (for
    :func:`warm_block_from_prepared` without a template)."""
    tree = {name: tuple(_jax_array(x) for x in v) if name == "w"
            else _jax_array(v) for name, v in prep.items()}
    if cfg is not None:
        tree["cfg_fingerprint"] = _text(_cfg_fingerprint(cfg))
    if target is not None:
        tree["target_fingerprint"] = _text(_graph_fingerprint(target))
        tree["warm_points"] = _jax_array(target.points)
        tree["warm_valid_mask"] = _jax_array(target.valid_mask)
    save_results(path, tree)


def load_prepared_target(path: str, cfg: PipelineConfig = None,
                         target: GraphArrays = None, device=None):
    """Inverse of :func:`save_prepared_target`, for saves of either package
    (``pyfocusr_tpu/pipeline.py:1333-1376``), on ``device``: the CUDA card
    by default (see ``utils.device.resolve_device``); the overflow edges
    come back int64.  With ``cfg`` (resp. ``target``), the stored config
    (resp. mesh) fingerprint must match, when the file carries one."""
    device = resolve_device(device)
    flat = load_results(path)
    if cfg is not None and "['cfg_fingerprint']" in flat:
        stored = bytes(flat["['cfg_fingerprint']"]).decode()
        if not _fingerprint_matches(stored, cfg):
            raise ValueError(
                "prepared-target state was saved under a different "
                "PipelineConfig; re-run prepare_target (stored: "
                f"{stored[:200]}...)"
            )
    if target is not None and "['target_fingerprint']" in flat:
        stored = bytes(flat["['target_fingerprint']"]).decode()
        if stored != _graph_fingerprint(target):
            raise ValueError(
                "prepared-target state does not match this target mesh "
                "(geometry/topology/feature hash mismatch — a different "
                "mesh, or a checkpoint saved under an older fingerprint "
                "format). Re-run prepare_target on the current mesh."
            )
    w = []
    while f"['w']/[{len(w)}]" in flat:
        w.append(_tensor_to(flat[f"['w']/[{len(w)}]"], device))
    out = {"w": tuple(w)}
    for name in ("lams", "vecs", "smoothed_points", "block", "warm_points",
                 "warm_valid_mask"):
        if f"['{name}']" in flat:
            out[name] = _tensor_to(flat[f"['{name}']"], device)
    return out


def _masked_minmax(arr, mask):
    """Column minima and maxima of ``arr`` over real vertices only."""
    real = mask[:, None] > 0
    with spans.host_read("scalar_copy"):
        inf = torch.tensor(float("inf"), device=arr.device)
    return (torch.where(real, arr, inf).min(dim=0).values,
            torch.where(real, arr, -inf).max(dim=0).values)


def _normed_points(graph: GraphArrays):
    """xyz shifted to the per-axis minimum and divided by the mean axis
    range (real vertices only); returns (normalized points, mean range)."""
    mn, mx = _masked_minmax(graph.points, graph.valid_mask)
    mean_range = (mx - mn).mean()
    normed = (graph.points - mn[None, :]) / torch.clamp(mean_range, min=1e-30)
    return normed * graph.valid_mask[:, None], mean_range


def _register_pair(target, source, cfg, generator, draws, stage,
                   landmark_pairs=None, pre=None, pre_src=None, warm_block=None):
    device = target.device
    k_total = cfg.n_total

    # --- ICP pre-alignment: moves the source onto the target (or the
    # target onto the source with icp_reg_target_to_source). ---
    stage("icp")
    if cfg.icp_register_first:
        moving, fixed = (
            (target, source) if cfg.icp_reg_target_to_source else (source, target)
        )
        fixed_q = torch.where(
            fixed.valid_mask[:, None] > 0, fixed.points,
            torch.full_like(fixed.points, SENTINEL),
        )
        (s_, R_, t_), _ = icp_fit(
            moving.points[draws["icp_landmarks"]], fixed_q,
            mode=cfg.icp_registration_mode, max_iterations=cfg.icp_iterations,
        )
        moved = apply_rigid(moving.points, s_, R_, t_)
        moving = dataclasses.replace(
            moving, points=moved * moving.valid_mask[:, None]
        )
        if cfg.icp_reg_target_to_source:
            target = moving
        else:
            source = moving

    stage("spectra")
    # --- Spectra (the branch table of pyfocusr_tpu/pipeline.py:1445-1512).
    # A warm-started solve maps a filtered block onto its mesh through a
    # spatial NN and runs the truncated schedule with the residual-gated
    # top-up; ``pre`` / ``pre_src`` carry a prepared side's spectrum. ---
    warm_ok = _warm_supported(cfg, target.n_points, source.n_points)
    blk_t = None
    if pre is None:
        if warm_ok and pre_src is not None and pre_src.get("block") is not None:
            # The prepared source (a template) seeds the target solve.
            x0_t = _warm_x0(pre_src["block"], source.points, source.valid_mask,
                            target.points)
            lams_t, vecs_t, w_t = _spectrum(
                target, k_total, cfg, draws.get("eig_block_target"), x0=x0_t,
                generator=generator, **_warm_schedule(cfg),
            )
        elif (warm_ok and warm_block is not None
              and not (cfg.icp_register_first and cfg.icp_reg_target_to_source)):
            # A class template seeds the target solve, whose block then
            # seeds the source's; off when ICP moves the target.
            x0_t = _warm_x0(warm_block["block"], warm_block["points"],
                            warm_block["valid_mask"], target.points)
            lams_t, vecs_t, w_t, blk_t = _spectrum(
                target, k_total, cfg, draws.get("eig_block_target"), x0=x0_t,
                return_block=True, generator=generator, **_warm_schedule(cfg),
            )
        elif warm_ok and pre_src is None:
            lams_t, vecs_t, w_t, blk_t = _spectrum(
                target, k_total, cfg, draws["eig_block_target"],
                return_block=True, generator=generator,
            )
        else:
            lams_t, vecs_t, w_t = _spectrum(
                target, k_total, cfg, _start(draws, "target", cfg, target),
                generator=generator,
            )
    else:
        lams_t, vecs_t, w_t = pre["lams"], pre["vecs"], pre["w"]
        if warm_ok:
            blk_t = pre.get("block")
    if pre_src is None:
        if warm_ok and blk_t is not None:
            x0_s = _warm_x0(blk_t, target.points, target.valid_mask, source.points)
            lams_s, vecs_s, w_s = _spectrum(
                source, k_total, cfg, draws.get("eig_block_source"), x0=x0_s,
                generator=generator, **_warm_schedule(cfg),
            )
        else:
            lams_s, vecs_s, w_s = _spectrum(
                source, k_total, cfg, _start(draws, "source", cfg, source),
                generator=generator,
            )
    else:
        lams_s, vecs_s, w_s = pre_src["lams"], pre_src["vecs"], pre_src["w"]

    # --- eigsort ---
    stage("eigsort")
    idx_t, idx_s = draws["eigsort_target"], draws["eigsort_source"]
    sorted_vecs, Q = sort_eigenmaps(
        lams_t, lams_s, vecs_t[idx_t], vecs_s[idx_s],
        _normed(target.points[idx_t]), _normed(source.points[idx_s]),
        vecs_s if cfg.target_eigenmap_as_reference else vecs_t,
        target_as_reference=cfg.target_eigenmap_as_reference,
    )
    if cfg.target_eigenmap_as_reference:
        vecs_s_sorted, vecs_t_used = sorted_vecs, vecs_t
    else:
        vecs_s_sorted, vecs_t_used = vecs_s, sorted_vecs

    # --- Spectral coords ---
    k_use = cfg.n_spectral_features
    src_coords = vecs_s_sorted[:, :k_use]
    tgt_coords = vecs_t_used[:, :k_use]
    if cfg.get_weighted_spectral_coords:
        lam_max = torch.maximum(lams_s[:k_use], lams_t[:k_use])
        wspec = Q[:k_use] * lam_max
        sigma = wspec.mean()
        wspec = torch.exp(-(wspec**2) / (2.0 * sigma**2))
        src_coords = src_coords * wspec[None, :]
        tgt_coords = tgt_coords * wspec[None, :]
    smooth_fn = _smooth_fn(cfg)

    # --- Node features appended: each smoothed on its own mesh's graph,
    # min-max scaled to [0, 1], times the ptp of that mesh's spectral
    # coordinates (pyfocusr_tpu/pipeline.py:1563-1590). ---
    if cfg.use_features_as_coords and target.node_features.shape[1] > 0:

        def feature_cols(graph, w_arr, coords):
            mn_c, mx_c = _masked_minmax(coords, graph.valid_mask)
            ptp = mx_c.max() - mn_c.min()
            sm = smooth_fn(graph.neighbors, w_arr[0], graph.node_features,
                           cfg.feature_smoothing_iterations, w_arr[1], w_arr[2])
            mn, mx = _masked_minmax(sm, graph.valid_mask)
            sm = (sm - mn[None, :]) / torch.clamp(mx - mn, min=1e-30)[None, :]
            return ptp * sm * graph.valid_mask[:, None]

        src_coords = torch.cat([src_coords, feature_cols(source, w_s, src_coords)],
                               dim=1)
        tgt_coords = torch.cat([tgt_coords, feature_cols(target, w_t, tgt_coords)],
                               dim=1)

    # --- xyz appended as features ---
    if cfg.include_points_as_features:
        np_s, range_s = _normed_points(source)
        np_t, range_t = _normed_points(target)
        if cfg.norm_physical_and_spectral:
            src_coords = torch.cat([src_coords, np_s], dim=1)
            tgt_coords = torch.cat([tgt_coords, np_t], dim=1)
        else:
            src_coords = torch.cat([src_coords * range_s, source.points], dim=1)
            tgt_coords = torch.cat([tgt_coords * range_t, target.points], dim=1)

    # --- CPD: move the target spectral cloud onto the source's ---
    stage("cpd")
    n_reg = _n_reg(cfg, target, source)
    X = src_coords[draws["cpd_source"]]
    cpd_landmarks = None
    if landmark_pairs is not None:
        # The landmark target vertices are the first control points, so the
        # prior terms act on real control points.
        n_lm = landmark_pairs.shape[0]
        Y = tgt_coords[torch.cat([landmark_pairs[:, 1], draws["cpd_target"]])]
        cpd_landmarks = (
            torch.arange(n_lm, device=device),
            src_coords[landmark_pairs[:, 0]],
            torch.full((n_lm,), cfg.landmark_weight, dtype=torch.float32,
                       device=device),
        )
    else:
        Y = tgt_coords[draws["cpd_target"]]
    # Above 3000^2 pairs the responsibilities are streamed, never formed.
    estep_impl = cpd_ops._estep_route(n_reg, n_reg, None)
    spans.count("cpd_rows", Y.shape[0])
    spans.count("cpd_cols", X.shape[0])
    spans.count("cpd_dims", X.shape[1])
    spans.count("estep_streamed", int(estep_impl == "streamed"))
    if cfg.rigid_before_non_rigid_reg:
        _, B, t_vec, _, _ = cpd_ops._affine_cpd_run(
            X, Y, cfg.rigid_reg_max_iterations, cfg.rigid_tolerance,
            w=cfg.non_rigid_outlier_w, estep_impl=estep_impl,
        )
        Y = Y @ B.T + t_vec[None, :]
        tgt_coords = tgt_coords @ B.T + t_vec[None, :]
    num_eig = min(cfg.non_rigid_n_eigens, n_reg)
    with spans.span("cpd/gram"):
        Qg, lam_g = cpd_ops.low_rank_gaussian(
            Y, cfg.non_rigid_beta, num_eig, draws["cpd_omega"]
        )
    _, z_cpd, _, _ = cpd_ops._deformable_cpd_run(
        X, Y, Qg, lam_g, cfg.non_rigid_alpha, cfg.non_rigid_max_iterations,
        cfg.non_rigid_tolerance, w=cfg.non_rigid_outlier_w,
        estep_impl=estep_impl, landmarks=cpd_landmarks,
    )
    tgt_coords_moved = cpd_ops.lowrank_transform(
        tgt_coords, Y, Qg, lam_g, z_cpd, cfg.non_rigid_beta
    )

    # --- Initial correspondences (padding target rows never selected) ---
    stage("correspondences")
    tmask = target.valid_mask[:, None]
    tgt_coords_q = torch.where(
        tmask > 0, tgt_coords_moved, torch.full_like(tgt_coords_moved, SENTINEL)
    )
    if cfg.initial_correspondence_type == "hungarian":
        init_corr = _hungarian(tgt_coords_moved, src_coords)
    else:
        _, init_corr = nn_query(tgt_coords_q, src_coords)
    mutual = None
    if cfg.compute_mutual_consistency:
        src_q = torch.where(
            source.valid_mask[:, None] > 0, src_coords,
            torch.full_like(src_coords, SENTINEL),
        )
        _, rev_corr = nn_query(src_q, tgt_coords_moved)
        arange = torch.arange(init_corr.shape[0], device=device)
        mutual = (rev_corr[init_corr] == arange).to(torch.float32) * source.valid_mask

    # --- Smoothing ---
    stage("smoothing")
    corr = init_corr
    smoothed_tgt = target.points
    projected = source.points
    if cfg.smooth_correspondences:
        if pre is None:
            smoothed_tgt = smooth_fn(
                target.neighbors, w_t[0], target.points,
                cfg.graph_smoothing_iterations, w_t[1], w_t[2],
            )
        else:
            smoothed_tgt = pre["smoothed_points"]
        projected = smooth_fn(
            source.neighbors, w_s[0], smoothed_tgt[init_corr],
            cfg.projection_smooth_iterations, w_s[1], w_s[2],
        )
        if cfg.final_correspondence_type == "hungarian":
            stage("final_hungarian")
            corr = _hungarian(smoothed_tgt, projected)

    # --- Final locations: one k=3 query gives the IDW weights and, for
    # 'kd', the final correspondence (column 0). ---
    stage("final_knn")
    d3, i3 = knn3_masked(smoothed_tgt, target.valid_mask, projected)
    if cfg.smooth_correspondences and cfg.final_correspondence_type == "kd":
        corr = i3[:, 0]
    weighted = idw_from_knn(d3, i3, target.points)
    nearest = target.points[corr]
    average = (source.points + weighted) / 2.0

    smask = source.valid_mask[:, None]
    svalid = source.valid_mask.to(torch.int64)
    out = {
        "correspondences": corr * svalid,
        "initial_correspondences": init_corr * svalid,
        "nearest_points": nearest * smask,
        "weighted_points": weighted * smask,
        "average_points": average * smask,
        "eig_vals_target": lams_t,
        "eig_vals_source": lams_s,
        "eig_vecs_target": vecs_t_used * tmask,
        "eig_vecs_source_sorted": vecs_s_sorted * smask,
        "spectral_coords_target": tgt_coords_moved * tmask,
        "spectral_coords_source": src_coords * smask,
        "smoothed_target_coords": smoothed_tgt * tmask,
        "source_projected_on_target": projected * smask,
        "Q": Q,
    }
    if mutual is not None:
        out["mutual_consistency"] = mutual
    return out
