"""The FOCUSR registration of one mesh pair through the reference's class
API.

Counterpart of ``pyfocusr_tpu/focusr.py``: ``Focusr`` (:47) with its
constructor (:48-222: ICP of the full clouds, both ``Graph`` objects with
seeds ``seed`` and ``seed + 1``, the deferred spectra), ``align_maps``
stage by stage (:654-731), ``align_maps_pipeline`` over ``register_pair``
(:531-642), the correspondences, final locations, average shape, scalar
setters, transformed meshes, ``transfer_point_data`` (:437),
``icp_transform``, ``registration_quality`` and the viewers (:782-985:
the ``view_*`` methods over the optional itkwidgets, ``utils/viz.py``,
and ``export_viewer_html`` over ``utils/html_viewer.py``).

The one argument beyond the JAX signature is ``device``: the class builds
on the CUDA card unless the caller names the CPU
(``utils.device.resolve_device``).  Every stage runs there: ICP and the
nearest-neighbour queries launch the k-NN kernel (ICP the 3x3 close too),
CPD above 3000^2 pairs the E-step kernel, and 'hungarian' correspondences
above ``ops.assignment.DEVICE_THRESHOLD`` vertices the JV kernel after the
Sinkhorn kernel's warm start; smaller assignments take the host library's
``lap_host`` (``ops.assignment.linear_sum_assignment``).  Index results
(``corresponding_target_idx_for_each_source_pt``) are numpy, as in the JAX
class; point results are tensors on the device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import pipeline
from .mesh import TriMesh, as_trimesh
from .metrics import registration_quality as _registration_quality
from .ops import cpd
from .ops.assignment import linear_sum_assignment
from .ops.icp import icp as icp_fit
from .ops.knn import idw_from_knn, knn_query, nn_query, pairwise_sq_dists
from .spectral.eigsort import eigsort
from .spectral.graph import Graph
from .utils.device import resolve_device, to_numpy
from .utils.logging import StageTimer, print_header

__all__ = ["Focusr"]


class Focusr(object):
    def __init__(
        self,
        vtk_mesh_target: TriMesh,
        vtk_mesh_source: TriMesh,
        icp_register_first=True,
        icp_registration_mode="rigid",  # 'rigid' | 'similarity'
        icp_reg_target_to_source=False,
        n_spectral_features=3,
        n_extra_spectral=3,
        target_eigenmap_as_reference=True,
        norm_physical_and_spectral=True,
        n_coords_spectral_ordering=5000,
        n_coords_spectral_registration=5000,
        rigid_before_non_rigid_reg=True,
        rigid_reg_max_iterations=100,
        rigid_tolerance=1e-8,
        non_rigid_max_iterations=1000,
        non_rigid_tolerance=1e-8,
        non_rigid_alpha=0.5,
        non_rigid_beta=3.0,
        non_rigid_n_eigens=100,
        non_rigid_outlier_w=0.0,  # CPD outlier weight in [0, 1)
        include_points_as_features=False,
        get_weighted_spectral_coords=True,
        graph_smoothing_iterations=300,
        feature_smoothing_iterations=40,
        smooth_correspondences=True,
        return_average_final_points=True,
        return_nearest_final_points=True,
        return_transformed_mesh=True,
        projection_smooth_iterations=40,
        feature_weights=None,
        initial_correspondence_type="kd",  # 'kd' | 'hungarian'
        final_correspondence_type="kd",  # 'kd' | 'hungarian'
        list_features_to_calc=("curvature",),
        list_features_to_get_from_mesh=(),
        use_features_as_coords=False,
        use_features_in_graph=False,
        include_features_in_adj_matrix=False,
        G_matrix_p_function="exp",
        norm_node_features_std=True,
        norm_node_features_cap_std=3,
        norm_node_features_0_1=True,
        verbose=False,
        seed=0,
        timer: StageTimer | None = None,
        device=None,
    ):
        self.verbose = verbose
        self.timer = timer if timer is not None else StageTimer(verbose=verbose)
        self.device = resolve_device(device)
        if verbose:
            print("Starting Focusr")
        # Both meshes' points become f32 tensors on the device.
        vtk_mesh_target, vtk_mesh_source = (
            m.with_points(torch.as_tensor(m.points, device=self.device).to(torch.float32))
            for m in (as_trimesh(vtk_mesh_target), as_trimesh(vtk_mesh_source)))
        self.n_spectral_features = n_spectral_features
        self.n_extra_spectral = n_extra_spectral
        self.n_total_spectral_features = n_spectral_features + n_extra_spectral
        self.target_eigenmap_as_reference = target_eigenmap_as_reference
        self.norm_physical_and_spectral = norm_physical_and_spectral
        self.include_points_as_features = include_points_as_features
        self.get_weighted_spectral_coords = get_weighted_spectral_coords
        self.feature_smoothing_iterations = feature_smoothing_iterations
        self.n_coords_spectral_registration = n_coords_spectral_registration
        self.rigid_before_non_rigid_reg = rigid_before_non_rigid_reg
        self.rigid_reg_max_iterations = rigid_reg_max_iterations
        self.rigid_tolerance = rigid_tolerance
        self.non_rigid_max_iterations = non_rigid_max_iterations
        self.non_rigid_tolerance = non_rigid_tolerance
        self.non_rigid_alpha = non_rigid_alpha
        self.non_rigid_beta = non_rigid_beta
        self.non_rigid_n_eigens = non_rigid_n_eigens
        self.non_rigid_outlier_w = non_rigid_outlier_w
        self.initial_correspondence_type = initial_correspondence_type
        self.smooth_correspondences = smooth_correspondences
        self.return_average_final_points = return_average_final_points
        self.return_nearest_final_points = return_nearest_final_points
        self.graph_smoothing_iterations = graph_smoothing_iterations
        self.projection_smooth_iterations = projection_smooth_iterations
        self.final_correspondence_type = final_correspondence_type
        self.return_transformed_mesh = return_transformed_mesh
        self.seed = seed

        # ICP of the full clouds: the source onto the target, or the target
        # onto the source with ``icp_reg_target_to_source``.
        self._icp_transform = None
        if icp_register_first is True:
            with self.timer.span("icp"):
                if icp_reg_target_to_source is True:
                    (s, R, t), moved = icp_fit(vtk_mesh_target.points,
                                               vtk_mesh_source.points,
                                               mode=icp_registration_mode)
                    vtk_mesh_target = vtk_mesh_target.with_points(moved)
                else:
                    (s, R, t), moved = icp_fit(vtk_mesh_source.points,
                                               vtk_mesh_target.points,
                                               mode=icp_registration_mode)
                    vtk_mesh_source = vtk_mesh_source.with_points(moved)
                self._icp_transform = (s, R, t)

        graph_kwargs = dict(
            n_spectral_features=self.n_total_spectral_features,
            n_rand_samples=n_coords_spectral_ordering,
            list_features_to_calc=list(list_features_to_calc),
            list_features_to_get_from_mesh=list(list_features_to_get_from_mesh),
            feature_weights=feature_weights,
            include_features_in_G_matrix=use_features_in_graph,
            include_features_in_adj_matrix=include_features_in_adj_matrix,
            G_matrix_p_function=G_matrix_p_function,
            norm_node_features_std=norm_node_features_std,
            norm_node_features_cap_std=norm_node_features_cap_std,
            norm_node_features_0_1=norm_node_features_0_1,
        )
        with self.timer.span("build_graph_target"):
            self.graph_target = Graph(vtk_mesh_target, seed=seed, **graph_kwargs)
        with self.timer.span("build_graph_source"):
            self.graph_source = Graph(vtk_mesh_source, seed=seed + 1, **graph_kwargs)
        for _name, _val in (
            ("initial_correspondence_type", initial_correspondence_type),
            ("final_correspondence_type", final_correspondence_type),
        ):
            if _val not in ("kd", "hungarian"):
                raise ValueError(f"{_name} must be 'kd' or 'hungarian', got {_val!r}")
        if "hungarian" in (
            initial_correspondence_type,
            final_correspondence_type,
        ) and self.graph_source.n_points != self.graph_target.n_points:
            raise Exception(
                "If number vertices between source & target don't match, "
                "correspondence types must\nbe 'kd' and not 'hungarian'."
            )
        # The spectra are computed on first use (align_maps), not here:
        # align_maps_pipeline solves its own.
        self.use_features_as_coords = use_features_as_coords

        self.Q = None
        self.spectral_weights = None
        self.source_spectral_coords = None
        self.target_spectral_coords = None
        self.source_extra_features = None
        self.target_extra_features = None
        self.source_spectral_coords_after_rigid = None
        self.source_spectral_coords_b4_reg = None
        self.rigid_params = None
        self.non_rigid_params = None
        self.smoothed_target_coords = None
        self.source_projected_on_target = None
        self.weighted_avg_transformed_mesh = None
        self.nearest_neighbour_transformed_mesh = None
        self.corresponding_target_idx_for_each_source_pt = None
        self.nearest_neighbor_transformed_points = None
        self.weighted_avg_transformed_points = None
        self.average_mesh = None

    # --- Point-set preparation ---
    def append_features_to_spectral_coords(self):
        if self.verbose:
            print("Appending Extra Features to Spectral Coords")
        if self.graph_source.n_extra_features != self.graph_target.n_extra_features:
            raise Exception(
                "Number of extra features between"
                " target ({}) and source ({}) dont match!".format(
                    self.graph_target.n_extra_features,
                    self.graph_source.n_extra_features,
                )
            )
        src_cols, tgt_cols = [], []
        for graph, cols, coords in (
            (self.graph_source, src_cols, self.source_spectral_coords),
            (self.graph_target, tgt_cols, self.target_spectral_coords),
        ):
            ptp = coords.max() - coords.min()
            for f in graph.node_features:
                sm = graph.mean_filter_graph(f, iterations=self.feature_smoothing_iterations)
                sm = sm - sm.min()
                cols.append(ptp * (sm / sm.max()))
        self.source_extra_features = torch.stack(src_cols, dim=1)
        self.target_extra_features = torch.stack(tgt_cols, dim=1)
        self.source_spectral_coords = torch.cat(
            [self.source_spectral_coords, self.source_extra_features], dim=1)
        self.target_spectral_coords = torch.cat(
            [self.target_spectral_coords, self.target_extra_features], dim=1)

    def append_pts_to_spectral_coords(self):
        gs, gt = self.graph_source, self.graph_target
        if self.norm_physical_and_spectral is True:
            self.source_spectral_coords = torch.cat(
                [self.source_spectral_coords, gs.normed_points], dim=1)
            self.target_spectral_coords = torch.cat(
                [self.target_spectral_coords, gt.normed_points], dim=1)
        else:
            self.source_spectral_coords = torch.cat(
                [self.source_spectral_coords * gs.mean_pts_scale_range, gs.points], dim=1)
            self.target_spectral_coords = torch.cat(
                [self.target_spectral_coords * gt.mean_pts_scale_range, gt.points], dim=1)

    # --- CPD: moves the target spectral cloud onto the source's ---
    def register_target_to_source(self, reg_type="deformable"):
        src_idx = self.graph_source.get_list_rand_idxs(self.n_coords_spectral_registration)
        tgt_idx = self.graph_target.get_list_rand_idxs(self.n_coords_spectral_registration)
        X = self.source_spectral_coords[torch.as_tensor(src_idx, device=self.device), :]
        Y = self.target_spectral_coords[torch.as_tensor(tgt_idx, device=self.device), :]
        if reg_type == "deformable":
            reg = cpd.deformable_registration(
                X=X,
                Y=Y,
                num_eig=self.non_rigid_n_eigens,
                max_iterations=self.non_rigid_max_iterations,
                tolerance=self.non_rigid_tolerance,
                alpha=self.non_rigid_alpha,
                beta=self.non_rigid_beta,
                w=self.non_rigid_outlier_w,
                verbose=self.verbose,
                seed=self.seed,
            )
            _, self.non_rigid_params = reg.register()
        elif reg_type == "affine":
            # Affine in place of rigid: cycpd's rigid rejects D > 3.
            reg = cpd.affine_registration(
                X=X,
                Y=Y,
                max_iterations=self.rigid_reg_max_iterations,
                tolerance=self.rigid_tolerance,
            )
            _, self.rigid_params = reg.register()
        # The fitted transform moves ALL target points.
        self.target_spectral_coords = reg.transform_point_cloud(self.target_spectral_coords)

    # --- Correspondences ---
    def get_hungarian_correspondence(self, target_pts, spectral_pts):
        # Euclidean (not squared) costs, the reference's cdist objective.
        tic = time.time()
        dists = torch.sqrt(pairwise_sq_dists(spectral_pts, target_pts))
        if self.verbose:
            print("time to get cdist: {}".format(time.time() - tic))
        tic = time.time()
        _, target_idx = linear_sum_assignment(dists)
        if self.verbose:
            print("time to linear sum assignment: {}".format(time.time() - tic))
        self.corresponding_target_idx_for_each_source_pt = np.asarray(target_idx)

    def get_kd_correspondence(self, target_pts, spectral_pts):
        _, idx = nn_query(target_pts, spectral_pts)
        self.corresponding_target_idx_for_each_source_pt = idx.cpu().numpy()

    def get_initial_correspondences(self):
        if self.initial_correspondence_type == "kd":
            self.get_kd_correspondence(self.target_spectral_coords,
                                       self.source_spectral_coords)
        elif self.initial_correspondence_type == "hungarian":
            self.get_hungarian_correspondence(self.target_spectral_coords,
                                              self.source_spectral_coords)

    def _corr_rows(self):
        return torch.as_tensor(self.corresponding_target_idx_for_each_source_pt,
                               device=self.device)

    def get_smoothed_correspondences(self):
        self.smoothed_target_coords = self.graph_target.mean_filter_graph(
            self.graph_target.points, iterations=self.graph_smoothing_iterations)
        if (self.smoothed_target_coords.shape[0] != self.graph_source.n_points
                and self.initial_correspondence_type == "hungarian"):
            raise Exception(
                "If number vertices between source & target don't match, "
                "initial_correspondence_type must\nbe 'kd' and not 'hungarian'. "
                "Current type is: {}".format(self.initial_correspondence_type)
            )
        gathered = self.smoothed_target_coords[self._corr_rows(), :]
        self.source_projected_on_target = self.graph_source.mean_filter_graph(
            gathered, iterations=self.projection_smooth_iterations)
        if self.final_correspondence_type == "kd":
            self.get_kd_correspondence(self.smoothed_target_coords,
                                       self.source_projected_on_target)
        elif self.final_correspondence_type == "hungarian":
            self.get_hungarian_correspondence(self.smoothed_target_coords,
                                              self.source_projected_on_target)

    def get_weighted_final_node_locations(self, n_closest_pts=3):
        """Inverse-distance-weighted average of the ``n_closest_pts`` closest
        smoothed-target points, an exact hit taken outright."""
        if self.smoothed_target_coords is None:
            raise ValueError(
                "weighted final locations need smoothed correspondences: run "
                "with smooth_correspondences=True (the reference crashes on "
                "a None KDTree here; we raise instead)"
            )
        dists, idxs = knn_query(self.smoothed_target_coords,
                                self.source_projected_on_target, k=n_closest_pts)
        self.weighted_avg_transformed_points = idw_from_knn(
            dists, idxs, self.graph_target.points)

    def get_nearest_neighbour_final_node_locations(self):
        self.nearest_neighbor_transformed_points = self.graph_target.points[
            self._corr_rows(), :]

    def get_average_shape(self, align_type="weighted"):
        """The midpoint mesh of the source and its transformed positions."""
        if align_type == "nearest":
            new_xyz = self.graph_target.points[self._corr_rows(), :]
            mean_xyz = (self.graph_source.points + new_xyz) / 2.0
        elif align_type == "weighted":
            mean_xyz = (self.weighted_avg_transformed_points
                        + self.graph_source.points) / 2.0
        else:
            raise ValueError(f"Unknown align_type {align_type!r}")
        self.average_mesh = self.graph_source.mesh.with_points(mean_xyz)
        return self.average_mesh

    def transfer_point_data(self, names=None, method="idw"):
        """Pull named target point_data onto source vertices through the
        computed correspondences (``transfer.transfer_point_data``, on this
        object's device).  Call after :meth:`align_maps`; returns ``{name:
        [Ns] array}`` of numpy arrays."""
        from .transfer import transfer_point_data as _transfer

        if self.corresponding_target_idx_for_each_source_pt is None:
            raise RuntimeError("call align_maps() before transfer_point_data()")
        smoothed = (self.smoothed_target_coords
                    if self.smoothed_target_coords is not None
                    else self.graph_target.points)
        projected = (self.source_projected_on_target
                     if self.source_projected_on_target is not None
                     else self.graph_source.points)
        result = {
            "correspondences": np.asarray(
                self.corresponding_target_idx_for_each_source_pt),
            "smoothed_target_coords": smoothed,
            "source_projected_on_target": projected,
        }
        return _transfer(self.graph_target.mesh, result, names, method,
                         device=self.device)

    # --- Spectral weighting ---
    def calc_c_weighting_spectral(self):
        k = self.n_spectral_features
        lam_max = torch.maximum(self.graph_source.eig_vals[:k],
                                self.graph_target.eig_vals[:k])
        w = self.Q[:k] * lam_max
        sigma = w.mean()
        self.spectral_weights = torch.exp(-(w**2) / (2.0 * sigma**2))

    def calc_weighted_spectral_coords(self):
        self.calc_c_weighting_spectral()
        k = self.n_spectral_features
        self.source_spectral_coords = (self.graph_source.eig_vecs[:, :k]
                                       * self.spectral_weights[None, :])
        self.target_spectral_coords = (self.graph_target.eig_vecs[:, :k]
                                       * self.spectral_weights[None, :])

    def calc_spectral_coords(self):
        if self.get_weighted_spectral_coords is True:
            self.calc_weighted_spectral_coords()
        else:
            k = self.n_spectral_features
            self.source_spectral_coords = self.graph_source.eig_vecs[:, :k]
            self.target_spectral_coords = self.graph_target.eig_vecs[:, :k]

    # --- Entry points ---
    def _pipeline_compatible(self):
        """Whether ``register_pair`` covers this configuration."""
        hungarian = "hungarian" in (self.initial_correspondence_type,
                                    self.final_correspondence_type)
        return not hungarian or self.graph_target.n_points == self.graph_source.n_points

    def _pipeline_features_flag(self) -> bool:
        """use_features_as_coords for ``register_pair``; a feature-count
        mismatch raises, as the stage-by-stage path does."""
        if not self.use_features_as_coords:
            return False
        if self.graph_source.n_extra_features != self.graph_target.n_extra_features:
            raise Exception(
                "Number of extra features between"
                " target ({}) and source ({}) dont match!".format(
                    self.graph_target.n_extra_features,
                    self.graph_source.n_extra_features,
                )
            )
        return self.graph_source.n_extra_features > 0

    def _pipeline_config(self) -> pipeline.PipelineConfig:
        """The ``PipelineConfig`` of :meth:`align_maps_pipeline` (ICP off:
        the constructor has aligned the meshes)."""
        gt = self.graph_target
        return pipeline.PipelineConfig(
            icp_register_first=False,
            initial_correspondence_type=self.initial_correspondence_type,
            final_correspondence_type=self.final_correspondence_type,
            use_features_as_coords=self._pipeline_features_flag(),
            feature_smoothing_iterations=self.feature_smoothing_iterations,
            include_points_as_features=self.include_points_as_features,
            norm_physical_and_spectral=self.norm_physical_and_spectral,
            n_spectral_features=self.n_spectral_features,
            n_extra_spectral=self.n_extra_spectral,
            n_coords_spectral_ordering=gt.rand_idxs.shape[0],
            n_coords_spectral_registration=self.n_coords_spectral_registration,
            get_weighted_spectral_coords=self.get_weighted_spectral_coords,
            rigid_before_non_rigid_reg=self.rigid_before_non_rigid_reg,
            rigid_reg_max_iterations=self.rigid_reg_max_iterations,
            rigid_tolerance=self.rigid_tolerance,
            non_rigid_max_iterations=self.non_rigid_max_iterations,
            non_rigid_tolerance=self.non_rigid_tolerance,
            non_rigid_alpha=self.non_rigid_alpha,
            non_rigid_beta=self.non_rigid_beta,
            non_rigid_n_eigens=self.non_rigid_n_eigens,
            non_rigid_outlier_w=self.non_rigid_outlier_w,
            smooth_correspondences=self.smooth_correspondences,
            graph_smoothing_iterations=self.graph_smoothing_iterations,
            projection_smooth_iterations=self.projection_smooth_iterations,
            target_eigenmap_as_reference=self.target_eigenmap_as_reference,
            use_features_in_graph=bool(gt.include_features_in_G_matrix),
            include_features_in_adj_matrix=bool(gt.include_features_in_adj_matrix),
            G_matrix_p_function=gt.G_matrix_p_function,
            feature_weights_diag=tuple(
                float(x) for x in np.diag(np.asarray(gt.feature_weights))
            ) if gt.n_extra_features > 0 else (),
        )

    def _pipeline_inputs(self, n_landmarks: int = 0):
        """(cfg, target GraphArrays, source GraphArrays, draws) of
        :meth:`align_maps_pipeline`'s ``register_pair`` call."""
        cfg = self._pipeline_config()
        graphs = []
        for g in (self.graph_target, self.graph_source):
            feats = (torch.stack(g.node_features, dim=1).cpu().numpy()
                     if g.n_extra_features > 0 else None)
            graphs.append(pipeline.mesh_to_graph_arrays(
                g.mesh, node_features=feats, device=self.device, topology=g.topology))
        tg, sg = graphs
        draws = pipeline.make_draws(self.seed, cfg, tg.n_points, sg.n_points, n_landmarks)
        return cfg, tg, sg, draws

    def align_maps_pipeline(self, landmark_pairs=None):
        """The registration as one ``pipeline.register_pair`` call with
        ``make_draws(seed, ...)``, filling the reference-named attributes.
        ``landmark_pairs``: optional int [L, 2] (source vertex, target
        vertex) correspondences (see ``register_pair``)."""
        if not self._pipeline_compatible():
            raise ValueError(
                "configuration not supported by the fused pipeline "
                "(hungarian needs equal vertex counts); use align_maps()"
            )
        with self.timer.span("pipeline_register_pair"):
            n_lm = 0 if landmark_pairs is None else len(landmark_pairs)
            cfg, tg, sg, draws = self._pipeline_inputs(n_lm)
            res = pipeline.register_pair(tg, sg, cfg, draws=draws,
                                         landmark_pairs=landmark_pairs)
        self.Q = res["Q"]
        self.graph_target.eig_vals = res["eig_vals_target"]
        self.graph_source.eig_vals = res["eig_vals_source"]
        self.graph_target.eig_vecs = res["eig_vecs_target"]
        self.graph_source.eig_vecs = res["eig_vecs_source_sorted"]
        self.source_spectral_coords = res["spectral_coords_source"]
        self.target_spectral_coords = res["spectral_coords_target"]
        self.source_spectral_coords_b4_reg = res["spectral_coords_source"]
        self.smoothed_target_coords = res["smoothed_target_coords"]
        self.source_projected_on_target = res["source_projected_on_target"]
        self.corresponding_target_idx_for_each_source_pt = (
            res["correspondences"].cpu().numpy())
        self.initial_correspondences = res["initial_correspondences"].cpu().numpy()
        self.nearest_neighbor_transformed_points = res["nearest_points"]
        self.weighted_avg_transformed_points = res["weighted_points"]
        if self.return_transformed_mesh:
            if self.return_average_final_points:
                self.get_source_mesh_transformed_weighted_avg()
            if self.return_nearest_final_points:
                self.get_source_mesh_transformed_nearest_neighbour()
        return self.corresponding_target_idx_for_each_source_pt

    def _ensure_spectra(self):
        """The constructor's deferred spectra, on first use."""
        if self.graph_target.eig_vecs is None:
            with self.timer.span("spectrum_target"):
                self.graph_target.get_graph_spectrum()
        if self.graph_source.eig_vecs is None:
            with self.timer.span("spectrum_source"):
                self.graph_source.get_graph_spectrum()

    def align_maps(self):
        self._ensure_spectra()
        with self.timer.span("eigsort"):
            eig_map_sorter = eigsort(
                graph_target=self.graph_target,
                graph_source=self.graph_source,
                n_features=self.n_total_spectral_features,
                target_as_reference=self.target_eigenmap_as_reference,
            )
            self.Q = eig_map_sorter.sort_eigenmaps()
        self.calc_spectral_coords()

        if self.graph_source.n_extra_features > 0 and self.use_features_as_coords is True:
            with self.timer.span("append_features"):
                self.append_features_to_spectral_coords()
        if self.include_points_as_features is True:
            self.append_pts_to_spectral_coords()

        self.source_spectral_coords_b4_reg = self.source_spectral_coords.clone()
        if self.verbose:
            print("Number of features (including spectral) used for "
                  "registartion: {}".format(self.target_spectral_coords.shape[1]))

        if self.rigid_before_non_rigid_reg is True:
            if self.verbose:
                print_header("Rigid Registration Beginning!")
            with self.timer.span("cpd_affine"):
                self.register_target_to_source(reg_type="affine")
            self.source_spectral_coords_after_rigid = self.source_spectral_coords.clone()
        if self.verbose:
            print_header("Non-Rigid (Deformable) Registration Beginning")
        with self.timer.span("cpd_deformable"):
            self.register_target_to_source("deformable")

        with self.timer.span("initial_correspondences"):
            self.get_initial_correspondences()
        # Kept for diagnostics: smoothing overwrites the slot.
        self.initial_correspondences = np.asarray(
            self.corresponding_target_idx_for_each_source_pt)
        if self.verbose:
            print("Number of unique correspondences: {}".format(
                len(np.unique(self.corresponding_target_idx_for_each_source_pt))))
        if self.smooth_correspondences is True:
            with self.timer.span("smoothed_correspondences"):
                self.get_smoothed_correspondences()
            if self.verbose:
                print("Number of unique correspondences after smoothing: {}".format(
                    len(np.unique(self.corresponding_target_idx_for_each_source_pt))))
        if self.return_average_final_points is True:
            with self.timer.span("final_locations_weighted"):
                self.get_weighted_final_node_locations()
        if self.return_nearest_final_points is True:
            self.get_nearest_neighbour_final_node_locations()
        if self.return_transformed_mesh is True:
            if self.return_average_final_points is True:
                self.get_source_mesh_transformed_weighted_avg()
            if self.return_nearest_final_points is True:
                self.get_source_mesh_transformed_nearest_neighbour()

    # --- Scalar setters ---
    def _corr_scalars(self):
        return torch.as_tensor(self.corresponding_target_idx_for_each_source_pt,
                               dtype=torch.float32, device=self.device)

    def set_transformed_source_scalars_to_corresp_target_idx(self):
        idx = self._corr_scalars()
        if self.weighted_avg_transformed_mesh is not None:
            self.weighted_avg_transformed_mesh = (
                self.weighted_avg_transformed_mesh.with_point_data("corresp_idx", idx))
        if self.nearest_neighbour_transformed_mesh is not None:
            self.nearest_neighbour_transformed_mesh = (
                self.nearest_neighbour_transformed_mesh.with_point_data("corresp_idx", idx))

    def set_source_scalars_to_corresp_target_idx(self):
        self.graph_source.mesh = self.graph_source.mesh.with_point_data(
            "corresp_idx", self._corr_scalars())

    def set_target_scalars_to_corresp_target_idx(self):
        self.graph_target.mesh = self.graph_target.mesh.with_point_data(
            "corresp_idx", torch.arange(self.graph_target.n_points, dtype=torch.float32,
                                        device=self.device))

    def set_all_mesh_scalars_to_corresp_target_idx(self):
        self.set_target_scalars_to_corresp_target_idx()
        self.set_source_scalars_to_corresp_target_idx()
        self.set_transformed_source_scalars_to_corresp_target_idx()

    # --- Output meshes ---
    def get_source_mesh_transformed_weighted_avg(self):
        self.weighted_avg_transformed_mesh = self.graph_source.mesh.with_points(
            self.weighted_avg_transformed_points)

    def get_source_mesh_transformed_nearest_neighbour(self):
        self.nearest_neighbour_transformed_mesh = self.graph_source.mesh.with_points(
            self.nearest_neighbor_transformed_points)

    # --- Viewers (reference ``focusr.py:646-795``): optional itkwidgets,
    # or the standalone HTML export ---
    def view_aligned_spectral_coords(self, starting_spectral_coord=0,
                                     point_set_representations=("spheres",),
                                     point_set_colors=None,
                                     include_target_coordinates=True,
                                     include_non_rigid_aligned=True,
                                     include_rigid_aligned=False,
                                     include_unaligned=False, upscale_factor=10.0):
        from .utils.viz import view_point_sets

        sl = slice(starting_spectral_coord, starting_spectral_coord + 3)
        chosen = ((include_target_coordinates, self.target_spectral_coords),
                  (include_unaligned, self.source_spectral_coords_b4_reg),
                  (include_rigid_aligned, self.source_spectral_coords_after_rigid),
                  (include_non_rigid_aligned, self.source_spectral_coords))
        point_sets = [upscale_factor * to_numpy(coords)[:, sl]
                      for include, coords in chosen if include]
        return view_point_sets(point_sets, representations=list(point_set_representations),
                               colors=point_set_colors)

    def view_meshes_colored_by_spectral_correspondences(
            self, x_translation=100, y_translation=0, z_translation=0, shadow=True):
        from .utils.viz import view_meshes

        target = self.graph_target.mesh.with_point_data(
            "corresp_idx", np.arange(self.graph_target.n_points, dtype=np.float32))
        target = target.with_points(
            to_numpy(target.points, np.float32)
            + np.asarray([x_translation, y_translation, z_translation], np.float32))
        source = self.graph_source.mesh.with_point_data(
            "corresp_idx", to_numpy(self.corresponding_target_idx_for_each_source_pt,
                                    np.float32))
        return view_meshes([source, target], shadow=shadow)

    def view_aligned_smoothed_spectral_coords(self):
        from .utils.viz import view_point_sets

        return view_point_sets([self.smoothed_target_coords,
                                self.source_projected_on_target])

    def _transformed_mesh(self, rebuild_nearest: bool):
        """The transformed source mesh for a viewer: the weighted-average one,
        else the nearest-neighbour one, built from their points when only
        those exist (``rebuild_nearest`` recomputes the nearest points
        first, as the reference's ``view_meshes`` does); None without
        either."""
        if self.weighted_avg_transformed_mesh is not None:
            return self.weighted_avg_transformed_mesh
        if self.nearest_neighbour_transformed_mesh is not None:
            return self.nearest_neighbour_transformed_mesh
        if self.weighted_avg_transformed_points is not None:
            self.get_source_mesh_transformed_weighted_avg()
            return self.weighted_avg_transformed_mesh
        if self.nearest_neighbor_transformed_points is not None:
            if rebuild_nearest:
                self.get_nearest_neighbour_final_node_locations()
            self.get_source_mesh_transformed_nearest_neighbour()
            return self.nearest_neighbour_transformed_mesh
        return None

    def _ensure_average(self) -> bool:
        """Build the average mesh from the weighted points, else the nearest
        ones, when it is missing; False when neither exists."""
        if self.average_mesh is None:
            if self.weighted_avg_transformed_points is not None:
                self.get_average_shape()
            elif self.nearest_neighbor_transformed_points is not None:
                self.get_average_shape(align_type="nearest")
        return self.average_mesh is not None

    def view_meshes(self, include_target=True, include_source=True,
                    include_transformed_target=False, include_average=False,
                    shadow=True):
        from .utils.viz import view_meshes

        geometries = []
        if include_target:
            geometries.append(self.graph_target.mesh)
        if include_source:
            geometries.append(self.graph_source.mesh)
        if include_transformed_target:
            transformed = self._transformed_mesh(rebuild_nearest=True)
            if transformed is None:
                raise Exception(
                    "No corresponding points or meshes calculated. Try running: \n"
                    "reg.get_weighted_final_node_locations()\n"
                    "reg.get_nearest_neighbour_final_node_locations()\n"
                    "or try re-running with the flags: \n"
                    "return_average_final_points=True & return_transformed_mesh=True"
                )
            geometries.append(transformed)
        if include_average:
            if not self._ensure_average():
                raise Exception(
                    "No xyz correspondences calculated can't get average! Try:\n"
                    "`reg.get_weighted_final_node_locations` or "
                    "`reg.get_nearest_neighbour_final_node_locations`"
                )
            geometries.append(self.average_mesh)
        return view_meshes(geometries, shadow=shadow)

    def export_viewer_html(self, file_path, include_target=True, include_source=True,
                           include_transformed=True, include_average=False,
                           include_spectral_coords=False,
                           color_by_correspondences=True, x_translation=0.0):
        """Write a standalone HTML/WebGL viewer of the registration result
        (the dependency-free counterpart of ``view_meshes`` /
        ``view_meshes_colored_by_spectral_correspondences``): the target,
        the source, the transformed source (weighted-average when available,
        else nearest-neighbour) and optionally the average mesh and the
        aligned spectral point clouds, meshes colored by correspondence
        index so matched regions share colors.  Runs in any WebGL browser
        with no network access.  Returns the path written."""
        from .utils.html_viewer import export_html

        corr = self.corresponding_target_idx_for_each_source_pt

        def _colored(mesh, idx_values):
            if not color_by_correspondences or idx_values is None:
                return mesh
            return mesh.with_point_data("corresp_idx", to_numpy(idx_values, np.float32))

        meshes, names = [], []
        if include_target:
            target = _colored(self.graph_target.mesh,
                              np.arange(self.graph_target.n_points, dtype=np.float32))
            if x_translation:
                target = target.with_points(
                    to_numpy(target.points, np.float32)
                    + np.asarray([x_translation, 0.0, 0.0], np.float32))
            meshes.append(target)
            names.append("target")
        if include_source:
            meshes.append(_colored(self.graph_source.mesh, corr))
            names.append("source")
        if include_transformed:
            transformed = self._transformed_mesh(rebuild_nearest=False)
            if transformed is not None:
                meshes.append(_colored(transformed, corr))
                names.append("source transformed")
        if include_average and self._ensure_average():
            meshes.append(self.average_mesh)
            names.append("average")

        point_sets, ps_names = [], []
        if include_spectral_coords:
            for label, coords in (("target spectral", self.target_spectral_coords),
                                  ("source spectral (aligned)",
                                   self.source_spectral_coords)):
                if coords is not None:
                    point_sets.append(10.0 * to_numpy(coords)[:, :3])
                    ps_names.append(label)
        return export_html(file_path, meshes=meshes, mesh_names=names,
                           point_sets=point_sets, point_set_names=ps_names,
                           title="FOCUSR registration")

    @property
    def icp_transform(self):
        """The fitted ICP transform (s, R, t), or None without ICP."""
        return self._icp_transform

    def registration_quality(self):
        """Unique fraction, mean displacement (from the post-ICP source),
        symmetric surface distance and Hausdorff of the completed
        registration (``metrics.registration_quality``)."""
        if self.corresponding_target_idx_for_each_source_pt is None:
            raise ValueError("run align_maps() first")
        return _registration_quality(
            self.graph_target.points,
            self.graph_source.points,
            {"correspondences": torch.as_tensor(
                self.corresponding_target_idx_for_each_source_pt),
             "weighted_points": self.weighted_avg_transformed_points},
        )
