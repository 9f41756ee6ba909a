"""The class API's graph of one mesh: feature-weighted Laplacian, spectrum,
subsampling and smoothing.

Counterpart of ``pyfocusr_tpu/spectral/graph.py``: ``features_dictionary``
(:57) and ``Graph`` (:64) with every public method, the viewers
(``view_mesh_*`` over the optional itkwidgets, ``export_viewer_html``;
:423-460) included.  The graph is the ELL
neighbour table of ``mesh.build_topology`` with its weights, degrees and G
as tensors on one device: the device of the mesh's points when they are a
tensor, else the CUDA card (``utils.device.resolve_device``).

The spectrum is the narrow Chebyshev solver (``eig_method='chebyshev'``,
the default, at every mesh size: the JAX class never calls the wide one)
or shift-invert Lanczos (any other ``eig_method``), with the reference's
retry at a larger k while fewer than ``n_spectral_features`` eigenvalues
exceed 1e-10.

Randomness: ``self._rng = np.random.default_rng(seed)`` draws the
subsamples exactly as the JAX class does, so ``rand_idxs`` and
``get_list_rand_idxs`` equal its draws.  The eigensolver's starts, which
JAX draws from ``PRNGKey(seed)``, come from :func:`eig_start_draws` on a
stream of their own.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..mesh import MeshTopology, TriMesh, as_trimesh, build_topology
from ..ops import graph_ops
from ..ops.curvature import principal_curvatures
from ..ops.eigen import narrow_or_lanczos
from ..pipeline import _NARROW_EXTRA
from ..utils.device import resolve_device

__all__ = ["Graph", "features_dictionary", "eig_start_draws", "MIN_EIG_VAL"]

MIN_EIG_VAL = 1e-10  # the reference's cut of the null modes


def eig_start_draws(seed: int, n: int, method: str, k: int) -> np.ndarray:
    """The random start of a ``Graph``'s eigensolve (seed ``seed``, ``n``
    vertices, ``k`` wanted pairs): f32 [n, k + 8], the narrow solver's block,
    for ``method`` 'chebyshev'; otherwise [n, 2], the Lanczos power-iteration
    and start vectors.  Drawn from the first child of ``seed``'s seed
    sequence, a stream apart from the subsampling's."""
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(1)[0])
    width = k + _NARROW_EXTRA if method == "chebyshev" else 2
    return rng.standard_normal((n, width)).astype(np.float32)


def _curvature_feature(graph: "Graph"):
    kmin, kmax = principal_curvatures(
        graph.points, graph.mesh.triangles, graph._edges_j, graph._edge_faces_j
    )
    return [kmin, kmax]


def _min_curvature_feature(graph: "Graph"):
    return [_curvature_feature(graph)[0]]


def _max_curvature_feature(graph: "Graph"):
    return [_curvature_feature(graph)[1]]


# 'curvature' yields both principal curvatures, the others one each.
features_dictionary = {
    "curvature": _curvature_feature,
    "min_curvature": _min_curvature_feature,
    "max_curvature": _max_curvature_feature,
}


class Graph:
    def __init__(
        self,
        mesh: TriMesh = None,
        n_spectral_features: int = 3,
        norm_eig_vecs: bool = True,
        n_rand_samples: int = 10000,
        list_features_to_calc=(),
        list_features_to_get_from_mesh=(),
        feature_weights=None,
        include_features_in_adj_matrix: bool = False,
        include_features_in_G_matrix: bool = False,
        G_matrix_p_function: str = "exp",
        norm_node_features_std: bool = True,
        norm_node_features_cap_std: float = 3,
        norm_node_features_0_1: bool = True,
        seed: int = 0,
        eig_method: str = "chebyshev",
        eig_cg_iters: int = 300,
        eig_lanczos_iters: int = 0,
        topology: MeshTopology | None = None,
        vtk_mesh=None,
    ):
        # ``vtk_mesh`` is the reference's name for the mesh argument.
        if mesh is None:
            mesh = vtk_mesh
        if mesh is None:
            raise TypeError("Graph requires a mesh (positional or vtk_mesh=)")
        mesh = as_trimesh(mesh)
        self.eig_method = eig_method
        self.mesh = mesh
        self.n_spectral_features = n_spectral_features
        self.norm_eig_vecs = norm_eig_vecs
        self.include_features_in_adj_matrix = include_features_in_adj_matrix
        self.include_features_in_G_matrix = include_features_in_G_matrix
        self.G_matrix_p_function = G_matrix_p_function
        self.norm_node_features_std = norm_node_features_std
        self.norm_node_features_cap_std = norm_node_features_cap_std
        self.norm_node_features_0_1 = norm_node_features_0_1
        self.seed = seed
        self.eig_cg_iters = eig_cg_iters
        self.eig_lanczos_iters = eig_lanczos_iters

        pts = mesh.points
        self.device = pts.device if torch.is_tensor(pts) else resolve_device(None)
        self.n_points = mesh.n_points
        self.points = torch.as_tensor(pts, device=self.device).to(torch.float32)
        self.pts_scale_range = np.ptp(self.points.cpu().numpy(), axis=0)
        self.max_pts_scale_range = float(np.max(self.pts_scale_range))
        self.mean_pts_scale_range = float(np.mean(self.pts_scale_range))
        self.normed_points = (
            self.points - self.points.min(dim=0).values
        ) / self.mean_pts_scale_range

        self.topology = topology if topology is not None else build_topology(
            np.asarray(mesh.triangles), self.n_points
        )

        def idx(a):
            return torch.as_tensor(np.asarray(a), device=self.device).long()

        self._neighbors = idx(self.topology.neighbors)
        self._nbr_mask = torch.as_tensor(self.topology.nbr_mask, device=self.device)
        self._edges_j = idx(self.topology.edges)
        self._edge_faces_j = idx(self.topology.edge_faces)
        self._overflow = idx(self.topology.overflow_edges)
        self._ov_w = None  # computed with the adjacency weights

        self.eig_vals = None
        self.eig_vecs = None
        self.eig_val_gap = None
        self._rng = np.random.default_rng(seed)
        self.rand_idxs = self.get_list_rand_idxs(n_rand_samples)

        self.node_features = []
        for feature in list_features_to_calc:
            self.node_features += list(features_dictionary[feature](self))
        for feature in list_features_to_get_from_mesh:
            if feature in mesh.point_data:
                self.node_features.append(torch.as_tensor(
                    mesh.point_data[feature], device=self.device).to(torch.float32))
            else:
                warnings.warn(f"NO SCALARS WITH SPECIFIED NAME: {feature!r}")
        self.norm_node_features(
            norm_using_std=self.norm_node_features_std,
            norm_range_0_to_1=self.norm_node_features_0_1,
            cap_std=self.norm_node_features_cap_std,
        )
        self.n_extra_features = len(self.node_features)
        if feature_weights is None:
            self.feature_weights = np.eye(max(self.n_extra_features, 1))
        else:
            self.feature_weights = np.asarray(feature_weights)
        self.mean_xyz_range_scaled_features = [
            f * self.mean_pts_scale_range for f in self.node_features
        ]

        self._adjacency_weights = None
        self._degrees = None
        self._g = None

    def norm_node_features(self, norm_using_std=True, norm_range_0_to_1=True, cap_std=3):
        """z-score (capped at +-``cap_std``) and/or min-max each feature; a
        constant feature becomes a constant instead of NaN."""
        out = []
        for f in self.node_features:
            f = torch.as_tensor(f, device=self.device).to(torch.float32)
            if norm_using_std is True:
                std = f.std(unbiased=False)
                f = (f - f.mean()) / torch.where(std > 0, std, 1.0)
                if cap_std is not False:
                    f = torch.clamp(f, -cap_std, cap_std)
            if norm_range_0_to_1 is True:
                ptp = f.max() - f.min()
                f = (f - f.min()) / torch.where(ptp > 0, ptp, 1.0)
            out.append(f)
        self.node_features = out

    def _adjacency_coords(self) -> torch.Tensor:
        """xyz, with the mean-range-scaled features appended when they enter
        the adjacency."""
        if self.n_extra_features > 0 and self.include_features_in_adj_matrix:
            return torch.cat([self.points] + [
                f[:, None] for f in self.mean_xyz_range_scaled_features], dim=1)
        return self.points

    def get_weighted_adjacency_matrix(self):
        """ELL edge weights w = 1/dist (and the overflow edges' weights);
        drops the cached degrees and G."""
        coords = self._adjacency_coords()
        self._adjacency_weights = graph_ops.edge_weights(
            coords, self._neighbors, self._nbr_mask)
        self._ov_w = graph_ops.overflow_weights(coords, self._overflow)
        self._degrees = None
        self._g = None
        return self._adjacency_weights

    @property
    def adjacency_weights(self) -> torch.Tensor:
        if self._adjacency_weights is None:
            self.get_weighted_adjacency_matrix()
        return self._adjacency_weights

    def get_degree_matrix(self):
        self._degrees = graph_ops.degree_vector(
            self.adjacency_weights, self._overflow, self._ov_w)
        return self._degrees

    @property
    def degrees(self) -> torch.Tensor:
        if self._degrees is None:
            self.get_degree_matrix()
        return self._degrees

    def get_G_matrix(self, p_function: str = "exp"):
        feats = torch.stack(self.node_features) if self.n_extra_features > 0 else None
        self._g = graph_ops.g_vector(
            feats, self.degrees,
            torch.as_tensor(self.feature_weights, dtype=torch.float32, device=self.device),
            p_function=p_function, include_features=self.include_features_in_G_matrix,
        )
        return self._g

    @property
    def g(self) -> torch.Tensor:
        if self._g is None:
            self.get_G_matrix(p_function=self.G_matrix_p_function)
        return self._g

    def laplacian_matvec(self, x):
        """L x with L = G (D - W), matrix-free."""
        return graph_ops.laplacian_matvec(
            self._neighbors, self.adjacency_weights, self.g, x,
            self._overflow, self._ov_w, degrees=self.degrees)

    def get_laplacian_matrix(self):
        """L = G (D - W) as scipy CSR on ``self.laplacian_matrix``, for
        inspection; the solvers use :meth:`laplacian_matvec`."""
        import scipy.sparse as sp

        W = self.to_scipy_sparse()
        d = self.degrees.double().cpu().numpy()
        g = self.g.double().cpu().numpy()
        self.laplacian_matrix = sp.diags(g) @ (sp.diags(d) - W)
        return self.laplacian_matrix

    def to_scipy_sparse(self):
        """W as scipy CSR (for tests and inspection)."""
        import scipy.sparse as sp

        nbrs = self._neighbors.cpu().numpy()
        w = self.adjacency_weights.cpu().numpy()
        mask = self._nbr_mask.cpu().numpy() > 0
        rows = np.repeat(np.arange(self.n_points), self.topology.max_degree).reshape(
            self.n_points, -1)
        data, ri, ci = w[mask], rows[mask], nbrs[mask]
        if self._overflow.shape[0]:
            ov = self._overflow.cpu().numpy()
            ovw = self._ov_w.cpu().numpy()
            real = ov[:, 0] != ov[:, 1]
            data = np.concatenate([data, ovw[real]])
            ri = np.concatenate([ri, ov[real, 0]])
            ci = np.concatenate([ci, ov[real, 1]])
        return sp.coo_matrix((data, (ri, ci)), shape=(self.n_points,) * 2).tocsr()

    def get_graph_spectrum(self):
        """The ``n_spectral_features`` smallest eigenpairs of L above 1e-10,
        eigenvectors min-max scaled to [-0.5, 0.5] when ``norm_eig_vecs``.
        While fewer survive (extra null modes of a disconnected mesh), the
        solve reruns with k grown by 1 + n_spectral_features, four times at
        most, then raises."""
        self.get_weighted_adjacency_matrix()
        self.get_degree_matrix()
        self.get_G_matrix(p_function=self.G_matrix_p_function)
        neighbors, weights = self._neighbors, self.adjacency_weights
        g = torch.clamp(self.g, min=1e-30)
        s = torch.sqrt(g)
        # Kernel basis: one indicator column per connected component.
        n_comp = max(self.topology.n_components, 1)
        ind = np.zeros((self.n_points, n_comp), np.float32)
        ind[np.arange(self.n_points), self.topology.component_labels] = 1.0
        null_vec = torch.as_tensor(ind, device=self.device) * (1.0 / s)[:, None]
        ov, ov_w, d = self._overflow, self._ov_w, self.degrees

        def matvec(X):
            return graph_ops.sym_laplacian_matvec(neighbors, weights, g, X, ov, ov_w,
                                                  degrees=d)

        def quad_form(V):
            return graph_ops.sym_laplacian_quad_form(neighbors, weights, s, V, ov, ov_w)

        ws = graph_ops.spmv(neighbors, weights, s, ov, ov_w)
        lam_bound = (s * (s * d + ws)).max()
        method = "chebyshev" if self.eig_method == "chebyshev" else "lanczos"
        solver_kw = ({} if method == "chebyshev" else
                     dict(cg_iters=self.eig_cg_iters, lanczos_iters=self.eig_lanczos_iters))
        n_needed = self.n_spectral_features
        k_req = n_needed
        for _attempt in range(4):
            start = torch.tensor(
                eig_start_draws(self.seed, self.n_points, method, k_req), device=self.device)
            lams, vecs = narrow_or_lanczos(
                "narrow" if method == "chebyshev" else "lanczos", matvec, quad_form, s,
                null_vec, k_req, start, lam_bound, **solver_kw)
            good = np.where(lams.cpu().numpy() > MIN_EIG_VAL)[0]
            if len(good) >= n_needed:
                break
            k_req += 1 + n_needed
        else:
            raise RuntimeError(
                f"eigensolver found only {len(good)} eigenvalues > "
                f"{MIN_EIG_VAL} after 4 attempts (k grown to {k_req}); "
                f"needed {n_needed}. The mesh may have many near-zero "
                "modes (heavily disconnected?) or the spectrum failed to "
                "converge."
            )
        good = torch.as_tensor(good[:n_needed], device=self.device)
        self.eig_vals = lams[good]
        self.eig_vecs = vecs[:, good]
        if self.norm_eig_vecs is True:
            mn = self.eig_vecs.min(dim=0).values
            ptp = self.eig_vecs.max(dim=0).values - mn
            self.eig_vecs = (self.eig_vecs - mn) / ptp - 0.5
        return self.eig_vals, self.eig_vecs

    def get_eig_val_gap(self):
        self.eig_val_gap = float(torch.diff(self.eig_vals).mean())
        return self.eig_val_gap

    def _rand_rows(self):
        return torch.as_tensor(self.rand_idxs, device=self.device)

    def get_rand_eig_vecs(self):
        return self.eig_vecs[self._rand_rows(), :]

    def get_rand_normalized_points(self):
        pts = self.points[self._rand_rows(), :]
        mn = pts.min(dim=0).values
        return (pts - mn) / (pts.max(dim=0).values - mn)

    def get_list_rand_idxs(self, n_rand_samples, replace=False, force_randomization=False):
        if n_rand_samples > self.n_points:
            idxs = np.arange(self.n_points)
            if force_randomization is True:
                self._rng.shuffle(idxs)
            return idxs
        return self._rng.choice(self.n_points, size=n_rand_samples, replace=replace)

    def mean_filter_graph(self, values, iterations: int = 300):
        """``iterations`` steps of diag(1/(1+d)) (W + I) on ``values``."""
        return graph_ops.mean_filter(
            self._neighbors, self.adjacency_weights,
            torch.as_tensor(values, device=self.device).to(torch.float32),
            iterations, self._overflow, self._ov_w,
        )

    # Viewers (reference ``graph.py:296-314``): optional itkwidgets, or the
    # standalone HTML export.
    def view_mesh_existing_scalars(self):
        from ..utils.viz import view_mesh

        return view_mesh(self.mesh)

    def view_mesh_eig_vec(self, eig_vec: int = 0):
        from ..utils.viz import view_mesh

        return view_mesh(self.mesh.with_point_data("eig_vec", self.eig_vecs[:, eig_vec]))

    def view_mesh_features(self, feature_idx: int = 0):
        from ..utils.viz import view_mesh

        return view_mesh(self.mesh.with_point_data("feature",
                                                   self.node_features[feature_idx]))

    def export_viewer_html(self, file_path, eig_vec=None, feature_idx=None):
        """Standalone HTML/WebGL export of the graph's mesh, the
        dependency-free counterpart of the three ``view_mesh_*`` viewers:
        the existing point-data scalars, plus an ``eig_vec`` column and / or
        a node ``feature`` as further colorings.  Returns the path
        written."""
        from ..utils.html_viewer import export_html

        mesh = self.mesh
        if eig_vec is not None:
            mesh = mesh.with_point_data(f"eig_vec_{eig_vec}", self.eig_vecs[:, eig_vec])
        if feature_idx is not None:
            mesh = mesh.with_point_data(f"feature_{feature_idx}",
                                        self.node_features[feature_idx])
        return export_html(file_path, meshes=[mesh], mesh_names=["mesh"],
                           title="Graph mesh")
