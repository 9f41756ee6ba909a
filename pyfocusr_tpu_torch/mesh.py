"""Triangle-mesh container and host-side topology.

Counterpart of ``pyfocusr_tpu/mesh.py``: ``TriMesh`` (:36, with
``with_points`` and ``with_point_data``), ``MeshTopology`` (:84),
``build_topology`` (:115), ``as_trimesh`` (:267-360, with the duck-typed
``vtkPolyData`` branch, which imports no vtk) and ``load_mesh`` /
``save_mesh`` (:363, :384) over the copies of the JAX package's readers
and writers in ``io/``.  The tensors the pipeline iterates on are made
from the topology by ``pipeline.mesh_to_graph_arrays``.

``build_topology`` runs the host library's two C++ passes
(``native.topo_edges`` / ``topo_fill``, ``csrc/host/fast_topology.cpp``),
as the JAX package does when its library is built (:143-176).
``build_topology_plain`` is the numpy path (JAX :178-264), the plain
version the tests hold the C++ passes to byte for byte; ``build_topology``
takes it only for an empty triangle array and for indices out of range
(where it raises JAX's message).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from . import native
from .io.mesh_formats import read_any, write_any
from .utils.device import to_numpy

__all__ = ["TriMesh", "MeshTopology", "as_trimesh", "build_topology",
           "build_topology_plain", "load_mesh", "save_mesh"]


def _array(values):
    """Tensors stay tensors (on their device); anything else becomes numpy."""
    return values if torch.is_tensor(values) else np.asarray(values)


@dataclasses.dataclass(frozen=True)
class TriMesh:
    """Triangle mesh as numpy arrays (``with_points`` / ``with_point_data``
    keep tensors as they are given, on their device).

    points:     f32 [N, 3] vertex positions
    triangles:  i32 [F, 3] vertex indices per face
    point_data: named per-vertex arrays
    """

    points: np.ndarray
    triangles: np.ndarray
    point_data: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.triangles.shape[0]

    def with_points(self, new_points) -> "TriMesh":
        """Copy of this mesh with replaced vertex positions."""
        return TriMesh(_array(new_points), self.triangles, dict(self.point_data))

    def with_point_data(self, name: str, values) -> "TriMesh":
        pd = dict(self.point_data)
        pd[name] = _array(values)
        return TriMesh(self.points, self.triangles, pd)


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Static connectivity derived from triangles (host-side, numpy).

    edges:      i32 [E, 2]  unique undirected edges (i < j)
    neighbors:  i32 [N, D]  padded neighbor table (ELL); padding = own index
    nbr_mask:   f32 [N, D]  1.0 for real neighbor slots, 0.0 for padding
    max_degree: int         D
    edge_faces: i32 [E, 2]  faces incident to each edge (-1 if boundary)
    component_labels: i32 [N] connected-component id per vertex
    overflow_edges: i32 [E_o, 2] directed (src, dst) edges beyond the cap
    """

    edges: np.ndarray
    neighbors: np.ndarray
    nbr_mask: np.ndarray
    max_degree: int
    edge_faces: np.ndarray
    component_labels: np.ndarray
    n_components: int
    overflow_edges: np.ndarray = None

    @property
    def n_points(self) -> int:
        return self.neighbors.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]


def _ell_width(true_max: int, degree_cap: Optional[int],
               pad_degree: Optional[int]) -> int:
    """The ELL table's width: the largest degree, capped at ``degree_cap``,
    widened to ``pad_degree``."""
    max_deg = true_max
    if degree_cap is not None and true_max > degree_cap:
        max_deg = degree_cap
    if pad_degree is not None:
        if pad_degree < max_deg:
            raise ValueError(f"pad_degree {pad_degree} < degree {max_deg}")
        max_deg = pad_degree
    return max_deg


def build_topology(
    triangles: np.ndarray,
    n_points: int,
    pad_degree: Optional[int] = None,
    degree_cap: Optional[int] = 24,
) -> MeshTopology:
    """Unique undirected edges, the padded ELL neighbor table (degree capped
    at ``degree_cap``, the rest spilled to ``overflow_edges``) and connected
    components — byte-identical to the JAX package's tables.  The host
    library's two passes; :func:`build_topology_plain` for no triangles or
    out-of-range indices."""
    tris = np.asarray(triangles, dtype=np.int64)
    head = native.topo_edges(tris, n_points) if tris.size else None
    if head is None:
        return build_topology_plain(tris, n_points, pad_degree, degree_cap)
    edges, edge_faces, true_max = head
    max_deg = _ell_width(true_max, degree_cap, pad_degree)
    neighbors, mask, overflow, labels, n_comp = native.topo_fill(edges, n_points, max_deg)
    return MeshTopology(
        edges=edges,
        neighbors=neighbors,
        nbr_mask=mask,
        max_degree=max_deg,
        edge_faces=edge_faces,
        component_labels=labels,
        n_components=n_comp if n_points else 0,
        overflow_edges=overflow,
    )


def build_topology_plain(
    triangles: np.ndarray,
    n_points: int,
    pad_degree: Optional[int] = None,
    degree_cap: Optional[int] = 24,
) -> MeshTopology:
    """:func:`build_topology` in numpy (JAX ``mesh.py:178-264``): the plain
    version of the host library's passes."""
    tris = np.asarray(triangles, dtype=np.int64)
    if tris.size and (tris.min() < 0 or tris.max() >= n_points):
        raise ValueError(
            f"triangle indices span [{tris.min()}, {tris.max()}] but the "
            f"mesh has {n_points} points"
        )

    if tris.size == 0:
        edges = np.zeros((0, 2), dtype=np.int32)
        edge_faces = np.zeros((0, 2), dtype=np.int32)
    else:
        raw = np.concatenate(
            [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0
        )
        raw.sort(axis=1)
        # Scalar-key unique: same lexicographic order as np.unique(axis=0).
        key = raw[:, 0] * np.int64(n_points) + raw[:, 1]
        ukey, inverse = np.unique(key, return_inverse=True)
        edges = np.stack([ukey // n_points, ukey % n_points], axis=1).astype(
            np.int32
        )
        face_of_raw = np.tile(np.arange(tris.shape[0], dtype=np.int32), 3)
        edge_faces = np.full((edges.shape[0], 2), -1, dtype=np.int32)
        order = np.argsort(inverse, kind="stable")
        eid_sorted = inverse[order]
        face_sorted = face_of_raw[order]
        first = np.concatenate([[True], eid_sorted[1:] != eid_sorted[:-1]])
        slot = np.arange(eid_sorted.shape[0]) - np.maximum.accumulate(
            np.where(first, np.arange(eid_sorted.shape[0]), 0)
        )
        keep = slot < 2  # non-manifold extra incidences are dropped
        edge_faces[eid_sorted[keep], slot[keep]] = face_sorted[keep]

    directed = np.concatenate([edges, edges[:, ::-1]], axis=0)
    counts = np.bincount(directed[:, 0], minlength=n_points)
    true_max = int(counts.max()) if counts.size and counts.max() > 0 else 1
    max_deg = _ell_width(true_max, degree_cap, pad_degree)

    # ELL fill: stable sort directed edges by source; slots beyond the cap
    # spill into the overflow edge list.
    order = np.argsort(directed[:, 0], kind="stable")
    src = directed[order, 0]
    dst = directed[order, 1]
    slot = np.arange(src.shape[0]) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]]
    )[src]
    in_ell = slot < max_deg
    neighbors = np.tile(np.arange(n_points, dtype=np.int32)[:, None], (1, max_deg))
    mask = np.zeros((n_points, max_deg), dtype=np.float32)
    neighbors[src[in_ell], slot[in_ell]] = dst[in_ell]
    mask[src[in_ell], slot[in_ell]] = 1.0
    overflow = (
        np.stack([src[~in_ell], dst[~in_ell]], axis=1).astype(np.int32)
        if (~in_ell).any()
        else np.zeros((0, 2), np.int32)
    )

    # Connected components, numbered in the order of their lowest vertex
    # (the JAX package's label propagation converges to each component's
    # lowest vertex id; its ~diameter rounds took 15 s at 655362 vertices).
    labels64 = np.arange(n_points, dtype=np.int64)
    if edges.shape[0]:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        adj = coo_matrix(
            (np.ones(edges.shape[0], np.int8), (edges[:, 0], edges[:, 1])),
            shape=(n_points, n_points),
        )
        n_comp, comp = connected_components(adj, directed=False)
        lowest = np.full(n_comp, n_points, np.int64)
        np.minimum.at(lowest, comp, labels64)
        labels64 = lowest[comp]
    _, labels = np.unique(labels64, return_inverse=True)
    return MeshTopology(
        edges=edges,
        neighbors=neighbors,
        nbr_mask=mask,
        max_degree=max_deg,
        edge_faces=edge_faces,
        component_labels=labels.astype(np.int32),
        n_components=int(labels.max()) + 1 if n_points else 0,
        overflow_edges=overflow,
    )


def _as_trimesh_vtk_bulk(obj):
    """Bulk vtkPolyData -> TriMesh through ``vtk.util.numpy_support`` when
    the real vtk module is importable (it is whenever the caller holds a
    live vtkPolyData): one array copy instead of per-point calls.  None
    falls back to the duck-typed loops (stand-in objects, polygonal cells
    that need the fan path, exotic builds)."""
    try:
        from vtk.util.numpy_support import vtk_to_numpy  # type: ignore

        n = int(obj.GetNumberOfPoints())
        points = np.asarray(vtk_to_numpy(obj.GetPoints().GetData()),
                            np.float32).reshape(n, 3)
        cells = vtk_to_numpy(obj.GetPolys().GetData()).astype(np.int64)
        # Legacy connectivity layout [k, v0..vk-1, k, ...]: uniform
        # triangles reshape directly, anything else takes the fan loop.
        if cells.size and cells.size % 4 == 0:
            quads = cells.reshape(-1, 4)
            if not np.all(quads[:, 0] == 3):
                return None
            triangles = quads[:, 1:].astype(np.int32)
        elif cells.size == 0:
            triangles = np.zeros((0, 3), np.int32)
        else:
            return None
        point_data = {}
        pdo = obj.GetPointData()
        for a in range(int(pdo.GetNumberOfArrays())):
            arr = pdo.GetArray(a)
            if arr is None:
                continue
            name = pdo.GetArrayName(a) or f"array_{a}"
            point_data[name] = np.asarray(vtk_to_numpy(arr), np.float32)
        return TriMesh(points=points, triangles=triangles, point_data=point_data)
    except Exception:
        return None


def as_trimesh(obj) -> TriMesh:
    """A :class:`TriMesh` from a mesh-like object: a ``TriMesh`` unchanged,
    or a live ``vtkPolyData`` (duck-typed on the VTK API, so nothing here
    imports vtk), its polygons fan-triangulated and its named point-data
    arrays carried over."""
    if isinstance(obj, TriMesh):
        return obj
    if hasattr(obj, "GetNumberOfPoints") and hasattr(obj, "GetNumberOfCells"):
        converted = _as_trimesh_vtk_bulk(obj)
        if converted is not None:
            return converted
        n = int(obj.GetNumberOfPoints())
        points = np.empty((n, 3), np.float32)
        for i in range(n):
            points[i] = obj.GetPoint(i)
        tris = []
        for c in range(int(obj.GetNumberOfCells())):
            ids = obj.GetCell(c).GetPointIds()
            k = int(ids.GetNumberOfIds())
            for t in range(1, k - 1):  # fan triangulation; k == 3 -> one
                tris.append((ids.GetId(0), ids.GetId(t), ids.GetId(t + 1)))
        triangles = np.asarray(tris, np.int32) if tris else np.zeros((0, 3), np.int32)
        point_data = {}
        pdo = obj.GetPointData() if hasattr(obj, "GetPointData") else None
        if pdo is not None:
            for a in range(int(pdo.GetNumberOfArrays())):
                arr = pdo.GetArray(a)
                if arr is None:
                    continue
                name = pdo.GetArrayName(a) or f"array_{a}"
                nt = int(arr.GetNumberOfTuples())
                nc = int(arr.GetNumberOfComponents())
                vals = np.empty((nt, nc), np.float32)
                for t in range(nt):
                    for cidx in range(nc):
                        vals[t, cidx] = arr.GetComponent(t, cidx)
                point_data[name] = vals[:, 0] if nc == 1 else vals
        return TriMesh(points=points, triangles=triangles, point_data=point_data)
    raise TypeError(
        f"cannot interpret {type(obj).__name__!r} as a mesh: expected a "
        "TriMesh or a vtkPolyData-like object"
    )


def load_mesh(path: str, dtype=np.float32) -> TriMesh:
    """Load a mesh file into a :class:`TriMesh` of numpy arrays (replaces
    ``vtk_functions.read_vtk_mesh``, reference ``vtk_functions.py:5-9``).
    Format by extension: legacy ``.vtk`` PolyData, XML ``.vtp``, ``.ply``,
    ``.obj`` and ``.stl``.  The arrays stay on the host;
    ``pipeline.mesh_to_graph_arrays`` moves them to the device."""
    points, triangles, point_data = read_any(path)
    return TriMesh(
        points=np.asarray(points, dtype=dtype),
        triangles=np.asarray(triangles, dtype=np.int32),
        point_data={k: np.asarray(v, dtype=dtype) for k, v in point_data.items()},
    )


def save_mesh(path: str, mesh: TriMesh) -> None:
    """Write ``mesh`` (numpy arrays or tensors on any device) in the format
    implied by ``path``'s extension (.vtk / .vtp / .ply / .obj / .stl); the
    file is the one the JAX package's ``save_mesh`` writes."""
    write_any(
        path,
        to_numpy(mesh.points, np.float64),
        to_numpy(mesh.triangles),
        {k: to_numpy(v, np.float64) for k, v in mesh.point_data.items()},
    )
