"""The reference's ``pyfocusr/vtk_functions.py`` surface over the port's
mesh and ops modules: the same function names, VTK nowhere in the compute
path.

Counterpart of ``pyfocusr_tpu/vtk_functions.py`` (:36-112):

  read_vtk_mesh / write_vtk_mesh  -> ``mesh.load_mesh`` / ``save_mesh``
  icp_transform                   -> ``ops/icp.icp`` (k-NN and close kernels
                                     on the card)
  apply_transform                 -> (s, R, t) applied to a TriMesh
  get_node_curvatures (+3)        -> ``ops/curvature.principal_curvatures``
  vtk_deep_copy                   -> a copy of the TriMesh's arrays

The functions that compute take ``device=None``: the CUDA card unless the
caller names the CPU (``utils.device.resolve_device``).  Their results are
tensors on that device, as the JAX package's are arrays on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import TriMesh, as_trimesh, build_topology, load_mesh, save_mesh
from .ops.curvature import principal_curvatures
from .ops.icp import apply_rigid
from .ops.icp import icp as _icp
from .utils.device import as_f32, resolve_device

__all__ = [
    "read_vtk_mesh",
    "write_vtk_mesh",
    "icp_transform",
    "apply_transform",
    "get_node_curvatures",
    "get_min_curvature",
    "get_max_curvature",
    "get_min_max_curvature_values",
    "vtk_deep_copy",
]


def read_vtk_mesh(path_to_file: str) -> TriMesh:
    return load_mesh(path_to_file)


def write_vtk_mesh(path_to_file: str, mesh: TriMesh) -> None:
    save_mesh(path_to_file, mesh)


def icp_transform(
    target: TriMesh,
    source: TriMesh,
    numberOfIterations: int = 100,
    number_landmarks: int = 1000,
    transform_mode: str = "rigid",
    device=None,
):
    """Fit ICP moving ``source`` onto ``target``; returns the (s, R, t)
    tuple.  ``number_landmarks`` is accepted for signature parity but
    unused, as in the reference (set after ``Update()``,
    ``vtk_functions.py:27-28``) and the JAX package: every point is used."""
    target, source = as_trimesh(target), as_trimesh(source)
    dev = resolve_device(device)
    (s, R, t), _moved = _icp(as_f32(source.points, dev), as_f32(target.points, dev),
                             mode=transform_mode, max_iterations=numberOfIterations)
    return (s, R, t)


def apply_transform(source: TriMesh, transform) -> TriMesh:
    """``source`` with its points moved by (s, R, t), on the transform's
    device."""
    source = as_trimesh(source)
    s, R, t = transform
    return source.with_points(apply_rigid(as_f32(source.points, R.device), s, R, t))


def _curvatures(mesh: TriMesh, device=None):
    mesh = as_trimesh(mesh)
    topo = build_topology(np.asarray(mesh.triangles), mesh.n_points)
    return principal_curvatures(as_f32(mesh.points, resolve_device(device)),
                                np.asarray(mesh.triangles), topo.edges, topo.edge_faces)


def get_node_curvatures(vtk_mesh: TriMesh, curvature_type: str = "min",
                        device=None) -> TriMesh:
    vtk_mesh = as_trimesh(vtk_mesh)
    kmin, kmax = _curvatures(vtk_mesh, device)
    vals = kmin if curvature_type == "min" else kmax
    return vtk_mesh.with_point_data(f"{curvature_type}_curvature", vals)


def get_max_curvature(vtk_mesh: TriMesh, device=None):
    return [_curvatures(vtk_mesh, device)[1].cpu().numpy()]


def get_min_curvature(vtk_mesh: TriMesh, device=None):
    return [_curvatures(vtk_mesh, device)[0].cpu().numpy()]


def get_min_max_curvature_values(vtk_mesh: TriMesh, device=None):
    kmin, kmax = _curvatures(vtk_mesh, device)
    return kmin.cpu().numpy(), kmax.cpu().numpy()


def vtk_deep_copy(mesh: TriMesh) -> TriMesh:
    """A TriMesh whose arrays share no memory with ``mesh``'s (tensors
    cloned on their device, anything else copied as numpy)."""
    mesh = as_trimesh(mesh)

    def copy(a):
        return a.clone() if torch.is_tensor(a) else np.array(a)

    return TriMesh(copy(mesh.points), copy(mesh.triangles),
                   {k: copy(v) for k, v in mesh.point_data.items()})
