"""Optional visualization adapters (reference L5, ``focusr.py:646-795`` and
``graph.py:296-314``, built on itkwidgets).

A copy of ``pyfocusr_tpu/utils/viz.py``: the first-class visualization
paths are ``.vtk`` files any viewer opens (``save_mesh``) and the
standalone HTML/WebGL viewer (``utils.html_viewer.export_html`` /
``Focusr.export_viewer_html``).  If itkwidgets is installed, the
``view_*`` entry points return a live Viewer like the reference's;
otherwise they raise the reference's ImportError (``focusr.py:6-10,658``).
Arrays may be tensors on any device: they reach the viewer as numpy
(``utils.device.to_numpy``).
"""

from __future__ import annotations

import numpy as np

from .device import to_numpy

try:  # pragma: no cover - optional dependency
    from itkwidgets import Viewer  # type: ignore
except Exception:  # pragma: no cover
    Viewer = None

__all__ = [
    "Viewer",
    "view_mesh",
    "view_meshes",
    "view_point_sets",
    "require_viewer",
    "default_colors",
]


def require_viewer():
    if Viewer is None:
        raise ImportError(
            "Viewer from itkwidgets not imported properly - cant view."
        )


def default_colors(n: int):
    """Matplotlib-V2 cycle colors as RGB triples (reference ``focusr.py:707``)."""
    try:
        from matplotlib import colors

        return [colors.to_rgb(f"C{x}") for x in range(n)]
    except Exception:
        base = [
            (0.12, 0.47, 0.71),
            (1.00, 0.50, 0.05),
            (0.17, 0.63, 0.17),
            (0.84, 0.15, 0.16),
        ]
        return [base[i % len(base)] for i in range(n)]


def _to_vtk_polydata(mesh):
    """A vtkPolyData, when the vtk package is available (optional)."""
    import vtk  # type: ignore
    from vtk.util.numpy_support import numpy_to_vtk, numpy_to_vtkIdTypeArray  # type: ignore

    pd = vtk.vtkPolyData()
    pts = vtk.vtkPoints()
    pts.SetData(numpy_to_vtk(to_numpy(mesh.points, np.float64)))
    pd.SetPoints(pts)
    tris = to_numpy(mesh.triangles, np.int64)
    cells = vtk.vtkCellArray()
    conn = np.column_stack([np.full(len(tris), 3, np.int64), tris]).ravel()
    cells.SetCells(len(tris), numpy_to_vtkIdTypeArray(conn, deep=True))
    pd.SetPolys(cells)
    for name, arr in mesh.point_data.items():
        va = numpy_to_vtk(np.ascontiguousarray(to_numpy(arr, np.float64)))
        va.SetName(name)
        pd.GetPointData().AddArray(va)
        pd.GetPointData().SetActiveScalars(name)
    return pd


def _geometry(mesh):
    """A vtkPolyData when the vtk package is present (the reference's
    behaviour); otherwise the raw arrays (itkwidgets accepts several
    geometry forms, and a stub viewer in tests accepts anything)."""
    try:
        return _to_vtk_polydata(mesh)
    except Exception:
        return {
            "points": to_numpy(mesh.points, np.float64),
            "triangles": to_numpy(mesh.triangles, np.int64),
            "point_data": {k: to_numpy(v) for k, v in mesh.point_data.items()},
        }


def view_mesh(mesh, **kwargs):
    require_viewer()
    return Viewer(geometries=[_geometry(mesh)], **kwargs)


def view_meshes(meshes, **kwargs):
    require_viewer()
    return Viewer(geometries=[_geometry(m) for m in meshes], **kwargs)


def view_point_sets(point_sets, representations=None, colors=None, **kwargs):
    require_viewer()
    point_sets = [np.ascontiguousarray(to_numpy(p)) for p in point_sets]
    if colors is None:
        colors = default_colors(len(point_sets))
    if representations is not None and len(representations) == 1 and len(point_sets) > 1:
        representations = representations * len(point_sets)
    return Viewer(
        point_sets=point_sets,
        point_set_representations=representations or ["spheres"] * len(point_sets),
        point_set_colors=colors,
        **kwargs,
    )
