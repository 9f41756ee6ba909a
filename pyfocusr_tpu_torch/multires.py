"""Mesh subdivision (host-side numpy).

Counterpart of ``pyfocusr_tpu/multires.py:63`` (``subdivide``), the one
piece of the multiresolution module the synthetic test meshes need.  The
multiresolution registration itself is not ported yet.
"""

from __future__ import annotations

import numpy as np

from .mesh import TriMesh

__all__ = ["subdivide"]


def subdivide(mesh: TriMesh) -> TriMesh:
    """Midpoint (1-to-4) subdivision: each edge gains its midpoint vertex.
    N' = N + E, F' = 4F.  Point data is averaged onto midpoints."""
    pts = np.asarray(mesh.points, np.float64)
    tris = np.asarray(mesh.triangles, np.int64)
    n = pts.shape[0]
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.sort(e, axis=1)
    uniq, inv = np.unique(e[:, 0] * n + e[:, 1], return_inverse=True)
    eu = np.stack([uniq // n, uniq % n], axis=1)
    mids = 0.5 * (pts[eu[:, 0]] + pts[eu[:, 1]])
    new_pts = np.concatenate([pts, mids])
    m = inv.reshape(3, -1).T + n  # midpoint index per (tri, edge)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    mab, mbc, mca = m[:, 0], m[:, 1], m[:, 2]
    new_tris = np.concatenate(
        [
            np.stack([a, mab, mca], 1),
            np.stack([mab, b, mbc], 1),
            np.stack([mca, mbc, c], 1),
            np.stack([mab, mbc, mca], 1),
        ]
    )
    pd = {}
    for k, v in mesh.point_data.items():
        va = np.asarray(v, np.float64)
        pd[k] = np.concatenate([va, 0.5 * (va[eu[:, 0]] + va[eu[:, 1]])])
    return TriMesh(
        np.asarray(new_pts, np.float32),
        np.asarray(new_tris, np.int32),
        {k: np.asarray(v, np.float32) for k, v in pd.items()},
    )
