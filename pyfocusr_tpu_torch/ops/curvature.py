"""Discrete principal curvatures per vertex.

Counterpart of ``pyfocusr_tpu/ops/curvature.py``: ``gaussian_curvature``
(:47, angle deficit over a third of the one-ring area), ``mean_curvature``
(:66, edge length times signed dihedral angle, oriented by the first
face's winding) and ``principal_curvatures`` (:108, H -/+ sqrt(max(H^2 - K,
0))), the 'curvature' features of ``spectral/graph.py``.

The per-vertex sums are ``index_add_`` scatter-adds.  On a CUDA device
they use float atomics, so their order, and the last bits of each sum,
change from run to run: compare the card with the CPU by tolerance.
"""

from __future__ import annotations

import math

import torch

__all__ = ["principal_curvatures", "gaussian_curvature", "mean_curvature"]


def _face_geometry(points, triangles):
    p0, p1, p2 = (points[triangles[:, c]] for c in range(3))
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    norm = n.norm(dim=1, keepdim=True)
    return p0, p1, p2, n / torch.clamp(norm, min=1e-30), 0.5 * norm[:, 0]


def gaussian_curvature(points, triangles, n_points: int):
    """(2 pi - sum of incident angles) / (incident area / 3) per vertex."""
    p0, p1, p2, _, area = _face_geometry(points, triangles)
    angle_sum = torch.zeros((n_points,), dtype=points.dtype, device=points.device)
    area_sum = torch.zeros_like(angle_sum)
    for c, (a, b, d) in enumerate(((p0, p1, p2), (p1, p2, p0), (p2, p0, p1))):
        e1, e2 = b - a, d - a
        cosang = (e1 * e2).sum(dim=1) / torch.clamp(
            e1.norm(dim=1) * e2.norm(dim=1), min=1e-30)
        angle_sum.index_add_(0, triangles[:, c], torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
        area_sum.index_add_(0, triangles[:, c], area)
    return (2.0 * math.pi - angle_sum) / torch.clamp(area_sum / 3.0, min=1e-30)


def mean_curvature(points, triangles, edges, edge_faces, n_points: int):
    """Edge-based mean curvature: edges [E, 2] (i < j) with their two faces
    ``edge_faces`` [E, 2] (-1 on a boundary, which contributes zero)."""
    _, _, _, normal, area = _face_geometry(points, triangles)
    interior = (edge_faces >= 0).all(dim=1)
    f0 = torch.clamp(edge_faces[:, 0], min=0)
    n0, n1 = normal[f0], normal[torch.clamp(edge_faces[:, 1], min=0)]
    evec = points[edges[:, 1]] - points[edges[:, 0]]
    elen = evec.norm(dim=1)
    ehat = evec / torch.clamp(elen[:, None], min=1e-30)
    phi = torch.atan2((torch.linalg.cross(n0, n1) * ehat).sum(dim=1), (n0 * n1).sum(dim=1))
    # phi's sign follows the arbitrary order of (f0, f1): orient it by
    # whether f0 winds along the edge as i -> j.
    tri0 = triangles[f0]
    i, j = edges[:, 0], edges[:, 1]
    forward = (((tri0[:, 0] == i) & (tri0[:, 1] == j))
               | ((tri0[:, 1] == i) & (tri0[:, 2] == j))
               | ((tri0[:, 2] == i) & (tri0[:, 0] == j)))
    phi = torch.where(forward, phi, -phi)
    contrib = torch.where(interior, elen * phi, torch.zeros_like(phi))
    acc = torch.zeros((n_points,), dtype=points.dtype, device=points.device)
    acc.index_add_(0, i, contrib).index_add_(0, j, contrib)
    a_v = torch.zeros_like(acc)
    for c in range(3):
        a_v.index_add_(0, triangles[:, c], area)
    return acc / torch.clamp(4.0 * a_v / 3.0, min=1e-30)


def principal_curvatures(points, triangles, edges, edge_faces):
    """(k_min [N], k_max [N]) on the device of ``points``; the index
    arrays may be numpy or tensors."""
    dev = points.device

    def idx(a):
        return torch.as_tensor(a, device=dev).long()

    triangles, edges, edge_faces = idx(triangles), idx(edges), idx(edge_faces)
    n_points = points.shape[0]
    K = gaussian_curvature(points, triangles, n_points)
    H = mean_curvature(points, triangles, edges, edge_faces, n_points)
    disc = torch.sqrt(torch.clamp(H * H - K, min=0.0))
    return H - disc, H + disc
