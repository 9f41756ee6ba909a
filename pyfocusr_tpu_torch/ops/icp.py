"""Iterative closest point (rigid / similarity) registration.

Counterpart of ``pyfocusr_tpu/ops/icp.py``: ``umeyama`` (:31),
``apply_rigid`` (:61) and ``icp`` (:67).  Each iteration is one
nearest-neighbour query (the k-NN kernel on CUDA) plus a closed-form
Umeyama/Kabsch update; the JAX ``lax.while_loop`` is a Python loop whose
stop test — mean motion <= 1e-5 * scale, or ``max_iterations`` — is read on
the host each iteration, in f32 like the JAX test.
"""

from __future__ import annotations

import torch

from ..utils.precision import f32_matmuls
from .knn import nn_query

__all__ = ["umeyama", "icp", "apply_rigid"]


def umeyama(src, dst, with_scale: bool, weights=None):
    """Least-squares similarity/rigid transform mapping src -> dst: returns
    (scale s, rotation R [3, 3], translation t [3]) minimizing
    sum_i w_i ||dst_i - (s R src_i + t)||^2 (Umeyama 1991)."""
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(weights.sum(), min=1e-30)
    wn = (weights / wsum)[:, None]
    mu_s = (src * wn).sum(dim=0)
    mu_d = (dst * wn).sum(dim=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc * wn).T @ sc
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.ones(3, dtype=cov.dtype, device=cov.device)
    diag[2] = d
    R = U @ torch.diag(diag) @ Vt
    if with_scale:
        var_s = ((sc * sc).sum(dim=1) * wn[:, 0]).sum()
        s = (S * diag).sum() / torch.clamp(var_s, min=1e-30)
    else:
        s = torch.ones((), dtype=cov.dtype, device=cov.device)
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def apply_rigid(points, s, R, t):
    return s * (points @ R.T) + t


@f32_matmuls
def icp(source_points, target_points, mode: str = "rigid",
        max_iterations: int = 100, source_mask=None, return_iterations=False):
    """ICP registering source onto target, starting by matching centroids.

    Returns ((s, R, t), moved) with moved = s * source @ R.T + t; with
    ``return_iterations`` also the number of iterations run."""
    with_scale = mode == "similarity"
    if mode not in ("rigid", "similarity"):
        raise ValueError("Error invalid transform mode")
    dt, dev = source_points.dtype, source_points.device
    if source_mask is None:
        source_mask = torch.ones(source_points.shape[0], dtype=dt, device=dev)
    wn = source_mask / torch.clamp(source_mask.sum(), min=1e-30)
    # Target centroid and scale over finite (non-sentinel) rows only.
    finite_t = (target_points.abs() < 1e29).all(dim=1).to(dt)
    tn = finite_t / torch.clamp(finite_t.sum(), min=1e-30)
    t0 = (target_points * tn[:, None]).sum(dim=0) - (
        source_points * wn[:, None]
    ).sum(dim=0)
    moved = source_points + t0
    scale = (target_points * finite_t[:, None]).abs().max() + 1.0
    threshold = 1e-5 * scale

    s = torch.ones((), dtype=dt, device=dev)
    R = torch.eye(3, dtype=dt, device=dev)
    t = t0
    it = 0
    delta = torch.tensor(float("inf"), dtype=dt, device=dev)
    while it < max_iterations and bool(delta > threshold):
        _, idx = nn_query(target_points, moved)
        matched = target_points[idx]
        s, R, t = umeyama(source_points, matched, with_scale, weights=source_mask)
        new_moved = apply_rigid(source_points, s, R, t)
        step = torch.linalg.norm(new_moved - moved, dim=1)
        delta = (torch.where(source_mask > 0, step, torch.zeros_like(step)) * wn).sum()
        moved = new_moved
        it += 1
    if return_iterations:
        return (s, R, t), moved, it
    return (s, R, t), moved
