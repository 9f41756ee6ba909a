"""Low-rank deformable Coherent Point Drift (Myronenko & Song 2010).

Counterpart of ``pyfocusr_tpu/ops/cpd.py``: ``gaussian_kernel`` (:64),
``_estep`` (:69), ``_init_sigma2`` (:93), ``low_rank_gaussian`` (:198,
the dense-Gram branch, M <= 8192), ``_deformable_cpd_run`` (:266, dense
E-step, no landmarks) and ``lowrank_transform`` (:387).

Kept from the JAX version for f32 reasons:

* Householder QR (``torch.linalg.qr``) in the randomized subspace
  iteration; the Gram-based SVQB swap fails in f32 (``cpd.py:223-236``);
* the balanced eigenbasis M-step, (S C S + a_s2 I) z = S Q^T F, instead of
  the Woodbury form, which cancels in f32 (``cpd.py:278-296``).

The dense E-step materializes P [M, N]; at the pipeline's 1000-point
subsample that is a [1000, 1000] product left to ``torch.matmul``.  The
streamed E-step (TPU kernel ``cpd_estep_pallas``) is not ported yet.  The
EM loop is a Python loop whose stop test |delta sigma2| <= tol is read on
the host each iteration, as the JAX ``while_loop`` tests it.
"""

from __future__ import annotations

import math

import torch

from ..utils.precision import f32_matmuls
from .knn import pairwise_sq_dists

__all__ = [
    "gaussian_kernel",
    "low_rank_gaussian",
    "lowrank_transform",
]


def gaussian_kernel(a, b, beta):
    """G[i, j] = exp(-||a_i - b_j||^2 / (2 beta^2))."""
    return torch.exp(-pairwise_sq_dists(a, b) / (2.0 * beta**2))


def _estep(X, TY, sigma2, w):
    """CPD E-step.  Returns (Pt1 [N], P1 [M], PX [M, D], Np, L)."""
    M = TY.shape[0]
    N, D = X.shape
    d2 = pairwise_sq_dists(TY, X)  # [M, N]
    P = torch.exp(-d2 / (2.0 * sigma2))
    c = (2.0 * math.pi * sigma2) ** (D / 2.0) * (w / (1.0 - w)) * (M / N) if w > 0 else 0.0
    den = torch.clamp(P.sum(dim=0) + c, min=1e-30)
    L = -torch.log(den).sum() + D * N * torch.log(sigma2) / 2.0
    P = P / den[None, :]
    Pt1 = P.sum(dim=0)
    P1 = P.sum(dim=1)
    PX = P @ X
    Np = P1.sum()
    return Pt1, P1, PX, Np, L


def _init_sigma2(X, Y):
    """sigma2_0 = sum_ij ||y_i - x_j||^2 / (D M N) in closed form, after
    shifting both clouds by their joint mean."""
    N, D = X.shape
    M = Y.shape[0]
    c = (X.sum(dim=0) + Y.sum(dim=0)) / (M + N)
    Xc = X - c[None, :]
    Yc = Y - c[None, :]
    total = (
        N * (Yc * Yc).sum()
        + M * (Xc * Xc).sum()
        - 2.0 * torch.dot(Yc.sum(dim=0), Xc.sum(dim=0))
    )
    return torch.clamp(total, min=0.0) / (D * M * N)


@f32_matmuls
def low_rank_gaussian(Y, beta, num_eig: int, omega):
    """Top-``num_eig`` eigenpairs of the M x M Gaussian Gram of Y by
    randomized subspace iteration from the caller's f32 [M, >= p] normal
    block ``omega`` (p = min(num_eig + 16, M)).  Returns (Q [M, k], lam [k])
    with G ~ Q diag(lam) Q^T; negative noise-floor estimates clamp to 0."""
    M = Y.shape[0]
    if M > 8192:
        raise NotImplementedError(
            "low_rank_gaussian above 8192 points needs the tiled Gram "
            "matvec, not ported yet (ROADMAP Queue 1 item 10)"
        )
    G = gaussian_kernel(Y, Y, beta)
    p = min(num_eig + 16, M)
    Z = G @ omega[:, :p].to(Y.dtype)
    Qb, _ = torch.linalg.qr(Z)
    for _ in range(2):  # subspace iterations sharpen the small eigenvalues
        Qb, _ = torch.linalg.qr(G @ Qb)
    H = Qb.T @ (G @ Qb)
    H = 0.5 * (H + H.T)
    lam, S = torch.linalg.eigh(H)  # ascending
    lam = torch.flip(lam, dims=[0])[:num_eig]
    S = torch.flip(S, dims=[1])[:, :num_eig]
    return Qb @ S, torch.clamp(lam, min=0.0)


def _sqrt_lam_gated(lam, dtype):
    """sqrt(lam), zeroed below the f32 identifiability floor lam_0 * 2 eps."""
    eps2 = 2.0 * torch.finfo(dtype).eps
    return torch.where(lam > lam[0] * eps2, torch.sqrt(lam), torch.zeros_like(lam))


@f32_matmuls
def _deformable_cpd_run(X, Y, Q, lam, alpha: float, max_iterations: int,
                        tolerance: float, w: float = 0.0):
    """EM loop with the balanced low-rank M-step.  Moves Y onto X.
    Returns (TY, z, sigma2, iterations) with z the spectral warp
    coefficients (displacement at the control points = Q diag(sqrt lam) z)."""
    N, D = X.shape
    k = lam.shape[0]
    sigma2 = _init_sigma2(X, Y)
    sqrt_lam = _sqrt_lam_gated(lam, X.dtype)
    eye_k = torch.eye(k, dtype=X.dtype, device=X.device)
    xx = (X * X).sum(dim=1)

    def kernel_apply_z(z):
        return Q @ (sqrt_lam[:, None] * z)

    z = torch.zeros((k, D), dtype=X.dtype, device=X.device)
    it = 0
    err = torch.tensor(float("inf"), dtype=X.dtype, device=X.device)
    while it < max_iterations and bool(err > tolerance):
        TY = Y + kernel_apply_z(z)
        Pt1, P1, PX, Np, _ = _estep(X, TY, sigma2, w)
        a_s2 = alpha * sigma2
        F = PX - P1[:, None] * Y
        Ft = Q.T @ F
        C = Q.T @ (P1[:, None] * Q)
        A = sqrt_lam[:, None] * C * sqrt_lam[None, :] + a_s2 * eye_k
        z = torch.linalg.solve(A, sqrt_lam[:, None] * Ft)
        TY_new = Y + kernel_apply_z(z)
        xPx = torch.dot(Pt1, xx)
        yPy = torch.dot(P1, (TY_new * TY_new).sum(dim=1))
        trPXY = (TY_new * PX).sum()
        sigma2_new = torch.clamp(
            (xPx - 2.0 * trPXY + yPy) / (Np * D), min=tolerance / 10.0
        )
        err = (sigma2_new - sigma2).abs()
        sigma2 = sigma2_new
        it += 1
    return Y + kernel_apply_z(z), z, sigma2, it


# Rows of the [rows, M] kernel block per step of lowrank_transform.
_TRANSFORM_MAX_ELEMS = 32_000_000
_TRANSFORM_TILE = 2048


@f32_matmuls
def lowrank_transform(points, Y0, Q, lam, z, beta):
    """Out-of-sample warp of the fitted field, points + G(points, Y0) @ W,
    with the balanced weights W = Q diag(1/sqrt lam) z (same gate as the
    fit).  Evaluated in row blocks above 32M kernel entries."""
    sqrt_lam = _sqrt_lam_gated(lam, points.dtype)
    safe = torch.clamp(sqrt_lam, min=torch.finfo(points.dtype).tiny)
    wt = torch.where(sqrt_lam[:, None] > 0, z / safe[:, None], torch.zeros_like(z))
    W = Q @ wt

    def move(pts):
        return pts + gaussian_kernel(pts, Y0, beta) @ W

    n = points.shape[0]
    if n * Y0.shape[0] <= _TRANSFORM_MAX_ELEMS:
        return move(points)
    return torch.cat(
        [move(points[s : s + _TRANSFORM_TILE]) for s in range(0, n, _TRANSFORM_TILE)]
    )
