"""Graph operators over fixed-degree (ELL) neighbour tables.

Counterpart of ``pyfocusr_tpu/ops/graph_ops.py``: ``edge_weights`` (:49),
``overflow_weights`` (:68), ``degree_vector`` (:80), ``spmv`` (:88),
``mean_filter`` (:109), ``g_vector`` (:131), ``laplacian_matvec`` (:197),
``sym_laplacian_matvec`` (:215), ``sym_laplacian_quad_form`` (:237), ``_chebyshev_power_coeffs``
(:261) and ``mean_filter_chebyshev`` (:279).

The graph is (neighbors int64 [N, D], weights f32 [N, D]) with padding
slots at weight 0, plus hub-vertex overflow edges int64 [E_o, 2] (src, dst)
applied by ``index_add_``.  On CUDA ``index_add_`` uses atomics, so the
order of the overflow sums (and so their last bits) changes from run to run.
The 40-600 step smoothing loops of the JAX package's ``lax.scan`` /
``fori_loop`` are Python loops here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "DEGREE_EPS",
    "edge_weights",
    "overflow_weights",
    "degree_vector",
    "spmv",
    "mean_filter",
    "mean_filter_chebyshev",
    "g_vector",
    "laplacian_matvec",
    "sym_laplacian_matvec",
    "sym_laplacian_quad_form",
]

DEGREE_EPS = 1e-8  # (d + 1e-8)^-1, as the JAX package and its reference


def _has(overflow) -> bool:
    return overflow is not None and overflow.shape[0] > 0


def edge_weights(coords, neighbors, nbr_mask):
    """w[i, s] = 1 / ||c_i - c_{nbr[i, s]}|| over real slots, 0 on padding;
    coincident connected vertices clamp to a huge finite weight."""
    diff = coords[neighbors] - coords[:, None, :]
    dist = torch.sqrt((diff * diff).sum(dim=-1))
    real = nbr_mask > 0
    safe = torch.clamp(torch.where(real, dist, torch.ones_like(dist)), min=1e-20)
    return torch.where(real, 1.0 / safe, torch.zeros_like(safe))


def overflow_weights(coords, overflow):
    """w = 1/dist for overflow directed edges; src == dst rows get 0."""
    if overflow.shape[0] == 0:
        return torch.zeros((0,), dtype=coords.dtype, device=coords.device)
    src, dst = overflow[:, 0], overflow[:, 1]
    diff = coords[src] - coords[dst]
    dist = torch.sqrt((diff * diff).sum(dim=-1))
    real = src != dst
    safe = torch.clamp(torch.where(real, dist, torch.ones_like(dist)), min=1e-20)
    return torch.where(real, 1.0 / safe, torch.zeros_like(safe))


def degree_vector(weights, overflow=None, ov_w=None):
    """d_i = sum_j w_ij (row sums of W, overflow edges included)."""
    d = weights.sum(dim=1)
    if _has(overflow):
        d = d.index_add(0, overflow[:, 0], ov_w)
    return d


def spmv(neighbors, weights, x, overflow=None, ov_w=None):
    """y = W @ x for x of shape [N] or [N, C]."""
    if x.dim() == 1:
        y = (weights * x[neighbors]).sum(dim=1)
        if _has(overflow):
            y.index_add_(0, overflow[:, 0], ov_w * x[overflow[:, 1]])
        return y
    y = torch.einsum("nd,ndc->nc", weights, x[neighbors])
    if _has(overflow):
        y.index_add_(0, overflow[:, 0], ov_w[:, None] * x[overflow[:, 1]])
    return y


def mean_filter(neighbors, weights, values, iterations: int, overflow=None,
                ov_w=None):
    """Iterative graph low-pass: out <- diag(1/(1+d)) (W + I) out, repeated
    ``iterations`` times."""
    squeeze = values.dim() == 1
    x = values[:, None] if squeeze else values
    inv = 1.0 / (1.0 + degree_vector(weights, overflow, ov_w))
    for _ in range(iterations):
        x = inv[:, None] * (spmv(neighbors, weights, x, overflow, ov_w) + x)
    return x[:, 0] if squeeze else x


def g_vector(node_features, degrees, feature_weights, p_function: str = "exp",
             include_features: bool = False, valid_mask=None):
    """Diagonal of G in L = G (D - W): (d + 1e-8)^-1 without features; with
    features, each transformed feature (exp/log/square/shift) is scaled into
    the range of the degrees, weighted by ``feature_weights[k, k]``,
    averaged, and multiplied by (d + 1e-8)^-1.  ``valid_mask`` keeps
    padding rows out of the min/max statistics."""
    d_inv = (degrees + DEGREE_EPS) ** -1
    if not include_features or node_features is None or node_features.shape[0] == 0:
        return d_inv

    inf = torch.tensor(float("inf"), device=degrees.device)

    def mmin(x):
        return x.min() if valid_mask is None else torch.where(valid_mask > 0, x, inf).min()

    def mmax(x):
        return x.max() if valid_mask is None else torch.where(valid_mask > 0, x, -inf).max()

    k_features = node_features.shape[0]
    g = torch.zeros_like(degrees)
    deg_ptp = mmax(degrees) - mmin(degrees)
    for k in range(k_features):
        f = node_features[k]
        if p_function == "exp":
            gk = torch.exp(f)
        elif p_function == "log":
            gk = torch.log(f - mmin(f) + 1.0)
        elif p_function == "square":
            gk = f**2
        else:
            gk = f - mmin(f)
        # A constant transformed feature carries no information: weight 0.
        gk_ptp = mmax(gk) - mmin(gk)
        scaling = torch.where(
            gk_ptp > 0,
            feature_weights[k, k] * deg_ptp / torch.clamp(gk_ptp, min=1e-30),
            torch.zeros_like(gk_ptp),
        )
        g = g + gk * scaling
    g = g / k_features
    return g * d_inv


def laplacian_matvec(neighbors, weights, g, x, overflow=None, ov_w=None,
                     degrees=None):
    """L x = g * (d * x - W x), the non-symmetric L = G (D - W), for x of
    shape [N] or [N, C]."""
    d = degrees if degrees is not None else degree_vector(weights, overflow, ov_w)
    if x.dim() == 1:
        return g * (d * x - spmv(neighbors, weights, x, overflow, ov_w))
    return g[:, None] * (d[:, None] * x - spmv(neighbors, weights, x, overflow, ov_w))


def sym_laplacian_matvec(neighbors, weights, g, x, overflow=None, ov_w=None,
                         degrees=None):
    """A x with A = diag(s) (D - W) diag(s), s = sqrt(g)."""
    s = torch.sqrt(g)
    d = degrees if degrees is not None else degree_vector(weights, overflow, ov_w)
    if x.dim() == 1:
        sx = s * x
        return s * (d * sx - spmv(neighbors, weights, sx, overflow, ov_w))
    sx = s[:, None] * x
    return s[:, None] * (
        d[:, None] * sx - spmv(neighbors, weights, sx, overflow, ov_w)
    )


def sym_laplacian_quad_form(neighbors, weights, s, V, overflow=None, ov_w=None):
    """Per-column Rayleigh quotients of A = S(D-W)S on unit-norm V as the
    edge-difference form 1/2 sum_(i,j) w_ij (u_i - u_j)^2, u = s V — a sum
    of non-negative terms, free of the D x - W x cancellation."""
    u = s[:, None] * V
    du = u[neighbors] - u[:, None, :]
    acc = torch.einsum("nd,ndk->k", weights, du * du)
    if _has(overflow):
        dov = u[overflow[:, 0]] - u[overflow[:, 1]]
        acc = acc + (ov_w[:, None] * dov * dov).sum(dim=0)
    return 0.5 * acc


def _chebyshev_power_coeffs(q: int, m: int):
    """Chebyshev-series coefficients of t^q on [-1, 1], degree m, in f64 on
    the host (DCT at Chebyshev points)."""
    n = m + 1
    theta = (np.arange(n) + 0.5) * np.pi / n
    t = np.cos(theta)
    f = t.astype(np.float64) ** q
    k = np.arange(n)[:, None]
    c = (2.0 / n) * (np.cos(k * theta[None, :]) @ f)
    c[0] *= 0.5
    return c


def mean_filter_chebyshev(neighbors, weights, values, iterations: int,
                          overflow=None, ov_w=None):
    """The same operator power A^q as ``mean_filter`` (A = diag(1/(1+d))
    (W + I)), applied as a degree ~sqrt(2 q ln 1e5) Chebyshev polynomial of
    the symmetrized S = D~^-1/2 (W + I) D~^-1/2."""
    q = iterations
    degree = min(q, int(math.sqrt(2.0 * q * math.log(1e5))) + 8)
    if degree >= q:
        return mean_filter(neighbors, weights, values, q, overflow, ov_w)

    squeeze = values.dim() == 1
    x = values[:, None] if squeeze else values
    d = degree_vector(weights, overflow, ov_w)
    inv_sqrt = (1.0 + d) ** -0.5

    def s_op(v):
        u = inv_sqrt[:, None] * v
        return inv_sqrt[:, None] * (spmv(neighbors, weights, u, overflow, ov_w) + u)

    coeffs = torch.as_tensor(
        _chebyshev_power_coeffs(q, degree), dtype=torch.float32
    ).to(x.device)
    x0 = x / inv_sqrt[:, None]
    t_prev = x0
    t_cur = s_op(x0)
    acc = coeffs[0] * t_prev + coeffs[1] * t_cur
    for kk in range(2, degree + 1):
        t_next = 2.0 * s_op(t_cur) - t_prev
        acc = acc + coeffs[kk] * t_next
        t_prev, t_cur = t_cur, t_next
    out = inv_sqrt[:, None] * acc
    return out[:, 0] if squeeze else out
