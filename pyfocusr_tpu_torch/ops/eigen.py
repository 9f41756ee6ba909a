"""Smallest nonzero eigenpairs of the graph Laplacian by a wide-block
Chebyshev-filtered subspace iteration.

Counterpart of ``pyfocusr_tpu/ops/eigen.py``: ``_project_out`` (:58) and
``chebyshev_eigpairs_wide`` (:260), with the warm start ``x0``,
``return_block`` and the residual-gated ``extra_chunks`` top-up
(:425-454).  The narrow solver
``chebyshev_eigpairs`` (:482) and shift-invert Lanczos are not ported yet.

The solver works on the symmetrized A = S (D - W) S with the kernel (one
indicator per connected component, scaled by 1/s) deflated exactly.  Each
chunk applies a degree-``chunk_degree`` Chebyshev filter to a 128-wide
block, re-orthonormalizes it by SVQB (eigh of the [b, b] Gram with a rank
floor) and runs Rayleigh-Ritz; the small [b, b] products and the two
``eigh`` calls per chunk go to ``torch.matmul`` / ``torch.linalg.eigh``.

Randomness is an input: the JAX package draws the initial [N, b] block
from its key inside the solver; here the caller passes ``init_block`` (the
pipeline takes it from its ``draws``), so both packages can start from the
same block.  Only the SVQB refill noise, drawn when the filter collapses the
block below the rank floor, comes from ``generator``.
"""

from __future__ import annotations

import collections

import torch

from ..utils.precision import f32_matmuls

__all__ = ["chebyshev_eigpairs_wide", "SOLVES"]

# The last solves' schedules, newest last: rows, whether the block started
# warm, the chunks run and the top-up chunks among them.
SOLVES = collections.deque(maxlen=16)


def _project_out(v0, x):
    """Remove the span(V0) component: x - V0 (V0^T x).  v0: [N] unit vector
    or [N, C] orthonormal columns (zero columns project nothing)."""
    if v0.dim() == 1:
        if x.dim() == 1:
            return x - v0 * torch.dot(v0, x)
        return x - v0[:, None] * (v0 @ x)[None, :]
    return x - v0 @ (v0.T @ x)


def _randn(shape, generator, device):
    """Standard normals from ``generator`` (on its own device), on ``device``."""
    gdev = generator.device if generator is not None else device
    return torch.randn(
        shape, generator=generator, device=gdev, dtype=torch.float32
    ).to(device)


@f32_matmuls
def chebyshev_eigpairs_wide(
    matvec,
    null_vec: torch.Tensor,
    k: int,
    lam_max_bound,
    filter_op_factory,
    quad_form,
    init_block: torch.Tensor = None,
    block_width: int = 128,
    chunk_degree: int = 33,
    chunks: int = 6,
    cut_index: int = 23,
    subspace_mask=None,
    x0=None,
    return_block: bool = False,
    extra_chunks: int = 0,
    extra_resid_tol: float = 3e-4,
    generator: torch.Generator = None,
):
    """k smallest nonzero eigenpairs of the symmetric PSD operator
    ``matvec`` ([N, C] -> [N, C]).

    ``lam_max_bound``: an upper bound of A's spectrum (the pipeline's
    Gershgorin bound).  ``filter_op_factory(c, e)`` returns the fused
    filter step T -> (2/e)(A T - c T); ``quad_form(V) -> [k]`` gives the
    cancellation-free final Rayleigh quotients.  (The JAX version's
    power-iteration bound and black-box filter fallbacks have no caller
    here and are not ported.)  ``init_block`` f32 [N, >= b]: the random starting block
    (its first b columns are used).  ``x0`` [N, m]: warm-start columns
    that replace the first m columns of the block; when x0 covers all b
    columns ``init_block`` may be None.  After ``chunks``
    chunks, up to ``extra_chunks`` more run while the largest wanted-mode
    residual exceeds ``extra_resid_tol * lam_max`` (read on the host).

    Returns (lams [k], vecs [N, k], resid [k]) and, with ``return_block``,
    the final filtered block [N, b].
    """
    n = null_vec.shape[0]
    device = null_vec.device
    if null_vec.dim() == 1:
        v0 = null_vec / null_vec.norm()
        n_null = 1
    else:
        norms = null_vec.norm(dim=0, keepdim=True)
        v0 = null_vec / torch.clamp(norms, min=1e-30)
        n_null = null_vec.shape[1]
    b = min(block_width, max(n - n_null - 1, k + 2))
    cut = min(cut_index, max(b - 4, k))

    lam_max = torch.as_tensor(lam_max_bound, dtype=torch.float32,
                              device=device) * 1.005

    def cheb_filter(X, a, deg):
        c = (lam_max + a) / 2.0
        e = (lam_max - a) / 2.0
        op = filter_op_factory(c, e)
        t_prev = X
        t_cur = 0.5 * op(X)
        for _ in range(deg - 1):
            t_prev, t_cur = t_cur, op(t_cur) - t_prev
        return t_cur

    def svqb_rr(Y):
        """Rank-robust orthonormalization + Rayleigh-Ritz -> (X, theta).
        Gram directions below the rank floor are refilled with projected
        noise (filtered restarts) rather than zeroed, which would surface
        as spurious theta = 0 modes."""
        Y = Y / torch.clamp(Y.norm(dim=0, keepdim=True), min=1e-30)
        G = Y.T @ Y
        e, U = torch.linalg.eigh(G)
        floor = e[-1] * 1e-10
        valid = e > floor
        inv = torch.where(
            valid, 1.0 / torch.sqrt(torch.maximum(e, floor)), torch.zeros_like(e)
        )
        Q = Y @ (U * inv[None, :])
        if not bool(valid.all()):
            noise = _randn(Q.shape, generator, device)
            if subspace_mask is not None:
                noise = noise * subspace_mask[:, None]
            noise = _project_out(v0, noise)
            noise = noise / torch.clamp(noise.norm(dim=0, keepdim=True), min=1e-30)
            Q = torch.where(valid[None, :], Q, noise)
        H = Q.T @ matvec(Q)
        H = 0.5 * (H + H.T)
        theta, S = torch.linalg.eigh(H)
        return Q @ S, theta

    def next_cut(theta):
        return torch.clamp(1.5 * theta[cut], lam_max * 1e-5, lam_max * 2e-2)

    if x0 is not None and x0.shape[1] >= b:
        X = x0[:, :b].to(torch.float32).clone()
    else:
        if init_block is None:
            raise ValueError(
                f"init_block [N, >= {b}] is required unless x0 covers all "
                f"{b} block columns"
            )
        X = init_block[:, :b].to(torch.float32).clone()
        if x0 is not None:
            X[:, : x0.shape[1]] = x0.to(torch.float32)
    if subspace_mask is not None:
        X = X * subspace_mask[:, None]
    X = _project_out(v0, X)
    a = lam_max * 1e-3
    for _ in range(chunks):
        X = _project_out(v0, cheb_filter(X, a, chunk_degree))
        X, theta = svqb_rr(X)
        a = next_cut(theta)

    def wanted_resid(Xc):
        V = Xc[:, :k]
        V = V / torch.clamp(V.norm(dim=0, keepdim=True), min=1e-30)
        Av = matvec(V)
        th = (V * Av).sum(dim=0)
        return (Av - V * th[None, :]).norm(dim=0).max()

    done = 0
    if extra_chunks > 0:
        while done < extra_chunks and bool(
            wanted_resid(X) > extra_resid_tol * lam_max
        ):
            X = _project_out(v0, cheb_filter(X, a, chunk_degree))
            X, theta = svqb_rr(X)
            a = next_cut(theta)
            done += 1

    SOLVES.append({"n": n, "warm": x0 is not None, "chunks": chunks + done,
                   "top_up_chunks": done})
    V = X[:, :k]
    V = V / V.norm(dim=0, keepdim=True)
    Av = matvec(V)
    resid = (Av - V * (V * Av).sum(dim=0)[None, :]).norm(dim=0)
    lams = quad_form(V)
    if return_block:
        return lams, V, resid, X
    return lams, V, resid
