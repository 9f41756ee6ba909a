"""Coherent Point Drift (Myronenko & Song 2010): affine and low-rank
deformable registration.

Counterpart of ``pyfocusr_tpu/ops/cpd.py``: ``gaussian_kernel`` (:64),
``_estep`` (:69), ``_init_sigma2`` (:93), ``_affine_cpd_run`` (:120),
``low_rank_gaussian`` (:198), ``_deformable_cpd_run`` (:266, with
``estep_impl`` and ``landmarks``), ``lowrank_transform`` (:387) and the
cycpd-compatible classes ``affine_registration`` (:156) and
``deformable_registration`` (:439); and of ``gaussian_matvec_tiled``
(``pyfocusr_tpu/ops/pallas_kernels.py:236``).

Kept from the JAX version for f32 reasons:

* Householder QR (``torch.linalg.qr``) in the randomized subspace
  iteration; the Gram-based SVQB swap fails in f32 (``cpd.py:223-236``);
* the balanced eigenbasis M-step, (S C S + a_s2 I) z = S Q^T F, instead of
  the Woodbury form, which cancels in f32 (``cpd.py:278-296``).

Two E-steps.  The dense one (``estep_impl="dense"``) materializes P [M, N]
and leaves the product to ``torch.matmul``; the streamed one
(``estep_impl="streamed"``) is ``cpd_estep_kernel.estep_for``, the
hand-written CUDA kernel on a CUDA device and its plain tiled version on
the CPU, which never forms P.  The pipeline and the classes take the
streamed one when M N > 3000^2, the affine run included (the JAX affine
class is dense at every size).  Above 8192 control points the Gram of ``low_rank_gaussian``
is applied in row tiles and never formed either.

Both EM loops run on one driver, ``_em_loop``, whose state (the warp, sigma2,
the last change of sigma2, the iteration count and a stop flag) lives on
the device, as in the JAX ``while_loop``.  By default each iteration is
masked by the stop flag and the host reads the flag every ``EM_BLOCK``
iterations; on a CUDA device the iteration is captured once as a CUDA graph
and replayed.  ``loop="plain"`` is the sequential loop that reads the stop
test every iteration, the plain version the blocked loop equals bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import device_loop
from ..utils.device import resolve_device
from ..utils.precision import f32_matmuls
from . import cpd_estep_kernel
from .cpd_estep_kernel import outlier_constant
from .knn import pairwise_sq_dists

__all__ = [
    "affine_registration",
    "deformable_registration",
    "omega_draw",
    "gaussian_kernel",
    "gaussian_matvec_tiled",
    "low_rank_gaussian",
    "lowrank_transform",
]


def gaussian_kernel(a, b, beta):
    """G[i, j] = exp(-||a_i - b_j||^2 / (2 beta^2))."""
    return torch.exp(-pairwise_sq_dists(a, b) / (2.0 * beta**2))


@f32_matmuls
def gaussian_matvec_tiled(Y, beta, V, tile: int = 2048):
    """Z = G V with G = exp(-|y_i - y_j|^2 / 2 beta^2), in row tiles of
    ``tile`` so the [M, M] Gram never materializes.  The JAX function is an
    XLA function, not a Pallas kernel, so its port is plain torch: one
    [tile, M] slab (matmul identity, as ``gaussian_kernel``) per step."""
    return torch.cat([
        gaussian_kernel(Y[s : s + tile], Y, beta) @ V
        for s in range(0, Y.shape[0], tile)
    ])


def _estep(X, TY, sigma2, w):
    """Dense CPD E-step (P [M, N] materialized).  Returns (Pt1 [N], P1 [M],
    PX [M, D], Np, L)."""
    M = TY.shape[0]
    N, D = X.shape
    d2 = pairwise_sq_dists(TY, X)  # [M, N]
    P = torch.exp(-d2 / (2.0 * sigma2))
    c = outlier_constant(sigma2, w, D, M, N)
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


# Above this many points low_rank_gaussian applies the Gram in row tiles
# (cpd.py:212 of the JAX package).
_DENSE_GRAM_MAX_M = 8192


@f32_matmuls
def low_rank_gaussian(Y, beta, num_eig: int, omega):
    """Top-``num_eig`` eigenpairs of the M x M Gaussian Gram of Y by
    randomized subspace iteration from the caller's f32 [M, >= p] normal
    block ``omega`` (p = min(num_eig + 16, M)).  Returns (Q [M, k], lam [k])
    with G ~ Q diag(lam) Q^T; negative noise-floor estimates clamp to 0.
    Above 8192 points the Gram is applied by ``gaussian_matvec_tiled``."""
    M = Y.shape[0]
    if M <= _DENSE_GRAM_MAX_M:
        G = gaussian_kernel(Y, Y, beta)

        def gmat(V):
            return G @ V
    else:  # the [M, M] Gram is applied in row tiles, never formed
        def gmat(V):
            return gaussian_matvec_tiled(Y, beta, V)

    p = min(num_eig + 16, M)
    Qb, _ = torch.linalg.qr(gmat(omega[:, :p].to(Y.dtype)))
    for _ in range(2):  # subspace iterations sharpen the small eigenvalues
        Qb, _ = torch.linalg.qr(gmat(Qb))
    H = Qb.T @ gmat(Qb)
    H = 0.5 * (H + H.T)
    lam, S = torch.linalg.eigh(H)  # ascending
    lam = torch.flip(lam, dims=[0])[:num_eig]
    S = torch.flip(S, dims=[1])[:, :num_eig]
    return Qb @ S, torch.clamp(lam, min=0.0)


def _sqrt_lam_gated(lam, dtype):
    """sqrt(lam), zeroed below the f32 identifiability floor lam_0 * 2 eps."""
    eps2 = 2.0 * torch.finfo(dtype).eps
    return torch.where(lam > lam[0] * eps2, torch.sqrt(lam), torch.zeros_like(lam))


# EM iterations run between two host reads of the blocked loop's stop flag:
# on the card, replays of the captured iteration.  A run overshoots its
# convergence by at most K - 1 masked iterations, whose M-step ops still run
# (the streamed E-step kernels return at once on the flag): at K = 8 that is
# a few milliseconds beside the 50-300 iterations a run takes, while the
# host reads, each a wait for the device to drain, drop eightfold.
EM_BLOCK = 8

# What the last blocked EM loop did (``device_loop.reset_stats``):
# iterations, whether it ran as a CUDA graph, iterations run after the first
# (replays on the card), host reads of its flag, and host milliseconds spent
# capturing, replaying (launching the replays) and reading.
EM_STATS = {}


def _solve(A, B):
    """A^{-1} B for the M-step's small systems by LU, without the host check
    of the factorisation that ``torch.linalg.solve`` makes (a read of the
    device, which a CUDA graph cannot hold).  A singular A gives non-finite
    values, and the loop then stops on its NaN test, as JAX's does."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def _em_loop(update, state, max_iterations: int, tolerance: float,
             loop: str = "blocked") -> int:
    """Run EM on ``state`` (a dict of tensors, with the 0-d ``"sigma2"``)
    until |delta sigma2| <= tolerance or ``max_iterations``, JAX's
    ``while_loop`` condition.  ``update(state, done)`` returns the candidate
    values of one iteration (a dict of some of the keys, ``"sigma2"`` among
    them); ``done`` is an int32 device flag the E-step may skip on, or None.
    Returns the iteration count; ``state`` holds the final values.

    ``loop="plain"``: the sequential loop, one host read of the stop test
    per iteration.  ``loop="blocked"``: the iteration is masked (it keeps
    the old state where ``done`` is set, advances its count only while not
    done, and sets ``done = not (err > tol) or it >= max_iterations``, NaN
    included), all of it on the device, and ``utils/device_loop.run_blocked``
    reads the flag every ``EM_BLOCK`` iterations: on a CUDA device one
    iteration is captured as a CUDA graph and replayed (a failed capture
    raises), on the CPU the masked iteration runs eagerly.  Both loops give
    the same values bit for bit.  The E-step kernel's launches in the graph
    count in ``cpd_estep_kernel.LAUNCHES`` at each replay."""
    if loop not in ("blocked", "plain"):
        raise ValueError(f"loop must be 'blocked' or 'plain', got {loop!r}")
    sigma2 = state["sigma2"]
    if loop == "plain":
        it = 0
        err = torch.full_like(sigma2, float("inf"))
        while it < max_iterations and bool(err > tolerance):
            new = update(state, None)
            err = (new["sigma2"] - state["sigma2"]).abs()
            state.update(new)
            it += 1
        return it

    device_loop.reset_stats(EM_STATS, EM_BLOCK)
    if not (max_iterations > 0 and math.inf > tolerance):
        return 0
    err = torch.full_like(sigma2, float("inf"))
    ctrl = torch.zeros((2,), dtype=torch.int32, device=sigma2.device)  # it, done
    it_count, done_flag = ctrl[0], ctrl[1:]

    def step():
        done = done_flag[0] != 0
        new = update(state, done_flag)
        err_new = (new["sigma2"] - state["sigma2"]).abs()
        for key, val in new.items():
            state[key].copy_(torch.where(done, state[key], val))
        err.copy_(torch.where(done, err, err_new))
        it_count.add_((~done).to(torch.int32))
        done_flag.copy_(((~(err > tolerance)) | (it_count >= max_iterations))
                        .to(torch.int32).reshape(1))

    return device_loop.run_blocked(step, ctrl, max_iterations, EM_BLOCK, EM_STATS,
                                   kernels=(cpd_estep_kernel,), what="EM loop")


def _estep_for(X, M: int, w: float, estep_impl: str):
    """The E-step of one EM run as ``(TY, sigma2, done) -> (Pt1, P1, PX, Np,
    L)``: dense, or streamed (``cpd_estep_kernel.estep_for``)."""
    if estep_impl == "dense":
        return lambda TY, sigma2, done: _estep(X, TY, sigma2, w)
    if estep_impl == "streamed":
        return cpd_estep_kernel.estep_for(X, M, w)
    raise ValueError(f"estep_impl must be 'dense' or 'streamed', got {estep_impl!r}")


@f32_matmuls
def _affine_cpd_run(X, Y, max_iterations: int, tolerance: float, w: float = 0.0,
                    estep_impl: str = "dense", loop: str = "blocked"):
    """Affine CPD: moves Y onto X by TY = Y B^T + t.  Returns (TY, B, t,
    sigma2, iterations).  ``estep_impl`` as in ``_deformable_cpd_run`` (the
    JAX function has the dense one only); ``loop``: see ``_em_loop``."""
    N, D = X.shape
    estep = _estep_for(X, Y.shape[0], w, estep_impl)

    def update(state, done):
        B, t, sigma2 = state["B"], state["t"], state["sigma2"]
        TY = Y @ B.T + t[None, :]
        Pt1, P1, PX, Np, _ = estep(TY, sigma2, done)
        mu_x = (X.T @ Pt1) / Np
        mu_y = (Y.T @ P1) / Np
        Xh = X - mu_x[None, :]
        Yh = Y - mu_y[None, :]
        # A = Xh^T P^T Yh from PX, without a second pass over P.
        A = (PX - P1[:, None] * mu_x[None, :]).T @ Yh
        YPY = (Yh.T * P1[None, :]) @ Yh
        B_new = _solve(YPY.T, A.T).T.contiguous()
        t_new = mu_x - B_new @ mu_y
        xPx = torch.dot(Pt1, (Xh * Xh).sum(dim=1))
        trAB = torch.trace(A @ B_new.T)
        sigma2_new = torch.clamp((xPx - trAB) / (Np * D), min=tolerance / 10.0)
        return {"B": B_new, "t": t_new, "sigma2": sigma2_new}

    state = {"B": torch.eye(D, dtype=X.dtype, device=X.device),
             "t": torch.zeros((D,), dtype=X.dtype, device=X.device),
             "sigma2": _init_sigma2(X, Y)}
    it = _em_loop(update, state, max_iterations, tolerance, loop)
    B, t = state["B"], state["t"]
    return Y @ B.T + t[None, :], B, t, state["sigma2"], it


@f32_matmuls
def _deformable_cpd_run(X, Y, Q, lam, alpha: float, max_iterations: int,
                        tolerance: float, w: float = 0.0,
                        estep_impl: str = "dense", landmarks=None,
                        loop: str = "blocked"):
    """EM loop with the balanced low-rank M-step.  Moves Y onto X.
    Returns (TY, z, sigma2, iterations) with z the spectral warp
    coefficients (displacement at the control points = Q diag(sqrt lam) z).

    ``estep_impl``: "dense" (P materialized) or "streamed"
    (``cpd_estep_kernel.estep_for``: the CUDA kernel for CUDA tensors).
    ``landmarks``: optional (lm_idx int [L], lm_pos f32 [L, D], lm_w f32
    [L]) prior correspondences, Y[lm_idx[l]] pulled toward lm_pos[l] with
    pseudo-responsibility lm_w[l] (MAP CPD): the prior terms add to diag(P1)
    and PX in the M-step solve only; sigma2 stays data-driven.
    ``loop``: see ``_em_loop``."""
    N, D = X.shape
    M = Y.shape[0]
    k = lam.shape[0]
    sqrt_lam = _sqrt_lam_gated(lam, X.dtype)
    eye_k = torch.eye(k, dtype=X.dtype, device=X.device)
    xx = (X * X).sum(dim=1)

    def kernel_apply_z(z):
        return Q @ (sqrt_lam[:, None] * z)

    estep = _estep_for(X, M, w, estep_impl)

    lm_p1 = lm_px = None
    if landmarks is not None:
        lm_idx, lm_pos, lm_w = landmarks
        lm_idx = torch.as_tensor(lm_idx, device=X.device).long()
        lm_pos = torch.as_tensor(lm_pos, dtype=X.dtype, device=X.device)
        lm_w = torch.as_tensor(lm_w, dtype=X.dtype, device=X.device)
        lm_p1 = torch.zeros((M,), dtype=X.dtype, device=X.device).index_add_(
            0, lm_idx, lm_w)
        lm_px = torch.zeros((M, D), dtype=X.dtype, device=X.device).index_add_(
            0, lm_idx, lm_w[:, None] * lm_pos)

    def update(state, done):
        z, sigma2 = state["z"], state["sigma2"]
        TY = Y + kernel_apply_z(z)
        Pt1, P1, PX, Np, _ = estep(TY, sigma2, done)
        P1_solve, PX_solve = P1, PX
        if lm_p1 is not None:
            P1_solve, PX_solve = P1 + lm_p1, PX + lm_px
        a_s2 = alpha * sigma2
        F = PX_solve - P1_solve[:, None] * Y
        Ft = Q.T @ F
        C = Q.T @ (P1_solve[:, None] * Q)
        A = sqrt_lam[:, None] * C * sqrt_lam[None, :] + a_s2 * eye_k
        z_new = _solve(A, sqrt_lam[:, None] * Ft).contiguous()
        TY_new = Y + kernel_apply_z(z_new)
        xPx = torch.dot(Pt1, xx)
        yPy = torch.dot(P1, (TY_new * TY_new).sum(dim=1))
        trPXY = (TY_new * PX).sum()
        sigma2_new = torch.clamp(
            (xPx - 2.0 * trPXY + yPy) / (Np * D), min=tolerance / 10.0
        )
        return {"z": z_new, "sigma2": sigma2_new}

    state = {"z": torch.zeros((k, D), dtype=X.dtype, device=X.device),
             "sigma2": _init_sigma2(X, Y)}
    it = _em_loop(update, state, max_iterations, tolerance, loop)
    z = state["z"]
    return Y + kernel_apply_z(z), z, state["sigma2"], it


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


# Above this many E-step pairs the classes and the pipeline stream the E-step.
_STREAM_PAIRS = 3000 * 3000


def _estep_route(n_x: int, n_y: int, estep_impl) -> str:
    """The E-step a class run takes: ``estep_impl`` None picks 'streamed'
    (the CUDA kernel on the card, its plain tiled version on the CPU) above
    3000^2 pairs and 'dense' below."""
    if estep_impl is None:
        return "streamed" if n_x * n_y > _STREAM_PAIRS else "dense"
    return estep_impl


def _cloud(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a tensor on ``device``: when None, a tensor's own device,
    and the CUDA card for arrays (``utils.device.resolve_device``)."""
    if torch.is_tensor(x):
        return x.to(device=x.device if device is None else device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype,
                        device=resolve_device(None) if device is None else device)


def omega_draw(seed: int, M: int, p: int) -> np.ndarray:
    """The Gram subspace-iteration start of a ``deformable_registration``
    seeded ``seed``: f32 [M, p] standard normals (the JAX class draws them
    from ``PRNGKey(seed)``)."""
    return np.random.default_rng(seed).standard_normal((M, p)).astype(np.float32)


class affine_registration:
    """cycpd-compatible affine CPD moving Y onto X, on the device of X (see
    ``_cloud``)."""

    def __init__(self, X, Y, max_iterations=100, tolerance=1e-8, w=0.0, **_ignored):
        self.X = _cloud(X)
        self.Y = _cloud(Y, self.X.device)
        self.max_iterations = int(max_iterations)
        self.tolerance = float(tolerance)
        self.w = float(w)
        self.B = None
        self.t = None
        self.sigma2 = None
        self.iterations_run = None
        self.TY = None

    def register(self):
        TY, B, t, sigma2, it = _affine_cpd_run(
            self.X, self.Y, self.max_iterations, self.tolerance, self.w,
            estep_impl=_estep_route(self.X.shape[0], self.Y.shape[0], None),
        )
        self.TY, self.B, self.t = TY, B, t
        self.sigma2 = float(sigma2)
        self.iterations_run = int(it)
        return TY, self.get_registration_parameters()

    def get_registration_parameters(self):
        """pycpd's convention: the returned B right-multiplies Y (TY = Y B +
        t); the class keeps its transpose."""
        return {"B": self.B.T.cpu().numpy(), "t": self.t.cpu().numpy()}

    def transform_point_cloud(self, points):
        points = _cloud(points, self.X.device)
        return points @ self.B.T + self.t[None, :]


class deformable_registration:
    """cycpd-compatible low-rank deformable CPD moving Y onto X, on the
    device of X (see ``_cloud``).  The Gram's ``num_eig`` eigenpairs start
    from ``omega_draw(seed, M, num_eig + 16)``."""

    def __init__(
        self,
        X,
        Y,
        num_eig=100,
        max_iterations=1000,
        tolerance=1e-8,
        alpha=0.5,
        beta=3.0,
        w=0.0,
        verbose=False,
        seed=0,
        estep_impl=None,  # None: streamed above 3000^2 pairs, else dense
        landmarks=None,  # (Y_indices [L], fixed_positions [L, D], weights [L])
        **_ignored,
    ):
        self.X = _cloud(X)
        self.Y = _cloud(Y, self.X.device)
        self.num_eig = int(min(num_eig, self.Y.shape[0]))
        self.max_iterations = int(max_iterations)
        self.tolerance = float(tolerance)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.w = float(w)
        self.verbose = verbose
        self.seed = seed
        self.estep_impl = _estep_route(self.X.shape[0], self.Y.shape[0], estep_impl)
        if landmarks is not None:
            li, lp, lw = landmarks
            dev = self.X.device
            landmarks = (_cloud(li, dev, torch.int64), _cloud(lp, dev), _cloud(lw, dev))
        self.landmarks = landmarks
        self.z = None
        self.sigma2 = None
        self.iterations_run = None
        self.TY = None

    def register(self):
        M = self.Y.shape[0]
        p = min(self.num_eig + 16, M)
        omega = torch.tensor(omega_draw(self.seed, M, p), device=self.Y.device)
        self._Q, self._lam = low_rank_gaussian(self.Y, self.beta, self.num_eig, omega)
        TY, z, sigma2, it = _deformable_cpd_run(
            self.X, self.Y, self._Q, self._lam, self.alpha, self.max_iterations,
            self.tolerance, self.w, estep_impl=self.estep_impl,
            landmarks=self.landmarks,
        )
        self.TY, self.z = TY, z
        self.sigma2 = float(sigma2)
        self.iterations_run = int(it)
        if self.verbose:
            print(f"CPD deformable: {self.iterations_run} iterations, "
                  f"sigma2={self.sigma2:.3e}")
        return TY, self.get_registration_parameters()

    @property
    def W(self):
        """cycpd's kernel weights (displacement = G(., Y0) @ W), rebuilt from
        the balanced coefficients z; large for near-singular kernels, where
        ``transform_point_cloud`` is the stable evaluation."""
        if self.z is None:
            return None
        sqrt_lam = torch.sqrt(self._lam)
        safe = torch.clamp(sqrt_lam, min=torch.finfo(torch.float32).tiny)
        wt = torch.where(sqrt_lam[:, None] > 0, self.z / safe[:, None],
                         torch.zeros_like(self.z))
        return self._Q @ wt

    def get_registration_parameters(self):
        return {
            "W": self.W.cpu().numpy(),
            "z": self.z.cpu().numpy(),
            "beta": self.beta,
            "Y0": self.Y.cpu().numpy(),
        }

    def transform_point_cloud(self, points):
        """The fitted field applied out of sample (``lowrank_transform``)."""
        return lowrank_transform(_cloud(points, self.X.device), self.Y, self._Q,
                                 self._lam, self.z, self.beta)
