"""Plain reference of a registration's stages, in PyTorch, NumPy and SciPy.

Written from the algorithm's definition (the upstream FOCUSR pipeline as
the port states it: ICP by nearest neighbours and the Umeyama close, the
Laplacian L = D^-1 (D - W) with w_ij = 1 / |x_i - x_j|, the eigsort cost
c_spatial * c_lambda * c_hist with sign flips, low-rank deformable CPD with
the balanced M-step, nearest-neighbour or one-to-one correspondences, the
mean filter A = diag(1 / (1 + d)) (W + I), and k = 3 inverse-distance
locations).  It imports nothing of the program and takes nothing the
program made: every stage starts from the arrays it is handed.

Each torch stage runs in one of two arithmetics (:class:`Arith`):

* ``"ref"``: float64, the reference;
* ``"ctl"``: float32 with every matrix product's operands rounded to TF32
  (10 mantissa bits, what the tensor cores read when TF32 is on), the
  control: the nearest precision below the float32 with TF32 off that the
  configuration states.  The rounding is done here, so the control reads
  the same on the card and on the CPU.

The eigenpairs come from ARPACK (shift-invert, float64, host); the control's
eigen stage is their Rayleigh-Ritz on the card in its arithmetic.  The
k x k eigsort assignment is enumerated; the N x N one is SciPy's
``linear_sum_assignment``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from scipy import sparse
from scipy.optimize import linear_sum_assignment
from scipy.sparse.linalg import eigsh

F32_EPS = float(np.finfo(np.float32).eps)
DEGREE_EPS = 1e-8
# Rows of a [rows, N] distance block.
_BLOCK_ELEMS = 1 << 25


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    i = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    i = ((i + 0xFFF + ((i >> 13) & 1)) & 0xFFFFE000) & 0xFFFFFFFF
    i = torch.where(i >= 2**31, i - 2**32, i)
    return i.to(torch.int32).view(torch.float32)


class Arith:
    """The arithmetic a stage runs in: dtype, device and matrix products."""

    def __init__(self, mode: str, device):
        if mode not in ("ref", "ctl"):
            raise ValueError(f"mode must be 'ref' or 'ctl', got {mode!r}")
        self.mode = mode
        self.device = torch.device(device)
        self.dtype = torch.float64 if mode == "ref" else torch.float32

    def t(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return tf32(x) if self.mode == "ctl" else x

    def mm(self, a, b):
        return self.r(a) @ self.r(b)

    def sqdist(self, a, b):
        """[Na, Nb] squared distances by the matrix-product identity."""
        an = (a * a).sum(dim=1, keepdim=True)
        bn = (b * b).sum(dim=1, keepdim=True)
        return torch.clamp(an + bn.T - 2.0 * self.mm(a, b.T), min=0.0)

    def knn(self, ref, query, k: int):
        """(squared distances, indices) of the k nearest ``ref`` rows of each
        ``query`` row, by :meth:`sqdist` in row blocks."""
        rows = max(1, _BLOCK_ELEMS // max(ref.shape[0], 1))
        ds, ix = [], []
        for s in range(0, query.shape[0], rows):
            d2 = self.sqdist(query[s:s + rows], ref)
            v, i = torch.topk(d2, k, dim=1, largest=False)
            ds.append(v)
            ix.append(i)
        return torch.cat(ds), torch.cat(ix)


def set_full_f32():
    """TF32 off for float32 matrix products: the control rounds its own."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# --------------------------------------------------------------------------
# Mesh operators
# --------------------------------------------------------------------------


class MeshOps:
    """The graph of one triangle mesh in float64: the symmetric edge weights
    w_ij = 1 / |x_i - x_j|, degrees d, the symmetric Laplacian
    A = S (D - W) S with s = (d + 1e-8)^-1/2 (scipy CSR), and the same W
    as an ELL table (neighbours padded with the vertex itself at weight 0)
    for the torch stages."""

    def __init__(self, points, triangles):
        p = np.asarray(points, np.float64)
        t = np.asarray(triangles, np.int64)
        n = p.shape[0]
        e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        e = np.concatenate([e, e[:, ::-1]])
        key = np.unique(e[:, 0] * n + e[:, 1])
        i, j = key // n, key % n
        w = 1.0 / np.linalg.norm(p[i] - p[j], axis=1)
        self.n = n
        self.W = sparse.csr_matrix((w, (i, j)), shape=(n, n))
        self.d = np.asarray(self.W.sum(axis=1)).ravel()
        self.s = (self.d + DEGREE_EPS) ** -0.5
        S = sparse.diags(self.s)
        self.A = (S @ (sparse.diags(self.d) - self.W) @ S).tocsr()
        deg = np.bincount(i, minlength=n)
        width = int(deg.max())
        slot = np.arange(i.shape[0]) - np.repeat(np.cumsum(deg) - deg, deg)
        self.nbr = np.tile(np.arange(n)[:, None], (1, width))
        self.nbr[i, slot] = j
        self.w_ell = np.zeros((n, width))
        self.w_ell[i, slot] = w

    def torch_ell(self, ar: Arith):
        return (torch.as_tensor(self.nbr, device=ar.device), ar.t(self.w_ell), ar.t(self.d))


def spectrum(mops: MeshOps, k: int):
    """The k smallest nonzero eigenvalues of the generalized problem
    (D - W) v = lambda (D + 1e-8) v and their vectors a of the symmetric
    form (v = s a), ascending: ARPACK shift-invert about -1e-6 (A is
    positive semi-definite with the constants' direction as its kernel),
    float64."""
    vals, vecs = eigsh(mops.A, k=k + 1, sigma=-1e-6, which="LM")
    order = np.argsort(vals)
    vals, vecs = vals[order], vecs[:, order]
    if not abs(vals[0]) < 1e-9 * max(abs(vals[1]), 1e-30):
        raise RuntimeError(f"the Laplacian's kernel was not found: {vals[:2]}")
    return vals[1:], vecs[:, 1:]


def minmax_normalize(v):
    """Each column mapped onto [-0.5, 0.5] (torch or numpy)."""
    mn, mx = v.min(0), v.max(0)
    if torch.is_tensor(v):
        mn, mx = mn.values, mx.values
    return (v - mn) / (mx - mn) - 0.5


def ritz(ar: Arith, mops: MeshOps, a):
    """Rayleigh-Ritz of the symmetric-form vectors ``a`` [N, k] (float64
    numpy) with the Laplacian applied in ``ar``: (eigenvalues [k],
    generalized eigenvectors min-max normalized [N, k]), in ``ar``'s dtype.
    In float64 on ARPACK's vectors it returns them unchanged."""
    nbr, w, d = mops.torch_ell(ar)
    s = (d + DEGREE_EPS) ** -0.5
    V = ar.t(a)
    x = s[:, None] * V
    lx = d[:, None] * x - torch.einsum("nd,ndc->nc", ar.r(w), ar.r(x[nbr]))
    AV = s[:, None] * lx
    H = ar.mm(V.T, AV)
    G = ar.mm(V.T, V)
    H = 0.5 * (H + H.T)
    Lg = torch.linalg.cholesky(0.5 * (G + G.T))
    Li = torch.linalg.inv(Lg)
    lam, Y = torch.linalg.eigh(Li @ H @ Li.T)
    vecs = ar.mm(V, Li.T @ Y)
    return lam, minmax_normalize(s[:, None] * vecs)


# --------------------------------------------------------------------------
# ICP (rigid): the port's semantics, pyfocusr_tpu_torch/ops/icp.py
# --------------------------------------------------------------------------


def _close(ar: Arith, cov, var_s, mu_s, mu_d):
    """Rigid Umeyama close of the cross-covariance: (R, t)."""
    U, _, Vh = torch.linalg.svd(cov)
    sgn = torch.sign(torch.det(U) * torch.det(Vh))
    D = torch.diag(torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn]))
    R = ar.mm(ar.mm(U, D), Vh)
    return R, mu_d - ar.mm(R, mu_s[:, None])[:, 0]


def icp(ar: Arith, source_points, target_points, landmarks, max_iterations: int):
    """Rigid ICP of the ``landmarks`` rows of the source onto the target,
    then the whole source moved: each iteration matches every moved landmark
    to its nearest target vertex and sets (R, t) by the Umeyama close of the
    unmoved landmarks onto their matches; it starts by matching centroids
    and stops once the mean motion of the landmarks is <= 1e-5 (max |target
    coordinate| + 1), or after ``max_iterations``.  Returns the moved source
    [N, 3] in ``ar``'s dtype."""
    src_all = ar.t(source_points)
    tgt = ar.t(target_points)
    src = src_all[torch.as_tensor(np.asarray(landmarks), device=ar.device)]
    n = src.shape[0]
    threshold = 1e-5 * (tgt.abs().max() + 1.0)
    mu_s = src.mean(dim=0)
    sc = src - mu_s
    var_s = (sc * sc).sum(dim=1).mean()
    t = tgt.mean(dim=0) - mu_s
    R = torch.eye(3, dtype=ar.dtype, device=ar.device)
    moved = src + t
    for _ in range(max_iterations):
        _, idx = ar.knn(tgt, moved, 1)
        matched = tgt[idx[:, 0]]
        mu_d = matched.mean(dim=0)
        cov = ar.mm((matched - mu_d).T, sc) / n
        R, t = _close(ar, cov, var_s, mu_s, mu_d)
        new = ar.mm(src, R.T) + t
        delta = torch.linalg.norm(new - moved, dim=1).mean()
        moved = new
        if not bool(delta > threshold):
            break
    return ar.mm(src_all, R.T) + t


def icp_step(ar: Arith, source_points, target_points, landmarks, moved_source):
    """One ICP iteration from a given pose: the moved landmarks' nearest
    target vertices and the Umeyama close of the unmoved landmarks onto
    them.  Returns the landmarks' mean motion over ICP's stop threshold
    1e-5 (max |target coordinate| + 1): at most 1 where the iteration has
    converged."""
    src_all = ar.t(source_points)
    tgt = ar.t(target_points)
    lm = torch.as_tensor(np.asarray(landmarks), device=ar.device)
    src, moved = src_all[lm], ar.t(moved_source)[lm]
    mu_s = src.mean(dim=0)
    sc = src - mu_s
    _, idx = ar.knn(tgt, moved, 1)
    matched = tgt[idx[:, 0]]
    mu_d = matched.mean(dim=0)
    cov = ar.mm((matched - mu_d).T, sc) / src.shape[0]
    R, t = _close(ar, cov, (sc * sc).sum(dim=1).mean(), mu_s, mu_d)
    motion = torch.linalg.norm(ar.mm(src, R.T) + t - moved, dim=1).mean()
    return float(motion / (1e-5 * (tgt.abs().max() + 1.0)))


# --------------------------------------------------------------------------
# eigsort: the port's semantics, pyfocusr_tpu_torch/spectral/eigsort_device.py
# --------------------------------------------------------------------------


def eigsort(ar: Arith, lam_t, lam_s, vt, vs, pt, ps, vs_full):
    """Sort and sign-flip the source eigenvectors into the target's modes.

    ``lam_*`` [k]; ``vt``, ``vs`` [n, k]: the sampled rows of the target's
    and the source's normalized eigenvectors (source in ascending eigenvalue
    order); ``pt``, ``ps`` [n, 3]: the sampled points, each set scaled to
    [0, 1] per axis; ``vs_full`` [Ns, k]: every source row.  The cost of
    target mode i against source mode j is c_spatial * c_lambda * c_hist,
    straight or flipped: c_lambda = exp(min((l_i - l_j)^2 / 2 gap^2, 80)),
    gap the mean step of the two spectra; c_hist the W1 distance of the
    log(v + 0.5 + eps) samples; c_spatial the root sum of squares of target
    minus (or plus) the source values at each target sample's nearest source
    sample, over n.  Returns (sorted source vectors [Ns, k], Q [k])."""
    k = lam_t.shape[0]
    lam_t, lam_s, vt, vs, pt, ps = (ar.t(x) for x in (lam_t, lam_s, vt, vs, pt, ps))
    eps = F32_EPS

    def gap_of(v):
        return torch.diff(v).mean() if v.shape[0] > 1 else torch.zeros_like(v[0])

    gap = (gap_of(lam_t) + gap_of(lam_s)) / 2
    gap = torch.where(gap > 0, gap, torch.ones_like(gap))
    c_lambda = torch.exp(torch.clamp((lam_t[:, None] - lam_s[None, :]) ** 2
                                     / (2.0 * gap ** 2), max=80.0))

    def logs(x):
        return torch.sort(torch.log(torch.clamp(x + 0.5 + eps, min=eps)), dim=0).values

    lt, ls, lsf = logs(vt), logs(vs), logs(-vs)
    if lt.shape[0] != ls.shape[0]:
        raise ValueError("eigsort samples of unequal sizes are not covered here")
    c_hist = (lt[:, :, None] - ls[:, None, :]).abs().mean(dim=0)
    c_hist_f = (lt[:, :, None] - lsf[:, None, :]).abs().mean(dim=0)

    _, nn = ar.knn(ps, pt, 1)
    g = vs[nn[:, 0]]
    n_t = vt.shape[0]
    tt = (vt * vt).sum(dim=0)
    gg = (g * g).sum(dim=0)
    tg = ar.mm(vt.T, g)
    c_spatial = torch.sqrt(torch.clamp(tt[:, None] + gg[None, :] - 2.0 * tg, min=0.0)) / n_t
    c_spatial_f = torch.sqrt(torch.clamp(tt[:, None] + gg[None, :] + 2.0 * tg, min=0.0)) / n_t
    c = c_spatial * c_lambda * c_hist
    c_f = c_spatial_f * c_lambda * c_hist_f
    Q = torch.minimum(c, c_f).cpu().numpy()
    flip = (c > c_f).cpu().numpy()
    best, src_of_tgt = None, None
    for perm in itertools.permutations(range(k)):
        total = Q[np.arange(k), perm].sum()
        if best is None or total < best:
            best, src_of_tgt = total, np.array(perm)
    sign = np.ones(k)
    sign[src_of_tgt] = np.where(flip[np.arange(k), src_of_tgt], -1.0, 1.0)
    vs_full = np.asarray(vs_full, np.float64)
    return (vs_full * sign[None, :])[:, src_of_tgt], Q[np.arange(k), src_of_tgt]


def unit_box(points):
    """Points shifted and scaled to [0, 1] per axis."""
    p = np.asarray(points, np.float64)
    mn = p.min(axis=0)
    return (p - mn) / np.maximum(p.max(axis=0) - mn, 1e-30)


# --------------------------------------------------------------------------
# Low-rank deformable CPD: the port's semantics, pyfocusr_tpu_torch/ops/cpd.py
# --------------------------------------------------------------------------


def cpd_em(ar: Arith, X, Y, alpha: float, beta: float, num_eig: int,
           max_iterations: int, tolerance: float, run_out: bool = False):
    """Deformable CPD moving Y [M, D] onto X [N, D] (no outliers).

    The Gram G = exp(-|y_i - y_j|^2 / 2 beta^2) is replaced by its top
    ``num_eig`` eigenpairs, the modes under lam_0 * 2 eps(float32) (the
    configuration's identifiability floor) dropped; the warp of Y is
    Q diag(sqrt lam) z.  Each EM iteration: P = exp(-|TY_m - x_n|^2 /
    2 sigma2) normalised over m; the balanced M-step
    (sqrt lam C sqrt lam + alpha sigma2 I) z = sqrt lam Q^T (PX - P1 Y),
    C = Q^T diag(P1) Q; sigma2 = (x^T P^T 1 x - 2 tr(PX TY^T) + y^T P1 y) /
    (Np D), at least tolerance / 10.  It stops once |delta sigma2| <=
    ``tolerance`` or after ``max_iterations`` (with ``run_out``, it runs to
    ``max_iterations`` all the same); sigma2 starts at the mean squared
    distance over D.

    Returns (Q, sqrt lam gated, [z after each iteration], [|delta sigma2|
    of each iteration], the iteration it stops at)."""
    X, Y = ar.t(X), ar.t(Y)
    N, D = X.shape
    M = Y.shape[0]
    G = torch.exp(-ar.sqdist(Y, Y) / (2.0 * beta ** 2))
    lam, Qm = torch.linalg.eigh(0.5 * (G + G.T))
    lam = torch.flip(lam, dims=[0])[:num_eig]
    Qm = torch.flip(Qm, dims=[1])[:, :num_eig]
    keep = lam > lam[0] * 2.0 * F32_EPS
    sl = torch.where(keep, torch.sqrt(torch.clamp(lam, min=0.0)), torch.zeros_like(lam))
    xx = (X * X).sum(dim=1)
    sigma2 = ar.sqdist(Y, X).sum() / (D * M * N)
    z = torch.zeros((num_eig, D), dtype=ar.dtype, device=ar.device)
    eye = torch.eye(num_eig, dtype=ar.dtype, device=ar.device)
    zs, dsig, stop = [], [], None
    for it in range(1, max_iterations + 1):
        TY = Y + ar.mm(Qm, sl[:, None] * z)
        P = torch.exp(-ar.sqdist(TY, X) / (2.0 * sigma2))
        P = P / torch.clamp(P.sum(dim=0, keepdim=True), min=1e-30)
        Pt1, P1 = P.sum(dim=0), P.sum(dim=1)
        PX = ar.mm(P, X)
        Np = P1.sum()
        F = PX - P1[:, None] * Y
        C = ar.mm(Qm.T, P1[:, None] * Qm)
        A = sl[:, None] * C * sl[None, :] + alpha * sigma2 * eye
        z = torch.linalg.solve(A, sl[:, None] * ar.mm(Qm.T, F))
        TY = Y + ar.mm(Qm, sl[:, None] * z)
        new = torch.clamp((Pt1 @ xx - 2.0 * (TY * PX).sum() + P1 @ (TY * TY).sum(dim=1))
                          / (Np * D), min=tolerance / 10.0)
        err = float((new - sigma2).abs())
        sigma2 = new
        zs.append(z)
        dsig.append(err)
        if stop is None and not err > tolerance:
            stop = it
            if not run_out:
                break
    return Qm, sl, zs, dsig, stop if stop is not None else max_iterations


def cpd_basis(ar: Arith, points, Y, Qm, beta: float):
    """G(points, Y) Q [P, num_eig]: the warp's basis at ``points``."""
    P_all, Y = ar.t(points), ar.t(Y)
    rows = max(1, _BLOCK_ELEMS // Y.shape[0])
    return torch.cat([ar.mm(torch.exp(-ar.sqdist(P_all[s:s + rows], Y) / (2.0 * beta ** 2)), Qm)
                      for s in range(0, P_all.shape[0], rows)])


def cpd_warp(ar: Arith, points, basis, sl, z):
    """The fitted warp of ``points``: p + G(p, Y) Q diag(1 / sqrt lam) z,
    ``basis`` from :func:`cpd_basis`."""
    safe = torch.clamp(sl, min=torch.finfo(ar.dtype).tiny)
    wt = torch.where(sl[:, None] > 0, z / safe[:, None], torch.zeros_like(z))
    return ar.t(points) + ar.mm(basis, wt)


def cpd(ar: Arith, X, Y, points, alpha: float, beta: float, num_eig: int,
        max_iterations: int, tolerance: float):
    """:func:`cpd_em` to its stop, then its warp of ``points``."""
    Qm, sl, zs, _, stop = cpd_em(ar, X, Y, alpha, beta, num_eig, max_iterations, tolerance)
    return cpd_warp(ar, points, cpd_basis(ar, points, Y, Qm, beta), sl, zs[stop - 1])


# --------------------------------------------------------------------------
# Correspondences, smoothing, final locations
# --------------------------------------------------------------------------


def nearest(ar: Arith, ref, query):
    """Index of the nearest ``ref`` row of each ``query`` row."""
    return ar.knn(ar.t(ref), ar.t(query), 1)[1][:, 0]


def assignment(ar: Arith, ref, query):
    """One-to-one correspondences: the ``ref`` row assigned to each
    ``query`` row by the exact assignment on Euclidean distances computed in
    ``ar`` (SciPy's solver on those costs)."""
    cost = torch.sqrt(ar.sqdist(ar.t(query), ar.t(ref))).cpu().numpy().astype(np.float64)
    rows, cols = linear_sum_assignment(cost)
    out = np.empty(cost.shape[0], np.int64)
    out[rows] = cols
    return out


def mean_filter(ar: Arith, mops: MeshOps, values, iterations: int):
    """x <- diag(1 / (1 + d)) (W + I) x, ``iterations`` times."""
    nbr, w, d = mops.torch_ell(ar)
    x = ar.t(values)
    inv = 1.0 / (1.0 + d)
    wr = ar.r(w)
    for _ in range(iterations):
        x = inv[:, None] * (torch.einsum("nd,ndc->nc", wr, ar.r(x[nbr])) + x)
    return x


def knn3_idw(ar: Arith, ref_positions, ref_values, query):
    """k = 3 inverse-distance locations: the nearest ``ref_positions`` rows
    of each query, their ``ref_values`` weighted by 1 / distance (an exact
    hit taken as it is).  Returns (nearest index [Nq], locations [Nq, D])."""
    d2, idx = ar.knn(ar.t(ref_positions), ar.t(query), 3)
    d = torch.sqrt(d2)
    vals = ar.t(ref_values)[idx]
    w = 1.0 / torch.clamp(d, min=1e-30)
    out = (vals * w[:, :, None]).sum(dim=1) / w.sum(dim=1, keepdim=True)
    exact = d[:, 0] <= 0.0
    out = torch.where(exact[:, None], vals[:, 0], out)
    return idx[:, 0], out
