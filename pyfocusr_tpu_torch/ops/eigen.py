"""Smallest nonzero eigenpairs of the graph Laplacian: the wide-block and
the narrow Chebyshev-filtered subspace iterations, and deflated shift-invert
Lanczos.

Counterpart of ``pyfocusr_tpu/ops/eigen.py``: ``_project_out`` (:58),
``_cg_solve`` (:71), ``_estimate_lambda_max`` (:106),
``lanczos_shift_invert`` (:123), ``chebyshev_eigpairs_wide`` (:260, with
the warm start ``x0``, ``return_block`` and the residual-gated
``extra_chunks`` top-up, :425-454), ``chebyshev_eigpairs`` (:482, with its
fused ``filter_op_factory`` and its union-graph mode ``partition_masks``,
:508-516 and :723-737, which ``experiments.spectrum_union`` runs) and
``smallest_nonzero_eigpairs`` (:740).

Every solver works on the symmetrized A = S (D - W) S with the kernel (one
indicator per connected component, scaled by 1/s) deflated exactly;
``matvec`` applies A to an [N, C] block.  The wide solver's chunk applies a
degree-``chunk_degree`` Chebyshev filter to a 128-wide block,
re-orthonormalizes it by SVQB (eigh of the [b, b] Gram with a rank floor)
and runs Rayleigh-Ritz.  Its filter is the caller's (``filter_op_factory``),
which gives a chunk's whole recurrence where JAX's gives a step op:
``pipeline._spectrum`` passes the ELL factory, whose chunk runs
``ops/cheb_step_kernel.chebyshev_ell`` (on CUDA tensors one kernel launch a
step: the sparse product and the three-term recurrence).  The narrow
solver filters a [N, k + 8] block, takes Householder QR, and polishes
with one block shift-invert step (batched CG); Lanczos runs ~4k + 8 steps
on (A + sigma I)^-1, each a fixed-count CG solve.  The small dense
products, QR and ``eigh`` go to ``torch.matmul`` / ``torch.linalg``.  The
loops of the JAX ``fori_loop`` / ``while_loop`` are
Python loops over device tensors that read nothing back: CG freezes a
converged column by ``torch.where``, as JAX's ``live`` mask does.

Randomness is an input: the JAX package draws the start vectors from its
key inside the solver (``key``, ``fold_in(key, 7)`` and ``fold_in(key,
1)``); here the caller passes them (``init_block``, ``power_vec``,
``start_vec``), so both packages can start from the same draws.  Only the
wide solver's SVQB refill noise, drawn when the filter collapses the block
below the rank floor, comes from ``generator``.
"""

from __future__ import annotations

import collections

import torch

from ..utils import spans
from ..utils.precision import f32_matmuls

__all__ = [
    "chebyshev_eigpairs",
    "chebyshev_eigpairs_wide",
    "lanczos_shift_invert",
    "narrow_or_lanczos",
    "smallest_nonzero_eigpairs",
    "SOLVES",
]

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


def _unit_null(null_vec):
    """The kernel basis with unit columns (all-zero columns stay zero)."""
    if null_vec.dim() == 1:
        return null_vec / null_vec.norm()
    return null_vec / torch.clamp(null_vec.norm(dim=0, keepdim=True), min=1e-30)


def _cg_solve(matvec, b, iters: int, v0):
    """Fixed-iteration CG for A x = b inside the complement of v0, one
    column of b [N, C] per system.  The residual is re-projected every step
    against f32 null-space drift, and a column freezes once its residual
    falls to 1e-12 of its start: f32 CG run past convergence amplifies its
    rounding noise."""
    b = _project_out(v0, b)
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = (r * r).sum(dim=0)
    rs0 = rs
    zero = torch.zeros_like(rs)
    for _ in range(iters):
        live = rs > 1e-12 * rs0
        ap = _project_out(v0, matvec(p))
        denom = (p * ap).sum(dim=0)
        alpha = torch.where(live, rs / torch.where(denom > 0, denom, 1.0), zero)
        x = x + alpha[None, :] * p
        r = _project_out(v0, r - alpha[None, :] * ap)
        rs_new = (r * r).sum(dim=0)
        beta = torch.where(live, rs_new / torch.where(rs > 0, rs, 1.0), zero)
        p = r + beta[None, :] * p
        rs = rs_new
    return x


def _estimate_lambda_max(matvec, v, iters: int = 30, subspace_mask=None):
    """Power-iteration estimate of ||A||_2 from the start vector v [N]
    (JAX draws it from its key)."""
    v = v.to(torch.float32)
    if subspace_mask is not None:
        v = v * subspace_mask
    v = (v / v.norm())[:, None]
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.clamp(w.norm(), min=1e-30)
    return (v * matvec(v)).sum()


@f32_matmuls
def lanczos_shift_invert(matvec, null_vec: torch.Tensor, k: int,
                         power_vec: torch.Tensor, start_vec: torch.Tensor,
                         lanczos_iters: int = 0, cg_iters: int = 300,
                         sigma_rel: float = 2e-3, refine_steps: int = 1,
                         subspace_mask=None):
    """The k smallest nonzero eigenpairs of the symmetric PSD operator
    ``matvec``: Lanczos with full reorthogonalization on
    B = (A + sigma I)^-1 restricted to span{null_vec}^perp (B applied by
    ``cg_iters`` CG iterations), Rayleigh-Ritz on the tridiagonal,
    ``refine_steps`` block inverse-iteration steps, and Rayleigh quotients
    on A.  sigma = ``sigma_rel`` times the power-iteration estimate of
    lambda_max from ``power_vec`` [N]; the Lanczos run starts from
    ``start_vec`` [N] (JAX: normals from ``key`` and ``fold_in(key, 1)``).
    ``lanczos_iters`` = 0 takes max(4k + 8, 32) steps.

    Returns (eigvals ascending [k], eigvecs [N, k], residual norms [k])."""
    n = null_vec.shape[0]
    device = null_vec.device
    m = lanczos_iters if lanczos_iters > 0 else max(4 * k + 8, 32)
    v0 = _unit_null(null_vec)
    sigma = sigma_rel * _estimate_lambda_max(matvec, power_vec, subspace_mask=subspace_mask)

    def shifted(X):
        return matvec(X) + sigma * (X if subspace_mask is None else X * subspace_mask[:, None])

    def apply_b(X):
        return _cg_solve(shifted, X, cg_iters, v0)

    q = start_vec.to(torch.float32)
    if subspace_mask is not None:
        q = q * subspace_mask
    q = _project_out(v0, q[:, None])[:, 0]
    q = q / q.norm()
    V = torch.zeros((m, n), dtype=torch.float32, device=device)
    alphas = torch.zeros((m,), dtype=torch.float32, device=device)
    betas = torch.zeros((m,), dtype=torch.float32, device=device)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros((), dtype=torch.float32, device=device)
    for j in range(m):
        V[j] = q
        w = apply_b(q[:, None])[:, 0]
        alpha = torch.dot(q, w)
        w = w - alpha * q - beta_prev * q_prev
        # Full reorthogonalization against the vectors so far, twice for f32.
        for _ in range(2):
            w = w - V[: j + 1].T @ (V[: j + 1] @ w)
        w = _project_out(v0, w[:, None])[:, 0]
        beta = w.norm()
        alphas[j] = alpha
        betas[j] = beta
        q_prev, q, beta_prev = q, w / torch.clamp(beta, min=1e-30), beta

    T = (torch.diag(alphas) + torch.diag(betas[: m - 1], 1)
         + torch.diag(betas[: m - 1], -1))
    with spans.host_read("eigh"):
        theta, Y = torch.linalg.eigh(T)  # ascending
    idx = torch.argsort(-theta)[:k]  # largest of B = smallest of A
    ritz = _project_out(v0, V.T @ Y[:, idx])
    ritz = ritz / ritz.norm(dim=0, keepdim=True)
    for _ in range(refine_steps):
        Q, _ = torch.linalg.qr(_project_out(v0, apply_b(ritz)))
        H = Q.T @ matvec(Q)
        with spans.host_read("eigh"):
            _, S = torch.linalg.eigh(0.5 * (H + H.T))
        ritz = Q @ S
        ritz = ritz / ritz.norm(dim=0, keepdim=True)
    Av = matvec(ritz)
    lams = (ritz * Av).sum(dim=0)
    resid = (Av - ritz * lams[None, :]).norm(dim=0)
    order = torch.argsort(lams)
    return lams[order], ritz[:, order], resid[order]


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
    Gershgorin bound).  ``filter_op_factory(c, e)`` returns a chunk
    ``(X, deg) -> t_deg``, the degree-``deg`` Chebyshev recurrence from X on
    the filter step T -> (2/e)(A T - c T), t_1 = 0.5 step(X) (JAX's factory
    returns the step, and its solver runs the recurrence; here the factory
    runs it, so that a chunk can be one fused kernel a step, as
    ``pipeline.ell_filter_factory``'s is); ``quad_form(V) -> [k]`` gives the
    cancellation-free final Rayleigh quotients.  (The JAX version's
    power-iteration bound and its filter built from ``matvec`` when no
    factory is given have no caller of the wide solver, in either package,
    and are not ported here; the narrow solver, :func:`chebyshev_eigpairs`,
    has both.)  ``init_block`` f32 [N, >= b]: the random starting block
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
    v0 = _unit_null(null_vec)
    n_null = 1 if null_vec.dim() == 1 else null_vec.shape[1]
    b = min(block_width, max(n - n_null - 1, k + 2))
    cut = min(cut_index, max(b - 4, k))

    lam_max = torch.as_tensor(lam_max_bound, dtype=torch.float32,
                              device=device) * 1.005

    def cheb_filter(X, a, deg):
        c = (lam_max + a) / 2.0
        e = (lam_max - a) / 2.0
        return filter_op_factory(c, e)(X, deg)

    def svqb_rr(Y):
        """Rank-robust orthonormalization + Rayleigh-Ritz -> (X, theta).
        Gram directions below the rank floor are refilled with projected
        noise (filtered restarts) rather than zeroed, which would surface
        as spurious theta = 0 modes."""
        Y = Y / torch.clamp(Y.norm(dim=0, keepdim=True), min=1e-30)
        G = Y.T @ Y
        with spans.host_read("eigh"):
            e, U = torch.linalg.eigh(G)
        floor = e[-1] * 1e-10
        valid = e > floor
        inv = torch.where(
            valid, 1.0 / torch.sqrt(torch.maximum(e, floor)), torch.zeros_like(e)
        )
        Q = Y @ (U * inv[None, :])
        all_valid = valid.all()
        with spans.host_read("svqb_rank"):
            all_valid = bool(all_valid)
        if not all_valid:
            noise = _randn(Q.shape, generator, device)
            if subspace_mask is not None:
                noise = noise * subspace_mask[:, None]
            noise = _project_out(v0, noise)
            noise = noise / torch.clamp(noise.norm(dim=0, keepdim=True), min=1e-30)
            Q = torch.where(valid[None, :], Q, noise)
        H = Q.T @ matvec(Q)
        H = 0.5 * (H + H.T)
        with spans.host_read("eigh"):
            theta, S = torch.linalg.eigh(H)
        return Q @ S, theta

    def next_cut(theta):
        return torch.clamp(1.5 * theta[cut], lam_max * 1e-5, lam_max * 2e-2)

    def chunk(X, a):
        """One chunk: the filter, then SVQB and Rayleigh-Ritz."""
        with spans.span("spectra/chunk"):
            with spans.span("spectra/filter"):
                X = _project_out(v0, cheb_filter(X, a, chunk_degree))
            with spans.span("spectra/svqb_rr"):
                X, theta = svqb_rr(X)
            return X, next_cut(theta)

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
        X, a = chunk(X, a)

    def wanted_resid(Xc):
        V = Xc[:, :k]
        V = V / torch.clamp(V.norm(dim=0, keepdim=True), min=1e-30)
        Av = matvec(V)
        th = (V * Av).sum(dim=0)
        return (Av - V * th[None, :]).norm(dim=0).max()

    done = 0
    while done < extra_chunks:
        with spans.span("spectra/top_up_gate"):
            more = wanted_resid(X) > extra_resid_tol * lam_max
            with spans.host_read("top_up_gate"):
                more = bool(more)
        if not more:
            break
        X, a = chunk(X, a)
        done += 1

    SOLVES.append({"n": n, "warm": x0 is not None, "chunks": chunks + done,
                   "top_up_chunks": done})
    spans.solve(n, x0 is not None, chunks + done, done)
    V = X[:, :k]
    V = V / V.norm(dim=0, keepdim=True)
    Av = matvec(V)
    resid = (Av - V * (V * Av).sum(dim=0)[None, :]).norm(dim=0)
    lams = quad_form(V)
    if return_block:
        return lams, V, resid, X
    return lams, V, resid


@f32_matmuls
def chebyshev_eigpairs(matvec, null_vec: torch.Tensor, k: int,
                       init_block: torch.Tensor, block_extra: int = 8,
                       degree: int = 75, sweeps: int = 6,
                       refine_cg_iters: int = 150, subspace_mask=None,
                       lam_max_bound=None, power_vec: torch.Tensor = None,
                       resid_tol: float = 0.0, quad_form=None,
                       partition_masks=None, filter_op_factory=None):
    """The k smallest nonzero eigenpairs of the symmetric PSD operator
    ``matvec`` by Chebyshev-filtered subspace iteration on a narrow block of
    b = k_tot + ``block_extra`` columns, then one block shift-invert polish
    (k_tot = k, or k P in the union-graph mode below).

    ``init_block`` f32 [N, >= b]: the random start (its first b columns;
    JAX: normals from ``key``).  ``lam_max_bound``: an upper bound of A's
    spectrum; without it the bound is 1.3 times the power-iteration
    estimate from ``power_vec`` [N] (JAX: ``fold_in(key, 7)``).  The first
    sweep runs at 40% of ``degree``, then ``sweeps`` - 1 more, each
    adapting the filter's lower cut to 1.5 times the k-th Ritz value.
    ``resid_tol`` > 0 stops early once the wanted residuals are below
    ``resid_tol`` * lam_max and the wanted subspace moved by under 1e-5
    (one host read a sweep); the default 0 runs every sweep and reads
    nothing.  The polish solves (A + a/10 I) Z = ritz with
    ``refine_cg_iters`` batched CG iterations and runs Rayleigh-Ritz on
    span(Z); ``quad_form(V) -> [k]`` gives the final Rayleigh quotients.
    ``filter_op_factory(c, e)``, when given, supplies the fused filter step
    T -> (2/e)(A T - c T) in place of the one built from ``matvec``.

    ``partition_masks`` f32 [N, P] (disjoint 0/1 columns) is the union-graph
    mode: A is block-diagonal over P partitions (the disjoint union of two
    meshes), one filtered block of k P + ``block_extra`` columns serves
    them all (the cut at the k P-th Ritz value), and the final
    Rayleigh-Ritz runs per partition on the polished block restricted to
    its rows, which separates the near-degenerate pairs two similar meshes
    give.  Returns (lams [P, k], vecs [N, P, k], resid [P, k]) then.

    Returns (lams [k], vecs [N, k], resid [k])."""
    n = null_vec.shape[0]
    n_parts = 0 if partition_masks is None else partition_masks.shape[1]
    k_tot = k * max(n_parts, 1)
    b = k_tot + block_extra
    v0 = _unit_null(null_vec)
    if lam_max_bound is not None:
        lam_max = torch.as_tensor(lam_max_bound, dtype=torch.float32,
                                  device=null_vec.device) * 1.005
    else:
        if power_vec is None:
            raise ValueError("power_vec [N] is required without lam_max_bound")
        lam_max = _estimate_lambda_max(matvec, power_vec, subspace_mask=subspace_mask) * 1.3

    def cheb_filter(X, a, deg):
        """T_deg((2A - (a + lam_max)) / (lam_max - a)) applied to X."""
        c = (lam_max + a) / 2.0
        e = (lam_max - a) / 2.0
        if filter_op_factory is not None:
            op = filter_op_factory(c, e)
        else:
            def op(T):
                return (2.0 / e) * (matvec(T) - c * T)

        t_prev, t_cur = X, 0.5 * op(X)
        for _ in range(deg - 1):
            t_prev, t_cur = t_cur, op(t_cur) - t_prev
        return t_cur

    def sweep(X, a, deg):
        """One filtered subspace iteration -> (X', a', max wanted residual)."""
        Q, _ = torch.linalg.qr(_project_out(v0, cheb_filter(X, a, deg)))
        AQ = matvec(Q)
        H = Q.T @ AQ
        with spans.host_read("eigh"):
            theta, S = torch.linalg.eigh(0.5 * (H + H.T))  # ascending
        X = Q @ S
        resid = ((AQ @ S)[:, :k_tot] - X[:, :k_tot] * theta[None, :k_tot]).norm(dim=0)
        a = torch.clamp(1.5 * theta[k_tot - 1], lam_max * 1e-5, lam_max * 2e-2)
        return X, a, resid.max()

    X = init_block[:, :b].to(torch.float32)
    if subspace_mask is not None:
        X = X * subspace_mask[:, None]
    X = _project_out(v0, X)
    deg0 = max(degree * 2 // 5, 32) if sweeps > 1 else degree
    X, a, r = sweep(X, lam_max * 1e-3, deg0)
    change = float("inf")
    for _ in range(sweeps - 1):
        if resid_tol > 0:
            far = r > lam_max * resid_tol
            with spans.host_read("sweep_gate"):
                far = bool(far)
            if not (far or change > 1e-5):
                break
        prev = X[:, :k_tot]
        X, a, r = sweep(X, a, degree)
        if resid_tol > 0:
            with spans.host_read("svdvals"):
                sv = torch.linalg.svdvals(prev.T @ X[:, :k_tot])
            least = 1.0 - sv.min()
            with spans.host_read("sweep_gate"):
                change = float(least)

    sigma = a * 0.1

    def shifted(Xb):
        return matvec(Xb) + sigma * (Xb if subspace_mask is None else Xb * subspace_mask[:, None])

    Z = _project_out(v0, _cg_solve(shifted, X[:, :k_tot], refine_cg_iters, v0))

    def rayleigh_ritz(Zp):
        """The k smallest Ritz pairs of A on span(Zp)."""
        Qz, _ = torch.linalg.qr(Zp)
        Hz = Qz.T @ matvec(Qz)
        with spans.host_read("eigh"):
            _, Sz = torch.linalg.eigh(0.5 * (Hz + Hz.T))
        vecs = Qz @ Sz
        vecs = vecs / vecs.norm(dim=0, keepdim=True)
        Av = matvec(vecs)
        lams = (vecs * Av).sum(dim=0)
        resid = (Av - vecs * lams[None, :]).norm(dim=0)
        order = torch.argsort(lams)[:k]
        vec_sel = vecs[:, order]
        lam_sel = quad_form(vec_sel) if quad_form is not None else lams[order]
        return lam_sel, vec_sel, resid[order]

    if partition_masks is None:
        return rayleigh_ritz(Z)
    out = []
    for p in range(n_parts):
        pm = partition_masks[:, p:p + 1]
        lams_p, vecs_p, resid_p = rayleigh_ritz(Z * pm)
        out.append((lams_p, vecs_p * pm, resid_p))
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out], dim=1),
            torch.stack([o[2] for o in out]))


def smallest_nonzero_eigpairs(matvec, scale_back: torch.Tensor,
                              null_vec: torch.Tensor, k: int,
                              power_vec: torch.Tensor, start_vec: torch.Tensor,
                              cg_iters: int = 300, lanczos_iters: int = 0,
                              refine_steps: int = 1, subspace_mask=None):
    """Smallest nonzero eigenpairs of L = diag(g)(D - W) through its
    symmetrization: ``matvec`` applies A, ``scale_back`` = sqrt(g) maps A's
    eigenvectors to L's (u = s v, unit norm).  Shift-invert Lanczos from
    ``power_vec`` and ``start_vec`` (see :func:`lanczos_shift_invert`).
    Returns (eigvals ascending [k], eigvecs [N, k], residuals [k])."""
    lams, vecs, resid = lanczos_shift_invert(
        matvec, null_vec, k, power_vec, start_vec, lanczos_iters=lanczos_iters,
        cg_iters=cg_iters, refine_steps=refine_steps, subspace_mask=subspace_mask,
    )
    u = vecs * scale_back[:, None]
    return lams, u / u.norm(dim=0, keepdim=True), resid


def narrow_or_lanczos(solver: str, matvec, quad_form, s: torch.Tensor,
                      null_basis: torch.Tensor, k: int, start: torch.Tensor,
                      lam_bound, subspace_mask=None, **solver_kw):
    """The k smallest nonzero eigenpairs of L = diag(g)(D - W) by the narrow
    solver (``solver`` 'narrow') or shift-invert Lanczos ('lanczos'), both
    on A = S (D - W) S: ``matvec`` and ``quad_form`` apply A, ``s`` =
    sqrt(g), ``null_basis`` is A's kernel, ``lam_bound`` bounds A's
    spectrum (read by the narrow solver only).  ``start`` is the narrow
    solver's [N, >= k + block_extra] block, or Lanczos's power-iteration
    and start vectors as the two columns of [N, 2].  ``solver_kw`` goes to
    :func:`chebyshev_eigpairs` or :func:`smallest_nonzero_eigpairs`.
    Returns (eigvals [k], L's eigenvectors [N, k] at unit norm)."""
    if solver == "lanczos":
        lams, vecs, _ = smallest_nonzero_eigpairs(
            matvec, s, null_basis, k, start[:, 0], start[:, 1],
            subspace_mask=subspace_mask, **solver_kw)
        return lams, vecs
    lams, vecs_a, _ = chebyshev_eigpairs(
        matvec, null_basis, k, start, subspace_mask=subspace_mask,
        lam_max_bound=lam_bound, quad_form=quad_form, **solver_kw)
    vecs = vecs_a * s[:, None]
    return lams, vecs / vecs.norm(dim=0, keepdim=True)
