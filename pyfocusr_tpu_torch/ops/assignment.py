"""Linear assignment, on the device and on the host.

Counterpart of ``pyfocusr_tpu/ops/assignment.py``: ``lap_host`` (:43, the
numpy Jonker-Volgenant loop), ``exact_lap_small``
(:509, the k x k eigsort matching for k <= 8), ``_sinkhorn_duals`` (:214),
``_greedy_complete`` (:242), ``_bulk_match`` (:263), ``_jv_device`` (:284)
and ``sinkhorn_jv_lap`` (:406), the exact solver behind 'hungarian'
correspondences: annealed-Sinkhorn duals warm-start a Jonker-Volgenant
solve (tight-edge bulk matching, then one Dijkstra augmentation per row
still free), and the ``linear_sum_assignment`` dispatcher (:540) between
that solver and ``lap_host``.

The two TPU kernels on that path are CUDA kernels here:
``ops/sinkhorn_kernel.py`` (the Sinkhorn dual updates) and
``ops/jv_kernel.py`` (the Dijkstra augmentation).  On CUDA tensors
``sinkhorn_jv_lap`` launches both; on CPU tensors the same two calls take
the kernels' plain versions (each wrapper dispatches on where its tensors
lie; nothing here looks at the device).

Not ported: ``auction_lap`` / ``sinkhorn_auction_lap`` (superseded by JV)
and ``lap_host``'s native C++ fast path (``pyfocusr_tpu/native.py``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from torch.profiler import record_function

from . import jv_kernel, sinkhorn_kernel

__all__ = ["exact_lap_small", "lap_host", "linear_sum_assignment", "sinkhorn_jv_lap"]


def lap_host(cost):
    """Jonker-Volgenant shortest-augmenting-path LAP on the host (numpy,
    f64).  Returns (row_ind, col_ind) minimizing cost[row_ind,
    col_ind].sum(), rows in order: the scipy contract.  A cost with more
    rows than columns is solved transposed."""
    cost = np.asarray(cost, dtype=np.float64)
    if not np.isfinite(cost).all():
        # scipy's contract; a NaN row would never select an augmenting column.
        raise ValueError("cost matrix contains non-finite entries")
    n_rows, n_cols = cost.shape
    if n_rows > n_cols:
        rows, cols = lap_host(cost.T)
        order = np.argsort(cols)
        return cols[order], rows[order]

    u = np.zeros(n_rows + 1)
    v = np.zeros(n_cols + 1)
    # p[j]: the row (1-based) matched to column j (1-based); column 0 is virtual.
    p = np.zeros(n_cols + 1, dtype=np.int64)
    way = np.zeros(n_cols + 1, dtype=np.int64)
    for i in range(1, n_rows + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n_cols + 1, np.inf)
        used = np.zeros(n_cols + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            # Relaxation over the free columns at once.
            free = ~used[1:]
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            sub = minv[1:]
            upd = free & (cur < sub)
            sub[upd] = cur[upd]
            way[1:][upd] = j0
            masked = np.where(free, sub, np.inf)
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            used_cols = np.where(used)[0]
            u[p[used_cols]] += delta
            v[used_cols] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0 != 0:  # augment along the alternating path
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1

    col_ind = np.zeros(n_rows, dtype=np.int64)
    for j in range(1, n_cols + 1):
        if p[j] > 0:
            col_ind[p[j] - 1] = j - 1
    return np.arange(n_rows), col_ind


def linear_sum_assignment(cost, device_threshold: int | None = 0):
    """(row_ind, col_ind) as numpy arrays, the scipy contract.  A square
    CUDA tensor of more than ``device_threshold`` rows is solved on the card
    by :func:`sinkhorn_jv_lap` (the Sinkhorn and JV kernels); numpy arrays,
    CPU tensors and rectangular costs go to :func:`lap_host`, the
    counterpart of the JAX package's CPU-backend gate.  The default 0 keeps
    every square cost that lies on the card there: on an H100 the card's
    solve takes 1.0-1.2 ms from 2 to 64 rows, so ``lap_host`` is faster
    only below 64 rows and by under 1 ms, and the card is 5-90x faster
    from 64 to 2048 rows (``chip_smoke.py``'s ``lap_dispatch`` sweep); the
    JAX package's 2048, set on a TPU against a native C++ host solver, does
    not carry over.  ``device_threshold=None`` takes the host at every
    size."""
    n_rows, n_cols = cost.shape
    on_card = torch.is_tensor(cost) and cost.device.type == "cuda"
    if (device_threshold is None or not on_card or n_rows != n_cols
            or n_rows <= device_threshold):
        if torch.is_tensor(cost):
            cost = cost.detach().cpu().numpy()
        return lap_host(cost)
    return np.arange(n_rows), sinkhorn_jv_lap(cost).cpu().numpy()


def exact_lap_small(cost: torch.Tensor) -> torch.Tensor:
    """Exact square LAP for k <= 8 by enumerating all k! permutations (a
    host constant) on the cost's device: one gather, a sum and an argmin
    (first minimum on ties).  Returns the column of each row, int64 [k]."""
    k = cost.shape[0]
    if cost.shape[1] != k:
        raise ValueError(f"exact_lap_small requires a square cost, got {tuple(cost.shape)}")
    if k > 8:
        raise ValueError(f"exact_lap_small enumerates k! permutations; k={k} > 8")
    perms = torch.as_tensor(
        np.array(list(itertools.permutations(range(k))), np.int64)
    ).to(cost.device)
    rows = torch.arange(k, device=cost.device)[None, :]
    totals = cost[rows, perms].sum(dim=1)
    return perms[torch.argmin(totals)]


def _sinkhorn_duals(cost, T0, T_factor: float, levels: int, iters_per_level: int):
    """Annealed log-domain Sinkhorn in plain PyTorch: dual potentials
    (f, g) of the entropic relaxation of the assignment LP at temperatures
    T0 * T_factor**level, each iteration two [n, n] ``torch.logsumexp``
    reductions.  The counterpart of the JAX package's XLA loop of the same
    name and the independent reference that the tests hold
    ``sinkhorn_kernel.sinkhorn_duals_streamed`` to (same schedule; it
    divides by T where the kernel multiplies by 1/T).  The solver itself
    calls ``sinkhorn_duals_streamed`` on every device."""
    n = cost.shape[0]
    f = torch.zeros((n,), dtype=cost.dtype, device=cost.device)
    g = torch.zeros((n,), dtype=cost.dtype, device=cost.device)
    ts, _ = sinkhorn_kernel.temperatures(T0, T_factor, levels)
    for T in ts:
        for _ in range(iters_per_level):
            f = -T * torch.logsumexp((g[None, :] - cost) / T, dim=1)
            g = -T * torch.logsumexp((f[:, None] - cost) / T, dim=0)
    return f, g


def _greedy_complete(assignment, n: int):
    """Pair any still-unassigned rows (-1) with the free columns, both in
    index order: the safety net that keeps the result a permutation if the
    Dijkstra step budget is ever hit."""
    dev = assignment.device
    taken = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    taken[torch.where(assignment >= 0, assignment, n)] = 1
    taken = taken[:n]
    free_rank = torch.cumsum(1 - taken, dim=0) - 1  # rank of each free column
    # For the r-th unassigned row, pick the r-th free column.
    order = torch.argsort(
        torch.where(taken > 0, n, free_rank), stable=True
    )  # free columns first
    unassigned_rank = torch.cumsum((assignment < 0).to(torch.int64), dim=0) - 1
    fill = order[unassigned_rank.clamp(0, n - 1)]
    return torch.where(assignment < 0, fill, assignment)


def _bulk_match(cost, v0):
    """Tight-edge bulk matching (the vectorised analog of JV column
    reduction): with u = row minima of ``cost - v0`` the duals are feasible
    for any ``v0``, every row's argmin column is a zero-reduced-cost edge,
    and one scatter-min per column keeps the lowest row that claims it.
    Returns (u0 f32 [n], row4col0 int32 [n], col4row0 int32 [n]); -1 marks a
    free column or row."""
    n = cost.shape[0]
    dev = cost.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    u0 = (cost - v0[None, :]).min(dim=1).values
    j_star = torch.argmin(cost - u0[:, None] - v0[None, :], dim=1)
    col_winner = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    col_winner.scatter_reduce_(0, j_star, rows, reduce="amin")
    won = col_winner[j_star] == rows
    col4row0 = torch.where(won, j_star, -1).to(torch.int32)
    row4col0 = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    row4col0[torch.where(won, j_star, n)] = rows.to(torch.int32)
    return u0, row4col0[:n].contiguous(), col4row0


def _jv_device(cost, v0, max_total_steps: int):
    """Jonker-Volgenant LAP from column duals ``v0``: ``_bulk_match`` then
    the Dijkstra augmentation of ``jv_kernel.jv_device`` (the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors).  Returns
    (col_of_row int32 [n] with -1 where the step budget ran out, steps_used,
    u, v)."""
    with record_function("register_pair/lap_bulk_match"):
        u0, row4col0, col4row0 = _bulk_match(cost, v0)
    with record_function("register_pair/lap_jv"):
        return jv_kernel.jv_device(cost, u0, v0, row4col0, col4row0, max_total_steps)


def sinkhorn_jv_lap(cost, levels: int = 14, iters_per_level: int = 30,
                    max_total_steps: int = None, warm_start: bool = True,
                    return_duals: bool = False):
    """Exact square LAP on the cost's device: annealed-Sinkhorn duals
    (temperatures spread/4 * 3**-level) warm-start a Jonker-Volgenant solve
    when ``warm_start`` and n >= 512; smaller problems start from v = 0.
    The duals only shorten the augmenting paths: feasibility and exactness
    come from ``_bulk_match`` for any v.  ``max_total_steps`` (default 60 n)
    bounds the Dijkstra steps; rows beyond it (none observed) are paired
    with the leftover columns.

    Returns the column assigned to each row, int64 [n], always a
    permutation.  With ``return_duals`` returns ``(assignment, u, v,
    steps_used)``: the final duals certify optimality when the budget was
    not hit (``cost - u[:, None] - v[None, :] >= 0`` and ``sum(u) + sum(v)``
    equal to the assignment's cost, up to f32 rounding).
    """
    cost = cost.to(torch.float32)
    if cost.dim() != 2 or cost.shape[1] != cost.shape[0]:
        raise ValueError(
            f"sinkhorn_jv_lap requires a square cost matrix, got "
            f"{tuple(cost.shape)} (rectangular problems are not ported)"
        )
    n = cost.shape[0]
    if max_total_steps is None:
        max_total_steps = 60 * n
    cost = cost.contiguous()
    with record_function("register_pair/lap_warm_start"):
        if warm_start and n >= 512:
            spread = float(torch.clamp(cost.max() - cost.min(), min=1e-12))
            _, v0 = sinkhorn_kernel.sinkhorn_duals_streamed(
                cost, spread / 4.0, 1.0 / 3.0, levels, iters_per_level
            )
        else:
            v0 = torch.zeros((n,), dtype=torch.float32, device=cost.device)
    col4row, steps, u, v = _jv_device(cost, v0, max_total_steps)
    assignment = _greedy_complete(col4row.long(), n)
    if return_duals:
        return assignment, u, v, steps
    return assignment
