"""Linear assignment, on the device and on the host.

Counterpart of ``pyfocusr_tpu/ops/assignment.py``: ``lap_host`` (:43, the
host library's C++ Jonker-Volgenant, with the numpy loop as its plain
version ``lap_host_plain``), ``exact_lap_small``
(:509, the k x k eigsort matching for k <= 8), ``_sinkhorn_duals`` (:214),
``_greedy_complete`` (:242), ``_bulk_match`` (:263), ``_jv_device`` (:284)
and ``sinkhorn_jv_lap`` (:406), the exact solver behind 'hungarian'
correspondences: annealed-Sinkhorn duals warm-start a Jonker-Volgenant
solve (tight-edge bulk matching, then one Dijkstra augmentation per row
still free), the ``linear_sum_assignment`` dispatcher (:540) between
that solver and ``lap_host``, and the round-1 solvers JV superseded:
``_auction_scaling_phase`` / ``auction_lap`` (:115-209, the forward auction
with epsilon scaling, optimal to within n times its last epsilon) and the
``sinkhorn_auction_lap`` alias of ``sinkhorn_jv_lap`` (:491-506).

The two TPU kernels on that path are CUDA kernels here:
``ops/sinkhorn_kernel.py`` (the Sinkhorn dual updates) and
``ops/jv_kernel.py`` (the Dijkstra augmentation).  On CUDA tensors
``sinkhorn_jv_lap`` launches both; on CPU tensors the same two calls take
the kernels' plain versions (each wrapper dispatches on where its tensors
lie; nothing here looks at the device).  The auction's rounds are plain
PyTorch (JAX runs them as XLA scatters, no Pallas kernel): one masked round
driven by ``utils/device_loop.run_blocked``, its stop test on the device,
captured as a CUDA graph and replayed ``AUCTION_BLOCK`` rounds between host
reads on the card.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import native
from ..utils import device_loop, spans
from . import jv_kernel, sinkhorn_kernel

__all__ = ["auction_lap", "exact_lap_small", "lap_host", "lap_host_plain",
           "linear_sum_assignment", "sinkhorn_auction_lap", "sinkhorn_jv_lap"]

# Auction rounds between host reads of the stop flag.
AUCTION_BLOCK = 16
# What the last auction_lap did, one entry a phase: device_loop's fields
# (rounds as "iterations", host reads, graph or not, replay and read ms).
AUCTION_STATS = []


def _host_cost(cost):
    """``cost`` as f64 numpy; non-finite entries raise (scipy's contract: a
    NaN row would never select an augmenting column)."""
    cost = np.asarray(cost, dtype=np.float64)
    if not np.isfinite(cost).all():
        raise ValueError("cost matrix contains non-finite entries")
    return cost


def _untranspose(rows, cols):
    order = np.argsort(cols)
    return cols[order], rows[order]


def lap_host(cost):
    """Jonker-Volgenant shortest-augmenting-path LAP on the host (the host
    library's C++ solver, f64).  Returns (row_ind, col_ind) minimizing
    cost[row_ind, col_ind].sum(), rows in order: the scipy contract.  A
    cost with more rows than columns is solved transposed."""
    cost = _host_cost(cost)
    n_rows, n_cols = cost.shape
    if n_rows > n_cols:
        return _untranspose(*lap_host(cost.T))
    if n_rows == 0:
        return np.arange(0), np.zeros(0, np.int64)
    return np.arange(n_rows), native.lap_jv(cost)


def lap_host_plain(cost):
    """:func:`lap_host` as a numpy loop (the JAX package's, :70-108): the
    plain version of the C++ solver."""
    cost = _host_cost(cost)
    n_rows, n_cols = cost.shape
    if n_rows > n_cols:
        return _untranspose(*lap_host_plain(cost.T))

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


# Square CUDA costs of more rows than this go to the card (see
# linear_sum_assignment).
DEVICE_THRESHOLD = 642


def linear_sum_assignment(cost, device_threshold: int | None = DEVICE_THRESHOLD):
    """(row_ind, col_ind) as numpy arrays, the scipy contract.  A square
    CUDA tensor of more than ``device_threshold`` rows is solved on the card
    by :func:`sinkhorn_jv_lap` (the Sinkhorn and JV kernels); numpy arrays,
    CPU tensors and rectangular costs go to :func:`lap_host`, the
    counterpart of the JAX package's CPU-backend gate.  The default
    ``DEVICE_THRESHOLD`` = 642 is the largest size of ``chip_smoke.py``'s
    ``lap_dispatch`` sweep (uniform costs, 2 to 2048 rows) at which
    ``lap_host`` beat the card's solve on an NVIDIA H100 80GB HBM3 at a
    700 W power limit and its host: 24.7 against 27.5 ms at 642 rows,
    72 against 30 ms at 1024 (the card's solve takes 1.2-1.7 ms up to 64
    rows, where ``lap_host`` takes under 0.3 ms).  The JAX package's 2048
    was set on a TPU.  ``device_threshold=None`` takes the host at every
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
    with spans.host_read("perms_copy"):
        perms = torch.as_tensor(
            np.array(list(itertools.permutations(range(k))), np.int64)
        ).to(cost.device)
    rows = torch.arange(k, device=cost.device)[None, :]
    totals = cost[rows, perms].sum(dim=1)
    best = torch.argmin(totals)
    with spans.host_read("perms_index"):  # a 0-d index is read to the host
        return perms[best]


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
    u, v).  The open call's record counts JV's steps (``jv_steps``), the
    rows left free by the bulk match (``jv_free_rows``) and whether the
    budget left rows unassigned (``jv_budget_hit``), each kept on the
    device until the record is read."""
    with spans.span("lap/bulk_match"):
        u0, row4col0, col4row0 = _bulk_match(cost, v0)
    with spans.span("lap/jv"):
        col4row, steps, u, v = jv_kernel.jv_device(cost, u0, v0, row4col0, col4row0,
                                                   max_total_steps)
    if spans.current() is not None:
        spans.count("jv_steps", steps.to(torch.int64))
        spans.count("jv_free_rows", (col4row0 < 0).sum())
        spans.count("jv_budget_hit", (col4row < 0).any().to(torch.int64))
    return col4row, steps, u, v


def sinkhorn_jv_lap(cost, levels: int = 14, iters_per_level: int = 30,
                    max_total_steps: int = None, warm_start: bool = True,
                    return_duals: bool = False):
    """Exact square LAP on the cost's device: annealed-Sinkhorn duals
    (temperatures spread/4 * 3**-level) warm-start a Jonker-Volgenant solve
    when ``warm_start`` and n >= 512; smaller problems start from v = 0.
    The duals only shorten the augmenting paths: feasibility and exactness
    come from ``_bulk_match`` for any v.  ``max_total_steps`` (default 60 n)
    bounds the Dijkstra steps; rows beyond it are paired greedily with the
    leftover columns, off the optimum (the open call's record says so in
    ``jv_budget_hit``; its Sinkhorn passes in ``sinkhorn_passes``).

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
    with spans.span("lap/warm_start"):
        if warm_start and n >= 512:
            spread = torch.clamp(cost.max() - cost.min(), min=1e-12)
            with spans.host_read("lap_spread"):
                spread = float(spread)
            _, v0 = sinkhorn_kernel.sinkhorn_duals_streamed(
                cost, spread / 4.0, 1.0 / 3.0, levels, iters_per_level
            )
            spans.count("sinkhorn_passes", 2 * levels * iters_per_level)
        else:
            v0 = torch.zeros((n,), dtype=torch.float32, device=cost.device)
    col4row, steps, u, v = _jv_device(cost, v0, max_total_steps)
    assignment = _greedy_complete(col4row.long(), n)
    if return_duals:
        return assignment, u, v, steps
    return assignment


def _auction_scaling_phase(cost_neg, eps, prices, max_rounds: int, stats: dict = None):
    """One epsilon phase of the forward auction (``pyfocusr_tpu/ops/
    assignment.py:115-178``): every unassigned row bids for its best column
    (the top 2 of ``cost_neg - prices``) by the gap to its second plus
    ``eps``; each column takes the highest bid, ties to the lowest row
    (a scatter-max, then a scatter-min), raises its price by it and evicts
    its owner; until every row holds a column or ``max_rounds`` rounds ran.
    The rounds run in ``device_loop.run_blocked`` with the stop test on the
    device.  Returns (assignment int64 [n], -1 where unassigned; prices);
    ``stats`` gets the loop's fields."""
    n = cost_neg.shape[0]
    dev = cost_neg.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    pad = torch.full((1,), n, dtype=torch.int64, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=cost_neg.dtype, device=dev)
    zero = torch.zeros((), dtype=cost_neg.dtype, device=dev)
    minus1 = torch.full((1,), -1, dtype=torch.int64, device=dev)
    assignment = torch.full((n,), -1, dtype=torch.int64, device=dev)
    owner = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prices = prices.clone()
    ctrl = torch.zeros((2,), dtype=torch.int32, device=dev)

    def step():
        live = ctrl[1] == 0
        bidder = assignment < 0
        top2, top2_idx = torch.topk(cost_neg - prices[None, :], 2, dim=1)
        best_j = top2_idx[:, 0]
        bids = top2[:, 0] - top2[:, 1] + eps
        bid_eff = torch.where(bidder, bids, neg_inf)
        tgt = torch.where(bidder, best_j, pad)
        col_bid = torch.full((n + 1,), float("-inf"), dtype=cost_neg.dtype, device=dev)
        col_bid.scatter_reduce_(0, tgt, bid_eff, reduce="amax")
        cand = bidder & (bid_eff >= col_bid[best_j])
        cand_tgt = torch.where(cand, best_j, pad)
        col_winner = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
        col_winner.scatter_reduce_(0, cand_tgt, torch.where(cand, rows, pad), reduce="amin")
        won = cand & (col_winner[best_j] == rows)
        won_tgt = torch.where(won, best_j, pad)
        new_prices = torch.cat([prices, zero[None]])
        new_prices.index_add_(0, won_tgt, torch.where(won, bids, zero))
        owner_pad = torch.cat([owner, minus1])
        evicted = owner_pad[won_tgt]
        new_assign = torch.cat([assignment, minus1])
        new_assign.index_fill_(0, torch.where(evicted >= 0, evicted, pad), -1)
        owner_pad[won_tgt] = torch.where(won, rows, minus1)
        new_assign = torch.where(won, best_j, new_assign[:n])
        # The masked update: a finished loop keeps its state.
        assignment.copy_(torch.where(live, new_assign, assignment))
        owner.copy_(torch.where(live, owner_pad[:n], owner))
        prices.copy_(torch.where(live, new_prices[:n], prices))
        count = ctrl[0] + live.to(torch.int32)
        done = ~live | ~(assignment < 0).any() | (count >= max_rounds)
        ctrl.copy_(torch.stack([count, done.to(torch.int32)]))

    if stats is None:
        stats = {}
    device_loop.reset_stats(stats, AUCTION_BLOCK)
    if max_rounds < 1:  # no round runs, as in the JAX loop
        return assignment, prices
    device_loop.run_blocked(step, ctrl, max_rounds, AUCTION_BLOCK, stats,
                            what="auction phase")
    return assignment, prices


def auction_lap(cost, eps_scaling_steps: int = 7, max_rounds: int = 100000):
    """Square LAP by the forward auction with epsilon scaling, on the cost's
    device (``pyfocusr_tpu/ops/assignment.py:181-209``): epsilon starts at
    spread / 2, is divided by 6 after each of ``eps_scaling_steps`` phases
    and floored at spread / (4 n), the prices carried from phase to phase.
    The total cost is within n times the last epsilon of the optimum.  Rows
    a phase left unassigned at ``max_rounds`` are paired with the free
    columns (``_greedy_complete``).  Returns the column of each row, int64
    [n], a permutation; ``AUCTION_STATS`` holds each phase's rounds and host
    reads."""
    cost = torch.as_tensor(cost).to(torch.float32)
    n = cost.shape[0]
    AUCTION_STATS.clear()
    if n == 1:  # the bids need two columns; one row takes column 0
        return torch.zeros((1,), dtype=torch.int64, device=cost.device)
    cost_neg = -cost
    spread = torch.clamp(cost.max() - cost.min(), min=1e-12)
    prices = torch.zeros((n,), dtype=cost.dtype, device=cost.device)
    eps_final = spread / torch.tensor(4.0 * n, dtype=cost.dtype)
    eps = spread / 2.0
    assignment = None
    for _ in range(eps_scaling_steps):
        eps = torch.maximum(eps, eps_final)
        AUCTION_STATS.append({})
        assignment, prices = _auction_scaling_phase(cost_neg, eps, prices, max_rounds,
                                                    AUCTION_STATS[-1])
        eps = eps / 6.0
    return _greedy_complete(assignment, n)


def sinkhorn_auction_lap(cost, **kwargs):
    """The round-1 name of :func:`sinkhorn_jv_lap` (``pyfocusr_tpu/ops/
    assignment.py:491-506``): JV's keywords (``levels``,
    ``iters_per_level``, ``max_total_steps``, ``warm_start``) pass through;
    the retired auction's raise ``TypeError`` with the JAX package's
    message."""
    jv_kwargs = {"levels", "iters_per_level", "max_total_steps", "warm_start"}
    unknown = set(kwargs) - jv_kwargs
    if unknown:
        raise TypeError(
            f"sinkhorn_auction_lap: unsupported kwargs {sorted(unknown)} — "
            "the epsilon-scaling auction was replaced by the exact JV solver "
            f"(sinkhorn_jv_lap); supported tuning kwargs: {sorted(jv_kwargs)}"
        )
    return sinkhorn_jv_lap(cost, **kwargs)
