"""Brute-force nearest-neighbour queries (KD-tree replacement).

Counterpart of ``pyfocusr_tpu/ops/knn.py``: ``SENTINEL`` (:47),
``pairwise_sq_dists`` (:63), ``_use_pallas`` (:84), ``nn_query`` (:242)
and its XLA path ``_nn_query_impl`` (:291), ``knn_query`` (:337) and its
XLA path ``_knn_query_impl`` (:372), ``knn3_masked`` (:424),
``idw_from_knn`` (:440) and ``idw_pull_k3`` (:457), with the route
decision of :169-229 (``_GRID_*_PAIRS_DEFAULT``, ``_backend_pair_scale``,
``_grid_decision``).

A brute-force query takes the route JAX's ``_use_pallas`` gives it on a
TPU: D <= 16, k <= 128 and at least k references go to ``knn_kernel.knn``
(the hand-written CUDA kernels for CUDA tensors, their plain PyTorch version
for CPU tensors); wider coordinates, k > 128 or fewer references than k go
to ``knn_tiled`` / ``nn_tiled``, the port of JAX's XLA path, on either
device (JAX has no kernel there).  For 3-D points and k <= 8 a query may
instead take the exact voxel grid of ``ops/grid_knn.py``.  The grid and the
kernel return the same bits, so that choice is one of time:
``_grid_decision`` sends a query below ``_GRID_MIN_PAIRS_DEFAULT`` pairs to
brute, one at or above ``_GRID_SURE_PAIRS_DEFAULT`` to the grid, and one
between to the race of ``ops/knn_routing.py``, which times both once per
shape class and keeps the winner.  Both bounds are halved for k > 1.

Distances are Euclidean (``KDTree.query`` contract); indices come back as
int64 so they index tensors directly.
"""

from __future__ import annotations

import os

import torch

from ..utils.precision import f32_matmuls
from . import knn_kernel, knn_routing
from .grid_knn import knn_grid

# Masked-out reference rows are pushed to this coordinate so they can never
# win a query (1e30^2 overflows f32 to inf).
SENTINEL = 1e30

__all__ = [
    "SENTINEL",
    "pairwise_sq_dists",
    "nn_query",
    "nn_tiled",
    "knn_query",
    "knn_tiled",
    "knn3_masked",
    "idw_from_knn",
    "idw_pull_k3",
]


def pairwise_sq_dists(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Full [Nq, Nr] squared distances via the matmul identity, clamped at
    0 (the CPD E-step and Gram use it; nearest-neighbour search never does)."""
    qn = (query * query).sum(dim=1, keepdim=True)
    rn = (ref * ref).sum(dim=1, keepdim=True)
    d2 = qn + rn.T - 2.0 * (query @ ref.T)
    return torch.clamp(d2, min=0.0)


# The band of pairs (Nq * Nr, for k = 1; halved for k > 1, as the JAX
# package halves its own) where neither route wins surely, set from knn3 on
# the multires refine's own inputs on one NVIDIA H100 80GB HBM3 at 700.00 W
# (chip_smoke.py's multires phase and tools/multires_scale.py): at 655362^2
# (4.3e11 pairs) the grid took 0.055 s against brute's 0.192 s, at 2621442^2
# 0.25 against 3.02 s; at 163842^2 brute won, 0.0132 against 0.021 s, and at
# 40962^2 (1.7e9 pairs) by more.  So knn3 takes brute below 1.7e9 pairs and
# the grid from 4.25e11, and races between.
_GRID_MIN_PAIRS_DEFAULT = 3.4e9
_GRID_SURE_PAIRS_DEFAULT = 8.5e11
# On the CPU the plain brute version loses far more to the kernel a pair
# than the grid loses to itself on the card: the same crossings measured there
# (tools/multires_scale.py --device cpu, knn3 on the refine's inputs: brute
# 10x faster at 642^2, the grid 3.7x faster at 10242^2) sit at 2.45e-4 of
# the card's pair counts.
_CPU_PAIR_SCALE = 2.45e-4


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (the grid reads
    masks back to the host and must not run inside a capture)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _kernel_takes(d: int, nr: int, k: int) -> bool:
    """Whether JAX's ``_use_pallas`` (:84-102) sends this query to its
    kernel on a TPU: D <= 16, k <= 128 (the kernel's lane block) and at
    least k references.  Elsewhere JAX runs its XLA path, and so does the
    port (``knn_tiled`` / ``nn_tiled``)."""
    return d <= knn_kernel.MAX_D and k <= knn_kernel.MAX_K and nr >= k


# The XLA path's reference tile (JAX's ``tile`` default) and the elements of
# one [query chunk, tile] distance block (JAX's _QUERY_CHUNK_ELEMS, :70: 1 GB
# of f32).
_TILE = 8192
_QUERY_CHUNK_ELEMS = 256 * 1024 * 1024


def _query_chunks(query, tile: int):
    rows = max(_QUERY_CHUNK_ELEMS // max(tile, 1), 1024)
    return [query[s : s + rows] for s in range(0, query.shape[0], rows)]


def _clean_ref(ref):
    """Non-finite reference coordinates at ``SENTINEL`` (JAX :316), so they
    square to inf and never win."""
    return torch.where(torch.isfinite(ref), ref, torch.full_like(ref, SENTINEL))


@f32_matmuls
def nn_tiled(ref: torch.Tensor, query: torch.Tensor, tile: int = _TILE):
    """Nearest reference row of each query row by the matmul identity
    |q|^2 + |r|^2 - 2 q.r in full f32 (TF32 off), over reference tiles with
    a running minimum: the port of JAX's ``_nn_query_impl``.  The first
    minimum wins inside a tile and an earlier tile wins a tie.  Returns
    (distances f32 [Nq], indices int64 [Nq]); a query with no finite
    neighbour reports (inf, Nr)."""
    nr = ref.shape[0]
    ref = _clean_ref(ref)
    dists, idxs = [], []
    for q in _query_chunks(query, tile):
        qn = (q * q).sum(dim=1)
        best = torch.full((q.shape[0],), float("inf"), dtype=torch.float32,
                          device=q.device)
        best_idx = torch.zeros((q.shape[0],), dtype=torch.int64, device=q.device)
        for t0 in range(0, nr, tile):
            rt = ref[t0 : t0 + tile]
            d2 = qn[:, None] + (rt * rt).sum(dim=1)[None, :] - 2.0 * (q @ rt.T)
            col = torch.argmin(d2, dim=1)  # the first minimum, as jnp.argmin
            val = d2.gather(1, col[:, None])[:, 0]
            take = val < best
            best = torch.where(take, val, best)
            best_idx = torch.where(take, col + t0, best_idx)
        best_idx = torch.where(torch.isinf(best), torch.full_like(best_idx, nr),
                               best_idx)
        dists.append(torch.sqrt(torch.clamp(best, min=0.0)))
        idxs.append(best_idx)
    return torch.cat(dists), torch.cat(idxs)


def _sort_keys(d2, idx):
    """int64 keys ordered as (d2, idx) lexicographically: the f32 bits of
    d2 made monotone as a signed integer (negative values, which the
    identity's cancellation can give, reversed; -0 first made +0; NaN taken
    as +inf, never a winner), shifted over a non-negative int32 index."""
    d2 = torch.where(torch.isnan(d2), torch.full_like(d2, float("inf")), d2 + 0.0)
    bits = d2.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return (key << 32) | idx


def _key_d2(key):
    """The squared distance of a key of ``_sort_keys``."""
    hi = (key >> 32).to(torch.int32)
    return torch.where(hi < 0, hi ^ 0x7FFFFFFF, hi).view(torch.float32)


@f32_matmuls
def knn_tiled(ref: torch.Tensor, query: torch.Tensor, k: int, tile: int = _TILE):
    """k nearest reference rows of each query row by the matmul identity in
    full f32, over reference tiles with a running top-k merged with each
    tile, ascending by (squared distance, index): the port of JAX's
    ``_knn_query_impl``, whose ``lax.top_k`` merges of width k + tile keep
    ties in the lower index.  Returns (distances f32 [Nq, k], indices int64
    [Nq, k]); a slot with no finite neighbour (fewer than k references,
    ``SENTINEL`` or non-finite rows) reports (inf, Nr)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    nr = ref.shape[0]
    ref = _clean_ref(ref)
    none = _sort_keys(torch.tensor([float("inf")]),
                      torch.tensor([2**31 - 1], dtype=torch.int64)).item()
    dists, idxs = [], []
    for q in _query_chunks(query, tile):
        qn = (q * q).sum(dim=1)
        best = torch.full((q.shape[0], k), none, dtype=torch.int64, device=q.device)
        for t0 in range(0, nr, tile):
            rt = ref[t0 : t0 + tile]
            d2 = qn[:, None] + (rt * rt).sum(dim=1)[None, :] - 2.0 * (q @ rt.T)
            cols = torch.arange(t0, t0 + rt.shape[0], device=q.device)
            keys = torch.cat([best, _sort_keys(d2, cols.expand_as(d2))], dim=1)
            best = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
        d2 = _key_d2(best)
        idx = best & 0xFFFFFFFF
        idx = torch.where(torch.isinf(d2), torch.full_like(idx, nr), idx)
        dists.append(torch.sqrt(torch.clamp(d2, min=0.0)))
        idxs.append(idx)
    return torch.cat(dists), torch.cat(idxs)


def _grid_decision(ref, query, k: int) -> str:
    """'brute', 'grid' or 'race' for this query.  The grid takes 3-D
    points, k <= 8 (JAX :198), outside a CUDA-graph capture.
    ``PYFOCUSR_TPU_KNN_GRID`` = off | auto | on, and
    ``PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS`` / ``_SURE_PAIRS`` replace the bounds
    (MIN alone is a single threshold), read per call as in the JAX
    package."""
    mode = os.environ.get("PYFOCUSR_TPU_KNN_GRID", "auto").lower()
    if mode in ("off", "0") or _capturing():
        return "brute"
    if (ref.dim() != 2 or query.dim() != 2 or ref.shape[1] != 3
            or query.shape[1] != 3 or k > 8):
        return "brute"
    if mode in ("on", "1", "force"):
        return "grid"
    scale = 1.0 if ref.device.type == "cuda" else _CPU_PAIR_SCALE
    min_env = os.environ.get("PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS")
    sure_env = os.environ.get("PYFOCUSR_TPU_KNN_GRID_SURE_PAIRS")
    min_pairs = float(min_env) if min_env is not None else _GRID_MIN_PAIRS_DEFAULT * scale
    if sure_env is not None:
        sure_pairs = float(sure_env)
    elif min_env is not None:
        sure_pairs = min_pairs
    else:
        sure_pairs = _GRID_SURE_PAIRS_DEFAULT * scale
    if k > 1:
        min_pairs /= 2.0
        sure_pairs /= 2.0
    pairs = float(query.shape[0]) * float(ref.shape[0])
    if pairs < min_pairs:
        return "brute"
    if pairs >= max(sure_pairs, min_pairs):
        return "grid"
    return "race"


def knn_query(ref: torch.Tensor, query: torch.Tensor, k: int):
    """k nearest reference rows of each query row, ascending, ties to the
    lower index, by the route ``_grid_decision`` and ``_kernel_takes``
    pick.  Returns (distances f32 [Nq, k], indices int64 [Nq, k]); a
    missing neighbour is (inf, Nr)."""
    ref = ref.float().contiguous()
    query = query.float().contiguous()
    decision = _grid_decision(ref, query, k)
    if decision == "brute" and not _kernel_takes(ref.shape[1], ref.shape[0], k):
        if k == 1:
            d, i = nn_tiled(ref, query)
            return d[:, None], i[:, None]
        return knn_tiled(ref, query, k)
    if decision == "brute":
        d, i = knn_kernel.knn(ref, query, k)
    elif decision == "grid":
        d, i = knn_grid(ref, query, k)
    else:
        d, i = knn_routing.routed(
            knn_routing.bucket_key(query.shape[0], ref.shape[0], k),
            {"grid": lambda: knn_grid(ref, query, k),
             "brute": lambda: knn_kernel.knn(ref, query, k)},
            ref.device,
        )
    return d, i.long()


def nn_query(ref: torch.Tensor, query: torch.Tensor):
    """Nearest reference row of each query row: (distances [Nq], indices
    int64 [Nq])."""
    d, i = knn_query(ref, query, 1)
    return d[:, 0], i[:, 0]


def knn3_masked(ref_positions, ref_mask, query_points):
    """k=3 neighbours of ``query_points`` among the rows of
    ``ref_positions`` with ``ref_mask > 0`` (the others pushed to
    ``SENTINEL``).  Column 0 is the nearest-neighbour correspondence."""
    ref_q = torch.where(
        ref_mask[:, None] > 0,
        ref_positions,
        torch.full_like(ref_positions, SENTINEL),
    )
    return knn_query(ref_q, query_points, 3)


def idw_from_knn(dists, idxs, ref_values):
    """Inverse-distance k=3 interpolation with the exact-hit shortcut (a
    distance-0 neighbour wins outright)."""
    vals = ref_values[idxs]  # [Nq, k, D]
    exact = dists <= 0.0
    any_exact = exact.any(dim=1)
    first = torch.argmax(exact.to(torch.int8), dim=1)  # first True
    exact_vals = vals[torch.arange(vals.shape[0], device=vals.device), first]
    wts = 1.0 / torch.clamp(dists, min=1e-30)
    out = (vals * wts[:, :, None]).sum(dim=1) / wts.sum(dim=1, keepdim=True)
    return torch.where(any_exact[:, None], exact_vals, out)


def idw_pull_k3(ref_positions, ref_mask, ref_values, query_points):
    """k=3 inverse-distance interpolation of ``ref_values`` at
    ``query_points`` (``knn3_masked`` + ``idw_from_knn``).  With no valid
    reference row (``ref_mask`` all zero) the result is NaN (0/0 weight),
    as in the JAX package."""
    dists, idxs = knn3_masked(ref_positions, ref_mask, query_points)
    return idw_from_knn(dists, idxs, ref_values)
