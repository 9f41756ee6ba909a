"""Brute-force nearest-neighbour queries (KD-tree replacement).

Counterpart of ``pyfocusr_tpu/ops/knn.py``: ``SENTINEL`` (:47),
``pairwise_sq_dists`` (:63), ``nn_query`` (:242), ``knn_query`` (:337),
``knn3_masked`` (:424) and ``idw_from_knn`` (:440), with the route
decision of :169-229 (``_GRID_*_PAIRS_DEFAULT``, ``_backend_pair_scale``,
``_grid_decision``).

A query goes to the brute-force ``knn_kernel.knn`` (the hand-written CUDA
kernel for CUDA tensors, its plain PyTorch version for CPU tensors) or, for
3-D points and k <= 3, to the exact voxel grid of ``ops/grid_knn.py``.  Both
routes return the same bits, so the choice is one of time:
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

from . import knn_kernel, knn_routing
from .grid_knn import knn_grid

# Masked-out reference rows are pushed to this coordinate so they can never
# win a query (1e30^2 overflows f32 to inf).
SENTINEL = 1e30

__all__ = [
    "SENTINEL",
    "pairwise_sq_dists",
    "nn_query",
    "knn_query",
    "knn3_masked",
    "idw_from_knn",
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


def _grid_decision(ref, query, k: int) -> str:
    """'brute', 'grid' or 'race' for this query.  The grid takes 3-D
    points, k in ``knn_kernel.SUPPORTED_K``, outside a CUDA-graph capture.
    ``PYFOCUSR_TPU_KNN_GRID`` = off | auto | on, and
    ``PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS`` / ``_SURE_PAIRS`` replace the bounds
    (MIN alone is a single threshold), read per call as in the JAX
    package."""
    mode = os.environ.get("PYFOCUSR_TPU_KNN_GRID", "auto").lower()
    if mode in ("off", "0") or _capturing():
        return "brute"
    if (ref.dim() != 2 or query.dim() != 2 or ref.shape[1] != 3
            or query.shape[1] != 3 or k not in knn_kernel.SUPPORTED_K):
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
    lower index, by the route ``_grid_decision`` picks.  Returns (distances
    f32 [Nq, k], indices int64 [Nq, k]); a missing neighbour is (inf, Nr)."""
    ref = ref.float().contiguous()
    query = query.float().contiguous()
    decision = _grid_decision(ref, query, k)
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
