"""Brute-force nearest-neighbour queries (KD-tree replacement).

Counterpart of ``pyfocusr_tpu/ops/knn.py``: ``SENTINEL`` (:47),
``pairwise_sq_dists`` (:63), ``nn_query`` (:242), ``knn_query`` (:337),
``knn3_masked`` (:424) and ``idw_from_knn`` (:440).

Only the brute-force route is ported.  Every query goes to
``knn_kernel.knn``: the hand-written CUDA kernel for CUDA tensors, its plain
PyTorch version for CPU tensors.  The JAX package's voxel-grid route
(``ops/grid_knn.py``, reached above ~1.2e11 pairs) is not ported yet.

Distances are Euclidean (``KDTree.query`` contract); indices come back as
int64 so they index tensors directly.
"""

from __future__ import annotations

import torch

from . import knn_kernel

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


def knn_query(ref: torch.Tensor, query: torch.Tensor, k: int):
    """k nearest reference rows of each query row, ascending, ties to the
    lower index.  Returns (distances f32 [Nq, k], indices int64 [Nq, k]);
    a missing neighbour is (inf, Nr)."""
    d, i = knn_kernel.knn(
        ref.float().contiguous(), query.float().contiguous(), k
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
