"""Eigenmap sorting on the device: the sign-flip and mode-reorder that put
the two meshes' eigenvectors into corresponding order.

Counterpart of ``pyfocusr_tpu/spectral/eigsort_jax.py:30``
(``sort_eigenmaps_jit``).  The cost of matching target mode i with source
mode j is c_spatial * c_lambda * c_hist, for the straight and the flipped
source vector; the k x k assignment is solved exactly: by enumeration for
k <= 8 (``ops.assignment.exact_lap_small``), by the Jonker-Volgenant solver
from zero duals beyond (``ops.assignment._jv_device``, step budget 64 k;
the identity permutation if a row were left unassigned).  Kept from the JAX
version:

* the f32-eps clamp inside the histogram logs (``eigsort_jax.py:64``);
* the direct-difference spatial cost (``eigsort_jax.py:105-119``), not the
  matmul identity, which cancels in f32 for well-matched columns.

The column permutation is an indexing, exact like the JAX version's one-hot
matmul at HIGHEST precision.
"""

from __future__ import annotations

import torch

from ..ops.assignment import _jv_device, exact_lap_small
from ..ops.knn import nn_query
from ..ops.wasserstein import wasserstein_1d

__all__ = ["sort_eigenmaps"]


def _mean_gap(v):
    if v.shape[0] < 2:
        return torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.diff(v).mean()


def _pairwise_w1(a, b):
    """[k, k] W1 between every column of a and every column of b."""
    k = a.shape[1]
    return torch.stack(
        [torch.stack([wasserstein_1d(a[:, i], b[:, j]) for j in range(k)])
         for i in range(k)]
    )


def sort_eigenmaps(
    eig_vals_target,
    eig_vals_source,
    rand_target_eig_vecs,
    rand_source_eig_vecs,
    rand_target_points,
    rand_source_points,
    eig_vecs_to_permute,
    target_as_reference: bool = True,
):
    """Returns (sorted_eig_vecs, Q_vec).

    ``eig_vecs_to_permute``: full-resolution eigvecs of the non-reference
    mesh — the source's when ``target_as_reference`` (flipped/permuted into
    the target's mode order), the target's otherwise (assignment on Q.T)."""
    k = eig_vals_target.shape[0]
    eps = torch.finfo(torch.float32).eps

    # c_lambda, with the JAX version's guards (gap 0 -> 1, exponent <= 80).
    gap = (_mean_gap(eig_vals_target) + _mean_gap(eig_vals_source)) / 2
    gap = torch.where(gap > 0, gap, torch.ones_like(gap))
    diff = eig_vals_target[:, None] - eig_vals_source[None, :]
    c_lambda = torch.exp(torch.clamp(diff**2 / (2.0 * gap**2), max=80.0))

    # c_hist: W1 between the log-histograms of each pair of columns.
    def _log(x):
        return torch.log(torch.clamp(x + 0.5 + eps, min=eps))

    lt_r = _log(rand_target_eig_vecs)
    ls_r = _log(rand_source_eig_vecs)
    lsf_r = _log(-rand_source_eig_vecs)
    if rand_target_eig_vecs.shape[0] == rand_source_eig_vecs.shape[0]:
        lt = torch.sort(lt_r, dim=0).values
        ls = torch.sort(ls_r, dim=0).values
        lsf = torch.sort(lsf_r, dim=0).values
        c_hist = (lt[:, :, None] - ls[:, None, :]).abs().mean(dim=0)
        c_hist_f = (lt[:, :, None] - lsf[:, None, :]).abs().mean(dim=0)
    else:
        c_hist = _pairwise_w1(lt_r, ls_r)
        c_hist_f = _pairwise_w1(lt_r, lsf_r)

    # c_spatial: direct differences against each target sample's nearest
    # source sample.
    _, idx = nn_query(rand_source_points, rand_target_points)
    gathered = rand_source_eig_vecs[idx]
    n_t = rand_target_eig_vecs.shape[0]
    d_straight = rand_target_eig_vecs[:, :, None] - gathered[:, None, :]
    d_flipped = rand_target_eig_vecs[:, :, None] + gathered[:, None, :]
    c_spatial = torch.sqrt((d_straight**2).sum(dim=0)) / n_t
    c_spatial_f = torch.sqrt((d_flipped**2).sum(dim=0)) / n_t

    c = c_spatial * c_lambda * c_hist
    c_f = c_spatial_f * c_lambda * c_hist_f
    Q = torch.minimum(c, c_f)
    S = c > c_f
    if not target_as_reference:
        Q = Q.T
        S = S.T

    rows = torch.arange(k, device=Q.device)
    if k <= 8:
        src_of_tgt = exact_lap_small(Q)
    else:
        src_of_tgt, _, _, _ = _jv_device(
            Q.contiguous(), torch.zeros_like(Q[0]), 64 * k
        )
        src_of_tgt = src_of_tgt.long()
        # Safety net for the (never observed) step-budget bail.
        src_of_tgt = torch.where((src_of_tgt < 0).any(), rows, src_of_tgt)
    Q_vec = Q[rows, src_of_tgt]
    flipped = S[rows, src_of_tgt]
    # sign[col] = -1 where that permuted-side column is a flipped match.
    sign = torch.ones(k, dtype=torch.float32, device=Q.device)
    sign[src_of_tgt] = torch.where(
        flipped, -torch.ones_like(sign), torch.ones_like(sign)
    )
    vecs = (eig_vecs_to_permute * sign[None, :])[:, src_of_tgt]
    return vecs, Q_vec
