"""Eigenmap alignment for the class API: sign-flip and reorder the source
eigenvectors to match the target's (or the reverse), the assignment solved
on the host.

Counterpart of ``pyfocusr_tpu/spectral/eigsort.py``: ``_c_lambda`` (:41),
``_c_hist_pair`` (:49), ``_c_spatial_pair`` (:79), ``sort_eigenmaps_fn``
(:96) and the class ``eigsort`` (:180) with its cost attributes and the
match/flip report it prints.  The three cost factors are tensor operations
on the device of the eigenvectors (the spatial one through the k-NN kernel
on the card); the k x k assignment is ``ops.assignment.lap_host``.  The
pipeline's eigsort, which keeps the assignment on the device, is
``spectral/eigsort_device.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.assignment import lap_host
from ..ops.knn import nn_query
from ..utils.logging import print_header
from .eigsort_device import _mean_gap, _pairwise_w1

__all__ = ["eigsort", "sort_eigenmaps_fn"]

# The JAX module's clamp of the histogram logs: the f64 epsilon, applied to
# f32 values.
_EPS = float(np.finfo(np.float64).eps)


def _c_lambda(eig_vals_target, eig_vals_source, gap):
    """exp((lt_i - ls_j)^2 / (2 gap^2)), the exponent clamped at 80."""
    diff = eig_vals_target[:, None] - eig_vals_source[None, :]
    return torch.exp(torch.clamp(diff**2 / (2.0 * gap**2), max=80.0))


def _c_hist_pair(t_vecs, s_vecs):
    """W1 between the log-shifted eigenvector samples t_vecs [Nt, k] and
    s_vecs [Ns, k], straight and with the source flipped: (c_hist [k, k],
    c_hist_f [k, k])."""
    def log(x):
        return torch.log(torch.clamp(x + 0.5 + _EPS, min=_EPS))

    lt, ls, ls_f = log(t_vecs), log(s_vecs), log(-s_vecs)
    if t_vecs.shape[0] == s_vecs.shape[0]:
        st = torch.sort(lt, dim=0).values
        ss = torch.sort(ls, dim=0).values
        ssf = torch.sort(ls_f, dim=0).values
        return ((st[:, :, None] - ss[:, None, :]).abs().mean(dim=0),
                (st[:, :, None] - ssf[:, None, :]).abs().mean(dim=0))
    return _pairwise_w1(lt, ls), _pairwise_w1(lt, ls_f)


def _c_spatial_pair(t_vecs, s_vecs, t_points_norm, s_points_norm):
    """RMS eigenvector difference over each target sample's nearest source
    sample in normalized xyz, direct differences: (c_spatial, c_spatial_f)."""
    _, idx = nn_query(s_points_norm, t_points_norm)
    gathered = s_vecs[idx]
    n_t = t_vecs.shape[0]
    d = t_vecs[:, :, None] - gathered[:, None, :]
    d_f = t_vecs[:, :, None] + gathered[:, None, :]
    return (torch.sqrt((d * d).sum(dim=0)) / n_t,
            torch.sqrt((d_f * d_f).sum(dim=0)) / n_t)


def sort_eigenmaps_fn(eig_vals_target, eig_vals_source, rand_target_eig_vecs,
                      rand_source_eig_vecs, rand_target_points, rand_source_points,
                      eig_vecs_to_permute, target_as_reference: bool = True):
    """Returns (permuted and flipped eig_vecs_to_permute, Q [k], info): the
    cost c = c_spatial c_lambda c_hist and its flipped twin, Q = min of the
    two, the assignment on Q (Q^T without ``target_as_reference``), the
    matched columns flipped where the flipped cost won and permuted into
    the reference's order.  ``info`` holds the matches, the flips and every
    cost matrix (numpy)."""
    gap = (_mean_gap(eig_vals_target) + _mean_gap(eig_vals_source)) / 2.0
    gap = torch.where(gap > 0, gap, torch.ones_like(gap))
    c_lambda = _c_lambda(eig_vals_target, eig_vals_source, gap)
    c_hist, c_hist_f = _c_hist_pair(rand_target_eig_vecs, rand_source_eig_vecs)
    c_spatial, c_spatial_f = _c_spatial_pair(
        rand_target_eig_vecs, rand_source_eig_vecs, rand_target_points,
        rand_source_points)

    c = (c_spatial * c_lambda * c_hist).cpu().numpy()
    c_f = (c_spatial_f * c_lambda * c_hist_f).cpu().numpy()
    Q = np.minimum(c, c_f)
    S = c > c_f  # where the flipped pairing is better
    if target_as_reference:
        target_matches, source_matches = lap_host(Q)
        flip_side, perm_from, perm_to = source_matches, source_matches, target_matches
    else:
        source_matches, target_matches = lap_host(Q.T)
        flip_side, perm_from, perm_to = target_matches, target_matches, source_matches
    flipped = S[target_matches, source_matches]

    vecs = eig_vecs_to_permute
    sign = np.ones(vecs.shape[1], np.float32)
    sign[flip_side[flipped]] = -1.0
    perm = np.arange(vecs.shape[1])
    perm[perm_to] = perm_from  # new[:, to] = old[:, from]
    vecs = (vecs * torch.as_tensor(sign, device=vecs.device)[None, :])[
        :, torch.as_tensor(perm, device=vecs.device)]
    info = {
        "target_matches": target_matches,
        "source_matches": source_matches,
        "flipped": flipped,
        "c": c,
        "c_f": c_f,
        "Q_full": Q,
        "c_lambda": c_lambda.cpu().numpy(),
        "c_hist": c_hist.cpu().numpy(),
        "c_hist_f": c_hist_f.cpu().numpy(),
        "c_spatial": c_spatial.cpu().numpy(),
        "c_spatial_f": c_spatial_f.cpu().numpy(),
    }
    Q_vec = torch.as_tensor(Q[target_matches, source_matches].astype(np.float32),
                            device=vecs.device)
    return vecs, Q_vec, info


class eigsort:
    """The reference class's contract: holds the two graphs, exposes the
    cost matrices as attributes, and ``sort_eigenmaps()`` replaces the
    non-reference graph's ``eig_vecs`` with the sorted ones and returns Q.
    Works on the device of the graphs' tensors."""

    def __init__(self, graph_target, graph_source, n_features, target_as_reference=True):
        self.graph_target = graph_target
        self.graph_source = graph_source
        self.n_features = n_features
        self.target_as_reference = target_as_reference

        self.rand_target_points = graph_target.get_rand_normalized_points()
        self.rand_source_points = graph_source.get_rand_normalized_points()
        self.rand_target_eig_vecs = graph_target.get_rand_eig_vecs()[:, :n_features]
        self.rand_source_eig_vecs = graph_source.get_rand_eig_vecs()[:, :n_features]

        self.c_lambda = None
        self.c_hist = None
        self.c_hist_f = None
        self.c_spatial = None
        self.c_spatial_f = None
        self.Q = None

    def calc_c_lambda(self):
        lt = self.graph_target.eig_vals[: self.n_features]
        ls = self.graph_source.eig_vals[: self.n_features]
        gap = float((_mean_gap(lt) + _mean_gap(ls)) / 2.0)
        self.c_lambda = _c_lambda(lt, ls, gap if gap > 0 else 1.0).cpu().numpy()
        return self.c_lambda

    def calc_c_hist(self):
        c, cf = _c_hist_pair(self.rand_target_eig_vecs, self.rand_source_eig_vecs)
        self.c_hist, self.c_hist_f = c.cpu().numpy(), cf.cpu().numpy()
        return self.c_hist

    def calc_c_spatial(self):
        c, cf = _c_spatial_pair(self.rand_target_eig_vecs, self.rand_source_eig_vecs,
                                self.rand_target_points, self.rand_source_points)
        self.c_spatial, self.c_spatial_f = c.cpu().numpy(), cf.cpu().numpy()
        return self.c_spatial

    def eigen_sort(self):
        """The reference's method name: the whole sort."""
        return self.sort_eigenmaps()

    def sort_eigenmaps(self):
        vecs_in = (self.graph_source.eig_vecs if self.target_as_reference
                   else self.graph_target.eig_vecs)
        vecs_out, Q_vec, info = sort_eigenmaps_fn(
            self.graph_target.eig_vals[: self.n_features],
            self.graph_source.eig_vals[: self.n_features],
            self.rand_target_eig_vecs,
            self.rand_source_eig_vecs,
            self.rand_target_points,
            self.rand_source_points,
            vecs_in,
            target_as_reference=self.target_as_reference,
        )
        self.c = info["c"]
        self.c_f = info["c_f"]
        self.c_lambda = info["c_lambda"]
        self.c_hist = info["c_hist"]
        self.c_hist_f = info["c_hist_f"]
        self.c_spatial = info["c_spatial"]
        self.c_spatial_f = info["c_spatial_f"]
        self.Q = Q_vec
        if self.target_as_reference:
            self.graph_source.eig_vecs = vecs_out
        else:
            self.graph_target.eig_vecs = vecs_out

        print_header("Eigenvector Sorting Results")
        ref_name = "target" if self.target_as_reference else "source"
        print(f"Using {ref_name} eigenmaps as the reference")
        print("The matches for eigenvectors were as follows:")
        print("Target\t|  Source")
        for t, s, fl in zip(info["target_matches"], info["source_matches"],
                            info["flipped"]):
            sv, tv = str(s), str(t)
            if fl:
                if self.target_as_reference:
                    sv = "-" + sv
                else:
                    tv = "-" + tv
            print("{:6}\t|  {:6}".format(tv, sv))
        print("*Negative source values means those eigenvectors were flipped*\n ")
        return self.Q
