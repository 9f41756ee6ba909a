"""Exact 1-D Wasserstein (earth mover's) distance.

Counterpart of ``pyfocusr_tpu/ops/wasserstein.py:23`` (``wasserstein_1d``):
the L1 distance between the empirical quantile functions, from sorted
samples — mean |sort(u) - sort(v)| for equal sizes, the merged-CDF integral
(scipy's algorithm) otherwise.
"""

from __future__ import annotations

import torch

__all__ = ["wasserstein_1d"]


def wasserstein_1d(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """W1 between empirical samples u [Nu] and v [Nv] (uniform weights)."""
    us = torch.sort(u).values
    vs = torch.sort(v).values
    if u.shape[0] == v.shape[0]:
        return (us - vs).abs().mean()
    allv = torch.sort(torch.cat([us, vs])).values
    deltas = torch.diff(allv)
    cdf_u = torch.searchsorted(us, allv[:-1], right=True) / u.shape[0]
    cdf_v = torch.searchsorted(vs, allv[:-1], right=True) / v.shape[0]
    return ((cdf_u - cdf_v).abs() * deltas).sum()
