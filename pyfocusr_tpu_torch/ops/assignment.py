"""Linear assignment for tiny square costs.

Counterpart of ``pyfocusr_tpu/ops/assignment.py:509`` (``exact_lap_small``),
the k x k eigsort matching.  The Sinkhorn-warmed Jonker-Volgenant solver
behind 'hungarian' correspondences (``sinkhorn_jv_lap``, with the TPU
kernels ``_lse_rows_pallas`` and ``jv_device_pallas``) is not ported yet.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["exact_lap_small"]


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
