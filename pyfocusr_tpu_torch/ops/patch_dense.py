"""Patch-dense Laplacian filter operator: dense 128 x 128 blocks for the
edges inside BFS patches and a compacted residual for the edges between
them.

Counterpart of ``pyfocusr_tpu/ops/patch_dense.py``: ``BLOCK``,
``PATCH_DENSE_MAX_N`` and ``DR_MAX`` (:48-62), ``build_patch_plan`` (:64,
the host BFS blocking, copied so that both packages build the same plan
array for array) and ``patch_filter_factory`` (:204).

The vertices are grouped into BFS patches of ``BLOCK`` = 128 and renumbered
patch by patch.  The edges inside a patch become P dense [128, 128] blocks,
applied to the [N, b] filter block as one batched product (``torch.bmm``,
under the callers' TF32-off setting: the JAX package computes the same
product as an XLA einsum at HIGHEST precision, outside any Pallas kernel).
The edges between patches (about 14% on bone meshes) form a residual over
the boundary rows only, [Nb, Dr] column and weight tables, applied as one
[Nb * Dr] row gather and one batched product, and added back through the
``exp_idx`` row gather.  The plan is built on the host once per mesh and
carried as ``GraphArrays.patch_plan``; ``pipeline._spectrum`` takes it for
the wide Chebyshev filter when the graph carries one and lies on the CPU.
On a CUDA device every wide solve takes the ELL operator's fused step
instead (``ops/cheb_step_kernel.py``, one launch a step that moves only the
three blocks): the dense blocks, built for the TPU's matrix unit, hold ~6
nonzeros a row of 128, and on the H100 in f32 their product alone costs as
long as that step's whole memory traffic.  The plan is gated to
2 * 128 <= N <= ``PATCH_DENSE_MAX_N`` and a residual width of at most
``DR_MAX``, the JAX package's gates.

A step is seven launches on a CUDA device (eight with the recurrence's
subtraction): the permutation gather, the block product, the residual
gather, the residual product, the ``exp_idx`` gather, its subtraction and
the inverse-permutation gather; ``chip_smoke.py`` still times it there
beside the fused step.  The diagonal
and the 2/e scale are folded into the blocks and the residual weights once
per ``factory(c, e)`` call (once per chunk of the wide solver), so the
step does no elementwise pass of its own; this regroups f32 sums only.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

__all__ = ["build_patch_plan", "patch_filter_factory", "plan_to", "PATCH_DENSE_MAX_N",
           "BLOCK", "DR_MAX"]

BLOCK = 128
# Above this the dense blocks cost more than ~128 MB (N / 128 x 64 KB).
PATCH_DENSE_MAX_N = 150_000
# Residual-width cap: a hub whose cross-patch degree is large (the 122k
# UV-sphere pair's poles reach ~350 through overflow edges) makes the
# residual as wide as the hub, so such meshes keep the ELL operator
# (build_patch_plan returns None).  Organic surface meshes sit at Dr <= 8.
DR_MAX = 16


def build_patch_plan(neighbors, nbr_mask, overflow=None, block: int = BLOCK):
    """Host-side patch plan for :func:`patch_filter_factory`, the JAX
    package's (``pyfocusr_tpu/ops/patch_dense.py:64-201``) array for array.

    ``neighbors`` int [N, D], ``nbr_mask`` [N, D] (0 = padding slot),
    ``overflow`` int [E_o, 2] hub spill edges (src == dst rows are
    padding); numpy arrays or tensors.  Returns a dict of numpy arrays
    (int32 indices, ``perm_valid`` f32), or None when N is outside
    [2 * block, PATCH_DENSE_MAX_N] or the residual is wider than
    ``DR_MAX``.  The partition grows a BFS patch from the first unassigned
    vertex until it has ``block`` members, and repeats."""
    neighbors = _host(neighbors)
    nbr_mask = _host(nbr_mask)
    n, D = neighbors.shape
    if n < 2 * block or n > PATCH_DENSE_MAX_N:
        return None

    real = nbr_mask > 0
    adj = [neighbors[i][real[i]] for i in range(n)]
    patch = np.full(n, -1, np.int32)
    order = []
    pid = 0
    for seed in range(n):
        if patch[seed] >= 0:
            continue
        q = deque([seed])
        count = 0
        while q and count < block:
            v = q.popleft()
            if patch[v] >= 0:
                continue
            patch[v] = pid
            order.append(v)
            count += 1
            for u in adj[v]:
                if patch[u] < 0:
                    q.append(u)
        pid += 1
    perm = np.asarray(order, np.int64)  # new -> old
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    npad = (n + block - 1) // block * block

    # ELL entries in the new numbering.
    nbr_new = inv[neighbors][perm]
    real_new = real[perm]
    same = (nbr_new // block) == (np.arange(n) // block)[:, None]
    intra = same & real_new
    cross = (~same) & real_new
    rows_new = np.repeat(np.arange(n), D).reshape(n, D)
    # Flat index into concat(sw.flat [old], ov_sw, [0]): ELL entry
    # (old_row, slot) -> old_row * D + slot.
    src_flat_ell = perm[:, None] * D + np.arange(D)[None, :]

    ov_intra = ov_cross = None
    n_ov = 0
    if overflow is not None:
        overflow = _host(overflow)
        n_ov = overflow.shape[0]
    if n_ov:
        ov_real = overflow[:, 0] != overflow[:, 1]
        ov_src_new = inv[overflow[:, 0]]
        ov_dst_new = inv[overflow[:, 1]]
        ov_same = (ov_src_new // block) == (ov_dst_new // block)
        ov_intra = ov_real & ov_same
        ov_cross = ov_real & ~ov_same

    zero_slot = n * D + n_ov  # the appended exact-zero value

    # Dense intra blocks: scatter destinations and value sources.
    dst = (rows_new[intra] // block) * block * block \
        + (rows_new[intra] % block) * block + (nbr_new[intra] % block)
    srcv = src_flat_ell[intra]
    if n_ov and ov_intra.any():
        dst = np.concatenate([
            dst,
            (ov_src_new[ov_intra] // block) * block * block
            + (ov_src_new[ov_intra] % block) * block
            + (ov_dst_new[ov_intra] % block),
        ])
        srcv = np.concatenate([srcv, n * D + np.where(ov_intra)[0]])

    # Residual: the boundary rows, ragged -> [Nb, Dr].
    cross_deg = cross.sum(1).astype(np.int64)
    if n_ov and ov_cross.any():
        np.add.at(cross_deg, ov_src_new[ov_cross], 1)
    bnd = np.where(cross_deg > 0)[0]
    Nb = len(bnd)
    Dr = int(cross_deg[bnd].max()) if Nb else 1
    if Dr > DR_MAX:
        return None
    res_cols = np.zeros((max(Nb, 1), Dr), np.int64)
    res_src = np.full((max(Nb, 1), Dr), zero_slot, np.int64)
    pos_of = np.full(n, -1, np.int64)
    pos_of[bnd] = np.arange(Nb)
    # np.where lists entries row-major, so a row's slot is its offset from
    # the row's first entry.
    cr, cs = np.where(cross)
    j_idx = np.arange(len(cr)) - np.searchsorted(cr, cr)
    res_cols[pos_of[cr], j_idx] = nbr_new[cr, cs]
    res_src[pos_of[cr], j_idx] = src_flat_ell[cr, cs]
    if n_ov and ov_cross.any():
        base = cross.sum(1).astype(np.int64)  # ELL cross entries per row
        oe = np.where(ov_cross)[0]
        r_ov = ov_src_new[oe]
        order = np.argsort(r_ov, kind="stable")
        oe, r_ov = oe[order], r_ov[order]
        j_ov = base[r_ov] + (np.arange(len(oe)) - np.searchsorted(r_ov, r_ov))
        res_cols[pos_of[r_ov], j_ov] = ov_dst_new[oe]
        res_src[pos_of[r_ov], j_ov] = n * D + oe
    # Row -> its residual row; rows without cross edges -> Nb, the
    # appended zero row.
    exp_idx = np.full(npad, Nb, np.int64)
    exp_idx[bnd] = np.arange(Nb)

    perm_pad = np.zeros(npad, np.int64)
    perm_pad[:n] = perm
    valid_new = np.zeros(npad, np.float32)
    valid_new[:n] = 1.0
    return {
        "perm": perm_pad.astype(np.int32),       # [npad] new -> old (pad -> 0)
        "perm_valid": valid_new,                 # [npad]
        "inv_perm": inv.astype(np.int32),        # [n] old -> new
        "intra_dst": dst.astype(np.int32),       # [E_i] flat into [P * B * B]
        "intra_src": srcv.astype(np.int32),      # [E_i] flat into the values
        "res_cols": res_cols.astype(np.int32),   # [Nb, Dr] new-space rows
        "res_src": res_src.astype(np.int32),     # [Nb, Dr] flat into the values
        "exp_idx": exp_idx.astype(np.int32),     # [npad]
    }


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plan_to(plan, device):
    """A plan (numpy arrays or tensors) as tensors on ``device``: indices
    int64, ``perm_valid`` f32.  None stays None."""
    if plan is None:
        return None
    out = {}
    for name, v in plan.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        dtype = torch.float32 if t.is_floating_point() else torch.int64
        out[name] = t.to(dtype=dtype, device=device)
    return out


def patch_filter_factory(plan, sw, ov_sw, sd, mask):
    """Chebyshev filter-op factory over the patch-dense operator.

    ``plan``: tensors of :func:`build_patch_plan` on the operands' device
    (:func:`plan_to`).  ``sw`` f32 [N, D] symmetrized edge weights,
    ``ov_sw`` [E_o] overflow weights (None or empty without overflow
    edges), ``sd`` [N] symmetrized diagonal, ``mask`` [N] valid mask.
    Returns ``factory(c, e) -> op`` where ``op(T)`` applies
    ``(2/e) (A - c I)`` on the masked subspace, ``A x = sd x - W_sym x``:
    the operator of the ELL factory in ``pipeline._spectrum`` with its f32
    sums regrouped (dense 128-long dot products for the intra-patch
    edges).  The blocks and residual weights are built once here and
    shared by every chunk's ``factory(c, e)``."""
    n, D = sw.shape
    perm = plan["perm"]
    npad = perm.shape[0]
    P = npad // BLOCK
    Nb, Dr = plan["res_cols"].shape
    dev, dt = sw.device, sw.dtype

    # The value vector: ELL weights, overflow weights, an exact zero.
    parts = [sw.reshape(-1)]
    if ov_sw is not None and ov_sw.numel():
        parts.append(ov_sw.reshape(-1))
    parts.append(torch.zeros((1,), dtype=dt, device=dev))
    vals = torch.cat(parts)
    W = torch.zeros((P * BLOCK * BLOCK,), dtype=dt, device=dev)
    W.index_add_(0, plan["intra_dst"], -vals[plan["intra_src"]])
    W = W.view(P, BLOCK, BLOCK)
    res_w = vals[plan["res_src"]]  # [Nb, Dr]
    sd_new = (sd[perm] * plan["perm_valid"]).view(P, BLOCK)
    mask_new = (mask[perm] * plan["perm_valid"]).view(P, BLOCK)
    res_cols = plan["res_cols"].reshape(-1)
    exp_idx = plan["exp_idx"]
    inv_perm = plan["inv_perm"]
    eye = torch.eye(BLOCK, dtype=dt, device=dev)

    def factory(c, e):
        alpha = 2.0 / e
        # alpha (W + diag(sd - c mask)) per patch, and alpha times the
        # residual weights: the step then runs no elementwise pass.
        blocks = alpha * (W + (sd_new - c * mask_new)[:, :, None] * eye)
        res_wa = (alpha * res_w).unsqueeze(1)  # [Nb, 1, Dr]
        # The residual rows and the zero row after them, one buffer per
        # block width; each step overwrites the first Nb rows.
        rz_of = {}

        def op(T):
            b = T.shape[1]
            Tn = T.index_select(0, perm)  # into patch order
            yd = torch.bmm(blocks, Tn.view(P, BLOCK, b)).view(npad, b)
            if Nb:
                rz = rz_of.get(b)
                if rz is None:
                    rz = rz_of[b] = torch.zeros((Nb + 1, b), dtype=dt, device=dev)
                g = Tn.index_select(0, res_cols).view(Nb, Dr, b)
                torch.bmm(res_wa, g, out=rz[:Nb].view(Nb, 1, b))
                yd = yd - rz.index_select(0, exp_idx)
            return yd.index_select(0, inv_perm)

        return op

    return factory
