"""Exact k-NN of 3-D points through a uniform voxel grid, certified per row.

Counterpart of ``pyfocusr_tpu/ops/grid_knn.py:84-454``: ``_grid_prep``,
``_grid_build``, ``_estimate_dk``, ``_lower_bound_z``, ``_grid_search``,
``_grid_select``, ``knn_grid`` and ``last_stats``.

The brute-force kernel (``ops/knn_kernel.py``) costs O(Nq * Nr); between two
nearly coincident surfaces a grid makes the query O(N).  The reference
points are binned into cubic cells of side ``s`` (1.25x the median k-th
neighbour distance), sorted by cell id, and each query searches the 3x3x3
cells around its own as 9 (x, y) columns, each one run of 3 z-consecutive
cells: a dense per-column start table (bincount + cumsum) and an 8-step
binary search on z inside the column give each run's span of the sorted
array, and each run contributes at most ``cap`` candidates.

A row is exact, and kept, when the ball of radius d_k (plus a rounding
slack) around its query lies inside the searched slab on every axis (or
the slab reaches the grid's edge on that side), no run overflowed its cap,
every searched column was short enough for the binary search (< 256 rows)
and k finite candidates were found.  The other rows get a second pass with
cells and cap doubled, and what remains goes to the brute-force kernel.

The result equals the brute-force kernel's bit for bit: each candidate's
squared distance is summed over dimensions in order with the product and
the sum rounded separately, as ``knn_kernel.knn_plain`` does, and the top k
are taken lexicographically in (squared distance, index), k passes; the
slack keeps a point outside the slab from tying the k-th distance in f32.
So the route a query takes changes no bit of its answer.

The JAX package's TPU workarounds are left out: candidate coordinates and
indices are gathered as they are (no index packed in an f32 mantissa), and
chunks and fallback rows are not padded to powers of two.  Chunks of
``_CHUNK`` query rows bound the candidate arrays' memory.  The grid is plain
PyTorch, as it is XLA (not Pallas) in the JAX package.

The k-th neighbour distance is estimated as the JAX package does, from up
to 4096 strided sample rows, but against the reference rows that are not
sampled (thinned to at most 262144, with the 2-manifold density correction
sqrt(kept / all)): the JAX package asks the brute kernel for k + 1
neighbours to step over each sample's own row; leaving the sample rows out
of the references does the same with k.

Reference rows with a non-finite coordinate or one at or above 1e29 in
magnitude (``ops.knn.SENTINEL``) are never candidates, as in the kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import spans
from . import knn_kernel

__all__ = ["knn_grid", "last_stats"]

# The most recent knn_grid call: sizes, cell size, grid dims, rows left
# after pass 1, rows sent to the brute-force kernel and their fraction.
last_stats: dict = {}

_VALID_LIMIT = 1e29
# Cell side over the median k-th neighbour distance; candidates a run may
# hold (pass 2 doubles both).
_S_MULT = 1.25
_RUN_CAP = 12
# Unrolled binary-search steps inside a column: converges for spans up to
# 255 rows; a row that searches a longer column is not certified.
_ZSEARCH_STEPS = 8
_MAX_COL = 1 << _ZSEARCH_STEPS
# Query rows a chunk (its candidate arrays: ~1.3 KB a row at cap 12).
_CHUNK = 1 << 18
# Grid caps: cells in all and (x, y) columns of the dense start table.
_MAX_CELLS = 2 ** 30
_MAX_COLS = 2 ** 23
_INT64_MAX = torch.iinfo(torch.int64).max
# Relative rounding slack of the certificate, in units of the coordinates'
# magnitude and of d_k: a few f32 ulps of the cell, boundary and distance
# arithmetic.
_SLACK = 2e-6
# Sample rows and the reference size of the d_k estimate.
_SAMPLE = 4096
_SAMPLE_REF = 262144


def _prep(ref):
    """Validity mask, coordinates with non-finite values at 1e29, and the
    bounding box of the valid rows."""
    finite = (torch.isfinite(ref) & (ref.abs() < _VALID_LIMIT)).all(dim=1)
    big = torch.full_like(ref, _VALID_LIMIT)
    ref_clean = torch.where(torch.isfinite(ref), ref, big)
    lo = torch.where(finite[:, None], ref_clean, big).min(dim=0).values
    hi = torch.where(finite[:, None], ref_clean, -big).max(dim=0).values
    return finite, ref_clean, lo, hi


def _cells(points, lo, s, dims):
    """Cell coordinates int64 [n, 3] of ``points``, clipped to the grid (a
    NaN coordinate lands in cell 0)."""
    c = torch.floor((points - lo[None, :]) / s)
    c = torch.where(torch.isnan(c), torch.zeros_like(c), c)
    return torch.minimum(torch.clamp(c, min=0.0), (dims - 1).to(c.dtype)[None, :]).long()


def _build(ref_clean, finite, lo, s, dims, n_cols: int):
    """Sort the valid rows by cell id and build the dense column start table
    (bincount + cumsum).  Returns (sorted z-cells, sorted points, their
    original indices, column starts)."""
    cell = _cells(ref_clean, lo, s, dims)
    colid = cell[:, 0] * dims[1] + cell[:, 1]
    cid = torch.where(finite, colid * dims[2] + cell[:, 2],
                      torch.full_like(colid, _INT64_MAX))
    order = torch.argsort(cid, stable=True)
    sorted_cz = torch.where(finite, cell[:, 2],
                            torch.full_like(colid, _INT64_MAX))[order]
    cols = torch.where(finite, colid, torch.full_like(colid, n_cols))
    with spans.host_read("grid_bincount", 2):  # its least and largest id, read back
        counts = torch.bincount(cols, minlength=n_cols + 1)[:n_cols]
    colstart = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return sorted_cz, ref_clean[order], order, colstart


def _lower_bound_z(sorted_cz, lo0, hi0, target):
    """First position in [lo0, hi0) whose z-cell is >= target, by an
    unrolled binary search (exact for spans up to 2^steps - 1)."""
    lo, hi = lo0, hi0
    m_max = sorted_cz.shape[0] - 1
    for _ in range(_ZSEARCH_STEPS):
        mid = (lo + hi) >> 1
        less = sorted_cz[torch.clamp(mid, max=m_max)] < target
        active = lo < hi
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


_OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


def _search(sorted_cz, colstart, query, lo, s, dims):
    """Per query: its cell, the spans [start, end) of its 9 column runs in
    the sorted order, and whether a searched column is too long."""
    cell = _cells(query, lo, s, dims)
    with spans.host_read("grid_copy"):
        offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=query.device)
    rx = cell[:, 0, None] + offs[None, :, 0]  # [n, 9]
    ry = cell[:, 1, None] + offs[None, :, 1]
    ok = (rx >= 0) & (rx < dims[0]) & (ry >= 0) & (ry < dims[1])
    colid = torch.where(ok, rx * dims[1] + ry, torch.zeros_like(rx))
    c_lo = torch.where(ok, colstart[colid], torch.zeros_like(rx))
    c_hi = torch.where(ok, colstart[colid + 1], torch.zeros_like(rx))
    col_too_long = (c_hi - c_lo >= _MAX_COL).any(dim=1)
    cz = cell[:, 2, None]
    start = _lower_bound_z(sorted_cz, c_lo, c_hi, cz - 1)
    end = _lower_bound_z(sorted_cz, start, c_hi, cz + 2)
    return cell, start, end, col_too_long


def _select(sorted_pts, sorted_idx, query, cell, start, end, col_too_long,
            lo, s, dims, k: int, cap: int, coord_scale: float):
    """Gather each query's candidates, take the lexicographic top k and
    certify the row.  Returns (d2 [n, k], idx int64 [n, k], exact [n])."""
    n = query.shape[0]
    counts = end - start
    pos = start[:, :, None] + torch.arange(cap, device=query.device)[None, None, :]
    valid = (pos < end[:, :, None]).reshape(n, 9 * cap)
    posc = torch.clamp(pos, max=sorted_pts.shape[0] - 1).reshape(n, 9 * cap)
    cpts = sorted_pts[posc]  # [n, 9 cap, 3]
    with spans.host_read("grid_copy"):
        inf = torch.tensor(float("inf"), device=query.device)
    # As knn_plain: per dimension in order, product and sum rounded apart.
    d2 = torch.zeros((n, 9 * cap), dtype=torch.float32, device=query.device)
    for c in range(3):
        diff = query[:, c, None] - cpts[:, :, c]
        d2 = d2 + diff * diff
    d2 = torch.where(valid & ~torch.isnan(d2), d2, inf)
    idx = torch.where(valid, sorted_idx[posc], torch.full_like(posc, _INT64_MAX))

    # k passes of the (d2, index) minimum, the kernel's tie rule.  A
    # reference row sits in at most one run, so (m, mi) names one slot.
    d_out, i_out = [], []
    for _ in range(k):
        m = d2.min(dim=1).values
        at_m = d2 == m[:, None]
        mi = torch.where(at_m, idx, torch.full_like(idx, _INT64_MAX)).min(dim=1).values
        d_out.append(m)
        i_out.append(mi)
        d2 = torch.where(at_m & (idx == mi[:, None]), inf, d2)
    d2k = torch.stack(d_out, dim=1)
    idxk = torch.stack(i_out, dim=1)

    dk = torch.sqrt(d2k[:, k - 1])
    slack = _SLACK * (coord_scale + query.abs().amax(dim=1) + dk)
    reach = (dk + slack)[:, None]
    cellf = cell.to(query.dtype)
    left = torch.where(cell <= 0, -inf, lo[None, :] + (cellf - 1.0) * s)
    right = torch.where(cell >= dims[None, :] - 1, inf, lo[None, :] + (cellf + 2.0) * s)
    contained = ((query - reach >= left) & (query + reach <= right)).all(dim=1)
    overflow = (counts > cap).any(dim=1)
    enough = torch.clamp(counts, max=cap).sum(dim=1) >= k
    exact = (contained & enough & ~overflow & ~col_too_long
             & torch.isfinite(dk) & (d2k[:, k - 1] < _VALID_LIMIT))
    return d2k, idxk, exact


def _estimate_dk(ref_clean, finite_np, brute, k: int) -> float:
    """Median k-th neighbour distance of the valid rows: up to 4096 strided
    sample rows against the rows not sampled (thinned to 262144 at most),
    scaled by the 2-manifold density correction sqrt(kept / all)."""
    m = ref_clean.shape[0]
    q_idx = np.arange(0, m, max(m // _SAMPLE, 2))[:_SAMPLE]
    q_ok = finite_np[q_idx]
    rest = np.ones(m, bool)
    rest[q_idx] = False
    r_idx = np.nonzero(rest)[0]
    r_idx = r_idx[:: max(math.ceil(len(r_idx) / _SAMPLE_REF), 1)]
    kept = int(finite_np[r_idx].sum())
    if not q_ok.any() or kept < k:
        return 0.0
    corr = math.sqrt(kept / max(int(finite_np.sum()), 1))
    dev = ref_clean.device
    with spans.host_read("grid_copy", 2):
        r_rows, q_rows = torch.from_numpy(r_idx).to(dev), torch.from_numpy(q_idx).to(dev)
    d, _ = brute(ref_clean[r_rows].contiguous(), ref_clean[q_rows].contiguous(), k)
    with spans.host_read("grid_read"):
        d = d.cpu()
    dk = d.numpy()[q_ok][:, k - 1]
    dk = dk[np.isfinite(dk) & (dk > 0)]
    return float(np.median(dk)) * corr if dk.size else 0.0


def _set_stats(**kw):
    last_stats.clear()
    last_stats.update(kw)


def knn_grid(ref: torch.Tensor, query: torch.Tensor, k: int, brute=None):
    """Exact k nearest rows of ``ref`` (f32 [Nr, 3]) for each row of
    ``query`` (f32 [Nq, 3]) through the voxel grid, uncertified rows by
    ``brute(ref, query, k)`` (default ``knn_kernel.knn``: the CUDA kernel
    on the card, its plain version on the CPU).  The contract of
    ``knn_kernel``: ascending, ties to the lower index, (inf, Nr) for a
    missing neighbour; Euclidean distances f32 and indices int32, each
    [Nq, k], equal to the brute-force kernel's bit for bit.  Reads back to
    the host only the validity and exactness masks and a few scalars."""
    if brute is None:
        brute = knn_kernel.knn
    m, nq = ref.shape[0], query.shape[0]
    stats = dict(n_ref=m, n_query=nq, k=k, cell_size=0.0, dims=(0, 0, 0),
                 pass1_unresolved=0, fallback_rows=nq,
                 fallback_fraction=1.0 if nq else 0.0)
    if nq == 0:
        _set_stats(**stats)
        return (torch.zeros((0, k), dtype=torch.float32, device=query.device),
                torch.zeros((0, k), dtype=torch.int32, device=query.device))
    finite, ref_clean, lo, hi = _prep(ref)
    with spans.host_read("grid_read"):
        finite_np = finite.cpu().numpy()
    dk_est = 0.0
    if int(finite_np.sum()) >= max(k, 8):
        dk_est = _estimate_dk(ref_clean, finite_np, brute, k)
    if not (dk_est > 0.0 and np.isfinite(dk_est)):
        _set_stats(**stats)
        return brute(ref, query, k)

    lo_d, hi_d = lo.double(), hi.double()
    with spans.host_read("grid_read", 2):
        lo_np, hi_np = lo_d.cpu().numpy(), hi_d.cpu().numpy()
    ext = hi_np - lo_np
    coord_scale = float(np.abs(np.concatenate([lo_np, hi_np])).max())
    cap1 = max(_RUN_CAP, 2 * k + 6)

    def run_pass(q_sub, s_want, cap):
        """One grid build and a certified query pass over ``q_sub``."""
        s_val = s_want
        dims_np = np.maximum(np.floor(ext / s_val).astype(np.int64) + 1, 1)
        if int(dims_np.prod()) > _MAX_CELLS:
            s_val *= (int(dims_np.prod()) / _MAX_CELLS) ** (1.0 / 3.0)
            dims_np = np.maximum(np.floor(ext / s_val).astype(np.int64) + 1, 1)
        if int(dims_np[0] * dims_np[1]) > _MAX_COLS:
            s_val *= math.sqrt(int(dims_np[0] * dims_np[1]) / _MAX_COLS)
            dims_np = np.maximum(np.floor(ext / s_val).astype(np.int64) + 1, 1)
        with spans.host_read("grid_copy", 2):
            dims = torch.from_numpy(dims_np).to(query.device)
            s_t = torch.tensor(s_val, dtype=torch.float32, device=query.device)
        sorted_cz, sorted_pts, sorted_idx, colstart = _build(
            ref_clean, finite, lo, s_t, dims, int(dims_np[0] * dims_np[1]))
        parts = []
        for s0 in range(0, q_sub.shape[0], _CHUNK):
            q_c = q_sub[s0:s0 + _CHUNK]
            cell, start, end, too_long = _search(sorted_cz, colstart, q_c, lo, s_t, dims)
            parts.append(_select(sorted_pts, sorted_idx, q_c, cell, start, end,
                                 too_long, lo, s_t, dims, k, cap, coord_scale))
        d2, idx, exact = (torch.cat(p) for p in zip(*parts))
        return d2, idx, exact, s_val, dims_np

    # Pass 1: cells sized to the typical k-th neighbour distance.
    d2, idx, exact, s_real, dims_np = run_pass(query, _S_MULT * dk_est, cap1)
    with spans.host_read("grid_read"):
        fb1 = np.nonzero(~exact.cpu().numpy())[0]
    fb = fb1
    if fb1.size:
        # Pass 2: sparse patches and dense spots, with 2x cells and cap.
        with spans.host_read("grid_copy"):
            rows = torch.from_numpy(fb1).to(query.device)
        d2b, idxb, exactb, _, _ = run_pass(query[rows], 2.0 * s_real, 2 * cap1)
        with spans.host_read("grid_read"):
            ex2 = exactb.cpu().numpy()
        with spans.host_read("grid_copy"):
            good = torch.from_numpy(np.nonzero(ex2)[0]).to(query.device)
        d2[rows[good]] = d2b[good]
        idx[rows[good]] = idxb[good]
        fb = fb1[~ex2]
    _set_stats(n_ref=m, n_query=nq, k=k, cell_size=float(s_real),
               dims=tuple(int(x) for x in dims_np), pass1_unresolved=int(fb1.size),
               fallback_rows=int(fb.size), fallback_fraction=float(fb.size) / nq)
    dists = torch.sqrt(torch.clamp(d2, min=0.0))
    idx = idx.to(torch.int32)
    if fb.size:
        with spans.host_read("grid_copy"):
            rows = torch.from_numpy(fb).to(query.device)
        d_fb, i_fb = brute(ref, query[rows].contiguous(), k)
        dists[rows] = d_fb
        idx[rows] = i_fb
    return dists, idx
