"""The fine-level refine of ONE pair, vertex-sharded over a device mesh.

Counterpart of ``pyfocusr_tpu/parallel/bigmesh.py``:
``pad_rows_for_sharding`` (:65), ``partition_overflow_by_owner`` (:109),
``_local_weights`` (:139), ``_spmv_local`` (:149), ``_degree_local``
(:159), ``_mean_filter_sharded`` (:166), ``_mean_filter_chebyshev_sharded``
(:181) and ``refine_fine_level_sharded`` (:303).

Each rank of the mesh's one axis owns N/P vertex rows of both graphs
(neighbour tables, masks, edge weights and the hub-overflow edges whose
source row it owns) and keeps nothing else of the graph.  A smoothing step
all-gathers the [N, 3] iterate once (``distributed.all_gather``) and
applies the rank's own rows; the k = 3 query runs the rank's source rows
against the all-gathered smoothed target, by the route of the one-device
refine (``multires._refine_fine_level``: ``ops/knn.knn3_masked``, the
k-NN kernel or the grid on the card).  The results are gathered, so every
rank returns the seven global arrays of the one-device refine, cut to the
real row counts.

Every per-row operation is the one-device refine's, so the two agree to
f32 roundoff (``tests/test_torch_bigmesh.py`` holds the port to JAX's
sharded refine at ``tests/test_bigmesh.py``'s gates).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import graph_ops
from ..ops.knn import idw_from_knn, knn3_masked
from ..pipeline import GraphArrays
from ..utils.device import to_numpy
from ..utils.precision import f32_matmuls
from .distributed import all_gather, axis_rank, axis_size, gather_results, rank_device

__all__ = [
    "pad_rows_for_sharding",
    "partition_overflow_by_owner",
    "refine_fine_level_sharded",
]

# The fields of GraphArrays with one row per vertex.
_ROW_FIELDS = ("points", "neighbors", "nbr_mask", "valid_mask", "null_indicators",
               "node_features")


def _rows(x: torch.Tensor, row0: int, n_rows: int, device) -> torch.Tensor:
    """Rows [row0, row0 + n_rows) of ``x`` on ``device``, zero rows past
    its end."""
    part = x[row0:row0 + n_rows].to(device)
    if part.shape[0] < n_rows:
        part = torch.cat([part, part.new_zeros((n_rows - part.shape[0],) + part.shape[1:])])
    return part


def pad_rows_for_sharding(graph: GraphArrays, n_shards: int):
    """Pad the vertex axis to a multiple of ``n_shards`` with dead rows:
    zero points, masks (so zero edge weights), features and indicators,
    neighbours pointing at row 0.  A padding row has degree 0, so the
    smoothing maps it to itself and nothing reads it.  Returns (padded
    GraphArrays, original row count)."""
    n = graph.n_points
    n_pad = -(-n // n_shards) * n_shards
    return GraphArrays(
        **{f: _rows(getattr(graph, f), 0, n_pad, graph.device) for f in _ROW_FIELDS},
        overflow=graph.overflow,
    ), n


def partition_overflow_by_owner(overflow, n_rows: int, n_shards: int) -> torch.Tensor:
    """Hub-overflow directed edges (int [E, 2] global (src, dst)) grouped by
    the shard that owns their src row (``n_rows`` padded rows split evenly),
    each group padded to the largest with src == dst rows at the shard's
    first row (weight 0: a no-op).  Returns int64 [n_shards * e_max, 2],
    shard s's edges in rows [s e_max, (s + 1) e_max), indices still global;
    e_max >= 1.  On the host, on ``overflow``'s device."""
    ov = to_numpy(overflow, np.int64).reshape(-1, 2)
    rows_per = n_rows // n_shards
    ov = ov[ov[:, 0] != ov[:, 1]]  # old padding rows: re-padded per owner
    owner = ov[:, 0] // rows_per
    e_max = max(int(np.bincount(owner, minlength=n_shards).max(initial=0)), 1)
    out = np.zeros((n_shards, e_max, 2), np.int64)
    for s in range(n_shards):
        out[s] = s * rows_per
        mine = ov[owner == s]
        out[s, : mine.shape[0]] = mine
    dev = overflow.device if torch.is_tensor(overflow) else "cpu"
    return torch.from_numpy(out.reshape(n_shards * e_max, 2)).to(dev)


def _local_weights(pts_full, pts_shard, nbr_shard, mask_shard):
    """Edge weights 1/dist of this shard's rows, the neighbours (global
    indices) read from the gathered points: ``graph_ops.edge_weights``
    sharded."""
    diff = pts_full[nbr_shard] - pts_shard[:, None, :]
    dist = torch.sqrt((diff * diff).sum(dim=-1))
    real = mask_shard > 0
    safe = torch.clamp(torch.where(real, dist, torch.ones_like(dist)), min=1e-20)
    return torch.where(real, 1.0 / safe, torch.zeros_like(safe))


def _spmv_local(nbr, w, x_full, ov, ov_w, row0):
    """This shard's rows of W x: the ELL gather over the gathered iterate
    plus the shard-owned overflow edges (src localized by ``row0``)."""
    y = torch.einsum("nd,ndc->nc", w, x_full[nbr])
    y.index_add_(0, ov[:, 0] - row0, ov_w[:, None] * x_full[ov[:, 1]])
    return y


def _degree_local(w, ov, ov_w, row0):
    return w.sum(dim=1).index_add(0, ov[:, 0] - row0, ov_w)


def _mean_filter_sharded(mesh, axis, nbr, w, ov, ov_w, row0, x_shard, iterations):
    """The exact mean filter out <- diag(1/(1+d)) (W + I) out, row-sharded,
    one all-gather of the [N, C] iterate a step (``graph_ops.mean_filter``
    on one device)."""
    inv = 1.0 / (1.0 + _degree_local(w, ov, ov_w, row0))
    x = x_shard
    for _ in range(iterations):
        full = all_gather(x, mesh, axis)
        x = inv[:, None] * (_spmv_local(nbr, w, full, ov, ov_w, row0) + x)
    return x


def _mean_filter_chebyshev_sharded(mesh, axis, nbr, w, ov, ov_w, row0, x_shard,
                                   iterations):
    """The Chebyshev mean filter, row-sharded, with the degree rule and
    coefficients of ``graph_ops.mean_filter_chebyshev``."""
    q = iterations
    degree = min(q, int(math.sqrt(2.0 * q * math.log(1e5))) + 8)
    if degree >= q:
        return _mean_filter_sharded(mesh, axis, nbr, w, ov, ov_w, row0, x_shard, q)
    inv_sqrt = (1.0 + _degree_local(w, ov, ov_w, row0)) ** -0.5
    inv_sqrt_full = all_gather(inv_sqrt, mesh, axis)

    def s_op(v_shard):
        u_full = inv_sqrt_full[:, None] * all_gather(v_shard, mesh, axis)
        u_local = inv_sqrt[:, None] * v_shard
        return inv_sqrt[:, None] * (_spmv_local(nbr, w, u_full, ov, ov_w, row0) + u_local)

    coeffs = torch.as_tensor(graph_ops._chebyshev_power_coeffs(q, degree),
                             dtype=torch.float32).to(x_shard.device)
    t_prev = x_shard / inv_sqrt[:, None]
    t_cur = s_op(t_prev)
    acc = coeffs[0] * t_prev + coeffs[1] * t_cur
    for kk in range(2, degree + 1):
        t_next = 2.0 * s_op(t_cur) - t_prev
        acc = acc + coeffs[kk] * t_next
        t_prev, t_cur = t_cur, t_next
    return inv_sqrt[:, None] * acc


def _shard(graph: GraphArrays, n_dev: int, rank: int, device):
    """This rank's rows of ``graph`` padded to ``n_dev`` shards, its owned
    overflow edges, and its first global row."""
    n_pad = -(-graph.n_points // n_dev) * n_dev
    n_local = n_pad // n_dev
    row0 = rank * n_local
    ov = partition_overflow_by_owner(graph.overflow, n_pad, n_dev)
    e_max = ov.shape[0] // n_dev
    local = {f: _rows(getattr(graph, f), row0, n_local, device) for f in _ROW_FIELDS}
    local["overflow"] = ov[rank * e_max:(rank + 1) * e_max].to(device)
    return GraphArrays(**local), row0


@f32_matmuls
def refine_fine_level_sharded(target: GraphArrays, source: GraphArrays, init_corr,
                              cfg, device_mesh):
    """Fine-level refinement of one pair (``multires._refine_fine_level``:
    the smoothings, one k = 3 query, the inverse-distance locations), with
    each rank of ``device_mesh`` (one axis) owning N/P vertex rows.

    Every rank passes the same global graphs and ``init_corr`` (int [Ns])
    and gets back the one-device refine's seven keys as global tensors on
    its device (``distributed.rank_device``), ``smoothed_target_coords``
    cut to the target's rows and the others to the source's.  The smoothing
    weights are featureless: ``register_pair_multires`` rejects
    ``include_features_in_adj_matrix`` with a mesh."""
    names = tuple(device_mesh.mesh_dim_names or ())
    if device_mesh.ndim != 1:
        raise ValueError(
            "refine_fine_level_sharded expects a single-axis device mesh; "
            f"got axes {names}"
        )
    axis = names[0]
    n_dev = axis_size(device_mesh, axis)
    rank = axis_rank(device_mesh, axis)
    dev = rank_device(device_mesh)
    smooth = (_mean_filter_chebyshev_sharded if cfg.smoothing_method == "chebyshev"
              else _mean_filter_sharded)

    n_t, n_s = target.n_points, source.n_points
    tgt, row0_t = _shard(target, n_dev, rank, dev)
    src, row0_s = _shard(source, n_dev, rank, dev)
    ic = _rows(torch.as_tensor(init_corr).to(torch.int64), row0_s, src.n_points, dev)

    def gather(x):
        return all_gather(x, device_mesh, axis)

    tpts_full = gather(tgt.points)
    tmask_full = gather(tgt.valid_mask)
    spts_full = gather(src.points)
    w_t = _local_weights(tpts_full, tgt.points, tgt.neighbors, tgt.nbr_mask)
    w_s = _local_weights(spts_full, src.points, src.neighbors, src.nbr_mask)
    ovw_t = graph_ops.overflow_weights(tpts_full, tgt.overflow)
    ovw_s = graph_ops.overflow_weights(spts_full, src.overflow)

    corr = ic
    smoothed_tgt = tgt.points
    smoothed_full = tpts_full
    projected = src.points
    if cfg.smooth_correspondences:
        smoothed_tgt = smooth(device_mesh, axis, tgt.neighbors, w_t, tgt.overflow, ovw_t,
                              row0_t, tgt.points, cfg.graph_smoothing_iterations)
        smoothed_full = gather(smoothed_tgt)
        projected = smooth(device_mesh, axis, src.neighbors, w_s, src.overflow, ovw_s,
                           row0_s, smoothed_full[ic], cfg.projection_smooth_iterations)
    # One k=3 query: column 0 is the final correspondence, all three give
    # the inverse-distance locations.
    d3, i3 = knn3_masked(smoothed_full, tmask_full, projected)
    if cfg.smooth_correspondences:
        corr = i3[:, 0]
    weighted = idw_from_knn(d3, i3, tpts_full)
    smask = src.valid_mask[:, None]
    svalid = src.valid_mask.to(torch.int64)
    local = {
        "correspondences": corr * svalid,
        "initial_correspondences": ic * svalid,
        "nearest_points": tpts_full[corr] * smask,
        "weighted_points": weighted * smask,
        "average_points": (src.points + weighted) / 2.0 * smask,
        "smoothed_target_coords": smoothed_tgt * tgt.valid_mask[:, None],
        "source_projected_on_target": projected * smask,
    }
    out = gather_results(local, device_mesh, axis)
    return {k: out[k][:n_t] if k == "smoothed_target_coords" else out[k][:n_s]
            for k in local}
