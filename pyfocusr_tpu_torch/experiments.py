"""Two alternative schedules of the pair's eigensolves, kept out of the
pipeline's configuration.

Counterpart of ``pyfocusr_tpu/experiments.py``: ``spectrum_union`` (:36)
and ``spectrum_batched`` (:123).  The JAX package measured both neutral or
slower than two separate solves on a TPU and left them unreachable from
``PipelineConfig``; here they are the same computations on the port's
solvers, for measurement on the card (``chip_smoke.py``'s ``completion``
phase times them beside two separate solves).

* ``spectrum_union``: both meshes' spectra from one narrow Chebyshev solve
  on their disjoint union (a block-diagonal Laplacian), with a
  Rayleigh-Ritz per mesh (``ops/eigen.chebyshev_eigpairs``'s
  ``partition_masks``).
* ``spectrum_batched``: both graphs padded to one shape
  (``pipeline._pad_graph_arrays``) and each solved by ``pipeline._spectrum``.
  The JAX package vmaps one solve over the pair; the port's wide solver
  reads the host between chunks (the residual-gated top-up, the SVQB rank
  test), so it cannot be batched that way, and the two padded solves run
  in turn.  The values are those the JAX package's batched solve defines.

Randomness is an input: the start blocks are arguments.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import graph_ops
from .ops.eigen import chebyshev_eigpairs
from .pipeline import (
    GraphArrays,
    PipelineConfig,
    _masked_minmax_norm,
    _pad_graph_arrays,
    _spectrum,
    _tensor_to,
)
from .utils.precision import f32_matmuls

__all__ = ["spectrum_union", "spectrum_batched"]


@f32_matmuls
def spectrum_union(target: GraphArrays, source: GraphArrays, k: int, init_block,
                   cfg: PipelineConfig):
    """Both meshes' k smallest nonzero eigenpairs from one narrow Chebyshev
    solve on their disjoint union (``pyfocusr_tpu/experiments.py:36-120``).
    ``init_block`` f32 [Nt + Ns, >= 2k + 8]: the solve's random start (the
    JAX package draws it from its key).  Returns (lams [2, k], vecs_t [Nt,
    k], vecs_s [Ns, k]), the eigenvectors min-max normalized as
    ``pipeline._spectrum``'s.

    The xyz Laplacian only, as in the JAX package: a feature-weighted
    config raises rather than solving another operator than
    ``pipeline._spectrum`` would."""
    if cfg.include_features_in_adj_matrix or cfg.use_features_in_graph:
        raise ValueError(
            "spectrum_union benchmarks the xyz-only Laplacian; "
            "feature-weighted graph configs are not supported here"
        )
    if target.device != source.device:
        raise ValueError(f"target on {target.device} but source on {source.device}")
    dev = target.device
    nt, ns = target.n_points, source.n_points
    dt, ds = target.neighbors.shape[1], source.neighbors.shape[1]
    d_pad = max(dt, ds)
    ct, cs = target.null_indicators.shape[1], source.null_indicators.shape[1]
    nulls = torch.zeros((nt + ns, ct + cs), dtype=torch.float32, device=dev)
    nulls[:nt, :ct] = target.null_indicators
    nulls[nt:, ct:] = source.null_indicators
    # Overflow padding rows are src == dst and stay so under the offset.
    union = GraphArrays(
        points=torch.cat([target.points, source.points]),
        neighbors=torch.cat([F.pad(target.neighbors, (0, d_pad - dt)),
                             F.pad(source.neighbors, (0, d_pad - ds)) + nt]),
        nbr_mask=torch.cat([F.pad(target.nbr_mask, (0, d_pad - dt)),
                            F.pad(source.nbr_mask, (0, d_pad - ds))]),
        valid_mask=torch.cat([target.valid_mask, source.valid_mask]),
        null_indicators=nulls,
        overflow=torch.cat([target.overflow, source.overflow + nt]),
    )

    mask = union.valid_mask
    nbrs = union.neighbors
    w = graph_ops.edge_weights(union.points, nbrs, union.nbr_mask)
    ov = union.overflow
    ov_w = graph_ops.overflow_weights(union.points, ov)
    d = graph_ops.degree_vector(w, ov, ov_w)
    g = torch.where(mask > 0, (d + graph_ops.DEGREE_EPS) ** -1, torch.ones_like(d))
    sdiag = torch.sqrt(g)

    def matvec(X):
        return graph_ops.sym_laplacian_matvec(
            nbrs, w, g, X * mask[:, None], ov, ov_w) * mask[:, None]

    null_basis = union.null_indicators * (1.0 / sdiag)[:, None] * mask[:, None]
    ws = graph_ops.spmv(nbrs, w, sdiag, ov, ov_w)
    lam_bound = (mask * sdiag * (sdiag * d + ws)).max()
    zeros_t = torch.zeros((nt,), dtype=torch.float32, device=dev)
    zeros_s = torch.zeros((ns,), dtype=torch.float32, device=dev)
    part = torch.stack([torch.cat([target.valid_mask, zeros_s]),
                        torch.cat([zeros_t, source.valid_mask])], dim=1)
    lams, vecs, _ = chebyshev_eigpairs(
        matvec, null_basis, k, _tensor_to(init_block, dev),
        degree=cfg.eig_cheb_degree, sweeps=cfg.eig_cheb_sweeps,
        refine_cg_iters=cfg.eig_cheb_refine_cg,
        subspace_mask=mask, lam_max_bound=lam_bound,
        partition_masks=part,
    )
    out = []
    for p, (rows, m_p) in enumerate(((slice(0, nt), target.valid_mask),
                                     (slice(nt, nt + ns), source.valid_mask))):
        v = vecs[:, p, :] * sdiag[:, None]
        v = v / torch.clamp(v.norm(dim=0, keepdim=True), min=1e-30)
        out.append(_masked_minmax_norm(v[rows], m_p))
    return lams, out[0], out[1]


@f32_matmuls
def spectrum_batched(target: GraphArrays, source: GraphArrays, k: int, init_blocks,
                     cfg: PipelineConfig):
    """Both graphs padded to a common shape and solved by
    ``pipeline._spectrum`` (``pyfocusr_tpu/experiments.py:123-146``), in
    turn (see the module docstring).  ``init_blocks``: the two solves'
    starts, each [N_pad, w] with ``pipeline._start_width`` columns for the
    padded size (the JAX package's two keys).  Returns (lams_t, vecs_t,
    lams_s, vecs_s), the eigenvectors cut back to each mesh's rows."""
    n_pad = max(target.n_points, source.n_points)
    d_pad = max(target.neighbors.shape[1], source.neighbors.shape[1])
    c_pad = max(target.null_indicators.shape[1], source.null_indicators.shape[1])
    e_pad = max(target.overflow.shape[0], source.overflow.shape[0])
    out = []
    for g, start in zip((target, source), init_blocks):
        padded = _pad_graph_arrays(g, n_pad, d_pad, c_pad, e_pad)
        lams, vecs, _ = _spectrum(padded, k, cfg, _tensor_to(start, g.device))
        out += [lams, vecs[:g.n_points]]
    return tuple(out)
