"""Symmetric and groupwise (all-pairs) registration.

Counterpart of ``pyfocusr_tpu/parallel/groupwise.py``: ``_symmetrize``
(:73), ``register_pair_symmetric`` (:106), ``register_all_pairs`` (:167),
``cycle_consistency_error`` (:265), ``synchronize_correspondences``
(:297), ``spectral_bases`` (:351) and ``synchronize_spectral`` (:402),
with the JAX package's names and arguments save two, as in
``parallel/cohort.py``:

* randomness is an input: where JAX splits a ``key``, these take a
  ``generator`` (a ``torch.Generator`` that seeds the draws) or explicit
  draws (:func:`make_symmetric_draws`, :func:`make_all_pairs_draws`,
  :func:`make_basis_blocks`);
* each registration (a pair, a direction) draws its eigensolver refill
  noise from a generator of its own, ``cohort.lane_generator`` of its
  draws, as JAX splits its key per pair (:147, :210).

JAX vmaps the B(B-1) registrations of ``register_all_pairs`` (:208-215);
the port loops over the pairs on the graphs' device and stacks their
results on a leading axis, as ``register_cohort`` does.  With a
``device_mesh`` (a ``DeviceMesh`` with a ``'pairs'`` dimension, its other
dimensions replicating), the pairs are padded to a multiple of the
``'pairs'`` size with replicas of pair 0, each rank registers its
contiguous block on its device, the blocks are all-gathered along
``'pairs'`` and the padding dropped (:217-248).  The O(B^3)
gathers, the block ``eigh`` and the polar SVDs stay on the host in numpy,
as JAX's do; the snaps (``nn_query``) and the k = 3 pulls
(``idw_pull_k3``) run on the device the graphs or points lie on: on the
card they launch the k-NN kernel (``csrc/knn.cu``; a 20-column spectral
snap takes ``ops/knn.nn_tiled``, as JAX's XLA path does above 16
columns).
"""

from __future__ import annotations

import itertools
from typing import List, Sequence

import numpy as np
import torch

from ..mesh import TriMesh
from ..ops.knn import SENTINEL, idw_pull_k3, nn_query
from ..pipeline import (
    _NARROW_EXTRA,
    GraphArrays,
    NormalDraw,
    PipelineConfig,
    _n_real_vertices,
    _solver,
    _spectrum,
    _tensor_to,
    draw_seed,
    make_draws,
    register_pair,
)
from ..utils.device import to_numpy
from ..utils.precision import f32_matmuls
from .cohort import (
    _device_of,
    _f32,
    _lane,
    check_cohort_config,
    lane_generator,
    pad_cohort,
    stack_graph_arrays,
)
from .distributed import axis_rank, axis_size, check_axis, gather_results, rank_device

__all__ = [
    "register_pair_symmetric",
    "register_all_pairs",
    "synchronize_correspondences",
    "synchronize_spectral",
    "spectral_bases",
    "cycle_consistency_error",
    "make_symmetric_draws",
    "make_all_pairs_draws",
    "make_basis_blocks",
]


def _generator(generator):
    return torch.Generator().manual_seed(0) if generator is None else generator


def _masked_mean(values, mask):
    return (values * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _symmetrize(fwd_points, bwd_points, source_points, target_points, source_mask,
                target_mask):
    """Fuse the forward map with the inverse of the backward map.

    The backward registration gives, for every target vertex j, a location
    G(j) on the source surface.  Inverting it at source vertex i
    interpolates the target vertices' own positions at the 3 nearest G(j)
    to x_i: a second estimate F'(i) of where i lands on the target.  The
    symmetric map is the midpoint (F + F')/2 snapped to a target vertex;
    |F - F'| is the forward/backward consistency (0 for an involutive pair
    of maps).  Returns (midpoints [Ns, 3], snapped target rows int64 [Ns],
    both zero on padding rows, the masked mean of |F - F'|)."""
    inv = idw_pull_k3(bwd_points, target_mask, target_points, source_points)
    sym_points = 0.5 * (fwd_points + inv)
    tgt_q = torch.where(target_mask[:, None] > 0, target_points,
                        torch.full_like(target_points, SENTINEL))
    _, sym_corr = nn_query(tgt_q, sym_points)
    fb_consistency = _masked_mean(torch.linalg.norm(fwd_points - inv, dim=1), source_mask)
    return (sym_points * source_mask[:, None],
            sym_corr * source_mask.to(sym_corr.dtype), fb_consistency)


def make_symmetric_draws(seed: int, cfg: PipelineConfig, target: GraphArrays,
                         source: GraphArrays):
    """The random inputs of :func:`register_pair_symmetric` from ``seed``:
    ``{"forward": make_draws for source -> target, "backward": for target
    -> source}``, each over real rows only.  The two directions' seeds are
    drawn first with numpy, as JAX splits its key in two (:147)."""
    real_t, real_s = _n_real_vertices(target, source)
    seeds = np.random.default_rng(seed).integers(0, 2**62, size=2)
    return {"forward": make_draws(int(seeds[0]), cfg, target.n_points, source.n_points,
                                  real_target=real_t, real_source=real_s),
            "backward": make_draws(int(seeds[1]), cfg, source.n_points, target.n_points,
                                   real_target=real_s, real_source=real_t)}


def register_pair_symmetric(target: GraphArrays, source: GraphArrays,
                            cfg: PipelineConfig, generator: torch.Generator = None,
                            draws=None):
    """Register source -> target and target -> source, then fuse.

    ``draws``: from :func:`make_symmetric_draws`; when None they are drawn
    from ``generator`` (a fresh one seeded 0 when that is None too).  Each
    direction's refill noise comes from ``cohort.lane_generator`` of its
    draws.

    Returns a dict with the JAX package's keys: ``forward`` / ``backward``
    (the two ``register_pair`` results), ``sym_points`` f32 [Ns, 3] (the
    midpoint of the two directions' estimates, which may lie slightly off
    the target surface), ``sym_correspondences`` int64 [Ns] (the midpoint
    snapped to a target vertex), ``target_sym_points`` /
    ``target_sym_correspondences`` (the mirror outputs per target vertex),
    ``fb_consistency`` (mean |F - inv(G)| over real source vertices, mm)
    and ``cycle_error`` (mean |G(F_idx(i)) - x_i| over real source
    vertices, mm)."""
    if draws is None:
        draws = make_symmetric_draws(draw_seed(_generator(generator)), cfg, target, source)
    fwd = register_pair(target, source, cfg, generator=lane_generator(draws["forward"]),
                        draws=draws["forward"])
    bwd = register_pair(source, target, cfg, generator=lane_generator(draws["backward"]),
                        draws=draws["backward"])
    sym_pts, sym_corr, fb = _symmetrize(
        fwd["weighted_points"], bwd["weighted_points"], source.points, target.points,
        source.valid_mask, target.valid_mask)
    t_sym_pts, t_sym_corr, _ = _symmetrize(
        bwd["weighted_points"], fwd["weighted_points"], target.points, source.points,
        target.valid_mask, source.valid_mask)
    # Index-composition cycle: i -> corr_fwd[i] (a target vertex) -> its
    # backward-mapped location on the source, against x_i itself.
    cycle_gap = torch.linalg.norm(
        bwd["weighted_points"][fwd["correspondences"]] - source.points, dim=1)
    return {
        "forward": fwd,
        "backward": bwd,
        "sym_points": sym_pts,
        "sym_correspondences": sym_corr,
        "target_sym_points": t_sym_pts,
        "target_sym_correspondences": t_sym_corr,
        "fb_consistency": fb,
        "cycle_error": _masked_mean(cycle_gap, source.valid_mask),
    }


def _pair_index(batch: int):
    return [(i, j) for i in range(batch) for j in range(batch) if i != j]


def make_all_pairs_draws(seed: int, cfg: PipelineConfig, graphs: Sequence[GraphArrays]):
    """The random inputs of :func:`register_all_pairs`: one
    :func:`pipeline.make_draws` dict per ordered pair (target i, source j),
    in the pairs' stacking order, over each mesh's real rows.  The pairs'
    seeds are drawn first, one each, as JAX splits its key per pair
    (:205)."""
    pairs = _pair_index(len(graphs))
    real = _n_real_vertices(*graphs)
    n = graphs[0].n_points
    seeds = np.random.default_rng(seed).integers(0, 2**62, size=len(pairs))
    return [make_draws(int(s), cfg, n, n, real_target=real[i], real_source=real[j])
            for s, (i, j) in zip(seeds, pairs)]


def register_all_pairs(meshes: Sequence[TriMesh] | Sequence[GraphArrays],
                       cfg: PipelineConfig, generator: torch.Generator = None,
                       device_mesh=None, draws=None, device=None):
    """Register every ordered pair of a cohort: mesh j as source onto
    target mesh i, for all i != j.  Meshes are padded to common shapes
    (:func:`cohort.pad_cohort`, on ``device``: the card when None);
    graphs must share their shapes already.  ``draws``: from
    :func:`make_all_pairs_draws`; when None they are drawn from
    ``generator`` (seeded 0 when None).  Each pair's refill noise comes
    from ``cohort.lane_generator`` of its draws.

    ``device_mesh``: shard the pairs over its ``'pairs'`` dimension (a
    ``ValueError`` without one); every rank passes the same arguments,
    registers its block of the pairs (padded with replicas of pair 0 to a
    multiple of the ``'pairs'`` size) on its device and returns the global
    results.

    Returns ``(corr, pair_index, results)``: ``corr`` int64 numpy [B, B,
    N_pad] with ``corr[j, i, v]`` the vertex of mesh i corresponding to
    vertex v of mesh j (the diagonal is the identity); ``pair_index`` the
    (target i, source j) of each pair in stacking order; ``results`` each
    ``register_pair`` key stacked over the pairs on axis 0."""
    if device_mesh is not None:
        check_axis(device_mesh, "pairs", "register_all_pairs")
        if device is None:
            device = rank_device(device_mesh)
    meshes = list(meshes)
    graphs = (pad_cohort(meshes, device=device) if meshes and isinstance(meshes[0], TriMesh)
              else meshes)
    batch = len(graphs)
    if batch < 2:
        raise ValueError("need at least two meshes for all-pairs registration")
    stacked = stack_graph_arrays(graphs)
    n_pad = stacked.points.shape[1]
    check_cohort_config(min(_n_real_vertices(*graphs)), cfg, padded_size=n_pad)
    pair_index = _pair_index(batch)
    if draws is None:
        draws = make_all_pairs_draws(draw_seed(_generator(generator)), cfg, graphs)
    if len(draws) != len(pair_index):
        raise ValueError(f"draws hold {len(draws)} pairs; {batch} meshes make "
                         f"{len(pair_index)}")
    mine = range(len(pair_index))
    if device_mesh is not None:
        # Replicas of pair 0 fill the last block so every rank along
        # 'pairs' registers as many pairs; dropped after the gather.
        n_dev = axis_size(device_mesh, "pairs")
        per = -(-len(pair_index) // n_dev)
        rank = axis_rank(device_mesh, "pairs")
        mine = [p if p < len(pair_index) else 0 for p in range(rank * per, (rank + 1) * per)]
        stacked = stacked.to(rank_device(device_mesh))

    def register(p):
        (i, j), d = pair_index[p], draws[p]
        return register_pair(_lane(stacked, i), _lane(stacked, j), cfg,
                             generator=lane_generator(d), draws=d)

    rows = [register(p) for p in mine]
    results = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    if device_mesh is not None:
        gathered = gather_results(results, device_mesh, "pairs")
        results = {k: gathered[k][:len(pair_index)] for k in results}
    corr = np.tile(np.arange(n_pad, dtype=np.int64), (batch, batch, 1))
    got = to_numpy(results["correspondences"])
    for p, (i, j) in enumerate(pair_index):
        corr[j, i] = got[p]
    return corr, pair_index, results


def cycle_consistency_error(corr: np.ndarray, points: Sequence, n_real: Sequence[int]) -> float:
    """Mean three-cycle transitivity error in mm: for every ordered triple
    (j, k, i), the distance on mesh i between the landings of j -> k -> i
    and of j -> i, averaged over real vertices and all triples.  Zero for a
    transitive map set.  ``points``: each mesh's real [N_i, 3] points
    (numpy or tensors)."""
    batch = corr.shape[0]
    if batch < 3:
        raise ValueError(
            f"cycle consistency needs >= 3 meshes, got B={batch}; use the "
            "forward/backward-consistency diagnostics of "
            "register_pair_symmetric for pairs"
        )
    points = [to_numpy(p) for p in points]
    total, count = 0.0, 0
    for j, k, i in itertools.permutations(range(batch), 3):
        v = np.arange(n_real[j])
        via = corr[k, i][corr[j, k][v]]
        direct = corr[j, i][v]
        total += float(np.linalg.norm(points[i][via] - points[i][direct], axis=1).mean())
        count += 1
    return total / max(count, 1)


def _snap(ref, query, device):
    """Row of ``ref`` nearest each row of ``query`` (both host arrays), on
    ``device``, as int64 numpy."""
    _, idx = nn_query(_f32(ref, device), _f32(query, device))
    return to_numpy(idx, np.int64)


def synchronize_correspondences(corr: np.ndarray, points: Sequence,
                                n_real: Sequence[int], device=None) -> np.ndarray:
    """Map synchronization: each direct map j -> i is replaced by the
    per-vertex consensus of the two-hop compositions j -> k -> i over k !=
    i (k == j is the direct map itself, once): the landing positions on
    mesh i averaged over the B - 1 paths and snapped to the nearest mesh-i
    vertex on ``device`` (default: where the first tensor among ``points``
    lies, else the card).  Returns a corrected copy of ``corr``, the
    diagonal untouched."""
    dev = _device_of(*points, device=device)
    pts = [to_numpy(p) for p in points]
    batch = corr.shape[0]
    out = corr.copy()
    for j in range(batch):
        v = np.arange(n_real[j])
        for i in range(batch):
            if i == j:
                continue
            acc = np.zeros((n_real[j], 3), np.float64)
            for k in range(batch):
                if k == i:  # the identity diagonal: would count the direct map twice
                    continue
                landing = corr[j, i][v] if k == j else corr[k, i][corr[j, k][v]]
                acc += pts[i][landing]
            acc /= batch - 1
            out[j, i, : n_real[j]] = _snap(pts[i], acc, dev)
    return out


def _basis_width(cfg: PipelineConfig, n_points: int, n_basis: int) -> int:
    """Columns of the random start of an ``n_basis`` solve: the wide block,
    the narrow block (n_basis + 8) or Lanczos's two vectors."""
    return {"wide": cfg.eig_wide_block, "narrow": n_basis + _NARROW_EXTRA,
            "lanczos": 2}[_solver(cfg, n_points)]


def make_basis_blocks(seed: int, cfg: PipelineConfig, graphs: Sequence[GraphArrays],
                      n_basis: int = 12) -> List[NormalDraw]:
    """The random starts of :func:`spectral_bases`: one f32 [N_i, width]
    standard-normal block per graph, a :class:`pipeline.NormalDraw` drawn
    on the graph's device, its seed drawn with numpy from ``seed`` in
    graph order (JAX splits its key per graph, :376)."""
    seeds = np.random.default_rng(seed).integers(0, 2**62, size=len(graphs))
    return [NormalDraw(int(s), (g.n_points, _basis_width(cfg, g.n_points, n_basis)))
            for s, g in zip(seeds, graphs)]


@f32_matmuls
def spectral_bases(graphs: Sequence[GraphArrays], cfg: PipelineConfig,
                   generator: torch.Generator = None, n_basis: int = 12,
                   blocks=None) -> List[np.ndarray]:
    """Per-mesh orthonormal low-frequency Laplacian bases: each mesh's
    ``n_basis`` smallest nonzero eigenvectors (the pipeline's
    ``_spectrum`` on the graph's device, one solve per mesh as in JAX),
    restricted to real rows, centred per column (the pipeline's min-max
    normalization adds a constant), re-orthonormalized by a host QR and
    scaled by sqrt(n_real), so descriptor rows are O(1) at any mesh size.
    ``blocks``: the solves' starts (:func:`make_basis_blocks`); when None
    they are drawn from ``generator`` (seeded 0 when None).  Returns f64
    numpy [n_real_i, n_basis] per mesh."""
    real = _n_real_vertices(*graphs)
    for n in real:
        if n_basis >= n:
            raise ValueError(
                f"n_basis={n_basis} must be smaller than the real vertex count {n}")
    generator = _generator(generator)
    if blocks is None:
        blocks = make_basis_blocks(draw_seed(generator), cfg, graphs, n_basis)
    out = []
    for g, n, block in zip(graphs, real, blocks):
        _, vecs, _ = _spectrum(g, n_basis, cfg, _tensor_to(block, g.device),
                               generator=generator)
        v = to_numpy(vecs, np.float64)[to_numpy(g.valid_mask) > 0]
        v = v - v.mean(axis=0, keepdims=True)
        q, _ = np.linalg.qr(v)
        out.append(q * np.sqrt(n))
    return out


def synchronize_spectral(corr: np.ndarray, graphs: Sequence[GraphArrays],
                         cfg: PipelineConfig, generator: torch.Generator = None,
                         n_basis: int = 20, outlier_factor: float = 1.3,
                         repair: str = "consensus", blocks=None):
    """Functional-map synchronization: find the pairwise maps that are
    inconsistent in a shared latent spectral basis and repair only those.

    Each map j -> i induces ``D[j, i] = pinv(Phi_j) P_ji Phi_i`` in the
    meshes' bases (:func:`spectral_bases`, with ``generator`` /
    ``blocks``).  For a cycle-consistent set ``D[j, i] ~= Q_j Q_i^T``, so
    the top-``n_basis`` eigenspace of the symmetrized block matrix,
    polar-projected per mesh, gives every Q_i; ``|D[j, i] - Q_j Q_i^T| /
    sqrt(k)`` is each map's residual, and maps above ``outlier_factor``
    times the off-diagonal median are flagged (B >= 3; nothing is flagged
    for B == 2) and repaired: ``repair="consensus"`` by two-hop position
    consensus through unflagged maps only, ``"spectral"`` (also when no
    trusted path exists) by nearest neighbours between the synchronized
    descriptors ``Z_i = Phi_i Q_i``.  Unflagged maps are returned
    unchanged.  The eigenproblem and SVDs run in numpy on the host, the
    snaps on the graphs' device.

    Returns ``(out, info)``: the corrected copy of ``corr`` and ``{"Q":
    [B, k, k], "residuals": [B, B], "flagged": bool [B, B], "bases": the
    Z_i}``."""
    batch = corr.shape[0]
    if len(graphs) != batch:
        raise ValueError(f"corr is {batch}x{batch} but {len(graphs)} graphs given")
    if repair not in ("consensus", "spectral"):
        raise ValueError(f"unknown repair mode {repair!r}")
    dev = graphs[0].device
    masks = [to_numpy(g.valid_mask) > 0 for g in graphs]
    n_real = [int(m.sum()) for m in masks]
    # Padded index <-> real-row index maps (padding is trailing, so both
    # are identities on the real prefix; kept to name the index spaces).
    pad_of_real = [np.flatnonzero(m) for m in masks]
    real_of_pad = []
    for m in masks:
        r = np.zeros(m.shape[0], np.int64)
        r[m] = np.arange(int(m.sum()))
        real_of_pad.append(r)

    phis = spectral_bases(graphs, cfg, generator=generator, n_basis=n_basis, blocks=blocks)
    k = n_basis
    # With sqrt(n)-scaled orthonormal bases, pinv(Phi_j) = Phi_j.T / n_j.
    D = np.zeros((batch, batch, k, k))
    for j in range(batch):
        D[j, j] = np.eye(k)
        for i in range(batch):
            if i != j:
                t = real_of_pad[i][corr[j, i][: n_real[j]]]
                D[j, i] = phis[j].T @ phis[i][t] / n_real[j]

    W = D.transpose(0, 2, 1, 3).reshape(batch * k, batch * k)
    W = 0.5 * (W + W.T)
    _, evecs = np.linalg.eigh(W)
    U = evecs[:, -k:]
    Q = np.zeros((batch, k, k))
    for i in range(batch):
        a, _, bt = np.linalg.svd(U[i * k: (i + 1) * k])
        Q[i] = a @ bt

    residuals = np.zeros((batch, batch))
    for j in range(batch):
        for i in range(batch):
            if i != j:
                residuals[j, i] = np.linalg.norm(D[j, i] - Q[j] @ Q[i].T) / np.sqrt(k)
    off = ~np.eye(batch, dtype=bool)
    flagged = np.zeros((batch, batch), dtype=bool)
    if batch >= 3:
        flagged = off & (residuals > outlier_factor * float(np.median(residuals[off])))

    Z = [phis[i] @ Q[i] for i in range(batch)]
    points = [to_numpy(g.points)[m] for g, m in zip(graphs, masks)]
    out = corr.copy()
    for j in range(batch):
        for i in range(batch):
            if not flagged[j, i]:
                continue
            trusted = [t for t in range(batch)
                       if t != j and t != i and not flagged[j, t] and not flagged[t, i]]
            if repair == "spectral" or not trusted:
                out[j, i, : n_real[j]] = pad_of_real[i][_snap(Z[i], Z[j], dev)]
                continue
            acc = np.zeros((n_real[j], 3), np.float64)
            for t in trusted:
                acc += points[i][real_of_pad[i][corr[t, i][corr[j, t][: n_real[j]]]]]
            acc /= len(trusted)
            out[j, i, : n_real[j]] = pad_of_real[i][_snap(points[i], acc, dev)]
    return out, {"Q": Q, "residuals": residuals, "flagged": flagged, "bases": Z}
