"""Multi-resolution registration: meshes past what one spectral solve holds.

Counterpart of ``pyfocusr_tpu/multires.py``: ``subdivide`` (:63),
``_PACKED_KEY_MAX_NC`` (:57-60), ``_luby_mis_numpy`` (:100),
``_aggregate_once`` (:150), ``decimate`` (:236), ``_weight_coords`` (:272),
the refine (``_refine_fine_level`` :296 and ``_refine_fine_level_staged``
:377 in one function), ``_aggregate_features`` (:436), ``_map_landmarks``
(:454), ``_run_fingerprint`` (:478) and ``register_pair_multires``
(:514-860, with ``_save_coarse_and_finish`` and ``_finish_multires``):

    decimate both meshes (host)  ->  register the coarse pair
    (``pipeline.register_pair``)  ->  prolong the correspondences through
    the cluster maps  ->  refine at full resolution (smoothing, one k=3
    query, inverse-distance locations).

Decimation runs as the JAX package's does with its library built
(:150-183): edges from the caller's topology, else from the host library's
``topo_edges``, and the MIS from its ``mis_greedy`` (``native.py``,
``csrc/host/fast_topology.cpp``); cluster assignment and the coarse mesh
stay numpy.  ``decimate_plain`` is the same rounds over the numpy MIS of
``_luby_mis_numpy`` and the scalar-key edge unique of
``_unique_edges_numpy`` (JAX's numpy paths), the plain version the tests
hold it to: both return the JAX package's bits.

The JAX package splits the refine into a fused program and a host-staged
one above 600000 vertices, for two TPU reasons (only an untraced k-NN can
take the voxel grid; several Pallas k-NN calls in one program faulted the
remote worker).  PyTorch traces nothing, so there is one refine; its k=3
query takes the grid where ``ops/knn.py`` routes it.  The stage
checkpoints of the staged refine are kept: above
``PYFOCUSR_TPU_STAGED_REFINE_N`` vertices (default 600000) both smoothings
are saved.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os

import numpy as np
import torch

from . import native
from .mesh import TriMesh, build_topology
from .ops import graph_ops
from .ops.knn import idw_from_knn, knn3_masked
from .pipeline import (
    GraphArrays,
    PipelineConfig,
    _normed_points,
    _not_ported,
    _smooth_fn,
    mesh_to_graph_arrays,
    register_pair,
)
from .utils.checkpoint import StageCheckpointer
from .utils.device import resolve_device
from .utils.precision import f32_matmuls

__all__ = ["subdivide", "decimate", "decimate_plain", "register_pair_multires"]

# Largest coarse vertex count for which the packed triangle-dedup key
# (i*nc + j)*nc + k fits int64 (nc^3 < 2^63 needs nc <= ~2.09e6); above it
# decimate() switches to exact lexicographic row-unique.
_PACKED_KEY_MAX_NC = 2_000_000

# Fine vertex count from which the refine saves its two smoothings as
# stages (the JAX package's host-staged threshold, read from the same
# variable; 0 turns the smoothing stages off).
_STAGED_REFINE_N = int(os.environ.get("PYFOCUSR_TPU_STAGED_REFINE_N", "600000"))


def subdivide(mesh: TriMesh) -> TriMesh:
    """Midpoint (1-to-4) subdivision: each edge gains its midpoint vertex.
    N' = N + E, F' = 4F.  Point data is averaged onto midpoints."""
    pts = np.asarray(mesh.points, np.float64)
    tris = np.asarray(mesh.triangles, np.int64)
    n = pts.shape[0]
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.sort(e, axis=1)
    uniq, inv = np.unique(e[:, 0] * n + e[:, 1], return_inverse=True)
    eu = np.stack([uniq // n, uniq % n], axis=1)
    mids = 0.5 * (pts[eu[:, 0]] + pts[eu[:, 1]])
    new_pts = np.concatenate([pts, mids])
    m = inv.reshape(3, -1).T + n  # midpoint index per (tri, edge)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    mab, mbc, mca = m[:, 0], m[:, 1], m[:, 2]
    new_tris = np.concatenate(
        [
            np.stack([a, mab, mca], 1),
            np.stack([mab, b, mbc], 1),
            np.stack([mca, mbc, c], 1),
            np.stack([mab, mbc, mca], 1),
        ]
    )
    pd = {}
    for k, v in mesh.point_data.items():
        va = np.asarray(v, np.float64)
        pd[k] = np.concatenate([va, 0.5 * (va[eu[:, 0]] + va[eu[:, 1]])])
    return TriMesh(
        np.asarray(new_pts, np.float32),
        np.asarray(new_tris, np.int32),
        {k: np.asarray(v, np.float32) for k, v in pd.items()},
    )


def _luby_mis_numpy(u, v, n, prio):
    """Maximal independent set by Luby-style rounds with static priorities:
    a vertex joins when its priority beats every unresolved neighbour's;
    neighbours of new seeds drop out.  The lexicographically-first MIS, as
    the JAX package's native greedy pass.  Directed incidences are sorted
    by source once, so each round's neighbour minimum is one
    ``np.minimum.reduceat`` over the vertices that have edges (their starts
    increase strictly, so every segment is non-empty).  Loops until every
    vertex is resolved: the unresolved vertex of least priority always
    joins."""
    d_src = np.concatenate([u, v])
    d_dst = np.concatenate([v, u])
    order = np.argsort(d_src, kind="stable")
    d_src, d_dst = d_src[order], d_dst[order]
    seg_starts = np.searchsorted(d_src, np.arange(n))
    has_edges = seg_starts < np.append(seg_starts[1:], len(d_src))
    red_idx = seg_starts[has_edges]
    state = np.zeros(n, np.int8)  # 0 unresolved, 1 seed, -1 blocked
    while True:
        un = state == 0
        if not un.any():
            break
        nbr_prio = np.where(un[d_dst] & un[d_src], prio[d_dst], n + 1)
        best_nbr = np.full(n, n + 1, np.int64)
        if len(red_idx):
            best_nbr[has_edges] = np.minimum.reduceat(nbr_prio, red_idx)
        new_seed = un & (prio < best_nbr)
        if not new_seed.any():  # unreachable: the least priority joins
            raise RuntimeError("MIS round made no progress")
        state[new_seed] = 1
        blocked = np.zeros(n, bool)
        blocked[v[state[u] == 1]] = True
        blocked[u[state[v] == 1]] = True
        state[blocked & (state == 0)] = -1
    return state


def _unique_edges_numpy(tris: np.ndarray, n: int):
    """The mesh's unique undirected edges (u < v), sorted, by a scalar-key
    unique: the plain version of ``native.topo_edges``'s edges."""
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.sort(e, axis=1)
    ukey = np.unique(e[:, 0] * np.int64(n) + e[:, 1])
    return ukey // n, ukey % n


def _unique_edges_native(tris: np.ndarray, n: int):
    head = native.topo_edges(tris, n)
    if head is None:
        raise ValueError(f"triangle indices out of range for {n} vertices")
    return head[0][:, 0].astype(np.int64), head[0][:, 1].astype(np.int64)


def _aggregate_once(pts: np.ndarray, tris: np.ndarray, rng, edges=None,
                    plain: bool = False):
    """One MIS-aggregation round: seeds are an MIS of the mesh graph, every
    other vertex joins its nearest adjacent seed, coarse vertices are the
    cluster centroids and coarse triangles the deduplicated label-distinct
    images of the fine ones.  ``edges``: unique undirected edges (i < j) of
    the mesh, else taken from the triangles.  The edges and the MIS come
    from the host library, or with ``plain`` from their numpy versions.
    Returns (coarse_pts, coarse_tris, label)."""
    n = pts.shape[0]
    if edges is not None:
        u = np.asarray(edges[:, 0], np.int64)
        v = np.asarray(edges[:, 1], np.int64)
    else:
        u, v = (_unique_edges_numpy if plain else _unique_edges_native)(tris, n)

    prio = rng.permutation(n).astype(np.int64)
    state = (_luby_mis_numpy if plain else native.mis_greedy)(u, v, n, prio)

    is_seed = state == 1
    seeds = np.where(is_seed)[0]
    seed_rank = np.full(n, -1, np.int64)
    seed_rank[seeds] = np.arange(len(seeds))

    # Every non-seed joins its nearest adjacent seed (argmin by a lexsort
    # over (vertex, distance) of the seed-incident edges).
    d2 = np.sum((pts[u] - pts[v]) ** 2, axis=1)
    cand_v = np.concatenate([u[is_seed[v]], v[is_seed[u]]])
    cand_s = np.concatenate([v[is_seed[v]], u[is_seed[u]]])
    cand_d = np.concatenate([d2[is_seed[v]], d2[is_seed[u]]])
    keep = ~is_seed[cand_v]
    cand_v, cand_s, cand_d = cand_v[keep], cand_s[keep], cand_d[keep]
    order = np.lexsort((cand_d, cand_v))
    first = np.ones(len(order), bool)
    first[1:] = cand_v[order[1:]] != cand_v[order[:-1]]
    label = np.full(n, -1, np.int64)
    label[is_seed] = seed_rank[is_seed]
    label[cand_v[order[first]]] = seed_rank[cand_s[order[first]]]
    # A vertex without a seed neighbour (none, for an MIS) is its own cluster.
    orphan = label < 0
    label[orphan] = len(seeds) + np.arange(int(orphan.sum()))
    uniq, label = np.unique(label, return_inverse=True)
    nc = len(uniq)
    coarse_pts = np.zeros((nc, 3))
    counts = np.bincount(label, minlength=nc).astype(np.float64)
    for d in range(3):
        coarse_pts[:, d] = np.bincount(label, weights=pts[:, d], minlength=nc)
    coarse_pts /= counts[:, None]
    ct = label[tris]
    keep = (
        (ct[:, 0] != ct[:, 1]) & (ct[:, 1] != ct[:, 2]) & (ct[:, 0] != ct[:, 2])
    )
    cts = np.sort(ct[keep], axis=1)
    if nc <= _PACKED_KEY_MAX_NC:  # nc^3 < 2^63: the packed key is exact
        tkey = np.unique(
            (cts[:, 0] * np.int64(nc) + cts[:, 1]) * nc + cts[:, 2]
        )
        ct = np.stack(
            [tkey // (nc * nc), (tkey // nc) % nc, tkey % nc], axis=1
        )
    else:  # the packed key would wrap int64; row-unique is exact at any size
        ct = np.unique(cts, axis=0)
    return coarse_pts, ct, label


def decimate(mesh: TriMesh, target_n: int, seed: int = 0, edges=None):
    """Aggregation decimation to about ``target_n`` vertices (a round
    contracts ~3.5-4x; rounds stop within 1.5x of the target, so the result
    lands in roughly [0.4, 1.5] * target_n).  ``edges``: the mesh's unique
    edges (its ``build_topology(...).edges``), used by the first round.

    Returns (coarse TriMesh, fine_to_coarse int64 [N], coarse_rep int64
    [Nc]), ``coarse_rep[j]`` the fine vertex nearest cluster j's centroid.
    On the host, the edges and the MIS in the host library; equal to the
    JAX package's ``decimate`` bit for bit."""
    return _decimate(mesh, target_n, seed, edges, plain=False)


def decimate_plain(mesh: TriMesh, target_n: int, seed: int = 0, edges=None):
    """:func:`decimate` over the numpy edges and MIS: its plain version."""
    return _decimate(mesh, target_n, seed, edges, plain=True)


def _decimate(mesh: TriMesh, target_n: int, seed: int, edges, plain: bool):
    pts = np.asarray(mesh.points, np.float64)
    tris = np.asarray(mesh.triangles, np.int64)
    rng = np.random.default_rng(seed)
    fine_to_coarse = np.arange(pts.shape[0])
    cur_pts, cur_tris = pts, tris
    first_edges = edges
    while cur_pts.shape[0] > 1.5 * target_n:
        before = cur_pts.shape[0]
        cur_pts, cur_tris, label = _aggregate_once(
            cur_pts, cur_tris, rng, edges=first_edges, plain=plain
        )
        first_edges = None
        fine_to_coarse = label[fine_to_coarse]
        if cur_pts.shape[0] >= before:  # no progress (degenerate mesh)
            break
    d2 = np.sum((pts - cur_pts[fine_to_coarse]) ** 2, axis=1)
    order = np.lexsort((d2, fine_to_coarse))
    first = np.ones(len(order), bool)
    first[1:] = fine_to_coarse[order[1:]] != fine_to_coarse[order[:-1]]
    rep = np.zeros(cur_pts.shape[0], np.int64)
    rep[fine_to_coarse[order[first]]] = order[first]
    coarse = TriMesh(
        np.asarray(cur_pts, np.float32), np.asarray(cur_tris, np.int32)
    )
    return coarse, fine_to_coarse, rep


def _weight_coords(graph: GraphArrays, cfg: PipelineConfig):
    """Coordinates the smoothing weights derive from: xyz, or xyz with the
    node features scaled by the mean axis range appended when
    ``include_features_in_adj_matrix`` (as ``pipeline._spectrum`` builds its
    edge weights)."""
    feats = graph.node_features
    if not (cfg.include_features_in_adj_matrix and feats.shape[1] > 0):
        return graph.points
    mean_range = _normed_points(graph)[1]
    return torch.cat(
        [graph.points, feats * mean_range * graph.valid_mask[:, None]], dim=1
    )


def _smooth(graph: GraphArrays, values, iterations: int, cfg: PipelineConfig):
    """``values`` smoothed over ``graph`` by the configured filter, with the
    edge weights of :func:`_weight_coords`."""
    wc = _weight_coords(graph, cfg)
    w = graph_ops.edge_weights(wc, graph.neighbors, graph.nbr_mask)
    ov_w = graph_ops.overflow_weights(wc, graph.overflow)
    return _smooth_fn(cfg)(graph.neighbors, w, values, iterations,
                           graph.overflow, ov_w)


@f32_matmuls
def _refine_fine_level(target: GraphArrays, source: GraphArrays, init_corr,
                       cfg: PipelineConfig, ckpt=None):
    """Fine-resolution refinement from ``init_corr`` (int64 [Ns]): the
    smoothing and final-location tail of ``register_pair`` without spectra
    or CPD.  ``ckpt``: a :class:`StageCheckpointer` that serves or saves the
    two smoothings as ``refine_smoothed_target`` and ``refine_projected``.
    Returns the JAX package's seven keys."""
    corr = init_corr
    smoothed_tgt = target.points
    projected = source.points
    if cfg.smooth_correspondences:
        def smooth_target():
            return _smooth(target, target.points, cfg.graph_smoothing_iterations, cfg)

        smoothed_tgt = (ckpt.get_or("refine_smoothed_target", smooth_target)
                        if ckpt is not None else smooth_target())

        def smooth_projection():
            return _smooth(source, smoothed_tgt[init_corr],
                           cfg.projection_smooth_iterations, cfg)

        projected = (ckpt.get_or("refine_projected", smooth_projection)
                     if ckpt is not None else smooth_projection())
    # One k=3 query: column 0 is the final correspondence, all three give
    # the inverse-distance locations.
    d3, i3 = knn3_masked(smoothed_tgt, target.valid_mask, projected)
    if cfg.smooth_correspondences:
        corr = i3[:, 0]
    weighted = idw_from_knn(d3, i3, target.points)
    smask = source.valid_mask[:, None]
    svalid = source.valid_mask.to(torch.int64)
    return {
        "correspondences": corr * svalid,
        "initial_correspondences": init_corr * svalid,
        "nearest_points": target.points[corr] * smask,
        "weighted_points": weighted * smask,
        "average_points": (source.points + weighted) / 2.0 * smask,
        "smoothed_target_coords": smoothed_tgt * target.valid_mask[:, None],
        "source_projected_on_target": projected * smask,
    }


def _aggregate_features(feats, label, nc):
    """Cluster means of per-vertex features on the coarse mesh (f32)."""
    acc = np.stack(
        [
            np.bincount(
                label, weights=feats[:, k].astype(np.float64), minlength=nc
            )
            for k in range(feats.shape[1])
        ],
        axis=1,
    )
    cnt = np.bincount(label, minlength=nc).astype(np.float64)[:, None]
    return (acc / np.maximum(cnt, 1.0)).astype(np.float32)


def _map_landmarks(landmark_pairs, map_t, map_s, target_mesh, source_mesh):
    """Fine (source_vertex, target_vertex) pins, checked against the fine
    meshes and mapped through the cluster labels; of several pins in one
    coarse source cluster the first is kept.  Returns int64 [L, 2]."""
    lm = np.asarray(landmark_pairs, np.int64)
    if lm.ndim != 2 or lm.shape[1] != 2:
        raise ValueError(f"landmark_pairs must be [L, 2], got {lm.shape}")
    if lm.size and (
        lm[:, 0].min() < 0
        or lm[:, 0].max() >= source_mesh.n_points
        or lm[:, 1].min() < 0
        or lm[:, 1].max() >= target_mesh.n_points
    ):
        raise ValueError(
            "landmark_pairs index out of range for the FINE meshes "
            f"(source {source_mesh.n_points}, target "
            f"{target_mesh.n_points} vertices)"
        )
    c = np.stack([map_s[lm[:, 0]], map_t[lm[:, 1]]], axis=1)
    _, first = np.unique(c[:, 0], return_index=True)
    return c[np.sort(first)]


def _run_fingerprint(target_mesh, source_mesh, cfg, generator, coarse_n, seed,
                     landmark_pairs, node_features, level_ratio) -> str:
    """Hash of every input of :func:`register_pair_multires` that
    determines its outputs: the stage checkpoints' validity token.  The
    generator's state at entry stands for JAX's key, the config's fields
    for its ``repr``.  Mesh point_data is left out (the registration never
    reads it)."""
    h = hashlib.sha256()
    h.update(b"pyfocusr_tpu_torch-multires-ckpt-v1")
    for arr in (target_mesh.points, target_mesh.triangles,
                source_mesh.points, source_mesh.triangles):
        a = arr.detach().cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    h.update(repr(sorted(dataclasses.asdict(cfg).items())).encode())
    h.update(b"none" if generator is None
             else generator.get_state().numpy().tobytes())
    h.update(str((int(coarse_n), int(seed), float(level_ratio or 0))).encode())
    if landmark_pairs is not None:
        h.update(np.asarray(landmark_pairs, np.int64).tobytes())
    if node_features is not None:
        for f in node_features:
            a = np.asarray(f, np.float32)
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _check_inputs(target_mesh, source_mesh, cfg, node_features, device_mesh,
                  checkpoint_dir, draws):
    """The JAX package's input checks (:593-643); returns the fine features
    as f32 numpy (or Nones)."""
    if device_mesh is not None:
        raise _not_ported("register_pair_multires(device_mesh=...), the "
                          "vertex-sharded refine of parallel/bigmesh", "9")
    if checkpoint_dir is not None and draws is not None:
        raise ValueError(
            "checkpoint_dir cannot be combined with a draws callable: the "
            "run's fingerprint cannot hash a function"
        )
    if "hungarian" in (cfg.final_correspondence_type,
                       cfg.initial_correspondence_type):
        # At the coarse level the two independently decimated meshes rarely
        # have the equal vertex counts 'hungarian' needs.
        raise ValueError(
            "register_pair_multires uses 'kd' correspondences at every "
            "level; 'hungarian' at full resolution defeats the multi"
            "resolution decomposition, and at the coarse level the two "
            "independently decimated meshes rarely have the equal vertex "
            "counts it requires (set initial/final_correspondence_type='kd')"
        )
    if (cfg.use_features_as_coords or cfg.use_features_in_graph
            or cfg.include_features_in_adj_matrix) and node_features is None:
        raise ValueError(
            "feature-weighted configs need node_features=(target_feats, "
            "source_feats) — fine-resolution normalized [N, K] arrays; "
            "decimation aggregates them per cluster for the coarse level"
        )
    if node_features is None:
        return None, None
    feats_t, feats_s = (np.asarray(f, np.float32) for f in node_features)
    if (feats_t.ndim != 2 or feats_s.ndim != 2
            or feats_t.shape[0] != target_mesh.n_points
            or feats_s.shape[0] != source_mesh.n_points
            or feats_t.shape[1] != feats_s.shape[1]):
        raise ValueError(
            "node_features must be ([N_target, K], [N_source, K]) "
            f"matching the fine meshes; got {feats_t.shape} and "
            f"{feats_s.shape}"
        )
    return feats_t, feats_s


def register_pair_multires(target_mesh: TriMesh, source_mesh: TriMesh,
                           cfg: PipelineConfig, generator: torch.Generator = None,
                           coarse_n: int = 12000, seed: int = 0,
                           device_mesh=None, landmark_pairs=None,
                           node_features=None, topologies=None,
                           checkpoint_dir: str = None, level_ratio: float = 100.0,
                           draws=None, device=None):
    """Full-resolution registration of a mesh pair of any size.

    1. Decimate both meshes to about ``coarse_n`` vertices (host, seeds
       ``seed`` and ``seed + 1``).
    2. Register the coarse pair with :func:`register_pair`.
    3. Prolong: fine source vertex -> its coarse cluster -> the coarse
       correspondence -> that cluster's representative fine target vertex.
    4. Refine at full resolution: smoothing with
       ``projection_smooth_iterations`` raised to min(5 ratio, max(100,
       ratio)) for a contraction ratio ``ratio``, then one k=3 query.

    ``level_ratio``: where the fine-to-coarse jump exceeds it, an
    intermediate level is inserted at the geometric mean (or at
    ceil(n / level_ratio), whichever is larger) and registered by the same
    function, recursively; 0 or None for a single jump.

    ``generator``: the coarsest level's ``register_pair`` draws from it
    (None: a generator seeded 0, as there).  ``draws``: instead, a callable
    ``(coarse_target_graph, coarse_source_graph, n_landmarks) -> dict``
    called once, for the coarsest level's ``register_pair``.

    ``landmark_pairs`` (int [L, 2] fine (source_vertex, target_vertex)):
    mapped through the clusters, deduplicated, and applied to the coarse
    registration.  ``node_features`` (``(target [Nt, K], source [Ns, K])``):
    averaged per cluster for the coarse level; the refine's smoothing
    weights carry them with ``include_features_in_adj_matrix``.
    ``topologies``: the meshes' ``build_topology`` results, when the caller
    has them.

    ``checkpoint_dir``: finished stages are saved there and a later call
    with the same inputs resumes from them: the coarse solve with the
    prolonged initial correspondences always (each intermediate level in a
    ``level_<n>`` subdirectory), the two smoothings too where the larger
    mesh has ``PYFOCUSR_TPU_STAGED_REFINE_N`` (600000) vertices or more.
    Each file carries a fingerprint of every input (meshes, cfg, the
    generator's state at entry, coarse_n, seed, level_ratio, landmarks,
    features); a mismatch recomputes.  The files load in either package's
    ``load_results``, but a JAX run's fingerprint never matches a port
    run's, so a run does not resume from the other package's stages.

    ``device``: where the registration runs, the CUDA card when None.
    ``device_mesh`` (a sharded refine) is not ported and raises.

    Returns (fine results: the refine's seven keys at full resolution,
    coarse results: ``register_pair``'s dict, or the next level's fine
    results where an intermediate level ran).
    """
    feats_t, feats_s = _check_inputs(target_mesh, source_mesh, cfg,
                                     node_features, device_mesh,
                                     checkpoint_dir, draws)
    device = resolve_device(device)
    if topologies is not None:
        topo_t, topo_s = topologies
    else:
        topo_t = build_topology(np.asarray(target_mesh.triangles), target_mesh.n_points)
        topo_s = build_topology(np.asarray(source_mesh.triangles), source_mesh.n_points)
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = StageCheckpointer(
            checkpoint_dir,
            _run_fingerprint(target_mesh, source_mesh, cfg, generator, coarse_n,
                             seed, landmark_pairs, node_features, level_ratio),
            device=device,
        )
        saved = ckpt.load("coarse")
        if saved is not None:
            init_fine = saved.pop("__init_fine__")
            cs_n = int(saved.pop("__coarse_source_n__"))
            return _finish(target_mesh, source_mesh, cfg, init_fine, cs_n, saved,
                           topo_t, topo_s, feats_t, feats_s, ckpt, device)

    n_fine = max(target_mesh.n_points, source_mesh.n_points)
    if level_ratio and n_fine > level_ratio * max(coarse_n, 1):
        # The geometric mean, but never a fine-side jump above level_ratio;
        # the recursion splits the coarse side further.
        mid_n = max(int(round(math.sqrt(float(n_fine) * coarse_n))),
                    -(-n_fine // int(level_ratio)))
        mt_mesh, mmap_t, mrep_t = decimate(target_mesh, mid_n, seed, edges=topo_t.edges)
        ms_mesh, mmap_s, _ = decimate(source_mesh, mid_n, seed + 1, edges=topo_s.edges)
        if max(mt_mesh.n_points, ms_mesh.n_points) < 0.8 * n_fine:
            mid_feats = None
            if feats_t is not None:
                mid_feats = (_aggregate_features(feats_t, mmap_t, mt_mesh.n_points),
                             _aggregate_features(feats_s, mmap_s, ms_mesh.n_points))
            mid_lm = None
            if landmark_pairs is not None:
                mid_lm = _map_landmarks(landmark_pairs, mmap_t, mmap_s,
                                        target_mesh, source_mesh)
            mid_res, _ = register_pair_multires(
                mt_mesh, ms_mesh, cfg, generator, coarse_n=coarse_n, seed=seed,
                landmark_pairs=mid_lm, node_features=mid_feats,
                checkpoint_dir=(None if checkpoint_dir is None else os.path.join(
                    checkpoint_dir, f"level_{mt_mesh.n_points}")),
                level_ratio=level_ratio, draws=draws, device=device,
            )
            init_fine = _prolong(mrep_t, mid_res["correspondences"], mmap_s, device)
            return _save_coarse_and_finish(
                target_mesh, source_mesh, cfg, init_fine, ms_mesh.n_points,
                mid_res, topo_t, topo_s, feats_t, feats_s, ckpt, device)
        # Decimation stalled short of a useful level: one jump instead.

    ct_mesh, map_t, rep_t = decimate(target_mesh, coarse_n, seed, edges=topo_t.edges)
    cs_mesh, map_s, _ = decimate(source_mesh, coarse_n, seed + 1, edges=topo_s.edges)
    cf_t = cf_s = None
    if feats_t is not None:
        cf_t = _aggregate_features(feats_t, map_t, ct_mesh.n_points)
        cf_s = _aggregate_features(feats_s, map_s, cs_mesh.n_points)
    ct = mesh_to_graph_arrays(ct_mesh, node_features=cf_t, device=device)
    cs = mesh_to_graph_arrays(cs_mesh, node_features=cf_s, device=device)
    lm_coarse = None
    if landmark_pairs is not None:
        lm_coarse = _map_landmarks(landmark_pairs, map_t, map_s, target_mesh,
                                   source_mesh)
        # The coarse CPD subsample must exceed the pin count.
        n_reg_coarse = min(cfg.n_coords_spectral_registration,
                           ct_mesh.n_points, cs_mesh.n_points)
        if len(lm_coarse) >= n_reg_coarse:
            raise ValueError(
                f"{len(lm_coarse)} landmark pins survive decimation but the "
                f"coarse CPD subsample is only {n_reg_coarse} points; raise "
                "coarse_n (more clusters) or thin the landmarks"
            )
    n_lm = 0 if lm_coarse is None else len(lm_coarse)
    coarse_res = register_pair(
        ct, cs, cfg, generator,
        draws=None if draws is None else draws(ct, cs, n_lm),
        landmark_pairs=lm_coarse,
    )
    init_fine = _prolong(rep_t, coarse_res["correspondences"], map_s, device)
    return _save_coarse_and_finish(
        target_mesh, source_mesh, cfg, init_fine, cs_mesh.n_points, coarse_res,
        topo_t, topo_s, feats_t, feats_s, ckpt, device)


def _prolong(rep_t, coarse_corr, map_s, device):
    """Fine initial correspondences rep_t[coarse_corr[map_s]], int64 on
    ``device``."""
    corr = coarse_corr.detach().cpu().numpy().astype(np.int64)
    return torch.from_numpy(rep_t[corr[map_s]]).to(device)


def _save_coarse_and_finish(target_mesh, source_mesh, cfg, init_fine, cs_n,
                            coarse_res, topo_t, topo_s, feats_t, feats_s, ckpt,
                            device):
    """Save the "coarse" stage (the coarse dict, the prolonged initial
    correspondences and the coarse source size that sets the smoothing
    budget), then run the fine half."""
    if ckpt is not None:
        ckpt.save("coarse", {**coarse_res, "__init_fine__": init_fine,
                             "__coarse_source_n__": np.int64(cs_n)})
    return _finish(target_mesh, source_mesh, cfg, init_fine, cs_n, coarse_res,
                   topo_t, topo_s, feats_t, feats_s, ckpt, device)


def _finish(target_mesh, source_mesh, cfg, init_fine, cs_n, coarse_res, topo_t,
            topo_s, feats_t, feats_s, ckpt, device):
    """The fine half of :func:`register_pair_multires`, entered from the
    coarse solve or from its checkpoint."""
    # The prolonged correspondences are constant over clusters of ~ratio
    # fine vertices, so the projection smoothing must diffuse far enough to
    # separate them: ~5 ratio iterations, capped at max(100, ratio); a
    # larger configured value is kept (the JAX package's measurements, :816-833).
    ratio = source_mesh.n_points / max(cs_n, 1)
    proj_iters = max(cfg.projection_smooth_iterations,
                     min(int(round(5.0 * ratio)), max(100, int(round(ratio)))))
    fine_cfg = dataclasses.replace(cfg, projection_smooth_iterations=proj_iters)
    tg = mesh_to_graph_arrays(target_mesh, topology=topo_t, node_features=feats_t,
                              device=device)
    sg = mesh_to_graph_arrays(source_mesh, topology=topo_s, node_features=feats_s,
                              device=device)
    staged = _STAGED_REFINE_N > 0 and max(tg.n_points, sg.n_points) >= _STAGED_REFINE_N
    fine_res = _refine_fine_level(tg, sg, init_fine.to(device), fine_cfg,
                                  ckpt=ckpt if staged else None)
    return fine_res, coarse_res
