"""Cohort registration: one template registered to many subjects, and the
statistical shape model (SSM) built from the corresponded shapes.

Counterpart of ``pyfocusr_tpu/parallel/cohort.py``: ``pad_cohort`` (:62),
``stack_graph_arrays`` (:86), ``check_cohort_config`` (:120),
``register_cohort`` (:164), ``iterate_template`` (:258),
``build_ssm_template`` (:346), ``cohort_shape_modes`` (:383),
``ssm_project`` (:434), ``ssm_sample`` (:478), ``fit_subject_to_ssm``
(:524), ``cohort_mean_shape`` (:548) and ``all_pairs_surface_errors``
(:555), with the JAX package's names and arguments save two:

* randomness is an input, as everywhere in the port: where JAX takes a
  ``key``, these take a ``generator`` (a ``torch.Generator`` that seeds the
  draws) or explicit ``draws`` (:func:`make_cohort_draws`);
* each lane (subject) draws its eigensolver refill noise from a generator
  of its own, seeded from a hash of the lane's draws
  (:func:`lane_generator`), as JAX splits its key per lane (:207): a
  lane's result does not depend on the lanes run before it, nor on the
  rank that runs it.

JAX vmaps one ``register_pair`` program over the cohort axis
(:108-118).  The port loops over the subjects on the device and stacks
their results on a leading axis: the same values, lane by lane.  With a
``device_mesh`` (``parallel/distributed.py``: a ``DeviceMesh`` with a
``'cohort'`` dimension) every rank calls the function with the same
inputs, makes the whole cohort's draws, prepares the template itself and
registers the contiguous block of subjects it owns on its device; the
lanes are all-gathered and the mean is the all-reduced sum of the
``weighted_points`` over the batch (:239-247), so every rank returns the
global results.  Functions
that build tensors from meshes or arrays take ``device`` (the CUDA card
when None, see ``utils.device.resolve_device``); tensors are used where
they lie.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, Sequence

import numpy as np
import torch

from ..mesh import TriMesh, build_topology
from ..ops.icp import apply_rigid, icp, umeyama
from ..ops.knn import nn_query
from ..pipeline import (
    GraphArrays,
    PipelineConfig,
    _start_width,
    draw_seed,
    make_draws,
    mesh_to_graph_arrays,
    prepare_source,
    register_pair,
    register_pair_prepared_source,
    source_spectrum_hoistable,
)
from ..utils.device import resolve_device, to_numpy
from ..utils.precision import full_f32
from .distributed import (
    axis_rank,
    axis_size,
    check_axis,
    gather_results,
    is_first_rank,
    psum,
    rank_device,
)

__all__ = [
    "stack_graph_arrays",
    "pad_cohort",
    "check_cohort_config",
    "make_cohort_draws",
    "register_cohort",
    "iterate_template",
    "build_ssm_template",
    "cohort_shape_modes",
    "ssm_project",
    "ssm_sample",
    "fit_subject_to_ssm",
    "cohort_mean_shape",
    "all_pairs_surface_errors",
    "lane_generator",
]


# Bytes of each draw that seed a lane's generator: the leading rows of a
# draw are as random as the rest, and hashing a 10242-row start block
# whole took 7.5 ms a lane on the host.
_LANE_SEED_BYTES = 1 << 16


def lane_generator(draws) -> torch.Generator:
    """The generator one lane of a many-pair call draws its eigensolver
    refill noise from: a CPU generator seeded from a hash of the lane's own
    draws (a mapping name -> array; each draw's name, dtype, shape and
    first ``_LANE_SEED_BYTES`` bytes), so the same draws give the same
    noise wherever and after whatever the lane runs."""
    h = hashlib.sha256()
    for name in sorted(draws):
        a = np.ascontiguousarray(to_numpy(draws[name]))
        h.update(f"{name}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.reshape(-1).view(np.uint8)[:_LANE_SEED_BYTES])
    return torch.Generator().manual_seed(int.from_bytes(h.digest()[:8], "little") >> 1)


def _device_of(*arrays, device=None) -> torch.device:
    """``device`` when given, else where the first tensor among ``arrays``
    lies, else the CUDA card."""
    if device is not None:
        return torch.device(device)
    for a in arrays:
        if torch.is_tensor(a):
            return a.device
    return resolve_device(None)


def _f32(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def pad_cohort(meshes: Sequence[TriMesh], device=None) -> List[GraphArrays]:
    """Pad a list of meshes to common (n_points, degree, components,
    overflow edges) for stacking; each mesh's topology is built once."""
    topos = [build_topology(np.asarray(m.triangles), m.n_points) for m in meshes]
    n_pad = max(m.n_points for m in meshes)
    d_pad = max(t.max_degree for t in topos)
    c_pad = max(max(t.n_components, 1) for t in topos)
    e_pad = max(t.overflow_edges.shape[0] for t in topos)
    return [
        mesh_to_graph_arrays(m, device=device, topology=t, pad_n_points=n_pad,
                             pad_degree=d_pad, pad_components=c_pad,
                             pad_overflow=e_pad)
        for m, t in zip(meshes, topos)
    ]


def stack_graph_arrays(graphs: Sequence[GraphArrays]) -> GraphArrays:
    """Stack equal-shape graphs along a new leading cohort axis (the JAX
    package's patch-plan branch has no counterpart: the port has no patch
    plans)."""
    return GraphArrays(**{
        f.name: torch.stack([getattr(g, f.name) for g in graphs])
        for f in dataclasses.fields(GraphArrays)})


def _lane(targets: GraphArrays, i: int) -> GraphArrays:
    return GraphArrays(**{f.name: getattr(targets, f.name)[i]
                          for f in dataclasses.fields(GraphArrays)})


def check_cohort_config(meshes_min_points: int, cfg: PipelineConfig,
                        padded_size: int | None = None) -> None:
    """Padded-cohort hazards, with the JAX package's messages: subsample
    sizes above the smallest real vertex count (the ICP landmark draw too
    when the cohort is padded), and 'hungarian' correspondences on a padded
    cohort (padding rows would take part in the one-to-one assignment)."""
    knobs = ["n_coords_spectral_ordering", "n_coords_spectral_registration"]
    padded = padded_size is not None and padded_size > meshes_min_points
    if cfg.icp_register_first and padded:
        knobs.append("icp_n_landmarks")
    for name in knobs:
        if getattr(cfg, name) > meshes_min_points:
            raise ValueError(
                f"{name}={getattr(cfg, name)} exceeds the smallest cohort "
                f"mesh size {meshes_min_points}; padding rows would leak "
                "into subsamples. Lower it to at most the smallest real "
                "vertex count."
            )
    use_hungarian = "hungarian" in (cfg.initial_correspondence_type,
                                    cfg.final_correspondence_type)
    if use_hungarian and padded:
        raise ValueError(
            "'hungarian' correspondences need unpadded equal-size graphs: "
            f"the cohort is padded to {padded_size} rows but the smallest "
            f"mesh has {meshes_min_points} real vertices, so padding rows "
            "would participate in the one-to-one assignment. Use "
            "correspondence type 'kd' for padded cohorts."
        )


def _real_counts(template: GraphArrays, targets: GraphArrays):
    """(the template's real vertex count, each subject's), in one read."""
    counts = torch.cat([(template.valid_mask > 0).sum().reshape(1),
                        (targets.valid_mask > 0).sum(dim=1)]).tolist()
    return int(counts[0]), [int(c) for c in counts[1:]]


def make_cohort_draws(seed: int, cfg: PipelineConfig, template: GraphArrays,
                      targets: GraphArrays):
    """The random inputs of :func:`register_cohort`, drawn with numpy from
    ``seed``: ``{"pairs": [one make_draws dict per subject], "template_block":
    the template's cold-solve start}`` (an ``eig_block_source`` of
    :func:`pipeline.make_draws` on the wide path, an ``eig_start_source``
    on the others).  Each subject's draws index real rows only.  The seeds
    of the subjects and of the template are drawn first, one each, as JAX
    splits its key per lane and folds it in for the template (:207-213)."""
    batch, n_t = targets.points.shape[0], targets.points.shape[1]
    n_s = template.n_points
    real_s, real_t = _real_counts(template, targets)
    seeds = np.random.default_rng(seed).integers(0, 2**62, size=batch + 1)
    pairs = [make_draws(int(seeds[i]), cfg, n_t, n_s, real_target=real_t[i],
                        real_source=real_s) for i in range(batch)]
    block = np.random.default_rng(int(seeds[batch])).standard_normal(
        (n_s, _start_width(cfg, n_s))).astype(np.float32)
    return {"pairs": pairs, "template_block": block}


def register_cohort(template: GraphArrays, targets: GraphArrays,
                    cfg: PipelineConfig, generator: torch.Generator = None,
                    device_mesh=None, prepared_template: bool | None = None,
                    draws=None):
    """Register the template (as source) to every subject of ``targets``
    (stacked graphs, leading cohort axis).  Returns (each result key
    stacked on axis 0, the mean of ``weighted_points`` over the cohort
    [N, 3]); ``weighted_points`` lie in template vertex order.

    ``prepared_template`` hoists the template's eigensolve out of the
    per-subject loop (:func:`pipeline.prepare_source`, once): None enables
    it where :func:`pipeline.source_spectrum_hoistable` allows, True
    forces it (raising where it does not), False solves per pair.
    ``draws``: from :func:`make_cohort_draws`; when None they are drawn
    from ``generator`` (a fresh one seeded 0 when that is None too).  Each
    lane's refill noise comes from :func:`lane_generator` of its draws, the
    template's from that of ``draws["template_block"]``.

    ``device_mesh``: shard the subjects over its ``'cohort'`` dimension
    (the batch must be divisible by its size); every rank passes the same
    arguments and gets the global results on its device."""
    batch = targets.points.shape[0]
    real_s, real_t = _real_counts(template, targets)
    check_cohort_config(min(min(real_t), real_s), cfg,
                        padded_size=max(template.n_points, targets.points.shape[1]))
    lanes = range(batch)
    if device_mesh is not None:
        check_axis(device_mesh, "cohort", "register_cohort")
        n_dev = axis_size(device_mesh, "cohort")
        if batch % n_dev != 0:
            raise ValueError(
                f"cohort size {batch} must be divisible by device count {n_dev}"
            )
        per = batch // n_dev
        lanes = range(axis_rank(device_mesh, "cohort") * per,
                      (axis_rank(device_mesh, "cohort") + 1) * per)
        template = template.to(rank_device(device_mesh))
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = make_cohort_draws(draw_seed(generator), cfg, template, targets)
    if len(draws["pairs"]) != batch:
        raise ValueError(
            f"draws hold {len(draws['pairs'])} pairs for a cohort of {batch}")
    if prepared_template is None:
        prepared_template = source_spectrum_hoistable(cfg)
    prep = (prepare_source(template, cfg, draws["template_block"],
                           generator=lane_generator({"template_block": draws["template_block"]}))
            if prepared_template else None)
    rows = []
    for i in lanes:
        lane = _lane(targets, i).to(template.device)
        lane_draws = draws["pairs"][i]
        if prep is None:
            rows.append(register_pair(lane, template, cfg,
                                      generator=lane_generator(lane_draws),
                                      draws=lane_draws))
        else:
            rows.append(register_pair_prepared_source(
                prep, lane, template, cfg, generator=lane_generator(lane_draws),
                draws=lane_draws))
    results = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    if device_mesh is None:
        return results, results["weighted_points"].mean(dim=0)
    total = psum(results["weighted_points"].sum(dim=0), device_mesh, "cohort")
    gathered = gather_results(results, device_mesh, "cohort")
    return {k: gathered[k] for k in results}, total / batch


def iterate_template(template: GraphArrays, targets: GraphArrays,
                     cfg: PipelineConfig, generator: torch.Generator = None,
                     n_iterations: int = 3, device_mesh=None,
                     tolerance: float = 0.0, procrustes: bool = True,
                     checkpoint_dir: str | None = None, draws=None):
    """Groupwise template iteration, the SSM loop: each round registers the
    template to every subject (:func:`register_cohort`) and moves its real
    vertices to the cohort mean; padding rows keep their points.

    ``procrustes`` (default) first aligns each round's mean rigidly onto
    the previous template (``umeyama`` without scale, weighted by
    ``valid_mask``, the close kernel on the card), so no global pose drift
    accumulates.  Motion is the mean norm of the real vertices' moves.
    Stops early once motion < ``tolerance`` (if nonzero).
    ``checkpoint_dir`` writes ``template_round_{round:03d}.npz`` (``points``,
    ``motion`` so far) after each round.  ``draws``: one
    :func:`make_cohort_draws` result per round; when None each round draws
    from ``generator``.  ``device_mesh``: each round's
    :func:`register_cohort` is sharded over it; every rank runs the rounds
    on its device (the template moves there) and the mesh's first rank
    writes the checkpoints.

    Returns ``(template, results of the last round, motions)``."""
    if device_mesh is not None:
        template = template.to(rank_device(device_mesh))
    valid = template.valid_mask
    n_valid = torch.clamp(valid.sum(), min=1.0)
    motions: List[float] = []
    results = None
    for r in range(int(n_iterations)):
        results, mean_shape = register_cohort(
            template, targets, cfg, generator=generator, device_mesh=device_mesh,
            draws=None if draws is None else draws[r])
        if procrustes:
            with full_f32():
                s_, R_, t_ = umeyama(mean_shape, template.points, with_scale=False,
                                     weights=valid)
                mean_shape = apply_rigid(mean_shape, s_, R_, t_)
        new_pts = torch.where(valid[:, None] > 0, mean_shape, template.points)
        motion = float(((new_pts - template.points).norm(dim=1) * valid).sum()
                       / n_valid)
        template = dataclasses.replace(template, points=new_pts)
        motions.append(motion)
        if checkpoint_dir and (device_mesh is None or is_first_rank(device_mesh)):
            os.makedirs(checkpoint_dir, exist_ok=True)
            np.savez(
                os.path.join(checkpoint_dir, f"template_round_{len(motions):03d}.npz"),
                points=template.points.cpu().numpy(), motion=np.asarray(motions))
        if tolerance and motion < tolerance:
            break
    return template, results, motions


def build_ssm_template(meshes: Sequence[TriMesh], cfg: PipelineConfig,
                       generator: torch.Generator = None, n_iterations: int = 3,
                       template_index: int = 0, device_mesh=None,
                       tolerance: float = 0.0, procrustes: bool = True,
                       draws=None, device=None):
    """SSM template from raw meshes: pad and stack the cohort on
    ``device``, seed the template from ``meshes[template_index]`` (which
    stays a subject), run :func:`iterate_template`, and return
    ``(template_mesh, results, motions)``, ``template_mesh`` a
    :class:`TriMesh` on the seed subject's topology with the converged
    geometry.  ``device_mesh``: the rounds are sharded over its
    ``'cohort'`` dimension, on each rank's device unless ``device`` is
    given."""
    if device_mesh is not None and device is None:
        device = rank_device(device_mesh)
    meshes = list(meshes)
    graphs = pad_cohort(meshes, device=device)
    template, results, motions = iterate_template(
        graphs[template_index], stack_graph_arrays(graphs), cfg,
        generator=generator, n_iterations=n_iterations, device_mesh=device_mesh,
        tolerance=tolerance, procrustes=procrustes, draws=draws)
    n_real = meshes[template_index].n_points
    template_mesh = TriMesh(template.points[:n_real].cpu().numpy(),
                            meshes[template_index].triangles)
    return template_mesh, results, motions


def cohort_shape_modes(corresponded_points, n_modes: int | None = None,
                       device=None):
    """PCA of corresponded shapes ``[B, N, 3]`` (template vertex order, as
    ``register_cohort``'s ``weighted_points``): ``(mean [N, 3], modes
    [m, N, 3], variances [m])``, unit modes by descending variance; a shape
    is ``mean + sum_i b_i sqrt(variances[i]) modes[i]``.  At most B - 1
    modes are nonzero; ``n_modes`` truncates further.  The PCA goes
    through the [B, B] Gram of the centred shapes in f32 with TF32 off."""
    P = _f32(corresponded_points, _device_of(corresponded_points, device=device))
    B, N, D = P.shape
    flat = P.reshape(B, N * D)
    mean = flat.mean(dim=0)
    C = flat - mean[None, :]
    with full_f32():
        gram = (C @ C.T) / max(B - 1, 1)
        evals, evecs = torch.linalg.eigh(gram)  # ascending
        m = min(n_modes, B) if n_modes is not None else B
        idx = torch.arange(B - 1, B - 1 - m, -1, device=P.device)
        variances = torch.clamp(evals[idx], min=0.0)
        # Columns at the f32 noise floor are zeroed, not normalized: their
        # raw vector is noise inside span(C), and a normalized one would
        # be a direction not orthogonal to the real modes (ssm_project
        # would count its energy twice).
        raw = C.T @ evecs[:, idx]
    norms = raw.norm(dim=0, keepdim=True)
    valid = variances > 1e-6 * torch.clamp(variances[0], min=1e-30)
    modes = torch.where(valid[None, :], raw / torch.clamp(norms, min=1e-20),
                        torch.zeros_like(raw))
    return mean.reshape(N, D), modes.T.reshape(m, N, D), variances


def ssm_project(points, mean, modes, variances=None, n_modes: int | None = None,
                device=None):
    """Project a corresponded shape [N, 3] onto a mode basis: ``(coeffs
    [m'], reconstruction [N, 3], residual_rms)``.  ``coeffs[i] =
    <modes[i], points - mean>``, divided by ``sqrt(variances[i])``
    (standard-deviation units, what :func:`ssm_sample` takes) when
    ``variances`` is given; ``n_modes`` truncates the basis."""
    dev = _device_of(points, mean, modes, device=device)
    P, mean, modes = _f32(points, dev), _f32(mean, dev), _f32(modes, dev)
    if n_modes is not None:
        modes = modes[:n_modes]
    m = modes.shape[0]
    N, D = mean.shape
    with full_f32():
        coeffs = modes.reshape(m, N * D) @ (P - mean).reshape(N * D)
        recon = mean + torch.tensordot(coeffs, modes, dims=1)
    if variances is not None:
        sig = torch.sqrt(torch.clamp(_f32(variances, dev), min=0.0))
        coeffs = coeffs / torch.clamp(sig[:m], min=1e-30)
    residual_rms = torch.sqrt(((P - recon) ** 2).sum(dim=1).mean())
    return coeffs, recon, residual_rms


def ssm_sample(mean, modes, variances, b=None, generator: torch.Generator = None,
               n_samples: int = 1, clip_std: float = 3.0, device=None):
    """Shapes from the SSM, ``mean + sum_i b_i sqrt(variances[i])
    modes[i]``: from explicit ``b`` ([m] for one shape, [S, m] for S) or
    ``n_samples`` standard normal coefficient vectors from ``generator``,
    clipped to +-``clip_std``.  Exactly one of the two.  Returns [N, 3]
    when ``b`` is 1-D, else [S, N, 3]."""
    dev = _device_of(mean, modes, variances, device=device)
    mean, modes = _f32(mean, dev), _f32(modes, dev)
    sig = torch.sqrt(torch.clamp(_f32(variances, dev), min=0.0))
    m = modes.shape[0]
    if (b is None) == (generator is None):
        raise ValueError("pass exactly one of b= (coefficients) or generator=")
    if b is None:
        b = torch.clamp(torch.randn((n_samples, m), generator=generator,
                                    device=generator.device), -clip_std, clip_std)
    b = _f32(b, dev)
    squeeze = b.dim() == 1
    b2 = b[None, :] if squeeze else b
    if b2.shape[1] != m:
        raise ValueError(f"coefficient length {b2.shape[1]} != number of modes {m}")
    with full_f32():
        shapes = mean[None] + torch.tensordot(b2 * sig[None, :], modes, dims=1)
    return shapes[0] if squeeze else shapes


def fit_subject_to_ssm(subject_mesh: TriMesh, template_mesh: TriMesh, mean, modes,
                       cfg: PipelineConfig, generator: torch.Generator = None,
                       n_modes: int | None = None, draws=None, device=None):
    """Out-of-sample SSM fit of a raw mesh: register the template (source)
    to the subject on ``device``, take the corresponded locations in
    template vertex order and project them (:func:`ssm_project`).
    ``draws``: :func:`pipeline.make_draws`'s for the pair, else drawn from
    ``generator``.  Returns ``(coeffs, reconstruction [N, 3],
    residual_rms)``."""
    tg = mesh_to_graph_arrays(subject_mesh, device=device)
    sg = mesh_to_graph_arrays(template_mesh, device=device)
    res = register_pair(tg, sg, cfg, generator=generator, draws=draws)
    corresponded = res["weighted_points"][: template_mesh.n_points]
    return ssm_project(corresponded, mean, modes, n_modes=n_modes)


def cohort_mean_shape(template: TriMesh, weighted_points_mean) -> TriMesh:
    """The mean-shape mesh on the template's topology."""
    return template.with_points(weighted_points_mean)


def all_pairs_surface_errors(meshes: Sequence[TriMesh], icp_mode: str = "rigid",
                             device=None):
    """[n, n] matrix (numpy f64) of mean symmetric nearest-neighbour
    distances after ICP (``icp_mode``, 50 iterations) of each ordered pair
    (row i moved onto column j), on ``device``."""
    n = len(meshes)
    out = np.zeros((n, n), np.float64)
    dev = _device_of(*(m.points for m in meshes), device=device)
    pts = [_f32(m.points, dev) for m in meshes]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            _, moved = icp(pts[i], pts[j], mode=icp_mode, max_iterations=50)
            d_ij, _ = nn_query(pts[j], moved)
            d_ji, _ = nn_query(moved, pts[j])
            out[i, j] = float((d_ij.mean() + d_ji.mean()) / 2.0)
    return out
