"""Command-line interface of the port.

Counterpart of ``pyfocusr_tpu/cli.py``: the same subcommands, flags, exit
codes (2 on bad input), messages, outputs and JSON summaries::

    pyfocusr-tpu-torch register target.vtk source.vtk -o out_dir [...]
    pyfocusr-tpu-torch cohort template.vtk subj1.vtk subj2.vtk ... -o out_dir
    pyfocusr-tpu-torch ssm mesh1.vtk mesh2.vtk ... -o out_dir
    pyfocusr-tpu-torch warmup target.vtk source.vtk [--export FILE]
    pyfocusr-tpu-torch info mesh.vtk
    pyfocusr-tpu-torch convert in.vtk out.ply

What differs:

* ``--device`` on the subcommands that register: the CUDA card by default,
  raising without one (``utils/device.resolve_device``); ``cpu`` only when
  named.  ``info`` and ``convert`` run on the host.
* ``--seed s`` becomes ``torch.Generator().manual_seed(s)`` where JAX takes
  ``PRNGKey(s)``; the entry points draw from it (``pipeline.draw_seed``).
* Several cards: where JAX shards over its devices (``register
  --multires`` over 'verts', ``cohort`` and ``ssm`` over 'cohort' when the
  device count divides the subjects), the port spawns one rank a visible
  card over NCCL (``parallel/distributed.spawn``, the kernels built
  first) when ``--device`` is the card, each running the command on a
  one-axis ``DeviceMesh``; the first rank writes the files and prints the
  JSON (``cohort``'s ``devices_used`` is the rank count, as JAX's).
  ``--device cpu`` or ``cuda:N`` runs on that one device.
* ``--aot`` / ``warmup --export`` write and serve ``utils/aot.py``'s
  artifacts: ``.ptexec`` selects the compiled format (the built libraries
  travel in the file: a fresh process builds nothing), any other extension
  the portable one.
* ``warmup`` builds every library a pair on the device loads (the seven CUDA
  kernels on a card, one ``nvcc`` each started together, and the host
  library), then runs one pair; ``compile_plus_first_run_s`` counts both.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def _output_stems(paths):
    """Per-source output stems from basenames, disambiguated with a
    counter suffix: sources with equal basenames in different directories
    (a/mesh.vtk, b/mesh.vtk) must not overwrite each other's outputs.
    The counter skips candidates that collide with ANY source's own stem
    (a/mesh.vtk + b/mesh.vtk + c/mesh_1.vtk stays collision-free)."""
    bases = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    all_bases = set(bases)
    stems, used = [], set()
    for base in bases:
        stem, n = base, 0
        while stem in used or (stem != base and stem in all_bases):
            n += 1
            stem = f"{base}_{n}"
        used.add(stem)
        stems.append(stem)
    return stems


def _parse_landmark_file(path):
    """Parse a ``--landmarks`` file into ('index', i64 [L, 2]) or
    ('position', f64 [L, 6]); every data line must have the same width
    (2 = vertex-index pairs, 6 = paired physical positions)."""
    rows = []
    with open(path) as fh:
        for lineno, ln in enumerate(fh, 1):
            ln = ln.split("#", 1)[0].strip()
            if not ln:
                continue
            vals = ln.replace(",", " ").split()
            if len(vals) not in (2, 6):
                raise ValueError(
                    f"{path}:{lineno}: expected 2 (SRC_IDX TGT_IDX) or 6 "
                    f"(sx sy sz tx ty tz) values, got {len(vals)}"
                )
            rows.append(vals)
    if not rows:
        raise ValueError(f"{path}: no landmarks found")
    widths = {len(r) for r in rows}
    if len(widths) != 1:
        raise ValueError(f"{path}: mixed 2- and 6-column landmark lines")
    try:
        if widths == {2}:
            return "index", np.asarray(rows, np.int64)
        arr = np.asarray(rows, np.float64)
    except ValueError as exc:
        kind = "integer vertex indices" if widths == {2} else "coordinates"
        raise ValueError(f"{path}: landmark values must be {kind} ({exc})")
    if not np.all(np.isfinite(arr)):
        bad = int(np.argwhere(~np.isfinite(arr).all(axis=1))[0, 0])
        raise ValueError(
            f"{path}: landmark positions must be finite (data line {bad + 1} "
            "has NaN/inf)"
        )
    return "position", arr


def _landmark_pairs_for(kind, rows, target, source, device=None):
    """Build register_pair's [L, 2] (source_vertex, target_vertex) pairs
    for one mesh pair; returns (pairs, max_snap_distance_or_None).
    Positions snap on ``device`` (the card when None)."""
    if kind == "index":
        if rows[:, 0].min() < 0 or rows[:, 0].max() >= source.n_points:
            raise ValueError(
                f"landmark source index out of range [0, {source.n_points})"
            )
        if rows[:, 1].min() < 0 or rows[:, 1].max() >= target.n_points:
            raise ValueError(
                f"landmark target index out of range [0, {target.n_points})"
            )
        return rows.astype(np.int32), None
    from .pipeline import landmark_pairs_from_positions
    from .utils.device import to_numpy

    pairs, dists = landmark_pairs_from_positions(
        source, target, rows[:, :3], rows[:, 3:], device=device
    )
    pairs = to_numpy(pairs)
    # Defensive: an out-of-range pin would be silently clamped by the
    # pipeline's gather.
    if (
        pairs[:, 0].min() < 0
        or pairs[:, 0].max() >= source.n_points
        or pairs[:, 1].min() < 0
        or pairs[:, 1].max() >= target.n_points
    ):
        raise ValueError("landmark position snapped outside the mesh")
    return pairs, float(to_numpy(dists).max())


def _compute_node_features(mesh, names, topology=None, device=None):
    """Normalized [N, K] feature matrix (numpy) for the pipeline, reusing
    Graph's feature computation + normalization (z-score, clip +-3, 0-1 —
    the reference's defaults), computed on ``device`` (the card when
    None): names are 'curvature' (both principal curvatures),
    'min_curvature', 'max_curvature', or any point_data array name on the
    mesh.  Multi-component point_data arrays (e.g. normals, [N, C]) expand
    into C separately-normalized columns.  Pass a prebuilt ``topology`` to
    skip Graph's own edge extraction (the dominant host cost on large
    meshes)."""
    from .spectral.graph import Graph, features_dictionary
    from .utils.device import resolve_device, to_numpy

    calc = [n for n in names if n in features_dictionary]
    fetch = []
    g_mesh = mesh.with_points(torch.as_tensor(
        np.asarray(to_numpy(mesh.points), np.float32), device=resolve_device(device)))
    for n in names:
        if n in features_dictionary:
            continue
        arr = to_numpy(mesh.point_data[n])
        if arr.ndim == 1:
            fetch.append(n)
        else:
            # Split vector arrays into scalar columns so each component
            # normalizes independently (Graph would otherwise z-score the
            # whole matrix jointly, and mixed scalar/vector stacks fail).
            for c in range(arr.shape[1]):
                cn = f"{n}:{c}"
                g_mesh = g_mesh.with_point_data(cn, arr[:, c])
                fetch.append(cn)
    g = Graph(
        g_mesh,
        list_features_to_calc=calc,
        list_features_to_get_from_mesh=fetch,
        n_rand_samples=1,
        seed=0,
        topology=topology,
    )
    return np.stack([to_numpy(f) for f in g.node_features], axis=1)


def clamp_cohort_cfg(cfg, meshes):
    """Padded cohorts must not subsample more points than the smallest
    real mesh (parallel.cohort.check_cohort_config); clamp the two
    subsample knobs instead of erroring on small cohorts."""
    n_min = min(m.n_points for m in meshes)
    return dataclasses.replace(
        cfg,
        n_coords_spectral_ordering=min(cfg.n_coords_spectral_ordering, n_min),
        n_coords_spectral_registration=min(cfg.n_coords_spectral_registration, n_min),
    )


def _add_common(p):
    p.add_argument("--n-spectral-features", type=int, default=3)
    p.add_argument("--n-extra-spectral", type=int, default=3)
    p.add_argument("--non-rigid-alpha", type=float, default=0.01)
    p.add_argument("--non-rigid-beta", type=float, default=50.0)
    p.add_argument("--non-rigid-max-iterations", type=int, default=300)
    p.add_argument("--non-rigid-n-eigens", type=int, default=100)
    p.add_argument("--graph-smoothing-iterations", type=int, default=300)
    p.add_argument("--projection-smooth-iterations", type=int, default=40)
    p.add_argument("--n-coords-spectral-registration", type=int, default=1000)
    p.add_argument("--n-coords-spectral-ordering", type=int, default=5000)
    p.add_argument("--no-icp", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--device", default=None,
        help="where to register: the CUDA card by default (an error without "
        "one), 'cuda:N', or 'cpu'",
    )


def _generator(seed: int) -> torch.Generator:
    """The generator that stands for JAX's ``PRNGKey(seed)``."""
    return torch.Generator().manual_seed(seed)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _shard_axis(args, device):
    """The mesh axis JAX's CLI shards this command over, or None: with more
    than one visible card and ``--device`` the card (no index), ``register
    --multires`` over 'verts' (the fine refine; not with
    ``--features-in-adjacency``, which says so), ``ssm`` and ``cohort``
    over 'cohort' where the card count divides the subjects."""
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_dev < 2 or device.index is not None:
        return None
    if args.cmd == "register" and args.multires:
        if args.features_in_adjacency:
            # The sharded refine builds featureless smoothing weights; run
            # the refine on one device instead.
            print(
                "note: --features-in-adjacency disables the multi-device "
                "fine refine",
                file=sys.stderr,
            )
            return None
        return "verts"
    if args.cmd in ("ssm", "cohort"):
        n_items = len(args.meshes if args.cmd == "ssm" else args.subjects)
        if n_items % n_dev == 0:
            return "cohort"
    return None


def _rank_main(argv, axis: str, device_type: str) -> int:
    """One rank of a sharded command (``parallel/distributed.spawn``): the
    command on a one-axis mesh over every rank, on the rank's device.  Only
    the mesh's first rank prints and writes the outputs."""
    import contextlib

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .parallel.distributed import is_first_rank, rank_device

    mesh = init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))
    args = _parser().parse_args(argv)
    if is_first_rank(mesh):
        return _run(args, rank_device(mesh), mesh)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), \
            contextlib.redirect_stderr(null):
        return _run(args, rank_device(mesh), mesh)


def _parser():
    parser = argparse.ArgumentParser(prog="pyfocusr-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_reg = sub.add_parser("register", help="register source mesh(es) onto target")
    p_reg.add_argument("target")
    p_reg.add_argument(
        "source", nargs="+",
        help="one or more source meshes; with several, the target's "
        "spectrum/smoothing is prepared ONCE and reused per pair "
        "(pipeline.prepare_target)",
    )
    p_reg.add_argument("-o", "--out-dir", default=".")
    p_reg.add_argument(
        "--save-prepared", metavar="NPZ", default=None,
        help="persist the target's prepared state (spectrum + smoothing) "
        "for later --prepared runs",
    )
    p_reg.add_argument(
        "--prepared", metavar="NPZ", default=None,
        help="reuse a state saved with --save-prepared (by either package) "
        "instead of recomputing the target eigensolve (serving path)",
    )
    p_reg.add_argument(
        "--warm-from", metavar="NPZ", default=None,
        help="CLASS-TEMPLATE warm start: seed BOTH eigensolves of this "
        "pair from a representative mesh of the same anatomy class, "
        "prepared once with --save-prepared (the save embeds the "
        "template geometry).  Unlike --prepared — which requires the "
        "SAME target mesh — the template only needs to be roughly "
        "aligned with the pair; a residual safeguard self-heals toward "
        "the full solve when it is a poor match",
    )
    p_reg.add_argument(
        "--transfer-point-data",
        nargs="+",
        metavar="NAME",
        default=None,
        help="pull named target point_data arrays onto the transformed "
        "source outputs through the correspondences (k=3 IDW at the "
        "projected locations; 'all' transfers every array)",
    )
    p_reg.add_argument(
        "--html",
        action="store_true",
        help="also write <stem>viewer.html per pair: a self-contained "
        "WebGL viewer (no dependencies, no network) showing target and "
        "transformed source colored by correspondence index",
    )
    p_reg.add_argument(
        "--multires",
        type=int,
        metavar="COARSE_N",
        default=0,
        help="multi-resolution path for very large meshes: decimate to "
        "~COARSE_N vertices, register there, refine at full resolution "
        "(pyfocusr_tpu_torch.multires)",
    )
    p_reg.add_argument(
        "--level-ratio",
        type=float,
        default=100.0,
        metavar="R",
        help="with --multires: maximum per-level contraction before an "
        "intermediate resolution is inserted at the geometric mean "
        "(multi-level V-cycle).  0 = always a single coarse jump",
    )
    p_reg.add_argument(
        "--checkpoint-dir",
        metavar="DIR",
        default=None,
        help="with --multires: persist finished stages (coarse solve, fine "
        "smoothings) to DIR so a faulted multi-million-vertex run resumes "
        "instead of restarting; stage files are fingerprinted over every "
        "input, so a stale directory recomputes rather than leaking wrong "
        "results",
    )
    p_reg.add_argument(
        "--landmarks",
        metavar="FILE",
        default=None,
        help="known correspondences used as CPD priors (anatomically-"
        "guided registration): text file, one landmark per line, either "
        "'SRC_IDX TGT_IDX' vertex indices or 'sx sy sz tx ty tz' physical "
        "positions snapped to the nearest vertices; '#' comments allowed",
    )
    p_reg.add_argument(
        "--landmark-weight",
        type=float,
        default=None,
        metavar="W",
        help="pseudo-responsibility strength of the --landmarks priors "
        "(cfg.landmark_weight; default 100)",
    )
    p_reg.add_argument(
        "--features",
        nargs="+",
        metavar="NAME",
        default=None,
        help="feature-oriented registration (the F in FOCUSR): append the "
        "named features to the spectral coordinates "
        "(use_features_as_coords).  NAME is 'curvature' (both principal "
        "curvatures), 'min_curvature', 'max_curvature', or a point_data "
        "array present on BOTH meshes",
    )
    p_reg.add_argument(
        "--features-in-adjacency",
        action="store_true",
        help="also weight the graph edges by feature distances "
        "(include_features_in_adj_matrix); requires --features",
    )
    p_reg.add_argument(
        "--feature-mode",
        choices=("coords", "g-matrix", "both"),
        default="coords",
        help="how --features enter the registration: 'coords' appends "
        "them to the spectral coordinates (reference focusr.py:218-269), "
        "'g-matrix' weights the Laplacian's G matrix instead (reference "
        "feature_weights mechanism, graph.py:180-214), 'both' does both",
    )
    p_reg.add_argument(
        "--feature-weight",
        type=float,
        default=0.1,
        metavar="W",
        help="per-feature diagonal weight for --feature-mode "
        "g-matrix/both (cfg.feature_weights_diag; default 0.1)",
    )
    p_reg.add_argument(
        "--aot",
        metavar="FILE",
        default=None,
        help="serve through a pinned registration artifact "
        "(pyfocusr_tpu_torch/utils/aot.py): if FILE exists it is loaded, "
        "sidecar-validated against the config, the mesh shapes and this "
        "tree's sources; otherwise it is exported to FILE first.  A "
        ".ptexec extension selects the COMPILED format (the built kernel "
        "and host libraries travel in the file: a fresh process runs no "
        "nvcc and no g++; pinned to this device, torch and CUDA version); "
        "any other extension is the portable format (the libraries are "
        "built where missing).  One artifact serves one (config, "
        "shape-class); incompatible with --multires/--prepared/--landmarks",
    )
    p_reg.add_argument(
        "--quality",
        action="store_true",
        help="include registration-quality metrics in the JSON summary "
        "(unique fraction, mean displacement, symmetric surface distance, "
        "Hausdorff — pyfocusr_tpu_torch.metrics.registration_quality)",
    )
    _add_common(p_reg)

    p_coh = sub.add_parser("cohort", help="register a template to N subjects")
    p_coh.add_argument("template")
    p_coh.add_argument("subjects", nargs="+")
    p_coh.add_argument("-o", "--out-dir", default=".")

    p_ssm = sub.add_parser(
        "ssm",
        help="statistical shape model: iterate a groupwise template "
        "(Procrustes-normalized) and export PCA shape modes",
    )
    p_ssm.add_argument("meshes", nargs="+")
    p_ssm.add_argument("-o", "--out-dir", default=".")
    p_ssm.add_argument("--iterations", type=int, default=3)
    p_ssm.add_argument("--template-index", type=int, default=0)
    p_ssm.add_argument("--n-modes", type=int, default=0,
                       help="0 = all (capped at n_subjects - 1)")
    p_ssm.add_argument("--sample", type=int, default=0, metavar="N",
                       help="also synthesize N random shapes from the "
                       "fitted model (coefficients ~ N(0,1) per mode, "
                       "clipped to +-3 sigma) as ssm_sample_<i>.vtk")
    p_ssm.add_argument("--html", action="store_true",
                       help="also write ssm_viewer.html: the template with "
                       "per-vertex |mode| displacement magnitudes of the "
                       "first three modes as selectable colorings "
                       "(standalone WebGL, no dependencies)")
    p_ssm.add_argument("--project", nargs="+", default=[], metavar="MESH",
                       help="held-out meshes to fit to the built model: "
                       "register the template to each, project onto the "
                       "modes, report coefficients + reconstruction error")
    _add_common(p_ssm)
    _add_common(p_coh)

    p_warm = sub.add_parser(
        "warmup",
        help="build every library a registration on the device loads (the "
        "CUDA kernels with nvcc, the host library with g++) and run one "
        "pair; --export writes an artifact for serving (utils/aot.py)",
    )
    p_warm.add_argument("target")
    p_warm.add_argument("source")
    p_warm.add_argument("--export", default="", metavar="FILE",
                        help="also write a registration artifact to FILE "
                        "(.ptexec: compiled, else portable)")
    _add_common(p_warm)

    p_info = sub.add_parser("info", help="print mesh statistics")
    p_info.add_argument("mesh")

    p_conv = sub.add_parser(
        "convert",
        help="convert meshes between the supported formats "
        "(.vtk/.vtp/.ply/.obj/.stl by extension); point_data carries over "
        "where the format allows",
    )
    p_conv.add_argument("input")
    p_conv.add_argument("output")
    return parser


def main(argv=None):
    args = _parser().parse_args(argv)

    from .mesh import load_mesh, save_mesh

    if args.cmd == "convert":
        from .io.mesh_formats import SUPPORTED_EXTENSIONS

        low = args.output.lower()
        if not any(low.endswith(e) for e in SUPPORTED_EXTENSIONS):
            print(
                f"convert: unsupported output extension on {args.output!r}; "
                f"expected one of {SUPPORTED_EXTENSIONS}",
                file=sys.stderr,
            )
            return 2
        m = load_mesh(args.input)
        save_mesh(args.output, m)
        print(
            json.dumps(
                {
                    "input": args.input,
                    "output": args.output,
                    "points": m.n_points,
                    "triangles": m.n_triangles,
                    "point_data": sorted(m.point_data),
                }
            )
        )
        return 0

    if args.cmd == "info":
        from .mesh import build_topology

        m = load_mesh(args.mesh)
        topo = build_topology(np.asarray(m.triangles), m.n_points)
        print(
            json.dumps(
                {
                    "points": m.n_points,
                    "triangles": m.n_triangles,
                    "edges": topo.n_edges,
                    "max_degree": topo.max_degree,
                    "point_data": sorted(m.point_data),
                    "euler_characteristic": m.n_points
                    - topo.n_edges
                    + m.n_triangles,
                },
                indent=2,
            )
        )
        return 0

    from .utils.device import resolve_device

    device = resolve_device(args.device)
    axis = _shard_axis(args, device)
    if axis is None:
        return _run(args, device)
    # One rank a card over NCCL; the kernels are built here first, so the
    # ranks load them and do not race the first nvcc.
    from .parallel.distributed import spawn
    from .utils import aot

    aot.build_libraries("cuda")
    argv = sys.argv[1:] if argv is None else list(argv)
    return spawn(_rank_main, torch.cuda.device_count(), "nccl", "cuda",
                 args=(argv, axis, "cuda"))[0]


def _run(args, device, device_mesh=None) -> int:
    """The registering subcommands on ``device``; with ``device_mesh`` (one
    rank of a sharded command) sharded as JAX's CLI shards, and only the
    mesh's first rank writes the outputs."""
    from . import pipeline
    from .mesh import load_mesh, save_mesh
    from .parallel.distributed import axis_size, is_first_rank
    from .pipeline import PipelineConfig, mesh_to_graph_arrays, register_pair
    from .utils.device import to_numpy

    write = device_mesh is None or is_first_rank(device_mesh)
    cfg = PipelineConfig(
        icp_register_first=not args.no_icp,
        n_spectral_features=args.n_spectral_features,
        n_extra_spectral=args.n_extra_spectral,
        non_rigid_alpha=args.non_rigid_alpha,
        non_rigid_beta=args.non_rigid_beta,
        non_rigid_max_iterations=args.non_rigid_max_iterations,
        non_rigid_n_eigens=args.non_rigid_n_eigens,
        graph_smoothing_iterations=args.graph_smoothing_iterations,
        projection_smooth_iterations=args.projection_smooth_iterations,
        n_coords_spectral_registration=args.n_coords_spectral_registration,
        n_coords_spectral_ordering=args.n_coords_spectral_ordering,
    )
    if getattr(args, "out_dir", None):
        os.makedirs(args.out_dir, exist_ok=True)

    if args.cmd == "warmup":
        from .utils import aot

        target = load_mesh(args.target)
        source = load_mesh(args.source)
        t0 = time.perf_counter()
        aot.build_libraries(device)
        tg = mesh_to_graph_arrays(target, device=device)
        sg = mesh_to_graph_arrays(source, device=device)
        register_pair(tg, sg, cfg, _generator(args.seed))
        _sync(device)
        t_compile = time.perf_counter() - t0
        out = {
            "compile_plus_first_run_s": round(t_compile, 3),
            "n_target": target.n_points,
            "n_source": source.n_points,
        }
        if args.export:
            export = (aot.export_registration_exec if args.export.endswith(aot.EXEC_EXT)
                      else aot.export_registration)
            t0 = time.perf_counter()
            export(cfg, tg, sg, args.export)
            out["export"] = args.export
            out["export_s"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(out))
        return 0

    if args.cmd == "register":
        # argv-only validations BEFORE any mesh I/O — a wrong flag must not
        # cost a multi-million-vertex parse first.
        multi = len(args.source) > 1
        if multi and args.multires:
            print(
                "--multires supports a single source per invocation",
                file=sys.stderr,
            )
            return 2
        if args.multires and (args.prepared or args.save_prepared):
            print("--multires cannot use prepared target state", file=sys.stderr)
            return 2
        if args.warm_from and (args.prepared or args.multires or args.aot):
            print(
                "--warm-from is incompatible with --prepared (that target "
                "is already solved), --multires and --aot",
                file=sys.stderr,
            )
            return 2
        if args.checkpoint_dir and not args.multires:
            print("--checkpoint-dir requires --multires", file=sys.stderr)
            return 2
        if args.landmark_weight is not None and not args.landmarks:
            print("--landmark-weight requires --landmarks", file=sys.stderr)
            return 2
        if args.aot and (args.multires or args.prepared
                         or args.save_prepared or args.landmarks):
            print(
                "--aot is incompatible with --multires/--prepared/"
                "--save-prepared/--landmarks (the exported program pins "
                "the plain register_pair path)",
                file=sys.stderr,
            )
            return 2
        if args.features_in_adjacency and not args.features:
            print("--features-in-adjacency requires --features", file=sys.stderr)
            return 2
        if args.landmark_weight is not None and args.landmark_weight <= 0:
            print("--landmark-weight must be positive", file=sys.stderr)
            return 2
        landmark_rows = None
        if args.landmarks:
            try:
                landmark_rows = _parse_landmark_file(args.landmarks)
            except (OSError, ValueError) as exc:
                print(f"--landmarks: {exc}", file=sys.stderr)
                return 2
            if len(landmark_rows[1]) >= cfg.n_coords_spectral_registration:
                print(
                    f"--landmarks: {len(landmark_rows[1])} landmarks but "
                    "the CPD subsample is only "
                    f"{cfg.n_coords_spectral_registration} points; raise "
                    "--n-coords-spectral-registration above the landmark "
                    "count",
                    file=sys.stderr,
                )
                return 2
            if args.landmark_weight is not None:
                # Safe to replace before the prepared-state load/save:
                # the config fingerprint normalizes landmark_weight out
                # (pipeline._cfg_fingerprint).
                cfg = dataclasses.replace(cfg, landmark_weight=args.landmark_weight)
        installed = None
        if args.aot:
            from .utils import aot

            if args.aot.endswith(aot.EXEC_EXT) and os.path.exists(args.aot):
                # The compiled artifact's libraries, the host library's
                # mesh parser among them, are installed before any mesh
                # is read, so that a fresh process builds nothing.
                try:
                    installed = aot.install_libraries(args.aot, device=device)
                except ValueError as exc:
                    print(f"--aot: {exc}", file=sys.stderr)
                    return 2
        target = load_mesh(args.target)
        if not args.multires and target.n_points > 150_000:
            print(
                f"note: target has {target.n_points} vertices; direct "
                "registration above ~100k degrades correspondence "
                "uniqueness (docs/tuning.md) — consider --multires 12000",
                file=sys.stderr,
            )

        def _feature_names_missing(mesh):
            from .spectral.graph import features_dictionary

            return [
                n
                for n in (args.features or ())
                if n not in features_dictionary and n not in mesh.point_data
            ]

        feats_target = None
        topo_target = None
        if args.features:
            missing = _feature_names_missing(target)
            if missing:
                print(
                    f"--features: {missing} not computable and not in the "
                    f"target's point_data {sorted(target.point_data)}",
                    file=sys.stderr,
                )
                return 2
            from .mesh import build_topology

            # Built once and shared with mesh_to_graph_arrays below — edge
            # extraction is the dominant host cost on large meshes.
            topo_target = build_topology(
                np.asarray(target.triangles), target.n_points
            )
            feats_target = _compute_node_features(
                target, args.features, topology=topo_target, device=device
            )
            cfg = dataclasses.replace(
                cfg,
                use_features_as_coords=args.feature_mode in ("coords", "both"),
                include_features_in_adj_matrix=args.features_in_adjacency,
                use_features_in_graph=args.feature_mode in ("g-matrix", "both"),
                feature_weights_diag=(
                    (args.feature_weight,) * feats_target.shape[1]
                    if args.feature_mode in ("g-matrix", "both")
                    else cfg.feature_weights_diag
                ),
            )
        tg = (
            None
            if args.multires
            else mesh_to_graph_arrays(
                target, node_features=feats_target, topology=topo_target,
                device=device,
            )
        )
        warm_block = None
        if args.warm_from:
            from .pipeline import load_prepared_target, warm_block_from_prepared

            try:
                wb_prep = load_prepared_target(args.warm_from, device=device)
                warm_block = warm_block_from_prepared(wb_prep)
            except (OSError, ValueError, KeyError) as exc:
                print(f"--warm-from: {exc}", file=sys.stderr)
                return 2
            if warm_block["block"].shape[1] != cfg.eig_wide_block:
                print(
                    f"--warm-from: template block is "
                    f"{warm_block['block'].shape[1]} wide but "
                    f"eig_wide_block={cfg.eig_wide_block}; re-prepare the "
                    "template under this config",
                    file=sys.stderr,
                )
                return 2
        prep = None
        first_source = None
        if args.prepared:
            from .pipeline import load_prepared_target

            prep = load_prepared_target(args.prepared, cfg, target=tg, device=device)
        elif (multi and not args.aot) or args.save_prepared:
            from .pipeline import _start, draw_seed, prepare_target

            # The target's solve starts from the draws of the first pair
            # (JAX: split(PRNGKey(seed), 8)[0], the target block of every
            # pair of that key).
            first_source = load_mesh(args.source[0])
            draws = pipeline.make_draws(draw_seed(_generator(args.seed)), cfg,
                                        tg.n_points, first_source.n_points)
            prep = prepare_target(tg, cfg, _start(draws, "target", cfg, tg),
                                  warm_block=warm_block,
                                  generator=_generator(args.seed))
        if args.save_prepared and prep is not None:
            from .pipeline import save_prepared_target

            save_prepared_target(args.save_prepared, prep, cfg, target=tg)
        summaries = []
        aot_runner = None
        for i, (src_path, src_stem) in enumerate(
                zip(args.source, _output_stems(args.source))):
            source = first_source if i == 0 and first_source is not None else (
                load_mesh(src_path))
            lm_pairs, lm_snap = None, None
            if landmark_rows is not None:
                try:
                    lm_pairs, lm_snap = _landmark_pairs_for(
                        landmark_rows[0], landmark_rows[1], target, source,
                        device=device,
                    )
                except ValueError as exc:
                    print(f"--landmarks ({src_path}): {exc}", file=sys.stderr)
                    return 2
                # The pipeline's effective CPD subsample is also bounded by
                # the mesh sizes (the pre-load check above could only see
                # the config value).
                n_reg_eff = min(
                    cfg.n_coords_spectral_registration,
                    target.n_points,
                    source.n_points,
                )
                if not args.multires and len(lm_pairs) >= n_reg_eff:
                    print(
                        f"--landmarks: {len(lm_pairs)} landmarks but the "
                        f"effective CPD subsample is only {n_reg_eff} "
                        "points (bounded by the mesh sizes); thin the "
                        "landmarks",
                        file=sys.stderr,
                    )
                    return 2
            feats_source = None
            topo_source = None
            if args.features:
                missing = _feature_names_missing(source)
                if missing:
                    print(
                        f"--features: {missing} not computable and not in "
                        f"{src_path}'s point_data {sorted(source.point_data)}",
                        file=sys.stderr,
                    )
                    return 2
                from .mesh import build_topology

                topo_source = build_topology(
                    np.asarray(source.triangles), source.n_points
                )
                feats_source = _compute_node_features(
                    source, args.features, topology=topo_source, device=device
                )
                if feats_source.shape[1] != feats_target.shape[1]:
                    # Same names can expand to different widths (e.g. a
                    # [N, 3] 'disp' on one mesh vs scalar on the other).
                    print(
                        f"--features: {src_path} expands to "
                        f"{feats_source.shape[1]} feature columns but the "
                        f"target has {feats_target.shape[1]} (same-named "
                        "point_data with different component counts?)",
                        file=sys.stderr,
                    )
                    return 2
            t0 = time.perf_counter()
            if args.multires:
                from .multires import register_pair_multires

                try:
                    res, _ = register_pair_multires(
                        target, source, cfg, _generator(args.seed),
                        coarse_n=args.multires,
                        device_mesh=device_mesh,
                        landmark_pairs=lm_pairs,
                        node_features=(
                            (feats_target, feats_source)
                            if args.features
                            else None
                        ),
                        topologies=(
                            (topo_target, topo_source)
                            if topo_target is not None
                            and topo_source is not None
                            else None
                        ),
                        checkpoint_dir=args.checkpoint_dir,
                        level_ratio=args.level_ratio,
                        device=device,
                    )
                except ValueError as exc:
                    if lm_pairs is not None and "landmark" in str(exc):
                        # e.g. pins collapse onto more coarse clusters than
                        # the coarse CPD subsample holds.
                        print(f"--landmarks: {exc}", file=sys.stderr)
                        return 2
                    raise
            elif args.aot:
                # Extension dispatch: .ptexec = the compiled format (the
                # libraries travel in the file), anything else = portable.
                exec_fmt = args.aot.endswith(aot.EXEC_EXT)
                _export = (aot.export_registration_exec if exec_fmt
                           else aot.export_registration)
                _load = (aot.load_registration_exec if exec_fmt
                         else aot.load_registration)
                sg_arr = mesh_to_graph_arrays(
                    source, node_features=feats_source, topology=topo_source,
                    device=device,
                )
                if not os.path.exists(args.aot):
                    try:
                        _export(cfg, tg, sg_arr, args.aot)
                    except ValueError as exc:  # e.g. padded 'hungarian'
                        print(f"--aot: {exc}", file=sys.stderr)
                        return 2
                try:
                    # Loaded ONCE; each further source pays only the
                    # sidecar validation (the artifact pins one source
                    # shape class, so a differently-shaped source must
                    # fail loudly).
                    if aot_runner is None:
                        aot_runner = _load(
                            args.aot, cfg=cfg, target=tg, source=sg_arr,
                            **({"installed": installed} if exec_fmt else {}),
                        )
                    else:
                        aot.validate_artifact(
                            args.aot, cfg=cfg, target=tg, source=sg_arr
                        )
                except ValueError as exc:
                    print(f"--aot: {exc}", file=sys.stderr)
                    return 2
                res = aot_runner(tg, sg_arr, _generator(args.seed))
            elif prep is not None:
                from .pipeline import register_pair_prepared

                res = register_pair_prepared(
                    prep, tg,
                    mesh_to_graph_arrays(
                        source, node_features=feats_source, topology=topo_source,
                        device=device,
                    ),
                    cfg, _generator(args.seed),
                    landmark_pairs=lm_pairs,
                )
            else:
                res = register_pair(
                    tg,
                    mesh_to_graph_arrays(
                        source, node_features=feats_source, topology=topo_source,
                        device=device,
                    ),
                    cfg,
                    _generator(args.seed),
                    landmark_pairs=lm_pairs,
                    warm_block=warm_block,
                )
            _sync(device)
            dt = time.perf_counter() - t0
            if not write:
                continue
            # int32, as JAX writes the file.
            corr = to_numpy(res["correspondences"]).astype(np.int32)
            stem = src_stem + "_" if multi else ""
            out_t = source.with_points(res["weighted_points"]).with_point_data(
                "corresp_idx", corr.astype(np.float32)
            )
            if args.transfer_point_data:
                from .transfer import transfer_point_data

                t_names = (
                    None
                    if list(args.transfer_point_data) == ["all"]
                    else args.transfer_point_data
                )
                for t_name, t_vals in transfer_point_data(
                    target, res, t_names
                ).items():
                    out_t = out_t.with_point_data(
                        t_name, to_numpy(t_vals)[: corr.shape[0]]
                    )
            names = [
                f"{stem}transformed_source.vtk",
                f"{stem}average_mesh.vtk",
                f"{stem}correspondences.npy",
            ]
            save_mesh(os.path.join(args.out_dir, names[0]), out_t)
            avg = source.with_points(res["average_points"])
            save_mesh(os.path.join(args.out_dir, names[1]), avg)
            np.save(os.path.join(args.out_dir, names[2]), corr)
            if args.html:
                from .utils.html_viewer import export_html

                html_name = f"{stem}viewer.html"
                export_html(
                    os.path.join(args.out_dir, html_name),
                    meshes=[
                        target.with_point_data(
                            "corresp_idx",
                            np.arange(target.n_points, dtype=np.float32),
                        ),
                        out_t,
                    ],
                    mesh_names=["target", "source transformed"],
                    title=f"FOCUSR: {os.path.basename(src_path)} "
                    f"-> {os.path.basename(args.target)}",
                )
                names.append(html_name)
            q = None
            if args.quality:
                from .metrics import registration_quality

                q = registration_quality(target, source, res)
            summary = {
                "source": src_path,
                "seconds": round(dt, 3),
                # One np.unique pass: reuse the metrics' count when present.
                "unique_correspondences": (
                    q.pop("n_unique_correspondences")
                    if q is not None
                    else int(len(np.unique(corr)))
                ),
                "n_source_points": int(corr.shape[0]),
                "outputs": names,
            }
            if lm_pairs is not None:
                summary["landmarks"] = int(lm_pairs.shape[0])
                if lm_snap is not None:
                    # Large snap distances mean the picked positions do not
                    # actually lie on the surfaces — surface that loudly.
                    summary["landmark_max_snap_mm"] = round(lm_snap, 4)
            if q is not None:
                q.pop("n_source_points")
                summary["quality"] = q
            summaries.append(summary)
        if write:
            print(json.dumps(summaries[0] if not multi else summaries))
        return 0

    if args.cmd == "ssm":
        from .parallel.cohort import build_ssm_template, cohort_shape_modes

        meshes = [load_mesh(p) for p in args.meshes]
        cfg = clamp_cohort_cfg(cfg, meshes)
        t0 = time.perf_counter()
        template_mesh, results, motions = build_ssm_template(
            meshes, cfg, _generator(args.seed),
            n_iterations=args.iterations,
            template_index=args.template_index,
            device_mesh=device_mesh,
            device=device,
        )
        if not write:
            return 0
        # Rows are in TEMPLATE vertex order; rows past the template's real
        # vertex count are cohort padding.  Slice BEFORE the PCA so
        # ssm_modes.npz shapes match the exported ssm_template.vtk (which is
        # sliced to n_real) instead of carrying trailing all-zero rows.
        n_real = meshes[args.template_index].n_points
        mean, modes, variances = cohort_shape_modes(
            results["weighted_points"][:, :n_real],
            n_modes=args.n_modes or None,
        )
        _sync(device)
        dt = time.perf_counter() - t0
        save_mesh(
            os.path.join(args.out_dir, "ssm_template.vtk"), template_mesh
        )
        np.savez(
            os.path.join(args.out_dir, "ssm_modes.npz"),
            mean=to_numpy(mean),
            modes=to_numpy(modes),
            variances=to_numpy(variances),
            motions=np.asarray(motions),
        )
        html_outputs = []
        if args.html:
            from .utils.html_viewer import export_html

            modes_np = to_numpy(modes)  # [m, N, 3] displacement fields
            view_mesh = template_mesh
            for k in range(min(3, modes_np.shape[0])):
                mag = np.linalg.norm(modes_np[k], axis=-1)
                view_mesh = view_mesh.with_point_data(
                    f"mode{k}_mag", mag.astype(np.float32)
                )
            export_html(
                os.path.join(args.out_dir, "ssm_viewer.html"),
                meshes=[view_mesh],
                mesh_names=["SSM template (mode magnitudes)"],
                title="FOCUSR SSM",
            )
            html_outputs = ["ssm_viewer.html"]
        samples = []
        if args.sample:
            from .parallel.cohort import ssm_sample

            shapes = ssm_sample(
                mean, modes, variances,
                generator=_generator(args.seed + 500),
                n_samples=args.sample,
            )
            for si in range(args.sample):
                out_name = f"ssm_sample_{si}.vtk"
                save_mesh(
                    os.path.join(args.out_dir, out_name),
                    template_mesh.with_points(shapes[si]),
                )
                samples.append(out_name)
        projections = {}
        if args.project:
            from .parallel.cohort import fit_subject_to_ssm

            # Disambiguated stems: equal basenames in different directories
            # must not overwrite each other's report keys or recon files.
            proj_stems = _output_stems(list(args.project))
            for pi, (path, stem) in enumerate(zip(args.project, proj_stems)):
                held_out = load_mesh(path)
                coeffs, recon, resid = fit_subject_to_ssm(
                    held_out, template_mesh, mean, modes, cfg,
                    _generator(args.seed + 1000 + pi), device=device,
                )
                coeffs = to_numpy(coeffs)
                sd = np.sqrt(np.maximum(to_numpy(variances), 1e-30))
                projections[stem] = {
                    "path": path,
                    "coefficients": [round(float(c), 5) for c in coeffs],
                    "coefficients_sd_units": [
                        round(float(c / s), 3) for c, s in zip(coeffs, sd)
                    ],
                    "residual_rms_mm": round(float(resid), 4),
                }
                recon_mesh = template_mesh.with_points(recon)
                out_name = f"ssm_recon_{stem}.vtk"
                save_mesh(os.path.join(args.out_dir, out_name), recon_mesh)
                projections[stem]["output"] = out_name
        print(
            json.dumps(
                {
                    "seconds": round(dt, 3),
                    "n_subjects": len(meshes),
                    "iterations": len(motions),
                    "template_motion_trace": [round(m, 5) for m in motions],
                    "mode_variances": [
                        round(float(v), 6) for v in to_numpy(variances)
                    ],
                    "outputs": ["ssm_template.vtk", "ssm_modes.npz"]
                    + html_outputs
                    + samples,
                    **({"projections": projections} if projections else {}),
                }
            )
        )
        return 0

    if args.cmd == "cohort":
        from .parallel.cohort import (
            pad_cohort,
            register_cohort,
            stack_graph_arrays,
        )

        template_mesh = load_mesh(args.template)
        subject_meshes = [load_mesh(p) for p in args.subjects]
        cfg = clamp_cohort_cfg(cfg, [template_mesh] + subject_meshes)
        template = mesh_to_graph_arrays(template_mesh, device=device)
        subjects = stack_graph_arrays(pad_cohort(subject_meshes, device=device))
        t0 = time.perf_counter()
        results, mean_shape = register_cohort(
            template, subjects, cfg, _generator(args.seed), device_mesh
        )
        _sync(device)
        dt = time.perf_counter() - t0
        if not write:
            return 0
        mean_mesh = template_mesh.with_points(mean_shape)
        save_mesh(os.path.join(args.out_dir, "mean_shape.vtk"), mean_mesh)
        # int32, as JAX writes the file.
        corr_all = to_numpy(results["correspondences"]).astype(np.int32)
        np.save(
            os.path.join(args.out_dir, "cohort_correspondences.npy"), corr_all
        )
        print(
            json.dumps(
                {
                    "seconds": round(dt, 3),
                    "n_subjects": len(subject_meshes),
                    "devices_used": (1 if device_mesh is None
                                     else axis_size(device_mesh, "cohort")),
                    "unique_fraction_per_subject": [
                        round(len(np.unique(corr_all[b])) / corr_all.shape[1], 4)
                        for b in range(corr_all.shape[0])
                    ],
                    "outputs": ["mean_shape.vtk", "cohort_correspondences.npy"],
                }
            )
        )
        return 0


if __name__ == "__main__":
    sys.exit(main())
