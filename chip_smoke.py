#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pyfocusr_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with one NVIDIA H100 (sm_90a),
nvcc and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the seven CUDA kernels from ``pyfocusr_tpu_torch/csrc/`` (k-NN for
k = 1..3 and for k = 4..128, Sinkhorn row-logsumexp, Jonker-Volgenant,
streamed CPD E-step, the 3x3 Umeyama close, the Chebyshev filter step; one nvcc each, started
together), builds the host library from ``csrc/host/`` with g++ at its
first use, and drives four paths of
``register_pair`` on a synthetic 10242-vertex bone pair, on CUDA tensors,
each with the kernels' launch counts set to 0 just before and read just
after:

* the default 'kd' path at the bench configuration (``bench.py:122-134``),
  once more under ``torch.profiler`` (per-stage host and device time, device
  idle share; the op table goes to ``build/profile_register_pair.txt``), and
  on CPU tensors with the same random draws;
* the 'hungarian' path (``bench.py:558-571``: the bench configuration with
  one-to-one initial correspondences), profiled the same way, and compared
  with the same call on CPU tensors on the 2562-vertex pair (the CPU's
  plain Sinkhorn loop would take minutes at 10242);
* full-resolution CPD (the bench configuration with all 10242 points in
  CPD and ``non_rigid_alpha`` scaled by N/1000, ``docs/tuning.md:8-15``):
  the streamed E-step kernel and the tiled Gram; profiled, and compared with
  the same call on CPU tensors with CPD capped at the same iteration count;
* the reference's raw ``Focusr`` defaults (``pyfocusr_tpu/pipeline.py:
  78-89``): a 5000-point CPD subsample (streamed), the affine pre-pass,
  weighted spectral coordinates, alpha 0.5, beta 3, 1000 iterations;
* template serving at the bench configuration: ``prepare_target`` on the
  target once, then ``register_pair_prepared`` for five sources (seeds 1,
  3-6) beside their plain ``register_pair``; a never-seen pair (seeds 3, 4)
  from the seed-2 class template's ``warm_block``, in memory and through a
  save / load round trip; and the three feature flags with each mesh's
  thickness scalar.  Their CUDA-vs-CPU checks run on the 2562-vertex pair;
* the class API (``class_api``): ``Focusr(target, source).align_maps()`` at
  the class defaults on the 10242 pair (ICP of the full clouds, the narrow
  eigensolver in each ``Graph``, curvature features, affine and deformable
  CPD at 5000 points on the streamed E-step), first call and warm;
  ``align_maps_pipeline`` against ``register_pair`` on its own inputs;
  'hungarian' correspondences at 642 and 2562 (lse and JV; the objective
  against ``lap_host``'s) and ``linear_sum_assignment`` on the card against
  ``lap_host`` from 2 to 2048 rows; the narrow solver at 642 and 2562 and Lanczos at 2562
  through ``register_pair``, each solve timed; CUDA against CPU at 2562; the
  result (CUDA tensors) and its target ``Graph`` through ``export_viewer_html``,
  read back to their meshes' counts;
* multi-resolution registration (``multires``): ``register_pair_multires``
  on the pair subdivided to 655362 vertices (coarse_n 12000, one jump) with
  stage checkpoints, resumed from them bit for bit, and split by stage;
  both routes of its refine's k=3 query (the voxel grid and the k-NN
  kernel) on the refine's own inputs, bit-equal and timed, as at 40962 (a
  pair registered through intermediate levels, level_ratio 4) and 163842;
  CUDA against CPU at 10242 with the same coarse draws;
* cohort registration (``cohort``, ``bench.py:652-680``): the seed-2 bone
  at 10242 vertices as the template of 8 copies of the seed-1 bone
  jittered by 0.3 mm, ``register_cohort`` (the template's solve hoisted),
  first call and three warm calls beside a plain pair, each lane equal to
  its own ``register_pair_prepared_source``; a padded cohort (four of the
  subjects beside four ~9.4k-vertex decimations, padded to 10242) against
  its subjects registered unpadded, and one padded lane on the CPU;
  ``iterate_template`` for three rounds with Procrustes, the SSM of its
  last round, and ``all_pairs_surface_errors`` on the decimations;
* the host library (``native``): ``build_topology``, ``decimate`` and
  ``lap_host`` through the C++ paths of ``csrc/host/`` against their numpy
  plain versions (byte-equal, both timed) at the multires pair's 655362
  vertices, and a .vtk ASCII round trip through both parsers; the
  multires phase's split then shows the native host paths;
* groupwise registration (``groupwise``): ``register_pair_symmetric`` on the
  10242 pair, ``register_all_pairs`` on four warped subjects (12 pairs),
  first call and warm, the three-cycle error, ``synchronize_correspondences``
  and ``synchronize_spectral`` on the clean maps (nothing flagged) and with
  one map's rows scrambled (flagged and repaired); CUDA against CPU on the
  symmetric pair at 2562;
* wide coordinates and the class API's output stage (``wide_coords``):
  ``Focusr`` at the class defaults with 16 spectral features and xyz
  appended (D = 19: the initial correspondences on the port of JAX's XLA
  k-NN path, both CPD runs on the E-step kernel's tiled D > 16 instance),
  ``get_weighted_final_node_locations`` at k = 8 and 32 (the k = 4..128
  kernel), ``transfer_point_data`` and a ``save_mesh`` / ``load_mesh``
  round trip in .vtk and .vtp, first call and warm; CUDA against CPU at
  2562;
* the command line (``cli``): every subcommand of
  ``pyfocusr_tpu_torch/cli.py`` through ``cli.main`` in this process, on
  the 'kd' pair written to .vtk files (the cohort and the SSM on 2562-vertex
  bones), each invocation's seconds and kernel launches: ``info``,
  ``convert`` there and back, ``register`` under the bench configuration
  against ``register_pair``, two sources with ``--save-prepared``, then
  ``--prepared`` and ``--warm-from``, the options (html, quality, landmarks,
  curvature features, transfer), all points in CPD, ``cohort``, ``ssm`` and
  ``warmup --export``;
* the serving artifacts (``aot``, the counterpart of ``bench.py:436-554``
  at 10242 vertices): both formats of ``utils/aot.py`` exported, loaded and
  served in this process and by fresh processes, with the libraries built,
  with an empty build directory (portable: nvcc and g++ run), and with an
  empty build directory and no compiler reachable (compiled: nothing may
  be built); a changed config refused with exit 2;
* the sharded paths (``sharded``, ``parallel/distributed.py`` over
  ``torch.distributed``): the vertex-sharded refine at the multires
  phase's 655362 fine level, ``register_cohort`` on the 8 x 10242 cohort,
  ``register_all_pairs`` on four subjects (12 pairs) and
  ``register_pair_multires(device_mesh=)`` at 163842, each against the
  same call on one device, (a) over a world of one NCCL rank in this
  process, (b) on four gloo ranks spawned on the one card (smaller sizes;
  six pairs padded to eight) and (c) on one NCCL rank a card where more
  than one card is visible (else a line says why not); lanes bit for bit
  where two plain calls agree, the refines at ``tests/test_bigmesh.py``'s
  gates; each rank's launches in the kernels line (``launches_sharded``);
* the JAX package's schedules the port took last (``completion``, run
  after ``cohort``): the split-spectra schedule against the fused one on
  the bench's ``direct_122k_hub`` pair (two 350 x 350 UV spheres, 122152
  vertices), the union and batched spectra against two separate solves at
  10242, and the auction at 300 and 2562 rows against ``lap_host``'s
  optimum (and its own CPU run at 300).

Every CPD EM loop and every ICP on the card runs as one captured iteration
replayed as a CUDA graph, the host reading the stop flag every 8
iterations; two phases hold those loops bit for bit against the plain loops
(a host read per iteration): CPD at full resolution and on the 'kd' path's
1000 points, ICP on the 'kd' pair's inputs in rigid and similarity mode.
The 'kd' path and the raw defaults run five warm pairs each in this one
process, reported apart from the first call.

Each kernel is held against its plain PyTorch version on the card at the
shapes those paths give it.  Each phase prints one JSON line; any failed
check exits non-zero.  The last three lines are the kernels line, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or without the package beside it, the
script exits non-zero before printing anything.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Synthetic bone pair: the formula of tests/conftest.py (_synthetic_bone),
# one subdivision further (12 -> ... -> 10242 vertices).
_ICO_T = (1.0 + 5.0 ** 0.5) / 2.0
_ICO_VERTS = np.array(
    [
        (-1, _ICO_T, 0), (1, _ICO_T, 0), (-1, -_ICO_T, 0), (1, -_ICO_T, 0),
        (0, -1, _ICO_T), (0, 1, _ICO_T), (0, -1, -_ICO_T), (0, 1, -_ICO_T),
        (_ICO_T, 0, -1), (_ICO_T, 0, 1), (-_ICO_T, 0, -1), (-_ICO_T, 0, 1),
    ],
    np.float64,
)
_ICO_FACES = np.array(
    [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ],
    np.int32,
)

# The bench configuration (bench.py:122-134).
BENCH_CFG = dict(
    n_spectral_features=3,
    n_extra_spectral=3,
    get_weighted_spectral_coords=False,
    non_rigid_alpha=0.01,
    non_rigid_beta=50.0,
    non_rigid_n_eigens=100,
    non_rigid_max_iterations=300,
    n_coords_spectral_ordering=10000,
    n_coords_spectral_registration=1000,
    graph_smoothing_iterations=600,
    projection_smooth_iterations=1,
)

# The reference's 'hungarian' configuration (bench.py:558-571).
HUNGARIAN_CFG = dict(BENCH_CFG, initial_correspondence_type="hungarian")

# Full-resolution CPD: every vertex in CPD, alpha scaled by N/1000 from the
# bench's 0.01 at 1000 points (docs/tuning.md:8-15).
FULLRES_CFG = dict(BENCH_CFG, n_coords_spectral_registration=10242,
                   non_rigid_alpha=0.1)

# The six fields where the reference's raw Focusr.__init__ defaults differ
# from PipelineConfig's (pyfocusr_tpu/pipeline.py:78-89), over the bench
# configuration.
REFERENCE_DEFAULTS_CFG = dict(
    BENCH_CFG,
    n_coords_spectral_registration=5000,
    get_weighted_spectral_coords=True,
    rigid_before_non_rigid_reg=True,
    non_rigid_max_iterations=1000,
    non_rigid_alpha=0.5,
    non_rigid_beta=3.0,
)

# CPD iterations of both sides of the full-resolution CUDA-vs-CPU run: the
# CPU's plain E-step makes two passes over 10242^2 pairs per iteration.
# Not fewer: at 5 the spectral clouds are too far from aligned for the
# correspondence gate (87.6% equal against 95% in run 17d; 98.8% at 10,
# run 16l).
FULLRES_CPU_EM_CAP = 10
# The Sinkhorn schedule of both sides of the 'hungarian' CUDA-vs-CPU run at
# 2562 (the parity tests' shortening, tests/test_torch_pipeline.py): the
# solve stays exact, only the augmentation gets longer.  The default 14 x
# 30 passes took most of the CPU run's 71.7 s in run 16l; the kernels meet
# the default schedule in lse_kernel_vs_plain and jv_kernel_vs_plain.
HUNGARIAN_CPU_CHECK_SCHEDULE = dict(levels=5, iters_per_level=6)

# Published peaks of one H100 SXM (NVIDIA's data sheet): device-memory
# bandwidth and float32 rate outside the tensor cores.  A kernel's bound is
# the larger of its bytes over the one and its operations over the other.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The 67 TFLOP/s count an FMA as two operations.  Operations that may not
# fuse (the k-NN kernel's separately rounded subtract, multiply, add and
# compare) each take one lane's issue slot: 132 SMs x 128 lanes x 1.98 GHz.
F32_LANE_INSTR_PER_S = 132 * 128 * 1.98e9
SM_CLOCK_HZ = 1.98e9
# Exponentials on the special-function units: 16 per SM per clock (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) on 132 SMs at the 1.98 GHz boost clock that the f32 figure implies
# (67e12 = 132 x 128 lanes x 2 x 1.98e9).
SFU_EXP_PER_S = 132 * 16 * 1.98e9

# lse kernel against its plain version: max |difference| as a fraction of
# the cost's spread.  The JAX package holds its Pallas kernel to XLA at 2e-4
# on a cost of spread ~5 (tests/test_pallas_kernels.py:114), i.e. 4e-5 of
# the spread; the CUDA kernel merges (max, sum) pairs online and measured
# 4e-7 of the spread, so it is held to 1e-5.
LSE_TOL_OF_SPREAD = 1e-5
# 'hungarian' CUDA run against the CPU run (both end to end, so the two
# costs differ in f32 noise and the optimum moves in chains): LAP objectives
# and initial correspondences.  On one cost the two must agree outright.
HUNGARIAN_OBJ_RTOL = 2e-3
HUNGARIAN_AGREE_MIN = 0.90
SAME_COST_AGREE_MIN = 0.999
SAME_COST_OBJ_RTOL = 1e-6
# Agreement gates between the CUDA run and the CPU run of register_pair.
# Eigenpairs are held tighter than the 1e-3 / 0.999 first proposed: three
# H100 runs measured 1.9e-6 and 0.9999993.  Correspondences stay at 95%
# (measured 98.7%): CPD's stop test at tolerance 1e-8 sits in f32 noise,
# so the two devices can end the EM loop at different iterations.
EIGVAL_RTOL = 1e-4
COS_MIN = 0.9999
CORR_AGREE_MIN = 0.95
UNIQUE_DIFF_MAX = 0.02
# Eigenvalues closer than this (relative) are compared as one subspace.
DEGENERATE_GAP = 1e-2
# CPD E-step kernel against its plain version: each output's max |difference|
# over the larger of 1 and the output's max |value|. The two sum in
# different orders and the kernel contracts with FMA; a first check on the
# card measured <= 1e-7 of that scale.
ESTEP_TOL_OF_SCALE = 1e-5
# The first version of the E-step kernel (one thread a row, chunks merged by
# a second kernel) at 10242^2, D = 3, both passes, device time as PERF.md
# section 6 records it (run N), printed beside this run's time.
FIRST_ESTEP_KERNEL_MS = 0.180
# Streamed EM against dense EM on the card, 8 iterations
# (tests/test_pallas_kernels.py:71-93): moved cloud and sigma2.
EM_TY_ATOL = 1e-3
EM_SIGMA2_ATOL = 1e-5
# Subdivisions of the icosahedron for the JV case above the old one-block
# limit of 25600 columns: 40962 vertices.
JV_BIG_LEVELS = 6
# Final CPD sigma2 of the full-resolution CUDA and CPU runs, relative: the
# same EM iterations with sums in another order on each device.
FULLRES_SIGMA2_RTOL = 1e-3
# The Umeyama close kernel against its plain version (torch.linalg.svd and
# det in f64 on the card, rounded once to f32, as the kernel rounds its f64
# Jacobi result): R absolute, s relative, t over the case's coordinate
# scale.  On one H100 80GB HBM3 at 700 W the two read 0.0 apart on every
# case; an f32 plain close read up to 6e-7 apart in R, which these limits
# also admit.
CLOSE_R_ATOL = 1e-6
CLOSE_S_RTOL = 1e-6
CLOSE_T_OF_SCALE = 1e-6
# Clocks of one dependent f64 operation in one thread on the card: FMA,
# division, square root, reciprocal square root, as tools/sm_rate_probe.py
# measured them on one H100 80GB HBM3 at 700 W.  The close kernel's bound is
# its chain of them (umeyama_bound).
F64_CLOCKS = {"fma": 8.375, "div": 112.25, "sqrt": 80.25, "rsqrt": 55.25}
# Warm register_pair calls of the 'kd' path and of the raw defaults, in this
# one process after the first call.
WARM_REPS = 5
# Template serving: the sources served against the prepared seed-2 target,
# and the never-seen pair registered from the seed-2 class template.
SERVED_SEEDS = (1, 3, 4, 5, 6)
CLASS_PAIR_SEEDS = (3, 4)
# The synthetic bone's per-vertex scalar (tests/conftest.py:_synthetic_bone)
# and the flags that use node features.
FEATURE = "thickness_change_(mm)"
FEATURE_FLAGS = ("use_features_as_coords", "use_features_in_graph",
                 "include_features_in_adj_matrix")
# The CPU side of the new phases' CUDA-vs-CPU checks runs on the 2562-vertex
# pair: a 10242 CPU registration costs about as much as the phases' card work.
CPU_CHECK_LEVELS = 4
# CPD's stop tolerance of the feature flags' CUDA-vs-CPU runs, as in the
# parity tests (tests/test_torch_pipeline.py): with the features appended
# as a coordinate the stop test at the bench's 1e-8 sits in f32 noise.  On
# the CPU alone, six thread counts stop that EM loop at 155-163 iterations
# with 89.3-97.6% equal correspondences (tools/cpd_stop_noise.py; one H100
# against the CPU read under 95%); at 1e-6 all stop at 104, 96.5-97.3%.
FEATURE_CHECK_TOLERANCE = 1e-6
# The sizes at which the class phase times ``linear_sum_assignment`` on the
# card against ``lap_host`` (the host library's C++ solver), on which
# ``ops/assignment.DEVICE_THRESHOLD`` rests.
LAP_DISPATCH_SIZES = (2, 4, 16, 64, 128, 256, 512, 642, 1024, 2048)
# The native phase: the host library's paths against their numpy plain
# versions on the multires pair's target (655362 vertices), decimated to
# the multires coarse_n; ``lap_host`` at three sizes.
NATIVE_LEVELS = 8
NATIVE_LAP_SIZES = (64, 256, 1024)
# The groupwise phase: ``register_pair_symmetric`` on the seed-2 / seed-1
# pair, ``register_all_pairs`` on four subjects of one anatomy (the seed-2
# bone under axial warps of 0-3%, as tests/test_groupwise.py warps one
# bone), the synchronizations with ``n_basis`` 20, JAX's default, and one
# map's rows scrambled for the detection gate.
GROUPWISE_WARPS = ((0.0, 0.0), (0.01, 0.4), (0.02, 0.8), (0.03, 1.2))
GROUPWISE_N_BASIS = 20
GROUPWISE_SCRAMBLED_SHARE = 0.5
# synchronize_spectral's outlier_factor in the phase.  JAX's default 1.3
# (tuned on the bundled bone's three-mesh set, clean ceiling ~0.53 against
# 0.73 scrambled) flags 2-3 of the 12 clean maps of four-subject cohorts
# (tools/groupwise_flagging.py on the CPU at 2562 vertices: these warps,
# 0.3 mm jitter, four different bones): their residuals spread 1.51-1.75x
# about their median, while a map with half its rows permuted scores
# 0.51-0.54, 3.1-6.6x the median.  The phase also reports what 1.3 flags.
GROUPWISE_OUTLIER_FACTOR = 2.5
# The multires phase: the synthetic pair subdivided 8 times (655362
# vertices) with JAX's default coarse_n; a 40962 pair (6) whose coarse_n and
# level_ratio 4 insert intermediate levels; both k-NN routes at 163842 (7);
# CUDA against CPU at 10242 (5) with coarse_n 2562, CPD stopping at 1e-6 as
# in the feature flags' check.
MULTIRES_LEVELS = 8
MULTIRES_COARSE_N = 12000
MULTIRES_MULTI_LEVELS = 6
MULTIRES_MULTI_COARSE_N = 2500
MULTIRES_ROUTE_LEVELS = 7
MULTIRES_CHECK_COARSE_N = 2562
MULTIRES_CHECK_TOLERANCE = FEATURE_CHECK_TOLERANCE

# The cohort (bench.py:652-680, cohort_8x5k_1chip): 8 copies of one subject
# jittered by 0.3 mm, registered to one template, under bench.py's ccfg.
COHORT_CFG = dict(
    non_rigid_max_iterations=100,
    n_coords_spectral_ordering=5000,
    n_coords_spectral_registration=1000,
    graph_smoothing_iterations=300,
    projection_smooth_iterations=1,
)
COHORT_SUBJECTS = 8
COHORT_JITTER_MM = 0.3
COHORT_WARM_REPS = 3
# The padded cohort's four smaller subjects: the subject's next subdivision
# decimated by one aggregation round (``decimate`` contracts ~4.3x a round
# and stops within 1.5x of its target, so these land at ~9.4k vertices; the
# 10242 mesh itself would stay whole for targets from 6900 up).
COHORT_DECIMATE_TARGETS = (9000, 8000, 7000, 6500)
COHORT_ROUNDS = 3
COHORT_CHECK_TOLERANCE = FEATURE_CHECK_TOLERANCE
SSM_RECON_RMS_MAX_MM = 1e-3
COHORT_MIN_UNIQUE = 0.6
# The k = 4..128 kernel's timed k (csrc/knn_topk.cu), at both of the k-NN
# phase's shapes, and the wide-coordinates path (n_spectral_features + 3 xyz
# columns = 19 > 16) with the k of its weighted final locations.  The E-step
# kernel's tiled instance is held at the widths D of WIDE_ESTEP_D.
TOPK_KS = (4, 8, 32, 128)
# The first versions of the two kernels redesigned since: the k = 4..128
# kernel (a warp owning two queries, no split) and the E-step's chunked
# D > 16 instance (32-dimension chunks, a warp owning 4 rows, no split), as
# PERF.md section 6 records them (NVIDIA H100 80GB HBM3, 700 W, run 11c:
# device ms of one call from a CUDA graph of 20), printed beside this run's
# times case by case.
FIRST_TOPK_KERNEL_MS = {
    "xyz_k4": 0.1749, "xyz_k8": 0.1933, "xyz_k32": 0.2794, "xyz_k128": 1.1098,
    "icp_k4": 0.0708, "icp_k8": 0.0797, "icp_k32": 0.1151, "icp_k128": 0.3586,
    "d16_k8": 0.6303}
FIRST_WIDE_ESTEP_KERNEL_MS = {
    "5000_d19_late": 0.7210, "5000_d19_initial": 0.7241, "5000_d32_late": 1.0232,
    "5000_d64_late": 2.0059, "10242_d19_late": 2.0237, "10242_d32_late": 2.9559,
    "10242_d64_late": 5.7735}
WIDE_CFG = dict(n_spectral_features=16, include_points_as_features=True)
WIDE_KS = (8, 32)
WIDE_ESTEP_D = (19, 32, 64)
# The wide path's CUDA-vs-CPU check: 2562 vertices, unweighted coordinates,
# CPD stopped at 1e-6.  At 642 the narrow solver leaves its last pairs of 19
# unconverged (two seeds' eigenvalues 32% apart on the CPU), which no
# CUDA-vs-CPU gate can hold; at 2562 they agree within 2.1e-6.  Weighted
# coordinates move with each eigh's eigenvector signs (PR 8).
WIDE_CHECK_CFG = dict(WIDE_CFG, get_weighted_spectral_coords=False,
                      non_rigid_tolerance=1e-6, rigid_tolerance=1e-6)


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase line also carries the script's seconds so far
    (``elapsed_s``), so each phase's share of the command shows."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def synthetic_bone(tp, seed: int, levels: int = 5):
    mesh = tp.TriMesh(_ICO_VERTS.astype(np.float32), _ICO_FACES, {})
    for _ in range(levels):
        mesh = tp.subdivide(mesh)
    u = np.asarray(mesh.points, np.float64)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 4)
    amp = rng.uniform(0.04, 0.10, 4)
    r = 1.0
    r = r + amp[0] * np.sin(2.0 * u[:, 0] + ph[0]) * np.cos(1.5 * u[:, 1] + ph[1])
    r = r + amp[1] * np.sin(3.0 * u[:, 2] + ph[2])
    r = r + amp[2] * np.cos(2.5 * u[:, 1] + ph[3]) * u[:, 2]
    r = r + amp[3] * u[:, 0] * u[:, 1]
    pts = u * r[:, None] * np.array([[16.0, 13.0, 38.0]])  # mm, elongated
    thickness = 1.0 + np.sin(3.0 * u[:, 2] + ph[0]) * np.cos(u[:, 0] + ph[2])
    return tp.TriMesh(pts.astype(np.float32), np.asarray(mesh.triangles, np.int32),
                      {FEATURE: thickness.astype(np.float32)})


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms_once(torch, fn):
    """One call's result and its milliseconds on the card (CUDA events), for
    a call too long to repeat."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(torch, fn, reps: int = 20) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_knn(torch, knn_kernel, ref, query, k):
    """Kernel against plain version on the same card: indices equal, inf
    pattern equal, finite distances within rtol 1e-6 (and whether they are
    equal outright)."""
    kd, ki = knn_kernel.knn_cuda(ref, query, k)
    pd, pi = knn_kernel.knn_plain(ref, query, k)
    torch.cuda.synchronize()
    idx_equal = bool(torch.equal(ki, pi))
    inf_equal = bool(torch.equal(torch.isinf(kd), torch.isinf(pd)))
    fin = torch.isfinite(pd)
    err = (kd[fin] - pd[fin]).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    tol_ok = bool(torch.all(err <= 1e-6 * pd[fin].abs())) if err.numel() else True
    return {"idx_equal": idx_equal, "inf_equal": inf_equal,
            "max_abs_err": max_abs, "within_rtol_1e-6": tol_ok,
            "bit_equal": bool(torch.equal(kd, pd)) and idx_equal}


def knn_bound(nq, nr, d, k):
    """Least time of the k-NN on the card, in ms, and what sets it: 3 d
    unfused lane instructions a pair (d subtractions, d multiplies, d - 1
    adds and one compare) over the card's lane rate; the inputs read and
    the outputs written once."""
    ops_ms = nq * nr * 3 * d / F32_LANE_INSTR_PER_S * 1e3
    bytes_ms = ((nq + nr) * d * 4 + nq * k * 8) / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_kernel(torch, knn_kernel, tgt_pts, src_pts):
    """The k-NN kernel against ``knn_plain`` on the card: the contract cases
    (ties, non-finite rows, fewer references than k, sentinel rows, D = 16),
    query counts 1, 7, 2000 and 10242 at 10242 references, reference counts
    that are no multiple of a tile or a split, every split (1-16 CTAs),
    ties whose twins lie in different splits, and the ``done`` flag's early
    return; then the main path's shapes timed: ``kernel_ms`` the device time
    of one call from a CUDA graph of 20, ``call_ms`` one call between CUDA
    events (the host's launch cost where it exceeds the device time)."""
    dev = "cuda"
    g = torch.Generator().manual_seed(0)
    ref = torch.tensor(tgt_pts, device=dev)
    query = torch.tensor(src_pts, device=dev)
    nr = ref.shape[0]
    icp_q = query[:2000].contiguous()
    spec_ref = (torch.rand(ref.shape, generator=g) - 0.5).to(dev)
    spec_query = (torch.rand(query.shape, generator=g) - 0.5).to(dev)
    timed = [
        # (name, ref, query, k): the main path's shapes
        ("xyz_k1", ref, query, 1),  # warm-start map, mutual check
        ("xyz_k3", ref, query, 3),  # final k=3 query
        ("spectral_k1", spec_ref, spec_query, 1),  # initial correspondences
        ("icp_k1", ref, icp_q, 1),  # one ICP iteration (2000 landmarks)
        ("icp_k2", ref, icp_q, 2),
        ("icp_k3", ref, icp_q, 3),
    ]
    ties = torch.randn(50, 3, generator=g).repeat_interleave(2, 0)
    nonfinite = torch.randn(40, 3, generator=g)
    nonfinite[7] = float("nan")
    nonfinite[11, 1] = float("inf")
    sentinel = torch.tensor([[0.0, 0, 0], [1, 0, 0], [1e30, 1e30, 1e30],
                             [1e30, 1e30, 1e30]])
    contract = [
        ("ties", ties, ties[::2].contiguous(), 2),
        ("nonfinite_ref", nonfinite, nonfinite[[3, 20, 33]] + 1e-4, 3),
        ("nr_lt_k", torch.randn(2, 3, generator=g), torch.randn(5, 3, generator=g), 3),
        ("sentinel_rows", sentinel, torch.zeros(1, 3), 3),
        ("d16", torch.randn(3000, 16, generator=g), torch.randn(700, 16, generator=g), 3),
        ("d5", torch.randn(2000, 5, generator=g), torch.randn(300, 5, generator=g), 2),
        ("nq_1", ref, query[:1], 3),
        ("nq_7", ref, query[:7], 3),
        ("nr_ragged", ref[:nr - 1], icp_q, 3),  # 10241: no multiple of a tile or split
        ("nr_3001", ref[:3001], query, 2),
    ]
    results = []
    for name, r, q, k in contract:
        res = compare_knn(torch, knn_kernel, r.to(dev).contiguous(),
                          q.to(dev).contiguous(), k)
        res.update(case=name, nr=r.shape[0], nq=q.shape[0], d=r.shape[1], k=k)
        results.append(res)
    # Every split of the reference axis the library picks (1-16 CTAs a
    # cluster), each merged across its CTAs.
    splits_seen = set()
    for nq_s, nr_s in ((2000, 400), (2000, 700), (10242, nr), (2000, 3001), (2000, nr)):
        q, r = query[:nq_s].contiguous(), ref[:nr_s].contiguous()
        splits = knn_kernel.plan(nq_s, nr_s)["splits"]
        splits_seen.add(splits)
        res = compare_knn(torch, knn_kernel, r, q, 3)
        res.update(case=f"splits_{splits}", nr=nr_s, nq=nq_s, d=3, k=3)
        results.append(res)
    check(splits_seen == {1, 2, 4, 8, 16}, f"k-NN splits covered: {sorted(splits_seen)}")
    ties_idx = knn_kernel.knn_cuda(ties.to(dev), ties[::2].contiguous().to(dev), 2)[1]
    check(bool(torch.equal(ties_idx[:, 0].cpu(), torch.arange(0, 100, 2, dtype=torch.int32))),
          "tie rule: lower reference index first")
    # Twins at i and i + half: at the ICP shape's split (16 CTAs of 641
    # references) every pair lies in two different CTAs.
    half = nr // 2
    twins = torch.cat([ref[:half], ref[:half]]).contiguous()
    rows = torch.arange(0, half, 5, device=dev)
    tq = (ref[rows] + 1e-3).contiguous()
    res = compare_knn(torch, knn_kernel, twins, tq, 2)
    td, ti = knn_kernel.knn_cuda(twins, tq, 2)
    split_of = lambda i: i // -(-twins.shape[0] // knn_kernel.plan(tq.shape[0], twins.shape[0])["splits"])
    res.update(case="cross_split_ties", nr=twins.shape[0], nq=tq.shape[0], d=3, k=2,
               twins_in_other_split=bool((split_of(rows) != split_of(rows + half)).all()),
               lower_index_first=bool(torch.equal(ti[:, 0].long(), rows)
                                      and torch.equal(ti[:, 1].long(), rows + half)
                                      and torch.equal(td[:, 0], td[:, 1])))
    check(res["twins_in_other_split"] and res["lower_index_first"],
          f"ties across splits: the lower index must come first: {res}")
    results.append(res)
    # The done flag: set, the kernel leaves its outputs as they were.
    out = (torch.full((2000, 3), -1.0, device=dev),
           torch.full((2000, 3), -7, dtype=torch.int32, device=dev))
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    knn_kernel.knn_cuda(ref, icp_q, 3, out=out, done=flag)
    torch.cuda.synchronize()
    untouched = bool((out[0] == -1.0).all() and (out[1] == -7).all())
    flag.zero_()
    knn_kernel.knn_cuda(ref, icp_q, 3, out=out, done=flag)
    pd, pi = knn_kernel.knn_plain(ref, icp_q, 3)
    res = {"case": "done_flag", "nr": nr, "nq": 2000, "d": 3, "k": 3,
           "set_leaves_outputs": untouched,
           "unset_equal_to_plain": bool(torch.equal(out[0], pd) and torch.equal(out[1], pi))}
    check(untouched and res["unset_equal_to_plain"], f"k-NN done flag: {res}")
    results.append(res)
    for name, r, q, k in timed:
        res = compare_knn(torch, knn_kernel, r, q, k)
        buf = (torch.empty((q.shape[0], k), device=dev),
               torch.empty((q.shape[0], k), dtype=torch.int32, device=dev))
        run_k = lambda: knn_kernel.knn_cuda(r, q, k, out=buf)
        # Alternate plain, kernel, kernel, plain so drift hits both alike.
        p1 = cuda_ms(torch, lambda: knn_kernel.knn_plain(r, q, k))
        k1 = graph_ms(torch, run_k)
        k2 = graph_ms(torch, run_k)
        p2 = cuda_ms(torch, lambda: knn_kernel.knn_plain(r, q, k))
        res.update(case=name, nr=r.shape[0], nq=q.shape[0], d=r.shape[1], k=k,
                   kernel_ms=(k1 + k2) / 2, call_ms=cuda_ms(torch, run_k),
                   plain_ms=(p1 + p2) / 2, plan=knn_kernel.plan(q.shape[0], r.shape[0]),
                   **knn_bound(q.shape[0], r.shape[0], r.shape[1], k))
        results.append(res)
    for res in results:
        if "idx_equal" in res:
            check(res["idx_equal"] and res["inf_equal"] and res["within_rtol_1e-6"]
                  and res["bit_equal"],
                  f"k-NN kernel disagrees with its plain version: {res}")
    emit({"phase": "knn_kernel_vs_plain", "cases": results,
          "kernel_ms": "device time of one call from a CUDA graph of 20 calls"})
    return results


def euclidean_cost(torch, query, ref):
    """The 'hungarian' cost of the pipeline (``pipeline._hungarian``)."""
    from pyfocusr_tpu_torch.ops.knn import pairwise_sq_dists

    return torch.sqrt(torch.clamp(pairwise_sq_dists(query, ref), min=0.0)).contiguous()


def lap_objective(torch, query, ref, corr) -> float:
    """Summed Euclidean distance from each query row to its assigned
    reference row, in float64."""
    return float((query.double() - ref.double()[corr]).norm(dim=1).sum())


def phase_lse(torch, SK, costs):
    """The Sinkhorn kernel against ``lse_rows_plain`` on the card, on the
    'hungarian' costs of the 2562 and the 10242 pair: row pass and column
    pass, at the highest and the lowest temperature of the 14-level
    schedule; kernel, plain and ``torch.logsumexp`` times and the bound."""
    g = torch.Generator().manual_seed(1)
    results = []
    for cost in costs:
        n = cost.shape[0]
        spread = float(cost.max() - cost.min())
        vec = (0.01 * spread * torch.randn(n, generator=g)).cuda()
        bound_ms = (n * n + 2 * n) * 4 / HBM_BYTES_PER_S * 1e3
        ops_ms = 7 * n * n / F32_OPS_PER_S * 1e3  # 6 flops and an exp per entry
        for level in (0, 13):
            inv_t = 1.0 / (spread / 4.0 * (1.0 / 3.0) ** level)
            for transpose in (False, True):
                k = SK.lse_rows_cuda(cost, vec, inv_t, transpose)
                p = SK.lse_rows_plain(cost, vec, inv_t, transpose)
                torch.cuda.synchronize()
                err = float((k - p).abs().max())
                check(bool(torch.isfinite(k).all()), "lse kernel output finite")
                dim = 0 if transpose else 1
                bvec = vec.unsqueeze(1 - dim)
                run_k = lambda: SK.lse_rows_cuda(cost, vec, inv_t, transpose)
                run_p = lambda: SK.lse_rows_plain(cost, vec, inv_t, transpose)
                p1 = cuda_ms(torch, run_p, reps=5)
                k1 = cuda_ms(torch, run_k)
                k2 = cuda_ms(torch, run_k)
                p2 = cuda_ms(torch, run_p, reps=5)
                # The same function around one library reduction: the
                # subtract, the scale and the rescale are counted with it.
                lib = cuda_ms(torch, lambda: -torch.logsumexp(
                    (bvec - cost) * inv_t, dim=dim) / inv_t, reps=5)
                res = {"n": n, "level": level, "inv_t": inv_t, "transpose": transpose,
                       "spread": spread, "max_abs_err": err,
                       "tolerance": LSE_TOL_OF_SPREAD * spread,
                       "kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                       "logsumexp_ms": lib, "bound_ms": max(bound_ms, ops_ms),
                       "bound_by": "bytes" if bound_ms >= ops_ms else "operations"}
                check(err <= res["tolerance"],
                      f"lse kernel disagrees with its plain version: {res}")
                results.append(res)
    emit({"phase": "lse_kernel_vs_plain", "cases": results,
          "bound": "one read of the cost over 3.35 TB/s (H100 SXM data sheet)",
          "logsumexp_ms": "-torch.logsumexp((vec - C) * inv_t, dim) / inv_t",
          "launches": "a column update is two __global__ kernels, counted once"})
    return results


def dual_certificate(torch, cost, col, u, v):
    """Optimality of an assignment from its duals, in O(n^2) on the card:
    the least reduced cost (>= 0 up to rounding) and the gap between the
    assignment's cost and sum(u) + sum(v), relative."""
    n = cost.shape[0]
    min_reduced = float((cost - u[:, None] - v[None, :]).min())
    obj = float(cost[torch.arange(n, device=cost.device), col.long()].double().sum())
    dual = float(u.double().sum() + v.double().sum())
    return {"min_reduced_cost": min_reduced, "objective": obj, "dual_objective": dual,
            "duality_gap_rel": abs(obj - dual) / max(abs(obj), 1e-30)}


def jv_vs_plain(torch, JV, cost, u0, v0, r4c, c4r, budget, col, steps, u, v):
    """The kernel's result against ``jv_device_plain`` (a host loop, run on
    CPU copies of the same inputs: both do the same f32 additions,
    subtractions and comparisons, so the results must be equal)."""
    t0 = time.perf_counter()
    pcol, psteps, pu, pv = JV.jv_device_plain(
        cost.cpu(), u0.cpu(), v0.cpu(), r4c.cpu(), c4r.cpu(), budget)
    res = {"plain_ms": (time.perf_counter() - t0) * 1e3, "plain_on": "cpu",
           "col4row_equal": bool(torch.equal(pcol, col.cpu())),
           "steps_equal": int(psteps) == int(steps),
           "duals_equal": bool(torch.equal(pu, u.cpu()) and torch.equal(pv, v.cpu())),
           "max_abs_err": max(float((pu - u.cpu()).abs().max()),
                              float((pv - v.cpu()).abs().max())),
           "col4row_mismatches": int((pcol != col.cpu()).sum())}
    check(res["col4row_equal"] and res["steps_equal"] and res["duals_equal"],
          f"JV kernel disagrees with its plain version: {res}")
    return res


def jv_bound(steps, n):
    """Rows visited are re-read from device memory (4 n bytes a step, at most
    n distinct rows); 5 f32 operations a column a step."""
    bytes_ms = (min(steps, n) * n + 8 * n) * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = 5 * steps * n / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def jv_checks(torch, TA, cost, col, u, v, res, budget_hit_ok=False):
    """When the budget was not hit: no row left free, the kernel's own
    result a permutation, and the duality certificate.  Where the budget ran
    out (only where the caller allows it): a permutation after the solver's
    greedy completion of the rows left free."""
    n = cost.shape[0]
    spread = float(cost.max() - cost.min())
    res["budget_hit"] = res["steps"] >= res["budget"]
    res["rows_left_free"] = int((col < 0).sum())
    if res["budget_hit"]:
        check(budget_hit_ok, f"JV step budget hit: {res}")
        col = TA._greedy_complete(col.long(), n)
    else:
        check(res["rows_left_free"] == 0, f"JV left rows free within its budget: {res}")
    res["permutation"] = bool(torch.equal(torch.sort(col.long()).values,
                                          torch.arange(n, device=cost.device)))
    check(res["permutation"], f"JV kernel result is no permutation: {res}")
    if not res["budget_hit"]:
        res.update(dual_certificate(torch, cost, col, u, v))
        check(res["min_reduced_cost"] >= -1e-5 * spread
              and res["duality_gap_rel"] <= 1e-5,
              f"JV duality certificate fails: {res}")


def subdivided_xyz_cost(torch, tp, levels, device):
    """Euclidean distances between the vertices of the synthetic pair
    subdivided ``levels`` times (40962 vertices at 6), f32, made in row
    blocks so that no temporary exceeds a block."""
    src = torch.tensor(synthetic_bone(tp, 1, levels).points, device=device)
    tgt = torch.tensor(synthetic_bone(tp, 2, levels).points, device=device)
    cost = torch.empty((src.shape[0], tgt.shape[0]), dtype=torch.float32, device=device)
    for r0 in range(0, src.shape[0], 4096):
        cost[r0:r0 + 4096] = euclidean_cost(torch, src[r0:r0 + 4096], tgt)
    return cost


def phase_jv(torch, tp, SK, JV, TA, cost_small, cost_full):
    """The Jonker-Volgenant kernel against ``jv_device_plain`` on CPU copies
    of the same inputs, warm-started from the Sinkhorn duals and cold, and
    against scipy at n = 2562; at n = 10242 the duality certificate, the
    budget and the time per step.  Then, at 2562: a tie-heavy integer cost
    (equal to the plain version under a budget that ends partway, and solved
    in full against scipy's objective) and the Sinkhorn-started cost under
    half the steps it needs; and above the old one-block limit, n = 40962
    (Euclidean cost between the vertices of the pair's next subdivision,
    Sinkhorn-started, budget 400 n, held by the permutation and the duality
    certificate: the plain host loop is too slow there)."""
    from scipy.optimize import linear_sum_assignment

    results = []
    for cost in (cost_small, cost_full):
        n = cost.shape[0]
        budget = 60 * n
        spread = float(cost.max() - cost.min())
        warm = lambda: SK.sinkhorn_duals_streamed(cost, spread / 4.0, 1.0 / 3.0, 14, 30)
        _, g = warm()
        # The LAP's other two parts at this size, timed with CUDA events.
        lap_ms = {"warm_start_ms": cuda_ms(torch, warm, reps=2),
                  "bulk_match_ms": cuda_ms(torch, lambda: TA._bulk_match(cost, g), reps=5)}
        scipy_obj = None
        if n <= 4096:
            c64 = cost.double().cpu().numpy()
            ri, ci = linear_sum_assignment(c64)
            scipy_obj = float(c64[ri, ci].sum())
        # The cold start is held to the plain version at 2562 only: at 10242
        # it needs more than the 60 n steps the main path budgets.
        starts = [("sinkhorn", g)]
        if n <= 4096:
            starts.append(("cold", torch.zeros_like(g)))
        for start, v0 in starts:
            u0, r4c, c4r = TA._bulk_match(cost, v0)
            n_free = int((c4r < 0).sum())
            run = lambda: JV.jv_device_cuda(cost, u0, v0, r4c, c4r, budget)
            col, steps, u, v = run()
            torch.cuda.synchronize()
            steps = int(steps)
            ms = cuda_ms(torch, run, reps=3)
            res = {"n": n, "start": start, "n_free_rows": n_free, "steps": steps,
                   "budget": budget, "steps_per_free_row": steps / max(n_free, 1),
                   "kernel_ms": ms, "us_per_step": ms * 1e3 / max(steps, 1)}
            if start == "sinkhorn":
                res.update(lap_ms)
            jv_checks(torch, TA, cost, col, u, v, res)
            if scipy_obj is not None:
                res["scipy_objective"] = scipy_obj
                check(abs(res["objective"] - scipy_obj) <= 1e-6 * scipy_obj,
                      f"JV objective differs from scipy's: {res}")
            res.update(jv_vs_plain(torch, JV, cost, u0, v0, r4c, c4r, budget,
                                   col, steps, u, v))
            res.update(jv_bound(steps, n))
            results.append(res)
            if n <= 4096 and start == "sinkhorn":
                # The budget runs out partway through a search.
                half = steps // 2
                hcol, hsteps, hu, hv = JV.jv_device_cuda(cost, u0, v0, r4c, c4r, half)
                torch.cuda.synchronize()
                hres = {"n": n, "start": "sinkhorn_budget_half", "n_free_rows": n_free,
                        "steps": int(hsteps), "budget": half,
                        "rows_left_free": int((hcol < 0).sum())}
                check(int(hsteps) == half and hres["rows_left_free"] > 0,
                      f"JV budget case did not run out: {hres}")
                hres.update(jv_vs_plain(torch, JV, cost, u0, v0, r4c, c4r, half,
                                        hcol, hsteps, hu, hv))
                results.append(hres)

    # Ties everywhere, also across the CTAs' column ranges: integers 0-9.
    n = cost_small.shape[0]
    dev = cost_small.device
    ties = torch.tensor(np.random.default_rng(0).integers(0, 10, (n, n))
                        .astype(np.float32), device=dev)
    v0 = torch.zeros(n, device=dev)
    u0, r4c, c4r = TA._bulk_match(ties, v0)
    n_free = int((c4r < 0).sum())
    budget = 40 * n  # the plain loop runs ~10 s; the full solve needs ~1280 n
    col, steps, u, v = JV.jv_device_cuda(ties, u0, v0, r4c, c4r, budget)
    torch.cuda.synchronize()
    res = {"n": n, "start": "ties_int0-9_cold_budget", "n_free_rows": n_free,
           "steps": int(steps), "budget": budget,
           "rows_left_free": int((col < 0).sum())}
    res.update(jv_vs_plain(torch, JV, ties, u0, v0, r4c, c4r, budget, col, steps, u, v))
    results.append(res)
    budget = 2000 * n
    (col, steps, u, v), ms = cuda_ms_once(
        torch, lambda: JV.jv_device_cuda(ties, u0, v0, r4c, c4r, budget))
    res = {"n": n, "start": "ties_int0-9_cold", "n_free_rows": n_free,
           "steps": int(steps), "budget": budget, "kernel_ms": ms,
           "us_per_step": ms * 1e3 / max(int(steps), 1)}
    jv_checks(torch, TA, ties, col, u, v, res)
    c64 = ties.double().cpu().numpy()
    ri, ci = linear_sum_assignment(c64)
    res["scipy_objective"] = float(c64[ri, ci].sum())
    check(res["objective"] == res["scipy_objective"],
          f"JV objective on integer costs differs from scipy's: {res}")
    results.append(res)
    del ties

    # Above the one-block limit of 25600: the next subdivision, 40962.
    cost = subdivided_xyz_cost(torch, tp, JV_BIG_LEVELS, dev)
    n = cost.shape[0]
    spread = float(cost.max() - cost.min())
    _, g = SK.sinkhorn_duals_streamed(cost, spread / 4.0, 1.0 / 3.0, 14, 30)
    u0, r4c, c4r = TA._bulk_match(cost, g)
    n_free = int((c4r < 0).sum())
    budget = 400 * n
    (col, steps, u, v), ms = cuda_ms_once(
        torch, lambda: JV.jv_device_cuda(cost, u0, g, r4c, c4r, budget))
    res = {"n": n, "start": "sinkhorn_xyz_subdivided", "n_free_rows": n_free,
           "steps": int(steps), "budget": budget,
           "steps_per_free_row": int(steps) / max(n_free, 1),
           "kernel_ms": ms, "us_per_step": ms * 1e3 / max(int(steps), 1),
           "cost_bytes": cost.numel() * 4, "plain": "not run (host loop too slow)"}
    jv_checks(torch, TA, cost, col, u, v, res, budget_hit_ok=True)
    res.update(jv_bound(int(steps), n))
    results.append(res)
    del cost
    torch.cuda.empty_cache()
    config = JV.library_config()
    check(config["cluster_size"] == JV.CLUSTER_SIZE
          and config["threads_per_cta"] == JV.THREADS_PER_CTA
          and config["max_n"] == JV.MAX_N,
          f"the JV library was built with another configuration: {config}")
    emit({"phase": "jv_kernel_vs_plain", "config": config, "cases": results})
    return results, config


class CpdRecorder:
    """Records what each ``_deformable_cpd_run`` of the pipeline returned
    (EM iterations, final sigma2, the E-step taken), and the last call's
    arguments, and the iterations and E-step of each affine pre-pass
    (``affine_runs``), while installed; the pipeline calls both through the
    module attributes."""

    def __init__(self, cpd_ops):
        self.mod = cpd_ops
        self.real = cpd_ops._deformable_cpd_run
        self.real_affine = cpd_ops._affine_cpd_run
        self.runs = []
        self.affine_runs = []
        self.last_call = None

    def __enter__(self):
        def recorded(*args, **kwargs):
            self.last_call = (args, kwargs)
            out = self.real(*args, **kwargs)
            self.runs.append({"iterations": int(out[3]), "sigma2": float(out[2]),
                              "estep_impl": kwargs.get("estep_impl", "dense"),
                              "n_control": int(args[1].shape[0])})
            return out

        def recorded_affine(*args, **kwargs):
            out = self.real_affine(*args, **kwargs)
            self.affine_runs.append({"iterations": int(out[4]),
                                     "estep_impl": kwargs.get("estep_impl", "dense")})
            return out

        self.mod._deformable_cpd_run = recorded
        self.mod._affine_cpd_run = recorded_affine
        return self

    def __exit__(self, *exc):
        self.mod._deformable_cpd_run = self.real
        self.mod._affine_cpd_run = self.real_affine

    def streamed_loops(self):
        """(EM iterations, loops) of the last pair's streamed runs: its
        deformable run and the affine pre-pass before it, if streamed."""
        loops = [self.runs[-1]]
        if self.affine_runs and self.affine_runs[-1]["estep_impl"] == "streamed":
            loops.append(self.affine_runs[-1])
        return sum(r["iterations"] for r in loops), len(loops)


def knn_topk_bound(nq, nr, d, k, insertions):
    """Least time of the k = 4..128 k-NN on the card, in ms: the distance
    work of ``knn_bound`` (3 d unfused lane instructions a pair) and the
    list work these inputs need: each of ``insertions`` (the kernel's count
    of candidates that beat the k-th entry, scanning in index order) moves
    and compares the k entries of a sorted list once (2 k lane
    instructions); the inputs read and the outputs written once."""
    ops_ms = (nq * nr * 3 * d + insertions * 2 * k) / F32_LANE_INSTR_PER_S * 1e3
    bytes_ms = ((nq + nr) * d * 4 + nq * k * 8) / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "insertions": insertions,
            "distance_only_ms": nq * nr * 3 * d / F32_LANE_INSTR_PER_S * 1e3}


def topk_grid_cases(torch, device="cuda"):
    """Cases of the k = 4..128 kernel on both of ``plan``'s grids, (name,
    ref, query, k): 6401 queries take 4 a warp up to k = 32; 77 and 333
    queries, one query and every k above 32 take 1 (the thread queues).  Integer-grid clouds
    (many equal distances), 90 references (fewer than k = 96 and 128),
    query counts no multiple of a CTA's, k across the 32-entry list
    registers.  The card test
    ``tests/test_torch_knn.py::test_topk_kernel_matches_plain_on_card``
    takes these cases too."""
    g = torch.Generator().manual_seed(23)
    ref = torch.randint(0, 5, (3001, 3), generator=g).float().to(device)
    many = torch.randint(0, 5, (6401, 3), generator=g).float().to(device)
    cases = []
    for k in (4, 8, 31, 32, 33, 64, 65, 96, 128):
        for name, r, q in (("grid_ties_6401", ref, many), ("grid_ties_77", ref, many[:77]),
                           ("nq_1", ref, many[:1]), ("nr_90_6401", ref[:90], many),
                           ("nr_90_333", ref[:90], many[:333])):
            cases.append((f"{name}_k{k}", r.contiguous(), q.contiguous(), k))
    return cases


def phase_knn_topk(torch, knn_kernel, topk, tgt_pts, src_pts):
    """The k = 4..128 kernel (``csrc/knn_topk.cu``, through
    ``knn_kernel.knn_cuda``) against ``knn_plain`` on the card, bit for
    bit: contract cases (ties, non-finite and sentinel rows, fewer
    references than k, D = 5 and 16, one query, a k that is no multiple of
    32), both of ``plan``'s grids (1 and 4 queries a warp) at every list
    width (``topk_grid_cases``), the done flag, and ``TOPK_KS`` at the k-NN phase's two shapes (10242^2
    and ICP's 2000 x 10242, D = 3) plus k = 8 at D = 16, each timed as
    ``phase_kernel`` times k = 1..3, beside the first version's time
    (``FIRST_TOPK_KERNEL_MS``) and held to its bound (the list work from the
    kernel's own insertion count)."""
    dev = "cuda"
    g = torch.Generator().manual_seed(11)
    ref = torch.tensor(tgt_pts, device=dev)
    query = torch.tensor(src_pts, device=dev)
    nr = ref.shape[0]
    icp_q = query[:2000].contiguous()
    ties = torch.randn(300, 3, generator=g).repeat_interleave(2, 0)
    nonfinite = torch.randn(400, 3, generator=g)
    nonfinite[::7] = float("nan")
    nonfinite[5, 2] = float("inf")
    sentinel = torch.cat([torch.randn(5, 3, generator=g), torch.full((20, 3), 1e30)])
    contract = [
        ("ties", ties, ties[::3].contiguous(), 4),
        ("nonfinite_ref", nonfinite, torch.randn(50, 3, generator=g), 5),
        ("nr_lt_k", torch.randn(6, 3, generator=g), torch.randn(9, 3, generator=g), 8),
        ("sentinel_rows", sentinel, torch.randn(4, 3, generator=g), 8),
        ("d5_k100", torch.randn(2000, 5, generator=g), torch.randn(300, 5, generator=g), 100),
        ("d16_k33", torch.randn(3000, 16, generator=g), torch.randn(77, 16, generator=g), 33),
        ("nq_1_k128", ref, query[:1], 128),
    ]
    results = []
    for name, r, q, k in contract:
        res = compare_knn(torch, knn_kernel, r.to(dev).contiguous(), q.to(dev).contiguous(), k)
        res.update(case=name, nr=r.shape[0], nq=q.shape[0], d=r.shape[1], k=k,
                   grid=topk.plan(q.shape[0], k))
        results.append(res)
    for name, r, q, k in topk_grid_cases(torch, dev):
        res = compare_knn(torch, knn_kernel, r, q, k)
        res.update(case=name, nr=r.shape[0], nq=q.shape[0], d=3, k=k,
                   grid=topk.plan(q.shape[0], k))
        results.append(res)
    out = (torch.full((2000, 8), -1.0, device=dev),
           torch.full((2000, 8), -7, dtype=torch.int32, device=dev))
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    knn_kernel.knn_cuda(ref, icp_q, 8, out=out, done=flag)
    torch.cuda.synchronize()
    untouched = bool((out[0] == -1.0).all() and (out[1] == -7).all())
    flag.zero_()
    knn_kernel.knn_cuda(ref, icp_q, 8, out=out, done=flag)
    pd, pi = knn_kernel.knn_plain(ref, icp_q, 8)
    res = {"case": "done_flag", "nr": nr, "nq": 2000, "d": 3, "k": 8,
           "grid": topk.plan(2000, 8), "set_leaves_outputs": untouched,
           "unset_equal_to_plain": bool(torch.equal(out[0], pd) and torch.equal(out[1], pi))}
    check(untouched and res["unset_equal_to_plain"], f"k-NN top-k done flag: {res}")
    results.append(res)
    spec_ref = torch.randn(nr, 16, generator=g).to(dev)
    spec_query = torch.randn(query.shape[0], 16, generator=g).to(dev)
    timed_cases = [(f"xyz_k{k}", ref, query, k) for k in TOPK_KS]
    timed_cases += [(f"icp_k{k}", ref, icp_q, k) for k in TOPK_KS]
    timed_cases.append(("d16_k8", spec_ref, spec_query, 8))
    for name, r, q, k in timed_cases:
        res = compare_knn(torch, knn_kernel, r, q, k)
        buf = (torch.empty((q.shape[0], k), device=dev),
               torch.empty((q.shape[0], k), dtype=torch.int32, device=dev))
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        topk.knn_topk_cuda(r, q, k, buf, insertions=counter)
        run_k = lambda: knn_kernel.knn_cuda(r, q, k, out=buf)
        p1 = cuda_ms(torch, lambda: knn_kernel.knn_plain(r, q, k), reps=2)
        k1 = graph_ms(torch, run_k)
        k2 = graph_ms(torch, run_k)
        p2 = cuda_ms(torch, lambda: knn_kernel.knn_plain(r, q, k), reps=2)
        res.update(case=name, nr=r.shape[0], nq=q.shape[0], d=r.shape[1], k=k,
                   kernel_ms=(k1 + k2) / 2, first_version_ms=FIRST_TOPK_KERNEL_MS.get(name),
                   call_ms=cuda_ms(torch, run_k), plain_ms=(p1 + p2) / 2,
                   grid=topk.plan(q.shape[0], k),
                   **knn_topk_bound(q.shape[0], r.shape[0], r.shape[1], k,
                                    int(counter.item())))
        results.append(res)
    for res in results:
        if "idx_equal" in res:
            check(res["idx_equal"] and res["inf_equal"] and res["bit_equal"],
                  f"k-NN top-k kernel disagrees with its plain version: {res}")
    emit({"phase": "knn_topk_kernel_vs_plain", "cases": results,
          "kernel_ms": "device time of one call from a CUDA graph of 20 calls",
          "first_version_ms": "the first version of the kernel (FIRST_TOPK_KERNEL_MS)",
          "grid": "queries_per_warp, ctas, warps_per_sm = the grid's warps over the SMs",
          "library_ms": None,
          "library_why": "torch.cdist + topk: two calls, and the matmul identity the "
                         "contract forbids"})
    return results


def estep_launches_fit(launches: int, rec, cpd_ops) -> bool:
    """E-step launches of a pair's streamed EM runs (``rec``, a
    CpdRecorder): two per iteration, plus two per masked iteration replayed
    after a run converged (fewer than one block a run; the kernels launch
    and return at once on the stop flag)."""
    iterations, loops = rec.streamed_loops()
    return 0 < 2 * iterations <= launches < 2 * (iterations + loops * cpd_ops.EM_BLOCK)


def estep_bound(M: int, N: int, D: int):
    """Least time of the two-pass E-step on the card, in ms, and what sets
    it. Per (m, n) pair the den pass does D subtractions, D multiply-adds
    (2 operations each), a scale, an exp and an add (3 D + 3); the row pass
    the same distance and exp, a multiply by 1/den, an add to P1 and D
    multiply-adds into PX (5 D + 4). The exps also bound through the
    special-function units. Bytes: X and TY read once, den, P1 and PX
    written once. A single pass would have to store P (8 M N bytes through
    memory), which costs more than recomputing it."""
    ops_ms = M * N * (8 * D + 7) / F32_OPS_PER_S * 1e3
    exp_ms = 2 * M * N / SFU_EXP_PER_S * 1e3
    bytes_ms = ((M + N) * D + N + M + M * D) * 4 / HBM_BYTES_PER_S * 1e3
    bound = max(ops_ms, exp_ms, bytes_ms)
    return {"bound_ms": bound, "bound_by": "bytes" if bound == bytes_ms else "operations",
            "f32_ops_ms": ops_ms, "sfu_exp_ms": exp_ms, "bytes_ms": bytes_ms}


def graph_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in a
    CUDA graph and replayed ``reps`` times between CUDA events, so the
    host's launch overhead, which a host-bound wrapper would add to plain
    CUDA events, is not in the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def estep_errors(torch, got, want):
    """Each output's max |kernel - plain|, that over max(1, max |plain|)
    (the scale the tolerance takes), and whether all are within it."""
    errs, of_scale, ok = {}, {}, True
    for out, g, w in zip(("Pt1", "P1", "PX", "Np", "L"), got, want):
        check(bool(torch.isfinite(g).all()), f"E-step kernel {out} finite")
        err = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        errs[out], of_scale[out] = err, err / scale
        ok = ok and err <= ESTEP_TOL_OF_SCALE * scale
    return errs, of_scale, ok


def phase_cpd_estep(torch, EK, cpd_ops, cases, phase="cpd_estep_kernel_vs_plain",
                    edges=(), first_ms=None):
    """The streamed E-step kernel against ``cpd_estep_plain`` on the card at
    the main paths' shapes (10242^2 full resolution, 5000^2 the raw
    defaults) and widths (D = 3; D = 6 with xyz appended), at the initial
    sigma2 of EM and at the small sigma2 a full-resolution run ends at;
    kernel, plain and dense-E-step (P materialized) times and the bound.
    ``kernel_ms`` is the device time of one call of a planned ``CudaEstep``
    (its two launches) from a CUDA graph of calls, ``den_pass_ms`` that of
    the den pass alone, ``row_pass_ms`` the difference; ``call_ms`` one call
    by plain CUDA events, which the host's launch overhead sets when it
    exceeds the device time.  D > 16 cases also give the grid (``plan``:
    cluster size, CTAs and the grid's warps an SM per pass), the time of the
    first version from ``first_ms`` and whether two calls repeat bit for
    bit.  ``edges`` (name, X, TY, sigma2) are checked for
    tolerance and repetition only."""
    results = []
    for name, X, TY, sigma2 in edges:
        s2 = torch.tensor(sigma2, dtype=torch.float32, device=X.device)
        est = EK.CudaEstep(X, TY.shape[0])
        got = [t.clone() for t in est(TY, s2)]
        again = est(TY, s2)
        errs, of_scale, ok = estep_errors(torch, got, EK.cpd_estep_plain(X, TY, s2))
        res = {"case": name, "M": TY.shape[0], "N": X.shape[0], "D": X.shape[1],
               "sigma2": sigma2, "grid": est.plan, "max_abs_err": errs,
               "max_err_of_scale": of_scale, "within_tolerance": ok,
               "repeat_bit_equal": all(bool(torch.equal(a, b)) for a, b in zip(got, again))}
        check(ok and res["repeat_bit_equal"], f"E-step kernel edge case: {res}")
        results.append(res)
    for name, X, TY, sigma2 in cases:
        (N, D), M = X.shape, TY.shape[0]
        s2 = torch.tensor(sigma2, dtype=torch.float32, device=X.device)
        est = EK.CudaEstep(X, M)
        got = [t.clone() for t in est(TY, s2)]
        again = est(TY, s2)
        errs, of_scale, ok = estep_errors(torch, got, EK.cpd_estep_plain(X, TY, s2))
        run_k = lambda: est(TY, s2)
        run_p = lambda: EK.cpd_estep_plain(X, TY, s2)
        p1 = cuda_ms(torch, run_p, reps=3)
        k1 = cuda_ms(torch, run_k)
        k2 = cuda_ms(torch, run_k)
        p2 = cuda_ms(torch, run_p, reps=3)
        dense = cuda_ms(torch, lambda: cpd_ops._estep(X, TY, s2, 0.0), reps=3)
        kernel_ms = graph_ms(torch, run_k)
        den_ms = graph_ms(torch, lambda: est.den_pass(TY, s2))
        res = {"case": name, "M": M, "N": N, "D": D, "sigma2": sigma2,
               "max_abs_err": errs, "max_err_of_scale": of_scale, "within_tolerance": ok,
               "kernel_ms": kernel_ms, "den_pass_ms": den_ms,
               "row_pass_ms": kernel_ms - den_ms,
               "call_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               "dense_estep_ms": dense, **estep_bound(M, N, D)}
        if D > EK.REGISTER_MAX_D:
            res.update(grid=est.plan, first_version_ms=(first_ms or {}).get(name),
                       repeat_bit_equal=all(bool(torch.equal(a, b))
                                            for a, b in zip(got, again)))
            check(res["repeat_bit_equal"], f"E-step kernel does not repeat: {res}")
        check(ok, f"E-step kernel disagrees with its plain version: {res}")
        results.append(res)
    emit({"phase": phase, "cases": results,
          "tolerance": f"max |kernel - plain| <= {ESTEP_TOL_OF_SCALE} x max(1, max |plain|) "
                       "per output",
          "dense_estep_ms": "ops/cpd._estep, P [M, N] materialized: the E-step the "
                            "pipeline takes at or under 3000^2 pairs",
          "first_kernel_version_ms": first_ms or FIRST_ESTEP_KERNEL_MS,
          "grid": "per pass: splits = CTAs of a cluster splitting the other cloud, ctas, "
                  "warps_per_sm = the grid's warps over the SMs, blocks",
          "launches": "one E-step is two launches, the den pass and the row pass"})
    return results


def _wide_pair(torch, g, n, m, d, device):
    """X [n, d] spectral-like coordinates (N(0, 1/d) a column, |x| ~ 1) and
    TY [m, d]: X's points in another order (repeated past n), moved by N(0,
    0.02^2 / d), as late in EM."""
    X = torch.randn(n, d, generator=g) / d ** 0.5
    rows = torch.randperm(max(n, m), generator=g)[:m] % n
    TY = X[rows] + torch.randn(m, d, generator=g) * (0.02 / d ** 0.5)
    return X.to(device).contiguous(), TY.to(device).contiguous()


def wide_estep_cases(torch, sizes=(5000, 10242), widths=WIDE_ESTEP_D, device="cuda"):
    """E-step inputs for the kernel's tiled D > 16 instance, from a seed
    (``_wide_pair``, M = N = n) at sigma2 1e-2 (a late EM iteration: matched
    pairs at exp(-0.02), the nearest others within a few sigma) and, for the
    first size and width, at the initial sigma2 sum |x - ty|^2 / (D M N), as
    the first iteration sees it."""
    g = torch.Generator().manual_seed(7)
    cases = []
    for n in sizes:
        for d in widths:
            X, TY = _wide_pair(torch, g, n, n, d, device)
            cases.append((f"{n}_d{d}_late", X, TY, 1e-2))
            if n == sizes[0] and d == widths[0]:
                s2 = float(((X * X).sum() * n + (TY * TY).sum() * n
                            - 2 * (X.sum(0) * TY.sum(0)).sum()) / (d * n * n))
                cases.append((f"{n}_d{d}_initial", X, TY, s2))
    return cases


def wide_estep_edge_cases(torch, device="cuda"):
    """The tiled instance's edges on ``plan``'s grids, (name, X, TY,
    sigma2): clouds smaller than one rank's range or one 64-point tile,
    sizes no multiple of the tile or the CTA's 32 rows, splits of 2, 4 and
    8 ranks, and D = 17, 19, 20, 32, 33, 64, 65 and 130 (one, two and three
    64-dimension chunks, the PX slabs of blockIdx.z).  The card test
    ``tests/test_torch_cpd.py::test_cpd_estep_kernel_matches_plain_on_card``
    takes these cases too."""
    g = torch.Generator().manual_seed(17)
    shapes = [  # (N, M, D)
        (130, 5000, 33), (5000, 130, 17), (130, 2000, 33), (2000, 130, 17), (300, 257, 17),
        (5, 40, 19), (5, 40, 32), (40, 5, 19), (1000, 999, 64), (999, 1000, 64),
        (2000, 1999, 32), (1100, 1000, 33), (700, 650, 65), (500, 450, 130), (333, 1, 20),
        (1, 333, 20)]
    cases = []
    for n, m, d in shapes:
        X, TY = _wide_pair(torch, g, n, m, d, device)
        cases.append((f"n{n}_m{m}_d{d}", X, TY, 1e-2))
    return cases


def phase_cpd_loops(torch, cpd_ops, EK, runs):
    """The blocked EM loop (one iteration captured as a CUDA graph, replayed
    ``EM_BLOCK`` times between host reads) against the plain loop (a host
    read per iteration), on the inputs the pipeline gave
    ``_deformable_cpd_run``: iterations, sigma2, z and the moved cloud must
    be equal bit for bit. Per EM iteration: the blocked loop's fenced wall
    time (host), with and without its one-off capture; its device time as
    the sum of the kernels in a ``torch.profiler`` trace of one more run (a
    lower bound: gaps between a graph's kernels are not in it, and a trace
    can lose events) and as the span between CUDA events around another run
    less its capture; the E-step kernel's launches must lie in [2 it, 2 (it
    + K))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    K = cpd_ops.EM_BLOCK
    results = []
    for name, (args, kwargs) in runs:
        out = {}
        for loop in ("plain", "blocked"):
            EK.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = cpd_ops._deformable_cpd_run(*args, **dict(kwargs, loop=loop))
            torch.cuda.synchronize()
            out[loop] = (res, time.perf_counter() - t0, EK.LAUNCHES,
                         dict(cpd_ops.EM_STATS))
        (pTY, pz, ps2, pit), (bTY, bz, bs2, bit) = out["plain"][0], out["blocked"][0]
        equal = {"iterations": pit == bit, "sigma2": bool(torch.equal(ps2, bs2)),
                 "z": bool(torch.equal(pz, bz)), "TY": bool(torch.equal(pTY, bTY))}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cpd_ops._deformable_cpd_run(*args, **dict(kwargs, loop="blocked"))
            torch.cuda.synchronize()
        device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
        _, span_ms = cuda_ms_once(torch, lambda: cpd_ops._deformable_cpd_run(
            *args, **dict(kwargs, loop="blocked")))
        span_ms -= cpd_ops.EM_STATS["capture_ms"]  # the card waits while the host captures
        stats, wall_s, launches = out["blocked"][3], out["blocked"][1], out["blocked"][2]
        it = max(bit, 1)
        streamed = kwargs.get("estep_impl") == "streamed"
        r = {"case": name, "n_control": int(args[1].shape[0]),
             "estep_impl": kwargs.get("estep_impl", "dense"),
             "iterations": bit, "equal_to_plain": equal, "sigma2": float(bs2),
             "host_ms_per_iteration": wall_s * 1e3 / it,
             "host_ms_per_iteration_after_capture":
                 (wall_s * 1e3 - stats["capture_ms"]) / it,
             "device_ms_per_iteration": device_us / 1e3 / it,
             "device_span_ms_per_iteration": span_ms / it,
             "plain_host_ms_per_iteration": out["plain"][1] * 1e3 / max(pit, 1),
             "replay_ms_per_replay": stats["replay_ms"] / max(stats["replays"], 1),
             "estep_launches": launches if streamed else None, **stats}
        results.append(r)
        check(all(equal.values()), f"graph EM loop differs from the plain loop: {r}")
        check(stats["graph"] and stats["host_reads"] <= -(-bit // K) + 1,
              f"graph EM loop read the host too often: {r}")
        check(not streamed or 2 * bit <= launches < 2 * (bit + K),
              f"E-step launches {launches} outside [2 x {bit}, 2 x ({bit} + {K}))")
    emit({"phase": "cpd_loop_graph_vs_plain", "block": K, "cases": results})
    return results


def phase_cpd_run(torch, cpd_ops, X, Y, beta, alpha):
    """Eight EM iterations at full resolution on the card, streamed E-step
    (the kernel) against the dense one, from the same low-rank Gram."""
    g = torch.Generator().manual_seed(3)
    num_eig = 100
    omega = torch.randn(Y.shape[0], num_eig + 16, generator=g).to(Y.device)
    Q, lam = cpd_ops.low_rank_gaussian(Y, beta, num_eig, omega)
    runs = {}
    for impl in ("dense", "streamed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        TY, _, s2, it = cpd_ops._deformable_cpd_run(X, Y, Q, lam, alpha, 8, 0.0,
                                                    estep_impl=impl)
        torch.cuda.synchronize()
        runs[impl] = (TY, float(s2), it, time.perf_counter() - t0)
    ty_err = float((runs["streamed"][0] - runs["dense"][0]).abs().max())
    s2_err = abs(runs["streamed"][1] - runs["dense"][1])
    res = {"phase": "cpd_run_kernel_vs_dense", "M": Y.shape[0], "N": X.shape[0],
           "iterations": [runs[k][2] for k in runs],
           "TY_max_abs_err": ty_err, "sigma2_abs_err": s2_err,
           "sigma2": {k: runs[k][1] for k in runs},
           "seconds": {k: runs[k][3] for k in runs},
           "tolerance": {"TY": EM_TY_ATOL, "sigma2": EM_SIGMA2_ATOL}}
    emit(res)
    check(ty_err <= EM_TY_ATOL and s2_err <= EM_SIGMA2_ATOL,
          f"streamed EM disagrees with dense EM: {res}")
    return res


def _orthogonal(rng, det_sign):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.sign(np.linalg.det(q)) != det_sign:
        q[:, 2] *= -1
    return q


# The close kernel's cases: (name, singular values of the covariance, sign
# of its determinant, with_scale, rows of zero weight).
CLOSE_CASES = [
    ("rotation", (3.0, 2.0, 1.0), 1, False, False),
    ("reflection", (3.0, 2.0, 1.0), -1, False, False),
    ("near_equal", (2.0, 2.0 * (1 - 1e-4), 1.0), 1, False, False),
    ("rank2", (3.0, 2.0, 0.0), 1, False, False),
    ("similarity", (3.0, 2.0, 1.0), 1, True, False),
    ("similarity_reflection", (2.5, 1.5, 0.5), -1, True, False),
    ("weights", (3.0, 2.0, 1.0), 1, True, True),
]


def close_case_points(case, seed=0, n=500):
    """src, dst f32 [n, 3] and weights [n] (numpy seed) whose weighted
    cross-covariance has the case's singular values and determinant sign:
    src has identity covariance over the weighted rows and dst = src M^T
    + offset with M = U diag(sv) V^T; the rows of zero weight are noise."""
    _, sv, det_sign, _, weighted = case
    rng = np.random.default_rng(seed)
    w = np.ones(n)
    if weighted:
        w[rng.choice(n, n // 4, replace=False)] = 0.0
    keep = w > 0
    x = rng.normal(size=(int(keep.sum()), 3))
    x -= x.mean(0)
    q, _ = np.linalg.qr(x)
    src = np.zeros((n, 3))
    src[keep] = q * np.sqrt(keep.sum())
    src[~keep] = rng.normal(scale=30.0, size=(int((~keep).sum()), 3))
    M = _orthogonal(rng, 1) @ np.diag(sv) @ _orthogonal(rng, det_sign).T
    dst = src @ M.T + np.array([5.0, -3.0, 11.0])
    dst[~keep] = rng.normal(scale=30.0, size=(int((~keep).sum()), 3))
    src += np.array([-2.0, 7.0, 1.0])
    return src.astype(np.float32), dst.astype(np.float32), w.astype(np.float32)


def close_sweeps() -> int:
    """The close kernel's Jacobi sweeps, read from its source."""
    with open(os.path.join(ROOT, "pyfocusr_tpu_torch", "csrc", "umeyama3.cu")) as f:
        return int(re.search(r"constexpr int kSweeps = (\d+);", f.read()).group(1))


# (2^-53)^2: the close skips a rotation whose off-diagonal entry apq of
# cov^T cov has apq^2 <= this |app aqq| (kNegligible2 in csrc/umeyama3.cu).
CLOSE_NEGLIGIBLE2 = 2.0 ** -106


def close_emulated(cov, var_s, mu_s, mu_d, with_scale, sweeps):
    """The close kernel's steps (``close3`` in csrc/umeyama3.cu) in numpy
    float64 (``1 / sqrt`` for the card's ``rsqrt``, no FMA contraction),
    with at most ``sweeps`` Jacobi sweeps and the kernel's stop rule (a
    rotation skipped where its entry is negligible, the sweeps ended by one
    that rotated nothing): out f32 [13] = (s, R, t) and the rotations that
    ran."""
    A = np.asarray(cov, np.float64).reshape(3, 3)
    S, V = A.T @ A, np.eye(3)
    rotations = 0
    for _ in range(sweeps):
        ran = False
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = S[p, q]
            if apq == 0.0 or apq * apq <= CLOSE_NEGLIGIBLE2 * abs(S[p, p] * S[q, q]):
                continue
            rotations += 1
            ran = True
            r = 3 - p - q
            d = S[q, q] - S[p, p]
            h = 2.0 * apq
            hh = h * h
            root = np.sqrt(d * d + hh)
            ad = abs(d)
            den = ad + root
            g = 1.0 / np.sqrt(den * den + hh)
            sg = 1.0 if d >= 0.0 else -1.0
            c = den * g
            sn = sg * h * g
            tapq = sg * 0.5 * (root - ad)
            srp, srq = S[r, p], S[r, q]
            S[p, p] -= tapq
            S[q, q] += tapq
            S[p, q] = S[q, p] = 0.0
            S[r, p] = S[p, r] = c * srp - sn * srq
            S[r, q] = S[q, r] = sn * srp + c * srq
            vp, vq = V[:, p].copy(), V[:, q].copy()
            V[:, p], V[:, q] = c * vp - sn * vq, sn * vp + c * vq
        if not ran:
            break
    lam = np.diag(S).copy()
    for a, b in ((0, 1), (0, 2), (1, 2)):
        if lam[a] < lam[b]:
            lam[[a, b]] = lam[[b, a]]
            V[:, [a, b]] = V[:, [b, a]]
    v1, v2 = V[:, 0], V[:, 1]
    b1, b2 = A @ v1, A @ v2
    n1sq = b1 @ b1
    u1 = b1 * (1.0 / np.sqrt(n1sq)) if n1sq > 0 else v1
    b2 = b2 - (u1 @ b2) * u1
    n2sq = b2 @ b2
    if n2sq > 0 and n2sq > 1e-30 * n1sq:
        u2 = b2 * (1.0 / np.sqrt(n2sq))
    else:
        e = np.zeros(3)
        e[int(np.argmin(np.abs(u1)))] = 1.0
        u2 = np.cross(u1, e)
        u2 *= 1.0 / np.sqrt(u2 @ u2)
    R = np.outer(u1, v1) + np.outer(u2, v2) + np.outer(np.cross(u1, u2), np.cross(v1, v2))
    sc = float((R * A).sum()) / max(float(var_s), 1e-30) if with_scale else 1.0
    t = np.asarray(mu_d, np.float64) - sc * (R @ np.asarray(mu_s, np.float64))
    return np.concatenate([[sc], R.ravel(), t]).astype(np.float32), rotations


def close_chain(moments, with_scale, kernel_out):
    """What the close does on these moments: the rotations the kernel runs
    (``close_emulated`` under its cap), the fewest sweeps whose rounded
    result already equals the kernel's and the rotations they take, and
    whether the emulation gives the kernel's bits."""
    args = [x.detach().cpu().numpy() for x in moments]
    kernel_sweeps = close_sweeps()
    full, rotations_run = close_emulated(*args, with_scale, kernel_sweeps)
    for sweeps in range(kernel_sweeps + 1):
        out, rotations = close_emulated(*args, with_scale, sweeps)
        if np.array_equal(out, full):
            break
    return {"rotations_run": rotations_run, "sweeps_needed": sweeps, "rotations": rotations,
            "emulated_equals_kernel": bool(np.array_equal(
                full, kernel_out.detach().cpu().numpy()))}


def umeyama_bound(rotations: int, with_scale: bool = False):
    """Least time of the close, in ms: the longest path of dependent f64
    operations in one thread, each at its latency (F64_CLOCKS), operations
    that do not depend on each other side by side and a sum of many terms
    as a tree, for the rotations these moments need (``close_chain``'s
    ``rotations``: those of the fewest sweeps that give the kernel's
    rounded result).  First cov^T cov (three FMA-class steps).  A rotation
    waits on the entry the last one updated: h^2 and d^2 + h^2 (two), a
    square root, |d| + r and (|d| + r)^2 + h^2 (two), a reciprocal square
    root, c and s (one) and the entries the next rotation reads (two): a
    square root, a reciprocal square root and seven FMA-class steps (its
    negligibility test runs beside them).  Then the sort (three), B = cov V
    (three), u1 (a squared norm of three, a reciprocal square root, one
    product), u2 (the projection, three and one, its squared norm, three, a
    reciprocal square root, one), u1 x u2 (two), R (three) and t (three):
    twenty-nine FMA-class steps and two reciprocal square roots; with scale
    t's last step (one) waits on the trace, nine products summed as a tree
    (four), and a division: thirty-one and the division."""
    c = F64_CLOCKS
    rotation = c["sqrt"] + c["rsqrt"] + 7 * c["fma"]
    tail = 2 * c["rsqrt"] + (31 * c["fma"] + c["div"] if with_scale else 29 * c["fma"])
    cycles = rotations * rotation + tail
    return {"bound_ms": cycles / SM_CLOCK_HZ * 1e3, "bound_by": "operations",
            "chain_clocks": cycles}


def icp_step_emulated(target, idx, src, mask, wn, mu_s, var_s, state, ctrl, threshold,
                      max_iterations, with_scale, sweeps=None):
    """The ICP step kernel's arithmetic (``icp_step_kernel`` in
    csrc/umeyama3.cu) in numpy on numpy inputs, the arguments of
    ``umeyama_kernel.icp_step_plain``: ``state`` = (s, R, t, moved, delta)
    and ``ctrl`` = (count, flag).  The one-pass f64 sums, ``close_emulated``
    under the kernel's cap (or ``sweeps``), the moved rows in f64 rounded
    once, the masked motion in f64 and the flag.  Returns (new state, new
    ctrl, the close's rotations); on a set flag the state and ctrl as given,
    and 0."""
    s, R, t, moved, delta = (np.asarray(x, np.float32) for x in state)
    count, done = (int(x) for x in ctrl)
    if done:
        return (s, R, t, moved, delta), (count, done), 0
    f64 = np.float64
    m = np.asarray(target, f64)[np.asarray(idx).reshape(-1)]
    w = np.asarray(wn, f64)
    x = np.asarray(src, f64)
    ms = np.asarray(mu_s, f64)
    sc = x - ms
    wm = m * w[:, None]
    mu_d = wm.sum(axis=0)
    cov = wm.T @ sc - np.outer(mu_d, (sc * w[:, None]).sum(axis=0))
    out, rotations = close_emulated(cov, float(var_s), ms, mu_d, with_scale,
                                    close_sweeps() if sweeps is None else sweeps)
    new_s, new_R, new_t = out[0], out[1:10].reshape(3, 3), out[10:13]
    with np.errstate(over="ignore", invalid="ignore"):
        new_moved = ((x @ new_R.astype(f64).T) * f64(new_s) + new_t.astype(f64)).astype(np.float32)
        step = np.sqrt(((new_moved.astype(f64) - moved.astype(f64)) ** 2).sum(axis=1))
        motion = np.where(np.asarray(mask) > 0, step * w, 0.0).sum()
    new_delta = np.float32(motion)
    count += 1
    done = int(not (new_delta > np.float32(threshold)) or count >= max_iterations)
    return (new_s, new_R, new_t, new_moved, new_delta), (count, done), rotations


def phase_umeyama(torch, icp_ops, UK, icp_call, class_source=None):
    """The close kernel against ``umeyama_close_plain`` (``torch.linalg.svd``
    and ``det`` in f64 on the card, rounded once to f32) on the moments of
    CLOSE_CASES and of the 'kd' pair's first ICP iteration: R within
    CLOSE_R_ATOL, s within CLOSE_S_RTOL, t within CLOSE_T_OF_SCALE of the
    coordinates' scale, and ``close_emulated`` giving the kernel's bits.
    Times: the kernel's device time from a CUDA graph of 20 calls, the plain
    close and ``torch.linalg.svd`` alone between CUDA events; the bound from
    the rotations these moments need (``close_chain``).  Then the ICP step
    (``phase_icp_step``).  Returns (close results, step results)."""
    dev = "cuda"
    inputs = []
    for case in CLOSE_CASES:
        src, dst, w = close_case_points(case)
        inputs.append((case[0], torch.tensor(src, device=dev), torch.tensor(dst, device=dev),
                       torch.tensor(w, device=dev), case[3]))
    (src, tgt), kw = icp_call
    idx = first_icp_matches(torch, src, tgt)
    for with_scale in (False, True):
        inputs.append((f"kd_icp_first_iteration_scale_{with_scale}", src, tgt[idx],
                       torch.ones(src.shape[0], device=dev), with_scale))
    results = []
    for name, src, dst, w, with_scale in inputs:
        moments = icp_ops._moments(src, dst, w / w.sum())
        ks, kR, kt = UK.umeyama_close_cuda(*moments, with_scale)
        ps, pR, pt = UK.umeyama_close_plain(*moments, with_scale)
        torch.cuda.synchronize()
        scale = float(dst[w > 0].abs().max())
        errs = {"R": float((kR - pR).abs().max()),
                "s_rel": abs(float(ks - ps)) / abs(float(ps)),
                "t_of_scale": float((kt - pt).abs().max()) / scale}
        out = torch.empty(13, device=dev)
        chain = close_chain(moments, with_scale, torch.cat([ks.view(1), kR.flatten(), kt]))
        res = {"case": name, "with_scale": with_scale, "max_abs_err": errs,
               "det_cov": float(torch.linalg.det(moments[0].double())),
               "kernel_ms": graph_ms(torch, lambda: UK.umeyama_close_cuda(
                   *moments, with_scale, out=out)),
               "plain_ms": cuda_ms(torch, lambda: UK.umeyama_close_plain(*moments, with_scale)),
               "svd_ms": cuda_ms(torch, lambda: torch.linalg.svd(moments[0])),
               "sweeps": close_sweeps(), **chain,
               **umeyama_bound(chain["rotations"], with_scale)}
        check(errs["R"] <= CLOSE_R_ATOL and errs["s_rel"] <= CLOSE_S_RTOL
              and errs["t_of_scale"] <= CLOSE_T_OF_SCALE and chain["emulated_equals_kernel"],
              f"Umeyama close kernel disagrees with its plain version or its emulation: {res}")
        results.append(res)
    emit({"phase": "umeyama_kernel_vs_plain", "cases": results,
          "tolerance": {"R": CLOSE_R_ATOL, "s_rel": CLOSE_S_RTOL, "t_of_scale": CLOSE_T_OF_SCALE},
          "svd_ms": "torch.linalg.svd of the 3x3 covariance alone (the plain close also "
                    "takes two det and the products)"})
    return results, phase_icp_step(torch, icp_ops, UK, icp_call, class_source)


# The ICP step kernel against its plain version (the same inputs): s, R, t
# within the close's limits above (the step's close is the close kernel's on
# f64 moments summed in another order: the f32 results differ at most at a
# rounding boundary); the moved rows, which both compute in f64 from the
# same rounded s, R, t and round once, within CLOSE_T_OF_SCALE of the
# coordinates' scale; the mean motion, an f64 sum rounded once, within
# STEP_DELTA_RTOL; the count and the flag equal.
STEP_DELTA_RTOL = 1e-6
# Sentinel rows of the sentinel case: target rows at the sentinel the k-NN
# never matches, and source rows the mask drops, at 1e30 (their steps are
# ~1e30 or inf and must add exactly 0).
STEP_SENTINEL = 1e30


def icp_step_inputs(torch, icp_ops, src, tgt, mask, with_scale, idx=None, ctrl=(0, 0)):
    """The arguments of ``umeyama_kernel.icp_step`` for ICP's first
    iteration of src [n, 3] onto tgt [M, 3] under ``mask`` [n]: ICP's start
    (``icp._start``), the matches of ``knn_plain`` from the moved source
    where ``idx`` is None, the state (1, I, t0, moved, inf), ``ctrl``,
    max_iterations 100.  A dict of keyword arguments on src's device."""
    from pyfocusr_tpu_torch.ops import knn_kernel

    wn, mu_s, var_s, threshold, t0, moved = icp_ops._start(src, tgt, mask)
    if idx is None:
        idx = knn_kernel.knn_plain(tgt, moved.contiguous(), 1)[1]
    dev = src.device
    state = (torch.ones((), device=dev), torch.eye(3, device=dev), t0.clone(),
             moved.contiguous(), torch.tensor(float("inf"), device=dev))
    return dict(target=tgt.contiguous(), idx=idx.to(torch.int32).reshape(-1, 1).contiguous(),
                src=src.contiguous(), mask=mask.contiguous(), wn=wn, mu_s=mu_s, var_s=var_s,
                state=state, ctrl=torch.tensor(ctrl, dtype=torch.int32, device=dev),
                threshold=threshold, max_iterations=100, with_scale=with_scale)


def icp_step_case_inputs(torch, icp_ops, icp_call, class_source=None, device="cuda"):
    """(name, arguments) of the step cases: each of CLOSE_CASES (its dst as
    the target, rows matched to themselves, its weights as the mask), the
    'kd' pair's first ICP iteration rigid and similarity, the same with the
    flag already set (count 3), a sentinel case (64 target rows at
    STEP_SENTINEL, a tenth of the source rows at it and dropped by the
    mask) and, where ``class_source`` is given, all its rows against the
    target (the class defaults' ICP shape)."""
    cases = []
    for case in CLOSE_CASES:
        src, dst, w = (torch.tensor(x, device=device) for x in close_case_points(case))
        idx = torch.arange(src.shape[0], device=device)
        cases.append((case[0], icp_step_inputs(torch, icp_ops, src, dst, w, case[3], idx=idx)))
    (src, tgt), _ = icp_call
    src, tgt = src.to(device), tgt.to(device)
    ones = torch.ones(src.shape[0], device=device)
    for with_scale in (False, True):
        cases.append((f"kd_first_iteration_scale_{with_scale}",
                      icp_step_inputs(torch, icp_ops, src, tgt, ones, with_scale)))
    cases.append(("flag_set", icp_step_inputs(torch, icp_ops, src, tgt, ones, False,
                                              ctrl=(3, 1))))
    rng = np.random.default_rng(7)
    drop = torch.tensor(rng.choice(src.shape[0], src.shape[0] // 10, replace=False),
                        device=device)
    s_src, s_mask = src.clone(), ones.clone()
    s_src[drop] = STEP_SENTINEL
    s_mask[drop] = 0.0
    s_tgt = torch.cat([tgt, torch.full((64, 3), STEP_SENTINEL, device=device)])
    cases.append(("sentinel_rows", icp_step_inputs(torch, icp_ops, s_src, s_tgt, s_mask, False)))
    if class_source is not None:
        cs_src = class_source.to(device)
        cases.append(("class_defaults_all_points", icp_step_inputs(
            torch, icp_ops, cs_src, tgt, torch.ones(cs_src.shape[0], device=device), False)))
    return cases


def clone_step_args(a):
    """The step's arguments with fresh copies of the state and ctrl."""
    return dict(a, state=tuple(x.clone() for x in a["state"]), ctrl=a["ctrl"].clone())


def step_errors(got, want, ctrl_got, ctrl_want, scale):
    """The step's outputs against another's: s relative, R absolute, t over
    ``scale``, moved over the larger of ``scale`` and its own magnitude (rows
    the mask drops may sit at the sentinel), delta relative, and whether
    count and flag are equal."""
    (gs, gR, gt, gm, gd), (ws, wR, wt, wm, wd) = (
        [np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float64)
         for x in xs] for xs in (got, want))
    rel = lambda a, b: float(abs(a - b) / max(abs(b), 1e-30)) if np.isfinite(b) else (
        0.0 if a == b else float("inf"))
    return {"s_rel": rel(float(gs), float(ws)), "R": float(np.abs(gR - wR).max()),
            "t_of_scale": float(np.abs(gt - wt).max()) / scale,
            "moved_of_scale": float((np.abs(gm - wm) / np.maximum(scale, np.abs(wm))).max()),
            "delta_rel": rel(float(gd), float(wd)),
            "ctrl_equal": [int(x) for x in ctrl_got] == [int(x) for x in ctrl_want]}


def step_within(errs):
    return (errs["R"] <= CLOSE_R_ATOL and errs["s_rel"] <= CLOSE_S_RTOL
            and errs["t_of_scale"] <= CLOSE_T_OF_SCALE
            and errs["moved_of_scale"] <= CLOSE_T_OF_SCALE
            and errs["delta_rel"] <= STEP_DELTA_RTOL and errs["ctrl_equal"])


def step_emulation(a, sweeps=None):
    """``icp_step_emulated`` on a case's arguments (moved to the host)."""
    host = lambda x: x.detach().cpu().numpy()
    return icp_step_emulated(
        host(a["target"]), host(a["idx"]), host(a["src"]), host(a["mask"]), host(a["wn"]),
        host(a["mu_s"]), float(a["var_s"]), [host(x) for x in a["state"]],
        host(a["ctrl"]), float(a["threshold"]), a["max_iterations"], a["with_scale"], sweeps)


def step_rotations_needed(a, full):
    """The rotations of the fewest sweeps whose emulated step equals
    ``full`` (``step_emulation`` under the kernel's cap) in every output."""
    for sweeps in range(close_sweeps() + 1):
        state, ctrl, rotations = step_emulation(a, sweeps)
        if tuple(ctrl) == tuple(full[1]) and all(
                np.array_equal(x, y, equal_nan=True) for x, y in zip(state, full[0])):
            return rotations
    return full[2]


def step_bound(rotations, with_scale, n):
    """The step's least time: the close's chain (``umeyama_bound``, for the
    rotations of ``step_rotations_needed``) plus the
    bytes it must move once over HBM_BYTES_PER_S: per row its index (4),
    its matched target row (12), its source row (12), mask and weight (8),
    the moved row read and written (24)."""
    chain = umeyama_bound(rotations, with_scale)
    bytes_ms = 60 * n / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": chain["bound_ms"] + bytes_ms, "bound_by": "operations",
            "chain_ms": chain["bound_ms"], "bytes_ms": bytes_ms,
            "chain_clocks": chain["chain_clocks"]}


def replaced_step_sequence(torch, icp_ops, UK, a):
    """The torch sequence an ICP iteration ran after its k-NN before the step
    kernel (the parent's ``ops/icp.py`` iterate and masked step less the
    k-NN): the gather, ``_cross_moments`` in f32, the close kernel,
    ``apply_rigid``, the masked motion, five where / copy pairs and the
    count and flag updates, on the case's state.  Returns a function that
    runs it once (capturable)."""
    s, R, t, moved, delta = a["state"]
    ctrl, src, wn, mask = a["ctrl"], a["src"], a["wn"], a["mask"]
    sc = src - a["mu_s"]
    close_out = torch.empty(13, device=src.device)
    state = a["state"]

    def run():
        done = ctrl[1] != 0
        matched = a["target"].index_select(0, a["idx"][:, 0])
        cov, mu_d = icp_ops._cross_moments(matched, wn, sc)
        ns, nR, nt = UK.umeyama_close_cuda(cov, a["var_s"], a["mu_s"], mu_d, a["with_scale"],
                                           out=close_out)
        new_moved = icp_ops.apply_rigid(src, ns, nR, nt)
        step = torch.linalg.norm(new_moved - moved, dim=1)
        d = (torch.where(mask > 0, step, torch.zeros_like(step)) * wn).sum()
        for old, new in zip(state, (ns, nR, nt, new_moved, d)):
            old.copy_(torch.where(done, old, new))
        ctrl[:1].add_((~done).to(torch.int32))
        ctrl[1:].copy_(((~(delta > a["threshold"])) | (ctrl[0] >= a["max_iterations"]))
                       .to(torch.int32).reshape(1))
    return run


def phase_icp_step(torch, icp_ops, UK, icp_call, class_source=None):
    """``icp_step_cuda`` against ``icp_step_plain`` on the card, the same
    inputs, in every case of ``icp_step_case_inputs``, within the limits
    above (the set flag: every state buffer and ctrl bit for bit as given);
    ``icp_step_emulated`` against the kernel likewise.  Times, where the
    flag is clear: the step's device time from a CUDA graph of 20 calls
    (threshold -1, so the flag stays clear) beside the torch sequence it
    replaced (``replaced_step_sequence``, also from a graph), the plain step
    between CUDA events, and the bound (``step_bound``); the cluster the
    plan took.  The class-defaults case also runs at every cluster size
    (1-16 CTAs, the plan forced), each held to the plain step."""
    results = []
    for name, a in icp_step_case_inputs(torch, icp_ops, icp_call, class_source):
        k, p = clone_step_args(a), clone_step_args(a)
        UK.icp_step_cuda(**k)
        UK.icp_step_plain(**p)
        torch.cuda.synchronize()
        n = a["src"].shape[0]
        scale = float(a["target"][a["target"].abs().max(dim=1).values < 1e29].abs().max())
        errs = step_errors(k["state"], p["state"], k["ctrl"].tolist(), p["ctrl"].tolist(), scale)
        emulated = step_emulation(a)
        (es, eR, et, em, ed), ectrl, rotations = emulated
        emu = step_errors(k["state"], (es, eR, et, em, ed), k["ctrl"].tolist(), ectrl, scale)
        res = {"case": name, "n_source": n, "n_target": int(a["target"].shape[0]),
               "with_scale": a["with_scale"], "ctas": UK.plan(n)["ctas"],
               "err_vs_plain": errs, "err_vs_emulation": emu,
               "emulated_close_equals_kernel": bool(
                   np.array_equal(es, k["state"][0].cpu().numpy())
                   and np.array_equal(eR, k["state"][1].cpu().numpy())
                   and np.array_equal(et, k["state"][2].cpu().numpy())),
               "rotations_run": rotations, "ctrl": k["ctrl"].tolist()}
        if name == "flag_set":
            unchanged = all(torch.equal(x, y) for x, y in zip(k["state"] + (k["ctrl"],),
                                                               a["state"] + (a["ctrl"],)))
            plain_unchanged = all(torch.equal(x, y) for x, y in zip(
                p["state"] + (p["ctrl"],), a["state"] + (a["ctrl"],)))
            res["unchanged"] = {"kernel": unchanged, "plain": plain_unchanged}
            check(unchanged and plain_unchanged, f"the step wrote on a set flag: {res}")
        else:
            check(step_within(errs) and step_within(emu),
                  f"ICP step kernel disagrees with its plain version or its emulation: {res}")
            needed = step_rotations_needed(a, emulated)
            timed = clone_step_args(a)
            timed.update(threshold=torch.tensor(-1.0, device="cuda"), max_iterations=2 ** 30)
            old = clone_step_args(timed)
            if name == "class_defaults_all_points":  # every cluster size
                res["within_by_ctas"] = {}
                real_plan = UK.plan
                try:
                    for ctas in (1, 2, 4, 8, UK.MAX_CTAS):
                        UK.plan = lambda n, c=ctas: {**real_plan(n), "ctas": c}
                        kc = clone_step_args(a)
                        UK.icp_step_cuda(**kc)
                        res["within_by_ctas"][ctas] = step_within(step_errors(
                            kc["state"], p["state"], kc["ctrl"].tolist(), p["ctrl"].tolist(),
                            scale))
                finally:
                    UK.plan = real_plan
                check(all(res["within_by_ctas"].values()),
                      f"the ICP step disagrees with its plain version at some cluster size: {res}")
            res.update(kernel_ms=graph_ms(torch, lambda: UK.icp_step_cuda(**timed)),
                       replaced_sequence_ms=graph_ms(
                           torch, replaced_step_sequence(torch, icp_ops, UK, old)),
                       plain_ms=cuda_ms(torch, lambda: UK.icp_step_plain(**clone_step_args(a))),
                       rotations_needed=needed, **step_bound(needed, a["with_scale"], n))
        results.append(res)
    emit({"phase": "icp_step_kernel_vs_plain", "cases": results,
          "tolerance": {"R": CLOSE_R_ATOL, "s_rel": CLOSE_S_RTOL, "t_of_scale": CLOSE_T_OF_SCALE,
                        "moved_of_scale": CLOSE_T_OF_SCALE, "delta_rel": STEP_DELTA_RTOL},
          "replaced_sequence_ms": "the parent's torch work after the k-NN of one ICP "
                                  "iteration, the close kernel included, from a CUDA graph"})
    return results


def first_icp_matches(torch, src, tgt):
    """Nearest target row of each source row after ICP's centroid match:
    the matches of the first ICP iteration (plain version)."""
    from pyfocusr_tpu_torch.ops import knn_kernel

    moved = src + (tgt.mean(0) - src.mean(0))
    return knn_kernel.knn_plain(tgt, moved.contiguous(), 1)[1][:, 0].long()


class IcpRecorder:
    """Records the arguments of the pipeline's ICP call while installed (the
    pipeline calls it through the module attribute ``icp_fit``)."""

    def __init__(self, pipeline):
        self.mod = pipeline
        self.real = pipeline.icp_fit
        self.last_call = None

    def __enter__(self):
        def recorded(*args, **kwargs):
            self.last_call = (args, kwargs)
            return self.real(*args, **kwargs)

        self.mod.icp_fit = recorded
        return self

    def __exit__(self, *exc):
        self.mod.icp_fit = self.real


def phase_icp_loop(torch, icp_ops, KK, UK, icp_call):
    """The blocked ICP loop (one iteration captured as a CUDA graph, replayed
    ``ICP_BLOCK`` times between host reads) against the plain loop (a host
    read per iteration), both with the kernels, on the 'kd' pair's ICP
    inputs, rigid as the pipeline calls it and in similarity mode:
    iterations, s, R, t and the moved cloud equal bit for bit; host reads
    <= ceil(it / K) + 1; k-NN and close launches in [it, it + K).  Per
    iteration: the blocked loop's fenced wall time (host), with and without
    its capture; its device time as the sum of the kernels in a
    ``torch.profiler`` trace of one more run (a lower bound: gaps between a
    graph's kernels are not in it) and as the span between CUDA events
    around another run less its capture; the plain loop's host time.  The
    trace's kernels by name: each replay runs the k-NN and the step and
    nothing else (no other device work as often as there are replays)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    K = icp_ops.ICP_BLOCK
    args, kwargs = icp_call
    results = []
    for name, kw in (("kd_rigid", kwargs), ("kd_similarity", dict(kwargs, mode="similarity"))):
        out = {}
        for loop in ("plain", "blocked"):
            KK.LAUNCHES = UK.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = icp_ops.icp(*args, **dict(kw, loop=loop, return_iterations=True))
            torch.cuda.synchronize()
            out[loop] = (res, time.perf_counter() - t0, (KK.LAUNCHES, UK.LAUNCHES),
                         dict(icp_ops.ICP_STATS))
        ((ps, pR, pt), pm, pit), ((bs, bR, bt), bm, bit) = out["plain"][0], out["blocked"][0]
        equal = {"iterations": pit == bit, "s": bool(torch.equal(ps, bs)),
                 "R": bool(torch.equal(pR, bR)), "t": bool(torch.equal(pt, bt)),
                 "moved": bool(torch.equal(pm, bm))}
        run = lambda: icp_ops.icp(*args, **dict(kw, loop="blocked"))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        cuda_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        device_us = sum(e.time_range.elapsed_us() for e in cuda_events)
        names = collections.Counter(e.name for e in cuda_events)
        loop_names = [n for n in names if "knn_kernel" in n or "icp_step_kernel" in n]
        _, span_ms = cuda_ms_once(torch, run)
        span_ms -= icp_ops.ICP_STATS["capture_ms"]  # the card waits while the host captures
        stats, wall_s, (knn_n, close_n) = out["blocked"][3], out["blocked"][1], out["blocked"][2]
        it = max(bit, 1)
        r = {"case": name, "mode": kw.get("mode", "rigid"), "n_source": int(args[0].shape[0]),
             "n_target": int(args[1].shape[0]), "iterations": bit, "equal_to_plain": equal,
             "host_ms_per_iteration": wall_s * 1e3 / it,
             "host_ms_per_iteration_after_capture": (wall_s * 1e3 - stats["capture_ms"]) / it,
             "device_ms_per_iteration": device_us / 1e3 / it,
             "device_span_ms_per_iteration": span_ms / it,
             "plain_host_ms_per_iteration": out["plain"][1] * 1e3 / max(pit, 1),
             "replay_ms_per_replay": stats["replay_ms"] / max(stats["replays"], 1),
             "knn_launches": knn_n, "close_launches": close_n,
             "plain_knn_launches": out["plain"][2][0],
             # Device work of the profiled blocked run by name: the loop's
             # two kernels, and the most any other ran (the start's
             # operations and copies, a few each).
             "loop_kernels": {n: names[n] for n in loop_names},
             "most_other_kernel": max(((n, c) for n, c in names.items() if n not in loop_names),
                                      key=lambda nc: nc[1], default=(None, 0)),
             **stats}
        results.append(r)
        check(all(equal.values()), f"graph ICP loop differs from the plain loop: {r}")
        check(stats["graph"] and stats["host_reads"] <= -(-bit // K) + 1,
              f"graph ICP loop read the host too often: {r}")
        check(bit <= knn_n < bit + K and bit <= close_n < bit + K
              and out["plain"][2] == (pit, pit),
              f"ICP launches outside [{bit}, {bit} + {K}): {r}")
        # Each replay runs the k-NN and the step only: each of the two ran at
        # least once a replay, and no other device work as often (read where
        # the replays, 2 K or more, outnumber the start's few launches).
        replays = stats["replays"]
        check(len(loop_names) == 2 and min(names[n] for n in loop_names) >= replays
              and (replays < 2 * K or r["most_other_kernel"][1] < replays),
              f"the captured ICP iteration holds more than the k-NN and the step: {r}")
    emit({"phase": "icp_loop_graph_vs_plain", "block": K, "cases": results})
    return results


def warm_summary(first_s, warm):
    """First call, the warm calls, their median and spread, and the warm
    calls slower than the first."""
    return {"first_call_s": first_s, "warm_s": statistics.median(warm),
            "warm_s_all": warm, "warm_s_spread": max(warm) - min(warm),
            "warm_slower_than_first": [w for w in warm if w > first_s]}


def quality_and_checks(tp, target_mesh, source_mesh, res, n_s, min_unique=0.6):
    import torch

    corr = res["correspondences"]
    check(tuple(corr.shape) == (n_s,) and corr.dtype == torch.int64,
          "correspondences shape/dtype")
    for key in ("weighted_points", "nearest_points", "average_points"):
        check(tuple(res[key].shape) == (n_s, 3), f"{key} shape")
        check(bool(res[key].isfinite().all()), f"{key} finite")
    tgt = np.asarray(target_mesh.points, np.float32)
    check(np.array_equal(res["nearest_points"].cpu().numpy(), tgt[corr.cpu().numpy()]),
          "nearest_points are the corresponding target vertices")
    q = tp.registration_quality(target_mesh, source_mesh, res)
    if min_unique is not None:
        check(q["unique_fraction"] > min_unique, f"unique fraction {q['unique_fraction']}")
    return q


def compare_runs(gpu, cpu):
    out = {}
    worst_cos = 1.0
    worst_rel = 0.0
    for side, vec_key in (("target", "eig_vecs_target"),
                          ("source", "eig_vecs_source_sorted")):
        lg = gpu[f"eig_vals_{side}"].double().cpu().numpy()
        lc = cpu[f"eig_vals_{side}"].double().numpy()
        worst_rel = max(worst_rel, float(np.max(np.abs(lg - lc) / np.abs(lc))))
        vg = gpu[vec_key].double().cpu().numpy()
        vc = cpu[vec_key].double().numpy()
        vg = vg - vg.mean(0)
        vc = vc - vc.mean(0)
        vg /= np.linalg.norm(vg, axis=0)
        vc /= np.linalg.norm(vc, axis=0)
        # Group near-degenerate eigenvalues: compare their subspaces (the
        # smallest singular value of the cross-Gram of orthonormal bases of
        # each, the cosine of the largest principal angle), single modes by
        # |cos|.  Centred eigenvectors are no longer orthogonal, so each
        # group's columns are orthonormalised first: unorthogonalised, two
        # identical groups whose centred columns meet at cos c read 1 - |c|.
        groups, cur = [], [0]
        for c in range(1, len(lc)):
            if (lc[c] - lc[c - 1]) / lc[c] < DEGENERATE_GAP:
                cur.append(c)
            else:
                groups.append(cur)
                cur = [c]
        groups.append(cur)
        for grp in groups:
            qc, qg = np.linalg.qr(vc[:, grp])[0], np.linalg.qr(vg[:, grp])[0]
            sv = np.linalg.svd(qc.T @ qg, compute_uv=False)
            worst_cos = min(worst_cos, float(sv.min()))
        out[f"groups_{side}"] = groups
    cg = gpu["correspondences"].cpu().numpy()
    cc = cpu["correspondences"].numpy()
    n = len(cc)
    out.update(
        eigval_max_rel_diff=worst_rel,
        eigvec_min_abs_cos=worst_cos,
        correspondence_agreement=float((cg == cc).mean()),
        initial_correspondence_agreement=float(
            (gpu["initial_correspondences"].cpu().numpy()
             == cpu["initial_correspondences"].numpy()).mean()),
        unique_fraction_gpu=len(np.unique(cg)) / n,
        unique_fraction_cpu=len(np.unique(cc)) / n,
        weighted_points_mean_diff_mm=float(np.linalg.norm(
            gpu["weighted_points"].cpu().numpy()
            - cpu["weighted_points"].numpy(), axis=1).mean()),
    )
    return out


def agreement_checks(agree, what):
    """The 'kd' CUDA-vs-CPU gates on a ``compare_runs`` result."""
    check(agree["eigval_max_rel_diff"] <= EIGVAL_RTOL, f"eigenvalues {what}")
    check(agree["eigvec_min_abs_cos"] >= COS_MIN, f"eigenvectors {what}")
    check(agree["correspondence_agreement"] >= CORR_AGREE_MIN,
          f"final correspondences {what}")
    check(abs(agree["unique_fraction_gpu"] - agree["unique_fraction_cpu"])
          <= UNIQUE_DIFF_MAX, f"unique fraction {what}")


def to_cpu(res):
    return {k: v.cpu() for k, v in res.items()}


# The result keys with one row per target vertex; every other key with rows
# has one per source vertex ("Q" and the eigenvalues have none).
TARGET_ROW_KEYS = ("eig_vecs_target", "spectral_coords_target", "smoothed_target_coords")


def real_rows(res, n_t: int, n_s: int):
    """A registration result of padded graphs cut to the first ``n_t``
    target and ``n_s`` source rows (the real vertices)."""
    out = {}
    for k, v in res.items():
        if k == "Q" or k.startswith("eig_vals"):
            out[k] = v
        else:
            out[k] = v[:n_t] if k in TARGET_ROW_KEYS else v[:n_s]
    return out


def outputs_differ(torch, a, b):
    """The output keys whose tensors are not equal bit for bit, each with
    its largest absolute difference."""
    out = {}
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if not torch.equal(x, y):
            out[k] = float((x.double() - y.double()).abs().max())
    return out


def timed(torch, fn, device="cuda"):
    """(fn(), its wall seconds, fenced on ``device``)."""
    sync(torch, device)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, device)
    return out, time.perf_counter() - t0


def phase_serving(torch, tp, kernels, cfg, meshes, graphs, smi, device="cuda"):
    """One prepared target (seed 2) serving the sources of ``SERVED_SEEDS``
    through ``register_pair_prepared``, each with ``make_draws(0, ...)``,
    beside the plain ``register_pair`` of the same pairs.  Gates: the seed-1
    served pair equals the plain call bit for bit when two plain calls do
    (else the CUDA-vs-CPU gates); launches equal the plain pair's; the same
    prepared pair at 2562 vertices on the card against the CPU.  Returns
    the prepared state, whether two plain calls gave equal bits, and the
    first served pair's launches."""
    from pyfocusr_tpu_torch.ops import cpd as cpd_ops
    from pyfocusr_tpu_torch.ops import icp as icp_ops

    t_phase = time.perf_counter()
    tg, n_t = graphs[2], graphs[2].n_points
    draws = {seed: tp.make_draws(0, cfg, n_t, graphs[seed].n_points)
             for seed in SERVED_SEEDS}
    plain_a = tp.register_pair(tg, graphs[1], cfg, draws=draws[1])
    plain_b = tp.register_pair(tg, graphs[1], cfg, draws=draws[1])
    plain_diff = outputs_differ(torch, plain_a, plain_b)
    deterministic = not plain_diff
    prep, prepare_s = timed(torch, lambda: tp.prepare_target(
        tg, cfg, draws[1]["eig_block_target"]))
    served, plain = [], []
    for seed in SERVED_SEEDS:
        for rows, call in ((served, tp.register_pair_prepared),
                           (plain, tp.register_pair)):
            args = (prep,) if call is tp.register_pair_prepared else ()
            for mod in kernels.values():
                mod.LAUNCHES = 0
            res, secs = timed(torch, lambda: call(*args, tg, graphs[seed], cfg,
                                                  draws=draws[seed]))
            rows.append({"seed": seed, "s": secs,
                         "launches": {k: m.LAUNCHES for k, m in kernels.items()},
                         "icp_iterations": icp_ops.ICP_STATS["iterations"],
                         "cpd_iterations": cpd_ops.EM_STATS["iterations"]})
            if call is tp.register_pair_prepared:
                rows[-1]["quality"] = quality_and_checks(
                    tp, meshes[2], meshes[seed], res, graphs[seed].n_points)
                if seed == 1:
                    served_1 = res
    vs_plain = {"differing_keys": outputs_differ(torch, plain_a, served_1),
                **compare_runs(plain_a, to_cpu(served_1))}

    # The same prepared pair at 2562 vertices on the card and on the CPU.
    small = {seed: synthetic_bone(tp, seed, levels=CPU_CHECK_LEVELS) for seed in (1, 2)}
    small_g = {seed: tp.mesh_to_graph_arrays(m, device="cpu") for seed, m in small.items()}
    sd = tp.pipeline.host_draws(tp.make_draws(0, cfg, small[2].n_points, small[1].n_points))

    def serve_small(dev):
        t, s_ = small_g[2].to(dev), small_g[1].to(dev)
        pre = tp.prepare_target(t, cfg, sd["eig_block_target"])
        return tp.register_pair_prepared(pre, t, s_, cfg, draws=sd)

    res_gpu = serve_small(device)
    t0 = time.perf_counter()
    res_cpu = serve_small("cpu")
    cpu_s = time.perf_counter() - t0
    vs_cpu = compare_runs(res_gpu, res_cpu)
    emit({
        "phase": "serving_prepared_target", "nvidia_smi": smi,
        "n_target": n_t, "config": "bench.py:122-134", "target_seed": 2,
        "prepare_s": prepare_s,
        "served_s": [r["s"] for r in served],
        "served": served,
        **{f"served_{k}": v for k, v in warm_summary(
            served[0]["s"], [r["s"] for r in served[1:]]).items()},
        "served_median_s": statistics.median(r["s"] for r in served),
        "plain_s": [r["s"] for r in plain],
        "plain_median_s": statistics.median(r["s"] for r in plain),
        "plain_launches": [r["launches"] for r in plain],
        "two_plain_calls_equal_bits": deterministic,
        "two_plain_calls_differ": plain_diff,
        "served_vs_plain_gate": "bit for bit" if deterministic else "CUDA-vs-CPU gates",
        "served_vs_plain": vs_plain,
        "cpu_check_n": small[2].n_points,
        "why_2562": "a 10242 CPU registration costs about as much as this phase",
        "cpu_s": cpu_s, "served_cuda_vs_cpu": vs_cpu,
        "phase_s": time.perf_counter() - t_phase,
    })
    for a, b in zip(served, plain):
        check(a["launches"] == b["launches"] and a["launches"]["knn"] > 0
              and a["launches"]["umeyama3"] > 0,
              f"served pair {a['seed']} launched {a['launches']}, the plain "
              f"pair {b['launches']}")
    what = "served pair vs register_pair on the card"
    if deterministic:
        check(not vs_plain["differing_keys"],
              f"{what}: not equal bit for bit: {vs_plain['differing_keys']}")
    else:
        agreement_checks(vs_plain, what)
    agreement_checks(vs_cpu, "served pair CUDA vs CPU (2562)")
    return prep, deterministic, served[0]["launches"]


def phase_class_template(torch, tp, cfg, prep, meshes, graphs, smi, deterministic,
                         device="cuda"):
    """A never-seen pair (target seed 3, source seed 4) registered cold, and
    from the seed-2 class template's block, in memory and through a save /
    load round trip reloaded on the card.  Gates: quality within
    ``UNIQUE_DIFF_MAX`` and eigenvalues within ``EIGVAL_RTOL`` of the cold
    run; the reloaded template gives the in-memory one's output bits."""
    from pyfocusr_tpu_torch.ops import eigen

    t_phase = time.perf_counter()
    ts, ss = CLASS_PAIR_SEEDS
    tg, sg = graphs[ts], graphs[ss]
    draws = tp.make_draws(0, cfg, tg.n_points, sg.n_points)
    runs = {}

    def run(name, **kw):
        eigen.SOLVES.clear()
        res, secs = timed(torch, lambda: tp.register_pair(tg, sg, cfg, draws=draws, **kw))
        runs[name] = {"s": secs, "solves": list(eigen.SOLVES),
                      "quality": quality_and_checks(tp, meshes[ts], meshes[ss], res,
                                                    sg.n_points)}
        return res

    cold = run("cold")
    warm = run("warm_block", warm_block=tp.warm_block_from_prepared(prep, graphs[2]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "template.npz")
        tp.save_prepared_target(path, prep, cfg, graphs[2])
        back = tp.load_prepared_target(path, cfg, graphs[2], device=device)
    check(back["block"].device == graphs[2].device, "the template did not load on the card")
    reloaded = run("warm_block_reloaded", warm_block=tp.warm_block_from_prepared(back))
    vs_cold = compare_runs(cold, to_cpu(warm))
    reload_diff = outputs_differ(torch, warm, reloaded)
    emit({"phase": "serving_class_template", "nvidia_smi": smi,
          "template_seed": 2, "pair_seeds": [ts, ss], "runs": runs,
          "warm_vs_cold": vs_cold, "reloaded_differs": reload_diff,
          "phase_s": time.perf_counter() - t_phase})
    for name in ("warm_block", "warm_block_reloaded"):
        check(all(sv["warm"] for sv in runs[name]["solves"]),
              f"{name}: a solve started cold: {runs[name]['solves']}")
    check(vs_cold["eigval_max_rel_diff"] <= EIGVAL_RTOL,
          "class-template eigenvalues vs the cold run")
    check(abs(runs["warm_block"]["quality"]["unique_fraction"]
              - runs["cold"]["quality"]["unique_fraction"]) <= UNIQUE_DIFF_MAX,
          "class-template unique fraction vs the cold run")
    if deterministic:
        check(not reload_diff, f"reloaded template changed the output: {reload_diff}")
    else:
        agreement_checks(compare_runs(warm, to_cpu(reloaded)),
                         "reloaded template vs in-memory")


class SpectrumRecorder:
    """Records each ``pipeline._spectrum`` call's solver, rows and fenced
    seconds while installed (the pipeline calls it through the module
    attribute)."""

    def __init__(self, torch, pipeline):
        self.torch, self.mod, self.real = torch, pipeline, pipeline._spectrum
        self.solves = []

    def __enter__(self):
        def recorded(graph, k, cfg, *args, **kwargs):
            sync(self.torch, graph.device)
            t0 = time.perf_counter()
            out = self.real(graph, k, cfg, *args, **kwargs)
            sync(self.torch, graph.device)
            self.solves.append({"solver": self.mod._solver(cfg, graph.n_points),
                                "n": graph.n_points, "s": time.perf_counter() - t0})
            return out

        self.mod._spectrum = recorded
        return self

    def __exit__(self, *exc):
        self.mod._spectrum = self.real


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def focusr_run(torch, tp, kernels, target, source, device, entry="align_maps", **kw):
    """One ``Focusr`` construction and ``entry`` call on ``device`` with the
    kernels' launch counts set to 0 just before and read just after (the
    eigsort's printed report is swallowed).  Returns (the object, its
    seconds, the launches, the ICP and CPD loops it ran)."""
    from pyfocusr_tpu_torch.ops import cpd as cpd_ops
    from pyfocusr_tpu_torch.ops import icp as icp_ops

    sync(torch, device)
    for mod in kernels.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    with CpdRecorder(cpd_ops) as rec, contextlib.redirect_stdout(io.StringIO()):
        reg = tp.Focusr(target, source, device=device, **kw)
        getattr(reg, entry)()
    sync(torch, device)
    secs = time.perf_counter() - t0
    loops = {"icp_iterations": icp_ops.ICP_STATS["iterations"],
             "cpd_affine": rec.affine_runs, "cpd_deformable": rec.runs}
    return reg, secs, {k: m.LAUNCHES for k, m in kernels.items()}, loops


def focusr_result(torch, reg):
    """A ``Focusr``'s results under ``register_pair``'s keys (for
    ``compare_runs``)."""
    return {
        "eig_vals_target": reg.graph_target.eig_vals,
        "eig_vals_source": reg.graph_source.eig_vals,
        "eig_vecs_target": reg.graph_target.eig_vecs,
        "eig_vecs_source_sorted": reg.graph_source.eig_vecs,
        "correspondences": torch.as_tensor(reg.corresponding_target_idx_for_each_source_pt),
        "initial_correspondences": torch.as_tensor(reg.initial_correspondences),
        "weighted_points": reg.weighted_avg_transformed_points,
    }


def lap_dispatch(torch, TA, sizes=LAP_DISPATCH_SIZES, reps=3):
    """The card's solve (``linear_sum_assignment`` with
    ``device_threshold=0``: Sinkhorn and JV) against ``lap_host`` (the host
    library's C++ JV) on the same cost, at each of ``sizes``: uniform [0, 1)
    costs from a seed, the fenced median of ``reps`` warm calls of each;
    the objectives must agree.  Also the largest size at which the host
    won (``host_wins_up_to``), which ``DEVICE_THRESHOLD`` should equal."""
    rows = {}
    host_wins_up_to = 0
    for n in sizes:
        c64 = np.random.default_rng(n).uniform(0.0, 1.0, (n, n))
        cost = torch.tensor(c64.astype(np.float32), device="cuda")
        c64 = cost.double().cpu().numpy()
        TA.linear_sum_assignment(cost, device_threshold=0)
        TA.lap_host(c64)
        secs, host_secs = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, col = TA.linear_sum_assignment(cost, device_threshold=0)
            secs.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            _, host_col = TA.lap_host(c64)
            host_secs.append(time.perf_counter() - t0)
        r = np.arange(n)
        obj, obj_host = float(c64[r, col].sum()), float(c64[r, host_col].sum())
        card_s, host_s = float(np.median(secs)), float(np.median(host_secs))
        if host_s < card_s:
            host_wins_up_to = n
        rows[str(n)] = {"card_s": card_s, "lap_host_s": host_s,
                        "objective_rel_diff": abs(obj - obj_host) / obj_host}
        check(len(np.unique(col)) == n
              and abs(obj - obj_host) <= SAME_COST_OBJ_RTOL * obj_host,
              f"linear_sum_assignment on the card at n = {n}: {rows[str(n)]}")
    return {"sizes": rows, "host_wins_up_to": host_wins_up_to,
            "device_threshold": TA.DEVICE_THRESHOLD}


def viewer_counts(path):
    """(name, vertices, triangles) of each mesh in an exported viewer file,
    read back from its scene JSON and its decoded base64 payloads, and the
    point sets' sizes."""
    import base64

    with open(path, encoding="utf-8") as f:
        text = f.read()
    body = text.split('<script id="scene" type="application/json">', 1)[1]
    scene = json.loads(body.split("</script>", 1)[0])
    meshes = []
    for m in scene["meshes"]:
        pos = np.frombuffer(base64.b64decode(m["pos"]), "<f4")
        idx = np.frombuffer(base64.b64decode(m["idx"]), "<u4")
        check(pos.size == 3 * m["n"] and idx.size == 3 * m["f"]
              and (idx.size == 0 or int(idx.max()) < m["n"]),
              f"viewer payload of {m['name']} does not match its counts")
        meshes.append((m["name"], m["n"], m["f"]))
    return meshes, [p["n"] for p in scene["pointSets"]]


def viewer_export(reg):
    """A ``Focusr`` result (tensors on its device) and its target ``Graph``
    through ``export_viewer_html``; the files must parse back to the
    meshes' vertex and triangle counts."""
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        reg_path = reg.export_viewer_html(os.path.join(d, "registration.html"),
                                          include_spectral_coords=True)
        graph_path = reg.graph_target.export_viewer_html(os.path.join(d, "graph.html"),
                                                         eig_vec=1)
        secs = time.perf_counter() - t0
        sizes = [os.path.getsize(reg_path), os.path.getsize(graph_path)]
        reg_meshes, reg_points = viewer_counts(reg_path)
        graph_meshes, _ = viewer_counts(graph_path)
    t, s = reg.graph_target.mesh, reg.graph_source.mesh
    want = [("target", t.n_points, t.n_triangles), ("source", s.n_points, s.n_triangles)]
    if (reg.weighted_avg_transformed_mesh is not None
            or reg.nearest_neighbour_transformed_mesh is not None):  # built by the export
        want.append(("source transformed", s.n_points, s.n_triangles))
    check(reg_meshes == want and reg_points == [t.n_points, s.n_points]
          and graph_meshes == [("mesh", t.n_points, t.n_triangles)],
          f"viewer export read back {reg_meshes}, {reg_points}, {graph_meshes}; "
          f"expected {want}")
    return {"s": secs, "bytes": sizes, "meshes": reg_meshes, "graph": graph_meshes,
            "on_device": str(reg.graph_target.mesh.points.device)}


def phase_class_api(torch, tp, kernels, smi, deterministic, device="cuda",
                    levels=5, cpu_levels=CPU_CHECK_LEVELS):
    """The class API on ``device``: ``Focusr`` at the class defaults on the
    ``levels`` pair (10242 vertices), first call and warm, stage seconds
    from its ``StageTimer``; ``align_maps_pipeline`` against the port's
    ``register_pair`` on its config and draws (bit for bit where two plain
    calls are, else the CUDA-vs-CPU gates); 'hungarian' correspondences at
    642 and 2562 (the assignment's objective against ``lap_host``'s on the
    same cost) and, on the card, the ``lap_dispatch`` sweep; the narrow
    solver on a 642 pair and 'lanczos' and 'chebyshev-narrow' at 2562
    through ``register_pair``, each solve timed; and the CUDA-vs-CPU gates
    at 2562 on those two and on ``Focusr`` at the drive recipe.  Returns
    the class-defaults warm pair's launches and the 2562 'hungarian'
    pair's."""
    from pyfocusr_tpu_torch.ops import assignment as TA
    from pyfocusr_tpu_torch.ops.knn import pairwise_sq_dists

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    target, source = synthetic_bone(tp, 2, levels), synthetic_bone(tp, 1, levels)
    n_s = source.n_points
    out = {"phase": "class_api", "nvidia_smi": smi, "n": n_s,
           "config": "Focusr class defaults (pyfocusr_tpu/focusr.py:48-94)"}

    # --- Focusr at the class defaults: first call, then a warm one ---
    runs = []
    for _ in range(2):
        reg, secs, launches, loops = focusr_run(torch, tp, kernels, target, source, device)
        runs.append({"s": secs, "stages_s": reg.timer.totals(), "launches": launches,
                     **loops, "quality": reg.registration_quality()})
    out["defaults"] = {"first": runs[0], "warm": runs[1]}
    warm = runs[1]
    if on_card:
        for name in ("knn", "umeyama3", "cpd_estep"):
            check(warm["launches"][name] > 0,
                  f"Focusr at the class defaults launched no {name} kernel")
    n_cpd = min(5000, n_s)
    route = "streamed" if n_cpd * n_cpd > 3000 * 3000 else "dense"
    check(warm["cpd_affine"][-1]["estep_impl"] == route
          and warm["cpd_deformable"][-1]["estep_impl"] == route
          and warm["cpd_deformable"][-1]["n_control"] == n_cpd,
          f"the class path's CPD did not take the {route} E-step at {n_cpd} points: {warm}")
    check(warm["quality"]["unique_fraction"] > 0.5,
          f"class defaults unique fraction {warm['quality']}")
    out["viewer_export"] = viewer_export(reg)

    # --- align_maps_pipeline against register_pair on its inputs ---
    reg_p, p_s, p_launches, _ = focusr_run(torch, tp, kernels, target, source, device,
                                           entry="align_maps_pipeline")
    cfg, tg, sg, draws = reg_p._pipeline_inputs()
    plain = tp.register_pair(tg, sg, cfg, draws=draws)
    got = focusr_result(torch, reg_p)
    same = {"correspondences": np.array_equal(
                reg_p.corresponding_target_idx_for_each_source_pt,
                plain["correspondences"].cpu().numpy()),
            **{k: bool(torch.equal(got[k], plain[k])) for k in (
                "eig_vals_target", "eig_vals_source", "eig_vecs_source_sorted",
                "weighted_points")}}
    vs_plain = compare_runs(plain, {k: v.cpu() for k, v in got.items()})
    out["pipeline"] = {"s": p_s, "launches": p_launches, "equal_bits": same,
                       "gate": "bit for bit" if deterministic else "CUDA-vs-CPU gates",
                       "vs_register_pair": vs_plain}
    if deterministic:
        check(all(same.values()), f"align_maps_pipeline vs register_pair: {same}")
    else:
        agreement_checks(vs_plain, "align_maps_pipeline vs register_pair")

    # --- 'hungarian' initial and final correspondences at 642 and 2562 ---
    small_t = synthetic_bone(tp, 2, cpu_levels)
    small_s = synthetic_bone(tp, 1, cpu_levels)
    tiny = [synthetic_bone(tp, seed, 3) for seed in (2, 1)]
    out["hungarian"] = {}
    for meshes in (tiny, (small_t, small_s)):
        reg_h, h_s, launches, _ = focusr_run(
            torch, tp, kernels, *meshes, device,
            initial_correspondence_type="hungarian", final_correspondence_type="hungarian")
        n_h = meshes[1].n_points
        cost = torch.sqrt(pairwise_sq_dists(reg_h.source_spectral_coords,
                                            reg_h.target_spectral_coords)).cpu().numpy()
        rows = np.arange(cost.shape[0])
        obj_class = float(cost.astype(np.float64)[rows, reg_h.initial_correspondences].sum())
        t0 = time.perf_counter()
        _, host_cols = TA.lap_host(cost)
        host_s = time.perf_counter() - t0
        obj_host = float(cost.astype(np.float64)[rows, host_cols].sum())
        unique = len(np.unique(reg_h.corresponding_target_idx_for_each_source_pt)) / n_h
        out["hungarian"][str(n_h)] = {
            "s": h_s, "launches": launches,
            "objective_class": obj_class, "objective_lap_host": obj_host,
            "objective_rel_diff": abs(obj_class - obj_host) / obj_host,
            "lap_host_s": host_s, "unique_fraction": unique}
        if on_card and n_h > TA.DEVICE_THRESHOLD:
            check(launches["lse_rows"] > 0 and launches["jv"] == 2,
                  f"the class 'hungarian' pair at {n_h} launched {launches}")
        elif on_card:  # linear_sum_assignment keeps this size on the host
            check(launches["lse_rows"] == 0 and launches["jv"] == 0,
                  f"the class 'hungarian' pair at {n_h} launched {launches}")
        check(abs(obj_class - obj_host) <= SAME_COST_OBJ_RTOL * obj_host,
              f"class 'hungarian' objective at {n_h}: {obj_class} against "
              f"lap_host's {obj_host}")
        check(unique == 1.0, f"class 'hungarian' at {n_h} not one-to-one")
    h_launches = launches
    if on_card:
        out["lap_dispatch"] = lap_dispatch(torch, TA)

    # --- The narrow solver and Lanczos through register_pair, timed ---
    solves = {}
    for name, meshes, kw in (("narrow_642", tiny, {}),
                             ("narrow_2562", (small_t, small_s),
                              dict(eig_method="chebyshev-narrow")),
                             ("lanczos_2562", (small_t, small_s),
                              dict(eig_method="lanczos"))):
        cfg_e = tp.PipelineConfig(**dict(BENCH_CFG, **kw))
        graphs = [tp.mesh_to_graph_arrays(m, device="cpu") for m in meshes]
        d = tp.pipeline.host_draws(
            tp.make_draws(0, cfg_e, graphs[0].n_points, graphs[1].n_points))
        rec_runs = {}
        for dev in (device, "cpu") if name != "narrow_642" else (device,):
            with SpectrumRecorder(torch, tp.pipeline) as srec:
                sync(torch, dev)
                t0 = time.perf_counter()
                res = tp.register_pair(graphs[0].to(dev), graphs[1].to(dev), cfg_e, draws=d)
                sync(torch, dev)
            rec_runs[dev] = {"s": time.perf_counter() - t0, "solves": srec.solves,
                             "res": res}
        entry = {f"{dev}_s": r["s"] for dev, r in rec_runs.items()}
        entry.update({f"{dev}_solves": r["solves"] for dev, r in rec_runs.items()})
        entry["quality"] = quality_and_checks(tp, meshes[0], meshes[1],
                                              rec_runs[device]["res"], meshes[1].n_points)
        if "cpu" in rec_runs and device != "cpu":
            entry["cuda_vs_cpu"] = compare_runs(rec_runs[device]["res"],
                                                rec_runs["cpu"]["res"])
        solves[name] = entry
    out["register_pair_solvers"] = solves

    # --- Focusr CUDA vs CPU at the drive recipe (no weighting) ---
    recipe = dict(n_spectral_features=3, n_extra_spectral=3,
                  get_weighted_spectral_coords=False, list_features_to_calc=[],
                  non_rigid_alpha=0.01, non_rigid_beta=50, non_rigid_max_iterations=100,
                  rigid_before_non_rigid_reg=False, projection_smooth_iterations=1,
                  graph_smoothing_iterations=100, n_coords_spectral_registration=1000)
    rr = {dev: focusr_run(torch, tp, kernels, small_t, small_s, dev, **recipe)
          for dev in (device, "cpu")}
    out["recipe"] = {f"{dev}_s": r[1] for dev, r in rr.items()}
    if device != "cpu":
        out["recipe"]["cuda_vs_cpu"] = compare_runs(
            focusr_result(torch, rr[device][0]), focusr_result(torch, rr["cpu"][0]))
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if device != "cpu":
        for name in ("narrow_2562", "lanczos_2562"):
            agreement_checks(solves[name]["cuda_vs_cpu"], f"register_pair {name} CUDA vs CPU")
        agreement_checks(out["recipe"]["cuda_vs_cpu"], "Focusr recipe CUDA vs CPU (2562)")
    return warm["launches"], h_launches


def phase_features(torch, tp, meshes, smi, device="cuda"):
    """``register_pair`` under each feature flag at the bench configuration,
    each mesh's thickness scalar as its feature: the 10242 pair on the card
    (wall time and quality), and the 2562 pair on the card against the CPU
    under the 'kd' CUDA-vs-CPU gates, with CPD stopping at
    ``FEATURE_CHECK_TOLERANCE``."""
    from pyfocusr_tpu_torch.ops import cpd as cpd_ops

    t_phase = time.perf_counter()
    small = {seed: synthetic_bone(tp, seed, levels=CPU_CHECK_LEVELS) for seed in (1, 2)}
    feat = {}
    for name, ms in (("full", meshes), ("small", small)):
        feat[name] = {seed: tp.mesh_to_graph_arrays(
            ms[seed], node_features=ms[seed].point_data[FEATURE],
            device=device if name == "full" else "cpu") for seed in (1, 2)}
    rows = []
    for flag in FEATURE_FLAGS:
        cfg = tp.PipelineConfig(**dict(BENCH_CFG, **{flag: True}))
        tg, sg = feat["full"][2], feat["full"][1]
        draws = tp.make_draws(0, cfg, tg.n_points, sg.n_points)
        res, secs = timed(torch, lambda: tp.register_pair(tg, sg, cfg, draws=draws))
        row = {"flag": flag, "s": secs, "cpd_iterations": cpd_ops.EM_STATS["iterations"],
               "quality": quality_and_checks(tp, meshes[2], meshes[1], res, sg.n_points)}
        ccfg = tp.PipelineConfig(**dict(BENCH_CFG, non_rigid_tolerance=FEATURE_CHECK_TOLERANCE,
                                        **{flag: True}))
        st, ss = feat["small"][2], feat["small"][1]
        sd = tp.pipeline.host_draws(tp.make_draws(0, ccfg, st.n_points, ss.n_points))
        res_gpu = tp.register_pair(st.to(device), ss.to(device), ccfg, draws=sd)
        it_gpu = cpd_ops.EM_STATS["iterations"]
        t0 = time.perf_counter()
        res_cpu = tp.register_pair(st, ss, ccfg, draws=sd)
        row.update(cpu_check_n=st.n_points, cpu_s=time.perf_counter() - t0,
                   cpd_iterations_check=[it_gpu, cpd_ops.EM_STATS["iterations"]],
                   cuda_vs_cpu=compare_runs(res_gpu, res_cpu))
        rows.append(row)
    emit({"phase": "features", "nvidia_smi": smi, "feature": FEATURE,
          "config": "bench.py:122-134 plus each flag",
          "cpu_check": f"the 2562 pair, non_rigid_tolerance {FEATURE_CHECK_TOLERANCE}",
          "runs": rows, "phase_s": time.perf_counter() - t_phase})
    for row in rows:
        agreement_checks(row["cuda_vs_cpu"], f"{row['flag']} CUDA vs CPU (2562)")


def _device_us(evt) -> float:
    if hasattr(evt, "device_time_total"):
        return float(evt.device_time_total)
    return float(evt.cuda_time_total)  # torch releases before the rename


def profile_run(torch, tp, tg, sg, cfg, draws, smi, phase, table_name):
    """One more register_pair under torch.profiler (see :func:`profile_call`)."""
    return profile_call(torch, lambda: tp.register_pair(tg, sg, cfg, draws=draws),
                        smi, phase, table_name)


def profile_call(torch, fn, smi, phase, table_name):
    """``fn()`` under torch.profiler: wall time, device busy time (sum of
    kernel and copy durations on the card), and each top-level
    ``register_pair/`` range's host time (the draws, ``inputs`` and the
    stages) and the device time of what it launched, once per range and
    pair.  The full table goes to build/<table_name>."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.events()
    busy_us = sum(
        e.time_range.elapsed_us() for e in events
        if e.device_type == DeviceType.CUDA
        and not e.name.startswith("register_pair/")
    )
    # The hand-written kernels are launched through ctypes, outside any
    # torch operator: a stage's device time counts those launched inside one
    # of its nested spans (``icp/loop``, ``cpd/em_loop``, ``lap/*``, ...;
    # ``utils/spans.py``) and misses the rest.  Their time is summed here by
    # kernel name.
    own_ms = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            for tag in ("knn_kernel", "lse_rows_kernel", "lse_cols",
                        "jv_cluster_kernel", "estep_", "umeyama3_kernel"):
                if tag in e.name:
                    own_ms[tag] = own_ms.get(tag, 0.0) + e.time_range.elapsed_us() / 1e3
    stages = [
        {"stage": e.name.split("/", 1)[1],
         "host_ms": e.time_range.elapsed_us() / 1e3,
         "device_ms": _device_us(e) / 1e3}
        for e in events
        if e.device_type == DeviceType.CPU and e.name.startswith("register_pair/")
    ]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(ROOT, "build", table_name), "w") as f:
        f.write(smi + "\n" + table)
    return {"phase": phase, "wall_s": wall_s, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "hand_written_kernels_device_ms": own_ms, "stages": stages,
            "table": f"build/{table_name}"}


def drive(torch, tp, kernels, tg, sg, cfg, draws, warm_reps=1):
    """The path once to warm up, then ``warm_reps`` times with every
    kernel's launch count set to 0 just before each call and read just
    after.  Returns (the last result, first-call seconds, the warm calls'
    seconds, the last call's launches by kernel, peak device bytes)."""
    t0 = time.perf_counter()
    tp.register_pair(tg, sg, cfg, draws=draws)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(warm_reps):
        torch.cuda.synchronize()
        for mod in kernels.values():
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        res = tp.register_pair(tg, sg, cfg, draws=draws)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    return res, first_s, warm, launches, torch.cuda.max_memory_allocated()


def cpd_paths(torch, tp, kernels, tg, sg, target_mesh, source_mesh, smi):
    """The two CPD configurations on the 10242 pair (full resolution and the
    reference's raw defaults), the E-step kernel against its plain version
    at their inputs, streamed against dense EM, and full resolution CUDA
    against CPU. Returns the two paths' launch counts and the kernel
    comparison's results."""
    from pyfocusr_tpu_torch.ops import cpd as cpd_ops

    cpd_estep_kernel = kernels["cpd_estep"]
    n_t, n_s = tg.n_points, sg.n_points
    # --- Full-resolution CPD: all 10242 points, streamed E-step and tiled
    # Gram ---
    fr_cfg = tp.PipelineConfig(**FULLRES_CFG)
    fr_draws = tp.make_draws(0, fr_cfg, n_t, n_s)
    with CpdRecorder(cpd_ops) as rec:
        full, fr_first_s, (fr_warm_s,), fr_launches, fr_peak = drive(
            torch, tp, kernels, tg, sg, fr_cfg, fr_draws)
    fr_cpd = rec.runs[-1]
    q_fr = quality_and_checks(tp, target_mesh, source_mesh, full, n_s)
    emit({
        "phase": "register_pair_fullres_cuda",
        "n_target": n_t, "n_source": n_s,
        "config": "bench.py:122-134 with n_coords_spectral_registration=10242, "
                  "non_rigid_alpha=0.1 (docs/tuning.md:8-15)",
        "first_call_s": fr_first_s, "warm_s": fr_warm_s, "launches": fr_launches,
        "cpd": fr_cpd, "peak_device_bytes": fr_peak, "quality": q_fr,
    })
    check(fr_cpd["estep_impl"] == "streamed" and fr_cpd["n_control"] == n_t,
          f"full-resolution CPD did not stream over all points: {fr_cpd}")
    check(estep_launches_fit(fr_launches["cpd_estep"], rec, cpd_ops),
          f"E-step launches {fr_launches['cpd_estep']} outside [2 x, 2 x ({fr_cpd['iterations']} "
          "EM iterations + the EM block))")
    fr_call = rec.last_call
    emit(profile_run(torch, tp, tg, sg, fr_cfg, fr_draws, smi, "profile_fullres",
                     "profile_register_pair_fullres.txt"))

    # --- The E-step kernel against its plain version at the paths' inputs:
    # the full-resolution run's spectral clouds (target before and after
    # CPD), D = 3 and with xyz appended (D = 6), 10242 and 5000 points.
    X3 = full["spectral_coords_source"].contiguous()
    Y3 = full["eig_vecs_target"][:, :3].contiguous()
    moved3 = full["spectral_coords_target"].contiguous()
    xyz_s = tp.pipeline._normed_points(sg)[0]
    xyz_t = tp.pipeline._normed_points(tg)[0]
    X6 = torch.cat([X3, xyz_s], dim=1).contiguous()
    Y6 = torch.cat([Y3, xyz_t], dim=1).contiguous()
    moved6 = torch.cat([moved3, xyz_t], dim=1).contiguous()
    late = fr_cpd["sigma2"]
    cases = []
    for n in (n_t, 5000):
        for d, X, Y, moved in ((3, X3, Y3, moved3), (6, X6, Y6, moved6)):
            Xn, Yn, mn = X[:n].contiguous(), Y[:n].contiguous(), moved[:n].contiguous()
            cases.append((f"{n}_d{d}_initial", Xn, Yn, float(cpd_ops._init_sigma2(Xn, Yn))))
            cases.append((f"{n}_d{d}_late", Xn, mn, late))
    est_results = phase_cpd_estep(torch, cpd_estep_kernel, cpd_ops, cases)
    phase_cpd_run(torch, cpd_ops, X3, Y3, FULLRES_CFG["non_rigid_beta"],
                  FULLRES_CFG["non_rigid_alpha"])
    # The EM loop as a CUDA graph against the plain loop, at full resolution
    # and on the 'kd' path's 1000 points.
    kd_cfg = tp.PipelineConfig(**BENCH_CFG)
    with CpdRecorder(cpd_ops) as rec:
        tp.register_pair(tg, sg, kd_cfg, draws=tp.make_draws(0, kd_cfg, n_t, n_s))
    loop_results = phase_cpd_loops(torch, cpd_ops, cpd_estep_kernel,
                                   (("fullres", fr_call), ("kd_1000", rec.last_call)))
    del cases, X6, Y6, moved6
    torch.cuda.empty_cache()

    # --- The reference's raw Focusr defaults: 5000-point streamed CPD after
    # the affine pre-pass, on weighted spectral coordinates ---
    rd_cfg = tp.PipelineConfig(**REFERENCE_DEFAULTS_CFG)
    rd_draws = tp.make_draws(0, rd_cfg, n_t, n_s)
    with CpdRecorder(cpd_ops) as rec:
        rres, rd_first_s, rd_warm, rd_launches, rd_peak = drive(
            torch, tp, kernels, tg, sg, rd_cfg, rd_draws, warm_reps=WARM_REPS)
    rd_cpd = rec.runs[-1]
    # Quality is recorded, not gated: the raw defaults are untuned for these
    # meshes (pyfocusr_tpu/pipeline.py:78-89 says why PipelineConfig differs).
    q_rd = quality_and_checks(tp, target_mesh, source_mesh, rres, n_s, min_unique=None)
    emit({
        "phase": "register_pair_reference_defaults_cuda",
        "n_target": n_t, "n_source": n_s,
        "config": "bench.py:122-134 with the raw Focusr defaults of "
                  "pyfocusr_tpu/pipeline.py:78-89",
        **warm_summary(rd_first_s, rd_warm), "launches": rd_launches,
        "cpd": rd_cpd, "affine_prepass": rec.affine_runs[-1:],
        "peak_device_bytes": rd_peak, "quality": q_rd,
    })
    check(rd_cpd["estep_impl"] == "streamed" and rd_cpd["n_control"] == 5000,
          f"the raw-defaults CPD did not stream over 5000 points: {rd_cpd}")
    check(rec.affine_runs and rec.affine_runs[-1]["estep_impl"] == "streamed",
          f"the raw-defaults affine pre-pass did not stream: {rec.affine_runs}")
    check(estep_launches_fit(rd_launches["cpd_estep"], rec, cpd_ops),
          f"E-step launches {rd_launches['cpd_estep']} outside [2 x, 2 x (EM iterations "
          f"{rec.streamed_loops()} + a block a loop))")
    del rres

    # --- Every CPD option at once: landmarks snapped from positions (on the
    # card), xyz appended (D = 6 in CPD), the affine pre-pass, all points ---
    lm_verts = np.array([0, 11, 640, 1300, 2561, 5000, n_t - 1])
    pairs, snap = tp.landmark_pairs_from_positions(
        source_mesh, target_mesh, source_mesh.points[lm_verts],
        target_mesh.points[lm_verts])
    check(pairs.device.type == "cuda"
          and np.array_equal(pairs.cpu().numpy(), np.stack([lm_verts] * 2, axis=1))
          and float(snap.abs().max()) == 0.0,
          "landmark_pairs_from_positions did not snap mesh vertices to themselves")
    all_cfg = tp.PipelineConfig(**dict(FULLRES_CFG, include_points_as_features=True,
                                       rigid_before_non_rigid_reg=True))
    all_draws = tp.make_draws(0, all_cfg, n_t, n_s, n_landmarks=len(lm_verts))
    for mod in kernels.values():
        mod.LAUNCHES = 0
    with CpdRecorder(cpd_ops) as rec:
        t0 = time.perf_counter()
        ares = tp.register_pair(tg, sg, all_cfg, draws=all_draws, landmark_pairs=pairs)
        torch.cuda.synchronize()
        all_s = time.perf_counter() - t0
    all_launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    all_cpd = rec.runs[-1]
    q_all = quality_and_checks(tp, target_mesh, source_mesh, ares, n_s, min_unique=None)
    emit({"phase": "register_pair_cpd_options_cuda",
          "config": "full resolution with include_points_as_features, "
                    "rigid_before_non_rigid_reg and 7 landmark pairs",
          "seconds": all_s, "launches": all_launches, "cpd": all_cpd,
          "affine_prepass": rec.affine_runs[-1:],
          "cpd_width": int(ares["spectral_coords_source"].shape[1]), "quality": q_all})
    check(ares["spectral_coords_source"].shape[1] == 6, "xyz columns did not reach CPD")
    check(all_cpd["estep_impl"] == "streamed"
          and estep_launches_fit(all_launches["cpd_estep"], rec, cpd_ops),
          f"E-step launches {all_launches['cpd_estep']} outside [2 x, 2 x "
          f"(EM iterations {rec.streamed_loops()} + a block a loop))")
    del ares

    # --- Full resolution, CUDA against CPU, CPD capped at the same number of
    # iterations on both (the CPU's plain E-step is two passes over 10242^2
    # pairs per iteration) ---
    cap_cfg = tp.PipelineConfig(**dict(FULLRES_CFG,
                                       non_rigid_max_iterations=FULLRES_CPU_EM_CAP))
    fr_host = tp.pipeline.host_draws(fr_draws)
    with CpdRecorder(cpd_ops) as rec:
        cap_gpu = tp.register_pair(tg, sg, cap_cfg, draws=fr_host)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cap_cpu = tp.register_pair(tg.to("cpu"), sg.to("cpu"), cap_cfg, draws=fr_host)
        fr_cpu_s = time.perf_counter() - t0
    cpd_gpu, cpd_cpu = rec.runs
    agree = compare_runs(cap_gpu, cap_cpu)
    s2_rel = abs(cpd_gpu["sigma2"] - cpd_cpu["sigma2"]) / cpd_cpu["sigma2"]
    emit({"phase": "fullres_cuda_vs_cpu", "em_cap": FULLRES_CPU_EM_CAP,
          "cpu_s": fr_cpu_s, "cpd_cuda": cpd_gpu, "cpd_cpu": cpd_cpu,
          "sigma2_rel_diff": s2_rel, **agree})
    check(cpd_gpu["iterations"] == cpd_cpu["iterations"], "CPD iterations CUDA vs CPU")
    check(s2_rel <= FULLRES_SIGMA2_RTOL, "CPD sigma2 CUDA vs CPU")
    check(agree["eigval_max_rel_diff"] <= EIGVAL_RTOL, "full-res eigenvalues CUDA vs CPU")
    check(agree["eigvec_min_abs_cos"] >= COS_MIN, "full-res eigenvectors CUDA vs CPU")
    check(agree["correspondence_agreement"] >= CORR_AGREE_MIN,
          "full-res final correspondences CUDA vs CPU")
    check(abs(agree["unique_fraction_gpu"] - agree["unique_fraction_cpu"])
          <= UNIQUE_DIFF_MAX, "full-res unique fraction CUDA vs CPU")
    del cap_gpu, cap_cpu
    return fr_launches, rd_launches, est_results, loop_results


class MultiresSplit:
    """Times the stages of ``register_pair_multires`` while installed, by
    wrapping the names ``multires.py`` calls.  Each call is fenced by
    ``sync`` before and after: its host seconds run to the call's return,
    its wall seconds to the fence after it (the difference is the device's
    tail).  Also keeps the decimations' sizes (mesh vertices, target,
    result) and the k=3 query's inputs and route."""

    STAGES = {"build_topology": "topology", "decimate": "decimation",
              "register_pair": "coarse_register_pair",
              "mesh_to_graph_arrays": "graph_build", "_smooth": "smoothing",
              "knn3_masked": "knn3", "idw_from_knn": "idw"}

    def __init__(self, torch, tp, device):
        from pyfocusr_tpu_torch import multires

        self.torch, self.tp, self.device, self.mod = torch, tp, device, multires
        self.real = {name: getattr(multires, name) for name in self.STAGES}
        self.calls = []  # (stage, host_s, wall_s)
        self.decimations = []  # (mesh vertices, target_n, coarse vertices)
        self.knn3 = None
        self.coarse = None  # the coarsest register_pair's (target, source, result)
        self.refine_args = None  # the last _refine_fine_level's arguments

    def _wrap(self, name):
        real = self.real[name]

        def timed_call(*args, **kwargs):
            sync(self.torch, self.device)
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            t1 = time.perf_counter()
            sync(self.torch, self.device)
            self.calls.append((self.STAGES[name], t1 - t0, time.perf_counter() - t0))
            if name == "decimate":
                self.decimations.append((args[0].n_points, args[1], out[0].n_points))
            if name == "knn3_masked":
                self.knn3 = {"inputs": args, "route": knn3_route(self.torch, args[0],
                                                                 args[2])}
            if name == "register_pair":
                self.coarse = (args[0], args[1], out)
            return out

        return timed_call

    def __enter__(self):
        for name in self.STAGES:
            setattr(self.mod, name, self._wrap(name))
        real_refine = self.real_refine = self.mod._refine_fine_level

        def refine(*args, **kwargs):
            self.refine_args = args
            return real_refine(*args, **kwargs)

        self.mod._refine_fine_level = refine
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.mod, name, real)
        self.mod._refine_fine_level = self.real_refine

    def coarse_quality(self):
        """``registration_quality`` of the coarsest ``register_pair`` on its
        own graphs."""
        tg, sg, res = self.coarse
        return self.tp.registration_quality(tg.points, sg.points, res)

    def summary(self, total_s):
        """Seconds by stage (the two smoothings apart), their sum and the
        unattributed rest of ``total_s``."""
        out, smooth = {}, 0
        for stage, host_s, wall_s in self.calls:
            if stage == "smoothing":
                stage = ("smoothing_target", "smoothing_projection")[smooth % 2]
                smooth += 1
            rec = out.setdefault(stage, {"host_s": 0.0, "wall_s": 0.0, "calls": 0})
            rec["host_s"] += host_s
            rec["wall_s"] += wall_s
            rec["calls"] += 1
        attributed = sum(r["wall_s"] for r in out.values())
        return {"stages": out, "total_s": total_s,
                "unattributed_s": total_s - attributed}


def knn3_route(torch, ref, query):
    """The route the k=3 query of ``ref`` x ``query`` takes: the decision of
    ``ops/knn.py`` and, in the race band, the recorded winner (None before
    the first race of its bucket)."""
    from pyfocusr_tpu_torch.ops import knn as knn_ops
    from pyfocusr_tpu_torch.ops import knn_routing

    decision = knn_ops._grid_decision(ref, query, 3)
    out = {"decision": decision, "pairs": float(ref.shape[0]) * query.shape[0]}
    if decision == "race":
        bucket = knn_routing.bucket_key(query.shape[0], ref.shape[0], 3)
        out["bucket"] = bucket
        out["recorded"] = knn_routing._load(knn_routing.cache_file(ref.device)).get(bucket)
    return out


def knn3_routes(torch, ref_positions, ref_mask, query, reps=3):
    """Both routes of ``knn3_masked`` on the same inputs: the grid
    (``grid_knn.knn_grid``) and the brute-force kernel, each called once to
    warm up and then ``reps`` times, wall seconds fenced by
    ``torch.cuda.synchronize``; bit-equal distances and indices; the grid's
    ``last_stats``."""
    from pyfocusr_tpu_torch.ops import grid_knn, knn_kernel
    from pyfocusr_tpu_torch.ops.knn import SENTINEL

    device = query.device
    ref = torch.where(ref_mask[:, None] > 0, ref_positions,
                      torch.full_like(ref_positions, SENTINEL)).float().contiguous()
    query = query.float().contiguous()
    routes = {"grid": lambda: grid_knn.knn_grid(ref, query, 3),
              "brute": lambda: knn_kernel.knn(ref, query, 3)}
    out, results = {"n_ref": ref.shape[0], "n_query": query.shape[0],
                    "pairs": float(ref.shape[0]) * query.shape[0]}, {}
    for name, fn in routes.items():
        fn()
        times = []
        for _ in range(reps):
            sync(torch, device)
            t0 = time.perf_counter()
            results[name] = fn()
            sync(torch, device)
            times.append(time.perf_counter() - t0)
        out[f"{name}_s"] = statistics.median(times)
        out[f"{name}_s_all"] = times
        if name == "grid":
            out["grid_stats"] = dict(grid_knn.last_stats)
    (gd, gi), (bd, bi) = results["grid"], results["brute"]
    out["bit_equal"] = bool(torch.equal(gd, bd) and torch.equal(gi, bi))
    out["brute_over_grid"] = out["brute_s"] / out["grid_s"]
    return out


def outputs_equal(torch, a, b):
    """Whether two result dicts hold the same keys and equal tensors."""
    return set(a) == set(b) and not outputs_differ(torch, a, b)


def phase_multires(torch, tp, kernels, smi, device="cuda", levels=MULTIRES_LEVELS,
                   coarse_n=MULTIRES_COARSE_N, multi_levels=MULTIRES_MULTI_LEVELS,
                   route_levels=MULTIRES_ROUTE_LEVELS, check_levels=CPU_CHECK_LEVELS + 1,
                   cpu_check=True):
    """``register_pair_multires`` on the synthetic pair at ``levels`` (655362
    vertices at 8) under the 'kd' configuration: a first call writing
    checkpoints (a fresh checkpoint directory and routing record), a second
    call resuming from them (bit-equal; the stages served observed through
    ``StageCheckpointer.load``), a third without checkpoints split by stage;
    both routes of the refine's k=3 query on its own inputs, bit-equal and
    timed.  Then a multi-level run (``multi_levels``, level_ratio 4), both
    routes at ``route_levels`` (the refine's inputs and the source's points
    against the target's), and CUDA against CPU at ``check_levels`` with the
    same coarse draws.  The phase's line is printed before its gates are
    read.  Returns the first call's launches and the last call's refine
    inputs (``_refine_fine_level``'s target, source, initial
    correspondences and config)."""
    from pyfocusr_tpu_torch import multires
    from pyfocusr_tpu_torch.utils.checkpoint import StageCheckpointer

    t_phase = time.perf_counter()
    gates = []  # (ok, what), read after the line is printed
    cfg = tp.PipelineConfig(**BENCH_CFG)
    target = synthetic_bone(tp, 2, levels)
    source = synthetic_bone(tp, 1, levels)
    n_s = source.n_points

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    served = []
    real_load = StageCheckpointer.load

    def spy_load(self, stage):
        val = real_load(self, stage)
        if val is not None:
            served.append(stage)
        return val

    saved_cal = os.environ.get("PYFOCUSR_TPU_CAL_DIR")
    with tempfile.TemporaryDirectory() as ck, tempfile.TemporaryDirectory() as cal:
        os.environ["PYFOCUSR_TPU_CAL_DIR"] = cal
        try:
            sync(torch, device)
            for mod in kernels.values():
                mod.LAUNCHES = 0
            t0 = time.perf_counter()
            with MultiresSplit(torch, tp, device) as first_split:
                fine, coarse = tp.register_pair_multires(
                    target, source, cfg, gen(), coarse_n=coarse_n,
                    checkpoint_dir=ck, device=device)
            sync(torch, device)
            first_s = time.perf_counter() - t0
            launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
            stage_files = sorted(os.listdir(ck))
            StageCheckpointer.load = spy_load
            try:
                t0 = time.perf_counter()
                fine2, coarse2 = tp.register_pair_multires(
                    target, source, cfg, gen(), coarse_n=coarse_n,
                    checkpoint_dir=ck, device=device)
                sync(torch, device)
                resume_s = time.perf_counter() - t0
            finally:
                StageCheckpointer.load = real_load
            t0 = time.perf_counter()
            with MultiresSplit(torch, tp, device) as split:
                fine3, _ = tp.register_pair_multires(
                    target, source, cfg, gen(), coarse_n=coarse_n, device=device)
            sync(torch, device)
            third = split.summary(time.perf_counter() - t0)
            refine_args = split.refine_args
            routes = knn3_routes(torch, *split.knn3["inputs"])
            q = quality_and_checks(tp, target, source, fine, n_s, min_unique=None)
        finally:
            if saved_cal is None:
                os.environ.pop("PYFOCUSR_TPU_CAL_DIR", None)
            else:
                os.environ["PYFOCUSR_TPU_CAL_DIR"] = saved_cal
    if torch.device(device).type == "cuda":
        gates.append((launches["knn"] > 0 and launches["umeyama3"] > 0,
                      f"register_pair_multires launched no k-NN or close kernel: {launches}"))
    staged = 0 < multires._STAGED_REFINE_N <= max(target.n_points, n_s)
    want = ["coarse"] + (["refine_projected", "refine_smoothed_target"] if staged else [])
    gates += [
        (q["unique_fraction"] > 0.6, f"unique fraction {q['unique_fraction']}"),
        (sorted(served) == want, f"stages served on resume: {served}, expected {want}"),
        (outputs_equal(torch, fine, fine2) and outputs_equal(torch, coarse, coarse2),
         "the resumed call differs from the first"),
        (outputs_equal(torch, fine, fine3), "the call without checkpoints differs"),
        (routes["bit_equal"], "knn3 grid and brute routes differ on the refine's inputs"),
    ]
    main = {
        "n_target": target.n_points, "n_source": n_s, "coarse_n": coarse_n,
        "levels": first_split.decimations, "first_call_s": first_s,
        "first_call_split": first_split.summary(first_s),
        "knn3_route_first_call": first_split.knn3["route"],
        "stage_files": stage_files, "resume_s": resume_s, "served": served,
        "third_call": third, "knn3_route": split.knn3["route"],
        "knn3_routes_refine_inputs": routes, "launches": launches, "quality": q,
        "coarse_quality": split.coarse_quality(),
    }
    del fine, fine2, fine3, coarse, coarse2, split, first_split

    # --- Multi-level: level_ratio 4 inserts intermediate levels.
    mt = synthetic_bone(tp, 2, multi_levels)
    ms = synthetic_bone(tp, 1, multi_levels)
    t0 = time.perf_counter()
    with MultiresSplit(torch, tp, device) as ml_split:
        ml_fine, _ = tp.register_pair_multires(
            mt, ms, cfg, gen(), coarse_n=MULTIRES_MULTI_COARSE_N, level_ratio=4.0,
            device=device)
    ml_s = time.perf_counter() - t0
    ml_q = quality_and_checks(tp, mt, ms, ml_fine, ms.n_points, min_unique=None)
    solves = [c for c in ml_split.calls if c[0] == "coarse_register_pair"]
    # Two decimations a level (target, then source): the target's sizes.
    ml_levels = [mt.n_points] + [d[2] for d in ml_split.decimations[0::2]]
    gates += [
        (len(solves) == 1 and len(ml_split.decimations) >= 4,
         f"level_ratio 4 inserted no intermediate level: {ml_split.decimations}"),
        (ml_q["unique_fraction"] > 0.6, f"multi-level unique fraction {ml_q['unique_fraction']}"),
    ]
    ml_routes = knn3_routes(torch, *ml_split.knn3["inputs"])
    gates.append((ml_routes["bit_equal"],
                  f"knn3 grid and brute routes differ at {mt.n_points}"))
    multi = {"n": mt.n_points, "decimations": ml_split.decimations,
             "target_levels": ml_levels, "seconds": ml_s, "quality": ml_q,
             "knn3_route": ml_split.knn3["route"], "knn3_routes_refine_inputs": ml_routes}
    del ml_fine

    # --- Both routes at route_levels: the refine's own inputs, and the
    # source's points against the target's.
    rt = synthetic_bone(tp, 2, route_levels)
    rs = synthetic_bone(tp, 1, route_levels)
    with MultiresSplit(torch, tp, device) as r_split:
        r_fine, _ = tp.register_pair_multires(rt, rs, cfg, gen(), coarse_n=coarse_n,
                                              device=device)
    route_refine = knn3_routes(torch, *r_split.knn3["inputs"])
    pts_t = torch.as_tensor(np.asarray(rt.points), device=device)
    pts_s = torch.as_tensor(np.asarray(rs.points), device=device)
    route_pair = knn3_routes(torch, pts_t, torch.ones(rt.n_points, device=device), pts_s)
    r_q = quality_and_checks(tp, rt, rs, r_fine, rs.n_points, min_unique=None)
    gates += [(route_refine["bit_equal"] and route_pair["bit_equal"],
               f"knn3 grid and brute routes differ at {rt.n_points}"),
              (r_q["unique_fraction"] > 0.6, f"unique fraction {r_q['unique_fraction']}")]
    routes_small = {"n": rt.n_points, "refine_inputs": route_refine,
                    "source_vs_target": route_pair, "route": r_split.knn3["route"],
                    "quality": r_q}
    del r_fine

    # --- CUDA against CPU with the same coarse draws.
    cpu = None
    if cpu_check and torch.device(device).type == "cuda":
        ct = synthetic_bone(tp, 2, check_levels)
        cs = synthetic_bone(tp, 1, check_levels)

        # CPD stops at 1e-6 here, as in the feature flags' check: at the
        # bench's 1e-8 the stop test is f32 noise, the coarse solves ended
        # 97.6% equal and the refine's smoothing spread that to 94.5% of the
        # fine correspondences, while the refine alone, from one set of
        # initial correspondences, agreed on 99.99% (PERF.md section 6).
        ccfg = tp.PipelineConfig(**dict(BENCH_CFG,
                                        non_rigid_tolerance=MULTIRES_CHECK_TOLERANCE))

        def draws(cg, sg, n_lm):
            return tp.pipeline.host_draws(
                tp.make_draws(0, ccfg, cg.n_points, sg.n_points, n_lm))

        runs = {}
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            with MultiresSplit(torch, tp, dev) as c_split:
                runs[dev] = tp.register_pair_multires(
                    ct, cs, ccfg, coarse_n=MULTIRES_CHECK_COARSE_N, draws=draws, device=dev)
            sync(torch, dev)
            runs[dev] = runs[dev] + (time.perf_counter() - t0, c_split.refine_args)
        (g_fine, g_coarse, g_s, g_args), (c_fine, c_coarse, c_s, _) = runs[device], runs["cpu"]
        agree = compare_runs(g_coarse, to_cpu(c_coarse))
        # The CPU's refine from the card's refine inputs (the same initial
        # correspondences): what the refine alone changes between devices.
        tg_, sg_, init_, fcfg_ = g_args[:4]
        same_init = multires._refine_fine_level(tg_.to("cpu"), sg_.to("cpu"),
                                                init_.cpu(), fcfg_)

        def equal_share(key, a=g_fine, b=c_fine):
            return float((a[key].cpu() == b[key].cpu()).float().mean())

        cpu = {"n": ct.n_points, "coarse": agree,
               "initial_correspondence_agreement": equal_share("initial_correspondences"),
               "fine_correspondence_agreement": equal_share("correspondences"),
               "fine_agreement_from_the_same_initial": equal_share(
                   "correspondences", g_fine, same_init),
               "smoothed_target_max_diff_same_initial": float(
                   (g_fine["smoothed_target_coords"].cpu()
                    - same_init["smoothed_target_coords"]).abs().max()),
               "cuda_s": g_s, "cpu_s": c_s}
        gates += [(cpu["fine_correspondence_agreement"] >= CORR_AGREE_MIN,
                   "multires fine correspondences CUDA vs CPU"),
                  (cpu["fine_agreement_from_the_same_initial"] >= SAME_COST_AGREE_MIN,
                   "multires refine CUDA vs CPU from the same initial correspondences")]
    emit({"phase": "multires", "config": "bench.py:122-134", "nvidia_smi": smi,
          **main, "multi_level": multi, "routes": routes_small,
          "cuda_vs_cpu": cpu, "phase_s": time.perf_counter() - t_phase})
    if cpu is not None:
        agreement_checks(cpu["coarse"], "multires coarse CUDA vs CPU")
    for ok, what in gates:
        check(ok, what)
    return launches, refine_args


def topology_equal(a, b) -> bool:
    """Whether two ``MeshTopology`` are equal field for field (dtypes,
    shapes, values)."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def host_timed(fn):
    """(fn(), its seconds on the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_native(tp, smi, levels=NATIVE_LEVELS, coarse_n=MULTIRES_COARSE_N,
                 lap_sizes=NATIVE_LAP_SIZES):
    """The host library (``native.py``, ``csrc/host/*.cpp``, built with g++
    at first use): its build seconds, then at ``levels`` (655362 vertices)
    ``build_topology`` against ``build_topology_plain`` and ``decimate``
    (to ``coarse_n``, from the fine edges, as ``register_pair_multires``
    calls it) against ``decimate_plain``, each pair byte-equal and timed;
    ``lap_host`` against ``lap_host_plain`` on uniform costs at
    ``lap_sizes`` (equal assignments); and a .vtk ASCII round trip of the
    mesh through the C++ and the python parsers (equal arrays)."""
    from pyfocusr_tpu_torch import mesh as TM
    from pyfocusr_tpu_torch import multires, native
    from pyfocusr_tpu_torch.io import vtk_io
    from pyfocusr_tpu_torch.ops import assignment as TA

    t_phase = time.perf_counter()
    _, load_s = host_timed(native.get_lib)
    compiler = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                              check=True).stdout.splitlines()[0]
    mesh = synthetic_bone(tp, 2, levels)
    n = mesh.n_points
    tris = np.asarray(mesh.triangles)
    topo, topo_s = host_timed(lambda: TM.build_topology(tris, n))
    topo_plain, topo_plain_s = host_timed(lambda: TM.build_topology_plain(tris, n))
    dec, dec_s = host_timed(lambda: multires.decimate(mesh, coarse_n, 0, edges=topo.edges))
    dec_plain, dec_plain_s = host_timed(
        lambda: multires.decimate_plain(mesh, coarse_n, 0, edges=topo.edges))
    dec_equal = (np.array_equal(dec[0].points, dec_plain[0].points)
                 and np.array_equal(dec[0].triangles, dec_plain[0].triangles)
                 and np.array_equal(dec[1], dec_plain[1])
                 and np.array_equal(dec[2], dec_plain[2]))
    laps = {}
    for size in lap_sizes:
        cost = np.random.default_rng(size).uniform(0.0, 1.0, (size, size))
        (_, col), lap_s = host_timed(lambda: TA.lap_host(cost))
        (_, col_plain), lap_plain_s = host_timed(lambda: TA.lap_host_plain(cost))
        laps[str(size)] = {"native_s": lap_s, "plain_s": lap_plain_s,
                           "equal": bool(np.array_equal(col, col_plain))}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bone.vtk")
        _, write_s = host_timed(lambda: tp.save_mesh(path, mesh))
        with open(path, "rb") as f:
            raw = f.read()
        parsed, parse_s = host_timed(lambda: vtk_io._read_ascii_native(raw))
        parsed_plain, parse_plain_s = host_timed(
            lambda: vtk_io._read_ascii(raw.decode("ascii", errors="replace")))
        loaded, load_mesh_s = host_timed(lambda: tp.load_mesh(path))
    parse_equal = (all(np.array_equal(a, b) for a, b in zip(parsed[:2], parsed_plain[:2]))
                   and sorted(parsed[2]) == sorted(parsed_plain[2])
                   and all(np.array_equal(parsed[2][k], parsed_plain[2][k])
                           for k in parsed_plain[2]))
    emit({"phase": "native", "nvidia_smi": smi, "compiler": compiler,
          "build_s": native.build_seconds(), "load_s": load_s, "n": n,
          "build_topology": {"native_s": topo_s, "plain_s": topo_plain_s,
                             "equal": topology_equal(topo, topo_plain)},
          "decimate": {"coarse_n": coarse_n, "n_coarse": dec[0].n_points,
                       "native_s": dec_s, "plain_s": dec_plain_s, "equal": dec_equal},
          "lap_host": laps,
          "vtk_ascii": {"bytes": len(raw), "save_mesh_s": write_s, "native_s": parse_s,
                        "plain_s": parse_plain_s, "load_mesh_s": load_mesh_s,
                        "equal": parse_equal},
          "phase_s": time.perf_counter() - t_phase})
    check(topology_equal(topo, topo_plain), f"build_topology native vs plain at {n}")
    check(dec_equal, f"decimate native vs plain at {n}")
    check(all(r["equal"] for r in laps.values()), f"lap_host native vs plain: {laps}")
    check(parse_equal and loaded.n_points == n, "the .vtk ASCII parse native vs python")


def warped_bone(tp, levels, amp, phase):
    """The seed-2 bone scaled by 1 + amp sin(0.08 z + phase): one anatomy
    under a smooth axial warp (z in mm)."""
    m = synthetic_bone(tp, 2, levels)
    p = np.asarray(m.points, np.float64)
    p = p * (1.0 + amp * np.sin(0.08 * p[:, [2]] + phase))
    return tp.TriMesh(p.astype(np.float32), m.triangles, {})


def scrambled_map(corr, j, i, n_real, share, seed=0):
    """``corr`` with ``share`` of map j -> i's real rows permuted among
    themselves (``register_all_pairs``' layout)."""
    rng = np.random.default_rng(seed)
    bad = corr.copy()
    rows = rng.permutation(n_real)[: int(share * n_real)]
    bad[j, i, rows] = corr[j, i, rng.permutation(rows)]
    return bad


def phase_groupwise(torch, tp, kernels, smi, device="cuda", levels=5,
                    cpu_levels=CPU_CHECK_LEVELS, cpu_check=True, cfg_kw=BENCH_CFG):
    """``parallel/groupwise.py`` on ``device`` at the bench configuration:
    ``register_pair_symmetric`` on the seed-2 / seed-1 pair at ``levels``
    (10242 vertices); ``register_all_pairs`` on the ``GROUPWISE_WARPS``
    subjects (12 pairs), first call and warm, launches of each; the
    three-cycle error, ``synchronize_correspondences``, and
    ``synchronize_spectral`` on the clean maps (nothing may be flagged, the
    maps come back unchanged) and with one map's rows scrambled (it must be
    flagged and repaired, the others left alone), at
    ``GROUPWISE_OUTLIER_FACTOR``; CUDA against CPU on the
    symmetric pair at ``cpu_levels`` with the same draws.  Returns the warm
    ``register_all_pairs`` call's launches."""
    from pyfocusr_tpu_torch.parallel import groupwise as G

    t_phase = time.perf_counter()
    cfg = tp.PipelineConfig(**cfg_kw)
    on_card = torch.device(device).type == "cuda"
    gates = []
    out = {"phase": "groupwise", "nvidia_smi": smi, "config": "bench.py:122-134"}

    def run(fn):
        sync(torch, device)
        for mod in kernels.values():
            mod.LAUNCHES = 0
        res, secs = timed(torch, fn, device)
        return res, secs, {k: m.LAUNCHES for k, m in kernels.items()}

    # --- The symmetric pair ---
    tg = tp.mesh_to_graph_arrays(synthetic_bone(tp, 2, levels), device=device)
    sg = tp.mesh_to_graph_arrays(synthetic_bone(tp, 1, levels), device=device)
    sym_draws = G.make_symmetric_draws(0, cfg, tg, sg)
    sym, sym_s, sym_launches = run(lambda: G.register_pair_symmetric(tg, sg, cfg,
                                                                     draws=sym_draws))
    n_s = sg.n_points
    out["symmetric"] = {
        "n": n_s, "s": sym_s, "launches": sym_launches,
        "fb_consistency_mm": float(sym["fb_consistency"]),
        "cycle_error_mm": float(sym["cycle_error"]),
        "sym_unique_fraction": len(torch.unique(sym["sym_correspondences"])) / n_s,
        "sym_vs_forward_agreement": float((sym["sym_correspondences"]
                                           == sym["forward"]["correspondences"])
                                          .float().mean())}
    if on_card:
        gates.append((sym_launches["knn"] > 0 and sym_launches["umeyama3"] > 0,
                      f"register_pair_symmetric launched {sym_launches}"))
    gates.append((np.isfinite(out["symmetric"]["fb_consistency_mm"])
                  and out["symmetric"]["sym_unique_fraction"] > 0.5,
                  f"symmetric pair diagnostics {out['symmetric']}"))
    del sym, tg, sg

    # --- All pairs of four subjects, first call and warm ---
    subjects = [warped_bone(tp, levels, a, ph) for a, ph in GROUPWISE_WARPS]
    graphs = tp.pad_cohort(subjects, device=device)
    draws = G.make_all_pairs_draws(1, cfg, graphs)
    calls = []
    for _ in range(2):
        (corr, pair_index, results), secs, launches = run(
            lambda: G.register_all_pairs(graphs, cfg, draws=draws))
        calls.append({"s": secs, "launches": launches})
    n_pairs = len(pair_index)
    n_real = [m.n_points for m in subjects]
    unique = [len(np.unique(corr[j, i, : n_real[j]])) / n_real[j] for i, j in pair_index]
    warm = calls[1]
    out["all_pairs"] = {"subjects": len(subjects), "n": n_real[0], "pairs": n_pairs,
                        "first_s": calls[0]["s"], "warm_s": warm["s"],
                        "pairs_per_s": n_pairs / warm["s"], "s_per_pair": warm["s"] / n_pairs,
                        "launches_first": calls[0]["launches"], "launches": warm["launches"],
                        "min_unique_fraction": min(unique)}
    if on_card:
        gates.append((warm["launches"]["knn"] > 0 and warm["launches"]["umeyama3"] > 0,
                      f"register_all_pairs launched {warm['launches']}"))
    gates.append((min(unique) > 0.5, f"all-pairs unique fractions {unique}"))
    del results

    # --- The synchronizations ---
    points = [g.points[:n] for g, n in zip(graphs, n_real)]
    cyc, cyc_s = host_timed(lambda: G.cycle_consistency_error(corr, points, n_real))
    synced, sync_s, sync_launches = run(
        lambda: G.synchronize_correspondences(corr, points, n_real))
    cyc_synced = G.cycle_consistency_error(synced, points, n_real)
    blocks = G.make_basis_blocks(2, cfg, graphs, GROUPWISE_N_BASIS)
    (clean, info), spec_s, spec_launches = run(lambda: G.synchronize_spectral(
        corr, graphs, cfg, n_basis=GROUPWISE_N_BASIS, blocks=blocks,
        outlier_factor=GROUPWISE_OUTLIER_FACTOR))
    bad = scrambled_map(corr, 0, 1, n_real[0], GROUPWISE_SCRAMBLED_SHARE)
    (fixed, info_bad), bad_s, bad_launches = run(lambda: G.synchronize_spectral(
        bad, graphs, cfg, n_basis=GROUPWISE_N_BASIS, blocks=blocks,
        outlier_factor=GROUPWISE_OUTLIER_FACTOR))
    off = info["residuals"][~np.eye(len(graphs), dtype=bool)]
    pts1 = points[1].cpu().numpy()
    rows = slice(0, n_real[0])
    repaired_mm = float(np.linalg.norm(pts1[fixed[0, 1, rows]] - pts1[corr[0, 1, rows]],
                                       axis=1).mean())
    scrambled_mm = float(np.linalg.norm(pts1[bad[0, 1, rows]] - pts1[corr[0, 1, rows]],
                                        axis=1).mean())
    untouched = fixed.copy()
    untouched[info_bad["flagged"]] = bad[info_bad["flagged"]]
    out["synchronize"] = {
        "cycle_error_mm": cyc, "cycle_error_s": cyc_s,
        "correspondences_s": sync_s, "correspondences_launches": sync_launches,
        "cycle_error_after_mm": cyc_synced,
        "spectral_clean_s": spec_s, "spectral_clean_launches": spec_launches,
        "outlier_factor": GROUPWISE_OUTLIER_FACTOR,
        "residuals_clean": info["residuals"].tolist(),
        "residual_max_over_median_clean": float(off.max() / np.median(off)),
        "flagged_clean": int(info["flagged"].sum()),
        "flagged_clean_at_default_factor": int((off > 1.3 * np.median(off)).sum()),
        "spectral_scrambled_s": bad_s,
        "residuals_scrambled": info_bad["residuals"].tolist(),
        "flagged_scrambled": np.argwhere(info_bad["flagged"]).tolist(),
        "repaired_map_mean_mm_from_clean": repaired_mm,
        "scrambled_map_mean_mm_from_clean": scrambled_mm,
        "cycle_error_scrambled_mm": G.cycle_consistency_error(bad, points, n_real),
        "cycle_error_repaired_mm": G.cycle_consistency_error(fixed, points, n_real)}
    if on_card:
        gates.append((sync_launches["knn"] > 0,
                      f"synchronize_correspondences launched {sync_launches}"))
    gates += [
        (not info["flagged"].any() and np.array_equal(clean, corr),
         f"synchronize_spectral flagged clean maps: {info['flagged'].tolist()}"),
        (bool(info_bad["flagged"][0, 1]) and repaired_mm < 0.5 * scrambled_mm,
         f"the scrambled map was not flagged and repaired: {out['synchronize']}"),
        (np.array_equal(untouched, bad), "synchronize_spectral changed unflagged maps"),
    ]

    # --- CUDA against CPU on the symmetric pair, CPD stopping at 1e-6 ---
    if cpu_check and on_card:
        ccfg = tp.PipelineConfig(**dict(cfg_kw, non_rigid_tolerance=FEATURE_CHECK_TOLERANCE))
        pair = [tp.mesh_to_graph_arrays(synthetic_bone(tp, s, cpu_levels), device="cpu")
                for s in (2, 1)]
        d = {k: tp.pipeline.host_draws(v)
             for k, v in G.make_symmetric_draws(0, ccfg, *pair).items()}
        runs = {}
        for dev in (device, "cpu"):
            runs[dev] = timed(torch, lambda: G.register_pair_symmetric(
                pair[0].to(dev), pair[1].to(dev), ccfg, draws=d), dev)
        g, c = runs[device][0], runs["cpu"][0]
        out["cuda_vs_cpu"] = {
            "n": pair[1].n_points, "cuda_s": runs[device][1], "cpu_s": runs["cpu"][1],
            "forward": compare_runs(g["forward"], to_cpu(c["forward"])),
            "backward": compare_runs(g["backward"], to_cpu(c["backward"])),
            "sym_correspondence_agreement": float(
                (g["sym_correspondences"].cpu() == c["sym_correspondences"]).float().mean()),
            "fb_consistency_mm": [float(g["fb_consistency"]), float(c["fb_consistency"])]}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if "cuda_vs_cpu" in out:
        for side in ("forward", "backward"):
            agreement_checks(out["cuda_vs_cpu"][side], f"symmetric pair {side} CUDA vs CPU")
        check(out["cuda_vs_cpu"]["sym_correspondence_agreement"] >= CORR_AGREE_MIN,
              "symmetric correspondences CUDA vs CPU")
    for ok, what in gates:
        check(ok, what)
    return warm["launches"]


def jittered_cohort(tp, mesh, n: int, scale: float):
    """``n`` copies of ``mesh``, each point moved by normal noise of
    ``scale`` mm from one ``default_rng(0)`` stream (bench.py:661-667)."""
    rng = np.random.default_rng(0)
    base = np.asarray(mesh.points, np.float32)
    return [mesh.with_points(base + rng.normal(scale=scale, size=base.shape)
                             .astype(np.float32)) for _ in range(n)]


def unpadded_draws(draws, n_real: int, device):
    """A padded pair's draws as the unpadded pair's: the index draws and
    ``cpd_omega`` as they are (they index real rows), each per-vertex
    target draw cut to the real rows (a deferred one drawn on ``device``
    first, as the padded pair on ``device`` draws it)."""
    out = dict(draws)
    for name in ("eig_block_target", "eig_start_target"):
        if name in out:
            v = out[name]
            out[name] = (v.draw(device) if hasattr(v, "draw") else v)[:n_real]
    return out


def stage_totals(stages):
    """Host and device ms of each ``register_pair`` stage, summed over
    the pairs of a profiled call."""
    out = {}
    for st in stages:
        acc = out.setdefault(st["stage"], {"host_ms": 0.0, "device_ms": 0.0, "count": 0})
        acc["host_ms"] += st["host_ms"]
        acc["device_ms"] += st["device_ms"]
        acc["count"] += 1
    return out


def phase_cohort(torch, tp, kernels, smi, deterministic, device="cuda", levels=5,
                 n_subjects=COHORT_SUBJECTS, warm_reps=COHORT_WARM_REPS,
                 rounds=COHORT_ROUNDS, decimate_targets=COHORT_DECIMATE_TARGETS,
                 cfg_kw=COHORT_CFG, cpu_check=True, profile=True):
    """Cohort registration (``parallel.cohort``) at bench.py's cohort size:
    the seed-2 bone at 10242 vertices as the template, ``n_subjects``
    copies of the seed-1 bone jittered by 0.3 mm as subjects, ``ccfg``.
    ``register_cohort`` hoists the template's solve and registers each
    subject: the first call, ``warm_reps`` warm calls with the kernels'
    launch counts set to 0 just before each and read just after, a plain
    'kd' pair of the same process, peak memory, one warm call under the
    profiler (device idle share).  Gates: every lane equals
    ``register_pair_prepared_source`` on its subject and draws bit for bit
    when two plain calls do (else the CUDA-vs-CPU gates); the unique
    fraction of every lane >= 0.6.  Then a padded cohort (four of the
    subjects and four decimations of the subject's next subdivision, padded
    to 10242): each padded lane against the same subject unpadded on its
    real rows, and one padded lane on the CPU at CPD stop 1e-6, under the
    CUDA-vs-CPU gates; ``iterate_template`` for ``rounds`` rounds with
    Procrustes (the last round's motion below the first's, the round files
    load with numpy); the SSM of its last round (an in-sample shape
    reconstructed within 1e-3 mm RMS); ``all_pairs_surface_errors`` on
    the four decimated subjects.  Returns the warm call's launches.

    Rehearsed on the CPU at 642 vertices (``device="cpu", levels=3``, a
    ``cfg_kw`` with subsamples of at most 600 points and
    ``decimate_targets`` of 300-450, ``cpu_check=False,
    profile=False``), where no kernel launches."""
    t_phase = time.perf_counter()
    cfg = tp.PipelineConfig(**cfg_kw)
    template_mesh = synthetic_bone(tp, 2, levels)
    subject = synthetic_bone(tp, 1, levels)
    subjects = jittered_cohort(tp, subject, n_subjects, COHORT_JITTER_MM)
    template = tp.mesh_to_graph_arrays(template_mesh, device=device)
    graphs = [tp.mesh_to_graph_arrays(m, device=device) for m in subjects]
    targets = tp.stack_graph_arrays(graphs)
    n_s = template.n_points
    draws = tp.make_cohort_draws(0, cfg, template, targets)

    def cohort():
        return tp.register_cohort(template, targets, cfg, draws=draws)

    (res, mean), first_s = timed(torch, cohort, device)
    peak = None
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(warm_reps):
        for mod in kernels.values():
            mod.LAUNCHES = 0
        (res, mean), secs = timed(torch, cohort, device)
        warm.append(secs)
        launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    if device == "cuda":
        peak = torch.cuda.max_memory_allocated()
    check(device != "cuda" or (launches["knn"] > 0 and launches["umeyama3"] > 0),
          f"register_cohort launched {launches}")
    check(tuple(mean.shape) == (n_s, 3) and bool(mean.isfinite().all()),
          "cohort mean shape")
    warm_s = statistics.median(warm)

    # A plain 'kd' pair of the same process, warm, beside the per-pair time.
    plain = lambda: tp.register_pair(graphs[0], template, cfg, draws=draws["pairs"][0])
    plain()
    _, plain_s = timed(torch, plain, device)

    # Every lane against register_pair_prepared_source on its own draws and
    # its own generator (``lane_generator``, as register_cohort gives it).
    from pyfocusr_tpu_torch.parallel.cohort import lane_generator

    prep = tp.prepare_source(template, cfg, draws["template_block"],
                             generator=lane_generator({"template_block":
                                                       draws["template_block"]}))
    lane_diffs = []
    for i, g in enumerate(graphs):
        one = tp.register_pair_prepared_source(prep, g, template, cfg,
                                               generator=lane_generator(draws["pairs"][i]),
                                               draws=draws["pairs"][i])
        lane = {k: v[i] for k, v in res.items()}
        diff = outputs_differ(torch, one, lane)
        if diff and not deterministic:
            agreement_checks(compare_runs(one, to_cpu(lane)), f"cohort lane {i}")
        lane_diffs.append(diff)
    if deterministic:
        check(not any(lane_diffs), f"cohort lanes differ from their pairs: {lane_diffs}")
    quality = [quality_and_checks(tp, subjects[i], template_mesh,
                                  {k: v[i] for k, v in res.items()}, n_s,
                                  min_unique=None) for i in range(n_subjects)]
    min_unique = min(q["unique_fraction"] for q in quality)
    check(min_unique >= COHORT_MIN_UNIQUE, f"cohort unique fraction {min_unique}")
    prof = None
    if profile and device == "cuda":
        prof = profile_call(torch, cohort, smi, "profile_cohort", "profile_cohort.txt")
        prof["stage_totals"] = stage_totals(prof.pop("stages"))
    del res, prep

    # --- The padded cohort: four of the subjects and four decimations.
    fine = synthetic_bone(tp, 1, levels + 1)
    small = [tp.decimate(fine, tn, seed=k + 1)[0] for k, tn in enumerate(decimate_targets)]
    p_meshes = subjects[:len(subjects) - len(small)] + small
    p_graphs = tp.pad_cohort(p_meshes, device=device)
    p_targets = tp.stack_graph_arrays(p_graphs)
    n_pad = p_targets.points.shape[1]
    reals = [m.n_points for m in p_meshes]
    check(n_pad == max(reals) and min(reals) < n_pad, f"padded cohort sizes {reals}")
    p_draws = tp.make_cohort_draws(1, cfg, template, p_targets)
    (p_res, _), p_s = timed(torch, lambda: tp.register_cohort(
        template, p_targets, cfg, draws=p_draws), device)
    p_prep = tp.prepare_source(template, cfg, p_draws["template_block"],
                               generator=lane_generator({"template_block":
                                                         p_draws["template_block"]}))
    padded_vs_unpadded = []
    for i, (m, real) in enumerate(zip(p_meshes, reals)):
        if real == n_pad:
            continue
        alone = tp.register_pair_prepared_source(
            p_prep, tp.mesh_to_graph_arrays(m, device=device), template, cfg,
            generator=lane_generator(p_draws["pairs"][i]),
            draws=unpadded_draws(p_draws["pairs"][i], real, device))
        lane = real_rows({k: v[i] for k, v in p_res.items()}, real, n_s)
        check(int(lane["correspondences"].max()) < real,
              f"padded lane {i} corresponds to a padding row")
        agree = compare_runs(lane, to_cpu(alone))
        agree.update(lane=i, n_real=real,
                     quality=quality_and_checks(tp, m, template_mesh, lane, n_s,
                                                min_unique=None))
        padded_vs_unpadded.append(agree)
        agreement_checks(agree, f"padded cohort lane {i} vs unpadded")
    p_min_unique = min(a["quality"]["unique_fraction"] for a in padded_vs_unpadded)
    check(p_min_unique >= COHORT_MIN_UNIQUE, f"padded unique fraction {p_min_unique}")

    cuda_vs_cpu = None
    if cpu_check:
        i = reals.index(min(reals))
        ccfg = tp.PipelineConfig(**dict(cfg_kw, non_rigid_tolerance=COHORT_CHECK_TOLERANCE))

        host = tp.pipeline.host_draws(dict(p_draws["pairs"][i],
                                           template_block=p_draws["template_block"]))
        block = host.pop("template_block")

        def padded_lane(dev):
            t = template.to(dev)
            pre = tp.prepare_source(t, ccfg, block)
            return tp.register_pair_prepared_source(
                pre, p_graphs[i].to(dev), t, ccfg, draws=host)

        gpu = padded_lane(device)
        t0 = time.perf_counter()
        cpu = padded_lane("cpu")
        cuda_vs_cpu = compare_runs(gpu, cpu)
        cuda_vs_cpu.update(lane=i, n_real=reals[i], cpu_s=time.perf_counter() - t0)
        agreement_checks(cuda_vs_cpu, f"padded lane {i} CUDA vs CPU")
    del p_res, p_prep

    # --- iterate_template with Procrustes, its round files, and the SSM.
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        (_, it_res, motions), it_s = timed(torch, lambda: tp.iterate_template(
            template, targets, cfg, generator=torch.Generator().manual_seed(0),
            n_iterations=rounds, checkpoint_dir=tmp), device)
        files = sorted(os.listdir(tmp))
        loaded = []
        for name in files:
            with np.load(os.path.join(tmp, name)) as z:
                loaded.append({"file": name, "keys": sorted(z.files),
                               "points": list(z["points"].shape),
                               "motion": z["motion"].tolist()})
    check(files == [f"template_round_{r + 1:03d}.npz" for r in range(len(motions))]
          and all(f["keys"] == ["motion", "points"] for f in loaded),
          f"template round files {loaded}")
    check(len(motions) == rounds and motions[-1] < motions[0],
          f"iterate_template motions {motions}")
    mean_ssm, modes, variances = tp.cohort_shape_modes(it_res["weighted_points"])
    coeffs, recon, rms = tp.ssm_project(it_res["weighted_points"][0], mean_ssm, modes,
                                        variances)
    rms = float(rms)
    check(rms <= SSM_RECON_RMS_MAX_MM, f"SSM in-sample reconstruction RMS {rms} mm")
    sample = tp.ssm_sample(mean_ssm, modes, variances, b=coeffs)
    sample_rms = float(((sample - recon) ** 2).sum(dim=1).mean().sqrt())
    errs, ap_s = timed(torch, lambda: tp.all_pairs_surface_errors(
        small, device=device), device)
    off = errs[~np.eye(len(small), dtype=bool)]
    check(bool(np.all(np.isfinite(off)) and np.all(off > 0) and np.all(np.diag(errs) == 0)),
          f"all_pairs_surface_errors {errs.tolist()}")
    emit({
        "phase": "cohort", "nvidia_smi": smi, "config": "bench.py:670-676 (ccfg)",
        "n_template": n_s, "n_subjects": n_subjects, "jitter_mm": COHORT_JITTER_MM,
        **warm_summary(first_s, warm),
        "pairs_per_s": n_subjects / warm_s, "per_pair_s": warm_s / n_subjects,
        "plain_pair_s": plain_s, "launches": launches,
        "knn_per_pair": launches["knn"] / n_subjects,
        "umeyama3_per_pair": launches["umeyama3"] / n_subjects,
        "peak_device_bytes": peak,
        "lanes_equal_pairs": "bit for bit" if deterministic else "CUDA-vs-CPU gates",
        "lane_differing_keys": lane_diffs,
        "quality_min_unique": min_unique,
        "quality": quality[:2],
        "profile": prof,
        "padded": {"sizes": reals, "n_pad": n_pad, "seconds": p_s,
                   "vs_unpadded": padded_vs_unpadded},
        "padded_cuda_vs_cpu": cuda_vs_cpu,
        "iterate_template": {"rounds": rounds, "seconds": it_s, "motions": motions,
                             "files": loaded},
        "ssm": {"variances": variances.tolist(), "recon_rms_mm": rms,
                "sample_vs_recon_rms_mm": sample_rms},
        "all_pairs_surface_errors": {"sizes": [m.n_points for m in small],
                                     "seconds": ap_s, "mm": errs.tolist()},
        "phase_s": time.perf_counter() - t_phase,
    })
    return launches


def phase_wide_coords(torch, tp, kernels, smi, device="cuda", levels=5,
                      cpu_levels=CPU_CHECK_LEVELS, cpu_check=True):
    """Wide coordinates and the class API's output stage on ``device``:
    ``Focusr`` at the class defaults with ``WIDE_CFG`` (16 spectral
    features and xyz: D = 19) on the ``levels`` pair, ``align_maps()``,
    then ``get_weighted_final_node_locations`` at each k of ``WIDE_KS``,
    ``transfer_point_data`` of the target's thickness, and the average
    shape carrying it through ``save_mesh`` / ``load_mesh`` in .vtk and
    .vtp; first call and warm, the launch counts set to 0 before each and
    read after.  Checks: the initial correspondences took the tiled route
    (``ops/knn.nn_tiled``) at D = 19 and nothing else did; both CPD runs
    took the streamed E-step at D = 19; each k's locations equal the plain
    k-NN's (``knn_plain`` + ``idw_from_knn`` on the same inputs) bit for
    bit; the transfer equals the same transfer on the CPU; the round trip
    gives back the points (.vtp exactly, .vtk within its 10 digits) and the
    transferred scalar.  On the card, CUDA against CPU at ``cpu_levels``
    under ``WIDE_CHECK_CFG`` and the 'kd' gates.  Returns the warm run's
    launches."""
    from pyfocusr_tpu_torch.ops import cpd as cpd_ops
    from pyfocusr_tpu_torch.ops import knn as knn_ops
    from pyfocusr_tpu_torch.ops import knn_kernel

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    target, source = synthetic_bone(tp, 2, levels), synthetic_bone(tp, 1, levels)
    d_wide = WIDE_CFG["n_spectral_features"] + 3
    out = {"phase": "wide_coords", "nvidia_smi": smi, "n": source.n_points,
           "config": "Focusr class defaults (pyfocusr_tpu/focusr.py:48-94) with "
                     f"{WIDE_CFG}", "d": d_wide}
    tiled = []
    real_nn, real_knn = knn_ops.nn_tiled, knn_ops.knn_tiled

    def nn_tiled(ref, query, *a, **kw):
        tiled.append(("nn", ref.shape[1]))
        return real_nn(ref, query, *a, **kw)

    def knn_tiled(ref, query, k, *a, **kw):
        tiled.append(("knn", ref.shape[1]))
        return real_knn(ref, query, k, *a, **kw)

    knn_ops.nn_tiled, knn_ops.knn_tiled = nn_tiled, knn_tiled
    runs = []
    tmp = tempfile.mkdtemp(prefix="wide_coords_")
    try:
        for _ in range(2):
            tiled.clear()
            sync(torch, device)
            for mod in kernels.values():
                mod.LAUNCHES = 0
            t0 = time.perf_counter()
            with CpdRecorder(cpd_ops) as rec, contextlib.redirect_stdout(io.StringIO()):
                reg = tp.Focusr(target, source, device=device, **WIDE_CFG)
                reg.align_maps()
                sync(torch, device)
                align_s = time.perf_counter() - t0
                weighted = {}
                for k in WIDE_KS:
                    reg.get_weighted_final_node_locations(n_closest_pts=k)
                    weighted[k] = reg.weighted_avg_transformed_points
                transferred = reg.transfer_point_data()
                avg = tp.mesh_with_transferred_data(
                    reg.get_average_shape(), target,
                    {"correspondences": reg.corresponding_target_idx_for_each_source_pt,
                     "smoothed_target_coords": reg.smoothed_target_coords,
                     "source_projected_on_target": reg.source_projected_on_target},
                    names=[FEATURE], suffix="_from_target", device=device)
                loaded = {}
                for ext in (".vtk", ".vtp"):
                    path = os.path.join(tmp, f"average{ext}")
                    tp.save_mesh(path, avg)
                    loaded[ext] = tp.load_mesh(path)
            sync(torch, device)
            runs.append({"s": time.perf_counter() - t0, "align_maps_s": align_s,
                         "outputs_s": time.perf_counter() - t0 - align_s,
                         "stages_s": reg.timer.totals(),
                         "launches": {k: m.LAUNCHES for k, m in kernels.items()},
                         "tiled_route": list(tiled),
                         "cpd_affine": rec.affine_runs, "cpd_deformable": rec.runs,
                         "quality": reg.registration_quality()})
    finally:
        knn_ops.nn_tiled, knn_ops.knn_tiled = real_nn, real_knn
    out["first"], out["warm"] = runs
    warm = runs[1]
    check(tuple(reg.source_spectral_coords.shape) == (source.n_points, d_wide),
          f"wide coordinates: {tuple(reg.source_spectral_coords.shape)}")
    check(("nn", d_wide) in warm["tiled_route"]
          and all(d > knn_kernel.MAX_D for _, d in warm["tiled_route"]),
          f"the tiled k-NN route ran where JAX's would not: {warm['tiled_route']}")
    n_cpd = min(5000, source.n_points)
    route = "streamed" if n_cpd * n_cpd > 3000 * 3000 else "dense"
    check(warm["cpd_affine"][-1]["estep_impl"] == route
          and warm["cpd_deformable"][-1]["estep_impl"] == route,
          f"the wide path's CPD did not take the {route} E-step: {warm}")
    if on_card:
        check(warm["launches"]["knn_topk"] == len(WIDE_KS),
              f"the weighted locations at k = {WIDE_KS} launched {warm['launches']}")
        for name in ("knn", "umeyama3", "cpd_estep"):
            check(warm["launches"][name] > 0, f"the wide path launched no {name} kernel")
        if route == "streamed":
            check(estep_launches_fit(warm["launches"]["cpd_estep"], rec, cpd_ops),
                  f"wide E-step launches {warm['launches']['cpd_estep']} outside [2 x, 2 x "
                  f"(EM iterations {rec.streamed_loops()} + a block a loop))")
    check(warm["quality"]["unique_fraction"] > 0.5, f"wide path quality {warm['quality']}")

    # The path's outputs held to plain versions on the same inputs.
    ref_q, query = reg.smoothed_target_coords, reg.source_projected_on_target
    same_weighted = {}
    for k, w in weighted.items():
        check(tuple(w.shape) == (source.n_points, 3) and bool(torch.isfinite(w).all()),
              f"weighted locations at k = {k}")
        pd, pi = knn_kernel.knn_plain(ref_q.contiguous(), query.contiguous(), k)
        plain = knn_ops.idw_from_knn(pd, pi.long(), reg.graph_target.points)
        same_weighted[str(k)] = bool(torch.equal(w, plain))
    geometry = {"correspondences": reg.corresponding_target_idx_for_each_source_pt,
                "smoothed_target_coords": ref_q.cpu(),
                "source_projected_on_target": query.cpu()}
    tgt_cpu = target.with_points(np.asarray(target.points))
    cpu_transfer = tp.transfer_point_data(tgt_cpu, geometry, device="cpu")
    nearest = reg.transfer_point_data(method="nearest")
    transfer_diff = {name: float(np.abs(transferred[name] - cpu_transfer[name]).max())
                     for name in transferred}
    io_check = {}
    for ext, m in loaded.items():
        pts = avg.points.cpu().numpy()
        io_check[ext] = {
            "points_max_abs_diff": float(np.abs(m.points - pts).max()),
            "triangles_equal": bool(np.array_equal(m.triangles, np.asarray(avg.triangles))),
            "scalar_max_abs_diff": float(np.abs(
                m.point_data[FEATURE + "_from_target"]
                - np.asarray(avg.point_data[FEATURE + "_from_target"])).max())}
    out["checks"] = {"weighted_equal_plain": same_weighted, "transfer_max_abs_diff_vs_cpu":
                     transfer_diff, "io": io_check}
    check(all(same_weighted.values()), f"weighted locations vs plain: {same_weighted}")
    thick = np.asarray(target.point_data[FEATURE])
    check(np.array_equal(nearest[FEATURE],
                         thick[reg.corresponding_target_idx_for_each_source_pt]),
          "'nearest' transfer is the corresponding target vertices' scalar")
    check(all(v <= 1e-6 * max(1.0, float(np.abs(thick).max()))
              for v in transfer_diff.values()),
          f"transfer on {device} vs the CPU: {transfer_diff}")
    check(io_check[".vtp"]["points_max_abs_diff"] == 0.0
          and io_check[".vtp"]["scalar_max_abs_diff"] == 0.0
          and all(c["triangles_equal"] for c in io_check.values())
          and io_check[".vtk"]["points_max_abs_diff"] <= 1e-6 * float(np.abs(pts).max())
          and io_check[".vtk"]["scalar_max_abs_diff"] <= 1e-6 * max(1.0, float(np.abs(thick).max())),
          f"save_mesh / load_mesh round trip: {io_check}")

    if on_card and cpu_check:
        small_t = synthetic_bone(tp, 2, cpu_levels)
        small_s = synthetic_bone(tp, 1, cpu_levels)
        rr = {dev: focusr_run(torch, tp, kernels, small_t, small_s, dev, **WIDE_CHECK_CFG)
              for dev in (device, "cpu")}
        agree = compare_runs(focusr_result(torch, rr[device][0]),
                             focusr_result(torch, rr["cpu"][0]))
        out["cuda_vs_cpu"] = {"n": small_s.n_points, "config": WIDE_CHECK_CFG,
                              **{f"{dev}_s": r[1] for dev, r in rr.items()}, **agree}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if "cuda_vs_cpu" in out:
        agreement_checks(out["cuda_vs_cpu"], f"wide coordinates CUDA vs CPU ({cpu_levels})")
    return warm["launches"]


# --- The command line (``pyfocusr_tpu_torch/cli.py``) and the serving
# artifacts (``utils/aot.py``) -------------------------------------------

# The config fields the CLI's registering subcommands set by flag.
CLI_FIELDS = ("n_spectral_features", "n_extra_spectral", "non_rigid_alpha",
              "non_rigid_beta", "non_rigid_max_iterations", "non_rigid_n_eigens",
              "graph_smoothing_iterations", "projection_smooth_iterations",
              "n_coords_spectral_registration", "n_coords_spectral_ordering")
# The small bones' seeds: the cohort's template and three subjects (the
# SSM's four meshes), then the SSM's held-out mesh.
CLI_SMALL_SEEDS = (2, 1, 3, 4, 5)
CLI_LANDMARKS = 10
CLI_COHORT_MIN_UNIQUE = 0.5
# ``register --multires``: an intermediate level (10242 > 2 x 2500) and
# JAX's bound on its unique fraction (tests/test_cli.py:66).
CLI_MULTIRES_LEVEL_RATIO = 2.0
CLI_MULTIRES_MIN_UNIQUE = 0.4


def cli_flags(tp, cfg_kw):
    """The flags that make the CLI build ``PipelineConfig(**cfg_kw)``;
    fails where a field is neither a flag's nor at its default."""
    default = tp.PipelineConfig()
    for name, value in cfg_kw.items():
        check(name in CLI_FIELDS or getattr(default, name) == value,
              f"the CLI has no flag for {name}={value!r}")
    return [x for name in CLI_FIELDS if name in cfg_kw
            for x in ("--" + name.replace("_", "-"), str(cfg_kw[name]))]


def same_or_gates(torch, a, b, deterministic, what):
    """Two runs' correspondences: equal bit for bit where two plain calls
    on the card were (``deterministic``), else at the CUDA-vs-CPU gates.
    Returns the agreement."""
    a, b = (torch.as_tensor(x).long().cpu() for x in (a, b))
    check(a.shape == b.shape, f"{what}: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    agree = float((a == b).double().mean())
    if deterministic:
        check(agree == 1.0, f"{what}: not bit-equal ({agree})")
    else:
        check(agree >= CORR_AGREE_MIN, f"{what}: agreement {agree}")
        du = abs(len(torch.unique(a)) - len(torch.unique(b))) / a.shape[0]
        check(du <= UNIQUE_DIFF_MAX, f"{what}: unique fractions differ by {du}")
    return agree


def phase_cli(torch, tp, kernels, smi, deterministic, device="cuda", levels=5,
              small_levels=4):
    """Every subcommand of the port's CLI through ``cli.main`` in this
    process, on the 'kd' pair (``levels``: 10242 vertices) written to .vtk
    files, each invocation's kernel launches counted from 0: ``info``;
    ``convert`` .vtk -> .ply -> .vtk with equal arrays; ``register`` under
    the bench configuration, its correspondences against an in-process
    ``register_pair`` from the same generator (bit for bit where
    ``deterministic``, else the CUDA-vs-CPU gates); two sources with
    ``--save-prepared``, then ``--prepared`` (equal to the two-source run's
    pair) and a never-seen pair ``--warm-from`` the save; ``--html
    --quality --landmarks --features curvature --transfer-point-data``;
    all points in CPD; ``--multires`` with ``--level-ratio`` and
    ``--checkpoint-dir``, then the same invocation again, which resumes
    (the same correspondences; on the card the refine's k-NN launches and
    no ICP close); ``cohort`` (template + 3) and ``ssm`` (4 meshes, 2
    rounds, 2 samples, one projected, html) on the ``small_levels`` bones
    under the cohort configuration; ``warmup --export`` of a compiled
    artifact, whose sidecar proves the flags are the bench config.
    Returns the launches of all invocations by kernel."""
    from pyfocusr_tpu_torch import cli
    from pyfocusr_tpu_torch.utils import aot

    dev = [] if device == "cuda" else ["--device", device]
    bench = cli_flags(tp, BENCH_CFG) + dev
    runs = []

    def run(name, argv, expect_rc=0):
        sync(torch, device)
        for mod in kernels.values():
            mod.LAUNCHES = 0
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        sync(torch, device)
        runs.append({"name": name, "seconds": time.perf_counter() - t0, "rc": rc,
                     "launches": {k: m.LAUNCHES for k, m in kernels.items()}})
        check(rc == expect_rc, f"cli {name}: exit {rc}: {err.getvalue()[-800:]}")
        return out.getvalue()

    with tempfile.TemporaryDirectory(prefix="cli_") as d:
        f = {name: os.path.join(d, f"{name}.vtk") for name in ("t", "s", "s2")}
        for name, seed in (("t", 2), ("s", 1), ("s2", 3)):
            tp.save_mesh(f[name], synthetic_bone(tp, seed, levels=levels))
        small = [os.path.join(d, f"c{i}.vtk") for i in range(len(CLI_SMALL_SEEDS))]
        for path, seed in zip(small, CLI_SMALL_SEEDS):
            mesh = synthetic_bone(tp, seed, levels=small_levels)
            tp.save_mesh(path, mesh)
        n_small = mesh.n_points
        target, source = tp.load_mesh(f["t"]), tp.load_mesh(f["s"])
        n_t, n_s = target.n_points, source.n_points

        info = json.loads(run("info", ["info", f["t"]]))
        check(info["points"] == n_t and info["euler_characteristic"] == 2,
              f"cli info: {info}")
        run("convert_to_ply", ["convert", f["t"], os.path.join(d, "t.ply")])
        run("convert_to_vtk", ["convert", os.path.join(d, "t.ply"), os.path.join(d, "t2.vtk")])
        back = tp.load_mesh(os.path.join(d, "t2.vtk"))
        check(np.array_equal(back.points, target.points)
              and np.array_equal(back.triangles, target.triangles)
              and sorted(back.point_data) == sorted(target.point_data)
              and all(np.array_equal(back.point_data[k], v)
                      for k, v in target.point_data.items()),
              "cli convert: .vtk -> .ply -> .vtk changed the arrays")

        def corr(sub, stem=""):
            return np.load(os.path.join(d, sub, f"{stem}correspondences.npy"))

        summary = json.loads(run("register", ["register", f["t"], f["s"], "-o",
                                              os.path.join(d, "reg")] + bench))
        cfg = tp.PipelineConfig(**BENCH_CFG)
        on = "cpu" if device == "cpu" else None
        ref = tp.register_pair(tp.mesh_to_graph_arrays(target, device=on),
                               tp.mesh_to_graph_arrays(source, device=on), cfg,
                               generator=torch.Generator().manual_seed(0))
        agree = same_or_gates(torch, corr("reg"), ref["correspondences"], deterministic,
                              "cli register against register_pair")
        check(summary["n_source_points"] == n_s, f"cli register: {summary}")

        run("register_two_sources", ["register", f["t"], f["s"], f["s2"], "-o",
                                     os.path.join(d, "multi"), "--save-prepared",
                                     os.path.join(d, "prep.npz")] + bench)
        run("register_prepared", ["register", f["t"], f["s"], "-o",
                                  os.path.join(d, "prepared"), "--prepared",
                                  os.path.join(d, "prep.npz")] + bench)
        same_or_gates(torch, corr("prepared"), corr("multi", "s_"), deterministic,
                      "cli --prepared against the two-source run")
        warm = json.loads(run("register_warm_from", [
            "register", f["s2"], f["s"], "-o", os.path.join(d, "warm"), "--warm-from",
            os.path.join(d, "prep.npz")] + bench))
        check(warm["unique_correspondences"] / n_s > 0.6,
              f"cli --warm-from: {warm}")

        with open(os.path.join(d, "lm.txt"), "w") as fh:
            for i in range(CLI_LANDMARKS):
                v = i * (min(n_t, n_s) // CLI_LANDMARKS)
                fh.write(f"{v} {v}\n")
        opts = json.loads(run("register_options", [
            "register", f["t"], f["s"], "-o", os.path.join(d, "opts"), "--html",
            "--quality", "--landmarks", os.path.join(d, "lm.txt"), "--features",
            "curvature", "--transfer-point-data", "all"] + bench))
        moved = tp.load_mesh(os.path.join(d, "opts", "transformed_source.vtk"))
        check(opts["landmarks"] == CLI_LANDMARKS and "quality" in opts
              and "viewer.html" in opts["outputs"] and FEATURE in moved.point_data
              and os.path.getsize(os.path.join(d, "opts", "viewer.html")) > 0,
              f"cli register options: {opts}")
        fullres = json.loads(run("register_fullres", [
            "register", f["t"], f["s"], "-o", os.path.join(d, "fullres")] + bench
            + ["--n-coords-spectral-registration", str(n_s)]))
        check(fullres["unique_correspondences"] / n_s > 0.6, f"cli full resolution: {fullres}")
        multires = ["register", f["t"], f["s"], "--multires", str(MULTIRES_MULTI_COARSE_N),
                    "--level-ratio", str(CLI_MULTIRES_LEVEL_RATIO), "--checkpoint-dir",
                    os.path.join(d, "checkpoints")] + bench
        mr = json.loads(run("register_multires",
                            multires + ["-o", os.path.join(d, "multires")]))
        check(mr["unique_correspondences"] / n_s > CLI_MULTIRES_MIN_UNIQUE
              and os.path.exists(os.path.join(d, "checkpoints", "coarse.npz")),
              f"cli --multires: {mr}")
        run("multires_resume", multires + ["-o", os.path.join(d, "multires_resume")])
        check(np.array_equal(corr("multires_resume"), corr("multires")),
              "cli --multires: the resume changed the correspondences")

        cohort_flags = cli_flags(tp, COHORT_CFG) + dev
        coh = json.loads(run("cohort", ["cohort", *small[:4], "-o",
                                        os.path.join(d, "cohort")] + cohort_flags))
        check(coh["n_subjects"] == 3 and min(coh["unique_fraction_per_subject"])
              > CLI_COHORT_MIN_UNIQUE, f"cli cohort: {coh}")
        ssm = json.loads(run("ssm", ["ssm", *small[:4], "-o", os.path.join(d, "ssm"),
                                     "--iterations", "2", "--sample", "2", "--project",
                                     small[4], "--html"] + cohort_flags))
        check(ssm["iterations"] == 2 and len(ssm["projections"]) == 1
              and all(np.isfinite(ssm["mode_variances"]))
              and all(os.path.exists(os.path.join(d, "ssm", o)) for o in ssm["outputs"]),
              f"cli ssm: {ssm}")

        art = os.path.join(d, "w" + aot.EXEC_EXT)
        warmup = json.loads(run("warmup_export", ["warmup", f["t"], f["s"], "--export",
                                                  art] + bench))
        with open(art + ".meta.json") as fh:
            meta = json.load(fh)
        check(meta["cfg_fingerprint"] == aot._program_fingerprint(cfg),
              "the CLI's flags did not give the bench configuration")
        check(len(meta["libraries"]) == (7 if device == "cuda" else 1),
              f"warmup --export carries {len(meta['libraries'])} libraries")

    totals = {k: sum(r["launches"][k] for r in runs) for k in kernels}
    if device == "cuda":
        for name in ("knn", "umeyama3"):
            check(all(r["launches"][name] > 0 for r in runs if r["name"].startswith(
                ("register", "cohort", "ssm", "warmup"))),
                  f"a registering CLI invocation launched no {name} kernel")
        check(next(r for r in runs if r["name"] == "register_fullres")
              ["launches"]["cpd_estep"] > 0, "cli full resolution launched no E-step kernel")
        resume = next(r for r in runs if r["name"] == "multires_resume")["launches"]
        check(resume["knn"] > 0 and resume["umeyama3"] == 0,
              f"cli --multires resume: the refine's k-NN only, no coarse ICP: {resume}")
    emit({"phase": "cli", "nvidia_smi": smi, "n_target": n_t, "n_source": n_s,
          "n_small": n_small,
          "config": "bench.py:122-134 (register), bench.py cohort ccfg (cohort, ssm)",
          "register_agreement_with_register_pair": agree,
          "warmup": warmup, "invocations": runs, "launches": totals})
    return totals


# A fresh serving process (``python -c SERVE_CODE fmt artifact target source
# out.pt device``): load the artifact, then the meshes, two registrations
# (seeds 7 and 8; the first's outputs saved); one JSON line with the seconds
# from its first statement.
SERVE_CODE = """
import time
t00 = time.perf_counter()
import json, shutil, sys
import numpy as np
import torch
import pyfocusr_tpu_torch as tp
from pyfocusr_tpu_torch import native
from pyfocusr_tpu_torch.utils import aot
fmt, art, t_path, s_path, out_path, device = sys.argv[1:]
on = None if device == "cuda" else device
def sync():
    if device == "cuda":
        torch.cuda.synchronize()
import_s = time.perf_counter() - t00
t0 = time.perf_counter()
load = aot.load_registration_exec if fmt == "compiled" else aot.load_registration
run = load(art, device=on)
load_s = time.perf_counter() - t0
tg = tp.mesh_to_graph_arrays(tp.load_mesh(t_path), device=on)
sg = tp.mesh_to_graph_arrays(tp.load_mesh(s_path), device=on)
t0 = time.perf_counter()
res = run(tg, sg, torch.Generator().manual_seed(7))
sync()
first_call_s = time.perf_counter() - t0
cold = time.perf_counter() - t00
t0 = time.perf_counter()
run(tg, sg, torch.Generator().manual_seed(8))
sync()
steady_s = time.perf_counter() - t0
torch.save({k: v.cpu() for k, v in res.items()}, out_path)
built = {m.__name__.rsplit(".", 1)[1]: m.BUILD_SECONDS for m in aot._kernel_modules()}
built["host"] = native.build_seconds()
print("SERVE" + json.dumps({
    "cold_process_serve_s": cold, "import_s": import_s, "load_s": load_s,
    "first_call_s": first_call_s, "steady_s": steady_s, "build_seconds": built,
    "nvcc": shutil.which("nvcc"), "gxx": shutil.which("g++")}))
"""


def serve_fresh(fmt, art, t_path, s_path, out_path, device, env):
    """``SERVE_CODE`` in a fresh interpreter; its JSON line plus the
    process's wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SERVE_CODE, fmt, art, t_path, s_path,
                           out_path, device], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"fresh {fmt} serve: {proc.stderr[-1500:]}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("SERVE"))
    return {**json.loads(line[len("SERVE"):]), "process_wall_s": wall}


def phase_aot(torch, tp, kernels, smi, deterministic, device="cuda", levels=5,
              steady_reps=3):
    """The serving artifacts on the 'kd' pair under the bench configuration,
    the port's counterpart of ``bench.py:436-554`` (aot_serving_15k) at
    ``levels`` (10242 vertices): for each format, the artifact's size, its
    export, load, first and steady calls in this process (the runner's
    result against ``register_pair`` from the same generator: bit for bit
    where ``deterministic``, else the CUDA-vs-CPU gates), and a fresh
    process serving it (seconds from its first statement to the first
    result, its outputs against ``register_pair``'s: bit for bit on the card
    where ``deterministic``, else the gates): (a) with the libraries built,
    both formats; (b) the portable
    format with an empty build directory (the nvcc and g++ builds
    included); (c) the compiled format with an empty build directory and
    neither nvcc nor g++ reachable (PATH and CUDA_HOME an empty
    directory), which must build nothing.  Then a fresh ``register --aot``
    with another ``--non-rigid-max-iterations`` must exit 2 with "different
    PipelineConfig"."""
    from pyfocusr_tpu_torch.utils import aot

    on = "cpu" if device == "cpu" else None
    cfg = tp.PipelineConfig(**BENCH_CFG)
    out = {"phase": "aot", "nvidia_smi": smi, "config": "bench.py:122-134"}
    with tempfile.TemporaryDirectory(prefix="aot_") as d:
        paths = {k: os.path.join(d, f"{k}.vtk") for k in ("t", "s")}
        tp.save_mesh(paths["t"], synthetic_bone(tp, 2, levels=levels))
        tp.save_mesh(paths["s"], synthetic_bone(tp, 1, levels=levels))
        tg = tp.mesh_to_graph_arrays(tp.load_mesh(paths["t"]), device=on)
        sg = tp.mesh_to_graph_arrays(tp.load_mesh(paths["s"]), device=on)
        out.update(n_target=tg.n_points, n_source=sg.n_points)
        ref = tp.register_pair(tg, sg, cfg, generator=torch.Generator().manual_seed(7))
        arts = {}
        for fmt, name, export, load in (
                ("portable", "reg.pt", aot.export_registration, aot.load_registration),
                ("compiled", "reg" + aot.EXEC_EXT, aot.export_registration_exec,
                 aot.load_registration_exec)):
            art = arts[fmt] = os.path.join(d, name)
            t0 = time.perf_counter()
            export(cfg, tg, sg, art)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            runner = load(art, cfg=cfg, target=tg, source=sg)
            load_s = time.perf_counter() - t0
            for mod in kernels.values():
                mod.LAUNCHES = 0
            res, first_s = timed(torch, lambda: runner(
                tg, sg, torch.Generator().manual_seed(7)), device)
            launches = {k: m.LAUNCHES for k, m in kernels.items()}
            agree = same_or_gates(torch, res["correspondences"], ref["correspondences"],
                                  deterministic, f"{fmt} runner against register_pair")
            if deterministic:
                check(not outputs_differ(torch, res, ref),
                      f"{fmt} runner: outputs differ from register_pair")
            steady = [timed(torch, lambda: runner(
                tg, sg, torch.Generator().manual_seed(8)), device)[1]
                for _ in range(steady_reps)]
            out[fmt] = {"artifact_mb": os.path.getsize(art) / 1e6, "export_s": export_s,
                        "load_s": load_s, "first_call_s": first_s,
                        "steady_s": statistics.median(steady), "steady_s_all": steady,
                        "agreement_with_register_pair": agree, "launches": launches}
            if device == "cuda":
                check(launches["knn"] > 0 and launches["umeyama3"] > 0,
                      f"the {fmt} runner launched no k-NN or close kernel: {launches}")

        empty = os.path.join(d, "empty")
        os.makedirs(empty)
        setups = (
            ("a_built", "portable", {}),
            ("a_built", "compiled", {}),
            ("b_empty_build_dir", "portable",
             {"PYFOCUSR_TPU_TORCH_BUILD_DIR": os.path.join(d, "build_b")}),
            ("c_no_compilers", "compiled",
             {"PYFOCUSR_TPU_TORCH_BUILD_DIR": os.path.join(d, "build_c"),
              "PATH": empty, "CUDA_HOME": empty}),
        )
        # On the card a fresh process serves register_pair's bits where two
        # plain calls give equal bits; on the CPU another process may take
        # another thread count, so there the gates.
        bits = deterministic and device == "cuda"
        for setup, fmt, env in setups:
            saved = os.path.join(d, f"{setup}_{fmt}.pt")
            got = serve_fresh(fmt, arts[fmt], paths["t"], paths["s"], saved, device,
                              {**os.environ, **env})
            served = torch.load(saved, weights_only=True)
            what = f"fresh {setup} {fmt} serve against register_pair"
            got["agreement_with_register_pair"] = same_or_gates(
                torch, served["correspondences"], ref["correspondences"], bits, what)
            if bits:
                differ = outputs_differ(torch, served, ref)
                check(not differ, f"{what}: outputs differ {differ}")
            got["bit_equal"] = not outputs_differ(torch, served, ref)
            out[fmt][f"cold_process_{setup}"] = got
            if setup == "c_no_compilers":
                check(got["nvcc"] is None and got["gxx"] is None,
                      f"nvcc or g++ reachable in setup (c): {got}")
                built = {k: v for k, v in got["build_seconds"].items()
                         if device == "cuda" or k == "host"}
                check(all(v == 0.0 for v in built.values()),
                      f"setup (c) built a library: {got['build_seconds']}")
                with open(arts[fmt] + ".meta.json") as fh:
                    want = sorted(lib["name"] for lib in json.load(fh)["libraries"])
                # Besides the libraries: the k-NN route's record (ops/knn_routing.py).
                libs = sorted(n for n in os.listdir(env["PYFOCUSR_TPU_TORCH_BUILD_DIR"])
                              if n.endswith(".so"))
                check(libs == want, f"setup (c)'s build directory holds other libraries "
                      f"than the artifact's: {libs}")
            if setup == "b_empty_build_dir" and device == "cuda":
                check(all(s > 0 for s in got["build_seconds"].values()),
                      f"setup (b) found a library built: {got['build_seconds']}")

        # A changed config is refused by a fresh CLI process with exit 2.
        argv = (["register", paths["t"], paths["s"], "-o", os.path.join(d, "refused"),
                 "--aot", arts["compiled"]] + cli_flags(tp, BENCH_CFG)
                + ["--non-rigid-max-iterations", "299"]
                + ([] if device == "cuda" else ["--device", device]))
        proc = subprocess.run(
            [sys.executable, "-c", "import sys; from pyfocusr_tpu_torch.cli import main; "
             f"sys.exit(main({argv!r}))"], capture_output=True, text=True, cwd=ROOT,
            timeout=600)
        check(proc.returncode == 2 and "different PipelineConfig" in proc.stderr,
              f"a changed config was not refused: {proc.returncode} {proc.stderr[-500:]}")
        out["changed_config_exit"] = proc.returncode
    emit(out)
    return out


# --- The sharded paths (parallel/distributed.py): every device_mesh of the
# JAX package, on torch.distributed.  Setup (a): a world of one NCCL rank in
# this process; (b): SHARDED_GLOO_RANKS gloo ranks spawned on the one card
# (times of ranks that share a card are correctness runs, not scale-out
# figures); (c): one NCCL rank a card, where more than one is visible.
SHARDED_MULTIRES_LEVELS = 7  # (a): register_pair_multires at 163842
SHARDED_GLOO_RANKS = 4
SHARDED_GLOO_REFINE_LEVELS = 7  # (b): the refine at 163842
SHARDED_GLOO_MULTIRES_LEVELS = 6  # (b): register_pair_multires at 40962
SHARDED_GLOO_SUBJECTS = 4  # (b): the cohort, one subject a rank
SHARDED_GLOO_PAIR_SUBJECTS = 3  # (b): 6 pairs on 4 ranks, padded to 8
# tests/test_bigmesh.py's gates of a sharded refine against one device.
SHARDED_REFINE_AGREE_MIN = 0.99
SHARDED_REFINE_RTOL = 2e-4
SHARDED_REFINE_ATOL = 2e-5
SHARDED_REFINE_KEYS = ("weighted_points", "average_points", "smoothed_target_coords",
                       "source_projected_on_target")
# The cohort mean: the all-reduced sum over the batch against the mean.
SHARDED_MEAN_RTOL = 1e-6


def kernel_modules():
    """The kernel wrappers by name, each with its ``LAUNCHES`` count."""
    from pyfocusr_tpu_torch.ops import (
        cheb_step_kernel,
        cpd_estep_kernel,
        jv_kernel,
        knn_kernel,
        knn_topk_kernel,
        sinkhorn_kernel,
        umeyama_kernel,
    )

    return {"knn": knn_kernel, "knn_topk": knn_topk_kernel, "lse_rows": sinkhorn_kernel,
            "jv": jv_kernel, "cpd_estep": cpd_estep_kernel, "umeyama3": umeyama_kernel,
            "cheb_step": cheb_step_kernel}


def sharded_inputs(tp, subjects, pair_subjects, multires_levels, levels=5,
                   cfg_kw=BENCH_CFG, cohort_cfg_kw=COHORT_CFG, coarse_n=MULTIRES_COARSE_N):
    """The inputs of the sharded calls: the cohort phase's template and
    jittered subjects, the groupwise phase's warped subjects (at
    ``levels``), the multires pair at ``multires_levels``, and the
    configurations."""
    return {
        "cfg": cfg_kw, "cohort_cfg": cohort_cfg_kw, "coarse_n": coarse_n,
        "template": synthetic_bone(tp, 2, levels),
        "subjects": jittered_cohort(tp, synthetic_bone(tp, 1, levels), subjects,
                                    COHORT_JITTER_MM),
        "pair_subjects": [warped_bone(tp, levels, a, ph)
                          for a, ph in GROUPWISE_WARPS[:pair_subjects]],
        "multires": (synthetic_bone(tp, 2, multires_levels),
                     synthetic_bone(tp, 1, multires_levels)),
    }


def refine_inputs(torch, tp, levels, device="cuda", cfg_kw=BENCH_CFG,
                  coarse_n=MULTIRES_COARSE_N):
    """The inputs of ``_refine_fine_level`` in ``register_pair_multires`` of
    the 'kd' pair at ``levels`` (target, source, initial correspondences,
    config)."""
    with MultiresSplit(torch, tp, device) as split:
        tp.register_pair_multires(synthetic_bone(tp, 2, levels), synthetic_bone(tp, 1, levels),
                                  tp.PipelineConfig(**cfg_kw),
                                  torch.Generator(device=device).manual_seed(0),
                                  coarse_n=coarse_n, device=device)
    return split.refine_args[:4]


def _to(x, device):
    """A tensor or GraphArrays on ``device``; anything else as it is."""
    return x.to(device) if hasattr(x, "to") else x


def _cpu(x):
    """Tensors of a nested result moved to the CPU."""
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu(v) for v in x)
    return x.cpu() if hasattr(x, "cpu") else x


def sharded_calls(torch, tp, kernels, inputs, refine_args, mesh_of, device):
    """The sharded phase's four calls on ``device``: the refine
    (``refine_fine_level_sharded``, or ``_refine_fine_level`` without a
    mesh), ``register_cohort`` under the cohort configuration,
    ``register_all_pairs`` and ``register_pair_multires`` under the bench
    configuration, with ``mesh_of(axis)`` the device mesh of each ('verts',
    'cohort', 'pairs'; None: one device).  The kernels' counts are set to 0
    just before the calls and read just after.  Returns ({call: result on
    the CPU}, {call: wall seconds}, launches)."""
    from pyfocusr_tpu_torch import multires
    from pyfocusr_tpu_torch.parallel import groupwise as G
    from pyfocusr_tpu_torch.parallel.bigmesh import refine_fine_level_sharded

    cfg = tp.PipelineConfig(**inputs["cfg"])
    ccfg = tp.PipelineConfig(**inputs["cohort_cfg"])
    meshes = {axis: mesh_of(axis) for axis in ("verts", "cohort", "pairs")}
    template = tp.mesh_to_graph_arrays(inputs["template"], device=device)
    targets = tp.stack_graph_arrays([tp.mesh_to_graph_arrays(m, device=device)
                                     for m in inputs["subjects"]])
    cohort_draws = tp.make_cohort_draws(0, ccfg, template, targets)
    pair_graphs = tp.pad_cohort(inputs["pair_subjects"], device=device)
    pair_draws = G.make_all_pairs_draws(1, cfg, pair_graphs)
    tg, sg, init, fcfg = (_to(x, device) for x in refine_args)

    def refine():
        if meshes["verts"] is None:
            return multires._refine_fine_level(tg, sg, init, fcfg)
        return refine_fine_level_sharded(tg, sg, init, fcfg, meshes["verts"])

    calls = {
        "refine": refine,
        "cohort": lambda: tp.register_cohort(template, targets, ccfg,
                                             device_mesh=meshes["cohort"], draws=cohort_draws),
        "all_pairs": lambda: G.register_all_pairs(pair_graphs, cfg, device_mesh=meshes["pairs"],
                                                  draws=pair_draws),
        "multires": lambda: tp.register_pair_multires(
            *inputs["multires"], cfg, torch.Generator(device=device).manual_seed(0),
            coarse_n=inputs["coarse_n"], device_mesh=meshes["verts"], device=device),
    }
    out, seconds = {}, {}
    sync(torch, device)
    for mod in kernels.values():
        mod.LAUNCHES = 0
    for name, fn in calls.items():  # the sharded calls run here
        res, seconds[name] = timed(torch, fn, device)
        out[name] = _cpu(res)
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    return out, seconds, launches


def sharded_rank(inputs, refine_args, device_type):
    """One spawned rank of the sharded phase (``distributed.spawn``): the
    four calls over one-axis meshes of every rank, on the rank's device."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import pyfocusr_tpu_torch as tp
    from pyfocusr_tpu_torch.parallel.distributed import rank_device

    def mesh_of(axis):
        return init_device_mesh(device_type, (dist.get_world_size(),),
                                mesh_dim_names=(axis,))

    device = rank_device(mesh_of("verts"))
    out, seconds, launches = sharded_calls(torch, tp, kernel_modules(), inputs, refine_args,
                                           mesh_of, device)
    return {"results": out, "seconds": seconds, "launches": launches,
            "device": str(device), "backend": dist.get_backend()}


def sharded_checks(torch, one, got, deterministic, what):
    """Gates of one setup's results ``got`` against the one-device results
    ``one`` (both on the CPU): the refine and multires fine level at
    tests/test_bigmesh.py's gates (the multires coarse level bit for bit
    where ``deterministic``); cohort and all-pairs lanes bit for bit where
    ``deterministic``, else at the CUDA-vs-CPU gates; the cohort mean
    within ``SHARDED_MEAN_RTOL`` of its largest coordinate (else median <=
    1e-3 mm and mean <= 0.1 mm).  Returns what was compared."""
    summary = {}

    def refine_gates(a, b, name):
        agree = float((a["correspondences"] == b["correspondences"]).float().mean())
        diffs = {k: float((a[k] - b[k]).abs().max()) for k in SHARDED_REFINE_KEYS}
        close = all(torch.allclose(b[k], a[k], rtol=SHARDED_REFINE_RTOL,
                                   atol=SHARDED_REFINE_ATOL) for k in SHARDED_REFINE_KEYS)
        check(agree >= SHARDED_REFINE_AGREE_MIN and close,
              f"{what} {name}: agreement {agree}, max differences {diffs}")
        check(list(a) == list(b) and all(a[k].shape == b[k].shape for k in a),
              f"{what} {name}: keys or shapes differ")
        return {"correspondence_agreement": agree, "max_abs_diff": diffs,
                "bit_equal": not outputs_differ(torch, a, b)}

    def lanes(a, b, name):
        n = a["correspondences"].shape[0]
        differ = [outputs_differ(torch, {k: v[i] for k, v in a.items()},
                                 {k: v[i] for k, v in b.items()}) for i in range(n)]
        if deterministic:
            check(not any(differ), f"{what} {name}: lanes differ from one device: {differ}")
        else:
            for i in range(n):
                agreement_checks(compare_runs({k: v[i] for k, v in b.items()},
                                              {k: v[i] for k, v in a.items()}),
                                 f"{what} {name} lane {i}")
        return {"lanes": n, "lanes_bit_equal": sum(not d for d in differ)}

    summary["refine"] = refine_gates(one["refine"], got["refine"], "refine")
    (res1, mean1), (res2, mean2) = one["cohort"], got["cohort"]
    summary["cohort"] = lanes(res1, res2, "cohort")
    mean_diff = (mean1 - mean2).norm(dim=1)
    if deterministic:
        ok = float(mean_diff.max()) <= SHARDED_MEAN_RTOL * float(mean1.abs().max())
    else:  # tests/test_torch_cohort.py's gates of a mean shape
        ok = float(mean_diff.median()) <= 1e-3 and float(mean_diff.mean()) <= 0.1
    check(ok, f"{what} cohort mean differs by up to {float(mean_diff.max())} mm")
    summary["cohort"]["mean_max_diff_mm"] = float(mean_diff.max())
    (corr1, index1, pairs1), (corr2, index2, pairs2) = one["all_pairs"], got["all_pairs"]
    check(index1 == index2, f"{what} all-pairs pair order")
    summary["all_pairs"] = lanes(pairs1, pairs2, "all-pairs")
    summary["all_pairs"]["corr_equal"] = bool(np.array_equal(corr1, corr2))
    check(summary["all_pairs"]["corr_equal"] or not deterministic,
          f"{what} all-pairs correspondence arrays differ")
    (fine1, coarse1), (fine2, coarse2) = one["multires"], got["multires"]
    summary["multires"] = refine_gates(fine1, fine2, "multires")
    summary["multires"]["coarse_bit_equal"] = not outputs_differ(torch, coarse1, coarse2)
    check(summary["multires"]["coarse_bit_equal"] or not deterministic,
          f"{what} multires coarse level differs")
    return summary


def phase_sharded(torch, tp, kernels, smi, deterministic, refine_args=None, device="cuda",
                  levels=5, refine_levels=MULTIRES_LEVELS,
                  multires_levels=SHARDED_MULTIRES_LEVELS,
                  gloo_refine_levels=SHARDED_GLOO_REFINE_LEVELS,
                  gloo_multires_levels=SHARDED_GLOO_MULTIRES_LEVELS, cfg_kw=BENCH_CFG,
                  cohort_cfg_kw=COHORT_CFG, coarse_n=MULTIRES_COARSE_N):
    """Every ``device_mesh`` path on the card, each against the same call on
    one device in this process (``sharded_calls``, ``sharded_checks``):

    (a) a world of one NCCL rank in this process: the refine at the
        multires phase's fine level (``refine_args``; 655362), the cohort
        of ``COHORT_SUBJECTS`` x 10242, all pairs of four subjects (12) and
        multires at ``SHARDED_MULTIRES_LEVELS``;
    (b) ``SHARDED_GLOO_RANKS`` gloo ranks sharing the card: the refine at
        ``SHARDED_GLOO_REFINE_LEVELS``, a cohort of one subject a rank,
        three subjects' six pairs (padded to eight), multires at
        ``SHARDED_GLOO_MULTIRES_LEVELS``;
    (c) one NCCL rank a card with (b)'s inputs, where more than one card is
        visible; else a line says it was not run.

    On the card each rank must launch the k-NN and close kernels.  Returns
    the launch counts per setup, one list entry a rank.  Rehearsed on the
    CPU with ``device="cpu"`` (gloo in place of NCCL), small levels and
    configurations, as the cohort phase is."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from pyfocusr_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    dtype = torch.device(device).type
    one_backend = "nccl" if dtype == "cuda" else "gloo"
    kw = dict(levels=levels, cfg_kw=cfg_kw, cohort_cfg_kw=cohort_cfg_kw, coarse_n=coarse_n)
    if refine_args is None:
        refine_args = refine_inputs(torch, tp, refine_levels, device, cfg_kw, coarse_n)
    launches = {}

    def launched(counts, what):
        check(dtype != "cuda" or (counts["knn"] > 0 and counts["umeyama3"] > 0),
              f"{what} launched no k-NN or close kernel: {counts}")

    # (a) One NCCL rank in this process.
    inputs_a = sharded_inputs(tp, COHORT_SUBJECTS, len(GROUPWISE_WARPS), multires_levels,
                              **kw)
    one_a, one_a_s, _ = sharded_calls(torch, tp, kernels, inputs_a, refine_args,
                                      lambda axis: None, device)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group(one_backend, rank=0, world_size=1,
                                store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            init_s = time.perf_counter() - t0
            got_a, got_a_s, launches_a = sharded_calls(
                torch, tp, kernels, inputs_a, refine_args,
                lambda axis: init_device_mesh(dtype, (1,), mesh_dim_names=(axis,)), device)
        finally:
            dist.destroy_process_group()
    launched(launches_a, f"(a) the {one_backend} rank")
    launches["nccl_one_rank"] = [launches_a]
    summary_a = sharded_checks(torch, one_a, got_a, deterministic, "(a) NCCL world of one")
    emit({"phase": "sharded_nccl_one_rank", "nvidia_smi": smi, "backend": one_backend,
          "ranks": 1, "n_refine": refine_args[1].n_points,
          "n_multires": inputs_a["multires"][1].n_points,
          "cohort_subjects": len(inputs_a["subjects"]),
          "pairs": len(got_a["all_pairs"][1]), "init_process_group_s": init_s,
          "one_device_s": one_a_s, "sharded_s": got_a_s, "launches": launches_a,
          "checks": summary_a})
    del one_a, got_a, inputs_a

    # (b) gloo ranks sharing the card; (c) one NCCL rank a card.
    inputs_b = sharded_inputs(tp, SHARDED_GLOO_SUBJECTS, SHARDED_GLOO_PAIR_SUBJECTS,
                              gloo_multires_levels, **kw)
    refine_b = [_to(x, "cpu") for x in refine_inputs(torch, tp, gloo_refine_levels, device,
                                                      cfg_kw, coarse_n)]
    # The host's cores shared among the ranks (torch's default of one
    # thread a core in each rank oversubscribes them); the one-device
    # reference runs with as many, so host-side reductions sum alike.
    threads, threads_before = max(1, (os.cpu_count() or 1) // SHARDED_GLOO_RANKS), \
        torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        one_b, one_b_s, _ = sharded_calls(torch, tp, kernels, inputs_b, refine_b,
                                          lambda axis: None, device)
    finally:
        torch.set_num_threads(threads_before)
    n_cards = torch.cuda.device_count() if dtype == "cuda" else 0
    setups = [("gloo_shared_card", "gloo", SHARDED_GLOO_RANKS)]
    if n_cards > 1:
        setups.append(("nccl_per_card", "nccl", n_cards))
    else:
        launches["nccl_per_card"] = None
        emit({"phase": "sharded_nccl_per_card", "run": False,
              "why": f"{n_cards} CUDA device visible: one NCCL rank a card needs two or more"})
    for name, backend, n_ranks in setups:
        t0 = time.perf_counter()
        ranks = distributed.spawn(sharded_rank, n_ranks, backend, dtype,
                                  args=(inputs_b, refine_b, dtype), threads=threads)
        wall_s = time.perf_counter() - t0
        for r, out in enumerate(ranks):
            launched(out["launches"], f"({name}) rank {r}")
        launches[name] = [out["launches"] for out in ranks]
        summaries = [sharded_checks(torch, one_b, out["results"], deterministic,
                                    f"({name}) rank {r}") for r, out in enumerate(ranks)]
        emit({"phase": f"sharded_{name}", "nvidia_smi": smi, "backend": backend,
              "ranks": n_ranks, "threads_per_rank": threads,
              "devices": [out["device"] for out in ranks],
              "label": ("correctness run: the ranks share one card, not a scale-out figure"
                        if name == "gloo_shared_card" else "one rank a card"),
              "n_refine": refine_b[1].n_points,
              "n_multires": inputs_b["multires"][1].n_points,
              "cohort_subjects": len(inputs_b["subjects"]),
              "pairs": len(ranks[0]["results"]["all_pairs"][1]),
              "spawn_and_run_wall_s": wall_s, "one_device_s": one_b_s,
              "sharded_s_per_rank": [out["seconds"] for out in ranks],
              "launches_per_rank": launches[name], "checks_rank0": summaries[0]})
    emit({"phase": "sharded", "phase_s": time.perf_counter() - t_phase})
    return launches


# --- The completion phase: the JAX package's schedules the port took last
# (split spectra, union and batched spectra, auction).

# The bench's direct_122k_hub pair (bench.py:796-870): two 350 x 350 UV
# spheres (122152 vertices; each pole touches a ring of 350), the source
# warped by 5%, 40 mm radius, and its configuration.
HUB_N = 350
HUB_WARP = 0.05
HUB_CFG = dict(
    get_weighted_spectral_coords=False, non_rigid_alpha=0.01, non_rigid_beta=50.0,
    non_rigid_max_iterations=300, n_coords_spectral_ordering=10000,
    n_coords_spectral_registration=1000, graph_smoothing_iterations=600,
    projection_smooth_iterations=1,
)
# The union / batched solves' gates against separate solves
# (tests/test_pipeline.py:166-175).
UNION_EIG_RTOL = 1e-3
UNION_COS_MIN = 0.999
# The auction's sizes and its gap gate against the optimum
# (tests/test_kernels.py:160-166), and the largest size also run on the
# CPU for equality: at 2562 the CPU's 11193 rounds took 76.1 s on the
# card's host (equal to the card's result; run 17b).
AUCTION_SIZES = (300, 2562)
AUCTION_GAP_MAX = 0.05
AUCTION_CPU_MAX_N = 300
# The fused Chebyshev filter step (ops/cheb_step_kernel.py): its gate against
# the plain ELL step, of the ELL result's largest entry (the JAX package's
# gate between its two filter operators, tests/test_patch_dense.py:79); the
# bones it is timed on (10242 and 40962 vertices, block width 128); the
# narrow block width and the UV sphere whose poles overflow the ELL width of
# 24, for the cases of other shapes; the steps a graph times; the warm 'kd'
# pairs with the fused chunk and the step-by-step ELL chunk alternated.
CHEB_STEP_TOL_OF_SCALE = 2e-6
CHEB_STEP_LEVELS = (5, 6)
CHEB_NARROW_WIDTH = 14
CHEB_HUB = (40, 60)
CHEB_TIMED_STEPS = 20
CHEB_WARM_REPS = 3


def uv_sphere(tp, n_theta: int, n_phi: int, warp: float = 0.0):
    """bench.py:805-836's UV sphere: poles as fans, radius 40."""
    pts = [(0.0, 0.0, 1.0)]
    for ii in range(1, n_theta):
        th = np.pi * ii / n_theta
        for jj in range(n_phi):
            ph = 2 * np.pi * jj / n_phi
            pts.append((np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)))
    pts.append((0.0, 0.0, -1.0))
    pts = np.asarray(pts, np.float64)
    tris = []

    def ring(k):
        return 1 + (k - 1) * n_phi

    for jj in range(n_phi):
        tris.append((0, ring(1) + jj, ring(1) + (jj + 1) % n_phi))
    for ii in range(1, n_theta - 1):
        for jj in range(n_phi):
            a, b = ring(ii) + jj, ring(ii) + (jj + 1) % n_phi
            c, d = ring(ii + 1) + jj, ring(ii + 1) + (jj + 1) % n_phi
            tris.append((a, c, b))
            tris.append((b, c, d))
    last = len(pts) - 1
    for jj in range(n_phi):
        tris.append((last, ring(n_theta - 1) + (jj + 1) % n_phi, ring(n_theta - 1) + jj))
    if warp:
        pts = pts * (1.0 + warp * np.sin(3.0 * pts[:, [1]]))
    return tp.TriMesh((pts * 40).astype(np.float32), np.asarray(tris, np.int32))


def filter_pieces(torch, tp, g):
    """The wide solver's operator pieces of ``g`` (pipeline._spectrum):
    symmetrized weights, overflow weights, diagonal, mask, and Gershgorin
    bound."""
    go = tp.pipeline.graph_ops
    mask = g.valid_mask
    w = go.edge_weights(g.points, g.neighbors, g.nbr_mask)
    ov = g.overflow
    ov_w = go.overflow_weights(g.points, ov)
    d = go.degree_vector(w, ov, ov_w)
    s = torch.sqrt(torch.where(mask > 0, (d + go.DEGREE_EPS) ** -1, torch.ones_like(d)))
    sw = s[:, None] * w * s[g.neighbors]
    sd = s * s * d * mask
    ov_sw = ov_w * s[ov[:, 0]] * s[ov[:, 1]] if ov.shape[0] else None
    bound = float((mask * s * (s * d + go.spmv(g.neighbors, w, s, ov, ov_w))).max())
    return sw, ov_sw, sd, mask, bound


def device_work_per_call(torch, fn, device):
    """Device work items (kernel, copy and set nodes) one call of ``fn``
    puts on the card: the nodes of a CUDA graph captured around one call,
    counted by ``cuGraphGetNodes`` of libcuda; None off the card.  (A
    ``torch.profiler`` trace gave the same 7 and 4 in run 17b, but after
    this script's earlier traces it held no device event, runs 17e-17h.)"""
    if device != "cuda":
        return None
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    check(rc == 0 and count.value > 0,
          f"cuGraphGetNodes returned {rc} and {count.value} nodes for a filter step")
    return int(count.value)


def eig_agreement(lg, vg, lw, vw):
    """Largest relative eigenvalue difference and smallest |cos| of the
    mean-centred eigenvector columns."""
    lg, lw = np.asarray(lg, np.float64), np.asarray(lw, np.float64)
    vg, vw = np.asarray(vg, np.float64), np.asarray(vw, np.float64)
    rel = float(np.max(np.abs(lg - lw) / np.abs(lw)))
    vg = vg - vg.mean(0)
    vw = vw - vw.mean(0)
    cos = np.abs((vg * vw).sum(0)) / (np.linalg.norm(vg, axis=0) * np.linalg.norm(vw, axis=0))
    return rel, float(cos.min())


def ell_step(neighbors, overflow, sw, ov_sw, sd, mask, c, e):
    """The plain filter step ``T -> (2/e) (A - c I) T`` over the ELL table
    (``cheb_step_kernel.ell_product``), with the table ``w_hat``,
    ``a_diag`` and ``ov_coef`` (None without overflow edges) it runs on."""
    from pyfocusr_tpu_torch.ops.cheb_step_kernel import ell_product

    alpha = 2.0 / e
    w_hat, a_diag = alpha * sw, alpha * (sd - c * mask)
    ov_coef = None if ov_sw is None else -(alpha * ov_sw)[:, None]

    def op(T):
        return ell_product(T, neighbors, w_hat, a_diag, overflow, ov_coef)

    return op, w_hat, a_diag, ov_coef


def cheb_operands(torch, tp, g, b, seed=0):
    """The operands of one Chebyshev filter step on graph ``g`` at block
    width ``b``, at a cold solve's first cut (``chebyshev_eigpairs_wide``):
    the plain step ``op`` (:func:`ell_step`), the ELL factory's ``chunk``
    (``pipeline.ell_filter_factory``), the kernel's table (int32
    neighbours, ``w_hat``, ``a_diag``), the overflow edges and their
    ``ov_coef`` (None without) and two random blocks ``t``, ``tprev``
    [N, b]."""
    sw, ov_sw, sd, mask, bound = filter_pieces(torch, tp, g)
    dev = g.device
    lam_max = torch.tensor(bound * 1.005, dtype=torch.float32, device=dev)
    a = lam_max * 1e-3
    c, e = (lam_max + a) / 2.0, (lam_max - a) / 2.0
    op, w_hat, a_diag, ov_coef = ell_step(g.neighbors, g.overflow, sw, ov_sw, sd, mask, c, e)
    rng = np.random.default_rng(seed)
    t, tprev = (torch.from_numpy(rng.standard_normal((g.n_points, b)).astype(np.float32))
                .to(dev) for _ in range(2))
    return {
        "op": op,
        "chunk": tp.pipeline.ell_filter_factory(g.neighbors, g.overflow, sw, ov_sw, sd,
                                                mask)(c, e),
        "neighbors": g.neighbors.to(torch.int32), "w_hat": w_hat, "a_diag": a_diag,
        "overflow": g.overflow, "ov_coef": ov_coef, "t": t, "tprev": tprev}


def cheb_reference(op, X, deg):
    """t_deg of the filter recurrence run step by step through ``op``, as
    the JAX package's ``chebyshev_eigpairs_wide`` runs it."""
    t_prev, t_cur = X, 0.5 * op(X)
    for _ in range(deg - 1):
        t_prev, t_cur = t_cur, op(t_cur) - t_prev
    return t_cur


def cheb_errors(torch, CK, ops, degrees=(1, 2, 3)):
    """The fused chunk (``chebyshev_ell`` on the operands' device) against
    the step-by-step ELL recurrence after each of ``degrees`` steps (one
    step, one in fresh buffers, one written over the block two back), and
    the single step ``cheb_step_plain`` / ``cheb_step_cuda`` against
    ``op(t) - tprev`` and ``0.5 op(t)`` where the graph has no overflow
    edges: each the largest difference over the reference's largest entry."""
    out = {}
    for deg in degrees:
        ref = cheb_reference(ops["op"], ops["t"], deg)
        got = CK.chebyshev_ell(ops["t"], deg, ops["neighbors"], ops["w_hat"], ops["a_diag"],
                               ops["overflow"], ops["ov_coef"])
        out[f"chunk_{deg}"] = float((got - ref).abs().max() / ref.abs().max())
    if ops["ov_coef"] is None:
        step = CK.cheb_step_plain if ops["t"].device.type == "cpu" else (
            lambda t, tp_, nb, w, a, first: CK.cheb_step_cuda(
                t, tp_, torch.empty_like(t), nb, w, a, first))
        for first in (True, False):
            ref = 0.5 * ops["op"](ops["t"]) if first else ops["op"](ops["t"]) - ops["tprev"]
            got = step(ops["t"], ops["tprev"], ops["neighbors"], ops["w_hat"], ops["a_diag"],
                       first)
            out["step_first" if first else "step"] = float(
                (got - ref).abs().max() / ref.abs().max())
    return out


@contextlib.contextmanager
def stepwise_filter(tp):
    """``pipeline._spectrum`` with each chunk's recurrence run one plain
    ELL step at a time (:func:`cheb_reference` over :func:`ell_step`), as
    before the kernel."""
    real = tp.pipeline.ell_filter_factory

    def stepwise(neighbors, overflow, sw, ov_sw, sd, mask):
        def factory(c, e):
            op = ell_step(neighbors, overflow, sw, ov_sw, sd, mask, c, e)[0]
            return lambda X, deg: cheb_reference(op, X, deg)

        return factory

    tp.pipeline.ell_filter_factory = stepwise
    try:
        yield
    finally:
        tp.pipeline.ell_filter_factory = real


def cheb_capture(torch, ops, deg):
    """One chunk of ``deg`` fused steps captured in a CUDA graph and
    replayed: (replay equal to the eager chunk bit for bit, launches the
    capture recorded)."""
    from pyfocusr_tpu_torch.ops import cheb_step_kernel as CK

    eager = ops["chunk"](ops["t"], deg)
    torch.cuda.synchronize()
    before = CK.LAUNCHES
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops["chunk"](ops["t"], deg)
    launches = CK.LAUNCHES - before
    graph.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(captured, eager)), launches


def cheb_step_times(torch, tp, CK, g, ops, device):
    """Device ms of one filter step at the operands' shape, each from a
    CUDA graph of ``CHEB_TIMED_STEPS`` steps (``graph_ms``): the kernel as
    a chunk runs it (two blocks in turn, each step reading both and writing
    over the older) and the plain ELL step, ``op(t) - tprev`` on fixed
    blocks (the recurrence before the kernel); the graph nodes of one step;
    and the bytes bound, 3 N b 4 + N D 8 bytes over ``HBM_BYTES_PER_S``."""
    n, b = ops["t"].shape
    d = g.neighbors.shape[1]
    blocks = [ops["tprev"].clone(), ops["t"].clone()]
    turn = [0]

    def fused():  # t = the newer block, written over the older
        older = blocks[turn[0]]
        newer = blocks[1 - turn[0]]
        CK.cheb_step_cuda(newer, older, older, ops["neighbors"], ops["w_hat"], ops["a_diag"],
                          False)
        turn[0] = 1 - turn[0]

    steps = {"kernel": fused,
             "ell": lambda: ops["op"](ops["t"]) - ops["tprev"]}
    out = {"n": n, "b": b, "d": d, "plan": CK.plan(n, b)}
    for name, fn in steps.items():
        out[f"{name}_ms"] = graph_ms(torch, fn, calls=CHEB_TIMED_STEPS)
        out[f"{name}_device_work_per_step"] = device_work_per_call(torch, fn, device)
    out["bound_ms"] = (3 * n * b * 4 + n * d * 8) / HBM_BYTES_PER_S * 1e3
    out["bound_by"] = "bytes"
    out["kernel_share_of_bound"] = out["bound_ms"] / out["kernel_ms"]
    # The blocks fit the 50 MB L2 at 10242 (15.7 MB); the bound counts
    # device memory all the same.
    out["blocks_mb"] = 3 * n * b * 4 / 1e6
    return out


def phase_cheb_step(torch, tp, kernels, smi, device="cuda", levels=CHEB_STEP_LEVELS,
                    warm_reps=CHEB_WARM_REPS):
    """The fused Chebyshev filter step on the card: at each of ``levels``
    (bones at 10242 and 40962 vertices, block width 128, the bones' ELL
    width) its error against the plain ELL step and chunk, its time beside
    the plain ELL step's and the bytes bound, a
    chunk captured in a CUDA graph, and the spectrum through it against the
    step-by-step ELL chunk; a narrow block (``CHEB_NARROW_WIDTH`` columns)
    and a hub graph with overflow edges (``CHEB_HUB``); then warm 'kd'
    pairs at 10242 fused and step by step alternated, each fused pair's
    launches and its record's ``cheb_steps_fused`` against 33 steps a
    chunk.  Returns the kernel's figures for the ``kernels`` line."""
    from pyfocusr_tpu_torch.ops import cheb_step_kernel as CK
    from pyfocusr_tpu_torch.utils import spans
    from pyfocusr_tpu_torch.utils.precision import full_f32

    cfg = tp.PipelineConfig(**BENCH_CFG)
    sizes = []
    with full_f32():
        for lv in levels:
            g = tp.mesh_to_graph_arrays(synthetic_bone(tp, 2, lv), device=device)
            ops = cheb_operands(torch, tp, g, cfg.eig_wide_block)
            errs = cheb_errors(torch, CK, ops, degrees=(1, 2, 3, cfg.eig_wide_degree))
            chunk_err = errs.pop(f"chunk_{cfg.eig_wide_degree}")
            check(max(errs.values()) <= CHEB_STEP_TOL_OF_SCALE,
                  f"fused step against the ELL step at {g.n_points}: {errs}")
            equal, cap_launches = cheb_capture(torch, ops, cfg.eig_wide_degree)
            check(equal and cap_launches == cfg.eig_wide_degree,
                  f"a captured chunk at {g.n_points}: equal {equal}, {cap_launches} launches")
            times = cheb_step_times(torch, tp, CK, g, ops, device)
            start = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (g.n_points, cfg.eig_wide_block)).astype(np.float32)).to(device)
            spectra = {}
            for name, ctx in (("fused", contextlib.nullcontext()),
                              ("stepwise", stepwise_filter(tp))):
                with ctx:
                    sync(torch, device)
                    t0 = time.perf_counter()
                    lams, vecs, _ = tp.pipeline._spectrum(g, cfg.n_total, cfg, start)
                    sync(torch, device)
                    spectra[name] = (time.perf_counter() - t0, _cpu(lams), _cpu(vecs))
            rel, cos = eig_agreement(spectra["fused"][1], spectra["fused"][2],
                                     spectra["stepwise"][1], spectra["stepwise"][2])
            check(rel <= EIGVAL_RTOL and cos >= COS_MIN,
                  f"fused spectrum against the stepwise one: rel {rel}, |cos| {cos}")
            sizes.append({"errors_of_scale": errs, "chunk_error_of_scale": chunk_err,
                          "capture_equal": equal, **times,
                          "spectrum_s": {k: v[0] for k, v in spectra.items()},
                          "spectrum_eigval_max_rel_diff": rel,
                          "spectrum_eigvec_min_abs_cos": cos})
            emit({"phase": "cheb_step_kernel_vs_plain", "nvidia_smi": smi, **sizes[-1]})
        # Other shapes: a narrow block, and a hub graph with overflow edges.
        g5 = tp.mesh_to_graph_arrays(synthetic_bone(tp, 2, levels[0]), device=device)
        narrow = cheb_errors(torch, CK, cheb_operands(torch, tp, g5, CHEB_NARROW_WIDTH))
        hub_g = tp.mesh_to_graph_arrays(uv_sphere(tp, *CHEB_HUB), device=device)
        check(hub_g.overflow.shape[0] > 0, "the hub sphere has no overflow edges")
        hub = cheb_errors(torch, CK, cheb_operands(torch, tp, hub_g, cfg.eig_wide_block))
        check(max(narrow.values()) <= CHEB_STEP_TOL_OF_SCALE
              and max(hub.values()) <= CHEB_STEP_TOL_OF_SCALE,
              f"fused step, narrow block {narrow}, hub graph {hub}")
    emit({"phase": "cheb_step_shapes", "nvidia_smi": smi,
          "narrow": {"b": CHEB_NARROW_WIDTH, "plan": CK.plan(g5.n_points, CHEB_NARROW_WIDTH),
                     "errors_of_scale": narrow},
          "hub": {"n": hub_g.n_points, "overflow_edges": int(hub_g.overflow.shape[0]),
                  "errors_of_scale": hub}})

    # Warm 'kd' pairs, fused and step by step in turn.
    tg, sg = (tp.mesh_to_graph_arrays(synthetic_bone(tp, seed, levels[0]), device=device)
              for seed in (2, 1))
    draws = tp.make_draws(0, cfg, tg.n_points, sg.n_points)
    warm = {"fused": [], "stepwise": []}
    counts = []
    for name in warm:  # one first call each
        with (stepwise_filter(tp) if name == "stepwise" else contextlib.nullcontext()):
            tp.register_pair(tg, sg, cfg, draws=draws)
    for _ in range(warm_reps):
        for name in warm:
            with (stepwise_filter(tp) if name == "stepwise" else contextlib.nullcontext()):
                CK.LAUNCHES = 0
                sync(torch, device)
                t0 = time.perf_counter()
                tp.register_pair(tg, sg, cfg, draws=draws)
                sync(torch, device)
                warm[name].append(time.perf_counter() - t0)
                rec = spans.RECORDS[-1]
                counts.append({"path": name, "launches": CK.LAUNCHES,
                               "cheb_steps_fused": rec.total("cheb_steps_fused"),
                               "chunks": sum(s["chunks"] for s in rec.solves)})
    for c in counts:
        want = cfg.eig_wide_degree * c["chunks"] if c["path"] == "fused" else 0
        check(c["launches"] == want and c["cheb_steps_fused"] == want,
              f"fused steps of a 'kd' pair: {c}, want {want}")
    pairs = {"kd_warm_s": {k: {"median": statistics.median(v), "all": v}
                           for k, v in warm.items()},
             "counts": counts}
    emit({"phase": "cheb_step_register_pair", "nvidia_smi": smi, **pairs})
    return {"sizes": sizes, "narrow": narrow, "hub": hub,
            "launches_per_pair": counts[0]["launches"], "main": sizes[-1]}


def phase_completion(torch, tp, kernels, smi, device="cuda",
                     hub=(HUB_N, HUB_N), split_n=None, union_levels=5,
                     auction_sizes=AUCTION_SIZES, cpu_auction_max_n=AUCTION_CPU_MAX_N):
    """The JAX package's schedules the port took last, on the card: (a) the
    split-spectra schedule against the fused one on the ``direct_122k_hub``
    pair (``hub`` = (n_theta, n_phi); ``split_n`` the threshold to run it
    at, the package's when None); (b) the union and batched spectra against
    two separate solves; (c) the auction against ``lap_host``'s optimum, and
    its CPU run up to ``cpu_auction_max_n`` rows.  Returns the kernels'
    launches on the split 122k pair."""
    from pyfocusr_tpu_torch import experiments
    from pyfocusr_tpu_torch.ops import assignment as TA
    from pyfocusr_tpu_torch.ops import eigen as TE

    t_phase = time.perf_counter()
    launches = {}

    # (a) split spectra on the hub pair.
    th, sh = uv_sphere(tp, *hub), uv_sphere(tp, *hub, warp=HUB_WARP)
    tgh = tp.mesh_to_graph_arrays(th, device=device)
    sgh = tp.mesh_to_graph_arrays(sh, device=device)
    hcfg = tp.PipelineConfig(**HUB_CFG)
    saved = tp.pipeline._SPLIT_SPECTRA_N
    split_at = saved if split_n is None else split_n
    hub_runs = {}
    try:
        for name, thr in (("split", split_at), ("fused", 0)):
            tp.pipeline._SPLIT_SPECTRA_N = thr
            draws = tp.make_draws(0, hcfg, tgh.n_points, sgh.n_points)
            tp.register_pair(tgh, sgh, hcfg, draws=draws)  # first call
            for mod in kernels.values():
                mod.LAUNCHES = 0
            TE.SOLVES.clear()
            sync(torch, device)
            t0 = time.perf_counter()
            res = tp.register_pair(tgh, sgh, hcfg, draws=draws)
            sync(torch, device)
            secs = time.perf_counter() - t0
            hub_runs[name] = {
                "split": tp.pipeline._want_split(tgh.n_points, sgh.n_points),
                "seconds": secs, "solves": list(TE.SOLVES),
                "launches": {k: mod.LAUNCHES for k, mod in kernels.items()},
                "quality": quality_and_checks(tp, th, sh, res, sh.n_points, min_unique=None),
                "corr": _cpu(res["correspondences"]),
            }
    finally:
        tp.pipeline._SPLIT_SPECTRA_N = saved
    check(hub_runs["split"]["split"] and not hub_runs["fused"]["split"],
          "the hub pair did not take the split schedule at its threshold")
    if device == "cuda":
        check(all(hub_runs["split"]["launches"][k] > 0 for k in ("knn", "umeyama3")),
              f"the split hub pair launched no k-NN or ICP step: {hub_runs['split']['launches']}")
    shared = float((hub_runs["split"].pop("corr") == hub_runs["fused"].pop("corr"))
                   .float().mean())
    launches["split_hub"] = hub_runs["split"]["launches"]
    emit({"phase": "completion_split_spectra", "nvidia_smi": smi, "n": tgh.n_points,
          "overflow_edges": int(tgh.overflow.shape[0]), "threshold": split_at,
          "runs": hub_runs, "correspondences_shared": shared})

    # (b) union and batched spectra against two separate solves.
    ut, us = synthetic_bone(tp, 2, union_levels), synthetic_bone(tp, 1, union_levels)
    utg = tp.mesh_to_graph_arrays(ut, device=device)
    usg = tp.mesh_to_graph_arrays(us, device=device)
    ucfg = tp.PipelineConfig()
    k = ucfg.n_total
    rng = np.random.default_rng(7)
    blocks = [rng.standard_normal((g.n_points, ucfg.eig_wide_block)).astype(np.float32)
              for g in (utg, usg)]
    union_start = rng.standard_normal((utg.n_points + usg.n_points, 2 * k + 8)).astype(
        np.float32)

    def timed_call(fn):
        sync(torch, device)
        t0 = time.perf_counter()
        r = fn()
        sync(torch, device)
        return time.perf_counter() - t0, r

    sep_s, sep = timed_call(lambda: [tp.pipeline._spectrum(
        g, k, ucfg, torch.from_numpy(b).to(device))[:2] for g, b in zip((utg, usg), blocks)])
    uni_s, uni = timed_call(lambda: experiments.spectrum_union(utg, usg, k, union_start, ucfg))
    bat_s, bat = timed_call(lambda: experiments.spectrum_batched(utg, usg, k, blocks, ucfg))
    union = {"separate_s": sep_s, "union_s": uni_s, "batched_s": bat_s}
    for name, got in (("union", [(uni[0][0], uni[1]), (uni[0][1], uni[2])]),
                      ("batched", [(bat[0], bat[1]), (bat[2], bat[3])])):
        worst = [eig_agreement(_cpu(lg), _cpu(vg), _cpu(lw), _cpu(vw))
                 for (lg, vg), (lw, vw) in zip(got, sep)]
        union[name] = {"eigval_max_rel_diff": max(w[0] for w in worst),
                       "eigvec_min_abs_cos": min(w[1] for w in worst)}
        check(union[name]["eigval_max_rel_diff"] <= UNION_EIG_RTOL
              and union[name]["eigvec_min_abs_cos"] > UNION_COS_MIN,
              f"{name} spectra against separate solves: {union[name]}")
    emit({"phase": "completion_union_batched", "nvidia_smi": smi,
          "n": [utg.n_points, usg.n_points], **union})

    # (c) the auction.
    auctions = []
    for n in auction_sizes:
        cost = np.random.default_rng(n).uniform(0, 1, (n, n)).astype(np.float32)
        r_opt, c_opt = TA.lap_host(cost)
        opt = float(cost[r_opt, c_opt].sum())
        dev_s, got = timed_call(lambda: TA.auction_lap(torch.from_numpy(cost).to(device)))
        stats = list(TA.AUCTION_STATS)
        got = got.cpu().numpy()
        gap = (float(cost[np.arange(n), got].sum()) - opt) / opt
        row = {"n": n, "seconds": dev_s, "gap": gap,
               "rounds": [st["iterations"] for st in stats],
               "host_reads": sum(st["host_reads"] for st in stats),
               "graph": all(st["graph"] for st in stats)}
        check(sorted(got.tolist()) == list(range(n)), f"auction at {n}: not a permutation")
        check(gap < AUCTION_GAP_MAX, f"auction at {n}: gap {gap}")
        if n <= cpu_auction_max_n and device != "cpu":
            t0 = time.perf_counter()
            cpu = TA.auction_lap(torch.from_numpy(cost)).numpy()
            row.update(cpu_s=time.perf_counter() - t0,
                       equals_cpu=bool(np.array_equal(cpu, got)))
        auctions.append(row)
    emit({"phase": "completion_auction", "nvidia_smi": smi, "sizes": auctions})
    emit({"phase": "completion", "nvidia_smi": smi, "phase_s": time.perf_counter() - t_phase})
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pyfocusr_tpu_torch as tp
    from pyfocusr_tpu_torch.ops import assignment as TA
    from pyfocusr_tpu_torch.ops import icp as icp_ops
    from pyfocusr_tpu_torch.ops import cpd as cpd_ops

    kernels = kernel_modules()
    knn_kernel, knn_topk_kernel, sinkhorn_kernel, jv_kernel, cpd_estep_kernel, \
        umeyama_kernel, _ = kernels.values()
    smi = nvidia_smi_line()
    cap = torch.cuda.get_device_capability(0)
    emit({
        "phase": "environment",
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "capability": list(cap),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    })
    check(cap == (9, 0), f"compute capability {cap}, the kernels are built for sm_90a")

    # One nvcc per source, all started together (nvcc runs in a subprocess),
    # and the host library: what a pair on the card loads.
    from pyfocusr_tpu_torch.utils import aot

    t0 = time.perf_counter()
    built = aot.build_libraries("cuda")
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "host_gxx_seconds": built["host"],
        "libraries": {
            name: {"nvcc_seconds": mod.BUILD_SECONDS,
                   "ptxas": [ln.strip() for ln in mod.BUILD_LOG.splitlines()
                             if "registers" in ln or "spill" in ln]}
            for name, mod in kernels.items()},
    })

    target_mesh = synthetic_bone(tp, 2)
    source_mesh = synthetic_bone(tp, 1)
    n_t, n_s = target_mesh.n_points, source_mesh.n_points
    knn_results = phase_kernel(torch, knn_kernel, target_mesh.points,
                               source_mesh.points)
    topk_results = phase_knn_topk(torch, knn_kernel, knn_topk_kernel, target_mesh.points,
                                  source_mesh.points)

    # --- The default 'kd' path ---
    cfg = tp.PipelineConfig(**BENCH_CFG)
    draws = tp.make_draws(0, cfg, n_t, n_s)
    tg = tp.mesh_to_graph_arrays(target_mesh)
    sg = tp.mesh_to_graph_arrays(source_mesh)
    check(tg.device.type == "cuda", "mesh_to_graph_arrays builds on the card by default")
    with IcpRecorder(tp.pipeline) as icp_rec:
        res, first_s, kd_warm, kd_launches, peak = drive(
            torch, tp, kernels, tg, sg, cfg, draws, warm_reps=WARM_REPS)
    kd_icp = dict(icp_ops.ICP_STATS)
    # ICP's k-NN launches (2000 x 10242): the eager iteration and each
    # replay; the path's other four queries are 10242 x 10242.
    kd_icp_knn = kd_icp["replays"] + 1
    check(kd_launches["knn"] > 0, "register_pair launched no k-NN kernel")
    check(kd_launches["umeyama3"] > 0, "register_pair launched no Umeyama close kernel")
    check(kd_icp["graph"] and kd_icp["host_reads"]
          <= -(-kd_icp["iterations"] // icp_ops.ICP_BLOCK) + 1,
          f"the 'kd' pair's ICP did not run as a graph loop: {kd_icp}")
    check(kd_launches["knn"] == kd_icp_knn + 4
          and kd_launches["umeyama3"] == kd_icp_knn,
          f"k-NN / close launches {kd_launches} against ICP {kd_icp}")
    q_gpu = quality_and_checks(tp, target_mesh, source_mesh, res, n_s)
    emit({
        "phase": "register_pair_cuda",
        "n_target": n_t, "n_source": n_s, "config": "bench.py:122-134",
        **warm_summary(first_s, kd_warm),
        "knn_launches": kd_launches["knn"], "knn_launches_icp": kd_icp_knn,
        "launches": kd_launches, "icp": kd_icp,
        "peak_device_bytes": peak, "quality": q_gpu,
    })
    umeyama_results, step_results = phase_umeyama(
        torch, icp_ops, umeyama_kernel, icp_rec.last_call,
        class_source=torch.tensor(source_mesh.points, device="cuda"))
    icp_results = phase_icp_loop(torch, icp_ops, knn_kernel, umeyama_kernel,
                                 icp_rec.last_call)

    emit(profile_run(torch, tp, tg, sg, cfg, draws, smi, "profile",
                     "profile_register_pair.txt"))

    # CUDA against CPU on one set of draws, their float starts drawn on the
    # host.
    host = tp.pipeline.host_draws(draws)
    res_gpu = tp.register_pair(tg, sg, cfg, draws=host)
    gpu_icp = dict(icp_ops.ICP_STATS)
    t0 = time.perf_counter()
    res_cpu = tp.register_pair(tg.to("cpu"), sg.to("cpu"), cfg, draws=host)
    cpu_s = time.perf_counter() - t0
    cpu_icp = dict(icp_ops.ICP_STATS)
    q_cpu = quality_and_checks(tp, target_mesh, source_mesh, res_cpu, n_s)
    agree = compare_runs(res_gpu, res_cpu)
    emit({"phase": "cuda_vs_cpu", "cpu_s": cpu_s, "quality_cpu": q_cpu,
          "icp_iterations_cuda": gpu_icp["iterations"],
          "icp_iterations_cpu": cpu_icp["iterations"], **agree})
    check(gpu_icp["iterations"] == cpu_icp["iterations"], "ICP iterations CUDA vs CPU")
    agreement_checks(agree, "CUDA vs CPU")
    del res_cpu, res_gpu

    # --- Template serving and the feature flags on the 'kd' configuration ---
    t0 = time.perf_counter()
    meshes = {1: source_mesh, 2: target_mesh}
    meshes.update({seed: synthetic_bone(tp, seed) for seed in SERVED_SEEDS
                   if seed not in meshes})
    graphs = {1: sg, 2: tg}
    graphs.update({seed: tp.mesh_to_graph_arrays(m) for seed, m in meshes.items()
                   if seed not in graphs})
    emit({"phase": "serving_meshes", "seeds": sorted(meshes),
          "seconds": time.perf_counter() - t0})
    prep, deterministic, served_launches = phase_serving(
        torch, tp, kernels, cfg, meshes, graphs, smi)
    phase_class_template(torch, tp, cfg, prep, meshes, graphs, smi, deterministic)
    phase_features(torch, tp, meshes, smi)
    del prep, graphs
    class_launches, class_h_launches = phase_class_api(torch, tp, kernels, smi,
                                                       deterministic)
    torch.cuda.empty_cache()
    wide_launches = phase_wide_coords(torch, tp, kernels, smi)
    torch.cuda.empty_cache()

    # --- The two 'hungarian' kernels at the costs that path gives them: the
    # spectral coordinates of the 10242 pair (computed before the
    # correspondences, so the 'kd' run above has them) and of the 2562 pair.
    small_t = synthetic_bone(tp, 2, levels=4)
    small_s = synthetic_bone(tp, 1, levels=4)
    hcfg = tp.PipelineConfig(**HUNGARIAN_CFG)
    small_draws = tp.pipeline.host_draws(
        tp.make_draws(0, hcfg, small_t.n_points, small_s.n_points))
    small_tg = tp.mesh_to_graph_arrays(small_t)
    small_sg = tp.mesh_to_graph_arrays(small_s)
    small_kd = tp.register_pair(small_tg, small_sg, cfg, draws=small_draws)
    cost_small = euclidean_cost(torch, small_kd["spectral_coords_source"],
                                small_kd["spectral_coords_target"])
    cost_full = euclidean_cost(torch, res["spectral_coords_source"],
                               res["spectral_coords_target"])
    lse_results = phase_lse(torch, sinkhorn_kernel, (cost_small, cost_full))
    jv_results, jv_config = phase_jv(torch, tp, sinkhorn_kernel, jv_kernel, TA,
                                     cost_small, cost_full)
    del cost_small, cost_full
    torch.cuda.empty_cache()

    # --- The 'hungarian' path at 10242 vertices ---
    hdraws = tp.make_draws(0, hcfg, n_t, n_s)
    hres, h_first_s, (h_warm_s,), h_launches, h_peak = drive(
        torch, tp, kernels, tg, sg, hcfg, hdraws)
    for name in ("knn", "lse_rows", "jv"):
        check(h_launches[name] > 0, f"the 'hungarian' register_pair launched no {name} kernel")
    q_h = quality_and_checks(tp, target_mesh, source_mesh, hres, n_s)
    init = hres["initial_correspondences"]
    init_unique = len(torch.unique(init)) / n_s
    check(init_unique == 1.0, f"'hungarian' initial correspondences are not "
          f"one-to-one: unique fraction {init_unique}")
    emit({
        "phase": "register_pair_hungarian_cuda",
        "n_target": n_t, "n_source": n_s, "config": "bench.py:558-571",
        "first_call_s": h_first_s, "warm_s": h_warm_s, "launches": h_launches,
        "peak_device_bytes": h_peak,
        "initial_unique_fraction": init_unique,
        "initial_lap_objective": lap_objective(
            torch, hres["spectral_coords_source"], hres["spectral_coords_target"], init),
        "quality": q_h,
    })
    emit(profile_run(torch, tp, tg, sg, hcfg, hdraws, smi, "profile_hungarian",
                     "profile_register_pair_hungarian.txt"))
    del hres

    # --- 'hungarian' CUDA vs CPU, on the 2562 pair: the CPU run's plain
    # Sinkhorn loop and plain JV host loop would take minutes at 10242.
    # Both sides take the short Sinkhorn schedule.
    real_lap = tp.pipeline.sinkhorn_jv_lap
    tp.pipeline.sinkhorn_jv_lap = functools.partial(real_lap, **HUNGARIAN_CPU_CHECK_SCHEDULE)
    try:
        small_gpu = tp.register_pair(small_tg, small_sg, hcfg, draws=small_draws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        small_cpu = tp.register_pair(small_tg.to("cpu"), small_sg.to("cpu"), hcfg,
                                     draws=small_draws)
        h_cpu_s = time.perf_counter() - t0
    finally:
        tp.pipeline.sinkhorn_jv_lap = real_lap
    objs = [lap_objective(torch, r["spectral_coords_source"],
                          r["spectral_coords_target"], r["initial_correspondences"])
            for r in (small_gpu, small_cpu)]
    init_agree = float((small_gpu["initial_correspondences"].cpu()
                        == small_cpu["initial_correspondences"]).float().mean())
    # The same cost through the CPU's plain versions (cold start): one
    # optimum, so the kernels' assignment must be the plain versions'.
    src_c = small_gpu["spectral_coords_source"].cpu()
    tgt_c = small_gpu["spectral_coords_target"].cpu()
    t0 = time.perf_counter()
    same_cost = TA.sinkhorn_jv_lap(euclidean_cost(torch, src_c, tgt_c), warm_start=False)
    same_cost_s = time.perf_counter() - t0
    same_agree = float((same_cost == small_gpu["initial_correspondences"].cpu())
                       .float().mean())
    same_obj = lap_objective(torch, src_c, tgt_c, same_cost)
    gpu_obj_on_cpu = lap_objective(torch, src_c, tgt_c,
                                   small_gpu["initial_correspondences"].cpu())
    emit({
        "phase": "hungarian_cuda_vs_cpu", "n": small_t.n_points,
        "why_2562": "the CPU's plain Sinkhorn and JV loops take minutes at 10242",
        "sinkhorn_schedule": HUNGARIAN_CPU_CHECK_SCHEDULE,
        "cpu_s": h_cpu_s,
        "lap_objective_cuda": objs[0], "lap_objective_cpu": objs[1],
        "lap_objective_rel_diff": abs(objs[0] - objs[1]) / objs[1],
        "initial_correspondence_agreement": init_agree,
        "same_cost_cpu_s": same_cost_s,
        "same_cost_agreement": same_agree,
        "same_cost_objective_cuda": gpu_obj_on_cpu,
        "same_cost_objective_cpu": same_obj,
    })
    for r in (small_gpu, small_cpu):
        check(len(torch.unique(r["initial_correspondences"])) == small_s.n_points,
              "'hungarian' initial correspondences at 2562 are not one-to-one")
    check(abs(objs[0] - objs[1]) <= HUNGARIAN_OBJ_RTOL * objs[1],
          "'hungarian' LAP objective CUDA vs CPU")
    check(init_agree >= HUNGARIAN_AGREE_MIN,
          "'hungarian' initial correspondences CUDA vs CPU")
    check(same_agree >= SAME_COST_AGREE_MIN
          and abs(gpu_obj_on_cpu - same_obj) <= SAME_COST_OBJ_RTOL * same_obj,
          "'hungarian' kernels vs plain versions on one cost")

    # --- The second LAP of the path: final correspondences 'hungarian' too,
    # on the 2562 pair (the solver is the one driven at 10242 above).
    fcfg = tp.PipelineConfig(**dict(HUNGARIAN_CFG, final_correspondence_type="hungarian"))
    for mod in kernels.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    fres = tp.register_pair(small_tg, small_sg, fcfg, draws=small_draws)
    torch.cuda.synchronize()
    f_s = time.perf_counter() - t0
    f_launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    f_unique = {key: len(torch.unique(fres[key])) / small_s.n_points
                for key in ("initial_correspondences", "correspondences")}
    emit({"phase": "register_pair_hungarian_final_cuda", "n": small_s.n_points,
          "seconds": f_s, "launches": f_launches, "unique_fraction": f_unique})
    check(f_launches["jv"] == 2 and f_launches["lse_rows"] == 2 * h_launches["lse_rows"],
          f"two LAPs expected with both correspondence types 'hungarian': {f_launches}")
    check(all(frac == 1.0 for frac in f_unique.values()),
          f"'hungarian' final correspondences are not one-to-one: {f_unique}")
    del fres

    torch.cuda.empty_cache()
    fr_launches, rd_launches, est_results, loop_results = cpd_paths(
        torch, tp, kernels, tg, sg, target_mesh, source_mesh, smi)
    torch.cuda.empty_cache()
    est_wide = phase_cpd_estep(torch, cpd_estep_kernel, cpd_ops, wide_estep_cases(torch),
                               phase="cpd_estep_wide_vs_plain",
                               edges=wide_estep_edge_cases(torch),
                               first_ms=FIRST_WIDE_ESTEP_KERNEL_MS)
    torch.cuda.empty_cache()
    phase_native(tp, smi)
    mr_launches, mr_refine_args = phase_multires(torch, tp, kernels, smi)
    torch.cuda.empty_cache()
    co_launches = phase_cohort(torch, tp, kernels, smi, deterministic)
    torch.cuda.empty_cache()
    completion_launches = phase_completion(torch, tp, kernels, smi)
    cheb = phase_cheb_step(torch, tp, kernels, smi)
    torch.cuda.empty_cache()
    gw_launches = phase_groupwise(torch, tp, kernels, smi)
    torch.cuda.empty_cache()
    cli_launches = phase_cli(torch, tp, kernels, smi, deterministic)
    torch.cuda.empty_cache()
    phase_aot(torch, tp, kernels, smi, deterministic)
    torch.cuda.empty_cache()
    sharded_launches = phase_sharded(torch, tp, kernels, smi, deterministic, mr_refine_args)
    del mr_refine_args
    torch.cuda.empty_cache()

    knn_by_case = {r["case"]: r for r in knn_results}
    knn_main, knn_icp = knn_by_case["xyz_k1"], knn_by_case["icp_k1"]
    close_main = umeyama_results[-2]  # the 'kd' pair's first ICP moments, rigid
    step_by_case = {r["case"]: r for r in step_results}
    step_main = step_by_case["kd_first_iteration_scale_False"]
    step_class = step_by_case["class_defaults_all_points"]
    # The main path's shapes: the row pass at the last temperature, and the
    # Sinkhorn-started augmentation, both on the 10242 cost.
    lse_main = next(r for r in lse_results if r["n"] == n_s and r["level"] == 13
                    and not r["transpose"])
    jv_main = next(r for r in jv_results if r["n"] == n_s and r["start"] == "sinkhorn")
    jv_small = next(r for r in jv_results if r["n"] < n_s and r["start"] == "sinkhorn")
    jv_big = next(r for r in jv_results if r["n"] > n_s)
    # The late sigma2 is the one most of the path's EM iterations run at.
    est_main = next(r for r in est_results if r["case"] == f"{n_t}_d3_late")
    est_first = next(r for r in est_results if r["case"] == f"{n_t}_d3_initial")
    est_5000 = next(r for r in est_results if r["case"] == "5000_d3_late")
    topk_main = next(r for r in topk_results if r["case"] == "xyz_k8")
    kernel_entries = [
        {
            "name": "knn",
            "route": "cuda",
            "launches_class_api": class_launches["knn"],
            "launches_class_api_hungarian": class_h_launches["knn"],
            "launches_wide_coords": wide_launches["knn"],
            "source": "pyfocusr_tpu_torch/csrc/knn.cu",
            "replaces": "pyfocusr_tpu/ops/pallas_kernels.py:647",
            "launches": kd_launches["knn"],
            "launches_icp_shape": kd_icp_knn,
            "launches_served_pair": served_launches["knn"],
            "launches_hungarian_path": h_launches["knn"],
            "launches_multires": mr_launches["knn"],
            "launches_cohort": co_launches["knn"],
            "launches_groupwise": gw_launches["knn"],
            "max_abs_err": max(r.get("max_abs_err", 0.0) for r in knn_results),
            "ms": knn_main["kernel_ms"],
            "plain_ms": knn_main["plain_ms"],
            "bound_ms": knn_main["bound_ms"],
            "bound_by": knn_main["bound_by"],
            "library_ms": None,  # cdist + topk: two calls, and the matmul identity
            "shape": f"nq={knn_main['nq']} nr={knn_main['nr']} d=3 k=1",
            "call_ms": knn_main["call_ms"],
            "splits": knn_main["plan"]["splits"],
            "ms_k3": knn_by_case["xyz_k3"]["kernel_ms"],
            "bound_ms_k3": knn_by_case["xyz_k3"]["bound_ms"],
            "icp_shape": {k: knn_icp[k] for k in ("nq", "nr", "kernel_ms", "call_ms",
                                                   "plain_ms", "bound_ms", "plan")},
            "icp_shape_ms_k2_k3": [knn_by_case["icp_k2"]["kernel_ms"],
                                   knn_by_case["icp_k3"]["kernel_ms"]],
        },
        {
            "name": "knn_topk",
            "route": "cuda",
            "source": "pyfocusr_tpu_torch/csrc/knn_topk.cu",
            "replaces": "pyfocusr_tpu/ops/pallas_kernels.py:647",
            # The wide-coordinates path: weighted final locations at WIDE_KS.
            "launches": wide_launches["knn_topk"],
            "launches_other_paths": {
                "kd": kd_launches["knn_topk"], "class_api": class_launches["knn_topk"],
                "multires": mr_launches["knn_topk"], "cohort": co_launches["knn_topk"],
                "groupwise": gw_launches["knn_topk"]},
            "max_abs_err": max(r.get("max_abs_err", 0.0) for r in topk_results),
            "ms": topk_main["kernel_ms"],
            "plain_ms": topk_main["plain_ms"],
            "bound_ms": topk_main["bound_ms"],
            "bound_by": topk_main["bound_by"],
            "library_ms": None,  # cdist + topk: two calls, and the matmul identity
            "shape": f"nq={topk_main['nq']} nr={topk_main['nr']} d=3 k=8",
            "by_case": {r["case"]: {k: r[k] for k in (
                "kernel_ms", "first_version_ms", "call_ms", "plain_ms", "bound_ms",
                "insertions", "distance_only_ms", "grid")}
                for r in topk_results if "kernel_ms" in r},
        },
        {
            "name": "lse_rows",
            "route": "cuda",
            "launches_class_api": class_launches["lse_rows"],
            "launches_class_api_hungarian": class_h_launches["lse_rows"],
            "source": "pyfocusr_tpu_torch/csrc/lse_rows.cu",
            "replaces": "pyfocusr_tpu/ops/pallas_kernels.py:265",
            "launches": h_launches["lse_rows"],
            "max_abs_err": max(r["max_abs_err"] for r in lse_results),
            "ms": lse_main["kernel_ms"],
            "plain_ms": lse_main["plain_ms"],
            "bound_ms": lse_main["bound_ms"],
            "bound_by": lse_main["bound_by"],
            "library_ms": lse_main["logsumexp_ms"],
            "column_pass_ms": next(
                r["kernel_ms"] for r in lse_results
                if r["n"] == n_s and r["level"] == 13 and r["transpose"]),
            "shape": f"cost {n_s}x{n_s} f32, row pass, level 13",
        },
        {
            "name": "jv",
            "route": "cuda",
            "launches_class_api": class_launches["jv"],
            "launches_class_api_hungarian": class_h_launches["jv"],
            "source": "pyfocusr_tpu_torch/csrc/jv.cu",
            "replaces": "pyfocusr_tpu/ops/pallas_kernels.py:422",
            "launches": h_launches["jv"],
            # Of the final duals; the assignment and the step count are
            # held to equality with the plain version.
            "max_abs_err": max(r["max_abs_err"] for r in jv_results
                               if "max_abs_err" in r),
            "col4row_mismatches": sum(r.get("col4row_mismatches", 0)
                                      for r in jv_results),
            "ms": jv_main["kernel_ms"],
            "plain_ms": jv_main["plain_ms"],
            "bound_ms": jv_main["bound_ms"],
            "bound_by": jv_main["bound_by"],
            "library_ms": None,  # no single PyTorch call solves an assignment
            "steps": jv_main["steps"],
            "us_per_step": jv_main["us_per_step"],
            # The same start at 2562 (its 26 MB cost stays in L2) beside
            # 10242 (420 MB: rows come from device memory).
            "us_per_step_2562": jv_small["us_per_step"],
            "us_per_step_10242": jv_main["us_per_step"],
            "cluster_size": jv_config["cluster_size"],
            "threads_per_cta": jv_config["threads_per_cta"],
            "smem_per_cta_bytes": jv_kernel.smem_per_cta_bytes(
                n_s, jv_config["static_smem_bytes"]),
            "max_n": jv_config["max_n"],
            "n_40962": {k: jv_big[k] for k in (
                "steps", "n_free_rows", "kernel_ms", "us_per_step", "budget_hit",
                "cost_bytes")},
            "lap_warm_start_ms": jv_main["warm_start_ms"],
            "lap_bulk_match_ms": jv_main["bulk_match_ms"],
            "shape": f"cost {n_s}x{n_s} f32, Sinkhorn-started, "
                     f"{jv_main['n_free_rows']} free rows",
        },
        {
            "name": "cpd_estep",
            "route": "cuda",
            "launches_class_api": class_launches["cpd_estep"],
            "launches_class_api_hungarian": class_h_launches["cpd_estep"],
            "source": "pyfocusr_tpu_torch/csrc/cpd_estep.cu",
            "replaces": "pyfocusr_tpu/ops/pallas_kernels.py:105,131,159",
            "launches": fr_launches["cpd_estep"],
            "launches_reference_defaults": rd_launches["cpd_estep"],
            # Of the per-point outputs Pt1, P1, PX; the scalars Np and L apart.
            "max_abs_err": max(r["max_abs_err"][k] for r in est_results
                               for k in ("Pt1", "P1", "PX")),
            "max_abs_err_Np_L": max(r["max_abs_err"][k] for r in est_results
                                    for k in ("Np", "L")),
            "ms": est_main["kernel_ms"],
            "plain_ms": est_main["plain_ms"],
            "bound_ms": est_main["bound_ms"],
            "bound_by": est_main["bound_by"],
            # No single PyTorch call computes the E-step; the dense E-step
            # (P materialized, 420 MB here) is the pipeline's other route.
            "library_ms": None,
            "dense_estep_ms": est_main["dense_estep_ms"],
            "call_ms": est_main["call_ms"],
            "den_pass_ms": est_main["den_pass_ms"],
            "row_pass_ms": est_main["row_pass_ms"],
            "ms_initial_sigma2": est_first["kernel_ms"],
            "ms_5000_d3": est_5000["kernel_ms"],
            "bound_ms_5000_d3": est_5000["bound_ms"],
            # The tiled D > 16 instance: the wide-coordinates path's runs
            # (D = 19 at 5000^2) and each timed case of
            # cpd_estep_wide_vs_plain, beside the first version's time.
            "launches_wide_coords": wide_launches["cpd_estep"],
            "max_abs_err_wide": max(r["max_abs_err"][k] for r in est_wide
                                    for k in ("Pt1", "P1", "PX")),
            "max_err_of_scale_wide": max(max(r["max_err_of_scale"].values())
                                         for r in est_wide),
            "wide": {r["case"]: {k: r[k] for k in (
                "kernel_ms", "first_version_ms", "den_pass_ms", "call_ms", "plain_ms",
                "dense_estep_ms", "bound_ms", "bound_by", "grid")}
                for r in est_wide if "kernel_ms" in r},
            "em_loop": {r["case"]: {k: r[k] for k in (
                "iterations", "host_ms_per_iteration", "device_ms_per_iteration",
                "device_span_ms_per_iteration", "replays", "host_reads", "capture_ms")}
                for r in loop_results},
            "shape": f"X {n_s}x3, TY {n_t}x3 f32, the full-resolution run's final "
                     "sigma2, both passes; ms is the device time of the launches, "
                     "call_ms the wrapper's",
        },
        {
            "name": "umeyama3",
            "route": "cuda",
            "launches_class_api": class_launches["umeyama3"],
            "launches_class_api_hungarian": class_h_launches["umeyama3"],
            "source": "pyfocusr_tpu_torch/csrc/umeyama3.cu",
            # No Pallas kernel: the SVD and det of the JAX umeyama, which
            # torch cannot capture in a CUDA graph.
            "replaces": "pyfocusr_tpu/ops/icp.py:48",
            "launches": kd_launches["umeyama3"],
            "launches_served_pair": served_launches["umeyama3"],
            "launches_multires": mr_launches["umeyama3"],
            "launches_cohort": co_launches["umeyama3"],
            "launches_groupwise": gw_launches["umeyama3"],
            "replaces_step": "pyfocusr_tpu/ops/icp.py:110-129",
            # The step: what every ICP iteration launches after its k-NN.
            "max_abs_err": max(max(r["max_abs_err"]["R"] for r in umeyama_results),
                               max(r["err_vs_plain"]["R"] for r in step_results)),
            "max_s_rel_err": max(max(r["max_abs_err"]["s_rel"] for r in umeyama_results),
                                 max(r["err_vs_plain"]["s_rel"] for r in step_results)),
            "max_moved_err_of_scale": max(r["err_vs_plain"]["moved_of_scale"]
                                          for r in step_results),
            "ms": step_main["kernel_ms"],
            "plain_ms": step_main["plain_ms"],
            "bound_ms": step_main["bound_ms"],
            "bound_by": step_main["bound_by"],
            "library_ms": None,  # no single PyTorch call; svd alone in svd_ms
            "replaced_sequence_ms": step_main["replaced_sequence_ms"],
            "ctas": step_main["ctas"],
            "class_shape": {k: step_class[k] for k in (
                "n_source", "n_target", "ctas", "kernel_ms", "replaced_sequence_ms",
                "plain_ms", "bound_ms")},
            # The close alone (ops/icp.umeyama, the cohort's Procrustes).
            "close_ms": close_main["kernel_ms"],
            "close_plain_ms": close_main["plain_ms"],
            "close_bound_ms": close_main["bound_ms"],
            "close_rotations_run": close_main["rotations_run"],
            "close_rotations_needed": close_main["rotations"],
            "svd_ms": close_main["svd_ms"],
            "chain_clocks": close_main["chain_clocks"],
            "icp_loop": {r["case"]: {k: r[k] for k in (
                "iterations", "host_ms_per_iteration", "host_ms_per_iteration_after_capture",
                "device_ms_per_iteration", "device_span_ms_per_iteration",
                "plain_host_ms_per_iteration", "replays", "host_reads", "capture_ms",
                "loop_kernels")}
                for r in icp_results},
            "shape": "the step at the 'kd' pair's first ICP iteration, 2000 x 10242; "
                     "the close alone on its moments (close_*)",
        },
        {
            "name": "cheb_step",
            "route": "cuda",
            "source": "pyfocusr_tpu_torch/csrc/cheb_step.cu",
            # No Pallas kernel: the JAX package's filter step is XLA products.
            "replaces": "pyfocusr_tpu/ops/eigen.py (chebyshev_eigpairs_wide's filter)",
            "launches": kd_launches["cheb_step"],
            "launches_per_pair_counted": cheb["launches_per_pair"],
            "max_err_of_scale": max(max(r["errors_of_scale"].values()) for r in cheb["sizes"]),
            "ms": cheb["main"]["kernel_ms"],
            "plain_ms": cheb["main"]["ell_ms"],
            "bound_ms": cheb["main"]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,  # no single PyTorch call computes the step
            "by_size": {r["n"]: {k: r.get(k) for k in (
                "kernel_ms", "ell_ms", "bound_ms", "kernel_share_of_bound")}
                for r in cheb["sizes"]},
            "shape": f"N={cheb['main']['n']} b={cheb['main']['b']} D={cheb['main']['d']}, "
                     "a step of a chunk's recurrence",
        },
    ]
    for entry in kernel_entries:  # every CLI invocation of the cli phase
        entry["launches_cli"] = cli_launches[entry["name"]]
        # The sharded phase's runs, one count a rank of each setup.
        entry["launches_sharded"] = {
            setup: None if per_rank is None else [c[entry["name"]] for c in per_rank]
            for setup, per_rank in sharded_launches.items()}
        # The completion phase's path: the split 122k hub pair.
        entry["launches_completion"] = {
            path: counts[entry["name"]] for path, counts in completion_launches.items()}
    emit({"kernels": kernel_entries})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
