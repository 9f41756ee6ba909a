#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pyfocusr_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with one NVIDIA H100 (sm_90a),
nvcc and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the five CUDA kernels from ``pyfocusr_tpu_torch/csrc/`` (k-NN,
Sinkhorn row-logsumexp, Jonker-Volgenant, streamed CPD E-step, the 3x3
Umeyama close; one nvcc each, started together) and drives four paths of
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
  through ``register_pair``, each solve timed; CUDA against CPU at 2562.

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

import concurrent.futures
import contextlib
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
FULLRES_CPU_EM_CAP = 10

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
# card against ``lap_host`` (its default sends every square CUDA cost to
# the card).
LAP_DISPATCH_SIZES = (2, 4, 16, 64, 256, 642, 2048)


def emit(obj):
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


def phase_cpd_estep(torch, EK, cpd_ops, cases):
    """The streamed E-step kernel against ``cpd_estep_plain`` on the card at
    the main paths' shapes (10242^2 full resolution, 5000^2 the raw
    defaults) and widths (D = 3; D = 6 with xyz appended), at the initial
    sigma2 of EM and at the small sigma2 a full-resolution run ends at;
    kernel, plain and dense-E-step (P materialized) times and the bound.
    ``kernel_ms`` is the device time of one call of a planned ``CudaEstep``
    (its two launches) from a CUDA graph of calls, ``den_pass_ms`` that of
    the den pass alone, ``row_pass_ms`` the difference; ``call_ms`` one call
    by plain CUDA events, which the host's launch overhead sets when it
    exceeds the device time."""
    results = []
    for name, X, TY, sigma2 in cases:
        (N, D), M = X.shape, TY.shape[0]
        s2 = torch.tensor(sigma2, dtype=torch.float32, device=X.device)
        got = EK.cpd_estep_cuda(X, TY, s2)
        want = EK.cpd_estep_plain(X, TY, s2)
        torch.cuda.synchronize()
        errs, ok = {}, True
        for out, g, w in zip(("Pt1", "P1", "PX", "Np", "L"), got, want):
            check(bool(torch.isfinite(g).all()), f"E-step kernel {out} finite ({name})")
            err = float((g - w).abs().max())
            scale = max(1.0, float(w.abs().max()))
            errs[out] = err
            ok = ok and err <= ESTEP_TOL_OF_SCALE * scale
        est = EK.CudaEstep(X, M)
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
               "max_abs_err": errs, "within_tolerance": ok,
               "kernel_ms": kernel_ms, "den_pass_ms": den_ms,
               "row_pass_ms": kernel_ms - den_ms,
               "call_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               "dense_estep_ms": dense, **estep_bound(M, N, D)}
        check(ok, f"E-step kernel disagrees with its plain version: {res}")
        results.append(res)
    emit({"phase": "cpd_estep_kernel_vs_plain", "cases": results,
          "tolerance": f"max |kernel - plain| <= {ESTEP_TOL_OF_SCALE} x max(1, max |plain|) "
                       "per output",
          "dense_estep_ms": "ops/cpd._estep, P [M, N] materialized: the E-step the "
                            "pipeline takes at or under 3000^2 pairs",
          "first_kernel_version_ms": FIRST_ESTEP_KERNEL_MS,
          "launches": "one E-step is two launches, the den pass and the row pass"})
    return results


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


def close_emulated(cov, var_s, mu_s, mu_d, with_scale, sweeps):
    """The close kernel's steps in numpy float64 (``1 / sqrt`` for the card's
    ``rsqrt``) with ``sweeps`` Jacobi sweeps: out f32 [13] = (s, R, t) and
    the rotations that ran (those whose off-diagonal entry was not 0)."""
    A = np.asarray(cov, np.float64).reshape(3, 3)
    S, V = A.T @ A, np.eye(3)
    rotations = 0
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = S[p, q]
            if apq == 0.0:
                continue
            rotations += 1
            r = 3 - p - q
            theta = (S[q, q] - S[p, p]) / (2.0 * apq)
            t = (0.5 / theta if abs(theta) > 1e150 else
                 (1.0 if theta >= 0 else -1.0) / (abs(theta) + np.sqrt(theta * theta + 1.0)))
            c = 1.0 / np.sqrt(t * t + 1.0)
            sn = t * c
            srp, srq = S[r, p], S[r, q]
            S[p, p] -= t * apq
            S[q, q] += t * apq
            S[p, q] = S[q, p] = 0.0
            S[r, p] = S[p, r] = c * srp - sn * srq
            S[r, q] = S[q, r] = sn * srp + c * srq
            vp, vq = V[:, p].copy(), V[:, q].copy()
            V[:, p], V[:, q] = c * vp - sn * vq, sn * vp + c * vq
    lam = np.diag(S).copy()
    for a, b in ((0, 1), (0, 2), (1, 2)):
        if lam[a] < lam[b]:
            lam[[a, b]] = lam[[b, a]]
            V[:, [a, b]] = V[:, [b, a]]
    v1, v2 = V[:, 0], V[:, 1]
    b1, b2 = A @ v1, A @ v2
    n1 = np.linalg.norm(b1)
    u1 = b1 / n1 if n1 > 0 else v1
    b2 = b2 - (u1 @ b2) * u1
    n2 = np.linalg.norm(b2)
    if n2 > 1e-300 and n2 > 1e-15 * n1:
        u2 = b2 / n2
    else:
        e = np.zeros(3)
        e[int(np.argmin(np.abs(u1)))] = 1.0
        u2 = np.cross(u1, e)
        u2 /= np.linalg.norm(u2)
    R = np.outer(u1, v1) + np.outer(u2, v2) + np.outer(np.cross(u1, u2), np.cross(v1, v2))
    sc = float((R * A).sum()) / max(float(var_s), 1e-30) if with_scale else 1.0
    t = np.asarray(mu_d, np.float64) - sc * (R @ np.asarray(mu_s, np.float64))
    return np.concatenate([[sc], R.ravel(), t]).astype(np.float32), rotations


def close_chain(moments, with_scale, kernel_out):
    """What the close needs on these moments: the fewest Jacobi sweeps whose
    rounded result (``close_emulated``) equals that of the kernel's sweeps,
    the rotations they run, and whether the emulation gives the kernel's
    bits."""
    args = [x.detach().cpu().numpy() for x in moments]
    kernel_sweeps = close_sweeps()
    full, _ = close_emulated(*args, with_scale, kernel_sweeps)
    for sweeps in range(kernel_sweeps + 1):
        out, rotations = close_emulated(*args, with_scale, sweeps)
        if np.array_equal(out, full):
            break
    return {"sweeps_needed": sweeps, "rotations": rotations,
            "emulated_equals_kernel": bool(np.array_equal(
                full, kernel_out.detach().cpu().numpy()))}


def umeyama_bound(rotations: int):
    """Least time of the close, in ms: one thread's chain of dependent f64
    operations, each at its latency (F64_CLOCKS), for the rotations these
    moments need (``close_chain``).  A rotation waits on two divisions, a
    square root, a reciprocal square root and seven FMA-class steps (theta,
    t, c, s, the update of the entries the next rotation reads); then the
    sort, the two left singular vectors (two norms, three divisions), R, s
    and t: about 25 FMA-class steps."""
    c = F64_CLOCKS
    rotation = 2 * c["div"] + c["sqrt"] + c["rsqrt"] + 7 * c["fma"]
    tail = 3 * c["div"] + 2 * c["sqrt"] + 25 * c["fma"]
    cycles = rotations * rotation + tail
    return {"bound_ms": cycles / SM_CLOCK_HZ * 1e3, "bound_by": "operations",
            "chain_clocks": cycles}


def phase_umeyama(torch, icp_ops, UK, icp_call):
    """The close kernel against ``umeyama_close_plain`` (``torch.linalg.svd``
    and ``det`` in f64 on the card, rounded once to f32) on the moments of
    CLOSE_CASES and of the 'kd' pair's first ICP iteration: R within
    CLOSE_R_ATOL, s within CLOSE_S_RTOL, t within CLOSE_T_OF_SCALE of the
    coordinates' scale.  Times: the kernel's device time from a CUDA graph
    of 20 calls, the plain close and ``torch.linalg.svd`` alone between CUDA
    events; the bound from the sweeps each case needs (``close_chain``)."""
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
               "sweeps": close_sweeps(), **chain, **umeyama_bound(chain["rotations"])}
        check(errs["R"] <= CLOSE_R_ATOL and errs["s_rel"] <= CLOSE_S_RTOL
              and errs["t_of_scale"] <= CLOSE_T_OF_SCALE,
              f"Umeyama close kernel disagrees with its plain version: {res}")
        results.append(res)
    emit({"phase": "umeyama_kernel_vs_plain", "cases": results,
          "tolerance": {"R": CLOSE_R_ATOL, "s_rel": CLOSE_S_RTOL, "t_of_scale": CLOSE_T_OF_SCALE},
          "svd_ms": "torch.linalg.svd of the 3x3 covariance alone (the plain close also "
                    "takes two det and the products)"})
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
    around another run less its capture; the plain loop's host time."""
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
        device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
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
             "plain_knn_launches": out["plain"][2][0], **stats}
        results.append(r)
        check(all(equal.values()), f"graph ICP loop differs from the plain loop: {r}")
        check(stats["graph"] and stats["host_reads"] <= -(-bit // K) + 1,
              f"graph ICP loop read the host too often: {r}")
        check(bit <= knn_n < bit + K and bit <= close_n < bit + K
              and out["plain"][2] == (pit, pit),
              f"ICP launches outside [{bit}, {bit} + {K}): {r}")
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
        # smallest singular value of the cross-Gram), single modes by |cos|.
        groups, cur = [], [0]
        for c in range(1, len(lc)):
            if (lc[c] - lc[c - 1]) / lc[c] < DEGENERATE_GAP:
                cur.append(c)
            else:
                groups.append(cur)
                cur = [c]
        groups.append(cur)
        for grp in groups:
            sv = np.linalg.svd(vc[:, grp].T @ vg[:, grp], compute_uv=False)
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


def outputs_differ(torch, a, b):
    """The output keys whose tensors are not equal bit for bit, each with
    its largest absolute difference."""
    out = {}
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if not torch.equal(x, y):
            out[k] = float((x.double() - y.double()).abs().max())
    return out


def timed(torch, fn):
    """(fn(), its wall seconds fenced by torch.cuda.synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
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
    sd = tp.make_draws(0, cfg, small[2].n_points, small[1].n_points)

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
    """``linear_sum_assignment`` on a CUDA cost (the card's Sinkhorn and JV
    solve) against ``lap_host`` on the same cost, at each of ``sizes``:
    uniform [0, 1) costs from a seed, the card's fenced median of ``reps``
    warm calls, the host's one call; the objectives must agree."""
    rows = {}
    for n in sizes:
        c64 = np.random.default_rng(n).uniform(0.0, 1.0, (n, n))
        cost = torch.tensor(c64.astype(np.float32), device="cuda")
        c64 = cost.double().cpu().numpy()
        TA.linear_sum_assignment(cost)
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, col = TA.linear_sum_assignment(cost)
            secs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _, host_col = TA.lap_host(c64)
        host_s = time.perf_counter() - t0
        r = np.arange(n)
        obj, obj_host = float(c64[r, col].sum()), float(c64[r, host_col].sum())
        rows[str(n)] = {"card_s": float(np.median(secs)), "lap_host_s": host_s,
                        "objective_rel_diff": abs(obj - obj_host) / obj_host}
        check(len(np.unique(col)) == n
              and abs(obj - obj_host) <= SAME_COST_OBJ_RTOL * obj_host,
              f"linear_sum_assignment on the card at n = {n}: {rows[str(n)]}")
    return rows


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
        if on_card:
            check(launches["lse_rows"] > 0 and launches["jv"] == 2,
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
        d = tp.make_draws(0, cfg_e, graphs[0].n_points, graphs[1].n_points)
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
        sd = tp.make_draws(0, ccfg, st.n_points, ss.n_points)
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
    """One more register_pair under torch.profiler: wall time, device busy
    time (sum of kernel and copy durations on the card), and each stage's
    host time and the device time of the torch operators it launched (the
    ``lap_*`` ranges lie inside the correspondence stage).  The full table goes to
    build/<table_name>."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tp.register_pair(tg, sg, cfg, draws=draws)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.events()
    busy_us = sum(
        e.time_range.elapsed_us() for e in events
        if e.device_type == DeviceType.CUDA
        and not e.name.startswith("register_pair/")
    )
    # The hand-written kernels are launched through ctypes, outside any
    # torch operator, so the stage ranges' device time misses them: their
    # time is summed here by kernel name.
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
    with CpdRecorder(cpd_ops) as rec:
        cap_gpu = tp.register_pair(tg, sg, cap_cfg, draws=fr_draws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cap_cpu = tp.register_pair(tg.to("cpu"), sg.to("cpu"), cap_cfg, draws=fr_draws)
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
    from pyfocusr_tpu_torch.ops import (
        cpd_estep_kernel,
        jv_kernel,
        knn_kernel,
        sinkhorn_kernel,
        umeyama_kernel,
    )

    kernels = {"knn": knn_kernel, "lse_rows": sinkhorn_kernel, "jv": jv_kernel,
               "cpd_estep": cpd_estep_kernel, "umeyama3": umeyama_kernel}
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

    # One nvcc per source, all started together (nvcc runs in a subprocess).
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        for fut in [pool.submit(mod.load_library) for mod in kernels.values()]:
            fut.result()
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
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
    umeyama_results = phase_umeyama(torch, icp_ops, umeyama_kernel, icp_rec.last_call)
    icp_results = phase_icp_loop(torch, icp_ops, knn_kernel, umeyama_kernel,
                                 icp_rec.last_call)

    emit(profile_run(torch, tp, tg, sg, cfg, draws, smi, "profile",
                     "profile_register_pair.txt"))

    t0 = time.perf_counter()
    res_cpu = tp.register_pair(tg.to("cpu"), sg.to("cpu"), cfg, draws=draws)
    cpu_s = time.perf_counter() - t0
    cpu_icp = dict(icp_ops.ICP_STATS)
    q_cpu = quality_and_checks(tp, target_mesh, source_mesh, res_cpu, n_s)
    agree = compare_runs(res, res_cpu)
    emit({"phase": "cuda_vs_cpu", "cpu_s": cpu_s, "quality_cpu": q_cpu,
          "icp_iterations_cuda": kd_icp["iterations"],
          "icp_iterations_cpu": cpu_icp["iterations"], **agree})
    check(kd_icp["iterations"] == cpu_icp["iterations"], "ICP iterations CUDA vs CPU")
    agreement_checks(agree, "CUDA vs CPU")
    del res_cpu

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

    # --- The two 'hungarian' kernels at the costs that path gives them: the
    # spectral coordinates of the 10242 pair (computed before the
    # correspondences, so the 'kd' run above has them) and of the 2562 pair.
    small_t = synthetic_bone(tp, 2, levels=4)
    small_s = synthetic_bone(tp, 1, levels=4)
    hcfg = tp.PipelineConfig(**HUNGARIAN_CFG)
    small_draws = tp.make_draws(0, hcfg, small_t.n_points, small_s.n_points)
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
    # Sinkhorn loop (840 x 2 logsumexp passes over the cost) and plain JV
    # host loop would take minutes at 10242.
    small_gpu = tp.register_pair(small_tg, small_sg, hcfg, draws=small_draws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    small_cpu = tp.register_pair(small_tg.to("cpu"), small_sg.to("cpu"), hcfg,
                                 draws=small_draws)
    h_cpu_s = time.perf_counter() - t0
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

    knn_by_case = {r["case"]: r for r in knn_results}
    knn_main, knn_icp = knn_by_case["xyz_k1"], knn_by_case["icp_k1"]
    close_main = umeyama_results[-2]  # the 'kd' pair's first ICP moments, rigid
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
    emit({"kernels": [
        {
            "name": "knn",
            "route": "cuda",
            "launches_class_api": class_launches["knn"],
            "launches_class_api_hungarian": class_h_launches["knn"],
            "source": "pyfocusr_tpu_torch/csrc/knn.cu",
            "replaces": "pyfocusr_tpu/ops/pallas_kernels.py:647",
            "launches": kd_launches["knn"],
            "launches_icp_shape": kd_icp_knn,
            "launches_served_pair": served_launches["knn"],
            "launches_hungarian_path": h_launches["knn"],
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
            "max_abs_err": max(r["max_abs_err"]["R"] for r in umeyama_results),
            "max_s_rel_err": max(r["max_abs_err"]["s_rel"] for r in umeyama_results),
            "ms": close_main["kernel_ms"],
            "plain_ms": close_main["plain_ms"],
            "bound_ms": close_main["bound_ms"],
            "bound_by": close_main["bound_by"],
            "library_ms": None,  # no single PyTorch call; svd alone in svd_ms
            "svd_ms": close_main["svd_ms"],
            "chain_clocks": close_main["chain_clocks"],
            "icp_loop": {r["case"]: {k: r[k] for k in (
                "iterations", "host_ms_per_iteration", "host_ms_per_iteration_after_capture",
                "device_ms_per_iteration", "device_span_ms_per_iteration",
                "plain_host_ms_per_iteration", "replays", "host_reads", "capture_ms")}
                for r in icp_results},
            "shape": "cov 3x3 f32, one thread, the 'kd' pair's first ICP iteration",
        },
    ]})
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
