#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pyfocusr_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with one NVIDIA H100 (sm_90a),
nvcc and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the three CUDA kernels from ``pyfocusr_tpu_torch/csrc/`` (k-NN,
Sinkhorn row-logsumexp, Jonker-Volgenant; one nvcc each, started together)
and drives two paths of ``register_pair`` on a synthetic 10242-vertex bone
pair, on CUDA tensors, each with the kernels' launch counts set to 0 just
before and read just after:

* the default 'kd' path at the bench configuration (``bench.py:122-134``),
  once more under ``torch.profiler`` (per-stage host and device time, device
  idle share; the op table goes to ``build/profile_register_pair.txt``), and
  on CPU tensors with the same random draws;
* the 'hungarian' path (``bench.py:558-571``: the bench configuration with
  one-to-one initial correspondences), profiled the same way, and compared
  with the same call on CPU tensors on the 2562-vertex pair (the CPU's
  plain Sinkhorn loop would take minutes at 10242).

Each kernel is held against its plain PyTorch version on the card at the
shapes those paths give it.  Each phase prints one JSON line; any failed
check exits non-zero.  The last three lines are the kernels line, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or without the package beside it, the
script exits non-zero before printing anything.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
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

# Published peaks of one H100 SXM (NVIDIA's data sheet): device-memory
# bandwidth and float32 rate outside the tensor cores.  A kernel's bound is
# the larger of its bytes over the one and its operations over the other.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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
    return tp.TriMesh(pts.astype(np.float32), np.asarray(mesh.triangles, np.int32))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    pattern equal, finite distances within rtol 1e-6."""
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
            "max_abs_err": max_abs, "within_rtol_1e-6": tol_ok}


def phase_kernel(torch, knn_kernel, tgt_pts, src_pts):
    dev = "cuda"
    g = torch.Generator().manual_seed(0)
    ref = torch.tensor(tgt_pts, device=dev)
    query = torch.tensor(src_pts, device=dev)
    spec_ref = (torch.rand(ref.shape, generator=g) - 0.5).to(dev)
    spec_query = (torch.rand(query.shape, generator=g) - 0.5).to(dev)
    timed = [
        # (name, ref, query, k): the main path's shapes
        ("xyz_k1", ref, query, 1),  # warm-start map, ICP (landmark rows)
        ("xyz_k3", ref, query, 3),  # final k=3 query
        ("spectral_k1", spec_ref, spec_query, 1),  # initial correspondences
        ("icp_k1", ref, query[:2000].contiguous(), 1),  # one ICP iteration
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
    ]
    results = []
    for name, r, q, k in contract:
        res = compare_knn(torch, knn_kernel, r.to(dev).contiguous(),
                          q.to(dev).contiguous(), k)
        res.update(case=name, nr=r.shape[0], nq=q.shape[0], d=r.shape[1], k=k)
        results.append(res)
    ties_idx = knn_kernel.knn_cuda(ties.to(dev), ties[::2].contiguous().to(dev), 2)[1]
    check(bool(torch.equal(ties_idx[:, 0].cpu(), torch.arange(0, 100, 2, dtype=torch.int32))),
          "tie rule: lower reference index first")
    for name, r, q, k in timed:
        res = compare_knn(torch, knn_kernel, r, q, k)
        # Alternate plain, kernel, kernel, plain so drift hits both alike.
        p1 = cuda_ms(torch, lambda: knn_kernel.knn_plain(r, q, k))
        k1 = cuda_ms(torch, lambda: knn_kernel.knn_cuda(r, q, k))
        k2 = cuda_ms(torch, lambda: knn_kernel.knn_cuda(r, q, k))
        p2 = cuda_ms(torch, lambda: knn_kernel.knn_plain(r, q, k))
        res.update(case=name, nr=r.shape[0], nq=q.shape[0], d=r.shape[1], k=k,
                   kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
        results.append(res)
    for res in results:
        check(res["idx_equal"] and res["inf_equal"] and res["within_rtol_1e-6"],
              f"k-NN kernel disagrees with its plain version: {res}")
    emit({"phase": "knn_kernel_vs_plain", "cases": results})
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


def phase_jv(torch, SK, JV, TA, cost_small, cost_full):
    """The Jonker-Volgenant kernel against ``jv_device_plain`` (a host loop,
    run on CPU copies of the same inputs: both do the same f32 additions,
    subtractions and comparisons, so the results must be equal), warm-started from the
    Sinkhorn duals and cold, and against scipy at n = 2562; at n = 10242 the
    duality certificate, the budget and the time per step."""
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
                   "kernel_ms": ms, "us_per_step": ms * 1e3 / max(steps, 1),
                   "permutation": bool(torch.equal(
                       torch.sort(col.long()).values, torch.arange(n, device="cuda"))),
                   **dual_certificate(torch, cost, col, u, v)}
            if start == "sinkhorn":
                res.update(lap_ms)
            check(res["permutation"], f"JV kernel result is no permutation: {res}")
            check(steps < budget, f"JV step budget hit: {res}")
            check(res["min_reduced_cost"] >= -1e-5 * spread
                  and res["duality_gap_rel"] <= 1e-5,
                  f"JV duality certificate fails: {res}")
            if scipy_obj is not None:
                res["scipy_objective"] = scipy_obj
                check(abs(res["objective"] - scipy_obj) <= 1e-6 * scipy_obj,
                      f"JV objective differs from scipy's: {res}")
            t0 = time.perf_counter()
            pcol, psteps, pu, pv = JV.jv_device_plain(
                cost.cpu(), u0.cpu(), v0.cpu(), r4c.cpu(), c4r.cpu(), budget)
            res["plain_ms"] = (time.perf_counter() - t0) * 1e3
            res["plain_on"] = "cpu"
            res["col4row_equal"] = bool(torch.equal(pcol, col.cpu()))
            res["steps_equal"] = int(psteps) == steps
            res["duals_equal"] = bool(torch.equal(pu, u.cpu())
                                      and torch.equal(pv, v.cpu()))
            res["max_abs_err"] = max(float((pu - u.cpu()).abs().max()),
                                     float((pv - v.cpu()).abs().max()))
            res["col4row_mismatches"] = int((pcol != col.cpu()).sum())
            check(res["col4row_equal"] and res["steps_equal"] and res["duals_equal"],
                  f"JV kernel disagrees with its plain version: {res}")
            # Rows visited are re-read from device memory: 4 n bytes a step.
            bytes_ms = (min(steps, n) * n + 8 * n) * 4 / HBM_BYTES_PER_S * 1e3
            ops_ms = 5 * steps * n / F32_OPS_PER_S * 1e3
            res["bound_ms"] = max(bytes_ms, ops_ms)
            res["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
            results.append(res)
    emit({"phase": "jv_kernel_vs_plain", "cases": results})
    return results


def quality_and_checks(tp, target_mesh, source_mesh, res, n_s):
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
    check(q["unique_fraction"] > 0.6, f"unique fraction {q['unique_fraction']}")
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
            for tag in ("knn_kernel", "lse_rows_kernel", "lse_cols", "jv_kernel"):
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


def drive(torch, tp, kernels, tg, sg, cfg, draws):
    """The path once to warm up, then once with every kernel's launch count
    set to 0 just before and read just after.  Returns (result, first-call
    seconds, warm seconds, launches by kernel, peak device bytes)."""
    t0 = time.perf_counter()
    tp.register_pair(tg, sg, cfg, draws=draws)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for mod in kernels.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    res = tp.register_pair(tg, sg, cfg, draws=draws)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    return res, first_s, warm_s, launches, torch.cuda.max_memory_allocated()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pyfocusr_tpu_torch as tp
    from pyfocusr_tpu_torch.ops import assignment as TA
    from pyfocusr_tpu_torch.ops import jv_kernel, knn_kernel, sinkhorn_kernel

    kernels = {"knn": knn_kernel, "lse_rows": sinkhorn_kernel, "jv": jv_kernel}
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
    res, first_s, warm_s, kd_launches, peak = drive(torch, tp, kernels, tg, sg, cfg, draws)
    check(kd_launches["knn"] > 0, "register_pair launched no k-NN kernel")
    q_gpu = quality_and_checks(tp, target_mesh, source_mesh, res, n_s)
    emit({
        "phase": "register_pair_cuda",
        "n_target": n_t, "n_source": n_s, "config": "bench.py:122-134",
        "first_call_s": first_s, "warm_s": warm_s,
        "knn_launches": kd_launches["knn"], "launches": kd_launches,
        "peak_device_bytes": peak, "quality": q_gpu,
    })

    emit(profile_run(torch, tp, tg, sg, cfg, draws, smi, "profile",
                     "profile_register_pair.txt"))

    t0 = time.perf_counter()
    res_cpu = tp.register_pair(tg.to("cpu"), sg.to("cpu"), cfg, draws=draws)
    cpu_s = time.perf_counter() - t0
    q_cpu = quality_and_checks(tp, target_mesh, source_mesh, res_cpu, n_s)
    agree = compare_runs(res, res_cpu)
    emit({"phase": "cuda_vs_cpu", "cpu_s": cpu_s, "quality_cpu": q_cpu, **agree})
    check(agree["eigval_max_rel_diff"] <= EIGVAL_RTOL, "eigenvalues CUDA vs CPU")
    check(agree["eigvec_min_abs_cos"] >= COS_MIN, "eigenvectors CUDA vs CPU")
    check(agree["correspondence_agreement"] >= CORR_AGREE_MIN,
          "final correspondences CUDA vs CPU")
    check(abs(agree["unique_fraction_gpu"] - agree["unique_fraction_cpu"])
          <= UNIQUE_DIFF_MAX, "unique fraction CUDA vs CPU")
    del res_cpu

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
    jv_results = phase_jv(torch, sinkhorn_kernel, jv_kernel, TA, cost_small, cost_full)
    del cost_small, cost_full
    torch.cuda.empty_cache()

    # --- The 'hungarian' path at 10242 vertices ---
    hdraws = tp.make_draws(0, hcfg, n_t, n_s)
    hres, h_first_s, h_warm_s, h_launches, h_peak = drive(
        torch, tp, kernels, tg, sg, hcfg, hdraws)
    for name, count in h_launches.items():
        check(count > 0, f"the 'hungarian' register_pair launched no {name} kernel")
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

    knn_main = next(r for r in knn_results if r["case"] == "xyz_k1")
    knn_ops_ms = knn_main["nq"] * knn_main["nr"] * (3 * knn_main["d"] + 1) \
        / F32_OPS_PER_S * 1e3  # sub, mul, add per dimension and one compare
    knn_bytes_ms = (knn_main["nq"] + knn_main["nr"]) * knn_main["d"] * 4 \
        / HBM_BYTES_PER_S * 1e3
    # The main path's shapes: the row pass at the last temperature, and the
    # Sinkhorn-started augmentation, both on the 10242 cost.
    lse_main = next(r for r in lse_results if r["n"] == n_s and r["level"] == 13
                    and not r["transpose"])
    jv_main = next(r for r in jv_results if r["n"] == n_s and r["start"] == "sinkhorn")
    emit({"kernels": [
        {
            "name": "knn",
            "route": "cuda",
            "source": "pyfocusr_tpu_torch/csrc/knn.cu",
            "replaces": "pyfocusr_tpu/ops/pallas_kernels.py:647",
            "launches": kd_launches["knn"],
            "launches_hungarian_path": h_launches["knn"],
            "max_abs_err": max(r["max_abs_err"] for r in knn_results),
            "ms": knn_main["kernel_ms"],
            "plain_ms": knn_main["plain_ms"],
            "bound_ms": max(knn_ops_ms, knn_bytes_ms),
            "bound_by": "operations" if knn_ops_ms >= knn_bytes_ms else "bytes",
            "library_ms": None,  # cdist + topk: two calls, and the matmul identity
            "shape": f"nq={knn_main['nq']} nr={knn_main['nr']} d=3 k=1",
        },
        {
            "name": "lse_rows",
            "route": "cuda",
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
            "source": "pyfocusr_tpu_torch/csrc/jv.cu",
            "replaces": "pyfocusr_tpu/ops/pallas_kernels.py:422",
            "launches": h_launches["jv"],
            # Of the final duals; the assignment and the step count are
            # held to equality with the plain version.
            "max_abs_err": max(r["max_abs_err"] for r in jv_results),
            "col4row_mismatches": sum(r["col4row_mismatches"] for r in jv_results),
            "ms": jv_main["kernel_ms"],
            "plain_ms": jv_main["plain_ms"],
            "bound_ms": jv_main["bound_ms"],
            "bound_by": jv_main["bound_by"],
            "library_ms": None,  # no single PyTorch call solves an assignment
            "steps": jv_main["steps"],
            "us_per_step": jv_main["us_per_step"],
            "lap_warm_start_ms": jv_main["warm_start_ms"],
            "lap_bulk_match_ms": jv_main["bulk_match_ms"],
            "shape": f"cost {n_s}x{n_s} f32, Sinkhorn-started, "
                     f"{jv_main['n_free_rows']} free rows",
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
