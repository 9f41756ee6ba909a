#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pyfocusr_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with one NVIDIA H100 (sm_90a),
nvcc and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the k-NN CUDA kernel from ``pyfocusr_tpu_torch/csrc/knn.cu``,
holds it against its plain PyTorch version on the card, drives
``register_pair`` on a synthetic 10242-vertex bone pair at the bench
configuration (``bench.py:122-134``) on CUDA tensors, once more under
``torch.profiler`` (per-stage host and device time, device idle share; the
op table goes to ``build/profile_register_pair.txt``), and then on
CPU tensors with the same random draws, and compares the two.  Each phase prints one
JSON line; any failed check exits non-zero.  The last three lines are the
kernels line, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero before printing anything.
"""

from __future__ import annotations

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


def profile_run(torch, tp, tg, sg, cfg, draws, smi):
    """One more register_pair under torch.profiler: wall time, device busy
    time (sum of kernel and copy durations on the card), and each stage's
    host time and the device time of the work it launched.  The full table
    goes to build/profile_register_pair.txt."""
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
    stages = [
        {"stage": e.name.split("/", 1)[1],
         "host_ms": e.time_range.elapsed_us() / 1e3,
         "device_ms": _device_us(e) / 1e3}
        for e in events
        if e.device_type == DeviceType.CPU and e.name.startswith("register_pair/")
    ]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(ROOT, "build", "profile_register_pair.txt"), "w") as f:
        f.write(smi + "\n" + table)
    return {"phase": "profile", "wall_s": wall_s, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s, "stages": stages,
            "table": "build/profile_register_pair.txt"}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pyfocusr_tpu_torch as tp
    from pyfocusr_tpu_torch.ops import knn_kernel

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

    t0 = time.perf_counter()
    knn_kernel.load_library()
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "nvcc_seconds": knn_kernel.BUILD_SECONDS,
        "ptxas": [ln.strip() for ln in knn_kernel.BUILD_LOG.splitlines()
                  if "registers" in ln or "spill" in ln],
    })

    target_mesh = synthetic_bone(tp, 2)
    source_mesh = synthetic_bone(tp, 1)
    n_t, n_s = target_mesh.n_points, source_mesh.n_points
    kernel_results = phase_kernel(torch, knn_kernel, target_mesh.points,
                                  source_mesh.points)

    cfg = tp.PipelineConfig(**BENCH_CFG)
    draws = tp.make_draws(0, cfg, n_t, n_s)
    tg = tp.mesh_to_graph_arrays(target_mesh, device="cuda")
    sg = tp.mesh_to_graph_arrays(source_mesh, device="cuda")
    t0 = time.perf_counter()
    tp.register_pair(tg, sg, cfg, draws=draws)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    knn_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    res = tp.register_pair(tg, sg, cfg, draws=draws)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = knn_kernel.LAUNCHES
    check(launches > 0, "register_pair launched no k-NN kernel")
    peak = torch.cuda.max_memory_allocated()
    q_gpu = quality_and_checks(tp, target_mesh, source_mesh, res, n_s)
    emit({
        "phase": "register_pair_cuda",
        "n_target": n_t, "n_source": n_s, "config": "bench.py:122-134",
        "first_call_s": first_s, "warm_s": warm_s,
        "knn_launches": launches, "peak_device_bytes": peak,
        "quality": q_gpu,
    })

    emit(profile_run(torch, tp, tg, sg, cfg, draws, smi))

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

    main_case = next(r for r in kernel_results if r["case"] == "xyz_k1")
    emit({"kernels": [{
        "name": "knn",
        "route": "cuda",
        "source": "pyfocusr_tpu_torch/csrc/knn.cu",
        "replaces": "pyfocusr_tpu/ops/pallas_kernels.py:647",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_results),
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "shape": f"nq={main_case['nq']} nr={main_case['nr']} d=3 k=1",
    }]})
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
