#!/usr/bin/env python3
"""Host cost of the call record (``pyfocusr_tpu_torch/utils/spans.py``) a
registration keeps, with no profiler running.

    python3 tools/spans_cost.py [--levels 5] [--reps 2000] [--device cuda]

Registers the synthetic bone pair of ``chip_smoke.py`` (``--levels`` 5:
10242 vertices, 6: 40962) with the benchmark's 'kd' settings twice, then
reads the second call's record for the operations it held: its stages and
nested spans, its host reads (counted once per read, more than the
``host_read`` blocks that made them), counters and solves.  A record of
those counts is then built ``--reps`` times with nothing between the
operations, and timed by ``time.perf_counter_ns``: the record's own host
cost a pair.  For comparison it times the seven bare
``torch.profiler.record_function`` ranges a pair opened before the record
existed.  Prints one JSON line (microseconds a pair: median and minimum),
with the second call's record read as the benchmark's readers read it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KD = dict(icp_register_first=True, icp_registration_mode="rigid", icp_iterations=100,
          icp_n_landmarks=2000, initial_correspondence_type="kd",
          final_correspondence_type="kd", n_spectral_features=3, n_extra_spectral=3,
          n_coords_spectral_ordering=10000, n_coords_spectral_registration=1000,
          get_weighted_spectral_coords=False, non_rigid_alpha=0.01, non_rigid_beta=50.0,
          non_rigid_max_iterations=300, non_rigid_tolerance=1e-8,
          graph_smoothing_iterations=600, projection_smooth_iterations=1,
          smoothing_method="chebyshev", eig_method="chebyshev", eig_warm_start=True)


def replay(spans, shape, reps: int):
    """Nanoseconds of each of ``reps`` records built to ``shape``."""
    out = []
    stages, nested, reads, counts, solves = (shape[k] for k in
                                             ("stages", "nested", "reads", "counts", "solves"))
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        with spans.call() as rec:
            for i in range(stages):
                rec.stage("s")
                if i == 0:
                    for _ in range(nested):
                        with spans.span("x/y"):
                            pass
                    for _ in range(reads):
                        with spans.host_read("r"):
                            pass
                    for _ in range(counts):
                        spans.count("c", 1)
                    for _ in range(solves):
                        spans.solve(1, False, 1, 0)
        out.append(time.perf_counter_ns() - t0)
    return out


def bare_ranges(reps: int, n: int = 7):
    from torch.profiler import record_function

    out = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            r = record_function("register_pair/x")
            r.__enter__()
            r.__exit__(None, None, None)
        out.append(time.perf_counter_ns() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke
    import pyfocusr_tpu_torch as tp
    from pyfocusr_tpu_torch.utils import spans

    cfg = tp.pipeline.PipelineConfig(**KD)
    t, s = (tp.mesh_to_graph_arrays(chip_smoke.synthetic_bone(tp, seed, levels=args.levels),
                                    device=args.device) for seed in (2, 1))
    for seed in (8, 7):
        draws = tp.pipeline.make_draws(seed, cfg, t.n_points, s.n_points)
        tp.register_pair(t, s, cfg, draws=draws)
    if args.device == "cuda":
        torch.cuda.synchronize()
    rec = spans.RECORDS[-1]
    top = sum(1 for sp in rec.spans if sp[1] is None)
    shape = {"stages": top, "nested": len(rec.spans) - top, "reads": rec.host_syncs(),
             "counts": sum(len(c) for c in rec.counters.values()) + 8,
             "solves": len(rec.solves)}
    assert not torch.autograd._profiler_enabled()
    replay(spans, shape, 50)  # warm
    ns = replay(spans, shape, args.reps)
    bare = bare_ranges(args.reps)
    out = {"levels": args.levels, "n": t.n_points, "device": args.device,
           "card": chip_smoke.nvidia_smi_line() if args.device == "cuda" else "cpu",
           "shape": shape,
           "record_us": {"median": statistics.median(ns) / 1e3, "min": min(ns) / 1e3},
           "bare_stage_ranges_us": {"median": statistics.median(bare) / 1e3,
                                    "min": min(bare) / 1e3},
           "syncs": {f"{st}/{site}": c for (st, site), (c, _) in rec.syncs.items()},
           "untraced_pair": {"host_syncs": rec.host_syncs(), "host_wait_ms": rec.host_wait_ms(),
                             "graph_capture_ms": rec.span_ms("device_loop/capture"),
                             "em_loop_ms": rec.span_ms("cpd/em_loop"),
                             "em_iterations": rec.total("em_iterations"),
                             "chunk_ms": rec.span_ms("spectra/chunk"),
                             "chunks": sum(sv["chunks"] for sv in rec.solves),
                             "wait_ms_by_site": {f"{st}/{site}": ns / 1e6 for (st, site), (_, ns)
                                                 in rec.syncs.items()}}}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
