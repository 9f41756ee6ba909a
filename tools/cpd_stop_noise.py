#!/usr/bin/env python3
"""How CPD's stop test at the bench tolerance moves a registration: the same
``register_pair`` call on CPU tensors under several torch thread counts,
which change only the order of float32 sums.

On ``chip_smoke.py``'s synthetic bone pair at 2562 vertices
(``CPU_CHECK_LEVELS``) and the bench configuration (``BENCH_CFG``, CPD
tolerance 1e-8), each with ``make_draws(0, ...)``:

* the class-template pair of ``chip_smoke.py`` (target seed 3, source seed
  4), cold and from the seed-2 template's ``warm_block``, the template
  prepared under the same thread count, as one process would;
* the seed-2 / seed-1 pair under each feature flag with the meshes'
  thickness scalar, at CPD tolerance 1e-8 and 1e-6 (the tolerance of
  ``chip_smoke.FEATURE_CHECK_TOLERANCE`` and the parity tests).

For each case and thread count it prints the CPD iterations and the unique
fraction, and for each two thread counts the share of equal final
correspondences and the smallest |cos| of the source's sorted
eigenvectors.  One JSON line a case.

    python3 tools/cpd_stop_noise.py [--threads 1,2,3,4,6,8] [--cases SUBSTRING]

Runs on the CPU, a minute or two a case and thread count (about 20
minutes in all).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import pyfocusr_tpu_torch as tp  # noqa: E402
from pyfocusr_tpu_torch.ops import cpd as cpd_ops  # noqa: E402


def min_abs_cos(a, b):
    a = a - a.mean(0)
    b = b - b.mean(0)
    cos = (a * b).sum(0) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))
    return float(np.abs(cos).min())


def survey(name, threads, call, target_mesh, source_mesh):
    runs = {}
    for n in threads:
        torch.set_num_threads(n)
        res = call()
        runs[n] = {
            "res": res,
            "cpd_iterations": cpd_ops.EM_STATS["iterations"],
            "unique_fraction": tp.registration_quality(
                target_mesh, source_mesh, res)["unique_fraction"],
        }
    pairs = []
    for a, b in itertools.combinations(threads, 2):
        ra, rb = runs[a]["res"], runs[b]["res"]
        pairs.append({
            "threads": [a, b],
            "correspondence_agreement": float(
                (ra["correspondences"] == rb["correspondences"]).float().mean()),
            "source_sorted_min_abs_cos": min_abs_cos(
                ra["eig_vecs_source_sorted"].double().numpy(),
                rb["eig_vecs_source_sorted"].double().numpy()),
        })
    print(json.dumps({
        "case": name,
        "by_threads": {n: {k: v for k, v in r.items() if k != "res"}
                       for n, r in runs.items()},
        "pairs": pairs,
    }), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", default="1,2,3,4,6,8")
    ap.add_argument("--cases", default="", help="run the cases whose name has this")
    args = ap.parse_args()
    threads = [int(t) for t in args.threads.split(",")]

    meshes = {s: cs.synthetic_bone(tp, s, levels=cs.CPU_CHECK_LEVELS)
              for s in (1, 2, 3, 4)}
    graphs = {s: tp.mesh_to_graph_arrays(m, device="cpu") for s, m in meshes.items()}
    cfg = tp.PipelineConfig(**cs.BENCH_CFG)

    ts, ss = cs.CLASS_PAIR_SEEDS
    draws = tp.make_draws(0, cfg, graphs[ts].n_points, graphs[ss].n_points)
    block = tp.make_draws(0, cfg, graphs[2].n_points,
                          graphs[1].n_points)["eig_block_target"]

    def class_pair(warm):
        kw = {}
        if warm:
            template = tp.prepare_target(graphs[2], cfg, block)
            kw["warm_block"] = tp.warm_block_from_prepared(template, graphs[2])
        return tp.register_pair(graphs[ts], graphs[ss], cfg, draws=draws, **kw)

    for name, warm in (("class_pair_cold", False), ("class_pair_warm_block", True)):
        if args.cases in name:
            survey(name, threads, lambda: class_pair(warm), meshes[ts], meshes[ss])

    feat = {s: tp.mesh_to_graph_arrays(
        meshes[s], node_features=meshes[s].point_data[cs.FEATURE], device="cpu")
        for s in (1, 2)}
    for flag in cs.FEATURE_FLAGS:
        for tol in (1e-8, cs.FEATURE_CHECK_TOLERANCE):
            if args.cases not in f"{flag}_tol_{tol:g}":
                continue
            fcfg = tp.PipelineConfig(**dict(cs.BENCH_CFG, non_rigid_tolerance=tol,
                                            **{flag: True}))
            fdraws = tp.make_draws(0, fcfg, feat[2].n_points, feat[1].n_points)
            survey(f"{flag}_tol_{tol:g}", threads, lambda: tp.register_pair(
                feat[2], feat[1], fcfg, draws=fdraws), meshes[2], meshes[1])


if __name__ == "__main__":
    main()
