#!/usr/bin/env python3
"""Warm times of the PyTorch port's 'kd' and 'hungarian' ``register_pair``
paths, for several checkouts of the repository in one run on one CUDA card.

    python3 tools/torch_paths_ab.py PARENT_DIR . . PARENT_DIR [--reps 5]

Each directory is a checkout holding ``pyfocusr_tpu_torch/`` and
``chip_smoke.py``; each is measured in a fresh Python process, in the order
given (so "parent, change, change, parent" spreads the host's drift over
both), on the synthetic 10242-vertex pair and configurations of that
checkout's ``chip_smoke.py``. Per path: one warm-up call, then ``--reps``
calls fenced by ``torch.cuda.synchronize()``, and the kernels' launch
counts of the last call. Prints one JSON line per checkout, then one line
with the medians by checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import json, sys, time
root, reps = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
import torch
import chip_smoke as cs
import pyfocusr_tpu_torch as tp
import importlib
kernels = {}
for name in ("knn_kernel", "sinkhorn_kernel", "jv_kernel", "cpd_estep_kernel"):
    try:
        kernels[name] = importlib.import_module(f"pyfocusr_tpu_torch.ops.{name}")
    except ImportError:
        pass
for mod in kernels.values():
    mod.load_library()
target, source = cs.synthetic_bone(tp, 2), cs.synthetic_bone(tp, 1)
tg, sg = tp.mesh_to_graph_arrays(target), tp.mesh_to_graph_arrays(source)
out = {"root": root}
for path, kw in (("kd", cs.BENCH_CFG), ("hungarian", cs.HUNGARIAN_CFG)):
    cfg = tp.PipelineConfig(**kw)
    draws = tp.make_draws(0, cfg, tg.n_points, sg.n_points)
    tp.register_pair(tg, sg, cfg, draws=draws)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        for mod in kernels.values():
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        tp.register_pair(tg, sg, cfg, draws=draws)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out[path] = {"warm_s": times,
                 "launches": {n: m.LAUNCHES for n, m in kernels.items()}}
print(json.dumps(out), flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkout directories, in run order")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    by_root = {}
    for root in args.roots:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", _CHILD, root, str(args.reps)],
                              capture_output=True, text=True, cwd=root, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        res = json.loads(line)
        for path in ("kd", "hungarian"):
            by_root.setdefault(root, {}).setdefault(path, []).extend(res[path]["warm_s"])
    print(json.dumps({"median_warm_s": {
        root: {path: statistics.median(t) for path, t in paths.items()}
        for root, paths in by_root.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
