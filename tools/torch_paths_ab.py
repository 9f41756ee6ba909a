#!/usr/bin/env python3
"""Warm times of the PyTorch port's ``register_pair`` paths ('kd',
'hungarian', full-resolution CPD and the reference's raw ``Focusr``
defaults) and of its Jonker-Volgenant kernel, for several checkouts of the
repository in one run on one CUDA card.

    python3 tools/torch_paths_ab.py PARENT_DIR . . PARENT_DIR [--reps 5]

Each directory is a checkout holding ``pyfocusr_tpu_torch/`` and
``chip_smoke.py``; each is measured in a fresh Python process, in the order
given (so "parent, change, change, parent" spreads the host's drift over
both), on the synthetic 10242-vertex pair and configurations of that
checkout's ``chip_smoke.py``. Per path: one warm-up call, then ``--reps``
calls fenced by ``torch.cuda.synchronize()``, and the kernels' launch
counts of the last call.

Then the JV kernel alone (``ops/jv_kernel.jv_device_cuda``), on inputs made
once by this checkout and saved under ``build/torch_paths_ab/``: the
'hungarian' costs of the synthetic 2562- and 10242-vertex pairs (spectral
coordinates of a 'kd' run), Sinkhorn-started and bulk-matched as the solver
does, under the path's budget of 60 n steps; and a tie-heavy cost at n =
2562 (integers 0-9 from a numpy seed), cold, under a budget that ends
partway. Per case: one call, then ``--jv-reps`` calls between CUDA events.
Every checkout's results must equal the first one's (exit code 1
otherwise). Another configuration of the kernel is measured as a checkout
of its own: a copy with a constant of ``csrc/jv.cu`` edited.

Prints one JSON line per checkout, then one line with the medians of the
paths and the JV kernel's microseconds per step by checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

PATHS = ("kd", "hungarian", "fullres", "reference_defaults")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORK = os.path.join(_ROOT, "build", "torch_paths_ab")

_MAKE_JV_INPUTS = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
import pyfocusr_tpu_torch as tp
from pyfocusr_tpu_torch.ops import assignment as TA
from pyfocusr_tpu_torch.ops import sinkhorn_kernel as SK
out = sys.argv[2]
cfg = tp.PipelineConfig(**cs.BENCH_CFG)
for levels in (4, 5):
    tgt, src = cs.synthetic_bone(tp, 2, levels), cs.synthetic_bone(tp, 1, levels)
    tg, sg = tp.mesh_to_graph_arrays(tgt), tp.mesh_to_graph_arrays(src)
    res = tp.register_pair(tg, sg, cfg, draws=tp.make_draws(0, cfg, tg.n_points, sg.n_points))
    cost = cs.euclidean_cost(torch, res["spectral_coords_source"], res["spectral_coords_target"])
    n = cost.shape[0]
    spread = float(cost.max() - cost.min())
    _, v0 = SK.sinkhorn_duals_streamed(cost, spread / 4.0, 1.0 / 3.0, 14, 30)
    u0, r4c, c4r = TA._bulk_match(cost, v0)
    torch.save({"cost": cost.cpu(), "u0": u0.cpu(), "v0": v0.cpu(), "r4c": r4c.cpu(),
                "c4r": c4r.cpu(), "budget": 60 * n}, f"{out}/sinkhorn_{n}.pt")
n = 2562
cost = torch.tensor(np.random.default_rng(0).integers(0, 10, (n, n)).astype(np.float32))
v0 = torch.zeros(n)
u0, r4c, c4r = TA._bulk_match(cost, v0)
torch.save({"cost": cost, "u0": u0, "v0": v0, "r4c": r4c, "c4r": c4r, "budget": 40 * n},
           f"{out}/ties_{n}.pt")
"""

_CHILD = r"""
import glob, json, os, sys, time
root, reps, work, tag, jv_reps = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                                  sys.argv[4], int(sys.argv[5]))
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
PATHS = (("kd", cs.BENCH_CFG), ("hungarian", cs.HUNGARIAN_CFG),
         ("fullres", cs.FULLRES_CFG), ("reference_defaults", cs.REFERENCE_DEFAULTS_CFG))
for path, kw in PATHS:
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
JV = kernels["jv_kernel"]
out["jv"] = {}
for path in sorted(glob.glob(f"{work}/inputs/*.pt")):
    name = os.path.basename(path)[:-3]
    d = {k: (x.cuda() if torch.is_tensor(x) else x) for k, x in torch.load(path).items()}
    run = lambda: JV.jv_device_cuda(d["cost"], d["u0"], d["v0"], d["r4c"], d["c4r"], d["budget"])
    col, steps, u, v = run()
    torch.cuda.synchronize()
    torch.save({"col": col.cpu(), "steps": steps.cpu(), "u": u.cpu(), "v": v.cpu()},
               f"{work}/out_{tag}_{name}.pt")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(jv_reps):
        run()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / jv_reps
    out["jv"][name] = {"n": d["cost"].shape[0], "steps": int(steps),
                       "n_free_rows": int((d["c4r"] < 0).sum()),
                       "ms": ms, "us_per_step": ms * 1e3 / max(int(steps), 1)}
print(json.dumps(out), flush=True)
"""


def _run(code, cwd, *args):
    proc = subprocess.run([sys.executable, "-c", code, *args], capture_output=True,
                          text=True, cwd=cwd, timeout=900)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        raise SystemExit(proc.returncode)
    return proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkout directories, in run order")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--jv-reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    os.makedirs(os.path.join(_WORK, "inputs"), exist_ok=True)
    _run(_MAKE_JV_INPUTS, _ROOT, _ROOT, os.path.join(_WORK, "inputs"))
    by_root, jv_by_root, equal = {}, {}, True
    for i, root in enumerate(args.roots):
        root = os.path.abspath(root)
        line = _run(_CHILD, root, root, str(args.reps), _WORK, f"dir{i}", str(args.jv_reps))
        print(line, flush=True)
        res = json.loads(line)
        for path in PATHS:
            by_root.setdefault(root, {}).setdefault(path, []).extend(res[path]["warm_s"])
        for name, case in res["jv"].items():
            a = torch.load(f"{_WORK}/out_dir0_{name}.pt")
            b = torch.load(f"{_WORK}/out_dir{i}_{name}.pt")
            same = all(torch.equal(a[k], b[k]) for k in a)
            equal &= same
            jv_by_root.setdefault(root, {}).setdefault(name, []).append(
                {"us_per_step": case["us_per_step"], "equal_to_first": same})
    print(json.dumps({
        "median_warm_s": {root: {path: statistics.median(t) for path, t in paths.items()}
                          for root, paths in by_root.items()},
        "jv_us_per_step": jv_by_root, "jv_equal": equal}), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
