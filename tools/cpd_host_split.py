#!/usr/bin/env python3
"""Host and device time of the PyTorch port's CPD EM loop, per iteration and
split by part, for several checkouts of the repository in one run on one
CUDA card.

    python3 tools/cpd_host_split.py PARENT_DIR . [--out FILE]

Each directory is a checkout holding ``pyfocusr_tpu_torch/`` and
``chip_smoke.py``; each is measured in a fresh Python process on the
synthetic 10242-vertex pair of that checkout's ``chip_smoke.py``. For each
path ('kd': 1000 control points, dense E-step; full resolution: 10242,
streamed; the raw ``Focusr`` defaults: 5000, streamed) one
``register_pair`` call records the arguments of its ``_deformable_cpd_run``;
that call (and the affine pre-pass's ``_affine_cpd_run``, where the path
has one, three times between fences) is then repeated alone:

* twice between ``torch.cuda.synchronize()`` fences (host wall time), and
  where the checkout's loops take ``loop="plain"``, twice more with it;
* once under ``torch.profiler`` with ``record_function`` ranges put around
  the E-step (``ops/cpd.py``'s ``cpd_estep`` or ``_estep``, where the
  checkout's loop calls them by those names), ``torch.linalg.solve`` /
  ``solve_ex``, and every ``Tensor.__bool__`` (the stop test's read of the
  device). The M-step ops are the rest of the run's host time. Device time
  is the sum of the card's kernel and copy durations in the trace.

Each range's host time includes whatever the device makes it wait for: the
stop-test read waits for the iteration's kernels, and ``linalg.solve`` waits
for its own ``info`` check. The profiler adds its own cost to every op, so
the profiled host times read high beside the fenced wall time.

Prints one JSON line per checkout (and writes them to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import inspect, json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function
import chip_smoke as cs
import pyfocusr_tpu_torch as tp
from pyfocusr_tpu_torch.ops import cpd as cpd_ops
from pyfocusr_tpu_torch.ops import cpd_estep_kernel as EK

EK.load_library()
target, source = cs.synthetic_bone(tp, 2), cs.synthetic_bone(tp, 1)
tg, sg = tp.mesh_to_graph_arrays(target), tp.mesh_to_graph_arrays(source)
paths = (("kd", cs.BENCH_CFG), ("fullres", cs.FULLRES_CFG),
         ("reference_defaults", cs.REFERENCE_DEFAULTS_CFG))

has_loop = "loop" in inspect.signature(cpd_ops._deformable_cpd_run).parameters

def fenced_ms(fn, a, k, iters):
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*a, **k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / max(iters, 1))
    return times

def ranged(name, fn):
    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped

out = {"root": root, "nvidia_smi": cs.nvidia_smi_line()}
real_run, real_affine = cpd_ops._deformable_cpd_run, cpd_ops._affine_cpd_run
for path, kw in paths:
    cfg = tp.PipelineConfig(**kw)
    draws = tp.make_draws(0, cfg, tg.n_points, sg.n_points)
    seen, seen_affine = [], []
    def recording(*a, **k):
        seen.append((a, k))
        return real_run(*a, **k)
    def recording_affine(*a, **k):
        seen_affine.append((a, k))
        return real_affine(*a, **k)
    cpd_ops._deformable_cpd_run = recording
    cpd_ops._affine_cpd_run = recording_affine
    tp.register_pair(tg, sg, cfg, draws=draws)
    cpd_ops._deformable_cpd_run, cpd_ops._affine_cpd_run = real_run, real_affine
    args, kwargs = seen[-1]
    affine = None
    if seen_affine:  # the affine pre-pass: fenced wall time per iteration
        a_args, a_kwargs = seen_affine[-1]
        a_walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a_res = real_affine(*a_args, **a_kwargs)
            torch.cuda.synchronize()
            a_walls.append(time.perf_counter() - t0)
        a_it = int(a_res[-1])
        affine = {"iterations": a_it,
                  "wall_ms_per_iteration": [w * 1e3 / max(a_it, 1) for w in a_walls],
                  "em_stats": dict(getattr(cpd_ops, "EM_STATS", {}))}
        if has_loop:
            affine["plain_wall_ms_per_iteration"] = fenced_ms(
                real_affine, a_args, dict(a_kwargs, loop="plain"), a_it)
    torch.cuda.synchronize()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = real_run(*args, **kwargs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    iters = int(res[3])
    plain = fenced_ms(real_run, args, dict(kwargs, loop="plain"), iters) if has_loop else None
    patches = [(cpd_ops, "_estep", "cpd/estep"), (torch.linalg, "solve", "cpd/solve"),
               (torch.linalg, "solve_ex", "cpd/solve"), (torch.Tensor, "__bool__", "cpd/stop_read")]
    if hasattr(cpd_ops, "cpd_estep"):
        patches.append((cpd_ops, "cpd_estep", "cpd/estep"))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, rng in patches:
        setattr(obj, name, ranged(rng, getattr(obj, name)))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("cpd/run"):
                real_run(*args, **kwargs)
            torch.cuda.synchronize()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    host_us, device_us = {}, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("cpd/"):
            host_us[e.name] = host_us.get(e.name, 0.0) + e.time_range.elapsed_us()
        elif e.device_type == DeviceType.CUDA and not e.name.startswith("cpd/"):
            device_us += e.time_range.elapsed_us()
    parts = {k.split("/")[1]: v / 1e3 / max(iters, 1) for k, v in host_us.items()}
    parts["m_step_and_rest"] = parts["run"] - sum(v for k, v in parts.items() if k != "run")
    out[path] = {
        "n_control": int(args[1].shape[0]), "n_x": int(args[0].shape[0]),
        "estep_impl": kwargs.get("estep_impl", "dense"), "iterations": iters,
        "wall_ms_per_iteration": [w * 1e3 / max(iters, 1) for w in walls],
        "profiled_host_ms_per_iteration": parts,
        "device_ms_per_iteration": device_us / 1e3 / max(iters, 1),
        "em_stats": dict(getattr(cpd_ops, "EM_STATS", {})),
        "plain_loop_wall_ms_per_iteration": plain,
        "affine_prepass": affine,
    }
print(json.dumps(out), flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkout directories, in run order")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    lines = []
    for root in args.roots:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", _CHILD, root], capture_output=True,
                              text=True, cwd=root, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
