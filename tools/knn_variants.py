#!/usr/bin/env python3
"""Device time of the k-NN kernel (``csrc/knn.cu``), of variants of it with
constants edited, and of the kernel of other checkouts, in one run on one
CUDA card.

    python3 tools/knn_variants.py [--checkout DIR]... [kQ=2] [kMaxSplit=8] ...

Each positional argument is one variant, a copy of the source edited as
``tools/kernel_variants.py`` describes (``NAME=VALUE`` constants or
``OLD=>NEW`` text) and built under ``build/knn_variants/``.  The source as
it stands is measured first.  ``--checkout DIR`` measures the kernel of
another checkout (its ``knn_kernel.knn_cuda`` as that checkout calls it) in
a process of its own, before and after the variants.

Inputs: the synthetic 10242-vertex pair of ``chip_smoke.py`` (target as
references, source as queries; its first 2000 rows are the ICP shape),
k = 1 and 3 at 10242 x 10242 and k = 1, 2, 3 at 2000 x 10242, D = 3.  Per
case: indices and distances against ``knn_plain`` (must be equal), and the
device time of one call from a CUDA graph of 20 calls replayed between
CUDA events.  Prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from kernel_variants import variant_library

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ((10242, 1), (10242, 3), (2000, 1), (2000, 2), (2000, 3))  # (nq, k)

_MEASURE = r'''
import json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
import pyfocusr_tpu_torch as tp
from pyfocusr_tpu_torch.ops import knn_kernel as KK

CASES = json.loads(sys.argv[2])


def measure():
    ref = torch.tensor(cs.synthetic_bone(tp, 2).points, device="cuda")
    src = torch.tensor(cs.synthetic_bone(tp, 1).points, device="cuda")
    out = {}
    for nq, k in CASES:
        q = src[:nq].contiguous()
        run = lambda: KK.knn_cuda(ref, q, k)
        kd, ki = run()
        pd, pi = KK.knn_plain(ref, q, k)
        torch.cuda.synchronize()
        equal = bool(torch.equal(kd, pd) and torch.equal(ki, pi))
        out[f"{nq}x{ref.shape[0]}_k{k}"] = {
            "ms": cs.graph_ms(torch, run), "equal_to_plain": equal}
    return out
'''

_CHILD = _MEASURE + r'''
print(json.dumps({"checkout": root, "cases": measure()}), flush=True)
'''


def _checkout(root):
    proc = subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(root),
                           json.dumps(CASES)], capture_output=True, text=True,
                          cwd=root, timeout=600)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        raise SystemExit(proc.returncode)
    print(proc.stdout.strip().splitlines()[-1], flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", action="append", default=[])
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("knn_variants: needs a CUDA device", file=sys.stderr)
        return 2
    namespace = {}
    sys.argv = [sys.argv[0], _ROOT, json.dumps(CASES)]
    exec(compile(_MEASURE, "knn_variants_measure", "exec"), namespace)
    KK = namespace["KK"]
    print(json.dumps({"nvidia_smi": namespace["cs"].nvidia_smi_line()}), flush=True)
    for root in args.checkout:
        _checkout(root)
    from pyfocusr_tpu_torch.ops import _cuda_build as build

    real = KK._LIBRARY
    for spec in ["source"] + args.variants:
        KK._LIBRARY = real if spec == "source" else variant_library(
            build, real, "knn.cu", "k-NN variant", spec)
        KK.load_library()
        ptxas = [ln.strip() for ln in KK.BUILD_LOG.splitlines() if "registers" in ln]
        print(json.dumps({"variant": spec, "cases": namespace["measure"](),
                          "ptxas": ptxas}), flush=True)
    KK._LIBRARY = real
    for root in args.checkout:
        _checkout(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
