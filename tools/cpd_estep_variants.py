#!/usr/bin/env python3
"""Device time of the streamed CPD E-step kernel (``csrc/cpd_estep.cu``) and
of variants of it with constants edited, in one run on one CUDA card.

    python3 tools/cpd_estep_variants.py [kTile=256] [kRows=8,kWarps=8] ...

Each argument is one variant: comma-separated ``NAME=VALUE`` pairs, each
replacing ``constexpr int NAME = ...;`` in a copy of the source built under
``build/cpd_estep_variants/``, or one literal replacement ``OLD=>NEW`` of
source text (several joined by ``' ;; '``); the source as it stands is
measured first.
Inputs are uniform random clouds from a torch seed (the kernel's time does
not depend on the values) at 10242^2 and 5000^2 with D = 3, and 10242^2 with
D = 6. Per case and variant: the outputs against ``cpd_estep_plain`` (max
|difference| over max(1, max |plain|), per output), and the device time of
one E-step (both passes) from a CUDA graph of 20 calls replayed between CUDA
events, split by pass from a ``torch.profiler`` trace of one replay.

Prints one JSON line per variant.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

CASES = ((10242, 3), (5000, 3), (10242, 6))
CALLS = 20


def _variant_library(EK, build, spec):
    """A CudaLibrary for a copy of csrc/cpd_estep.cu with the constants of
    ``spec`` replaced."""
    src = build.CSRC_DIR / "cpd_estep.cu"
    text = src.read_text()
    if "=>" in spec:
        for sub in spec.split(" ;; "):
            old, new = sub.split("=>", 1)
            if text.count(old) < 1:
                raise SystemExit(f"no {old!r} in {src}")
            text = text.replace(old, new)
        spec = "sub_" + hashlib.sha256(spec.encode()).hexdigest()[:8]
    for item in spec.split(",") if not spec.startswith("sub_") else ():
        name, value = item.split("=")
        text, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise SystemExit(f"no constant {name} in {src}")
    out_dir = build.BUILD_DIR.parent / "cpd_estep_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = re.sub(r"[^A-Za-z0-9]+", "_", spec)
    path = out_dir / f"cpd_estep_{tag}.cu"
    path.write_text(text)
    lib = build.CudaLibrary("cpd_estep.cu", f"cpd_estep_{tag}", "CPD E-step variant",
                            EK._LIBRARY.functions)
    lib.source = path
    return lib, spec


def _measure(torch, EK, X, TY, s2):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    est = EK.CudaEstep(X, TY.shape[0])
    got = [t.clone() for t in est(TY, s2)]
    want = EK.cpd_estep_plain(X, TY, s2)
    errs = {k: float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            for k, g, w in zip(("Pt1", "P1", "PX", "Np", "L"), got, want)}
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            est(TY, s2)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    by_pass = {"den": [], "row": []}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for tag in by_pass:
                if f"estep_{tag}_kernel" in e.name:
                    by_pass[tag].append(e.time_range.elapsed_us())
    return {"ms": start.elapsed_time(end) / (5 * CALLS),
            **{f"{k}_ms": (sum(v) / len(v) / 1e3 if v else None) for k, v in by_pass.items()},
            "max_err_of_scale": errs}


def main():
    import torch

    if not torch.cuda.is_available():
        print("cpd_estep_variants: needs a CUDA device", file=sys.stderr)
        return 2
    from pyfocusr_tpu_torch.ops import _cuda_build as build
    from pyfocusr_tpu_torch.ops import cpd_estep_kernel as EK

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    g = torch.Generator().manual_seed(0)
    inputs = {}
    for n, d in CASES:
        X = torch.rand(n, d, generator=g).cuda()
        TY = (torch.rand(n, d, generator=g) * 0.9 + 0.05).cuda()
        inputs[f"{n}_d{d}"] = (X, TY, torch.tensor(0.02).cuda())
    real = EK._LIBRARY
    for spec in ["source"] + sys.argv[1:]:
        EK._LIBRARY = real if spec == "source" else _variant_library(EK, build, spec)[0]
        EK.load_library()
        ptxas = [ln.strip() for ln in EK.BUILD_LOG.splitlines() if "registers" in ln]
        res = {name: _measure(torch, EK, *args) for name, args in inputs.items()}
        print(json.dumps({"variant": spec, "nvidia_smi": smi.strip(), "cases": res,
                          "ptxas": ptxas}), flush=True)
    EK._LIBRARY = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
