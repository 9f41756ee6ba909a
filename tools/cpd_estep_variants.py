#!/usr/bin/env python3
"""Device time of the streamed CPD E-step kernel (``csrc/cpd_estep.cu``) and
of variants of it with constants edited, in one run on one CUDA card.

    python3 tools/cpd_estep_variants.py [kTile=256] [kRows=8,kWarps=8] ...

Each argument is one variant, a copy of the source edited as
``tools/kernel_variants.py`` describes (``NAME=VALUE`` constants or
``OLD=>NEW`` text) and built under ``build/cpd_estep_variants/``; the source
as it stands is measured first.
Inputs are uniform random clouds from a torch seed (the kernel's time does
not depend on the values) at 10242^2 and 5000^2 with D = 3, and 10242^2 with
D = 6. Per case and variant: the outputs against ``cpd_estep_plain`` (max
|difference| over max(1, max |plain|), per output), and the device time of
one E-step (both passes) from a CUDA graph of 20 calls replayed between CUDA
events (``chip_smoke.graph_ms``), split by pass from a ``torch.profiler``
trace of one call.

Prints one JSON line per variant.
"""

from __future__ import annotations

import json
import os
import sys

from kernel_variants import variant_library

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

CASES = ((10242, 3), (5000, 3), (10242, 6))


def _measure(torch, cs, EK, X, TY, s2):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    est = EK.CudaEstep(X, TY.shape[0])
    got = [t.clone() for t in est(TY, s2)]
    want = EK.cpd_estep_plain(X, TY, s2)
    errs = {k: float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            for k, g, w in zip(("Pt1", "P1", "PX", "Np", "L"), got, want)}
    torch.cuda.synchronize()
    ms = cs.graph_ms(torch, lambda: est(TY, s2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        est(TY, s2)
        torch.cuda.synchronize()
    by_pass = {"den": [], "row": []}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for tag in by_pass:
                if f"estep_{tag}_kernel" in e.name:
                    by_pass[tag].append(e.time_range.elapsed_us())
    return {"ms": ms,
            **{f"{k}_ms": (sum(v) / len(v) / 1e3 if v else None) for k, v in by_pass.items()},
            "max_err_of_scale": errs}


def main():
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("cpd_estep_variants: needs a CUDA device", file=sys.stderr)
        return 2
    from pyfocusr_tpu_torch.ops import _cuda_build as build
    from pyfocusr_tpu_torch.ops import cpd_estep_kernel as EK

    smi = cs.nvidia_smi_line()
    g = torch.Generator().manual_seed(0)
    inputs = {}
    for n, d in CASES:
        X = torch.rand(n, d, generator=g).cuda()
        TY = (torch.rand(n, d, generator=g) * 0.9 + 0.05).cuda()
        inputs[f"{n}_d{d}"] = (X, TY, torch.tensor(0.02).cuda())
    real = EK._LIBRARY
    for spec in ["source"] + sys.argv[1:]:
        EK._LIBRARY = real if spec == "source" else variant_library(
            build, real, "cpd_estep.cu", "CPD E-step variant", spec)
        EK.load_library()
        ptxas = [ln.strip() for ln in EK.BUILD_LOG.splitlines() if "registers" in ln]
        res = {name: _measure(torch, cs, EK, *args) for name, args in inputs.items()}
        print(json.dumps({"variant": spec, "nvidia_smi": smi, "cases": res,
                          "ptxas": ptxas}), flush=True)
    EK._LIBRARY = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
