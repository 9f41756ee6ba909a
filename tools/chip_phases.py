#!/usr/bin/env python3
"""Chosen kernel phases of ``chip_smoke.py`` on one CUDA card, without the
paths around them: a quick check of a kernel after a change.

    python3 tools/chip_phases.py [topk] [estep_wide] [sharded] [--sweep] [--topk-variant SPEC]...

``topk`` runs ``phase_knn_topk`` (the k = 4..128 kernel against
``knn_plain``, bit for bit, and its times), ``estep_wide`` runs
``phase_cpd_estep`` on ``wide_estep_cases`` and ``wide_estep_edge_cases``
(the E-step's D > 16 instance against ``cpd_estep_plain``); both by
default.  ``sharded`` runs ``phase_sharded`` (every ``device_mesh`` path over
``torch.distributed`` against one device: a world of one NCCL rank, gloo
ranks sharing the card, one NCCL rank a card where several are visible),
its lanes held bit for bit where two plain 'kd' pairs agree; it builds
every library first and makes its own refine inputs at 655362 vertices.  ``--sweep`` also times both grids of the top-k kernel (1 and 4
queries a warp; 4 only up to k = 32) and every split of the E-step's other
cloud (both passes alike) at the timed shapes, each as one call from a CUDA
graph of 20 (``chip_smoke.graph_ms``), so the planner's choice can be read
beside the others; the sweep forces a grid by patching the module's
``plan``.  ``--topk-variant SPEC`` times a copy of ``csrc/knn_topk.cu``
edited as ``tools/kernel_variants.py`` describes (``kQueue=0``: every
winner inserted at once, no thread queues), beside the source,
at the timed shapes and k = 4..128 (``VARIANT_KS``), each held bit for bit
to ``knn_plain``.  Prints ``chip_smoke``'s JSON lines, one line
per sweep or variant, and the card's ``nvidia-smi`` line.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


# The k a top-k sweep or variant is timed at: the phase's and one in each
# list width.
VARIANT_KS = (4, 8, 32, 64, 96, 128)


def forced(module, edit):
    """``module.plan`` replaced by the planner's answer edited by ``edit``
    (a function of the plan): how a sweep runs grids the planner would not
    pick.  Use as ``with forced(...):``."""
    import contextlib

    @contextlib.contextmanager
    def patch():
        real = module.plan
        module.plan = lambda *a, **kw: edit(real(*a, **kw))
        try:
            yield
        finally:
            module.plan = real
    return patch()


def sweep_topk(torch, knn_kernel, topk, ref, query):
    out = []
    for nq in (query.shape[0], 2000):
        q = query[:nq].contiguous()
        for k in VARIANT_KS:
            buf = (torch.empty((nq, k), device="cuda"),
                   torch.empty((nq, k), dtype=torch.int32, device="cuda"))
            times = {}
            for qw in (1, 4) if k <= 32 else (1,):
                with forced(topk, lambda p: {**p, "queries_per_warp": qw}):
                    times[f"qw{qw}"] = cs.graph_ms(torch, lambda: topk.knn_topk_cuda(
                        ref, q, k, buf))
            out.append({"nq": nq, "nr": ref.shape[0], "k": k, "ms": times,
                        "planned": topk.plan(nq, k)})
    return out


def topk_variants(torch, knn_kernel, topk, ref, query, specs):
    from kernel_variants import variant_library

    from pyfocusr_tpu_torch.ops import _cuda_build as build

    real = topk._LIBRARY
    out = []
    for spec in ["source"] + specs:
        topk._LIBRARY = real if spec == "source" else variant_library(
            build, real, "knn_topk.cu", "top-k variant", spec)
        topk.load_library()
        cases = {}
        for nq in (query.shape[0], 2000):
            q = query[:nq].contiguous()
            for k in VARIANT_KS:
                buf = (torch.empty((nq, k), device="cuda"),
                       torch.empty((nq, k), dtype=torch.int32, device="cuda"))
                run = lambda: topk.knn_topk_cuda(ref, q, k, buf)
                kd, ki = run()
                pd, pi = knn_kernel.knn_plain(ref, q, k)
                cases[f"{nq}_k{k}"] = {"ms": cs.graph_ms(torch, run),
                                       "bit_equal": bool(torch.equal(kd, pd)
                                                         and torch.equal(ki, pi))}
        out.append({"variant": spec, "cases": cases,
                    "ptxas": [ln.strip() for ln in topk.BUILD_LOG.splitlines()
                              if "registers" in ln]})
    topk._LIBRARY = real
    return out


def sweep_estep(torch, EK):
    out = []
    for name, X, TY, s2 in cs.wide_estep_cases(torch):
        s2 = torch.tensor(s2, dtype=torch.float32, device="cuda")
        times = {}
        for splits in (1, 2, 4, 8):
            split = lambda p: {name: {**p[name], "splits": splits} for name in p}
            with forced(EK, split):
                est = EK.CudaEstep(X, TY.shape[0])
            times[splits] = cs.graph_ms(torch, lambda: est(TY, s2))
        out.append({"case": name, "ms_by_split": times,
                    "planned": EK.plan(X.shape[0], TY.shape[0], X.shape[1])})
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_phases: needs a CUDA device", file=sys.stderr)
        return 2
    import pyfocusr_tpu_torch as tp
    from pyfocusr_tpu_torch.ops import cpd as cpd_ops
    from pyfocusr_tpu_torch.ops import cpd_estep_kernel as EK
    from pyfocusr_tpu_torch.ops import knn_kernel, knn_topk_kernel

    argv = sys.argv[1:]
    specs = [argv[i + 1] for i, a in enumerate(argv) if a == "--topk-variant"]
    args = [a for i, a in enumerate(argv)
            if not a.startswith("--") and (i == 0 or argv[i - 1] != "--topk-variant")]
    phases = args or ["topk", "estep_wide"]
    smi = cs.nvidia_smi_line()
    for mod in (knn_kernel, knn_topk_kernel, EK):
        mod.load_library()
        cs.emit({"phase": "build", "library": mod.__name__, "nvcc_seconds": mod.BUILD_SECONDS,
                 "ptxas": [ln.strip() for ln in mod.BUILD_LOG.splitlines()
                           if "registers" in ln or "spill" in ln]})
    if "topk" in phases:
        ref = torch.tensor(cs.synthetic_bone(tp, 2).points, device="cuda")
        query = torch.tensor(cs.synthetic_bone(tp, 1).points, device="cuda")
        cs.phase_knn_topk(torch, knn_kernel, knn_topk_kernel, ref.cpu().numpy(),
                          query.cpu().numpy())
        if "--sweep" in sys.argv:
            cs.emit({"phase": "topk_grid_sweep",
                     "cases": sweep_topk(torch, knn_kernel, knn_topk_kernel, ref, query)})
        if specs:
            for line in topk_variants(torch, knn_kernel, knn_topk_kernel, ref, query, specs):
                cs.emit({"phase": "topk_variant", **line})
    if "estep_wide" in phases:
        cs.phase_cpd_estep(torch, EK, cpd_ops, cs.wide_estep_cases(torch),
                           phase="cpd_estep_wide_vs_plain",
                           edges=cs.wide_estep_edge_cases(torch),
                           first_ms=cs.FIRST_WIDE_ESTEP_KERNEL_MS)
        if "--sweep" in sys.argv:
            cs.emit({"phase": "estep_split_sweep", "cases": sweep_estep(torch, EK)})
    if "sharded" in phases:
        from pyfocusr_tpu_torch.utils import aot

        aot.build_libraries("cuda")
        cfg = tp.PipelineConfig(**cs.BENCH_CFG)
        tg = tp.mesh_to_graph_arrays(cs.synthetic_bone(tp, 2))
        sg = tp.mesh_to_graph_arrays(cs.synthetic_bone(tp, 1))
        draws = tp.make_draws(0, cfg, tg.n_points, sg.n_points)
        a, b = (tp.register_pair(tg, sg, cfg, draws=draws) for _ in range(2))
        deterministic = not cs.outputs_differ(torch, a, b)
        cs.emit({"phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
                 "device_count": torch.cuda.device_count(), "deterministic": deterministic})
        cs.phase_sharded(torch, tp, cs.kernel_modules(), smi, deterministic)
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"chip_phases: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
