#!/usr/bin/env python3
"""How far the last bits of ICP's Umeyama close carry through
``register_pair``, over several mesh pairs.

Each pair is ``chip_smoke.py``'s synthetic bone pair made from other seeds
(seed 0 is the pair ``chip_smoke.py`` runs).  Each is registered on CPU
tensors twice in each configuration, once with the plain close as it is
(``torch.linalg.svd`` in float64, rounded once to float32, as the card's
kernel rounds) and once with the same close computed in float32.  The two
runs are compared as ``chip_smoke.py`` compares a CUDA run with a CPU run,
and stage by stage along the path the bits take:

* ICP: the largest difference of the moved source points (mm);
* the spectral warm start: the share of source vertices whose nearest
  target vertex, the row of the target's eigensolver block they start from
  (``pipeline._warm_x0``), differs;
* the spectra (each mode's |cos| apart, and as ``chip_smoke.py`` groups
  them), the initial and the final correspondences.

Configurations: the full-resolution one (``FULLRES_CFG``) and 'kd'
(``BENCH_CFG``), CPD capped at ``FULLRES_CPU_EM_CAP`` iterations, as the
CUDA-vs-CPU phase of ``chip_smoke.py`` caps the full-resolution run.

    python3 tools/icp_close_bits.py [--seeds 3]

Runs on the CPU (about a minute a registration); prints one JSON line a
pair and configuration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def _cos_per_mode(a, b):
    """|cos| of each column of two eigenvector blocks, centred: 1 where a
    mode is unchanged, below 1 where it turned (also inside a group of
    near-equal eigenvalues, which ``chip_smoke.compare_runs`` compares as a
    subspace)."""
    a = a.double() - a.double().mean(0)
    b = b.double() - b.double().mean(0)
    return [float(v) for v in ((a * b).sum(0).abs() / (a.norm(dim=0) * b.norm(dim=0)))]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    import pyfocusr_tpu_torch as tp
    from pyfocusr_tpu_torch import pipeline
    from pyfocusr_tpu_torch.ops import umeyama_kernel as UK
    from pyfocusr_tpu_torch.ops.knn import nn_query

    def close_f32(cov, var_s, mu_s, mu_d, with_scale, out=None):
        """The plain close's code without its float64 round trip."""
        U, S, Vt = torch.linalg.svd(cov)
        d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
        diag = torch.ones(3, dtype=cov.dtype)
        diag[2] = d
        R = U @ torch.diag(diag) @ Vt
        s = (S * diag).sum() / torch.clamp(var_s, min=1e-30) if with_scale \
            else torch.ones((), dtype=cov.dtype)
        return s, R, mu_d - s * (R @ mu_s)

    warm_calls = []
    real_warm = pipeline._warm_x0

    def recorded_warm(block, from_points, from_mask, to_points):
        ref = torch.where(from_mask[:, None] > 0, from_points,
                          torch.full_like(from_points, pipeline.SENTINEL))
        warm_calls.append((to_points.clone(), nn_query(ref, to_points)[1]))
        return real_warm(block, from_points, from_mask, to_points)

    def run(tg, sg, cfg, draws, close):
        real_close = UK.umeyama_close
        UK.umeyama_close, pipeline._warm_x0 = close, recorded_warm
        warm_calls.clear()
        try:
            res = tp.register_pair(tg, sg, cfg, draws=draws)
        finally:
            UK.umeyama_close, pipeline._warm_x0 = real_close, real_warm
        return res, warm_calls[-1] if warm_calls else None

    configs = {"full_resolution": cs.FULLRES_CFG, "kd": cs.BENCH_CFG}
    for seed in range(args.seeds):
        tg = tp.mesh_to_graph_arrays(cs.synthetic_bone(tp, 2 + 2 * seed), device="cpu")
        sg = tp.mesh_to_graph_arrays(cs.synthetic_bone(tp, 1 + 2 * seed), device="cpu")
        for name, base in configs.items():
            cfg = tp.PipelineConfig(**dict(base,
                                           non_rigid_max_iterations=cs.FULLRES_CPU_EM_CAP))
            draws = tp.make_draws(seed, cfg, tg.n_points, sg.n_points)
            f64, warm64 = run(tg, sg, cfg, draws, UK.umeyama_close)
            f32, warm32 = run(tg, sg, cfg, draws, close_f32)
            stages = {}
            if warm64 is not None:
                stages = {
                    "moved_source_max_diff_mm": float(
                        (warm64[0] - warm32[0]).abs().max()),
                    "warm_start_rows_differing": float(
                        (warm64[1] != warm32[1]).double().mean()),
                }
            for side, key in (("target", "eig_vecs_target"),
                              ("source", "eig_vecs_source_sorted")):
                stages[f"{side}_eigvec_abs_cos_per_mode"] = _cos_per_mode(f64[key], f32[key])
            agree = {k: v for k, v in cs.compare_runs(f64, f32).items()
                     if not k.startswith("groups")}
            print(json.dumps({
                "seed": seed, "config": name,
                "target_seed": 2 + 2 * seed, "source_seed": 1 + 2 * seed,
                "cpd_iterations_cap": cs.FULLRES_CPU_EM_CAP,
                **stages, "f64_close_vs_f32_close": agree,
                "correspondence_agreement_below_gate": bool(
                    agree["correspondence_agreement"] < cs.CORR_AGREE_MIN),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
