#!/usr/bin/env python3
"""How ``synchronize_spectral`` flags the maps of a four-subject cohort.

Registers every ordered pair of four subjects with the port on the CPU
(``parallel/groupwise.register_all_pairs``, the bench configuration with
the spectral-ordering subsample cut to the mesh), then runs
``synchronize_spectral`` (20 modes) on the clean maps and with one map's
rows half permuted (``chip_smoke.scrambled_map``), and prints the
residuals, their largest over their median, and which maps JAX's default
outlier factor 1.3 and ``chip_smoke.GROUPWISE_OUTLIER_FACTOR`` flag.

    python3 tools/groupwise_flagging.py [--levels 4] [--subjects warp|jitter|seeds]

``warp``: ``chip_smoke.warped_bone`` at ``GROUPWISE_WARPS`` (the chip
phase's cohort); ``jitter``: four copies of the seed-1 bone jittered by
0.3 mm (``chip_smoke.jittered_cohort``, the cohort phase's subjects);
``seeds``: the synthetic bones of seeds 2, 1, 3 and 4.  Levels 4 (2562
vertices) take ~15 s a cohort, level 5 (10242) ~3 min.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import pyfocusr_tpu_torch as tp  # noqa: E402
from pyfocusr_tpu_torch.parallel import groupwise as G  # noqa: E402


def subjects(kind: str, levels: int):
    if kind == "warp":
        return [chip_smoke.warped_bone(tp, levels, a, ph) for a, ph in chip_smoke.GROUPWISE_WARPS]
    if kind == "jitter":
        return chip_smoke.jittered_cohort(tp, chip_smoke.synthetic_bone(tp, 1, levels), 4, 0.3)
    return [chip_smoke.synthetic_bone(tp, seed, levels) for seed in (2, 1, 3, 4)]


def flags(residuals, factor):
    off = ~np.eye(residuals.shape[0], dtype=bool)
    return np.argwhere(off & (residuals > factor * np.median(residuals[off]))).tolist()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--subjects", choices=("warp", "jitter", "seeds"), default="warp")
    args = ap.parse_args()
    meshes = subjects(args.subjects, args.levels)
    n = meshes[0].n_points
    cfg = tp.PipelineConfig(**dict(chip_smoke.BENCH_CFG, n_coords_spectral_ordering=min(
        chip_smoke.BENCH_CFG["n_coords_spectral_ordering"], n)))
    graphs = tp.pad_cohort(meshes, device="cpu")
    corr, _, _ = G.register_all_pairs(graphs, cfg, draws=G.make_all_pairs_draws(1, cfg, graphs))
    blocks = G.make_basis_blocks(2, cfg, graphs, chip_smoke.GROUPWISE_N_BASIS)
    n_real = [m.n_points for m in meshes]
    out = {"subjects": args.subjects, "n": n}
    for case, maps in (("clean", corr),
                       ("scrambled", chip_smoke.scrambled_map(
                           corr, 0, 1, n_real[0], chip_smoke.GROUPWISE_SCRAMBLED_SHARE))):
        _, info = G.synchronize_spectral(maps, graphs, cfg, n_basis=chip_smoke.GROUPWISE_N_BASIS,
                                         blocks=blocks)
        r = info["residuals"]
        off = r[~np.eye(len(meshes), dtype=bool)]
        out[case] = {"residuals": np.round(r, 4).tolist(),
                     "max_over_median": float(off.max() / np.median(off)),
                     "flagged_at_1.3": flags(r, 1.3),
                     "flagged_at_phase_factor": flags(r, chip_smoke.GROUPWISE_OUTLIER_FACTOR)}
    print(json.dumps(out))


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
