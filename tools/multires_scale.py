#!/usr/bin/env python3
"""The PyTorch port's multi-resolution registration at scale, split by
stage, with both routes of its refine's k=3 query.

    python3 tools/multires_scale.py [--levels 9] [--coarse-n 12000]
                                    [--level-ratio 100] [--device cuda]
                                    [--reps 3] [--out FILE]

For each ``--levels`` L it builds the synthetic pair of ``chip_smoke.py``
(``synthetic_bone(tp, 2 | 1, L)``: 2621442 vertices at 9) and runs
``register_pair_multires`` under the 'kd' configuration (``bench.py:
122-134``) with a fresh k-NN routing record: a first call (where the
refine's query falls in the race band it races there), then a second
split by stage (``chip_smoke.MultiresSplit``: topology, decimation, the
coarse ``register_pair``, graph builds, each smoothing, the k=3 query and
its route, host and wall seconds fenced by ``torch.cuda.synchronize``).
Then both routes of the k=3 query on the refine's own inputs
(``chip_smoke.knn3_routes``: a warm-up and ``--reps`` fenced calls each,
bit-equal), and the registration's quality.

``--device cpu`` runs the same on the CPU with the plain k-NN (the CPU scale
of the route bounds in ``ops/knn.py`` comes from such a run).  Prints the
card's ``nvidia-smi`` name and power limit and one JSON line per size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, nargs="+", default=[9])
    ap.add_argument("--coarse-n", type=int, default=12000)
    ap.add_argument("--level-ratio", type=float, default=100.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    import pyfocusr_tpu_torch as tp

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("multires_scale: no CUDA device", file=sys.stderr)
            return 2
        print(chip_smoke.nvidia_smi_line(), flush=True)
    cfg = tp.PipelineConfig(**chip_smoke.BENCH_CFG)
    lines = []
    for levels in args.levels:
        target = chip_smoke.synthetic_bone(tp, 2, levels)
        source = chip_smoke.synthetic_bone(tp, 1, levels)
        with tempfile.TemporaryDirectory() as cal:
            os.environ["PYFOCUSR_TPU_CAL_DIR"] = cal

            def run():
                return tp.register_pair_multires(
                    target, source, cfg, torch.Generator(device=device).manual_seed(0),
                    coarse_n=args.coarse_n, level_ratio=args.level_ratio,
                    device=device)

            calls = {}
            for name in ("first_call", "second_call"):
                t0 = time.perf_counter()
                with chip_smoke.MultiresSplit(torch, tp, device) as split:
                    fine, _ = run()
                chip_smoke.sync(torch, device)
                calls[name] = split.summary(time.perf_counter() - t0)
                calls[name]["knn3_route"] = split.knn3["route"]
                calls[name]["decimations"] = split.decimations
            coarse_quality = split.coarse_quality()
            routes = chip_smoke.knn3_routes(torch, *split.knn3["inputs"], reps=args.reps)
            quality = tp.registration_quality(target, source, fine)
        line = {"tool": "multires_scale", "device": str(device),
                "device_name": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu"),
                "n_target": target.n_points, "n_source": source.n_points,
                "coarse_n": args.coarse_n, "level_ratio": args.level_ratio,
                **calls, "knn3_routes_refine_inputs": routes, "quality": quality,
                "coarse_quality": coarse_quality}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del fine, split
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0 if all(line["knn3_routes_refine_inputs"]["bit_equal"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
