#!/usr/bin/env python3
"""The JAX package's multi-resolution quality on the synthetic pair, as the
reference for the PyTorch port's card runs (the card has no JAX).

    JAX_PLATFORMS=cpu python3 tools/multires_jax_quality.py [--levels 7]
                                                         [--coarse-n 12000]

Builds ``chip_smoke.synthetic_bone`` seeds 2 (target) and 1 (source) with
the JAX package's ``TriMesh`` and ``subdivide`` (163842 vertices at 7),
runs ``pyfocusr_tpu.multires.register_pair_multires`` under the 'kd'
configuration of ``chip_smoke.py`` (``bench.py:122-134``) with
``PRNGKey(0)``, and prints one JSON line: the level sizes (a ``decimate``
spy), ``pyfocusr_tpu.metrics.registration_quality`` of the fine result
(unique fraction, symmetric surface distance) and the wall seconds, beside
the JAX backend it ran on.  Quality, not speed, is what the line is for.

``--coarse-only`` stops at the coarsest level: the meshes are decimated
through the same levels (and intermediate levels) as the full run, the
coarsest pair is registered by ``pipeline.register_pair``, and the line
gives that registration's quality on the coarse meshes (a cheap check of
the coarse solve at sizes whose full run is for the card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, default=7)
    ap.add_argument("--coarse-n", type=int, default=12000)
    ap.add_argument("--level-ratio", type=float, default=100.0)
    ap.add_argument("--coarse-only", action="store_true")
    args = ap.parse_args()

    import jax

    from pyfocusr_tpu import metrics, multires
    from pyfocusr_tpu.mesh import TriMesh
    from pyfocusr_tpu.pipeline import PipelineConfig

    jp = types.SimpleNamespace(TriMesh=TriMesh, subdivide=multires.subdivide)
    target = chip_smoke.synthetic_bone(jp, 2, args.levels)
    source = chip_smoke.synthetic_bone(jp, 1, args.levels)
    levels = []
    real = multires.decimate

    def spy(mesh, n, seed=0, edges=None):
        out = real(mesh, n, seed, edges=edges)
        levels.append((mesh.n_points, n, out[0].n_points))
        return out

    class Coarse(Exception):
        pass

    real_register = multires.register_pair
    coarse = {}

    def register_coarse(tg, sg, cfg, key, **kw):
        coarse["result"] = jax.block_until_ready(real_register(tg, sg, cfg, key, **kw))
        coarse["graphs"] = (tg, sg)
        raise Coarse

    multires.decimate = spy
    if args.coarse_only:
        multires.register_pair = register_coarse
    t0 = time.perf_counter()
    try:
        fine, _ = multires.register_pair_multires(
            target, source, PipelineConfig(**chip_smoke.BENCH_CFG), jax.random.PRNGKey(0),
            coarse_n=args.coarse_n, level_ratio=args.level_ratio)
        fine = jax.block_until_ready(fine)
    except Coarse:
        pass
    seconds = time.perf_counter() - t0
    multires.decimate, multires.register_pair = real, real_register
    if args.coarse_only:
        tg, sg = coarse["graphs"]
        quality = metrics.registration_quality(tg.points, sg.points, coarse["result"])
    else:
        quality = metrics.registration_quality(target, source, fine)
    print(json.dumps({
        "tool": "multires_jax_quality", "jax_backend": jax.default_backend(),
        "n_target": target.n_points, "n_source": source.n_points,
        "coarse_n": args.coarse_n, "level_ratio": args.level_ratio,
        "coarse_only": args.coarse_only, "config": "bench.py:122-134", "decimations": levels,
        "quality": {k: float(v) for k, v in quality.items()}, "seconds": seconds,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
