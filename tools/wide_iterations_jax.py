#!/usr/bin/env python3
"""EM iterations of both CPD runs of the wide-coordinates ``Focusr`` in the
JAX package and in the PyTorch port, on the CPU, from the same draws.

    JAX_PLATFORMS=cpu python3 tools/wide_iterations_jax.py [--levels 4]
                                                        [--torch-threads 4]

Runs ``Focusr(target, source, n_spectral_features=16,
include_points_as_features=True).align_maps()`` (the class defaults
otherwise: 1000 deformable and 100 affine iterations at most, tolerance
1e-8, D = 19 coordinates) on ``chip_smoke.synthetic_bone`` seeds 2
(target) and 1 (source), 2562 vertices at ``--levels 4``, three times:

* ``jax``: the JAX package;
* ``port_jax_draws``: the port on the CPU with JAX's random draws (the
  eigensolvers' start blocks and the Gram's start, as
  ``tests/test_torch_focusr.py::jax_draws_in_port`` swaps them in; the
  subsamples come from the same numpy seeds in both packages);
* ``port_jax_spectra``: the same, with each port ``Graph`` given the
  eigenpairs the JAX ``Graph`` of the same seed solved, so that no
  eigenvector sign separates the packages' coordinates.

Prints one JSON line per run: the affine and deformable runs' EM
iterations, final sigma2, the unique fraction of the correspondences and
the wall seconds; then one line with the deformable counts side by side.
At ``--levels 4`` the three runs take about 35 s on a CPU; at 5 (10242
vertices, 5000-point CPD on the port's streamed plain E-step) up to 45 min
when the port's run takes the 1000-iteration cap.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

WIDE_CFG = chip_smoke.WIDE_CFG


def _recording(module, runs, kind):
    """Wraps ``module.<kind>_registration.register`` to append each run's
    iterations and sigma2 to ``runs``; returns the restore function."""
    cls = getattr(module, f"{kind}_registration")
    real = cls.register

    def register(self, *a, **kw):
        out = real(self, *a, **kw)
        runs.append({"kind": kind, "iterations": int(self.iterations_run),
                     "sigma2": float(self.sigma2)})
        return out

    cls.register = register
    return lambda: setattr(cls, "register", real)


def _run(label, make, cpd_module):
    runs = []
    restore = [_recording(cpd_module, runs, kind) for kind in ("affine", "deformable")]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            reg = make()
            reg.align_maps()
    finally:
        for undo in restore:
            undo()
    import numpy as np

    corr = np.asarray(reg.corresponding_target_idx_for_each_source_pt)
    line = {"run": label, "cpd": runs, "unique_fraction": len(np.unique(corr)) / len(corr),
            "seconds": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    return line


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--torch-threads", type=int, default=4)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import pyfocusr_tpu_torch as tp
    from pyfocusr_tpu.focusr import Focusr as JFocusr
    from pyfocusr_tpu.mesh import TriMesh as JTriMesh
    from pyfocusr_tpu.ops import cpd as JC
    from pyfocusr_tpu.spectral.graph import Graph as JGraph
    from pyfocusr_tpu_torch.ops import cpd as TC
    from pyfocusr_tpu_torch.spectral import graph as TG

    torch.set_num_threads(args.torch_threads)
    target = chip_smoke.synthetic_bone(tp, 2, args.levels)
    source = chip_smoke.synthetic_bone(tp, 1, args.levels)
    jt, js = (JTriMesh(m.points, m.triangles, dict(m.point_data)) for m in (target, source))

    # JAX's draws, as tests/test_torch_focusr.py makes them.
    def jax_graph_start(seed, n, method, k):
        key = jax.random.PRNGKey(seed)
        if method == "chebyshev":
            return np.asarray(jax.random.normal(key, (n, k + 8), jnp.float32))
        return np.stack([np.asarray(jax.random.normal(kk, (n,), jnp.float32))
                         for kk in (key, jax.random.fold_in(key, 1))], axis=1)

    def jax_omega(seed, M, p):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (M, p), jnp.float32))

    solved = {}
    jax_solve = JGraph.get_graph_spectrum

    def record(self):
        out = jax_solve(self)
        solved[self.seed] = (np.asarray(self.eig_vals), np.asarray(self.eig_vecs))
        return out

    JGraph.get_graph_spectrum = record
    try:
        jax_line = _run("jax", lambda: JFocusr(jt, js, **WIDE_CFG), JC)
    finally:
        JGraph.get_graph_spectrum = jax_solve

    real_start, real_omega = TG.eig_start_draws, TC.omega_draw
    TG.eig_start_draws, TC.omega_draw = jax_graph_start, jax_omega
    port_solve = TG.Graph.get_graph_spectrum

    def inject(self):
        self.get_weighted_adjacency_matrix()
        self.get_degree_matrix()
        self.get_G_matrix(p_function=self.G_matrix_p_function)
        vals, vecs = solved[self.seed]
        self.eig_vals = torch.tensor(vals, device=self.device)
        self.eig_vecs = torch.tensor(vecs, device=self.device)
        return self.eig_vals, self.eig_vecs

    make_port = lambda: tp.Focusr(target, source, device="cpu", **WIDE_CFG)
    try:
        port_line = _run("port_jax_draws", make_port, TC)
        TG.Graph.get_graph_spectrum = inject
        spectra_line = _run("port_jax_spectra", make_port, TC)
    finally:
        TG.eig_start_draws, TC.omega_draw = real_start, real_omega
        TG.Graph.get_graph_spectrum = port_solve

    def deformable(line):
        return [r["iterations"] for r in line["cpd"] if r["kind"] == "deformable"]

    print(json.dumps({
        "tool": "wide_iterations_jax", "jax_backend": jax.default_backend(),
        "n_target": target.n_points, "n_source": source.n_points, "config": WIDE_CFG,
        "cap": 1000, "deformable_iterations": {
            line["run"]: deformable(line) for line in (jax_line, port_line, spectra_line)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
