"""The entry ``pyfocusr_tpu_torch.pipeline.register_pair``: a template bone
registered onto a pool of source bones, judged stage by stage.

Set-up builds the template and the pool on the host (``harness/bones.py``)
and their ``GraphArrays`` on the device through the program's
``mesh_to_graph_arrays`` (topology, patch plan).  The deck is every pool
source with each of the traffic mix's ``draws_per_source`` draw streams.
A call draws the item's random inputs with the program's own
``pipeline.make_draws`` (numpy on the host, seeded by the item alone, so
every ``--seed`` calls the same work) and registers the pair, ended by
``torch.cuda.synchronize()``; the call's seconds cover both, as a script
that lets ``register_pair`` draw pays for both.

The judgement (``harness/judge.py``) covers the settings of
``judge.COVERED``; a configuration outside them is refused at set-up.
"""

from __future__ import annotations

import time

import torch

from harness import bones, drive, judge

# The draws of deck item (source seed s, stream d) come from seed
# DRAW_SEED_BASE + 1000 s + d.
DRAW_SEED_BASE = 19_000_000
NUMBERS = judge.NUMBERS


def item_seed(pool_seed: int, stream: int) -> int:
    return DRAW_SEED_BASE + 1000 * pool_seed + stream


class Entry:
    def __init__(self, tp, cfg: dict, traffic: dict, device):
        judge.check_covered(cfg)
        self.tp, self.cfg, self.device = tp, cfg, device
        self.cfg_obj = tp.pipeline.config_from_dict(cfg)
        levels = traffic["subdivision_levels"]
        base = bones.sphere(levels)
        self.target = bones.bone(traffic["template_seed"], levels, base)
        self.pool_seeds = list(traffic["pool_seeds"])
        self.pool = [bones.bone(s, levels, base) for s in self.pool_seeds]
        self.target_ga = tp.mesh_to_graph_arrays(tp.TriMesh(*self.target), device=device)
        self.pool_ga = [tp.mesh_to_graph_arrays(tp.TriMesh(*m), device=device)
                        for m in self.pool]
        self.n = self.target[0].shape[0]
        self.deck = [(src, d) for src in range(len(self.pool))
                     for d in range(traffic["draws_per_source"])]
        self.gen = None
        self.k = cfg["n_spectral_features"] + cfg["n_extra_spectral"]
        self.meshes = {}

    def seed(self, seed: int):
        """The program's generator (the eigensolver's SVQB refill) from the
        run's seed."""
        self.gen = torch.Generator(device=self.device).manual_seed(drive.seed_ints(seed)[0])

    def draws(self, item):
        src, d = item
        return self.tp.pipeline.make_draws(item_seed(self.pool_seeds[src], d), self.cfg_obj,
                                           self.target_ga.n_points, self.pool_ga[src].n_points)

    def call(self, item):
        """One timed registration: ((result, draws), seconds)."""
        t0 = time.perf_counter()
        draws = self.draws(item)
        res = self.tp.register_pair(self.target_ga, self.pool_ga[item[0]], self.cfg_obj,
                                    generator=self.gen, draws=draws)
        drive.sync(self.device)
        return (res, draws), time.perf_counter() - t0

    def counters(self) -> dict:
        """The program's counters after a traced call, and the call's shapes
        (read by ``metrics/knn_roofline.py``)."""
        from pyfocusr_tpu_torch.ops import icp as icp_ops

        return {"icp_iterations": int(icp_ops.ICP_STATS.get("iterations", 0)),
                "n_target": self.n, "n_source": self.n,
                "icp_rows": min(self.cfg["icp_n_landmarks"], self.n),
                "eigsort_rows": min(self.cfg["n_coords_spectral_ordering"], self.n),
                "initial": self.cfg["initial_correspondence_type"]}

    def _mesh(self, key, mesh):
        if key not in self.meshes:
            self.meshes[key] = judge.Mesh(*mesh, self.k)
        return self.meshes[key]

    def judge_pair(self, item, kept, control: bool = False) -> dict:
        """{"program": numbers, "info": ...} of a kept call, and with
        ``control`` the control's numbers from the same inputs."""
        src, _ = item
        res, draws = kept
        pair = judge.Pair(self._mesh("target", self.target), self._mesh(src, self.pool[src]),
                          draws, self.cfg, self.device)
        prog = judge.program_view(res)
        out = {"program": pair.numbers(prog), "info": dict(pair.info)}
        if control:
            ctl = judge.control_outputs(pair, prog, self.device)
            out["control"] = pair.numbers(ctl, inputs_from=prog)
        return out
