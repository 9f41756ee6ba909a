"""``BENCHMARK.json`` and the files the harness finds by name in it."""

from __future__ import annotations

import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def check_names(bench: dict) -> list:
    """Every name and unit of ``bench`` outside the allowed characters, as
    messages (empty when all are allowed)."""
    bad = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench.get(section, []):
            names = [entry.get("name")]
            if section == "workloads":
                names += [entry.get("config"), entry.get("traffic")]
            if section == "configs":
                names += list(entry.get("reduced", []))
            for n in names:
                if not isinstance(n, str) or not NAME_RE.match(n):
                    bad.append(f"{section}: name {n!r}")
            if "unit" in entry and not (isinstance(entry["unit"], str)
                                        and UNIT_RE.match(entry["unit"])):
                bad.append(f"{section}: unit {entry['unit']!r}")
    return bad


class Cell:
    """One workload of ``BENCHMARK.json`` with what it names: its
    configuration, traffic mix and limits, and its metrics."""

    def __init__(self, bench: dict, workload: str, bench_dir: str = BENCH_DIR):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        cfgs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = cfgs[self.workload["config"]]
        self.config = load_json(os.path.join(ROOT, self.config_entry["file"]))
        self.traffic = load_json(os.path.join(bench_dir, "traffic",
                                              f"{self.workload['traffic']}.json"))
        self.limits = load_json(os.path.join(bench_dir, "limits",
                                             f"{workload}.json"))["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]
