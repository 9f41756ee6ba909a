#!/usr/bin/env python3
"""Readings of a cell's compared numbers, for setting its limits.

    python3 benchmark/calibrate.py --workload <name> --seeds 1-12 [--control 1-3] [--all 13]
                                   [--out FILE]

In one process (set-up once: the cell's inputs do not depend on the seed),
for each seed it runs the seed's first cycle of the deck (as a run's window
does, with the same entry) and reads every number of the calls a run
would judge (the entry's ``judge_pair``), or of every call for an ``--all`` seed;
for each ``--control`` seed it also reads the
control: each stage recomputed from the same inputs in the reference's
lower-precision arithmetic (float32 with TF32 products), judged by the same
numbers.  One JSON line a seed on standard output (and appended to
``--out``).  On the card by default; ``--device cpu`` for a rehearsal.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import run  # noqa: E402
from harness import spec  # noqa: E402


def seed_list(text: str):
    """'1-12' or '3,5,9' -> integers."""
    out = []
    for part in text.split(","):
        if "-" in part[1:]:
            a, b = part.split("-", 1)
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def readings(cell, seeds, control_seeds, device, emit, all_seeds=()):
    """Run the seeds (see the module docstring); ``emit(dict)`` each line."""
    import pyfocusr_tpu_torch as tp
    from harness import drive

    entry = drive.load_entry(cell.traffic["entry"]).Entry(
        tp, cell.config["pipeline_config"], cell.traffic, device)
    entry.seed(0)
    entry.call(entry.deck[0])
    deck = len(entry.deck)
    for seed in seeds:
        entry.seed(seed)
        sample = (range(deck) if seed in all_seeds else
                  drive.sample_calls(drive.sample_rng(seed), deck, cell.traffic["judge_pairs"]))
        record = drive.Record(sample)
        drive.window(entry, drive.Order(deck, seed), record, float("inf"), max_calls=deck)
        t0 = time.perf_counter()
        for i, (item, kept) in sorted(record.judged().items()):
            line = {"seed": seed, "call": i, "item": list(item), "seconds": record.seconds[i],
                    **entry.judge_pair(item, kept, control=seed in control_seeds)}
            line["judge_s"] = time.perf_counter() - t0
            emit(line)
            t0 = time.perf_counter()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--all", default="", help="seeds whose every deck item is judged")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.prepare_environment()
    cell = spec.Cell(spec.load_json(os.path.join(run.ROOT, "BENCHMARK.json")), args.workload)

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    readings(cell, seed_list(args.seeds), set(seed_list(args.control)), args.device, emit,
             set(seed_list(args.all)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
