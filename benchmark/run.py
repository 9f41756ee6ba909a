#!/usr/bin/env python3
"""The benchmark of ``pyfocusr_tpu_torch``: one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for.  The cell's traffic mix names its entry (``entries/<entry>.py``),
which builds the inputs in set-up; one warm call follows.  Then the entry
is called back to back for ``--seconds`` (``--trace 0``: the end-to-end
metrics), or for the traffic mix's ``trace_pairs`` calls under
``torch.profiler`` (``--trace 1``: the per-layer metrics).  Once the
window has closed the entry judges a sample of the calls against the plain
reference and the run prints one JSON line as the last line of its
standard output; each compared number and its limit are the last lines of
its standard error.  Without a card it fails and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
PACKAGE = "pyfocusr_tpu_torch"
sys.path[:0] = [BENCH_DIR, ROOT]

from harness import spec  # noqa: E402
from harness.imports import forbidden_loaded  # noqa: E402


class RunFailure(RuntimeError):
    pass


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def prepare_environment():
    """The program's kernel build cache at a fixed path inside the
    checkout, and no JAX through any library that could load it."""
    build = os.path.join(ROOT, "build")
    os.environ["PYFOCUSR_TPU_TORCH_BUILD_DIR"] = os.path.join(build, PACKAGE)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def p90(values):
    """The 90th percentile (linear between order statistics)."""
    v = sorted(values)
    pos = 0.9 * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def judge(entry, record):
    """{number: max over the judged calls} and the judged call indices."""
    worst = {}
    judged = record.judged()
    for _, (item, kept) in sorted(judged.items()):
        for n, v in entry.judge_pair(item, kept)["program"].items():
            worst[n] = v if math.isnan(v) or n not in worst else max(worst[n], v)
    return worst, sorted(judged)


def execute(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float):
    """Set-up, the window, the judgement.  Returns the result dict and the
    checks [(name, value, limit)]."""
    import torch

    import pyfocusr_tpu_torch as tp
    from harness import drive
    from harness import trace as T

    entry = drive.load_entry(cell.traffic["entry"]).Entry(
        tp, cell.config["pipeline_config"], cell.traffic, device)
    entry.seed(seed)
    entry.call(entry.deck[0])  # warm: builds, loads and captures
    drive.sync(device)
    setup_s = time.perf_counter() - t_start
    order = drive.Order(len(entry.deck), seed)
    record = drive.Record(drive.sample_calls(drive.sample_rng(seed), len(entry.deck),
                                             cell.traffic["judge_pairs"]))
    on_card = torch.device(device).type == "cuda"
    metrics, dev = {}, {"platform": "gpu" if on_card else "cpu",
                        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                        "count": 1}
    extra = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        calls = []
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            window_s = drive.window(entry, order, record, math.inf,
                                    max_calls=cell.traffic["trace_pairs"],
                                    after_call=lambda: calls.append(entry.counters()))
        events = T.reduce_events(prof)
        tr = {"events": events, "calls": calls, "pairs": len(calls), "window_s": window_s,
              "busy_s": T.busy_seconds(events)}
        metrics = T.read_metrics(os.path.join(BENCH_DIR, "metrics"), cell.per_layer, tr)
        dev.update(busy_s=tr["busy_s"], window_s=window_s)
        extra["breakdown"] = T.breakdown(events)
        out_dir = os.path.join(ROOT, "build", "benchmark")
        os.makedirs(out_dir, exist_ok=True)
        T.save(tr, os.path.join(out_dir, f"trace_{cell.name}.json"))
    else:
        window_s = drive.window(entry, order, record, seconds)
        names = {m["name"] for m in cell.end_to_end}
        values = {"setup_s": setup_s, "pairs_per_s": len(record.seconds) / window_s,
                  "pair_p90_s": p90(record.seconds) if record.seconds else math.nan}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {n: {"value": values[n], "unit": units[n]} for n in values if n in names}
    dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if on_card else 0
    found = forbidden_loaded(list(sys.modules))
    if found:
        raise RunFailure(f"modules of JAX or the JAX package were loaded: {found}")
    worst, judged = judge(entry, record)
    names = list(worst) + [n for n in cell.limits if n not in worst]
    checks = [(n, worst.get(n, math.nan), cell.limits.get(n, math.nan)) for n in names]
    attempted = len(record.seconds) + record.failed
    ok = record.failed == 0 and attempted > 0 and all(v <= lim for _, v, lim in checks)
    result = {"correct": bool(ok), "attempted": attempted, "failed": record.failed,
              "metrics": metrics, "device": dev, **extra, "judged_calls": judged}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        log(f"no {PACKAGE}/ beside benchmark/: run from a checkout of the repository")
        return 2
    bench = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    bad = spec.check_names(bench)
    if bad:
        log(f"BENCHMARK.json has names or units outside the allowed characters: {bad}")
        return 2
    cell = spec.Cell(bench, args.workload)
    prepare_environment()
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log(f"card: {power_line()}")
    try:
        result, checks = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                 T_START)
    except RunFailure as exc:
        log(str(exc))
        return 4
    except Exception:  # noqa: BLE001 - the run's boundary: report and fail
        log(traceback.format_exc())
        return 5
    for name, value, limit in checks:
        log(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAIL'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
