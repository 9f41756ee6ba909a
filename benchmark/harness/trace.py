"""The traced run: the window's calls under ``torch.profiler``, reduced to a
small trace that the per-layer readers (``metrics/<name>.py``) read.

The trace is a dict:

events   [{"name", "kind": "cpu" | "cuda", "ts", "dur", "device_us"}]: every
         device operation (the ranges' own device-side spans left out), and
         the host ranges ``register_pair/<stage>``
         (and ``register_pair/lap_*``) the program opens; times in
         microseconds on the profiler's clock; ``device_us``, a host range's
         device time of the torch operators it launched
calls    one dict a traced call: the entry's counters read after it
         (``icp_iterations``) and the call's shapes
pairs    the number of traced calls
window_s the traced window's seconds (host clock), busy_s the seconds in
         which some device operation ran (the union of their intervals)
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os

HOST_PREFIX = "register_pair/"
# Characters of a device operation's name kept in a saved trace.
NAME_CHARS = 120


def _device_us(evt) -> float:
    if hasattr(evt, "device_time_total"):
        return float(evt.device_time_total)
    return float(evt.cuda_time_total)


def reduce_events(prof) -> list:
    """The profiler's events as plain dicts (see the module docstring)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        kind = "cuda" if e.device_type == DeviceType.CUDA else "cpu"
        # A host range shows on the device too, as the span of its work:
        # only its host side is kept.
        if (kind == "cpu") != e.name.startswith(HOST_PREFIX):
            continue
        out.append({"name": e.name, "kind": kind, "ts": float(e.time_range.start),
                    "dur": float(e.time_range.elapsed_us()),
                    "device_us": _device_us(e) if kind == "cpu" else 0.0})
    return out


def merged_device_intervals(events) -> list:
    """The union of the device operations' intervals, sorted: [[start, end]]."""
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e["kind"] == "cuda")
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(events) -> float:
    return sum(b - a for a, b in merged_device_intervals(events)) / 1e6


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    device's idle time summed by the stage range open on the host at each
    idle gap's midpoint ("between_calls" where none is), each list longest
    first."""
    ops = {}
    for e in events:
        if e["kind"] == "cuda":
            ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] / 1e6
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e["kind"] == "cpu" and not e["name"].startswith(HOST_PREFIX + "lap_"))
    starts = [r[0] for r in ranges]
    merged = merged_device_intervals(events)
    gaps = {}
    if ranges and merged:
        start = min(ranges[0][0], merged[0][0])
        end = max(max(r[1] for r in ranges), merged[-1][1])
        edges = [start] + [x for iv in merged for x in iv] + [end]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            name = ranges[i][2] if i >= 0 and mid <= ranges[i][1] else "between_calls"
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return {
        "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:top],
    }


def load_reader(metrics_dir: str, name: str):
    """``metrics/<name>.py``'s ``read(trace)``."""
    path = os.path.join(metrics_dir, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics_dir: str, specs: list, trace: dict) -> dict:
    """{name: {"value", "unit"}} of each per-layer metric whose reader found
    something to read (a reader returns None where it finds nothing)."""
    out = {}
    for m in specs:
        value = load_reader(metrics_dir, m["name"])(trace)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def first_call(trace: dict) -> dict:
    """The trace cut to its first traced call (the events before the second
    ``register_pair/icp`` range), its window the span of those events: a
    small record of one pair, for reading and for tests."""
    starts = sorted(e["ts"] for e in trace["events"]
                    if e["kind"] == "cpu" and e["name"] == HOST_PREFIX + "icp")
    end = starts[1] if len(starts) > 1 else float("inf")
    events = [e for e in trace["events"] if e["ts"] < end]
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e6
    return dict(trace, events=events, calls=trace["calls"][:1], pairs=1,
                busy_s=busy_seconds(events), window_s=span)


def save(trace: dict, path: str):
    """Write the first traced call's trace (:func:`first_call`), each name
    once in a table (device names cut to ``NAME_CHARS``)."""
    t = first_call(trace)
    names, index, rows = [], {}, []
    for e in t["events"]:
        name = e["name"][:NAME_CHARS]
        if name not in index:
            index[name] = len(names)
            names.append(name)
        rows.append([index[name], e["kind"], e["ts"], e["dur"], e["device_us"]])
    with open(path, "w") as f:
        json.dump(dict(t, events=rows, names=names), f)


def load(path: str) -> dict:
    """A trace written by :func:`save`, in the form the readers take."""
    with open(path) as f:
        t = json.load(f)
    names = t.pop("names")
    t["events"] = [{"name": names[i], "kind": k, "ts": ts, "dur": dur, "device_us": dev}
                   for i, k, ts, dur, dev in t["events"]]
    return t


def host_ms_per_pair(trace: dict, stage: str):
    """Host milliseconds a traced pair in the ``register_pair/<stage>``
    ranges; None where the trace holds none."""
    durs = [e["dur"] for e in trace["events"]
            if e["kind"] == "cpu" and e["name"] == HOST_PREFIX + stage]
    if not durs or not trace["pairs"]:
        return None
    return sum(durs) / 1e3 / trace["pairs"]


def kernel_events(trace: dict, tag: str, exclude: str = None) -> list:
    """The device events whose name holds ``tag`` (and not ``exclude``)."""
    return [e for e in trace["events"] if e["kind"] == "cuda" and tag in e["name"]
            and (exclude is None or exclude not in e["name"])]
