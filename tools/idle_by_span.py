#!/usr/bin/env python3
"""The card's idle time during one registration, put down to the innermost
span open on the host (``pyfocusr_tpu_torch/utils/spans.py``'s stages and
nested spans) at the middle of each idle gap.

    python3 tools/idle_by_span.py [--levels 5] [--export FILE]

Registers the synthetic bone pair of ``chip_smoke.py`` (``--levels`` 5:
10242 vertices, 6: 40962) with the benchmark's 'kd' settings twice, the
second time under ``torch.profiler`` (host and CUDA), with the draws made
before the call as the benchmark's entry makes them.  The device is busy
where any CUDA kernel or copy runs (the union of their intervals); each
gap between busy intervals, from the first host range's start to the
last one's end, goes to the innermost span open on the host at its
midpoint (the one that started last among those open).  ``--export``
writes the profiler's Chrome trace.  Prints one JSON line: the idle and
busy milliseconds and the idle milliseconds by span, longest first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from spans_cost import KD  # noqa: E402


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(ranges, device):
    """{span: idle us} over the gaps of ``device`` intervals within the
    span of ``ranges`` [(name, start, end)], each gap to the innermost
    range open at its midpoint ("none" where none is)."""
    busy = _merged(device)
    start = min(r[1] for r in ranges)
    end = max(r[2] for r in ranges)
    edges = [start] + [x for iv in busy for x in iv] + [end]
    ranges = sorted(ranges, key=lambda r: r[1])
    out = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "none"
        for n, r0, r1 in ranges:
            if r0 > mid:
                break
            if r1 >= mid:
                name = n  # later starts are the inner ones
        out[name] = out.get(name, 0.0) + (b - a)
    return out, sum(b - a for a, b in busy)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--export", default=None)
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import pyfocusr_tpu_torch as tp
    from pyfocusr_tpu_torch.utils import spans

    cfg = tp.pipeline.PipelineConfig(**KD)
    t, s = (tp.mesh_to_graph_arrays(chip_smoke.synthetic_bone(tp, seed, levels=args.levels),
                                    device="cuda") for seed in (2, 1))
    tp.register_pair(t, s, cfg, draws=tp.pipeline.make_draws(8, cfg, t.n_points, s.n_points))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        draws = tp.pipeline.make_draws(7, cfg, t.n_points, s.n_points)
        tp.register_pair(t, s, cfg, draws=draws)
        torch.cuda.synchronize()
    rec = spans.RECORDS[-1]
    names = {sp[0] for sp in rec.spans}
    ranges, device = [], []
    for e in prof.events():
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if e.name not in names:  # a range's device-side span is no work
                device.append((a, b))
        elif e.name in names:
            ranges.append((e.name, a, b))
    idle, busy = idle_by_span(ranges, device)
    if args.export:
        prof.export_chrome_trace(args.export)
    print(json.dumps({"levels": args.levels, "n": t.n_points,
                      "card": chip_smoke.nvidia_smi_line(),
                      "busy_ms": busy / 1e3, "idle_ms": sum(idle.values()) / 1e3,
                      "idle_ms_by_span": sorted(([k, v / 1e3] for k, v in idle.items()),
                                                key=lambda x: -x[1]),
                      "host_ms_by_span": {n: rec.span_ms(n) for n in sorted(names)},
                      "syncs": {f"{st}/{site}": [c, ns / 1e6]
                                for (st, site), (c, ns) in rec.syncs.items()}}), flush=True)


if __name__ == "__main__":
    main()
