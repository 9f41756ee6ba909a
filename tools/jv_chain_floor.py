#!/usr/bin/env python3
"""The chain floor of the Jonker-Volgenant kernel's Dijkstra step on one
CUDA card: the latency of one dependent row load and of one cluster barrier,
measured by the probes in ``tools/jv_chain_floor.cu``.

    python3 tools/jv_chain_floor.py [--steps 200000]

A step of ``csrc/jv.cu`` cannot start its row loads before the previous
step's argmin names the row, and no CTA knows the argmin before every CTA
has shared its candidates, so steps x (dependent row load + one cluster
barrier) is the floor of a design with this chain.  Measured:

* ``chase``: ns per dependent load of one row slice, a block of
  ceil(n / 16) threads reading one int32 each (one CTA's share of a row at
  16 CTAs), the slice's first word naming the next (row, slice) pair in a
  random cycle over 15 slices of every row; in a 10242 x 10242 buffer (420
  MB, beyond the 50 MB L2) and a 2562 x 2562 one (26 MB, L2-resident), as
  the cost is at those n;
* ``barrier``: ns per bare cluster barrier (arrive.release / wait.acquire)
  of 16 CTAs of 256 threads; ``exchange_barrier``: ns per candidate
  exchange through distributed shared memory with one cluster barrier;
  ``exchange_mbarrier``: ns per exchange written with st.async and waited
  for on each CTA's mbarrier, as ``csrc/jv.cu`` does it.

Each figure is CUDA-event time over one launch of ``--steps`` iterations,
after one warm-up launch.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from pyfocusr_tpu_torch.ops._cuda_build import CudaLibrary  # noqa: E402

_LIB = CudaLibrary(str(Path(__file__).with_name("jv_chain_floor.cu")), "jv_chain_floor",
                   "chain-floor probe", {
                       "pyfocusr_chase": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p],  # buf, row_len, slice, steps, start, out, stream
                       "pyfocusr_exchange": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_void_p],
                   })
SLICES = 15  # full slices of ceil(n / 16) words in a row of n


def _events_ns(fn, iters):
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e6 / iters


def chase_ns(lib, n, steps, stream):
    slice_ = -(-n // 16)
    g = torch.Generator().manual_seed(n)
    # A random cycle over the (row, slice) pairs, each named row * 16 + slice.
    rows = torch.arange(n).repeat_interleave(SLICES)
    sl = torch.arange(SLICES).repeat(n)
    order = torch.randperm(n * SLICES, generator=g)
    at = (rows * 16 + sl)[order]
    buf = torch.zeros((n, n), dtype=torch.int32)
    buf.view(-1)[(at // 16) * n + (at % 16) * slice_] = torch.roll(at, -1).to(torch.int32)
    buf = buf.cuda()
    out = torch.empty(slice_, dtype=torch.int32, device="cuda")

    def run():
        err = lib.pyfocusr_chase(buf.data_ptr(), n, slice_, steps, int(at[0]),
                                 out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"chase launch failed: error {err}")

    return _events_ns(run, steps)


def exchange_ns(lib, iters, exchange, stream):
    out = torch.empty(16, dtype=torch.int32, device="cuda")

    def run():
        err = lib.pyfocusr_exchange(iters, exchange, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"exchange launch failed: error {err}")

    return _events_ns(run, iters)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("jv_chain_floor: needs a CUDA device", file=sys.stderr)
        return 2
    lib = _LIB.load()
    stream = torch.cuda.current_stream().cuda_stream
    res = {
        "device": torch.cuda.get_device_name(0),
        "chase_ns_10242": chase_ns(lib, 10242, args.steps, stream),
        "chase_ns_2562": chase_ns(lib, 2562, args.steps, stream),
        "barrier_ns": exchange_ns(lib, args.steps, 0, stream),
        "exchange_barrier_ns": exchange_ns(lib, args.steps, 1, stream),
        "exchange_mbarrier_ns": exchange_ns(lib, args.steps, 2, stream),
        "cluster": "16 CTAs x 256 threads",
    }
    # The floor of a step: its dependent row load and one cluster barrier;
    # beside it, the load and the kernel's own exchange.
    for n in (10242, 2562):
        chase = res[f"chase_ns_{n}"]
        res[f"floor_us_per_step_{n}"] = (chase + res["barrier_ns"]) / 1e3
        res[f"load_and_exchange_us_{n}"] = (chase + res["exchange_mbarrier_ns"]) / 1e3
    print(json.dumps({"jv_chain_floor": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
