#!/usr/bin/env python3
"""Issue rates of one SM on the card for the operations of the CPD E-step
kernel: f32 FMA, f32 add and the `ex2.approx` exponential
(``tools/sm_rate_probe.cu``), with the SM clock sampled by ``nvidia-smi``
while they run; and the clocks of one dependent f64 FMA, division, square
root and reciprocal square root in one thread (the chain of the Umeyama
close kernel).

    python3 tools/sm_rate_probe.py

Each kernel runs 8 blocks of 256 threads per SM, eight independent chains a
thread; the rate is lane operations per SM per clock at the sampled clock.
Prints one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import threading
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("sm_rate_probe: needs a CUDA device", file=sys.stderr)
        return 2
    out_dir = os.path.join(_ROOT, "build", "sm_rate_probe")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "probe.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path,
                    os.path.join(_ROOT, "tools", "sm_rate_probe.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.probe_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int]
    lib.probe_f64_chain.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads = sms * 8, 256
    out = torch.empty(blocks * threads, device="cuda")
    clocks, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True)
            clocks.append(float(r.stdout.split()[0]))
            time.sleep(0.2)

    sampler = threading.Thread(target=sample)
    sampler.start()
    res = {}
    for which, name, iters in ((0, "ffma", 20000), (1, "fadd", 20000), (2, "ex2", 4000)):
        if lib.probe_run(which, out.data_ptr(), blocks, threads, 100) != 0:
            raise RuntimeError(f"probe {name} failed to launch")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            lib.probe_run(which, out.data_ptr(), blocks, threads, iters)
        end.record()
        torch.cuda.synchronize()
        res[name] = {"ms": start.elapsed_time(end) / 10,
                     "lane_ops": blocks * threads * iters * 8}
    stop.set()
    sampler.join()
    # Clocks of one dependent f64 operation: the difference of two chain
    # lengths, so the loop's fixed cost and the clock reads cancel.
    chain = torch.zeros(2, dtype=torch.int64, device="cuda")
    f64_clocks = {}
    for which, name in enumerate(("fma", "div", "sqrt", "rsqrt")):
        cycles = []
        for iters in (1000, 2000):
            if lib.probe_f64_chain(chain.data_ptr(), which, iters) != 0:
                raise RuntimeError(f"f64 chain probe {name} failed to launch")
            cycles.append(int(chain[0]))
        f64_clocks[name] = (cycles[1] - cycles[0]) / 1000
    mhz = max(clocks)
    for r in res.values():
        r["per_sm_per_clock"] = r["lane_ops"] / (r["ms"] / 1e3) / sms / (mhz * 1e6)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"nvidia_smi": smi.strip(), "sm_clock_mhz_samples": clocks,
                      "rates": res, "f64_dependent_clocks": f64_clocks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
