"""Iteration loops whose state and stop flag live on the device.

No counterpart in ``pyfocusr_tpu`` (JAX runs such loops as one
``lax.while_loop``).  Shared by CPD's EM loops (``ops/cpd.py::_em_loop``)
and ICP (``ops/icp.py::icp``).  The caller builds one masked iteration,
``step()``: it keeps the old state where the int32 done flag is set,
advances its iteration count only while not done, and sets the flag from
its stop test, all on the device.  ``run_blocked`` runs that iteration and
reads the (count, flag) pair on the host every ``block`` iterations.  On a
CUDA device the iteration runs once eagerly (on a side stream, which also
sets up the libraries' workspaces), is then captured as a CUDA graph and
replayed; a failed capture raises.  On the CPU it runs eagerly with the same
reads.
"""

from __future__ import annotations

import time

import torch

__all__ = ["captured", "reset_stats", "run_blocked"]


def reset_stats(stats: dict, block: int):
    """Empty ``stats`` and set the fields ``run_blocked`` fills: iterations,
    whether it ran as a CUDA graph, iterations run after the first (replays
    on the card), host reads of the flag, and host milliseconds spent
    capturing, replaying (launching the replays) and reading."""
    stats.clear()
    stats.update(iterations=0, graph=False, replays=0, host_reads=0,
                 capture_ms=0.0, replay_ms=0.0, read_ms=0.0, block=block)


def run_blocked(step, ctrl: torch.Tensor, max_iterations: int, block: int,
                stats: dict, kernels=(), what: str = "loop") -> int:
    """Run the masked iteration ``step`` until the flag ``ctrl[1]`` is set,
    reading ``ctrl`` = int32 (iteration count, done flag) on the host every
    ``block`` iterations; at most ``max_iterations`` iterations run.
    ``kernels``: modules whose ``LAUNCHES`` count the graph's launches (see
    ``captured``).  Returns the iteration count; fills ``stats``."""
    run = step
    if ctrl.device.type == "cuda":
        run = captured(step, ctrl.device, kernels, stats)
    else:
        step()
    ran, reads, replay_s = 1, 1, 0.0
    t0 = time.perf_counter()
    it, done = ctrl.tolist()
    read_s = time.perf_counter() - t0
    while not done:
        k = min(block, max_iterations - ran)
        if k <= 0:
            raise RuntimeError(f"{what}: the stop flag is unset after max_iterations")
        t0 = time.perf_counter()
        for _ in range(k):
            run()
        t1 = time.perf_counter()
        it, done = ctrl.tolist()
        replay_s += t1 - t0
        read_s += time.perf_counter() - t1
        ran += k
        reads += 1
    stats.update(iterations=it, replays=ran - 1, host_reads=reads,
                 replay_ms=replay_s * 1e3, read_ms=read_s * 1e3)
    return it


def captured(step, device, kernels, stats: dict):
    """Run ``step`` once eagerly on a side stream, capture it there as a CUDA
    graph and return the replay.  The capture is begun and ended on the
    graph itself, not through ``torch.cuda.graph``, whose entry synchronizes
    and empties the allocator's cache each time, so that every block the
    rest of a pair had cached would be allocated again after each loop.
    The launches a hand-written kernel's wrapper counts in its module's
    ``LAUNCHES`` (each module of ``kernels``) during the capture are moved
    to each replay."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        step()
        t0 = time.perf_counter()
        before = [mod.LAUNCHES for mod in kernels]
        graph.capture_begin()
        try:
            step()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    stats.update(graph=True, capture_ms=(time.perf_counter() - t0) * 1e3)
    per_replay = [mod.LAUNCHES - b for mod, b in zip(kernels, before)]
    for mod, b in zip(kernels, before):
        mod.LAUNCHES = b

    def replay():
        graph.replay()
        for mod, n in zip(kernels, per_replay):
            mod.LAUNCHES += n

    return replay
