"""Banner printing and per-stage wall-clock timing.

Counterpart of ``pyfocusr_tpu/utils/logging.py``: ``print_header`` (:14) and
``StageTimer`` (:21).  On a CUDA card launches return before the work is
done, so a span synchronises the card before it reads the clock at its end:
otherwise a stage's kernels would be charged to the next stage that waits
for them.  ``enable_profiler`` opens a ``torch.profiler.record_function``
range per span (the JAX version's ``jax.profiler.TraceAnnotation``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

__all__ = ["print_header", "StageTimer"]


def print_header(string: str) -> None:
    """Banner print: the string between two rules of 72 '='."""
    print("=" * 72)
    print(string)
    print("=" * 72)


class StageTimer:
    """Wall-clock spans per pipeline stage::

        timer = StageTimer()
        with timer.span("eigensolve"):
            ...
        timer.report()
    """

    def __init__(self, enable_profiler: bool = False, verbose: bool = False):
        self.spans: List[tuple] = []
        self.enable_profiler = enable_profiler
        self.verbose = verbose

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.enable_profiler:
            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            # Recorded even when the body raises: a failing stage's partial
            # time is what a crash diagnosis needs.
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.spans.append((name, dt))
            if self.verbose:
                print(f"[timing] {name}: {dt * 1000:.1f} ms")

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.spans:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> None:
        print_header("Stage timings")
        for name, dt in self.totals().items():
            print(f"{name:40s} {dt * 1000:10.1f} ms")
