"""Host milliseconds a pair in the program's ``register_pair/smoothing``
profiler range (``pipeline._StageRanges``)."""

from harness.trace import host_ms_per_pair


def read(trace):
    return host_ms_per_pair(trace, "smoothing")
