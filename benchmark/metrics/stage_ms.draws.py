"""Host milliseconds a pair in the program's ``register_pair/draws``
profiler range: ``pipeline.make_draws``, the numpy draws of a pair's random
inputs, which the entry makes before each call."""

from harness.trace import host_ms_per_pair


def read(trace):
    return host_ms_per_pair(trace, "draws")
