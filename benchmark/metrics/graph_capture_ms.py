"""Host milliseconds a traced pair in ``device_loop/capture``: the CUDA
graph captures of ICP's loop and of each EM loop, from the program's call
records."""

from harness.records import per_pair


def read(trace):
    return per_pair(trace, lambda rec: rec.span_ms("device_loop/capture"))
