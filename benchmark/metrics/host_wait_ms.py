"""Host milliseconds a traced pair blocked in its reads of the device
(``spans.host_read``), from the program's call records."""

from harness.records import per_pair


def read(trace):
    return per_pair(trace, lambda rec: rec.host_wait_ms())
