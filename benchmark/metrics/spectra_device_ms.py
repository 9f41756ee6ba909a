"""Device milliseconds a pair of the torch operators launched inside the
``register_pair/spectra`` range (the profiler's device time of the range;
the spectra launch no ctypes kernel and replay no graph, so it is whole)."""

from harness.trace import HOST_PREFIX


def read(trace):
    us = [e["device_us"] for e in trace["events"]
          if e["kind"] == "cpu" and e["name"] == HOST_PREFIX + "spectra"]
    if not us or not trace["pairs"] or not any(us):
        return None
    return sum(us) / 1e3 / trace["pairs"]
