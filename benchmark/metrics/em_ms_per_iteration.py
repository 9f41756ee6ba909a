"""Host milliseconds in ``cpd/em_loop`` over the EM iterations run, summed
over the traced pairs' EM loops, from the program's call records.  The
loops' CUDA graph captures (``device_loop/capture`` inside ``cpd/em_loop``,
a fixed cost a loop that ``graph_capture_ms`` reads) are left out, so that
the number does not move with how many iterations a deck's pairs take."""

from harness.records import ratio


def _loop_ms(rec):
    capture_ns = sum(t1 - t0 for name, parent, t0, t1 in rec.spans
                     if name == "device_loop/capture" and parent == "cpd/em_loop")
    return rec.span_ms("cpd/em_loop") - capture_ns / 1e6


def read(trace):
    return ratio(trace, _loop_ms, lambda rec: rec.total("em_iterations"))
