"""The streamed CPD E-step's share of its roofline, in %: the least time of
the E-steps that did work (``roofline/estep.py``), over the summed device
time of the ``estep_`` kernel events (``csrc/cpd_estep.cu``'s den and row
passes) in the device trace.  The work comes from each traced call's
record (``pyfocusr_tpu_torch.utils.spans``): the CPD stage's shape
(``cpd_rows`` M, ``cpd_cols`` N, ``cpd_dims`` D) and its EM iterations
(``em_iterations``), in the calls whose E-step was streamed
(``estep_streamed`` 1).  The masked replays after the stop do no work and
count as none.  None without records, where no call streamed, or where
the trace holds no E-step kernel."""

from harness.records import traced_records
from harness.trace import kernel_events
from roofline import estep


def read(trace):
    recs = traced_records(trace)
    if recs is None:
        return None
    streamed = [r for r in recs if r.counter("cpd", "estep_streamed", 0) == 1]
    busy_s = sum(e["dur"] for e in kernel_events(trace, "estep_")) / 1e6
    if not streamed or not busy_s:
        return None
    bound = sum(estep.bound_s(r.counter("cpd", "cpd_rows"), r.counter("cpd", "cpd_cols"),
                              r.counter("cpd", "cpd_dims"), r.counter("cpd", "em_iterations"))
                for r in streamed)
    return 100.0 * bound / busy_s
