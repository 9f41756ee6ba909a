"""The program's call records (``pyfocusr_tpu_torch.utils.spans``) of a
traced run's calls, for the per-layer readers that read counters and
nested spans: the records stay in the run's own process, and the readers
run there after the window.

A program without the records (no ``utils/spans.py``) gives None, as a
trace with nothing to read does.
"""

from __future__ import annotations

import importlib

# Counters of a traced call (``entries/<name>.py``'s ``counters()``) and
# where the call's record holds the same number: (stage, counter).
_MATCHED = {"icp_iterations": (None, "icp_iterations"),
            "n_target": ("inputs", "target_rows"),
            "n_source": ("inputs", "source_rows")}


def _value(rec, stage, name):
    return rec.total(name) if stage is None else rec.counter(stage, name, None)


def traced_records(trace: dict):
    """The records of the trace's calls: the last ``trace["pairs"]`` records
    of calls that returned, each agreeing with its traced call's counters
    (ICP's iterations, the meshes' rows) where the call has them; None
    where the program keeps no records, or they are fewer or disagree (as
    for a saved trace, read in another process)."""
    try:
        spans = importlib.import_module("pyfocusr_tpu_torch.utils.spans")
    except ImportError:
        return None
    n = trace.get("pairs") or 0
    done = [r for r in list(spans.RECORDS) if r.completed]
    if n <= 0 or len(done) < n:
        return None
    recs = done[-n:]
    for rec, call in zip(recs, trace.get("calls", [])):
        for key, (stage, name) in _MATCHED.items():
            if key in call and _value(rec, stage, name) != call[key]:
                return None
    return recs


def per_pair(trace: dict, value_of):
    """The mean of ``value_of(record)`` over the traced calls, or None."""
    recs = traced_records(trace)
    if recs is None:
        return None
    return sum(value_of(r) for r in recs) / len(recs)


def ratio(trace: dict, numerator, denominator):
    """sum(numerator) / sum(denominator) over the traced calls' records;
    None without records or where the denominator sums to 0."""
    recs = traced_records(trace)
    if recs is None:
        return None
    den = sum(denominator(r) for r in recs)
    if not den:
        return None
    return sum(numerator(r) for r in recs) / den
