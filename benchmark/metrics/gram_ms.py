"""Host milliseconds a traced pair in ``cpd/gram`` (the randomized subspace
iteration of CPD's Gram, ``ops/cpd.low_rank_gaussian``), over the pairs
whose Gram was applied in row tiles (counter ``gram_tiles`` > 0), from
the program's call records; None where no pair tiled its Gram."""

from harness.records import traced_records


def read(trace):
    recs = traced_records(trace)
    if recs is None:
        return None
    tiled = [r for r in recs if r.counter("cpd", "gram_tiles", 0) > 0]
    if not tiled:
        return None
    return sum(r.span_ms("cpd/gram") for r in tiled) / len(tiled)
