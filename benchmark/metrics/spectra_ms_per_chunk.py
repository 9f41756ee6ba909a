"""Host milliseconds in ``spectra/chunk`` (a chunk's filter steps, SVQB and
Rayleigh-Ritz) over the chunks run, both solves of every traced pair, from
the program's call records (``solves``)."""

from harness.records import ratio


def read(trace):
    return ratio(trace, lambda rec: rec.span_ms("spectra/chunk"),
                 lambda rec: sum(s["chunks"] for s in rec.solves))
