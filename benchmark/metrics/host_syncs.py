"""Host reads of the device a traced pair, every site (``spans.host_read``:
the device loops' flag reads, each ``eigh``'s error check, SVQB's rank test,
the top-up gate, pageable copies), from the program's call records."""

from harness.records import per_pair


def read(trace):
    return per_pair(trace, lambda rec: rec.host_syncs())
