"""The readers of the program's call records (``harness/records.py``:
``host_syncs``, ``host_wait_ms``, ``graph_capture_ms``,
``em_ms_per_iteration``, ``spectra_ms_per_chunk``) on hand-made records,
and ``stage_ms.draws`` on a hand-made trace."""

import collections
import gzip
import os
import shutil
import sys

import pytest
from conftest import BENCH_DIR, FIXTURES

from harness import records
from harness import trace as T
from pyfocusr_tpu_torch.utils import spans

METRICS = os.path.join(BENCH_DIR, "metrics")
RECORD_READERS = ("host_syncs", "host_wait_ms", "graph_capture_ms", "em_ms_per_iteration",
                  "spectra_ms_per_chunk")


def reader(name):
    return T.load_reader(METRICS, name)


def record(icp, em, chunks, capture_ms, syncs, completed=True, rows=10242):
    """A call's record: ICP's and EM's iterations, the solves' chunks, the
    captures' milliseconds (ICP's loop's, then the EM loop's, inside
    ``cpd/em_loop``), {(stage, site): (reads, ms)}, each span 1 ms a chunk
    and 0.5 ms an EM iteration besides the EM loop's captures."""
    rec = spans.CallRecord(1)
    rec.completed = completed
    rec.counters = {"inputs": {"target_rows": rows, "source_rows": rows},
                    "icp": {"icp_iterations": icp}, "cpd": {"em_iterations": em}}
    rec.solves = [{"stage": "spectra", "n": rows, "warm": i == 1, "chunks": c,
                   "top_up_chunks": 0} for i, c in enumerate(chunks)]
    rec.syncs = {key: [n, int(ms * 1e6)] for key, (n, ms) in syncs.items()}
    t = 0
    for _ in range(sum(chunks)):
        rec.spans.append(("spectra/chunk", "register_pair/spectra", t, t + 1_000_000))
        t += 1_000_000
    em_capture = [int(ms * 1e6) for ms in capture_ms[1:]]
    for i, ms in enumerate(capture_ms):
        rec.spans.append(("device_loop/capture", "cpd/em_loop" if i else "icp/loop", 0,
                          int(ms * 1e6)))
    rec.spans.append(("cpd/em_loop", "register_pair/cpd", t,
                      t + em * 500_000 + sum(em_capture)))
    return rec


def calls(*icps, rows=10242):
    return [{"icp_iterations": i, "n_target": rows, "n_source": rows} for i in icps]


@pytest.fixture
def two_pairs(monkeypatch):
    recs = collections.deque([
        record(30, 100, [5, 2], [1.0, 2.0], {("icp", "flag_read"): (5, 1.0),
                                             ("spectra", "eigh"): (14, 3.0)}),
        record(40, 60, [5, 3], [1.5, 2.5], {("cpd", "flag_read"): (8, 2.0)}),
        record(0, 0, [], [], {}, completed=False),
    ], maxlen=32)
    monkeypatch.setattr(spans, "RECORDS", recs)
    return {"events": [], "calls": calls(30, 40), "pairs": 2, "window_s": 1.0, "busy_s": 0.5}


def test_record_readers_on_two_pairs(two_pairs):
    assert reader("host_syncs")(two_pairs) == pytest.approx((5 + 14 + 8) / 2)
    assert reader("host_wait_ms")(two_pairs) == pytest.approx((1.0 + 3.0 + 2.0) / 2)
    assert reader("graph_capture_ms")(two_pairs) == pytest.approx((3.0 + 4.0) / 2)
    assert reader("em_ms_per_iteration")(two_pairs) == pytest.approx(0.5)
    assert reader("spectra_ms_per_chunk")(two_pairs) == pytest.approx(1.0)


@pytest.mark.parametrize("name", RECORD_READERS)
def test_record_readers_find_nothing_without_the_traced_records(monkeypatch, two_pairs, name):
    fewer = dict(two_pairs, pairs=3, calls=calls(1, 30, 40))
    assert reader(name)(fewer) is None  # two completed records for three pairs
    other = dict(two_pairs, calls=calls(30, 41))
    assert reader(name)(other) is None  # not the traced calls: ICP disagrees
    smaller = dict(two_pairs, calls=calls(30, 40, rows=2562))
    assert reader(name)(smaller) is None
    monkeypatch.setitem(sys.modules, "pyfocusr_tpu_torch.utils.spans", None)
    assert reader(name)(two_pairs) is None  # a program without the records


@pytest.mark.parametrize("name", RECORD_READERS)
def test_record_readers_find_nothing_in_a_saved_trace(tmp_path, two_pairs, name):
    path = tmp_path / "trace.json"
    with gzip.open(os.path.join(FIXTURES, "trace_kd_10k.json.gz"), "rb") as src, \
            open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    assert reader(name)(T.load(str(path))) is None


def test_traced_records_are_the_last_completed(two_pairs):
    recs = records.traced_records(two_pairs)
    assert [r.total("icp_iterations") for r in recs] == [30, 40]
    assert records.ratio(two_pairs, lambda r: 1, lambda r: 0) is None


def test_stage_ms_draws():
    ev = [{"name": "register_pair/draws", "kind": "cpu", "ts": 0.0, "dur": 3000.0,
           "device_us": 0.0},
          {"name": "register_pair/inputs", "kind": "cpu", "ts": 3000.0, "dur": 500.0,
           "device_us": 0.0},
          {"name": "register_pair/draws", "kind": "cpu", "ts": 9000.0, "dur": 5000.0,
           "device_us": 0.0}]
    t = {"events": ev, "calls": calls(1, 2), "pairs": 2, "window_s": 0.02, "busy_s": 0.0}
    assert reader("stage_ms.draws")(t) == pytest.approx(4.0)
    assert reader("stage_ms.draws")(dict(t, events=ev[1:2])) is None
