"""Spans and counters of a registration: one record per call.

No counterpart in ``pyfocusr_tpu``.  Every registration entry point runs
through ``pipeline._run``, which opens a :class:`call`; while it is open:

* ``record.stage(name)`` opens the consecutive top-level ranges
  ``register_pair/<name>`` (inputs, icp, spectra, eigsort, cpd,
  correspondences, smoothing, final_knn): each stage ends where the next
  begins, so that every host instant of a pair lies in one of them;
* :class:`span` opens a nested span where the work happens
  (``spectra/chunk``, ``cpd/em_loop``, ...).  Its name never starts with
  ``register_pair/``: a profiler trace's top-level ranges stay consecutive;
* :func:`count` adds to a counter of the open stage (ICP and EM iterations,
  JV's steps, the meshes' rows, CPD's shape, E-step route and row tiles);
* :class:`host_read` counts and times a place where the host blocks on the
  device (a flag read, an ``eigh``'s error check, a pageable copy) under
  the open stage and the site's name; it changes no value and no order;
* :func:`solve` keeps each eigensolve's schedule.

Each stage opens a ``torch.profiler.record_function`` range while a
profiler runs (the profiler's clock, shared with its device trace), which
the profiler also shows on the device as the span of the stage's work.  A
nested span opens a host-only range (``_RecordFunctionFast``, a function
range): a device-side span of its name would read as device work to a
reader that counts every device event.  Kernels launched outside a torch
operator (the hand-written kernels' ctypes launches, graph replays) inside
a nested span are the span's in the profiler's tree, and so count in its
stage's device time, which misses those launched in the stage's own range.
Every stage and span
adds its host time (``time.perf_counter_ns``) to the open record.  Outside
a call they open their range only, and counts are dropped.
:func:`before_call` is the one top-level range outside a call
(``register_pair/draws``, the draws a caller makes before the call); it is
the profiler's only, as nothing ties it to the call that takes the draws.

``RECORDS`` holds the last 32 records, newest last; a record is kept from
its call's start, ``completed`` once the call returned.  Nothing is written
to disk.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
from torch.profiler import record_function

__all__ = ["RECORDS", "STAGE_PREFIX", "CallRecord", "before_call", "call", "count",
           "current", "host_read", "solve", "span"]

STAGE_PREFIX = "register_pair/"
RECORDS = collections.deque(maxlen=32)

_now = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
_local = threading.local()
_ids = itertools.count(1)


def _enter_range(name: str, host_only: bool = False):
    """A profiler range opened (``host_only``: with no device-side span), or
    None when no profiler runs."""
    if not _profiling():
        return None
    r = torch._C._profiler._RecordFunctionFast(name) if host_only else record_function(name)
    r.__enter__()
    return r


class CallRecord:
    """What one call did.

    call_id    the call's number in this process, from 1
    completed  whether the call returned (False while it runs, or if it raised)
    spans      [(name, parent, start ns, end ns)] in the order they ended;
               a stage's name is its range's, ``register_pair/<stage>``,
               its parent None
    counters   {stage: {name: value}}; a value may be a 0-d device tensor,
               read when :meth:`counter` or :meth:`total` reads it
    syncs      {(stage, site): [host reads, blocked ns]}
    solves     each eigensolve's schedule: {"stage", "n", "warm", "chunks",
               "top_up_chunks"}
    """

    __slots__ = ("call_id", "completed", "spans", "counters", "syncs", "solves",
                 "stage_name", "_stack", "_top", "_prev")

    def __init__(self, call_id: int = 0):
        self.call_id = call_id
        self.completed = False
        self.spans = []
        self.counters = {}
        self.syncs = {}
        self.solves = []
        self.stage_name = None
        self._stack = [None]
        self._top = None
        self._prev = None

    def stage(self, name: str):
        """End the open stage and open ``register_pair/<name>``."""
        now = self._close_stage()
        full = STAGE_PREFIX + name
        self._top = (full, now, _enter_range(full))
        self.stage_name = name
        self._stack = [full]

    def _close_stage(self) -> int:
        now = _now()
        if self._top is not None:
            full, t0, rng = self._top
            self.spans.append((full, None, t0, now))
            if rng is not None:
                rng.__exit__(None, None, None)
            self._top = None
        return now

    def counter(self, stage: str, name: str, default=0):
        value = self.counters.get(stage, {}).get(name, default)
        return int(value) if torch.is_tensor(value) else value

    def total(self, name: str):
        """A counter summed over the stages."""
        return sum(self.counter(stage, name) for stage in self.counters
                   if name in self.counters[stage])

    def host_syncs(self, stage: str = None) -> int:
        return sum(c for (st, _), (c, _) in self.syncs.items() if stage in (None, st))

    def host_wait_ms(self, stage: str = None) -> float:
        return sum(ns for (st, _), (_, ns) in self.syncs.items() if stage in (None, st)) / 1e6

    def span_ms(self, name: str) -> float:
        """Host milliseconds in the spans called ``name``."""
        return sum(t1 - t0 for n, _, t0, t1 in self.spans if n == name) / 1e6

    def span_count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[0] == name)


def current():
    """The open call's record, or None."""
    return getattr(_local, "rec", None)


class call:
    """The record of one registration call (``with call() as rec``): kept
    in ``RECORDS`` from its start; the open stage is closed and
    ``completed`` set when the block ends."""

    __slots__ = ("rec",)

    def __enter__(self) -> CallRecord:
        rec = self.rec = CallRecord(next(_ids))
        rec._prev = current()
        RECORDS.append(rec)
        _local.rec = rec
        return rec

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        rec._close_stage()
        rec.stage_name = None
        rec.completed = exc_type is None
        _local.rec = rec._prev
        rec._prev = None
        return False


class span:
    """A nested span (``with span("spectra/chunk") as sp``): a host-only
    profiler range while a profiler runs, and (name, parent, start, end)
    in the open record; ``sp.ns`` is its host time, in or outside a call.
    ``profiled=False`` opens no range: a kernel launched outside a torch
    operator inside the span then stays in its stage's range alone, where
    the stage's device time does not count it."""

    __slots__ = ("name", "profiled", "rec", "rng", "t0", "ns")

    def __init__(self, name: str, profiled: bool = True):
        self.name = name
        self.profiled = profiled

    def __enter__(self):
        self.rng = _enter_range(self.name, host_only=True) if self.profiled else None
        rec = self.rec = current()
        if rec is not None:
            rec._stack.append(self.name)
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        self.ns = t1 - self.t0
        rec = self.rec
        if rec is not None:
            rec._stack.pop()
            rec.spans.append((self.name, rec._stack[-1], self.t0, t1))
        if self.rng is not None:
            self.rng.__exit__(exc_type, exc, tb)
        return False


class before_call:
    """The span of work a caller does for the next call, before it
    (``pipeline.make_draws``): the top-level profiler range
    ``register_pair/<name>`` outside a call, in no record; inside a call,
    the nested span ``<name>``."""

    __slots__ = ("name", "inner", "rng")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.inner = None
        if current() is not None:
            self.inner = span(self.name)
            return self.inner.__enter__()
        self.rng = _enter_range(STAGE_PREFIX + self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.inner is not None:
            return self.inner.__exit__(exc_type, exc, tb)
        if self.rng is not None:
            self.rng.__exit__(exc_type, exc, tb)
        return False


class host_read:
    """``with host_read(site, n) as r``: the block waits on the device ``n``
    times (a read to the host, an ``eigh``'s error check, a pageable copy);
    counted and timed under the open stage and ``site``.  ``r.ns`` is the
    block's host time, in or outside a call."""

    __slots__ = ("site", "n", "t0", "ns")

    def __init__(self, site: str, n: int = 1):
        self.site = site
        self.n = n

    def __enter__(self):
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = self.ns = _now() - self.t0
        rec = current()
        if rec is not None and self.n:
            key = (rec.stage_name, self.site)
            s = rec.syncs.get(key)
            if s is None:
                rec.syncs[key] = [self.n, dt]
            else:
                s[0] += self.n
                s[1] += dt
        return False


def count(name: str, value=1):
    """Add ``value`` (an int, or a 0-d device tensor read only when the
    record is read) to the open stage's counter ``name``."""
    rec = current()
    if rec is None:
        return
    stage = rec.counters.get(rec.stage_name)
    if stage is None:
        stage = rec.counters[rec.stage_name] = {}
    stage[name] = stage[name] + value if name in stage else value


def solve(n: int, warm: bool, chunks: int, top_up_chunks: int):
    """Keep an eigensolve's schedule in the open record."""
    rec = current()
    if rec is not None:
        rec.solves.append({"stage": rec.stage_name, "n": n, "warm": warm, "chunks": chunks,
                           "top_up_chunks": top_up_chunks})
