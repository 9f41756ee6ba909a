"""The measured window, the same for every entry: one caller calling back
to back, as a lab's registration script calls the library.

An entry (``entries/<name>.py``, named by the traffic mix's ``entry``) holds
what belongs to one entry point of the program: its set-up, its deck of
work items, one timed call, the counters a traced call leaves and the
judgement of a kept call.  This module cycles the entry's deck in an order
drawn from ``--seed``, keeps every call's seconds and the calls to judge.
"""

from __future__ import annotations

import importlib.util
import os
import time
import traceback

import numpy as np
import torch

ENTRIES_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "entries")


def load_entry(name: str, entries_dir: str = ENTRIES_DIR):
    """The module ``entries/<name>.py``."""
    path = os.path.join(entries_dir, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_entry_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seed_ints(seed: int):
    """The run's seed as the non-negative integer the generators take, and
    a numpy generator seeded by it."""
    s = int(seed) & (2**63 - 1)
    return s, np.random.default_rng(s)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Order:
    """The deck's indices in cycles, each cycle a permutation drawn from
    the seed: every seed calls the same work, in its own order."""

    def __init__(self, deck_size: int, seed: int):
        self.size = deck_size
        self.rng = seed_ints(seed)[1]
        self.queue = []

    def next(self) -> int:
        if not self.queue:
            self.queue = [int(i) for i in self.rng.permutation(self.size)]
        return self.queue.pop(0)


class Record:
    """What the window keeps: every call's seconds, and what the entry
    returned for the calls to judge (the sampled call indices and the
    slowest call)."""

    def __init__(self, sample):
        self.sample = set(sample)
        self.seconds = []
        self.kept = {}
        self.slowest = None
        self.failed = 0

    def add(self, i, item, kept, sec):
        self.seconds.append(sec)
        if i in self.sample:
            self.kept[i] = (item, kept)
        if self.slowest is None or sec > self.slowest[0]:
            self.slowest = (sec, i, item, kept)

    def judged(self):
        """{call index: (deck item, what the call kept)}: the sample and
        the slowest."""
        out = dict(self.kept)
        if self.slowest is not None:
            _, i, item, kept = self.slowest
            out.setdefault(i, (item, kept))
        return out


def sample_rng(seed: int):
    """The generator of the judged sample, a stream of the seed apart from
    the order's."""
    return np.random.default_rng([seed_ints(seed)[0], 1])


def sample_calls(rng, deck_size: int, count: int):
    """Call indices to judge, drawn from the seed within the first cycle
    of the deck (every window finishes it)."""
    return [int(i) for i in rng.choice(deck_size, size=min(count, deck_size), replace=False)]


def window(entry, order: Order, record: Record, seconds: float, max_calls: int = None,
           after_call=None):
    """Call ``entry.call(item)`` back to back until ``seconds`` have passed
    since the first call (or ``max_calls`` calls); ``after_call()`` runs
    after each.  A call that raises counts as failed, with its traceback on
    standard error.  Returns the window's seconds: from the first call to
    the end of the last."""
    t_start = time.perf_counter()
    i = 0
    while True:
        item = entry.deck[order.next()]
        try:
            kept, sec = entry.call(item)
        except Exception:  # noqa: BLE001 - a failed call is counted, not fatal
            traceback.print_exc()
            record.failed += 1
        else:
            record.add(i, item, kept, sec)
            if after_call is not None:
                after_call()
        i += 1
        elapsed = time.perf_counter() - t_start
        if elapsed >= seconds or (max_calls is not None and i >= max_calls):
            return elapsed
