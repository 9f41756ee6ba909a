"""The k-NN route inside the band where neither wins surely: race once per
shape class, persist the winner.

Counterpart of ``pyfocusr_tpu/ops/knn_routing.py`` (``cache_file``,
``bucket_key`` :68, ``_load``, ``_store``, ``routed`` :129).  Outside the
band ``ops/knn.py`` decides from its bounds.  The first query inside it for
a (k class, log2 pairs, log2 smaller side) bucket runs both exact routes,
each once untimed and once timed between ``torch.cuda.synchronize()`` calls,
returns the faster one's result and records it; later queries in the
bucket, in this process or another, take the recorded winner.  Both routes
return the same bits (``ops/grid_knn.py``), so the race decides time only.

The record is ``knn_routing_<device name>.json`` (the CUDA device's name,
or ``cpu``) in ``$PYFOCUSR_TPU_CAL_DIR``, by default the build directory of
the kernels (``build/pyfocusr_tpu_torch/`` or
``$PYFOCUSR_TPU_TORCH_BUILD_DIR``); delete it to race again.  The port's
bucket keys carry no legacy ``k1_`` form, so no two k classes share a key.
"""

from __future__ import annotations

import json
import math
import os
import re
import time

import torch

from ..utils import spans
from ._cuda_build import BUILD_DIR

__all__ = ["bucket_key", "cache_file", "routed"]

# The loaded record of each cache file, so one process races a bucket at
# most once even where the file cannot be written.
_MEM: dict = {}


def _cal_dir() -> str:
    return os.environ.get("PYFOCUSR_TPU_CAL_DIR", str(BUILD_DIR))


def cache_file(device) -> str:
    """The record of ``device``: named after the CUDA device, or ``cpu``."""
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    name = re.sub(r"[^A-Za-z0-9_.-]+", "_", name)
    return os.path.join(_cal_dir(), f"knn_routing_{name}.json")


def bucket_key(nq: int, nr: int, k: int) -> str:
    """The shape class: log2 of k, of the pair count and of the smaller
    side (the grid's cost follows the reference size, brute's the
    product, so extreme aspect ratios stay apart)."""
    pairs = max(float(nq) * float(nr), 1.0)
    side = max(float(min(nq, nr)), 1.0)
    return (f"k{int(math.log2(max(k, 1)))}_p{int(math.log2(pairs))}"
            f"_m{int(math.log2(side))}")


def _read(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _load(path: str) -> dict:
    if path not in _MEM:
        _MEM[path] = _read(path)
    return _MEM[path]


def _store(path: str, data: dict) -> None:
    """Write ``data`` merged over what the file holds now (another process
    may have raced another bucket meanwhile; ours win a shared key),
    atomically; an unwritable directory keeps the record in memory."""
    data = {**_read(path), **data}
    _MEM[path] = data
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def _sync(device):
    if torch.device(device).type == "cuda":
        with spans.host_read("route_race"):
            torch.cuda.synchronize(device)


def routed(bucket: str, runners: dict, device):
    """The recorded winner's result for ``bucket``, or the race of every
    runner (name -> thunk returning tensors on ``device``): one untimed
    call each, then one timed call each; the winner's timed result is
    returned and recorded with both times."""
    path = cache_file(device)
    entry = _load(path).get(bucket)
    if isinstance(entry, dict) and entry.get("winner") in runners:
        return runners[entry["winner"]]()
    times, results = {}, {}
    for name, thunk in runners.items():
        thunk()  # warm-up: a first call's set-up must not vote
        _sync(device)
        t0 = time.perf_counter()
        results[name] = thunk()
        _sync(device)
        times[name] = time.perf_counter() - t0
    winner = min(times, key=times.get)
    _store(path, {**_load(path), bucket: {"winner": winner, "times_s": times}})
    return results[winner]
