"""The port's exact voxel-grid k-NN (``pyfocusr_tpu_torch/ops/grid_knn.py``),
its route planner (``ops/knn_routing.py``) and the route decision of
``ops/knn.py``, against the port's brute-force ``knn_plain`` and the JAX
package's ``knn_grid`` / ``knn_routing``.

Gates:
* the grid equals ``knn_plain`` bit for bit (distances and indices), for
  k = 1, 2, 3 and 8 (the largest k the route sends to the grid, as JAX's
  does), on surface clouds, with masked (1e30) and non-finite
  reference and query rows, duplicated points (ties to the lower index), a
  sparse patch that pass 2 rescues and a dense spot that only the brute
  fallback resolves;
* against the JAX package's grid (whose brute fallback uses the matmul
  identity on the CPU): the same neighbour sets on >= 99.9% of rows and the
  same indices on >= 99.9% of rows;
* the route: the environment dials, both bounds and the CPU scale, k > 1
  halving, the race recording and reusing its winner, the store's merge, an
  unwritable record directory, the CUDA-graph capture guard, and JAX's
  bucket keys;
* ``knn_kernel.knn_cuda`` refuses more queries than one launch's grid
  holds, with the limit in its message.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu.ops import grid_knn as JG
from pyfocusr_tpu.ops import knn_routing as JR
from pyfocusr_tpu_torch.ops import grid_knn, knn_kernel, knn_routing
from pyfocusr_tpu_torch.ops import knn as TK

torch.set_num_threads(1)


def _bone(levels=4, seed=2):
    return np.asarray(chip_smoke.synthetic_bone(TP, seed, levels).points, np.float32)


def _near(ref, rng, sigma=0.05, n=None):
    """Queries on and near the surface of ``ref``, in shuffled order."""
    n = ref.shape[0] if n is None else n
    q = ref[rng.permutation(ref.shape[0])[:n]]
    return (q + rng.normal(0.0, sigma, q.shape)).astype(np.float32)


def _case(name):
    """(ref, query, what last_stats must show) of one case."""
    rng = np.random.default_rng(len(name))
    ref = _bone()
    if name == "surface":
        return ref, _near(ref, rng), lambda st: st["fallback_fraction"] < 0.05
    if name == "masked_nonfinite":
        ref = ref.copy()
        ref[::7] = 1e30
        ref[3, 1] = np.nan
        ref[10, 0] = np.inf
        q = _near(ref[np.isfinite(ref).all(1) & (np.abs(ref) < 1e29).all(1)], rng)
        q[0] = np.nan
        q[1, 2] = -np.inf
        return ref, q, lambda st: st["fallback_rows"] >= 2
    if name == "duplicates":
        ref = np.concatenate([ref, ref[:600], ref[:50]])  # ties across copies
        q = np.concatenate([ref[:300], _near(ref, rng, n=500)])
        return ref, q, lambda st: st["fallback_fraction"] < 0.05
    if name == "sparse_patch":
        # A cap of the bone thinned to every 20th point: there d_k exceeds
        # the pass-1 margin and pass 2 (2x cells) certifies most rows.
        patch = ref[:, 2] > 30.0
        keep = ~patch | (np.arange(ref.shape[0]) % 20 == 0)
        return ref[keep], _near(ref, rng, sigma=0.02), (
            lambda st: st["pass1_unresolved"] > 0
            and st["fallback_rows"] < st["pass1_unresolved"])
    if name == "dense_spot":
        # 400 points within 1e-3 mm of one vertex overflow every run cap,
        # pass 2's too: those queries take the brute fallback.
        spot = ref[100] + rng.normal(0.0, 1e-3, (400, 3)).astype(np.float32)
        ref = np.concatenate([ref, spot]).astype(np.float32)
        q = np.concatenate([spot[:40] + 1e-4, _near(ref, rng, n=400)]).astype(np.float32)
        return ref, q, lambda st: st["fallback_rows"] >= 40
    raise ValueError(name)


CASES = ("surface", "masked_nonfinite", "duplicates", "sparse_patch", "dense_spot")


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("case", CASES)
def test_grid_bit_equal_to_plain(case, k):
    ref, q, stats_ok = _case(case)
    r, qt = torch.from_numpy(ref), torch.from_numpy(q)
    gd, gi = grid_knn.knn_grid(r, qt, k)
    stats = dict(grid_knn.last_stats)
    pd, pi = knn_kernel.knn_plain(r, qt, k)
    assert gd.dtype == torch.float32 and gi.dtype == torch.int32
    assert torch.equal(gi, pi)
    assert torch.equal(gd, pd)
    assert stats["cell_size"] > 0 and stats_ok(stats), stats


def test_grid_degenerate_inputs_equal_plain():
    """No query rows; fewer than 8 valid reference rows (the brute route)."""
    r = torch.from_numpy(_bone(3))
    d, i = grid_knn.knn_grid(r, r[:0], 3)
    assert d.shape == (0, 3) and i.shape == (0, 3)
    few = r[:5]
    got = grid_knn.knn_grid(few, r[:50], 3)
    want = knn_kernel.knn_plain(few, r[:50], 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert grid_knn.last_stats["fallback_fraction"] == 1.0


@pytest.mark.parametrize("k", [1, 3])
def test_grid_matches_jax_knn_grid(k):
    rng = np.random.default_rng(40 + k)
    ref = _bone(5)
    q = _near(ref, rng, sigma=0.1)
    gd, gi = grid_knn.knn_grid(torch.from_numpy(ref), torch.from_numpy(q), k)
    jd, ji = JG.knn_grid(jnp.asarray(ref), jnp.asarray(q), k)
    gi, ji = gi.numpy(), np.asarray(ji)
    same_set = (np.sort(gi, axis=1) == np.sort(ji, axis=1)).all(axis=1).mean()
    same_idx = (gi == ji).all(axis=1).mean()
    assert same_set >= 0.999 and same_idx >= 0.999, (same_set, same_idx)
    np.testing.assert_allclose(gd.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


# --- The route decision and the planner ---

def _meta(nq, nr, d=3):
    """Shapes only (``_grid_decision`` reads shapes and the device type)."""
    return (torch.empty((nr, d), device="meta"), torch.empty((nq, d), device="meta"))


@pytest.fixture
def dials(monkeypatch):
    for name in ("PYFOCUSR_TPU_KNN_GRID", "PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS",
                 "PYFOCUSR_TPU_KNN_GRID_SURE_PAIRS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env, shape, k, want", [
    ({"PYFOCUSR_TPU_KNN_GRID": "off"}, (10**6, 10**6, 3), 1, "brute"),
    ({"PYFOCUSR_TPU_KNN_GRID": "on"}, (10, 10, 3), 1, "grid"),
    ({"PYFOCUSR_TPU_KNN_GRID": "on"}, (10, 10, 6), 1, "brute"),  # not 3-D
    ({"PYFOCUSR_TPU_KNN_GRID": "on"}, (10, 10, 3), 8, "grid"),  # JAX's largest grid k
    ({"PYFOCUSR_TPU_KNN_GRID": "on"}, (10, 10, 3), 9, "brute"),  # past it (JAX :198)
    ({"PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS": "100", "PYFOCUSR_TPU_KNN_GRID_SURE_PAIRS": "1000"},
     (9, 10, 3), 1, "brute"),
    ({"PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS": "100", "PYFOCUSR_TPU_KNN_GRID_SURE_PAIRS": "1000"},
     (10, 10, 3), 1, "race"),
    ({"PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS": "100", "PYFOCUSR_TPU_KNN_GRID_SURE_PAIRS": "1000"},
     (10, 100, 3), 1, "grid"),
    # k > 1 halves both bounds.
    ({"PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS": "100", "PYFOCUSR_TPU_KNN_GRID_SURE_PAIRS": "1000"},
     (5, 10, 3), 3, "race"),
    ({"PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS": "100", "PYFOCUSR_TPU_KNN_GRID_SURE_PAIRS": "1000"},
     (10, 50, 3), 2, "grid"),
    # MIN alone is a single threshold.
    ({"PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS": "100"}, (10, 10, 3), 1, "grid"),
    ({"PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS": "100"}, (9, 10, 3), 1, "brute"),
])
def test_route_dials(dials, env, shape, k, want):
    for name, value in env.items():
        dials.setenv(name, value)
    nq, nr, d = shape
    assert TK._grid_decision(*_meta(nq, nr, d), k) == want


def test_route_default_bounds_and_cpu_scale(dials):
    """Off the card both bounds take the CPU scale; on it (decided by the
    tensors' device type) they are the measured defaults."""
    lo = TK._GRID_MIN_PAIRS_DEFAULT * TK._CPU_PAIR_SCALE
    hi = TK._GRID_SURE_PAIRS_DEFAULT * TK._CPU_PAIR_SCALE
    assert 0 < lo < hi
    for k, f in ((1, 1.0), (3, 0.5)):
        n_lo = int(np.sqrt(lo * f)) - 1
        n_mid = int(np.sqrt(np.sqrt(lo * hi) * f))
        n_hi = int(np.sqrt(hi * f)) + 1
        assert TK._grid_decision(*_meta(n_lo, n_lo), k) == "brute"
        assert TK._grid_decision(*_meta(n_mid, n_mid), k) == "race"
        assert TK._grid_decision(*_meta(n_hi, n_hi), k) == "grid"

    class Cuda:
        type = "cuda"

    class Ref:
        def __init__(self, n):
            self.shape, self.device = (n, 3), Cuda()

        def dim(self):
            return 2

    n_card = int(np.sqrt(TK._GRID_MIN_PAIRS_DEFAULT)) + 1
    assert TK._grid_decision(Ref(n_card), Ref(n_card), 1) == "race"
    assert TK._grid_decision(Ref(n_card - 2), Ref(n_card - 2), 1) == "brute"


def test_route_capture_guard(dials):
    """While a CUDA stream captures a graph every query takes brute, even
    with the grid forced (it reads masks back to the host)."""
    dials.setenv("PYFOCUSR_TPU_KNN_GRID", "on")
    dials.setattr(torch.cuda, "is_available", lambda: True)
    dials.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert TK._grid_decision(*_meta(10**6, 10**6), 3) == "brute"
    dials.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert TK._grid_decision(*_meta(10**6, 10**6), 3) == "grid"


@pytest.mark.parametrize("nq, nr, k", [(10, 10, 1), (1000, 5000, 3), (655362, 655362, 3),
                                       (2, 10**8, 2), (10**6, 3, 1)])
def test_bucket_key_is_jax_key(nq, nr, k):
    assert knn_routing.bucket_key(nq, nr, k) == JR.bucket_key(nq, nr, k)


def _spy_routes(monkeypatch):
    calls = []
    real_grid, real_knn = TK.knn_grid, knn_kernel.knn

    def grid(*a):
        calls.append("grid")
        return real_grid(*a)

    def brute(*a):
        calls.append("brute")
        return real_knn(*a)

    monkeypatch.setattr(TK, "knn_grid", grid)
    monkeypatch.setattr(knn_kernel, "knn", brute)
    return calls


def test_race_records_and_reuses_its_winner(dials, tmp_path):
    dials.setenv("PYFOCUSR_TPU_CAL_DIR", str(tmp_path))
    dials.setenv("PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS", "1")
    dials.setenv("PYFOCUSR_TPU_KNN_GRID_SURE_PAIRS", "1e30")
    calls = _spy_routes(dials)
    rng = np.random.default_rng(1)
    ref = torch.from_numpy(_bone(3))
    q = torch.from_numpy(_near(ref.numpy(), rng))
    d, i = TK.knn_query(ref, q, 3)
    want = knn_kernel.knn_plain(ref, q, 3)
    assert torch.equal(d, want[0]) and torch.equal(i, want[1].long())
    # One untimed and one timed call of each route; the runners run grid
    # first, and each grid call also asks brute for its d_k sample.
    assert calls.count("grid") == 2 and calls[-2:] == ["brute", "brute"]
    path = knn_routing.cache_file("cpu")
    assert os.path.basename(path) == "knn_routing_cpu.json"
    rec = json.load(open(path))
    bucket = knn_routing.bucket_key(q.shape[0], ref.shape[0], 3)
    winner = rec[bucket]["winner"]
    assert winner in ("grid", "brute") and set(rec[bucket]["times_s"]) == {"grid", "brute"}
    once = ["grid", "brute"] if winner == "grid" else ["brute"]
    calls.clear()
    d2, i2 = TK.knn_query(ref, q, 3)
    assert calls == once
    assert torch.equal(d2, d) and torch.equal(i2, i)
    # A fresh process reads the winner from the file.
    knn_routing._MEM.clear()
    calls.clear()
    TK.knn_query(ref, q, 3)
    assert calls == once


def test_store_merges_with_the_file(tmp_path):
    path = str(tmp_path / "knn_routing_x.json")
    json.dump({"k0_p10_m5": {"winner": "brute"}}, open(path, "w"))
    knn_routing._store(path, {"k1_p20_m10": {"winner": "grid"}})
    assert json.load(open(path)) == {"k0_p10_m5": {"winner": "brute"},
                                     "k1_p20_m10": {"winner": "grid"}}
    # Ours win a key raced by both.
    knn_routing._store(path, {"k0_p10_m5": {"winner": "grid"}})
    assert json.load(open(path))["k0_p10_m5"] == {"winner": "grid"}
    knn_routing._MEM.clear()


def test_unwritable_record_races_once_per_process(dials, tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    dials.setenv("PYFOCUSR_TPU_CAL_DIR", str(blocker / "sub"))
    calls = []

    def runner(name):
        def run():
            calls.append(name)
            return torch.zeros(1)
        return run

    runners = {"grid": runner("grid"), "brute": runner("brute")}
    knn_routing.routed("k0_p1_m1", runners, "cpu")
    assert len(calls) == 4 and not os.path.exists(knn_routing.cache_file("cpu"))
    calls.clear()
    knn_routing.routed("k0_p1_m1", runners, "cpu")
    assert len(calls) == 1
    knn_routing._MEM.clear()


# --- The k-NN kernel's query count ---

def test_knn_cuda_rejects_more_queries_than_one_grid_holds():
    src = open(os.path.join(os.path.dirname(chip_smoke.__file__),
                            "pyfocusr_tpu_torch", "csrc", "knn.cu")).read()
    const = {m: int(re.search(rf"constexpr int {m} = (\d+)", src).group(1))
             for m in ("kThreads", "kGroup", "kQ")}
    assert knn_kernel.QUERIES_PER_CTA == const["kThreads"] // const["kGroup"] * const["kQ"]
    assert knn_kernel.MAX_QUERIES == knn_kernel.QUERIES_PER_CTA * 65535 == 8388480
    ref = torch.zeros((4, 3))
    over = torch.zeros((1, 3)).expand(knn_kernel.MAX_QUERIES + 1, 3)
    with pytest.raises(ValueError, match="at most 8388480 queries"):
        knn_kernel.knn_cuda(ref, over, 1)
    at = torch.zeros((1, 3)).expand(knn_kernel.MAX_QUERIES, 3)
    with pytest.raises(ValueError, match="CUDA device"):  # past the count check
        knn_kernel.knn_cuda(ref, at, 1)
