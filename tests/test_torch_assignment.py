"""Port parity for the 'hungarian' solver: ``pyfocusr_tpu_torch``'s Sinkhorn
dual updates, bulk matching, Jonker-Volgenant augmentation and
``sinkhorn_jv_lap`` against the JAX package on the same numpy inputs — the
Pallas kernels in interpret mode (as tests/test_pallas_kernels.py runs
them) and the XLA versions in ``pyfocusr_tpu/ops/assignment.py``.

The port runs on CPU tensors here, so its wrappers take the kernels' plain
versions.  Tolerances:

* Sinkhorn duals: atol 2e-4 on a geometric cost of spread ~5, the bound
  tests/test_pallas_kernels.py:114 holds the Pallas kernel to against XLA
  (the streamed form multiplies by 1/T where the XLA form divides by T);
* bulk matching: indices equal, u0 to 1e-6;
* Jonker-Volgenant: there are only f32 additions, subtractions and
  comparisons, in one order, so ``col4row`` and the step count are equal;
* ``sinkhorn_jv_lap``: the same assignment as the JAX function, and scipy's
  objective within 1e-5 relative (tests/test_kernels.py:194).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist

from pyfocusr_tpu.ops import assignment as JA
from pyfocusr_tpu.ops import pallas_kernels as PK
from pyfocusr_tpu.spectral.eigsort_jax import sort_eigenmaps_jit
from pyfocusr_tpu_torch.ops import assignment as TA
from pyfocusr_tpu_torch.ops import jv_kernel
from pyfocusr_tpu_torch.ops import sinkhorn_kernel as SK
from pyfocusr_tpu_torch.spectral.eigsort_device import sort_eigenmaps

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

T_FACTOR = 1.0 / 3.0


def _geometric_cost(n, seed, noise):
    """Distances between a cloud and a noisy copy of it (contested: every
    point has a near-equal partner)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3))
    b = a + noise * rng.normal(size=a.shape)
    return cdist(a, b).astype(np.float32)


def _random_cost(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, n)).astype(np.float32)


def _int_cost(n, seed):
    """Integers 0-9: most comparisons in a search are ties."""
    return np.random.default_rng(seed).integers(0, 10, (n, n)).astype(np.float32)


@pytest.fixture(scope="module")
def geo300():
    C = _geometric_cost(300, 0, 0.02)
    return C, float(C.max() - C.min())


def _objective(C, col):
    return C[np.arange(C.shape[0]), col].astype(np.float64).sum()


def _scipy_objective(C):
    ri, ci = linear_sum_assignment(C.astype(np.float64))
    return C[ri, ci].astype(np.float64).sum()


# ---------------------------------------------------------------- Sinkhorn


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("level", [0, 5, 13])
def test_lse_rows_plain_matches_pallas(geo300, transpose, level):
    """One dual update against ``_lse_rows_pallas`` (interpret mode), along
    the rows and down the columns, at a high, a middle and the lowest
    temperature of the 14-level schedule."""
    C, spread = geo300
    n, n_pad, tile_r = 300, 384, 128
    rng = np.random.default_rng(level)
    vec = (0.05 * rng.normal(size=n)).astype(np.float32)
    inv_t = float(np.float32(1.0) / np.float32(spread / 4.0 * T_FACTOR**level))
    # The TPU kernel's padding: 1e30 costs, -1e30 duals, transpose made here.
    Cp = np.pad(C, ((0, n_pad - n), (0, n_pad - n)), constant_values=1e30)
    vp = np.pad(vec, (0, n_pad - n), constant_values=-1e30)
    want = PK._lse_rows_pallas(jnp.asarray(Cp.T if transpose else Cp),
                               jnp.asarray(vp), inv_t, tile_r, interpret=True)
    got = SK.lse_rows(torch.tensor(C), torch.tensor(vec), inv_t, transpose)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n], atol=2e-4)
    assert got.dtype == torch.float32 and got.shape == (n,)


@pytest.mark.parametrize("reference", ["pallas_streamed", "xla"])
def test_sinkhorn_loop_matches_jax(geo300, reference):
    """6 levels x 5 iterations of the annealing loop against
    ``sinkhorn_duals_streamed`` (interpret mode) and ``_sinkhorn_duals``."""
    C, spread = geo300
    f, g = SK.sinkhorn_duals_streamed(torch.tensor(C), spread / 4.0, T_FACTOR, 6, 5)
    if reference == "xla":
        jf, jg = JA._sinkhorn_duals(jnp.asarray(C), spread / 4.0, T_FACTOR, 6, 5)
    else:
        jf, jg = PK.sinkhorn_duals_streamed(
            jnp.asarray(C), jnp.float32(spread / 4.0), T_FACTOR, 6, 5,
            tile_r=128, interpret=True)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=2e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-4)


def test_sinkhorn_duals_plain_loop_matches_jax(geo300):
    """The logsumexp form of the loop (the independent reference of the
    streamed form) against the JAX function it mirrors and against the
    streamed form that ``sinkhorn_jv_lap`` runs."""
    C, spread = geo300
    f, g = TA._sinkhorn_duals(torch.tensor(C), spread / 4.0, T_FACTOR, 6, 5)
    jf, jg = JA._sinkhorn_duals(jnp.asarray(C), spread / 4.0, T_FACTOR, 6, 5)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=2e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-4)
    sf, sg = SK.sinkhorn_duals_streamed(torch.tensor(C), spread / 4.0, T_FACTOR, 6, 5)
    np.testing.assert_allclose(f.numpy(), sf.numpy(), atol=2e-4)
    np.testing.assert_allclose(g.numpy(), sg.numpy(), atol=2e-4)


def test_sinkhorn_init_resumes_a_schedule(geo300):
    """4 levels then a 2-level resume from ``init`` reproduce the 6-level
    run to f32 roundoff (atol 1e-6, tests/test_pallas_kernels.py:143), and
    match the JAX resume."""
    C, spread = geo300
    Ct = torch.tensor(C)
    f6, g6 = SK.sinkhorn_duals_streamed(Ct, spread / 4.0, T_FACTOR, 6, 5)
    fa, ga = SK.sinkhorn_duals_streamed(Ct, spread / 4.0, T_FACTOR, 4, 5)
    fb, gb = SK.sinkhorn_duals_streamed(
        Ct, spread / 4.0 / 3.0**4, T_FACTOR, 2, 5, init=(fa, ga))
    np.testing.assert_allclose(f6.numpy(), fb.numpy(), atol=1e-6)
    np.testing.assert_allclose(g6.numpy(), gb.numpy(), atol=1e-6)
    jf, jg = PK.sinkhorn_duals_streamed(
        jnp.asarray(C), jnp.float32(spread / 4.0 / 3.0**4), T_FACTOR, 2, 5,
        tile_r=128, interpret=True,
        init=(jnp.asarray(fa.numpy()), jnp.asarray(ga.numpy())))
    np.testing.assert_allclose(fb.numpy(), np.asarray(jf), atol=2e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jg), atol=2e-4)


def test_sinkhorn_levels_zero_returns_initial_duals(geo300):
    C, spread = geo300
    f0, g0 = SK.sinkhorn_duals_streamed(torch.tensor(C), spread / 4.0, T_FACTOR, 0, 5)
    assert f0.shape == (300,) and not f0.any() and not g0.any()
    init = (torch.arange(300.0), -torch.arange(300.0))
    f1, g1 = SK.sinkhorn_duals_streamed(torch.tensor(C), spread / 4.0, T_FACTOR,
                                        0, 5, init=init)
    assert torch.equal(f1, init[0]) and torch.equal(g1, init[1])


def test_sinkhorn_wrapper_contract():
    C = torch.zeros((4, 4))
    v = torch.zeros(4)
    before = SK.LAUNCHES
    got = SK.lse_rows(C, v, 2.0)
    assert SK.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert torch.equal(got, SK.lse_rows_plain(C, v, 2.0))
    with pytest.raises(ValueError, match="CUDA"):
        SK.lse_rows_cuda(C, v, 2.0)
    with pytest.raises(TypeError, match="float32"):
        SK.lse_rows(C.double(), v.double(), 2.0)
    with pytest.raises(ValueError, match="reduced axis"):
        SK.lse_rows(torch.zeros((4, 5)), v, 2.0)
    SK.lse_rows(torch.zeros((4, 5)), v, 2.0, transpose=True)
    with pytest.raises(ValueError, match="square"):
        SK.sinkhorn_duals_streamed(torch.zeros((4, 5)), 1.0, T_FACTOR, 1, 1)
    assert SK._col_row_chunks(10242, 10242) * -(-10242 // 32) >= 132 * 8
    assert SK._col_row_chunks(10, 10) == 1


# ------------------------------------------------- bulk match and JV solver


def _warm_v0(C, levels=4, iters=5):
    spread = float(C.max() - C.min())
    _, g = SK.sinkhorn_duals_streamed(torch.tensor(C), spread / 4.0, T_FACTOR,
                                      levels, iters)
    return g.numpy()


JV_CASES = {
    # name: (cost, v0); tests/test_pallas_kernels.py:173,197 for the first two
    "random96_cold": lambda: (_random_cost(96, 0), np.zeros(96, np.float32)),
    "geometric64_warm": lambda: (
        _geometric_cost(64, 3, 0.3),
        (np.random.default_rng(3).normal(size=64) * 0.01).astype(np.float32)),
    "contested300_cold": lambda: (_geometric_cost(300, 1, 0.3),
                                  np.zeros(300, np.float32)),
    "contested300_sinkhorn": lambda: (
        _geometric_cost(300, 1, 0.3), _warm_v0(_geometric_cost(300, 1, 0.3))),
    # Ties everywhere, also between the column ranges of a cluster's CTAs.
    "tie_heavy_int": lambda: (_int_cost(200, 0), np.zeros(200, np.float32)),
}
# Step budget per column: the path's 60, except that the tie-heavy cost
# scans ~n columns per free row (19 293 steps at n = 200).
JV_BUDGET_PER_N = {"tie_heavy_int": 200}


@pytest.fixture(scope="module", params=sorted(JV_CASES))
def jv_case(request):
    C, v0 = JV_CASES[request.param]()
    budget = JV_BUDGET_PER_N.get(request.param, 60) * C.shape[0]
    return C, v0, TA._bulk_match(torch.tensor(C), torch.tensor(v0)), budget


def test_bulk_match_matches_jax(jv_case):
    C, v0, (u0, r4c, c4r), _ = jv_case
    ju0, jr4c, jc4r = JA._bulk_match(jnp.asarray(C), jnp.asarray(v0))
    np.testing.assert_array_equal(r4c.numpy(), np.asarray(jr4c))
    np.testing.assert_array_equal(c4r.numpy(), np.asarray(jc4r))
    np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), atol=1e-6)
    assert r4c.dtype == torch.int32 and c4r.dtype == torch.int32
    # Feasible duals, tight edges on the matched pairs.
    red = torch.tensor(C) - u0[:, None] - torch.tensor(v0)[None, :]
    assert float(red.min()) >= -1e-6


def test_jv_plain_matches_pallas_and_xla(jv_case):
    C, v0, (u0, r4c, c4r), budget = jv_case
    n = C.shape[0]
    assert int((c4r < 0).sum()) > 0  # the case leaves rows to augment
    col, steps, u, v = jv_kernel.jv_device(
        torch.tensor(C), u0, torch.tensor(v0), r4c, c4r, budget)
    assert int(steps) < budget
    pcol, psteps = PK.jv_device_pallas(
        jnp.asarray(C), jnp.asarray(u0.numpy()), jnp.asarray(v0),
        jnp.asarray(r4c.numpy()), jnp.asarray(c4r.numpy()), budget, n,
        interpret=True)
    np.testing.assert_array_equal(col.numpy(), np.asarray(pcol))
    assert int(steps) == int(psteps) > 0
    xcol, xsteps = JA._jv_device(jnp.asarray(C), jnp.asarray(v0), budget)
    np.testing.assert_array_equal(col.numpy(), np.asarray(xcol))
    assert int(steps) == int(xsteps)
    assert col.dtype == torch.int32 and steps.dtype == torch.int32
    assert sorted(col.tolist()) == list(range(n))
    obj, ref = _objective(C, col.numpy()), _scipy_objective(C)
    assert abs(obj - ref) < 1e-5 * max(ref, 1.0), (obj, ref)


def test_jv_final_duals_certify_the_optimum(jv_case):
    """The duals the port's JV returns: reduced costs >= 0 everywhere, 0 on
    the assignment, and sum(u) + sum(v) equal to the objective."""
    C, v0, (u0, r4c, c4r), budget = jv_case
    n = C.shape[0]
    col, _, u, v = jv_kernel.jv_device(
        torch.tensor(C), u0, torch.tensor(v0), r4c, c4r, budget)
    red = torch.tensor(C).double() - u.double()[:, None] - v.double()[None, :]
    tol = 1e-5 * float(C.max())
    assert float(red.min()) >= -tol
    assert float(red[torch.arange(n), col.long()].abs().max()) <= tol
    dual = float(u.double().sum() + v.double().sum())
    assert dual == pytest.approx(_objective(C, col.numpy()), rel=1e-5)


@pytest.mark.parametrize("budget", [0, 7, 40])
def test_jv_budget_exhaustion_and_greedy_complete(budget):
    """An exhausted step budget leaves rows at -1, the same rows and the
    same step count as both JAX versions; ``_greedy_complete`` then returns
    the permutation JAX's returns."""
    C = _random_cost(96, 0)
    v0 = np.zeros(96, np.float32)
    u0, r4c, c4r = TA._bulk_match(torch.tensor(C), torch.tensor(v0))
    col, steps, _, _ = jv_kernel.jv_device(
        torch.tensor(C), u0, torch.tensor(v0), r4c, c4r, budget)
    xcol, xsteps = JA._jv_device(jnp.asarray(C), jnp.asarray(v0), budget)
    np.testing.assert_array_equal(col.numpy(), np.asarray(xcol))
    assert int(steps) == int(xsteps) == budget
    assert int((col < 0).sum()) > 0
    if budget:  # jv_device_pallas's row kernel needs a budget >= 1
        pcol, psteps = PK.jv_device_pallas(
            jnp.asarray(C), jnp.asarray(u0.numpy()), jnp.asarray(v0),
            jnp.asarray(r4c.numpy()), jnp.asarray(c4r.numpy()), budget, 96,
            interpret=True)
        np.testing.assert_array_equal(col.numpy(), np.asarray(pcol))
        assert int(psteps) == budget
    done = TA._greedy_complete(col.long(), 96)
    want = JA._greedy_complete(jnp.asarray(xcol), 96)
    np.testing.assert_array_equal(done.numpy(), np.asarray(want))
    assert sorted(done.tolist()) == list(range(96))


def test_greedy_complete_matches_jax_on_handmade_cases():
    for a in ([2, -1, 0, -1, -1], [-1, -1, -1], [1, 0, 2], [-1, 3, -1, 0]):
        got = TA._greedy_complete(torch.tensor(a), len(a))
        want = JA._greedy_complete(jnp.asarray(a, jnp.int32), len(a))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert sorted(got.tolist()) == list(range(len(a)))


def test_jv_wrapper_contract():
    C = torch.rand((6, 6))
    z = torch.zeros(6)
    u0, r4c, c4r = TA._bulk_match(C, z)
    before = jv_kernel.LAUNCHES
    got = jv_kernel.jv_device(C, u0, z, r4c, c4r, 360)
    want = jv_kernel.jv_device_plain(C, u0, z, r4c, c4r, 360)
    assert jv_kernel.LAUNCHES == before  # CPU tensors: the plain version
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="CUDA"):
        jv_kernel.jv_device_cuda(C, u0, z, r4c, c4r, 360)
    with pytest.raises(TypeError, match="int32"):
        jv_kernel.jv_device(C, u0, z, r4c.long(), c4r, 360)
    with pytest.raises(ValueError, match="square"):
        jv_kernel.jv_device(torch.rand((6, 7)), u0, z, r4c, c4r, 360)
    with pytest.raises(ValueError, match="shape"):
        jv_kernel.jv_device(C, u0[:5], z, r4c, c4r, 360)
    # 17 bytes of search state a column, ceil(n / CLUSTER_SIZE) columns a
    # CTA, must fit one block's 227 KB of shared memory beside the slots.
    slots = 2 * jv_kernel.CLUSTER_SIZE * (jv_kernel.THREADS_PER_CTA // 32) * 16
    assert jv_kernel.smem_per_cta_bytes(jv_kernel.MAX_N, slots) <= 232448


def test_jv_kernel_source_agrees_with_wrapper():
    """The cluster size, threads per CTA and largest n that csrc/jv.cu is
    built with are the wrapper's, and n = 40962 (the next subdivision of the
    10242-vertex meshes) is within the limit."""
    src = (Path(jv_kernel.__file__).parent.parent / "csrc" / "jv.cu").read_text()

    def const(pattern):
        return int(re.search(pattern, src).group(1))

    cluster = const(r"constexpr int kClusterSize = (\d+);")
    threads = const(r"constexpr int kThreads = (\d+);")
    cols = const(r"constexpr int kMaxColsPerCta = (\d+);")
    assert re.search(r"constexpr int kMaxN = kClusterSize \* kMaxColsPerCta;", src)
    assert cluster == jv_kernel.CLUSTER_SIZE >= 8
    assert threads == jv_kernel.THREADS_PER_CTA
    assert cluster * cols == jv_kernel.MAX_N >= 40962
    slots = 2 * cluster * (threads // 32) * 16
    assert 17 * cols + slots <= 232448


# ------------------------------------------------------ sinkhorn_jv_lap


LAP_CASES = {
    # tests/test_kernels.py:175-194
    "random30": lambda: _random_cost(30, 30),
    "random120": lambda: _random_cost(120, 120),
    "random400": lambda: _random_cost(400, 400),
    "contested300": lambda: _geometric_cost(300, 0, 0.005),
}


@pytest.mark.parametrize("case", sorted(LAP_CASES))
def test_sinkhorn_jv_lap_matches_scipy_and_jax(case):
    C = LAP_CASES[case]()
    n = C.shape[0]
    got = TA.sinkhorn_jv_lap(torch.tensor(C))
    assert got.dtype == torch.int64
    got = got.numpy()
    assert len(np.unique(got)) == n
    obj, ref = _objective(C, got), _scipy_objective(C)
    assert abs(obj - ref) <= 1e-5 * ref + 1e-6, (n, obj, ref)
    np.testing.assert_array_equal(got, np.asarray(JA.sinkhorn_jv_lap(jnp.asarray(C))))


@pytest.fixture(scope="module")
def lap600():
    """n = 600 >= 512 takes the Sinkhorn warm start: the full 14 x 30
    schedule, run once for the tests below."""
    C = _random_cost(600, 5)
    warm = TA.sinkhorn_jv_lap(torch.tensor(C), warm_start=True, return_duals=True)
    cold = TA.sinkhorn_jv_lap(torch.tensor(C), warm_start=False, return_duals=True)
    return C, warm, cold


def test_sinkhorn_jv_lap_warm_matches_cold_and_scipy(lap600):
    C, (warm, *_), (cold, *_) = lap600
    assert sorted(warm.tolist()) == list(range(600))
    obj_w, obj_c = _objective(C, warm.numpy()), _objective(C, cold.numpy())
    ref = _scipy_objective(C)
    assert abs(obj_w - ref) <= 1e-5 * ref and abs(obj_c - ref) <= 1e-5 * ref
    np.testing.assert_array_equal(warm.numpy(), cold.numpy())


def test_sinkhorn_jv_lap_warm_start_matches_jax(lap600):
    C, (warm, _, _, steps_w), (_, _, _, steps_c) = lap600
    want = np.asarray(JA.sinkhorn_jv_lap(jnp.asarray(C)))
    np.testing.assert_array_equal(warm.numpy(), want)
    # The warm start is there to shorten the augmentation.
    assert 0 < int(steps_w) < int(steps_c) < 60 * 600


def test_sinkhorn_jv_lap_short_schedule_matches_jax():
    """A geometric cost above the warm-start threshold with a short
    schedule (4 levels x 5 iterations): rough duals, a long augmentation,
    the same optimum as JAX and scipy."""
    C = _geometric_cost(520, 7, 0.1)
    got = TA.sinkhorn_jv_lap(torch.tensor(C), levels=4, iters_per_level=5).numpy()
    want = np.asarray(JA.sinkhorn_jv_lap(jnp.asarray(C), levels=4, iters_per_level=5))
    np.testing.assert_array_equal(got, want)
    ref = _scipy_objective(C)
    assert abs(_objective(C, got) - ref) <= 1e-5 * ref


def test_sinkhorn_jv_lap_dual_certificate(lap600):
    C, (warm, u, v, steps), _ = lap600
    assert int(steps) < 60 * 600  # budget not hit: the duals certify
    red = torch.tensor(C).double() - u.double()[:, None] - v.double()[None, :]
    assert float(red.min()) >= -1e-5
    dual = float(u.double().sum() + v.double().sum())
    assert dual == pytest.approx(_objective(C, warm.numpy()), rel=1e-5)


def test_sinkhorn_jv_lap_budget_exhaustion_still_a_permutation():
    C = _random_cost(96, 0)
    got = TA.sinkhorn_jv_lap(torch.tensor(C), max_total_steps=10)
    want = JA.sinkhorn_jv_lap(jnp.asarray(C), max_total_steps=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sorted(got.tolist()) == list(range(96))


def test_sinkhorn_jv_lap_rejects_rectangular():
    with pytest.raises(ValueError, match="square"):
        TA.sinkhorn_jv_lap(torch.zeros((4, 6)))
    with pytest.raises(ValueError, match="square"):
        JA.sinkhorn_jv_lap(jnp.zeros((4, 6)))


# ------------------------------------------------------ the auction


@pytest.mark.parametrize("n", [1, 2, 64, 200])
def test_auction_lap_matches_jax(n):
    """The port's rounds are JAX's (top 2, scatter-max, lowest row on
    ties, price bump, eviction, 7 epsilon phases): the same assignment on
    a random cost, a permutation within the auction's bound of the
    optimum (n times the last epsilon, spread / 4 n)."""
    c = _random_cost(n, n)
    want = np.asarray(JA.auction_lap(jnp.asarray(c)))
    got = TA.auction_lap(torch.from_numpy(c))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(n))
    r, col = linear_sum_assignment(c)
    gap = c[np.arange(n), got.numpy()].sum() - c[r, col].sum()
    assert gap <= np.ptp(c) / 4 + 1e-5
    if n > 1:
        stats = TA.AUCTION_STATS
        assert len(stats) == 7 and all(s["iterations"] >= 1 for s in stats)
        assert all(s["host_reads"] <= -(-s["iterations"] // TA.AUCTION_BLOCK) + 1
                   for s in stats)


def test_auction_one_by_one_and_round_cap():
    assert TA.auction_lap(torch.tensor([[3.0]])).tolist() == [0]
    assert np.asarray(JA.auction_lap(jnp.asarray([[3.0]]))).tolist() == [0]
    # A round cap that stops every phase early: the rows left are paired
    # with the free columns, in both packages.
    c = _random_cost(64, 5)
    want = np.asarray(JA.auction_lap(jnp.asarray(c), max_rounds=3))
    got = TA.auction_lap(torch.from_numpy(c), max_rounds=3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(64))


def test_sinkhorn_auction_lap_forwards_to_jv_and_refuses_auction_keywords():
    c = _random_cost(40, 7)
    want = TA.sinkhorn_jv_lap(torch.from_numpy(c), warm_start=False)
    got = TA.sinkhorn_auction_lap(torch.from_numpy(c), warm_start=False)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JA.sinkhorn_auction_lap(jnp.asarray(c), warm_start=False)))
    messages = []
    for mod, arr in ((TA, torch.from_numpy(c)), (JA, jnp.asarray(c))):
        with pytest.raises(TypeError) as err:
            mod.sinkhorn_auction_lap(arr, eps_scaling_steps=3, max_rounds=10)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "eps_scaling_steps" in messages[0]


# ------------------------------------------------------ eigsort, k > 8


@pytest.mark.parametrize("target_as_reference", [True, False])
def test_eigsort_ten_modes_matches_jax(target_as_reference):
    """k = 10 modes take the JV solver (k <= 8 enumerates): a source map
    that is the target's with columns permuted and some flipped must come
    back in the target's order, as from ``sort_eigenmaps_jit``."""
    rng = np.random.default_rng(11)
    n, k = 400, 10
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    freqs = rng.uniform(0.5, 3.0, size=(3, k))
    base = np.sin(pts @ freqs + rng.uniform(0, 6, size=k))
    base = (base - base.min(0)) / (base.max(0) - base.min(0)) - 0.5
    perm = rng.permutation(k)
    sign = np.where(rng.uniform(size=k) < 0.4, -1.0, 1.0)
    vt = base.astype(np.float32)
    vs = (base[:, perm] * sign[None, :]).astype(np.float32)
    vs = vs + (0.01 * rng.normal(size=vs.shape)).astype(np.float32)
    lt = np.linspace(0.1, 1.0, k).astype(np.float32)
    ls = lt[perm]
    if not target_as_reference:  # the target's maps are the permuted side
        vt, vs, lt, ls = vs, vt, ls, lt
    to_permute = vs if target_as_reference else vt
    args = (lt, ls, vt, vs, pts, pts + np.float32(1e-3), to_permute)
    got_v, got_q = sort_eigenmaps(*(torch.tensor(a) for a in args),
                                  target_as_reference=target_as_reference)
    want_v, want_q = sort_eigenmaps_jit(*(jnp.asarray(a) for a in args),
                                        target_as_reference=target_as_reference)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-3,
                               atol=1e-9)
    # The permutation and the flips were undone.
    np.testing.assert_allclose(got_v.numpy(), base, atol=0.1)


# ------------------------------------------------------ on the card


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """Runs on a CUDA card only: both kernels against their plain versions.
    The lse kernel merges (max, sum) pairs online, so it is held to 1e-5 of
    the cost's spread; the JV kernel is held to equality."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = torch.tensor(_geometric_cost(300, 1, 0.3)).cuda()
    spread = float(C.max() - C.min())
    vec = torch.tensor(_warm_v0(C.cpu().numpy())).cuda()
    for transpose in (False, True):
        for level in (0, 13):
            inv_t = 1.0 / (spread / 4.0 * T_FACTOR**level)
            before = SK.LAUNCHES
            k = SK.lse_rows(C, vec, inv_t, transpose)
            assert SK.LAUNCHES == before + 1
            p = SK.lse_rows_plain(C, vec, inv_t, transpose)
            assert float((k - p).abs().max()) <= 1e-5 * spread
    # (cost, v0, budget): warm and cold on the contested cost; tie-heavy
    # integer costs at n = 1, 10, 17 (the cluster's CTAs own ceil(n / 16)
    # columns each, so some own none) and 200; and a budget that runs out
    # partway through a search.
    cases = [(C, vec, 60 * 300), (C, torch.zeros_like(vec), 60 * 300)]
    for n in (1, 10, 17, 200):
        cases.append((torch.tensor(_int_cost(n, n)).cuda(),
                      torch.zeros(n, device="cuda"), 200 * n))
    cases.append((C, torch.zeros_like(vec), 1000))
    for cost, v0, budget in cases:
        u0, r4c, c4r = TA._bulk_match(cost, v0)
        before = jv_kernel.LAUNCHES
        got = jv_kernel.jv_device(cost, u0, v0, r4c, c4r, budget)
        assert jv_kernel.LAUNCHES == before + 1
        want = jv_kernel.jv_device_plain(cost.cpu(), u0.cpu(), v0.cpu(), r4c.cpu(),
                                         c4r.cpu(), budget)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert int(got[1]) == 1000 and int((got[0] < 0).sum()) > 0
