"""Port parity: the k-NN kernel's plain version and the brute-force query
functions of ``pyfocusr_tpu_torch`` against the JAX package — the Pallas
kernel in interpret mode (as tests/test_pallas_kernels.py runs it) and the
XLA path ``_knn_query_impl``.

Tolerances: against the Pallas kernel both sides compute the same direct
f32 differences in the same order, so indices must be equal and distances
agree within rtol 1e-6.  The XLA path uses the |q|^2 + |r|^2 - 2 q.r
identity, whose f32 cancellation error is ~eps * |q|^2 on the squared
distance; on these unit-scale inputs that bounds the distance difference at
atol 1e-4 (the bound tests/test_pallas_kernels.py uses for the same pair),
and indices must still be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfocusr_tpu.ops import knn as jknn
from pyfocusr_tpu.ops.pallas_kernels import knn_pallas
from pyfocusr_tpu_torch.ops import knn as tknn
from pyfocusr_tpu_torch.ops import knn_kernel

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

SENTINEL = 1e30


def _pallas(ref, query, k, block_q=64, block_r=256):
    d, i = knn_pallas(jnp.asarray(ref), jnp.asarray(query), k,
                      block_q=block_q, block_r=block_r, interpret=True)
    return np.asarray(d), np.asarray(i)


def _plain(ref, query, k):
    d, i = knn_kernel.knn_plain(torch.as_tensor(ref), torch.as_tensor(query), k)
    return d.numpy(), i.numpy()


def _assert_same(got, want, rtol=1e-6, atol=0.0):
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "nq,nr,d,k,bq,br",
    [
        (300, 500, 3, 1, 64, 256),
        (300, 500, 3, 2, 64, 256),
        (300, 500, 3, 3, 64, 256),
        (77, 2049, 12, 3, 64, 256),  # unaligned sizes, D padded 12 -> 16
        (8, 9, 2, 3, 8, 256),  # tiny reference
        (200, 700, 16, 1, 64, 256),  # widest D the kernel takes
        # k = 4..16 of csrc/knn_topk.cu's 4..128 (k = 128: next test)
        (300, 500, 3, 4, 64, 256),
        (300, 500, 3, 5, 64, 256),
        (77, 2049, 12, 8, 64, 256),
        (200, 700, 16, 16, 64, 256),
    ],
)
def test_plain_matches_pallas(nq, nr, d, k, bq, br):
    rng = np.random.default_rng(nq + nr + d + k)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    r = rng.normal(size=(nr, d)).astype(np.float32)
    _assert_same(_plain(r, q, k), _pallas(r, q, k, bq, br))


def test_plain_k128_matches_xla():
    """k = 128, the top of the Pallas kernel's range.  ``knn_pallas`` in
    interpret mode cannot be traced there in a test's time (its merge is an
    odd-even transposition network of 2k(2k - 1)/2 = 32640 unrolled
    compare-swaps; k = 16 takes 9 s, k = 128 ran past 10 minutes), so the
    plain version is held to JAX's XLA path instead: the identity's
    distances within atol 1e-4 (module docstring), the indices equal but
    for near ties."""
    rng = np.random.default_rng(128)
    q = rng.normal(size=(100, 3)).astype(np.float32)
    r = rng.normal(size=(600, 3)).astype(np.float32)
    got = _plain(r, q, 128)
    d, i = jknn._knn_query_impl(jnp.asarray(r), jnp.asarray(q), 128, tile=256)
    want = (np.asarray(d), np.asarray(i))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    _assert_same_up_to_near_ties(got, want, rtol=1e-4)


def test_plain_tie_break_lower_index_first():
    rng = np.random.default_rng(1)
    r = np.repeat(rng.normal(size=(50, 3)), 2, axis=0).astype(np.float32)
    q = r[::2].copy()
    got = _plain(r, q, 2)
    _assert_same(got, _pallas(r, q, 2, 8, 256))
    np.testing.assert_array_equal(got[1][:, 0], np.arange(0, 100, 2))
    np.testing.assert_array_equal(got[1][:, 1], np.arange(1, 100, 2))


def test_plain_nonfinite_ref_rows_never_win():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(40, 3)).astype(np.float32)
    r[7] = np.nan
    r[11, 1] = np.inf
    q = r[[3, 20, 33]] + 1e-4
    got = _plain(r, q, 3)
    _assert_same(got, _pallas(r, q, 3))
    np.testing.assert_array_equal(got[1][:, 0], [3, 20, 33])
    assert not np.isin(got[1], [7, 11]).any()


def test_plain_missing_neighbor_sentinel():
    r = np.asarray([[0, 0, 0], [1, 0, 0], [SENTINEL] * 3, [SENTINEL] * 3],
                   np.float32)
    q = np.zeros((1, 3), np.float32)
    got = _plain(r, q, 3)
    _assert_same(got, _pallas(r, q, 3))
    np.testing.assert_array_equal(got[1][0], [0, 1, 4])
    assert np.isinf(got[0][0, 2])


def test_plain_fewer_refs_than_k_matches_xla():
    # knn_pallas refuses nr < k; the XLA path defines it: (inf, nr).
    rng = np.random.default_rng(3)
    r = rng.normal(size=(2, 3)).astype(np.float32)
    q = rng.normal(size=(5, 3)).astype(np.float32)
    got = _plain(r, q, 3)
    d, i = jknn._knn_query_impl(jnp.asarray(r), jnp.asarray(q), 3, tile=256)
    _assert_same(got, (np.asarray(d), np.asarray(i)), rtol=0, atol=1e-4)
    assert np.all(got[1][:, 2] == 2) and np.all(np.isinf(got[0][:, 2]))


@pytest.mark.parametrize("k", [1, 3])
def test_knn_query_matches_xla(k):
    rng = np.random.default_rng(10 + k)
    r = rng.normal(size=(1500, 3)).astype(np.float32)
    q = rng.normal(size=(900, 3)).astype(np.float32)
    d, i = tknn.knn_query(torch.as_tensor(r), torch.as_tensor(q), k)
    assert i.dtype == torch.int64
    jd, ji = jknn._knn_query_impl(jnp.asarray(r), jnp.asarray(q), k, tile=512)
    _assert_same((d.numpy(), i.numpy()), (np.asarray(jd), np.asarray(ji)),
                 rtol=0, atol=1e-4)
    _assert_same((d.numpy(), i.numpy()), _pallas(r, q, k))


def _assert_same_up_to_near_ties(got, want, rtol=1e-5):
    """Distances within rtol; indices equal, except where a slot's distance
    in ``want`` ties (rtol 1e-6) its neighbour slot's: there the two
    matmuls' rounding may order the pair either way."""
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=rtol)
    for row, slot in np.argwhere(gi != wi):
        near = [abs(wd[row, s] - wd[row, slot]) <= 1e-6 * wd[row, slot]
                for s in (slot - 1, slot + 1) if 0 <= s < wd.shape[1]]
        assert any(near), (row, slot, gd[row], wd[row])
    assert (gi != wi).mean() <= 1e-3


@pytest.mark.parametrize("d", [17, 20])
@pytest.mark.parametrize("k", [1, 5, 130])
def test_tiled_route_matches_xla(d, k):
    """D > 16 (and k > 128) take the port of JAX's XLA path on either
    device, as JAX's ``_use_pallas`` routes them; ``knn_query`` against
    ``_knn_query_impl`` / ``_nn_query_impl`` on the same inputs.  Both use
    the matmul identity in full f32 with tiles of different widths, so the
    distances agree within rtol 1e-5 (measured 1.4e-6 absolute on these
    unit-scale clouds) and the indices are equal but for near ties (one
    swapped pair of slots at k = 130, 1.2e-7 apart)."""
    rng = np.random.default_rng(100 * d + k)
    r = rng.normal(size=(700, d)).astype(np.float32)
    q = rng.normal(size=(300, d)).astype(np.float32)
    before = knn_kernel.LAUNCHES
    gd, gi = tknn.knn_query(torch.as_tensor(r), torch.as_tensor(q), k)
    assert gi.dtype == torch.int64 and tuple(gi.shape) == (300, k)
    if k == 1:
        jd, ji = jknn._nn_query_impl(jnp.asarray(r), jnp.asarray(q), tile=256)
        want = (np.asarray(jd)[:, None], np.asarray(ji)[:, None])
        td, ti = tknn.nn_tiled(torch.as_tensor(r), torch.as_tensor(q), tile=128)
        np.testing.assert_array_equal(ti.numpy(), gi.numpy()[:, 0])
    else:
        jd, ji = jknn._knn_query_impl(jnp.asarray(r), jnp.asarray(q), k, tile=256)
        want = (np.asarray(jd), np.asarray(ji))
        td, ti = tknn.knn_tiled(torch.as_tensor(r), torch.as_tensor(q), k, tile=128)
        np.testing.assert_array_equal(ti.numpy(), gi.numpy())
    _assert_same_up_to_near_ties((gd.numpy(), gi.numpy()), want)
    assert knn_kernel.LAUNCHES == before


def test_tiled_route_missing_neighbours_and_nonfinite_rows():
    """Fewer references than k: JAX's (inf, nr) slots; non-finite and
    SENTINEL reference rows never win."""
    rng = np.random.default_rng(8)
    r = rng.normal(size=(6, 18)).astype(np.float32)
    r[1] = np.nan
    r[4] = SENTINEL
    q = rng.normal(size=(9, 18)).astype(np.float32)
    gd, gi = tknn.knn_query(torch.as_tensor(r), torch.as_tensor(q), 7)
    assert np.isin(gi.numpy()[:, :4], [0, 2, 3, 5]).all()
    assert (gi.numpy()[:, 4:] == 6).all() and np.isinf(gd.numpy()[:, 4:]).all()
    jd, ji = jknn._knn_query_impl(jnp.asarray(np.where(np.isnan(r), SENTINEL, r)),
                                  jnp.asarray(q), 7, tile=256)
    _assert_same_up_to_near_ties((gd.numpy(), gi.numpy()), (np.asarray(jd), np.asarray(ji)))
    nd, ni = tknn.nn_query(torch.as_tensor(r), torch.as_tensor(q))
    np.testing.assert_array_equal(ni.numpy(), gi.numpy()[:, 0])


def test_route_follows_jax_use_pallas(monkeypatch):
    """The kernel route exactly where JAX's ``_use_pallas`` would take its
    kernel on a TPU (D <= 16, k <= 128, nr >= k), the tiled route
    elsewhere."""
    calls = []
    monkeypatch.setattr(tknn, "knn_tiled", lambda r, q, k: calls.append(("tiled", k))
                        or (torch.zeros(q.shape[0], k), torch.zeros(q.shape[0], k)))
    monkeypatch.setattr(tknn, "nn_tiled", lambda r, q: calls.append(("tiled", 1))
                        or (torch.zeros(q.shape[0]), torch.zeros(q.shape[0])))
    monkeypatch.setattr(knn_kernel, "knn", lambda r, q, k: calls.append(("kernel", k))
                        or (torch.zeros(q.shape[0], k), torch.zeros(q.shape[0], k)))
    # JAX's routing as on a TPU (its env dial forces the kernel side).
    monkeypatch.setenv("PYFOCUSR_TPU_KNN", "pallas")
    monkeypatch.setenv("PYFOCUSR_TPU_KNN_GRID", "off")
    for d, nr, k in [(16, 50, 128), (17, 50, 1), (3, 200, 129), (3, 4, 5), (8, 9, 9)]:
        calls.clear()
        tknn.knn_query(torch.zeros(nr, d), torch.zeros(3, d), k)
        jax_kernel = jknn._use_pallas(d, nr, k, None)
        assert calls == [("kernel" if jax_kernel else "tiled", k)], (d, nr, k, calls)


def test_idw_pull_k3_matches_jax():
    """The same neighbours; the weighted means differ by JAX's XLA distances
    (the matmul identity, ~1e-6 absolute here) in the weights 1 / d:
    atol 1e-4 on values of unit scale (measured 1.7e-5)."""
    rng = np.random.default_rng(12)
    ref = rng.normal(size=(500, 3)).astype(np.float32)
    mask = (rng.uniform(size=500) > 0.1).astype(np.float32)
    vals = rng.normal(size=(500, 4)).astype(np.float32)
    q = rng.normal(size=(300, 3)).astype(np.float32)
    got = tknn.idw_pull_k3(*(torch.as_tensor(a) for a in (ref, mask, vals, q)))
    want = jknn.idw_pull_k3(*(jnp.asarray(a) for a in (ref, mask, vals, q)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_nn_query_matches_jax():
    rng = np.random.default_rng(5)
    r = rng.normal(size=(1200, 6)).astype(np.float32)
    q = rng.normal(size=(800, 6)).astype(np.float32)
    d, i = tknn.nn_query(torch.as_tensor(r), torch.as_tensor(q))
    jd, ji = jknn.nn_query(jnp.asarray(r), jnp.asarray(q))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-4)
    pd, pi = _pallas(r, q, 1)
    np.testing.assert_array_equal(i.numpy(), pi[:, 0])
    np.testing.assert_allclose(d.numpy(), pd[:, 0], rtol=1e-6)


def test_knn3_masked_and_idw_match_jax():
    rng = np.random.default_rng(7)
    ref = rng.normal(size=(600, 3)).astype(np.float32)
    mask = (rng.uniform(size=600) > 0.2).astype(np.float32)
    vals = rng.normal(size=(600, 3)).astype(np.float32)
    q = rng.normal(size=(400, 3)).astype(np.float32)
    q[:5] = ref[np.flatnonzero(mask)[:5]]  # exact hits take the shortcut
    d, i = tknn.knn3_masked(torch.as_tensor(ref), torch.as_tensor(mask),
                            torch.as_tensor(q))
    jd, ji = jknn.knn3_masked(jnp.asarray(ref), jnp.asarray(mask), jnp.asarray(q))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert mask[i.numpy()].min() == 1.0
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-4)
    # IDW from the same neighbours: rtol 1e-5 (f32 weighted mean).
    out = tknn.idw_from_knn(torch.tensor(np.asarray(jd)),
                            torch.tensor(np.asarray(ji)).long(),
                            torch.tensor(vals))
    want = jknn.idw_from_knn(jd, ji, jnp.asarray(vals))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out.numpy()[:5], vals[np.flatnonzero(mask)[:5]])


def test_pairwise_sq_dists_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(70, 5)).astype(np.float32)
    b = rng.normal(size=(90, 5)).astype(np.float32)
    got = tknn.pairwise_sq_dists(torch.as_tensor(a), torch.as_tensor(b))
    want = jknn.pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_dispatch_uses_plain_version_and_counts_nothing():
    rng = np.random.default_rng(2)
    r = torch.as_tensor(rng.normal(size=(64, 3)).astype(np.float32))
    before = knn_kernel.LAUNCHES
    got = knn_kernel.knn(r, r, 3)
    want = knn_kernel.knn_plain(r, r, 3)
    assert knn_kernel.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int32


def test_kernel_wrapper_rejects_cpu_tensors():
    r = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        knn_kernel.knn_cuda(r, r, 1)
    with pytest.raises(TypeError, match="float32"):
        knn_kernel.knn(r.double(), r.double(), 1)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """Runs on a CUDA card only: the kernel against its plain version on
    the same card, bit-identical (same f32 operation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(0)
    for nq, nr, d in [(300, 500, 3), (77, 2049, 12), (8, 9, 2)]:
        q = torch.randn(nq, d, generator=g).cuda()
        r = torch.randn(nr, d, generator=g).cuda()
        for k in knn_kernel.SUPPORTED_K:
            before = knn_kernel.LAUNCHES
            kd, ki = knn_kernel.knn(r, q, k)
            assert knn_kernel.LAUNCHES == before + 1
            pd, pi = knn_kernel.knn_plain(r, q, k)
            assert torch.equal(ki, pi)
            assert torch.equal(kd, pd)


@pytest.mark.gpu
def test_topk_kernel_matches_plain_on_card():
    """Runs on a CUDA card only: k = 4..128 launch ``csrc/knn_topk.cu``
    (counted in ``knn_topk_kernel.LAUNCHES``, not in ``knn_kernel``'s),
    bit-identical to the plain version, ties and non-finite rows included;
    the done flag leaves the outputs as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyfocusr_tpu_torch.ops import knn_topk_kernel

    g = torch.Generator().manual_seed(1)
    ties = torch.randn(300, 3, generator=g).repeat_interleave(2, 0)
    bad = torch.randn(500, 5, generator=g)
    bad[::9] = float("nan")
    cases = [(torch.randn(2049, 3, generator=g), torch.randn(300, 3, generator=g)),
             (torch.randn(700, 12, generator=g), torch.randn(77, 12, generator=g)),
             (ties, ties[::3].contiguous()), (bad, torch.randn(40, 5, generator=g))]
    for r, q in cases:
        r, q = r.cuda(), q.cuda()
        for k in (4, 5, 8, 32, 100, 128):
            before = (knn_kernel.LAUNCHES, knn_topk_kernel.LAUNCHES)
            kd, ki = knn_kernel.knn(r, q, k)
            assert (knn_kernel.LAUNCHES, knn_topk_kernel.LAUNCHES) == (before[0], before[1] + 1)
            pd, pi = knn_kernel.knn_plain(r, q, k)
            assert torch.equal(ki, pi), (tuple(r.shape), k)
            assert torch.equal(kd, pd), (tuple(r.shape), k)
    r, q = cases[0][0].cuda(), cases[0][1].cuda()
    out = (torch.full((300, 8), -1.0, device="cuda"),
           torch.full((300, 8), -7, dtype=torch.int32, device="cuda"))
    knn_kernel.knn_cuda(r, q, 8, out=out, done=torch.ones(1, dtype=torch.int32, device="cuda"))
    assert bool((out[0] == -1.0).all()) and bool((out[1] == -7).all())
    # Both of the plan's grids (1 and 4 queries a warp) at every list width,
    # the cases chip_smoke.py's top-k phase runs on the card.
    import chip_smoke

    for name, r, q, k in chip_smoke.topk_grid_cases(torch):
        assert knn_topk_kernel.plan(q.shape[0], k)["queries_per_warp"] == (
            4 if q.shape[0] == 6401 and k <= 32 else 1), name
        kd, ki = knn_kernel.knn(r, q, k)
        pd, pi = knn_kernel.knn_plain(r, q, k)
        assert torch.equal(ki, pi), name
        assert torch.equal(kd, pd), name


# (nq, {k: queries a warp}) of the k = 4..128 kernel's plan on a 132-SM
# card: 10242 queries fill the card at 4 a warp up to k = 32; ICP's 2000
# take 1 a warp (4 would leave 4 warps an SM), as does every k above 32
# (the thread queues' instances).
TOPK_PLAN = {1: {8: 1, 32: 1, 64: 1, 128: 1}, 1000: {8: 1, 32: 1, 64: 1, 128: 1},
             2000: {8: 1, 32: 1, 64: 1, 128: 1}, 5000: {8: 1, 32: 1, 64: 1, 128: 1},
             10242: {8: 4, 32: 4, 33: 1, 64: 1, 128: 1}}


@pytest.mark.parametrize("nq", sorted(TOPK_PLAN))
def test_topk_plan_at_path_sizes(nq):
    from pyfocusr_tpu_torch.ops import knn_topk_kernel as T

    for k, qw in TOPK_PLAN[nq].items():
        got = T.plan(nq, k)
        assert got["queries_per_warp"] == qw, (nq, k, got)
        assert got["ctas"] == -(-nq // (qw * T.WARPS_PER_CTA))
        assert got["warps_per_sm"] == got["ctas"] * T.WARPS_PER_CTA / 132
    # The switch sits where 4 queries a warp give 12 warps an SM.
    edge = 4 * T.TARGET_WARPS_PER_SM * 132
    assert T.plan(edge, 8)["queries_per_warp"] == 4
    assert T.plan(edge - 4, 8)["queries_per_warp"] == 1


def test_topk_kernel_source_agrees_with_planner():
    """The warps a CTA and the grids csrc/knn_topk.cu is built with are the
    planner's."""
    from pathlib import Path

    from pyfocusr_tpu_torch.ops import knn_topk_kernel as T

    src = (Path(T.__file__).parent.parent / "csrc" / "knn_topk.cu").read_text()
    assert f"constexpr int kWarps = {T.WARPS_PER_CTA};" in src
    assert "(qw != 1 && qw != 4) || (qw == 4 && k > 32)" in src
