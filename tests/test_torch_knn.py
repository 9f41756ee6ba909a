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
    ],
)
def test_plain_matches_pallas(nq, nr, d, k, bq, br):
    rng = np.random.default_rng(nq + nr + d + k)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    r = rng.normal(size=(nr, d)).astype(np.float32)
    _assert_same(_plain(r, q, k), _pallas(r, q, k, bq, br))


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
