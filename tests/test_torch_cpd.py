"""Port parity for the CPD stage's full-resolution and prior pieces:
``pyfocusr_tpu_torch.ops.cpd_estep_kernel`` (the streamed E-step),
``gaussian_matvec_tiled``, the tiled branch of ``low_rank_gaussian``,
``_deformable_cpd_run`` with ``estep_impl="streamed"`` and ``landmarks``, and
``_affine_cpd_run``, against ``pyfocusr_tpu`` on the same inputs.

Tolerances, and why:
* ``cpd_estep_plain`` against ``cpd_estep_pallas(interpret=True)`` and
  ``cpd_estep_tiled``: atol 2e-5 with numpy's default rtol 1e-7, the JAX
  package's own gate for its kernels (``tests/test_pallas_kernels.py``).
  The port takes squared distances as direct differences, JAX through the
  |x|^2 + |ty|^2 - 2 x.ty identity; at these sigma2 the two differ by
  ~5e-6 in P1 and PX and by one ulp in the scalars Np and L.
* At a late, small sigma2 the identity cancels and the direct differences
  do not: the plain version is held to a float64 E-step at rtol 1e-4.
* ``gaussian_matvec_tiled``: atol 5e-5 against JAX's and against the dense
  Gram (the JAX package's gate).
* The tiled ``low_rank_gaussian`` against its dense branch from one omega:
  the same products in another grouping, eigenvalues and the rank-k
  reconstruction within 1e-5 of the top eigenvalue.
* Streamed against dense EM, 8 iterations: TY within 1e-3, sigma2 within
  1e-5 (``tests/test_pallas_kernels.py:71-93``; reduction-order
  differences compound through the EM map as sigma2 shrinks).
* Landmark and affine runs against JAX: the same iteration count, TY within
  1e-3, B and t within 1e-4, sigma2 within 1e-6 absolute, the stop
  tolerance (sigma2 is a difference of O(1) sums, so its f32 noise is
  absolute: measured 0.8-1.5e-7 at sigma2 ~ 1e-4; the stop test at 1e-6 sits
  above it, see test_torch_pipeline.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfocusr_tpu.ops import cpd as JC
from pyfocusr_tpu.ops.pallas_kernels import (
    cpd_estep_pallas,
    cpd_estep_tiled,
    gaussian_matvec_tiled as jax_gaussian_matvec_tiled,
)
from pyfocusr_tpu_torch.ops import cpd as TC
from pyfocusr_tpu_torch.ops import cpd_estep_kernel as EK

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

ESTEP_ATOL = 2e-5
NAMES = ("Pt1", "P1", "PX", "Np", "L")


def _outlier_c(s2, w, D, M, N):
    return (2 * np.pi * s2) ** (D / 2) * (w / (1 - w)) * (M / N) if w > 0 else 0.0


# (M, N, D, sigma2, w, seed): the cases of tests/test_pallas_kernels.py
# (700 x 900; 258 x 513 non-square with ragged tiles; the outlier term) and
# the xyz-as-features width D = 6.
ESTEP_CASES = {
    "700x900": (700, 900, 3, 0.05, 0.0, 0),
    "258x513": (258, 513, 3, 0.1, 0.0, 1),
    "outlier_w0.1": (700, 900, 3, 0.05, 0.1, 0),
    "d6": (400, 600, 6, 0.2, 0.0, 3),
}


def _estep_inputs(case):
    M, N, D, s2, w, seed = ESTEP_CASES[case]
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (N, D)).astype(np.float32)
    TY = rng.uniform(-1, 1, (M, D)).astype(np.float32)
    return X, TY, s2, _outlier_c(s2, w, D, M, N)


@pytest.mark.parametrize("case", sorted(ESTEP_CASES))
def test_cpd_estep_plain_matches_jax(case):
    X, TY, s2, c = _estep_inputs(case)
    want_tiled = cpd_estep_tiled(jnp.asarray(X), jnp.asarray(TY), s2, c, tile_m=256)
    want_pallas = cpd_estep_pallas(jnp.asarray(X), jnp.asarray(TY), s2, c,
                                   tile_m=128, tile_n=128, interpret=True)
    got = EK.cpd_estep_plain(torch.tensor(X), torch.tensor(TY), s2, c, tile_m=256)
    assert [tuple(g.shape) for g in got] == [tuple(np.shape(w)) for w in want_tiled]
    for name, g, wt, wp in zip(NAMES, got, want_tiled, want_pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), atol=ESTEP_ATOL,
                                   err_msg=f"{name} vs cpd_estep_tiled")
        np.testing.assert_allclose(g.numpy(), np.asarray(wp), atol=ESTEP_ATOL,
                                   err_msg=f"{name} vs cpd_estep_pallas")


def test_cpd_estep_dispatches_cpu_tensors_to_the_plain_version():
    X, TY, s2, c = _estep_inputs("258x513")
    before = EK.LAUNCHES
    got = EK.cpd_estep(torch.tensor(X), torch.tensor(TY), torch.tensor(s2), c)
    want = EK.cpd_estep_plain(torch.tensor(X), torch.tensor(TY), s2, c, tile_m=100)
    assert EK.LAUNCHES == before  # the kernel was not launched
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        EK.cpd_estep_cuda(torch.tensor(X), torch.tensor(TY), s2, c)


@pytest.mark.parametrize("bad,err", [
    ((np.zeros((5, 17), np.float32), np.zeros((4, 17), np.float32)), ValueError),
    ((np.zeros((5, 3), np.float64), np.zeros((4, 3), np.float64)), TypeError),
    ((np.zeros((5, 3), np.float32), np.zeros((4, 2), np.float32)), ValueError),
])
def test_cpd_estep_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        EK.cpd_estep(torch.tensor(bad[0]), torch.tensor(bad[1]), 0.1)


def test_cpd_estep_plain_at_small_sigma2_matches_float64():
    """Late in EM sigma2 is small, and on clouds away from the origin the
    matmul identity cancels: the port's direct differences stay within rtol
    1e-4 of a float64 E-step (measured 4e-5 in P1), where JAX's tiled version
    (the identity) errs by more than a hundred times as much (measured 0.17).
    Each x sees several control points within a few sigma, so the errors do
    not cancel in the normalisation."""
    rng = np.random.default_rng(4)
    Y = rng.uniform(0, 0.03, (300, 3)) + 3.0
    X = Y[rng.permutation(300)[:250]] + rng.normal(scale=3e-3, size=(250, 3))
    s2 = 1e-5
    d2 = ((Y[:, None, :] - X[None, :, :]) ** 2).sum(-1)  # f64 [M, N]
    P = np.exp(-d2 / (2 * s2))
    den = np.maximum(P.sum(0), 1e-30)
    want_p1 = (P / den).sum(1)
    want_px = (P / den) @ X
    X32, Y32 = X.astype(np.float32), Y.astype(np.float32)
    got = EK.cpd_estep_plain(torch.tensor(X32), torch.tensor(Y32), s2)
    np.testing.assert_allclose(got[1].numpy(), want_p1, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), want_px, rtol=1e-4, atol=1e-4)
    jax_p1 = np.asarray(cpd_estep_tiled(jnp.asarray(X32), jnp.asarray(Y32), s2, 0.0)[1])
    assert np.abs(jax_p1 - want_p1).max() > 100 * np.abs(got[1].numpy() - want_p1).max()


@pytest.fixture(scope="module")
def cloud_700():
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, (700, 3)).astype(np.float32)


def test_gaussian_matvec_tiled_matches_jax_and_dense(cloud_700):
    TY = cloud_700
    V = np.random.default_rng(2).normal(size=(TY.shape[0], 5)).astype(np.float32)
    want = np.asarray(jax_gaussian_matvec_tiled(jnp.asarray(TY), 1.3, jnp.asarray(V),
                                                tile=256))
    got = TC.gaussian_matvec_tiled(torch.tensor(TY), 1.3, torch.tensor(V), tile=256)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    dense = TC.gaussian_kernel(torch.tensor(TY), torch.tensor(TY), 1.3) @ torch.tensor(V)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=5e-5)


def test_low_rank_gaussian_tiled_branch_matches_dense(cloud_700, monkeypatch):
    """The branch taken above 8192 points, forced at 700 points by lowering
    the threshold, against the dense branch from the same omega."""
    Y = torch.tensor(cloud_700)
    omega = torch.tensor(np.random.default_rng(5).normal(size=(700, 76)).astype(np.float32))
    dQ, dl = TC.low_rank_gaussian(Y, 1.5, 60, omega)
    calls = []
    real = TC.gaussian_matvec_tiled
    monkeypatch.setattr(TC, "_DENSE_GRAM_MAX_M", 500)
    monkeypatch.setattr(TC, "gaussian_matvec_tiled",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tQ, tl = TC.low_rank_gaussian(Y, 1.5, 60, omega)
    assert len(calls) == 4  # Z, two subspace iterations, the Rayleigh quotient
    tol = 1e-5 * float(dl[0])
    np.testing.assert_allclose(tl.numpy(), dl.numpy(), atol=tol)
    np.testing.assert_allclose(((tQ * tl) @ tQ.T).numpy(), ((dQ * dl) @ dQ.T).numpy(),
                               atol=tol)


@pytest.fixture(scope="module")
def warp_pair():
    """The clouds of tests/test_pallas_kernels.py:71-93: Y uniform, X a
    smooth warp of it, with the JAX package's low-rank Gram of Y."""
    rng = np.random.default_rng(0)
    Y = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    X = (Y + 0.1 * np.sin(2 * Y[:, [1, 2, 0]])).astype(np.float32)
    Q, lam = JC.low_rank_gaussian(jnp.asarray(Y), 1.5, 60, jax.random.PRNGKey(0))
    return X, Y, np.asarray(Q), np.asarray(lam)


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def test_streamed_cpd_run_matches_dense(warp_pair):
    X, Y, Q, lam = _t(*warp_pair)
    TYd, _, s2d, itd = TC._deformable_cpd_run(X, Y, Q, lam, 2.0, 8, 0.0,
                                              estep_impl="dense")
    TYs, _, s2s, its = TC._deformable_cpd_run(X, Y, Q, lam, 2.0, 8, 0.0,
                                              estep_impl="streamed")
    assert itd == its == 8
    np.testing.assert_allclose(TYs.numpy(), TYd.numpy(), atol=1e-3)
    assert abs(float(s2d) - float(s2s)) < 1e-5
    with pytest.raises(ValueError, match="estep_impl"):
        TC._deformable_cpd_run(X, Y, Q, lam, 2.0, 8, 0.0, estep_impl="pallas")


@pytest.mark.parametrize("estep_impl", ["dense", "streamed"])
def test_landmark_cpd_run_matches_jax(warp_pair, estep_impl):
    """MAP CPD: five control points pulled toward their warped positions
    with weight 100; the JAX run takes its dense E-step."""
    X, Y, Q, lam = warp_pair
    lm_idx = np.array([0, 17, 101, 250, 499], np.int32)
    lm_pos = (X[lm_idx] + 0.02).astype(np.float32)
    lm_w = np.full((5,), 100.0, np.float32)
    jTY, _, js2, jit = JC._deformable_cpd_run(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Q), jnp.asarray(lam), 0.5, 60,
        1e-6, landmarks=(jnp.asarray(lm_idx), jnp.asarray(lm_pos), jnp.asarray(lm_w)))
    tX, tY, tQ, tl = _t(X, Y, Q, lam)
    tTY, _, ts2, tit = TC._deformable_cpd_run(
        tX, tY, tQ, tl, 0.5, 60, 1e-6, estep_impl=estep_impl,
        landmarks=_t(lm_idx, lm_pos, lm_w))
    assert tit == int(jit) < 60
    np.testing.assert_allclose(tTY.numpy(), np.asarray(jTY), atol=1e-3)
    assert abs(float(ts2) - float(js2)) <= 1e-6
    # The prior pulled the landmark rows: nearer their targets than without it.
    free, _, _, _ = TC._deformable_cpd_run(tX, tY, tQ, tl, 0.5, tit, 0.0)
    d_lm = np.linalg.norm(tTY.numpy()[lm_idx] - lm_pos, axis=1)
    d_free = np.linalg.norm(free.numpy()[lm_idx] - lm_pos, axis=1)
    assert d_lm.mean() < d_free.mean()


@pytest.mark.parametrize("w", [0.0, 0.1])
def test_affine_cpd_run_matches_jax(w):
    rng = np.random.default_rng(7)
    Y = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    A = np.array([[1.1, 0.1, 0.0], [-0.05, 0.95, 0.08], [0.02, 0.0, 1.05]], np.float32)
    X = (Y[rng.permutation(400)[:350]] @ A.T + np.array([0.1, -0.2, 0.05])
         + rng.normal(scale=0.01, size=(350, 3))).astype(np.float32)
    jTY, jB, jt, js2, jit = JC._affine_cpd_run(jnp.asarray(X), jnp.asarray(Y), 100,
                                               1e-6, w=w)
    tTY, tB, tt, ts2, tit = TC._affine_cpd_run(torch.tensor(X), torch.tensor(Y), 100,
                                               1e-6, w=w)
    assert tit == int(jit) < 100
    np.testing.assert_allclose(tB.numpy(), np.asarray(jB), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    assert abs(float(ts2) - float(js2)) <= 1e-6
    np.testing.assert_allclose(tTY.numpy(), np.asarray(jTY), atol=1e-4)
    if w == 0.0:  # the affine map it recovers
        np.testing.assert_allclose(tB.numpy(), A, atol=0.02)


# ------------------------------------------------------ on the card


@pytest.mark.gpu
def test_cpd_estep_kernel_matches_plain_on_card():
    """Runs on a CUDA card only: the kernel against its plain version at
    D = 3 and 6, ragged sizes and the outlier term, two launches per call.
    Tolerance: rtol 1e-5 on den-sized sums (the two sum in different orders
    and the kernel contracts with FMA), i.e. atol 1e-5 on P1 / PX here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case in sorted(ESTEP_CASES):
        X, TY, s2, c = _estep_inputs(case)
        Xc, TYc = torch.tensor(X).cuda(), torch.tensor(TY).cuda()
        before = EK.LAUNCHES
        got = EK.cpd_estep(Xc, TYc, torch.tensor(s2).cuda(), c)
        assert EK.LAUNCHES == before + 2
        want = EK.cpd_estep_plain(Xc, TYc, s2, c)
        for name, g, w in zip(NAMES, got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)
