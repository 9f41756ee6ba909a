"""Port parity for the point-data transfer (``pyfocusr_tpu_torch/transfer.py``
and ``Focusr.transfer_point_data``) and ``recursive_eig`` against
``pyfocusr_tpu`` on the synthetic bone pair (``chip_smoke.synthetic_bone``,
642 vertices: seeds 2 target, 1 source), from one registration result
handed to both packages as numpy.

Gates, and why:
* 'nearest': equal outright (a gather by the same correspondences);
* 'idw': within atol 1e-5 of each array's scale, JAX's k=3 query taken by
  the route it takes on a TPU (``knn_pallas``, run in interpret mode:
  ``jax_kernel_route``), whose direct differences are the port's.  On the
  CPU JAX's own route is its XLA path, the matmul identity, which on these
  millimetre coordinates (|x|^2 ~ 1e3) errs by ~1e-4 in a squared distance
  and moves the weights 1 / d of near neighbours by up to 24% (measured:
  1.6e-3 absolute on values of scale 2.6);
* the cohort matrix: equal outright (a gather);
* the errors JAX raises (unknown names, methods, sizes), raised alike;
* ``recursive_eig``: JAX's eigenpairs (one numpy routine, the same input).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu import recursive_eig as j_recursive_eig
from pyfocusr_tpu import transfer as JT
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
from pyfocusr_tpu.ops import pallas_kernels as JPK

torch.set_num_threads(1)

FEATURE = chip_smoke.FEATURE


@pytest.fixture(scope="module")
def pair():
    """(port target, port source, JAX target, JAX source, result): the
    target carries the thickness scalar and a [N, 3] vector array; the
    result maps each source vertex to its nearest target vertex, with the
    source's own points as its projection and a smoothed target."""
    t = chip_smoke.synthetic_bone(TP, 2, levels=3)
    s = chip_smoke.synthetic_bone(TP, 1, levels=3)
    rng = np.random.default_rng(0)
    t = t.with_point_data("normal_ish", rng.normal(size=(t.n_points, 3)).astype(np.float32))
    tp_, sp = np.asarray(t.points), np.asarray(s.points)
    d2 = ((sp[:, None, :] - tp_[None, :, :]) ** 2).sum(-1)
    result = {
        "correspondences": d2.argmin(axis=1).astype(np.int32),
        "smoothed_target_coords": (tp_ + rng.normal(0, 0.05, tp_.shape)).astype(np.float32),
        "source_projected_on_target": (sp + rng.normal(0, 0.05, sp.shape)).astype(np.float32),
    }
    jt, js = (JTriMesh(m.points, m.triangles, dict(m.point_data)) for m in (t, s))
    return t, s, jt, js, result


@pytest.fixture
def jax_kernel_route(monkeypatch):
    """JAX's k-NN queries take the route they take on a TPU: its Pallas
    kernel (D <= 16, k <= 128), here in interpret mode."""
    real = JPK.knn_pallas
    monkeypatch.setenv("PYFOCUSR_TPU_KNN", "pallas")
    monkeypatch.setattr(JPK, "knn_pallas",
                        lambda ref, query, k: real(ref, query, k, interpret=True))


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("method", ["idw", "nearest"])
def test_transfer_point_data_matches_jax(pair, method, jax_kernel_route):
    t, _, jt, _, result = pair
    got = TP.transfer_point_data(t, result, method=method, device="cpu")
    want = JT.transfer_point_data(jt, result, method=method)
    assert list(got) == list(want) == [FEATURE, "normal_ish"]
    for name in want:
        assert isinstance(got[name], np.ndarray)
        assert got[name].shape == np.asarray(want[name]).shape
        if method == "nearest":
            np.testing.assert_array_equal(got[name], np.asarray(want[name]))
        else:
            _close(got[name], np.asarray(want[name]))


def test_transfer_takes_tensors_on_their_device_and_n_source(pair, jax_kernel_route):
    """A result of CPU tensors runs on the CPU without ``device``;
    ``n_source`` slices the rows as in JAX."""
    t, _, jt, _, result = pair
    as_tensors = {k: torch.as_tensor(v) for k, v in result.items()}
    got = TP.transfer_point_data(t, as_tensors, names=iter([FEATURE]), n_source=500)
    want = JT.transfer_point_data(jt, result, names=iter([FEATURE]), n_source=500)
    assert got[FEATURE].shape == (500,)
    _close(got[FEATURE], np.asarray(want[FEATURE]))


def test_transfer_of_coordinates_reproduces_idw_from_knn(pair):
    """Transferring the target's coordinates by 'idw' gives the k=3
    weighted locations the pipeline computes (the same query)."""
    t, _, _, _, result = pair
    t = t.with_point_data("xyz", np.asarray(t.points))
    got = TP.transfer_point_data(t, result, names=["xyz"], device="cpu")["xyz"]
    ref = torch.as_tensor(result["smoothed_target_coords"])
    d, i = TP.ops.knn.knn3_masked(ref, torch.ones(ref.shape[0]),
                                  torch.as_tensor(result["source_projected_on_target"]))
    want = TP.ops.knn.idw_from_knn(d, i, torch.as_tensor(t.points)).numpy()
    np.testing.assert_array_equal(got, want)


def test_mesh_with_transferred_data_matches_jax(pair, jax_kernel_route):
    t, s, jt, js, result = pair
    got = TP.mesh_with_transferred_data(s, t, result, names=[FEATURE], suffix="_t",
                                        device="cpu")
    want = JT.mesh_with_transferred_data(js, jt, result, names=[FEATURE], suffix="_t")
    assert sorted(got.point_data) == sorted(want.point_data)
    _close(got.point_data[FEATURE + "_t"], np.asarray(want.point_data[FEATURE + "_t"]))
    short = dict(result, correspondences=result["correspondences"][:100],
                 source_projected_on_target=result["source_projected_on_target"][:100])
    for fn, mesh_s, mesh_t in ((TP.mesh_with_transferred_data, s, t),
                               (JT.mesh_with_transferred_data, js, jt)):
        kw = {"device": "cpu"} if fn is TP.mesh_with_transferred_data else {}
        with pytest.raises(ValueError, match="rows but"):
            fn(mesh_s, mesh_t, short, names=[FEATURE], **kw)


def test_cohort_point_data_matrix_matches_jax(pair):
    t, s, jt, js, result = pair
    rng = np.random.default_rng(3)
    corr = np.stack([rng.integers(0, t.n_points, 300) for _ in range(3)])
    results = {"correspondences": corr}
    got = TP.cohort_point_data_matrix([t, t, t], {"correspondences": torch.as_tensor(corr)},
                                      "normal_ish", n_template=250)
    want = JT.cohort_point_data_matrix([jt, jt, jt], results, "normal_ish", n_template=250)
    assert got.shape == (3, 250, 3)
    np.testing.assert_array_equal(got, np.asarray(want))
    small = TP.TriMesh(np.asarray(s.points)[:100], np.zeros((0, 3), np.int32),
                       {FEATURE: np.asarray(s.point_data[FEATURE])[:100]})
    with pytest.raises(ValueError, match="reach"):
        TP.cohort_point_data_matrix([small] * 3, results, FEATURE)


@pytest.mark.parametrize("case", ["unknown_name", "bad_method", "n_source", "short_values"])
def test_transfer_raises_as_jax(pair, case):
    t, _, jt, _, result = pair
    args = {
        "unknown_name": (dict(names=["nope"]), KeyError),
        "bad_method": (dict(method="cubic"), ValueError),
        "n_source": (dict(n_source=10**6), ValueError),
    }
    if case == "short_values":
        bad_t = t.with_point_data("short", np.zeros(5, np.float32))
        bad_jt = JTriMesh(jt.points, jt.triangles, dict(bad_t.point_data))
        for fn, mesh in ((TP.transfer_point_data, bad_t), (JT.transfer_point_data, bad_jt)):
            with pytest.raises(ValueError, match="rows for"):
                fn(mesh, result, names=["short"])
        return
    kw, err = args[case]
    with pytest.raises(err):
        TP.transfer_point_data(t, result, device="cpu", **kw)
    with pytest.raises(err):
        JT.transfer_point_data(jt, result, **kw)


def test_transfer_builds_on_the_card_by_default(pair):
    """A numpy result without ``device`` runs on the card: without one it
    raises, naming the CPU option."""
    t, _, _, _, result = pair
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.transfer_point_data(t, result)


def test_recursive_eig_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(40, 40))
    lap = np.diag((a @ a.T).sum(1)) - a @ a.T  # symmetric, one null mode
    got = TP.recursive_eig(lap, 6, 4)
    want = j_recursive_eig(lap, 6, 4)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(np.abs(got[1]), np.abs(want[1]), atol=1e-10)
    assert got[0].shape == (4,) and (got[0] > 1e-10).all()
