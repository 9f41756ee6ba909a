"""Port parity for groupwise registration: ``pyfocusr_tpu_torch.parallel.
groupwise`` against ``pyfocusr_tpu.parallel.groupwise`` on one device.

The cohort is built in code (``tests/test_groupwise.py`` reads the bundled
bone, which this suite cannot assume): the synthetic bone
(``chip_smoke.synthetic_bone``) seed 2 at 642 vertices under two small
axial warps, and the same bone at 2562 vertices warped a third way and
decimated to 600 (the decimation lands below 642, so ``pad_cohort`` pads
it).  The configuration is ``tests/test_torch_cohort.py``'s (its ``TINY``
with k = 3, 300 ICP landmarks and CPD's stop at 1e-6, for the reasons given
there).  JAX's side is one module-scoped call of each function.

Draws and signs: the port is given JAX's draws, rebuilt from its key
splits (``register_all_pairs``: ``split(key, B(B-1))``, one per pair,
:205; ``register_pair_symmetric``: ``split(key)``, :147), and each
target solve takes the
column signs of JAX's result for it (``jax_target_signs``: the eigsort is
not sign-symmetric, and JAX's vmapped signs differ from its unbatched
ones).

The spectral functions run on their own cohort at 2562 vertices (two
warps and a decimation to 2364, padded), where both packages' wide
solver converges at 20 modes; at 642 the narrow solver leaves modes 9-20
unconverged in both packages, differently (measured principal cosines of
the spans 0.01-0.93; ROADMAP Queue 3).  Their maps are nearest vertices
by position, a consistent set, and the starts are JAX's wide blocks
(``split(key, B)``, then eigen.py:404-405 per graph).

Gates: each pair of ``register_all_pairs`` and both directions of the
symmetric pair by ``tests/test_torch_pipeline.py::_check_slice``
(eigenpairs, >= 95% equal correspondences, unique fraction, final
locations); ``fb_consistency`` and ``cycle_error`` within 5% relative;
the symmetric correspondences >= 95% equal.  On JAX's own maps:
``cycle_consistency_error`` within 1e-6 relative (both are numpy);
``synchronize_correspondences`` equal except at near-ties of the snap
(JAX's CPU query is the matmul identity, the port's direct differences:
where the two picks differ, their distances to the consensus point differ
by at most 1e-3 mm); ``spectral_bases`` columns |cos| >= 0.9999;
``synchronize_spectral`` on the clean maps and with one map 50% scrambled:
residuals within 1e-3, the same flagged set, repaired maps >= 95% equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
from pyfocusr_tpu.parallel import cohort as JC
from pyfocusr_tpu.parallel import groupwise as JG
from test_torch_cohort import JCFG, TCFG, _block_key, jax_target_signs
from test_torch_pipeline import _check_slice, _eig_block, _jax_draws
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch.parallel import groupwise as TG

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
N_BASIS = 20
SNAP_TIE_MM = 1e-3


def _warped(levels, amp, phase):
    m = chip_smoke.synthetic_bone(TP, 2, levels)
    pts = np.asarray(m.points, np.float64)
    pts = pts * (1.0 + amp * np.sin(0.08 * pts[:, [2]] + phase))
    return TP.TriMesh(pts.astype(np.float32), m.triangles, {})


@pytest.fixture(scope="module")
def meshes():
    """(port meshes, JAX meshes): two warps at 642, one decimated (padded)."""
    tm = [_warped(3, 0.01, 0.0), _warped(3, 0.02, 0.4),
          TP.decimate(_warped(4, 0.015, 0.8), 600, seed=5)[0]]
    assert [m.n_points for m in tm][:2] == [642, 642] and tm[2].n_points < 642
    return tm, [JTriMesh(m.points, m.triangles, {}) for m in tm]


@pytest.fixture(scope="module")
def graphs(meshes):
    tm, jm = meshes
    return TP.pad_cohort(tm, device="cpu"), JC.pad_cohort(jm)


def _np(res):
    return {k: np.asarray(v) for k, v in res.items()}


def _sign_refs(pairs):
    """{a target solve's start: JAX's eigenvectors of that solve}."""
    return {_block_key(d["eig_start_target"]): np.array(vecs) for d, vecs in pairs}


@pytest.fixture(scope="module")
def all_pairs(graphs):
    tg, jg = graphs
    want_corr, want_index, want = JG.register_all_pairs(jg, JCFG, KEY)
    want = _np(want)
    stacked = JC.stack_graph_arrays(jg)
    keys = jax.random.split(KEY, len(want_index))
    lane = lambda i: jax.tree.map(lambda x: x[i], stacked)  # noqa: E731
    draws = [_jax_draws(keys[p], JCFG, lane(i), lane(j))
             for p, (i, j) in enumerate(want_index)]
    with jax_target_signs(_sign_refs(zip(draws, want["eig_vecs_target"]))):
        got_corr, got_index, got = TG.register_all_pairs(tg, TCFG, draws=draws)
    return dict(want=(np.asarray(want_corr), want_index, want),
                got=(got_corr, got_index, got))


@pytest.mark.parametrize("pair", range(6))
def test_register_all_pairs_matches_jax(all_pairs, pair):
    want_corr, want_index, want = all_pairs["want"]
    got_corr, got_index, got = all_pairs["got"]
    assert got_index == want_index
    g = _check_slice({k: v[pair] for k, v in want.items()},
                     {k: v[pair] for k, v in got.items()})
    i, j = got_index[pair]
    np.testing.assert_array_equal(got_corr[j, i], g["correspondences"])
    assert (got_corr[j, i] == want_corr[j, i]).mean() >= 0.95


def test_register_all_pairs_layout(all_pairs, graphs):
    got_corr, got_index, got = all_pairs["got"]
    n_pad = graphs[0][0].n_points
    assert got_corr.shape == (3, 3, n_pad) and got_corr.dtype == np.int64
    assert got["correspondences"].shape == (6, n_pad)
    for i in range(3):
        np.testing.assert_array_equal(got_corr[i, i], np.arange(n_pad))
    # Every correspondence of a real row is a real row of its target.
    real = [int(g.valid_mask.sum()) for g in graphs[0]]
    for (i, j) in got_index:
        assert got_corr[j, i][: real[j]].max() < real[i]


def test_register_pair_symmetric_matches_jax(graphs):
    tg, jg = graphs
    want = JG.register_pair_symmetric(jg[0], jg[1], JCFG, KEY)
    want = {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in want.items()}
    kf, kb = jax.random.split(KEY)
    draws = {"forward": _jax_draws(kf, JCFG, jg[0], jg[1]),
             "backward": _jax_draws(kb, JCFG, jg[1], jg[0])}
    refs = _sign_refs([(draws["forward"], want["forward"]["eig_vecs_target"]),
                       (draws["backward"], want["backward"]["eig_vecs_target"])])
    with jax_target_signs(refs):
        got = TG.register_pair_symmetric(tg[0], tg[1], TCFG, draws=draws)
    assert set(got) == set(want)
    for side in ("forward", "backward"):
        _check_slice(want[side], got[side])
    for key_ in ("fb_consistency", "cycle_error"):
        np.testing.assert_allclose(float(got[key_]), float(want[key_]), rtol=0.05,
                                   err_msg=key_)
    for pts, corr in (("sym_points", "sym_correspondences"),
                      ("target_sym_points", "target_sym_correspondences")):
        assert got[corr].dtype == torch.int64
        assert (got[corr].numpy() == want[corr]).mean() >= 0.95, corr
        d = np.linalg.norm(got[pts].numpy() - want[pts], axis=1)
        assert np.median(d) <= 1e-3 and d.mean() <= 0.1, (pts, np.median(d), d.mean())


def test_register_pair_symmetric_from_a_generator(graphs):
    """Draws from a generator are reproducible; the diagnostics are
    physical distances."""
    tg = graphs[0]
    a = TG.register_pair_symmetric(tg[0], tg[1], TCFG,
                                   generator=torch.Generator().manual_seed(4))
    b = TG.register_pair_symmetric(tg[0], tg[1], TCFG,
                                   generator=torch.Generator().manual_seed(4))
    assert torch.equal(a["sym_correspondences"], b["sym_correspondences"])
    assert 0.0 <= float(a["fb_consistency"]) < 10.0
    gap = np.linalg.norm(a["sym_points"].numpy()
                         - a["forward"]["weighted_points"].numpy(), axis=1).mean()
    assert gap <= 0.5 * float(a["fb_consistency"]) + 1e-5


def _real_points(meshes):
    return [np.asarray(m.points) for m in meshes[1]], [m.n_points for m in meshes[1]]


def _scrambled(corr, n_real, seed=1):
    """``corr`` with 50% of map 0 -> 1's real rows sent to random vertices
    (``tests/test_groupwise.py``'s corruption)."""
    rng = np.random.default_rng(seed)
    bad = corr.copy()
    noise = rng.integers(0, n_real[1], size=n_real[0])
    mix = rng.random(n_real[0]) < 0.5
    bad[0, 1, : n_real[0]] = np.where(mix, noise, bad[0, 1, : n_real[0]])
    return bad


def test_cycle_consistency_error_matches_jax(all_pairs, meshes):
    corr = all_pairs["want"][0]
    pts, n_real = _real_points(meshes)
    for c in (corr, _scrambled(corr, n_real)):
        want = JG.cycle_consistency_error(c, pts, n_real)
        got = TG.cycle_consistency_error(c, [torch.as_tensor(p) for p in pts], n_real)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match=">= 3 meshes"):
        TG.cycle_consistency_error(corr[:2, :2], pts[:2], n_real[:2])


def _snap_gap(points, consensus, a, b):
    """|distance to a| - |distance to b| per row: how far apart two
    packages' snaps of the same consensus point are."""
    return np.abs(np.linalg.norm(points[a] - consensus, axis=1)
                  - np.linalg.norm(points[b] - consensus, axis=1))


def test_synchronize_correspondences_matches_jax(all_pairs, meshes):
    corr = all_pairs["want"][0]
    pts, n_real = _real_points(meshes)
    for c in (corr, _scrambled(corr, n_real)):
        want = np.asarray(JG.synchronize_correspondences(c, pts, n_real))
        got = TG.synchronize_correspondences(c, pts, n_real, device="cpu")
        assert got.shape == want.shape
        for j in range(3):
            for i in range(3):
                w, g = want[j, i, : n_real[j]], got[j, i, : n_real[j]]
                if i == j or np.array_equal(w, g):
                    continue
                v = np.arange(n_real[j])
                paths = [c[j, i][v] if k == j else c[k, i][c[j, k][v]]
                         for k in range(3) if k != i]
                consensus = np.mean([pts[i][p].astype(np.float64) for p in paths], axis=0)
                diff = w != g
                gap = _snap_gap(pts[i], consensus[diff], w[diff], g[diff])
                assert gap.max() <= SNAP_TIE_MM, (j, i, gap.max(), diff.mean())
        # Rows past a mesh's real count are untouched.
        np.testing.assert_array_equal(got[2, 0, n_real[2]:], c[2, 0, n_real[2]:])


@pytest.fixture(scope="module")
def wide_graphs():
    """(port graphs, JAX graphs, real points, real counts) of the spectral
    cases: the bone at 2562 vertices under two warps and one decimated to
    2364 (padded), where both packages' wide solver converges at 20
    modes (at 642 vertices the narrow one leaves modes 9-20 unconverged in
    both, differently: ROADMAP Queue 3)."""
    tm = [_warped(4, 0.01, 0.0), _warped(4, 0.02, 0.4),
          TP.decimate(_warped(5, 0.015, 0.8), 2400, seed=5)[0]]
    jm = [JTriMesh(m.points, m.triangles, {}) for m in tm]
    return (TP.pad_cohort(tm, device="cpu"), JC.pad_cohort(jm),
            [np.asarray(m.points) for m in tm], [m.n_points for m in tm])


def _nn_corr(points, n_pad):
    """All-pairs maps by position (each real vertex of mesh j to the
    nearest vertex of mesh i, the warps being small): a consistent map set
    in ``register_all_pairs``'s layout."""
    batch = len(points)
    corr = np.tile(np.arange(n_pad, dtype=np.int64), (batch, batch, 1))
    for j in range(batch):
        for i in range(batch):
            if i != j:
                d = ((points[j][:, None, :] - points[i][None, :, :]) ** 2).sum(-1)
                corr[j, i, : len(points[j])] = d.argmin(axis=1)
    return corr


def _basis_blocks(key, graphs):
    """JAX's wide starts of ``spectral_bases`` (one key per graph)."""
    keys = jax.random.split(key, len(graphs))
    return [_eig_block(k, g.n_points, JCFG) for k, g in zip(keys, graphs)]


def test_spectral_bases_matches_jax(wide_graphs):
    tg, jg, _, n_real = wide_graphs
    key = jax.random.PRNGKey(6)
    want = JG.spectral_bases(jg, JCFG, key, n_basis=N_BASIS)
    got = TG.spectral_bases(tg, TCFG, n_basis=N_BASIS, blocks=_basis_blocks(key, jg))
    for w, g, n in zip(want, got, n_real):
        assert g.shape == w.shape == (n, N_BASIS)
        np.testing.assert_allclose(g.T @ g / n, np.eye(N_BASIS), atol=1e-8)
        cos = np.abs((w * g).sum(axis=0)) / n
        assert cos.min() >= 0.9999, cos
    with pytest.raises(ValueError, match="n_basis"):
        TG.spectral_bases(tg, TCFG, n_basis=10**6)


@pytest.mark.parametrize("case", ["clean", "scrambled", "scrambled_spectral"])
def test_synchronize_spectral_matches_jax(wide_graphs, case):
    tg, jg, pts, n_real = wide_graphs
    corr = _nn_corr(pts, tg[0].n_points)
    if case != "clean":
        corr = _scrambled(corr, n_real)
    repair = "spectral" if case == "scrambled_spectral" else "consensus"
    key = jax.random.PRNGKey(6)
    want, winfo = JG.synchronize_spectral(corr, jg, JCFG, key, n_basis=N_BASIS,
                                          repair=repair)
    got, ginfo = TG.synchronize_spectral(corr, tg, TCFG, n_basis=N_BASIS, repair=repair,
                                         blocks=_basis_blocks(key, jg))
    np.testing.assert_allclose(ginfo["residuals"], winfo["residuals"], atol=1e-3)
    np.testing.assert_array_equal(ginfo["flagged"], winfo["flagged"])
    for q in ginfo["Q"]:
        np.testing.assert_allclose(q @ q.T, np.eye(N_BASIS), atol=1e-8)
    if case == "clean":
        assert not ginfo["flagged"].any()
        np.testing.assert_array_equal(got, corr)
        return
    assert ginfo["flagged"][0, 1] and ginfo["flagged"].sum() == 1
    untouched = got.copy()
    untouched[0, 1] = corr[0, 1]
    np.testing.assert_array_equal(untouched, corr)
    agree = (got[0, 1, : n_real[0]] == np.asarray(want)[0, 1, : n_real[0]]).mean()
    assert agree >= 0.95, agree
    # The repair lands near the clean map, far nearer than the scrambled one.
    clean = _nn_corr(pts, tg[0].n_points)[0, 1, : n_real[0]]
    dist = np.linalg.norm(pts[1][got[0, 1, : n_real[0]]] - pts[1][clean], axis=1).mean()
    bad = np.linalg.norm(pts[1][corr[0, 1, : n_real[0]]] - pts[1][clean], axis=1).mean()
    assert dist < 0.5 * bad, (dist, bad)


def test_make_all_pairs_draws(graphs):
    tg = graphs[0]
    d = TG.make_all_pairs_draws(3, TCFG, tg)
    real = [int(g.valid_mask.sum()) for g in tg]
    assert len(d) == 6
    for p, (i, j) in enumerate(TG._pair_index(3)):
        assert d[p]["eigsort_target"].max() < real[i]
        assert d[p]["cpd_source"].max() < real[j]
    again = TG.make_all_pairs_draws(3, TCFG, tg)
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(d, again) for k in a)
    blocks = TG.make_basis_blocks(3, TCFG, tg, n_basis=N_BASIS)
    assert [b.shape for b in blocks] == [(642, N_BASIS + 8)] * 3  # the narrow solver


def test_all_pairs_needs_two_meshes(meshes):
    with pytest.raises(ValueError, match="at least two"):
        TG.register_all_pairs(meshes[0][:1], TCFG, device="cpu")
