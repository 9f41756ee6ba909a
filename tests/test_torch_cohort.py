"""Port parity for cohort registration and the statistical shape model:
``pyfocusr_tpu_torch.parallel.cohort`` against ``pyfocusr_tpu.parallel.
cohort``, and the padded graphs it stands on.

The cohort: template = the synthetic bone (``chip_smoke.synthetic_bone``)
seed 2 at 642 vertices; subjects = seed 1 at 642 and seeds 3 and 4 at 2562
decimated (``decimate(..., 600)``) to 581 and 594 vertices, so
``pad_cohort`` pads two of the three to 642.  The configuration is
``tests/test_cohort.py``'s ``TINY`` with three changes: k = 3
(``n_extra_spectral=0``: at 642 vertices the narrow solver leaves a sixth
pair unconverged in both packages, ROADMAP Queue 3), ``icp_n_landmarks``
300 (JAX's 2000 exceeds the smallest real count, which the padding guard
refuses) and CPD's stop at 1e-6 (at 1e-8 it sits in f32 noise).  Not
``test_cohort.py``'s spheres (114-182 vertices): there the narrow solver
converges in neither package, and JAX's own eigenvalues of one sphere
differ by up to 0.08 between two of its runs.

JAX draws inside its programs; the port is given the same draws, rebuilt
from JAX's key splits (``_cohort_draws``: ``split(key, B)`` per lane,
``fold_in(key, B)`` for the hoisted template, ``cohort.py:207-213``).

Eigenvector signs: each framework's ``eigh`` picks them, and JAX's differ
even between its vmapped cohort lanes and the same pair run alone (lane 1
here).  The eigsort cost is not sign-symmetric (its histogram term takes
log(v + 0.5)), so a sign can move the mode order of a near-degenerate
pair and with it every correspondence (measured: one lane of three at 0%
equal correspondences, eigenvalues equal).  The parity runs therefore give
each of the port's target solves the column signs of JAX's own result for
that lane and round (``jax_target_signs``); the rest of the pipeline runs
as it is.

Gates (those of ``tests/test_torch_pipeline.py::_check_slice``, why
there): eigenvalues rtol 1e-4, eigenvectors |cos| >= 0.9999, >= 95% equal
final correspondences per lane, unique fraction within 0.02, |delta
weighted_points| median <= 1e-3 mm and mean <= 0.1 mm; the cohort mean
shape median <= 1e-3 mm, mean <= 0.1 mm; a template after Procrustes
and an SSM reconstruction median <= 0.02 and 0.05 mm, mean <= 0.1 mm:
both are fits over every vertex (the rigid close, the mode coefficients),
so the few vertices whose correspondence differs (each by up to an edge,
~5 mm at 642 vertices) move every point a little (measured medians 0.005
and 0.012 mm); motions rtol 2e-2 (a mean of per-vertex moves over the same noise);
shape modes |cos| >= 0.9999 up to sign, variances rtol 1e-4; the SSM
functions on the same inputs to f32 (atol 1e-4 of values of order 1-80).
"""

import contextlib
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pyfocusr_tpu import pipeline as JP
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
from pyfocusr_tpu.parallel import cohort as JC
from test_torch_pipeline import _check_slice, _eig_block, _fields, _jax_draws, _solve_start
from test_torch_serving import _hub_mesh
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch.parallel import cohort as TC

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

KW = dict(
    icp_iterations=10,
    n_coords_spectral_ordering=150,
    n_coords_spectral_registration=100,
    non_rigid_max_iterations=10,
    non_rigid_n_eigens=30,
    graph_smoothing_iterations=10,
    projection_smooth_iterations=2,
    eig_cg_iters=60,
    n_extra_spectral=0,
    icp_n_landmarks=300,
    non_rigid_tolerance=1e-6,
)
JCFG = JP.PipelineConfig(**KW)
TCFG = TP.PipelineConfig(**KW)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def meshes():
    """(port meshes, JAX meshes): template first, then the three subjects."""
    tm = [chip_smoke.synthetic_bone(TP, 2, 3), chip_smoke.synthetic_bone(TP, 1, 3)]
    for seed in (3, 4):
        tm.append(TP.decimate(chip_smoke.synthetic_bone(TP, seed, 4), 600, seed=seed)[0])
    assert [m.n_points for m in tm] == [642, 642, 581, 594]
    return tm, [JTriMesh(m.points, m.triangles, {}) for m in tm]


def _to_torch(ga):
    return TP.graph_arrays_from_numpy(_fields(ga), device="cpu")


def _lane(targets, i):
    return jax.tree.map(lambda x: x[i], targets)


def _cohort_draws(key, cfg, template, targets):
    """The draws JAX's register_cohort makes from ``key``, as the port's
    ``make_cohort_draws`` gives them."""
    batch = targets.points.shape[0]
    keys = jax.random.split(key, batch)
    tk = jax.random.fold_in(key, batch)
    solver = TP.pipeline._solver(TCFG, template.n_points)
    block = (_eig_block(tk, template.n_points, cfg) if solver == "wide"
             else _solve_start(tk, template.n_points, cfg, solver))
    return {"pairs": [_jax_draws(keys[i], cfg, _lane(targets, i), template)
                      for i in range(batch)],
            "template_block": block}


def _block_key(block) -> str:
    a = block.detach().cpu().numpy() if torch.is_tensor(block) else np.asarray(block)
    return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()).hexdigest()


def _sign_refs(draws, jax_results):
    """{a lane's target-solve start: JAX's eigenvectors of that solve}."""
    return {_block_key(d["eig_start_target"]): np.array(jax_results["eig_vecs_target"][i])
            for i, d in enumerate(draws["pairs"])}


@contextlib.contextmanager
def jax_target_signs(refs):
    """The port's solves whose start is a key of ``refs`` return their
    columns with the signs of JAX's (see the module docstring)."""
    orig = TP.pipeline._spectrum

    def spectrum(graph, k, cfg, init_block, *args, **kw):
        out = orig(graph, k, cfg, init_block, *args, **kw)
        ref = None if init_block is None else refs.get(_block_key(init_block))
        if ref is None:
            return out
        vecs = out[1]
        sign = torch.where((vecs * torch.as_tensor(ref)).sum(dim=0) < 0, -1.0, 1.0)
        return (out[0], vecs * sign, *out[2:])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP.pipeline, "_spectrum", spectrum)
        yield


def _np(res):
    return {k: np.asarray(v) for k, v in res.items()}


def _check_points(want, got, median=1e-3):
    d = np.linalg.norm(np.asarray(want) - got.numpy(), axis=-1)
    assert np.median(d) <= median and d.mean() <= 0.1, (np.median(d), d.mean())


# ------------------------------------------------------------- padding


@pytest.fixture(scope="module")
def padded(meshes):
    tm, jm = meshes
    return TP.pad_cohort(tm[1:], device="cpu"), JC.pad_cohort(jm[1:])


def test_pad_cohort_matches_jax(padded, meshes):
    tg, jg = padded
    assert [int(g.valid_mask.sum()) for g in tg] == [642, 581, 594]
    for t, j in zip(tg, jg):
        for name, arr in _fields(j).items():
            np.testing.assert_array_equal(getattr(t, name).numpy(), arr, err_msg=name)
    stacked, jstacked = TP.stack_graph_arrays(tg), JC.stack_graph_arrays(jg)
    for name, arr in _fields(jstacked).items():
        np.testing.assert_array_equal(getattr(stacked, name).numpy(), arr, err_msg=name)


def _pad_case(case):
    """(points, triangles, pad kwargs) of one padding case."""
    if case == "hub":
        pts, tris = _hub_mesh()
        return pts, tris, dict(pad_n_points=40, pad_degree=32, pad_components=3,
                               pad_overflow=20)
    m = chip_smoke.synthetic_bone(TP, 1, 2)  # 162 vertices
    return m.points, m.triangles, {
        "rows": dict(pad_n_points=200),
        "all": dict(pad_n_points=170, pad_degree=9, pad_components=2, pad_overflow=4),
    }[case]


@pytest.mark.parametrize("case", ["rows", "all", "hub"])
@pytest.mark.parametrize("reuse_topology", [False, True])
def test_padded_mesh_to_graph_arrays_matches_jax(case, reuse_topology):
    pts, tris, kw = _pad_case(case)
    feats = np.linspace(0.0, 1.0, len(pts), dtype=np.float32)
    jtopo = ttopo = None
    if reuse_topology:
        from pyfocusr_tpu.mesh import build_topology as jbuild

        jtopo, ttopo = jbuild(np.asarray(tris), len(pts)), TP.build_topology(tris, len(pts))
    want = JP.mesh_to_graph_arrays(JTriMesh(pts, tris), node_features=feats,
                                   topology=jtopo, patch_blocks=False, **kw)
    got = TP.mesh_to_graph_arrays(TP.TriMesh(pts, tris), node_features=feats,
                                  device="cpu", topology=ttopo, **kw)
    for name, arr in _fields(want).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), arr, err_msg=name)
    assert int(got.valid_mask.sum()) == len(pts)
    assert TP.pipeline._graph_fingerprint(got) == JP._graph_fingerprint(want)


def test_padded_mesh_to_graph_arrays_rejects_a_narrower_degree():
    m = chip_smoke.synthetic_bone(TP, 1, 2)
    topo = TP.build_topology(m.triangles, m.n_points)
    with pytest.raises(ValueError, match="narrower than the provided"):
        TP.mesh_to_graph_arrays(m, device="cpu", topology=topo,
                                pad_degree=topo.max_degree - 1)


def test_make_draws_takes_real_rows_only():
    """A padded side's index draws take its real rows; unpadded sides and
    the ``eig_*`` draws are those of the unpadded call."""
    cfg = TP.PipelineConfig(n_coords_spectral_ordering=500, icp_n_landmarks=300)
    plain = TP.make_draws(0, cfg, 2562, 2700)
    same = TP.make_draws(0, cfg, 2562, 2700, real_target=2562, real_source=2700)
    for k in plain:
        np.testing.assert_array_equal(plain[k], same[k])
    padded = TP.make_draws(0, cfg, 2562, 2700, real_target=1500, real_source=1800)
    assert padded.keys() == plain.keys()
    for k, real in (("icp_landmarks", 1800), ("eigsort_target", 1500),
                    ("eigsort_source", 1800), ("cpd_source", 1800), ("cpd_target", 1500)):
        assert padded[k].shape == plain[k].shape and padded[k].max() < real, k
        assert len(np.unique(padded[k])) == len(padded[k]), k
    assert padded["eig_block_target"].shape == (2562, cfg.eig_wide_block)
    # A subsample of exactly the real count takes every real row (JAX draws
    # them in a random order too).
    every = TP.make_draws(0, TP.PipelineConfig(n_coords_spectral_ordering=600,
                                               n_coords_spectral_registration=600),
                          2562, 2700, real_target=600)
    np.testing.assert_array_equal(np.sort(every["eigsort_target"]), np.arange(600))


# ------------------------------------------------------------- register_cohort


@pytest.fixture(scope="module")
def cohort_runs(meshes, padded):
    tm, jm = meshes
    tg, jg = padded
    template = JP.mesh_to_graph_arrays(jm[0], patch_blocks=False)
    targets = JC.stack_graph_arrays(jg)
    want, want_mean = JC.register_cohort(template, targets, JCFG, KEY)
    want = _np(want)
    draws = _cohort_draws(KEY, JCFG, template, targets)
    ttemplate, ttargets = _to_torch(template), TP.stack_graph_arrays(tg)
    with jax_target_signs(_sign_refs(draws, want)):
        got, got_mean = TP.register_cohort(ttemplate, ttargets, TCFG, draws=draws)
    return dict(want=want, want_mean=np.asarray(want_mean), got=got, got_mean=got_mean,
                draws=draws, template=ttemplate, targets=ttargets)


@pytest.mark.parametrize("lane", [0, 1, 2])
def test_register_cohort_matches_jax_per_lane(cohort_runs, lane):
    r = cohort_runs
    want = {k: v[lane] for k, v in r["want"].items()}
    got = {k: v[lane] for k, v in r["got"].items()}
    g = _check_slice(want, got)
    # Padding rows of the template are none here; the lane's outputs are
    # the template's rows, and every correspondence is a real target row.
    real = int(r["targets"].valid_mask[lane].sum())
    assert g["correspondences"].max() < real
    assert np.all(g["eig_vecs_target"][real:] == 0)


def test_register_cohort_mean_shape_matches_jax(cohort_runs):
    r = cohort_runs
    assert r["got_mean"].shape == (642, 3)
    _check_points(r["want_mean"], r["got_mean"])
    torch.testing.assert_close(r["got_mean"], r["got"]["weighted_points"].mean(dim=0))


def test_register_cohort_lanes_equal_their_pairs(cohort_runs):
    """Each lane is ``register_pair_prepared_source`` of its subject on its
    draws, bit for bit (the port loops where JAX vmaps)."""
    r = cohort_runs
    with jax_target_signs(_sign_refs(r["draws"], r["want"])):
        prep = TP.prepare_source(r["template"], TCFG, r["draws"]["template_block"])
        for i in range(3):
            lane = TC._lane(r["targets"], i)
            res = TP.register_pair_prepared_source(prep, lane, r["template"], TCFG,
                                                   draws=r["draws"]["pairs"][i])
            for k, v in res.items():
                assert torch.equal(v, r["got"][k][i]), (i, k)


def test_register_cohort_without_the_hoist_matches_jax(meshes, padded):
    """``prepared_template=False`` solves the template in every pair."""
    _, jm = meshes
    tg, jg = padded
    template = JP.mesh_to_graph_arrays(jm[0], patch_blocks=False)
    targets = JC.stack_graph_arrays(jg)
    want, want_mean = JC.register_cohort(template, targets, JCFG, KEY,
                                         prepared_template=False)
    want = _np(want)
    draws = _cohort_draws(KEY, JCFG, template, targets)
    with jax_target_signs(_sign_refs(draws, want)):
        got, got_mean = TP.register_cohort(_to_torch(template), TP.stack_graph_arrays(tg),
                                           TCFG, draws=draws, prepared_template=False)
    for i in range(3):
        _check_slice({k: v[i] for k, v in want.items()}, {k: v[i] for k, v in got.items()})
    _check_points(want_mean, got_mean)


def test_make_cohort_draws_and_generator(cohort_runs):
    """Draws from a generator are reproducible and index real rows."""
    r = cohort_runs
    d = TP.make_cohort_draws(7, TCFG, r["template"], r["targets"])
    assert len(d["pairs"]) == 3
    assert d["template_block"].shape == (642, TCFG.n_total + 8)
    for i, real in enumerate((642, 581, 594)):
        for k in ("eigsort_target", "cpd_target"):
            assert d["pairs"][i][k].max() < real
    a, _ = TP.register_cohort(r["template"], r["targets"], TCFG,
                              generator=torch.Generator().manual_seed(3))
    b, _ = TP.register_cohort(r["template"], r["targets"], TCFG,
                              generator=torch.Generator().manual_seed(3))
    assert torch.equal(a["correspondences"], b["correspondences"])


# ------------------------------------------------------------- iterate_template


class _Recorder:
    """Records each round's key and results inside JAX's iterate_template."""

    def __init__(self):
        self.rounds = []
        self.orig = JC.register_cohort

    def __call__(self, template, targets, cfg, key, device_mesh=None,
                 prepared_template=None):
        out = self.orig(template, targets, cfg, key, device_mesh, prepared_template)
        self.rounds.append((template, targets, key, _np(out[0])))
        return out


@pytest.fixture(scope="module")
def template_runs(meshes, tmp_path_factory):
    """Both packages' ``iterate_template`` over all four meshes padded to
    642, the template seeded from the 581-vertex one (padded), two rounds
    with Procrustes, each round's files in its own directory."""
    tm, jm = meshes
    jg = JC.pad_cohort(jm)
    tg = TP.pad_cohort(tm, device="cpu")
    dirs = [tmp_path_factory.mktemp(name) for name in ("jax", "port")]
    rec = _Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "register_cohort", rec)
        want_t, want_res, want_m = JC.iterate_template(
            jg[2], JC.stack_graph_arrays(jg), JCFG, KEY, n_iterations=2,
            checkpoint_dir=str(dirs[0]))
    draws, refs = [], {}
    for template, targets, key, res in rec.rounds:
        d = _cohort_draws(key, JCFG, template, targets)
        draws.append(d)
        refs.update(_sign_refs(d, res))
    with jax_target_signs(refs):
        got_t, got_res, got_m = TP.iterate_template(
            tg[2], TP.stack_graph_arrays(tg), TCFG, n_iterations=2,
            checkpoint_dir=str(dirs[1]), draws=draws)
    return dict(want=(want_t, _np(want_res), want_m), got=(got_t, got_res, got_m),
                dirs=dirs, rounds=rec.rounds, tg=tg)


def test_iterate_template_matches_jax(template_runs):
    (want_t, want_res, want_m), (got_t, got_res, got_m) = (template_runs["want"],
                                                           template_runs["got"])
    assert len(got_m) == len(want_m) == 2
    np.testing.assert_allclose(got_m, want_m, rtol=2e-2)
    _check_points(want_t.points, got_t.points, median=0.02)
    # Padding rows keep their points (zeros); the mask is unchanged.
    real = int(got_t.valid_mask.sum())
    assert real == 581 and torch.all(got_t.points[real:] == 0)
    for i in range(4):
        _check_slice({k: v[i] for k, v in want_res.items()},
                     {k: v[i] for k, v in got_res.items()})


def test_iterate_template_rounds_match_jax(template_runs):
    """Round 1's template (before Procrustes moves it again) and the
    checkpoint files: the same names and keys, points and motions as JAX's
    within the gates."""
    jdir, tdir = template_runs["dirs"]
    jfiles = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == jfiles == [
        "template_round_001.npz", "template_round_002.npz"]
    for name in jfiles:
        with np.load(jdir / name) as a, np.load(tdir / name) as b:
            assert sorted(a.files) == sorted(b.files) == ["motion", "points"]
            assert b["points"].dtype == a["points"].dtype == np.float32
            _check_points(a["points"], torch.as_tensor(b["points"]), median=0.02)
            np.testing.assert_allclose(b["motion"], a["motion"], rtol=2e-2)
    # Round 2's template went into JAX's second register_cohort.
    _check_points(template_runs["rounds"][1][0].points,
                  torch.as_tensor(np.load(tdir / jfiles[0])["points"]), median=0.02)


def test_iterate_template_procrustes_step_matches_jax(template_runs):
    """The Procrustes close on one input: the same rigid map in both
    packages (f64-rounded close against JAX's f32 SVD: atol 1e-4 mm)."""
    from pyfocusr_tpu.ops.icp import apply_rigid as japply, umeyama as jumeyama

    template = template_runs["tg"][2]
    mean_shape = template_runs["got"][1]["weighted_points"].mean(dim=0)
    want = japply(jnp.asarray(mean_shape.numpy()), *jumeyama(
        jnp.asarray(mean_shape.numpy()), jnp.asarray(template.points.numpy()),
        with_scale=False, weights=jnp.asarray(template.valid_mask.numpy())))
    s, R, t = TC.umeyama(mean_shape, template.points, with_scale=False,
                         weights=template.valid_mask)
    assert float(s) == 1.0
    np.testing.assert_allclose(TC.apply_rigid(mean_shape, s, R, t).numpy(),
                               np.asarray(want), atol=1e-4)


def test_iterate_template_tolerance_stops_early(cohort_runs):
    r = cohort_runs
    _, _, motions = TP.iterate_template(
        r["template"], r["targets"], TCFG, n_iterations=5, tolerance=1e9,
        draws=[r["draws"]] * 5)
    assert len(motions) == 1


@pytest.fixture(scope="module")
def ssm_runs(meshes):
    """``build_ssm_template`` in both packages: one round over the four
    meshes, the template from the first."""
    tm, jm = meshes
    rec = _Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "register_cohort", rec)
        want = JC.build_ssm_template(jm, JCFG, KEY, n_iterations=1)
    (template, targets, key, res), = rec.rounds
    draws = _cohort_draws(key, JCFG, template, targets)
    with jax_target_signs(_sign_refs(draws, res)):
        got = TP.build_ssm_template(tm, TCFG, n_iterations=1, draws=[draws], device="cpu")
    return want, got


def test_build_ssm_template_matches_jax(ssm_runs):
    (wmesh, wres, wm), (gmesh, gres, gm) = ssm_runs
    assert isinstance(gmesh, TP.TriMesh) and gmesh.n_points == wmesh.n_points == 642
    np.testing.assert_array_equal(gmesh.triangles, np.asarray(wmesh.triangles))
    _check_points(wmesh.points, torch.as_tensor(gmesh.points), median=0.02)
    np.testing.assert_allclose(gm, wm, rtol=2e-2)
    assert gres["weighted_points"].shape == (4, 642, 3)


# ------------------------------------------------------------- the SSM


def _planted(seed=0, N=300, B=12):
    """Shapes with two planted orthogonal displacement modes
    (``tests/test_cohort.py:179-206``)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(N, 3)).astype(np.float32)
    U1 = rng.normal(size=(N, 3)); U1 /= np.linalg.norm(U1)
    U2 = rng.normal(size=(N, 3)); U2 -= U1 * np.sum(U1 * U2); U2 /= np.linalg.norm(U2)
    c1 = rng.normal(scale=2.0, size=B)
    c2 = rng.normal(scale=0.5, size=B)
    return (base[None] + c1[:, None, None] * U1[None]
            + c2[:, None, None] * U2[None]).astype(np.float32)


def _check_modes(want, got, n_check):
    wmean, wmodes, wvar = (np.asarray(x) for x in want)
    gmean, gmodes, gvar = (x.numpy() for x in got)
    np.testing.assert_allclose(gmean, wmean, atol=1e-5)
    assert gmodes.shape == wmodes.shape and gvar.shape == wvar.shape
    np.testing.assert_allclose(gvar[:n_check], wvar[:n_check], rtol=1e-4)
    for i in range(n_check):
        cos = abs(np.sum(gmodes[i] * wmodes[i]))
        assert cos >= 0.9999, (i, cos)
    # Modes at the noise floor are zeroed in both.
    np.testing.assert_array_equal(np.abs(gmodes[n_check:]).sum(axis=(1, 2)) == 0,
                                  np.abs(wmodes[n_check:]).sum(axis=(1, 2)) == 0)


@pytest.mark.parametrize("n_modes", [None, 2])
def test_cohort_shape_modes_matches_jax_on_planted_modes(n_modes):
    shapes = _planted()
    want = JC.cohort_shape_modes(shapes, n_modes=n_modes)
    got = TP.cohort_shape_modes(shapes, n_modes=n_modes, device="cpu")
    _check_modes(want, got, 2)


def test_cohort_shape_modes_matches_jax_on_the_cohort(template_runs):
    """PCA of the port's corresponded cohort in both packages: with four
    subjects, three modes carry variance."""
    wp = template_runs["got"][1]["weighted_points"][:, :581]
    want = JC.cohort_shape_modes(wp.numpy())
    got = TP.cohort_shape_modes(wp)
    _check_modes(want, got, 3)


def _basis(n=200, m=3, seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(n, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(m, n * 3)).T)
    return mean, q.T.reshape(m, n, 3).astype(np.float32), np.array([4.0, 1.0, 0.25],
                                                                    np.float32)


@pytest.mark.parametrize("kw", [{}, dict(variances=True), dict(n_modes=2)])
def test_ssm_project_matches_jax(kw):
    mean, modes, variances = _basis()
    rng = np.random.default_rng(3)
    subject = (mean + np.tensordot(np.array([1.3, -0.7, 0.4], np.float32), modes, 1)
               + 0.05 * rng.normal(size=mean.shape)).astype(np.float32)
    kw = dict(kw, variances=variances) if kw.get("variances") else kw
    want = JC.ssm_project(subject, mean, modes, **kw)
    got = TP.ssm_project(subject, mean, modes, device="cpu", **kw)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("b", [[2.0, -1.0, 0.5], [[2.0, -1.0, 0.5], [0.0, 1.0, -3.0]]])
def test_ssm_sample_matches_jax(b):
    mean, modes, variances = _basis()
    want = JC.ssm_sample(mean, modes, variances, b=np.asarray(b, np.float32))
    got = TP.ssm_sample(mean, modes, variances, b=np.asarray(b, np.float32), device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_ssm_sample_from_a_generator_is_clipped_and_reproducible():
    mean, modes, variances = _basis()
    kw = dict(n_samples=16, clip_std=2.0, device="cpu")
    a = TP.ssm_sample(mean, modes, variances, generator=torch.Generator().manual_seed(0), **kw)
    b = TP.ssm_sample(mean, modes, variances, generator=torch.Generator().manual_seed(0), **kw)
    assert a.shape == (16, 200, 3) and torch.equal(a, b)
    sd = np.sqrt(variances)
    for s in a:
        coeffs, _, _ = TP.ssm_project(s, mean, modes)
        assert np.all(np.abs(coeffs.numpy()) <= 2.0 * sd + 1e-4)


def _message(call):
    with pytest.raises(ValueError) as info:
        call()
    return str(info.value)


def test_ssm_sample_argument_errors_match_jax():
    mean, modes, variances = _basis()
    gen = torch.Generator().manual_seed(0)
    assert "exactly one" in _message(lambda: TP.ssm_sample(mean, modes, variances,
                                                           device="cpu"))
    assert "exactly one" in _message(lambda: TP.ssm_sample(
        mean, modes, variances, b=[1.0, 0.0, 0.0], generator=gen, device="cpu"))
    assert _message(lambda: TP.ssm_sample(mean, modes, variances, b=[1.0, 0.0],
                                          device="cpu")) == _message(
        lambda: JC.ssm_sample(mean, modes, variances, b=[1.0, 0.0]))


def test_fit_subject_to_ssm_matches_jax(meshes, ssm_runs):
    """A subject fitted to the SSM of the built template's cohort, in both
    packages from the same mean and modes and JAX's draws."""
    tm, jm = meshes
    (wmesh, wres, _), (gmesh, _, _) = ssm_runs
    mean, modes, _ = JC.cohort_shape_modes(np.asarray(wres["weighted_points"])[:, :642])
    mean, modes = np.asarray(mean), np.asarray(modes)
    key = jax.random.PRNGKey(7)
    want = JC.fit_subject_to_ssm(jm[1], wmesh, mean, modes, JCFG, key)
    tg = JP.mesh_to_graph_arrays(jm[1], patch_blocks=False)
    sg = JP.mesh_to_graph_arrays(wmesh, patch_blocks=False)
    ref = JP.register_pair(tg, sg, JCFG, key)
    draws = _jax_draws(key, JCFG, tg, sg)
    with jax_target_signs({_block_key(draws["eig_start_target"]):
                           np.array(ref["eig_vecs_target"])}):
        got = TP.fit_subject_to_ssm(tm[1], TP.TriMesh(np.asarray(wmesh.points),
                                                      np.asarray(wmesh.triangles)),
                                    mean, modes, TCFG, draws=draws, device="cpu")
    scale = float(np.abs(np.asarray(want[0])).max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-2 * scale)
    _check_points(np.asarray(want[1]), got[1], median=0.05)
    assert abs(float(got[2]) - float(want[2])) <= 2e-2 * float(want[2])


def test_cohort_mean_shape_matches_jax(meshes, cohort_runs):
    tm, jm = meshes
    r = cohort_runs
    want = JC.cohort_mean_shape(jm[0], r["want_mean"])
    got = TP.cohort_mean_shape(tm[0], r["got_mean"])
    assert isinstance(got, TP.TriMesh)
    np.testing.assert_array_equal(got.triangles, np.asarray(want.triangles))
    _check_points(np.asarray(want.points), got.points)


def test_all_pairs_surface_errors_matches_jax(meshes):
    tm, jm = meshes
    want = JC.all_pairs_surface_errors(jm[1:])
    got = TP.all_pairs_surface_errors(tm[1:], device="cpu")
    assert got.shape == (3, 3) and got.dtype == np.float64
    assert np.all(np.diag(got) == 0) and np.all(got[~np.eye(3, dtype=bool)] > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------- guards


@pytest.mark.parametrize("case", ["subsample", "icp_landmarks", "hungarian",
                                  "hungarian_unpadded", "fits"])
def test_check_cohort_config_matches_jax(case):
    kw, args = {
        "subsample": (dict(n_coords_spectral_ordering=10**6), (5000, None)),
        "icp_landmarks": (dict(icp_n_landmarks=2000), (600, 642)),
        "hungarian": (dict(initial_correspondence_type="hungarian",
                           icp_n_landmarks=64), (600, 642)),
        "hungarian_unpadded": (dict(final_correspondence_type="hungarian",
                                    n_coords_spectral_ordering=600,
                                    n_coords_spectral_registration=600), (642, 642)),
        "fits": (dict(icp_n_landmarks=2000), (5000, 5000)),
    }[case]
    jcall = lambda: JC.check_cohort_config(args[0], JP.PipelineConfig(**kw), args[1])
    tcall = lambda: TP.check_cohort_config(args[0], TP.PipelineConfig(**kw), args[1])
    if case in ("hungarian_unpadded", "fits"):
        assert jcall() is None and tcall() is None
    else:
        assert _message(tcall) == _message(jcall)


def _guard_cases(meshes):
    """(name, JAX call, port call) of each guard of tests/test_cohort.py
    (:231, :552, :629) and of the per-pair padding guards."""
    tm, jm = meshes
    jt = JP.mesh_to_graph_arrays(jm[0], patch_blocks=False)
    tt = _to_torch(jt)
    jpad, tpad = JC.pad_cohort(jm[1:]), TP.pad_cohort(tm[1:], device="cpu")
    js, ts = JC.stack_graph_arrays(jpad), TP.stack_graph_arrays(tpad)
    small = dict(n_coords_spectral_ordering=64, n_coords_spectral_registration=64,
                 icp_n_landmarks=64, non_rigid_max_iterations=2,
                 graph_smoothing_iterations=2, projection_smooth_iterations=1)
    cfgs = {
        "subsample": dict(n_coords_spectral_ordering=10**6),
        "hungarian_padded": dict(small, initial_correspondence_type="hungarian"),
        "icp_landmarks_padded": dict(small, icp_n_landmarks=2000),
        "prepared_template": dict(KW, icp_registration_mode="similarity"),
    }
    out = []
    for name, kw in cfgs.items():
        jc, tc = JP.PipelineConfig(**kw), TP.PipelineConfig(**kw)
        extra = {"prepared_template": True} if name == "prepared_template" else {}
        out.append((name, lambda jc=jc, extra=extra: JC.register_cohort(
            jt, js, jc, KEY, **extra),
            lambda tc=tc, extra=extra: TP.register_cohort(tt, ts, tc, **extra)))
    # The pair guards on one padded lane.
    for name, kw in (("pair_hungarian", dict(small, final_correspondence_type="hungarian")),
                     ("pair_subsample", dict(small, n_coords_spectral_registration=600))):
        jc, tc = JP.PipelineConfig(**kw), TP.PipelineConfig(**kw)
        out.append((name, lambda jc=jc: JP.register_pair(_lane(js, 1), jt, jc, KEY),
                    lambda tc=tc: TP.register_pair(TC._lane(ts, 1), tt, tc)))
    return out


@pytest.mark.parametrize("which", range(6))
def test_cohort_and_padding_guards_match_jax(meshes, which):
    name, jcall, tcall = _guard_cases(meshes)[which]
    assert _message(tcall) == _message(jcall), name


@pytest.mark.parametrize("call", ["register_cohort", "iterate_template",
                                  "build_ssm_template"])
def test_device_mesh_raises_naming_item_9(meshes, call):
    tm, _ = meshes
    tg = TP.pad_cohort(tm[1:], device="cpu")
    stacked = TP.stack_graph_arrays(tg)
    run = {
        "register_cohort": lambda: TP.register_cohort(tg[0], stacked, TCFG,
                                                      device_mesh=object()),
        "iterate_template": lambda: TP.iterate_template(tg[0], stacked, TCFG,
                                                        device_mesh=object()),
        "build_ssm_template": lambda: TP.build_ssm_template(tm, TCFG, device_mesh=object(),
                                                            device="cpu"),
    }[call]
    with pytest.raises(NotImplementedError, match=f"{call}.*item 9"):
        run()


def test_cohort_functions_take_jax_arguments():
    """Each public function of the JAX module has its counterpart, with
    JAX's parameters in JAX's order; ``key`` becomes ``generator`` and the
    port appends only ``draws`` and ``device``."""
    import inspect

    for name in JC.__all__:
        want = list(inspect.signature(getattr(JC, name)).parameters)
        got = list(inspect.signature(getattr(TC, name)).parameters)
        want = ["generator" if p == "key" else p for p in want]
        assert got[:len(want)] == want, name
        assert set(got[len(want):]) <= {"draws", "device"}, name
        assert getattr(TP, name) is getattr(TC, name)
