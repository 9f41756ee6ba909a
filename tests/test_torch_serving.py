"""Port parity for template serving: ``prepare_target`` /
``register_pair_prepared``, ``prepare_source`` /
``register_pair_prepared_source``, the class-template ``warm_block``,
prepared-state save / load across the two packages, the fingerprints and
the serving errors, on the 2562-vertex synthetic bone pair
(``mesh_5k_target`` / ``mesh_5k_source``) with the short schedules of
``tests/test_torch_pipeline.py`` (``FAST``).

JAX runs each entry point with ``PRNGKey(0)`` and prepares from the key
split its ``register_pair`` would use (``split(key, 8)[0]`` for the target,
``[1]`` for the source); the port is given the draws JAX made, rebuilt from
those splits (``_jax_draws``, ``_eig_block``).  Gates against JAX are those
of ``tests/test_torch_pipeline.py`` (``_check_slice``: eigenvalues rtol
1e-4, |cos| >= 0.9999, >= 95% equal correspondences, unique fraction
within 0.02, final locations to f32 noise where the correspondences
agree).  Within the port the prepared paths equal ``register_pair`` bit for
bit on the CPU, as the JAX package's own tests hold its prepared paths
(tests/test_pipeline.py:406-419, :484-507).
"""

import jax
import numpy as np
import pytest
import torch

from pyfocusr_tpu import pipeline as JP
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
from test_torch_pipeline import (FAST, _check_slice, _check_spectra, _eig_block,
                                 _fields, _jax_draws)
import pyfocusr_tpu_torch as TP

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
# No ICP and no cross-mesh warm start: the configuration under which a
# prepared source replaces exactly what register_pair computes.
SOURCE_FAST = dict(FAST, icp_register_first=False, eig_warm_start=False)


def _np(res):
    return {k: np.asarray(v) for k, v in res.items()}


def _to_torch(ga):
    return TP.graph_arrays_from_numpy(_fields(ga), device="cpu")


def _assert_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def graphs(mesh_5k_target, mesh_5k_source):
    """(JAX target, JAX source, port target, port source)."""
    tg = JP.mesh_to_graph_arrays(mesh_5k_target, patch_blocks=False)
    sg = JP.mesh_to_graph_arrays(mesh_5k_source, patch_blocks=False)
    return tg, sg, _to_torch(tg), _to_torch(sg)


@pytest.fixture(scope="module")
def prepared_target(graphs):
    """Both packages' prepared target and the pair served from it."""
    tg, sg, ttg, tsg = graphs
    jcfg = JP.PipelineConfig(**FAST)
    tcfg = TP.PipelineConfig(**FAST)
    jprep = JP.prepare_target(tg, jcfg, jax.random.split(KEY, 8)[0])
    want = _np(JP.register_pair_prepared(jprep, tg, sg, jcfg, KEY))
    draws = _jax_draws(KEY, jcfg, tg, sg)
    tprep = TP.prepare_target(ttg, tcfg, draws["eig_block_target"])
    got = TP.register_pair_prepared(tprep, ttg, tsg, tcfg, draws=draws)
    return dict(jcfg=jcfg, tcfg=tcfg, jprep=jprep, tprep=tprep, want=want,
                got=got, draws=draws)


def test_prepared_target_matches_jax(prepared_target):
    p = prepared_target
    _check_slice(p["want"], p["got"])
    np.testing.assert_allclose(p["tprep"]["smoothed_points"].numpy(),
                               np.asarray(p["jprep"]["smoothed_points"]),
                               rtol=0, atol=1e-3)
    assert p["tprep"]["block"].shape == p["jprep"]["block"].shape


def test_prepared_target_equals_register_pair(graphs, prepared_target):
    """The port's exactness contract: the prepared state replaces the very
    values register_pair computes, so the outputs are equal bit for bit."""
    _, _, ttg, tsg = graphs
    p = prepared_target
    ref = TP.register_pair(ttg, tsg, p["tcfg"], draws=p["draws"])
    _assert_equal(ref, p["got"])


@pytest.fixture(scope="module")
def prepared_source(graphs):
    tg, sg, ttg, tsg = graphs
    jcfg = JP.PipelineConfig(**SOURCE_FAST)
    tcfg = TP.PipelineConfig(**SOURCE_FAST)
    jprep = JP.prepare_source(sg, jcfg, jax.random.split(KEY, 8)[1])
    want = _np(JP.register_pair_prepared_source(jprep, tg, sg, jcfg, KEY))
    draws = _jax_draws(KEY, jcfg, tg, sg)
    tprep = TP.prepare_source(tsg, tcfg, draws["eig_block_source"])
    got = TP.register_pair_prepared_source(tprep, ttg, tsg, tcfg, draws=draws)
    return tcfg, draws, want, got


def test_prepared_source_matches_jax(prepared_source):
    _, _, want, got = prepared_source
    _check_slice(want, got)


def test_prepared_source_equals_register_pair(graphs, prepared_source):
    _, _, ttg, tsg = graphs
    tcfg, draws, _, got = prepared_source
    _assert_equal(TP.register_pair(ttg, tsg, tcfg, draws=draws), got)


def test_prepared_source_keeps_its_block_and_seeds_the_target(graphs):
    """With the warm start on, prepare_source keeps the filtered block and
    the pair's target solve starts from it (the truncated schedule); the
    pair reads no ``eig_block_source`` (make_draws gives it on request)."""
    from pyfocusr_tpu_torch.ops import eigen

    _, _, ttg, tsg = graphs
    cfg = TP.PipelineConfig(**dict(FAST, icp_register_first=False))
    draws = TP.make_draws(0, cfg, ttg.n_points, tsg.n_points, source_block=True)
    plain = TP.make_draws(0, cfg, ttg.n_points, tsg.n_points)
    assert set(draws) - set(plain) == {"eig_block_source"}
    for k in plain:
        np.testing.assert_array_equal(draws[k], plain[k])
    prep = TP.prepare_source(tsg, cfg, draws["eig_block_source"])
    assert prep["block"].shape == (tsg.n_points, cfg.eig_wide_block)
    eigen.SOLVES.clear()
    out = TP.register_pair_prepared_source(prep, ttg, tsg, cfg, draws=plain)
    (solve,) = eigen.SOLVES
    assert solve["warm"] and solve["chunks"] >= cfg.eig_wide_chunks_warm
    ref = TP.register_pair(ttg, tsg, cfg, draws=plain)
    agree = (out["correspondences"] == ref["correspondences"]).float().mean()
    assert agree >= 0.9, agree


@pytest.fixture(scope="module")
def template(mesh_5k_target):
    """A third mesh of the class (seed 3), both packages' graphs."""
    from conftest import _synthetic_bone

    jt = JP.mesh_to_graph_arrays(_synthetic_bone(3), patch_blocks=False)
    return jt, _to_torch(jt)


def test_class_template_warm_block_matches_jax(graphs, template, prepared_target):
    tg, sg, ttg, tsg = graphs
    jt, tt = template
    p = prepared_target
    key5 = jax.random.PRNGKey(5)
    jwb = JP.warm_block_from_prepared(JP.prepare_target(jt, p["jcfg"], key5), jt)
    want = _np(JP.register_pair(tg, sg, p["jcfg"], KEY, warm_block=jwb))
    tprep = TP.prepare_target(tt, p["tcfg"], _eig_block(key5, tt.n_points, p["tcfg"]))
    twb = TP.warm_block_from_prepared(tprep, tt)
    got = TP.register_pair(ttg, tsg, p["tcfg"], draws=p["draws"], warm_block=twb)
    _check_slice(want, got)


def _check_state_served(want, got):
    """A registration served from one package's prepared state against one
    served from another state or by the other package: the spectra gates
    and the final locations of ``_check_slice``, and >= 90% equal
    correspondences.  The share is looser than the 95% of a whole run
    because the pair's near-degenerate modes 2 and 3 turn with the target
    state's f32 noise and ~5% of nearest neighbours in the spectral cloud
    follow them (measured: the port serving the JAX state against JAX
    serving it 95.3%, against the port serving its own state 94.9%; the
    port against JAX, each on its own state, 99.6%)."""
    g = {k: np.asarray(v) for k, v in got.items()}
    _check_spectra(want, g)
    agree = (g["correspondences"] == want["correspondences"]).mean()
    assert agree >= 0.9, agree
    n = len(want["correspondences"])
    uw, ug = (len(np.unique(r["correspondences"])) / n for r in (want, g))
    assert abs(uw - ug) <= 0.02, (uw, ug)
    dw = np.linalg.norm(g["weighted_points"] - want["weighted_points"], axis=1)
    assert np.median(dw) <= 1e-3 and dw.mean() <= 0.1, (np.median(dw), dw.mean())


def test_jax_saved_template_serves_in_the_port(tmp_path, graphs, prepared_target):
    """A template prepared and saved by the JAX package, fingerprints
    embedded, loads in the port with both checks active: the loaded state
    is the JAX state bit for bit and serves what JAX serves from it."""
    tg, sg, ttg, tsg = graphs
    p = prepared_target
    path = str(tmp_path / "jax_template.npz")
    JP.save_prepared_target(path, p["jprep"], p["jcfg"], tg)
    back = TP.load_prepared_target(path, p["tcfg"], ttg, device="cpu")
    assert set(back) == set(p["tprep"]) | {"warm_points", "warm_valid_mask"}
    assert back["w"][1].dtype == torch.int64
    for name in ("lams", "vecs", "smoothed_points", "block"):
        np.testing.assert_array_equal(back[name].numpy(), np.asarray(p["jprep"][name]))
    for got_w, want_w in zip(back["w"], p["jprep"]["w"]):
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    got = TP.register_pair_prepared(back, ttg, tsg, p["tcfg"], draws=p["draws"])
    _check_state_served(p["want"], got)
    _check_state_served(_np(p["got"]), got)


def test_port_saved_template_serves_in_jax(tmp_path, graphs, prepared_target):
    """The reverse: a port save loads in JAX with both checks active, as the
    port's state bit for bit, and JAX serves from it what the port does."""
    tg, sg, ttg, _ = graphs
    p = prepared_target
    path = str(tmp_path / "port_template.npz")
    TP.save_prepared_target(path, p["tprep"], p["tcfg"], ttg)
    back = JP.load_prepared_target(path, p["jcfg"], tg)
    assert np.asarray(back["w"][1]).dtype == np.int32
    for name in ("lams", "vecs", "smoothed_points", "block"):
        np.testing.assert_array_equal(np.asarray(back[name]), p["tprep"][name].numpy())
    # The JAX state's own structure, so the compiled program is reused.
    state = {k: v for k, v in back.items() if not k.startswith("warm_")}
    got = JP.register_pair_prepared(state, tg, sg, p["jcfg"], KEY)
    _check_state_served(_np(p["got"]), _np(got))
    # The embedded geometry gives the class-template seed without the mesh.
    wb = TP.warm_block_from_prepared(TP.load_prepared_target(path, device="cpu"))
    np.testing.assert_array_equal(wb["points"].numpy(), ttg.points.numpy())


def test_save_results_writes_the_jax_layout(tmp_path):
    from pyfocusr_tpu.utils import checkpoint as JC
    from pyfocusr_tpu_torch.utils import checkpoint as TC

    tree = {"lams": np.arange(3, dtype=np.float32),
            "w": (np.ones((4, 2), np.float32), np.zeros((1, 2), np.int32)),
            "block": torch.ones(4, 5), "nested": {"b": [np.ones(2)], "a": np.zeros(1)}}
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JC.save_results(pj, jax.tree.map(np.asarray, tree))
    TC.save_results(pt, tree)
    with np.load(pj) as fj, np.load(pt) as ft:
        assert list(fj["__keys__"]) == list(ft["__keys__"])
    a, b = JC.load_results(pt), TC.load_results(pj)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _hub_mesh():
    """A fan of 30 triangles round one vertex: its degree exceeds the ELL
    cap of 24, so the graph carries overflow edges."""
    ang = np.linspace(0, 2 * np.pi, 30, endpoint=False)
    pts = np.concatenate([[[0, 0, 1]], np.stack([np.cos(ang), np.sin(ang),
                                                 np.zeros(30)], 1)]).astype(np.float32)
    tris = np.array([[0, 1 + i, 1 + (i + 1) % 30] for i in range(30)], np.int32)
    return pts, tris


@pytest.mark.parametrize("which", ["bone", "bone_features", "hub"])
def test_graph_fingerprint_matches_jax(mesh_5k_target, which):
    if which == "hub":
        pts, tris = _hub_mesh()
        feats = None
    else:
        pts, tris = np.asarray(mesh_5k_target.points), np.asarray(mesh_5k_target.triangles)
        feats = (mesh_5k_target.point_data["thickness_change_(mm)"]
                 if which == "bone_features" else None)
    jg = JP.mesh_to_graph_arrays(JTriMesh(pts, tris), node_features=feats,
                                 patch_blocks=False)
    tg = TP.mesh_to_graph_arrays(TP.TriMesh(pts, tris), node_features=feats,
                                 device="cpu")
    assert (tg.overflow.shape[0] > 0) == (which == "hub")
    assert TP.pipeline._graph_fingerprint(tg) == JP._graph_fingerprint(jg)


@pytest.mark.parametrize("kw", [
    {}, FAST, dict(feature_weights_diag=(1.0, 2.0), use_features_in_graph=True),
    dict(landmark_weight=3.0, eig_warm_start=False, non_rigid_beta=3.0),
])
def test_cfg_fingerprint_matches_jax(kw):
    jcfg, tcfg = JP.PipelineConfig(**kw), TP.PipelineConfig(**kw)
    assert TP.pipeline._cfg_fingerprint(tcfg) == JP._cfg_fingerprint(jcfg)
    # A full-repr fingerprint of an older save still matches.
    assert TP.pipeline._fingerprint_matches(repr(jcfg), tcfg)


def _message(call):
    with pytest.raises(ValueError) as info:
        call()
    return str(info.value)


def _moved_target(P):
    return P.PipelineConfig(icp_reg_target_to_source=True)


def _similarity(P):
    return P.PipelineConfig(icp_registration_mode="similarity")


# Each case: a function of (package, its target, its source, its prepared
# state, its registration call, the key JAX's entry points take as an
# argument, none for the port) -> a callable that must raise.
ERRORS = {
    "prepare_target_moving_target":
        lambda P, t, s, prep, reg, k: lambda: P.prepare_target(
            None, _moved_target(P), *k),
    "register_pair_prepared_moving_target":
        lambda P, t, s, prep, reg, k: lambda: P.register_pair_prepared(
            prep, t, s, _moved_target(P), *k),
    "prepare_source_similarity":
        lambda P, t, s, prep, reg, k: lambda: P.prepare_source(
            None, _similarity(P), *k),
    "register_pair_prepared_source_similarity":
        lambda P, t, s, prep, reg, k: lambda: P.register_pair_prepared_source(
            prep, t, s, _similarity(P), *k),
    "warm_block_missing_keys":
        lambda P, t, s, prep, reg, k: lambda: reg(warm_block={"points": t.points}),
    "warm_block_row_mismatch":
        lambda P, t, s, prep, reg, k: lambda: reg(warm_block={
            "points": t.points[:-1], "valid_mask": t.valid_mask[:-1],
            "block": prep["block"]}),
    "template_row_mismatch":
        lambda P, t, s, prep, reg, k: lambda: P.warm_block_from_prepared(
            {"block": prep["block"][:-1]}, t),
    "template_geometry_missing":
        lambda P, t, s, prep, reg, k: lambda: P.warm_block_from_prepared(prep),
    "no_filtered_block":
        lambda P, t, s, prep, reg, k: lambda: P.warm_block_from_prepared(
            {n: v for n, v in prep.items() if n != "block"}, t),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_serving_errors_match_jax(graphs, prepared_target, case):
    tg, sg, ttg, tsg = graphs
    p = prepared_target

    def jreg(**kw):
        return JP.register_pair(tg, sg, p["jcfg"], KEY, **kw)

    def treg(**kw):
        return TP.register_pair(ttg, tsg, p["tcfg"], draws=p["draws"], **kw)

    want = _message(ERRORS[case](JP, tg, sg, p["jprep"], jreg, (KEY,)))
    got = _message(ERRORS[case](TP, ttg, tsg, p["tprep"], treg, ()))
    assert got == want


@pytest.mark.parametrize("mismatch", ["cfg", "mesh"])
def test_load_fingerprint_errors_match_jax(tmp_path, graphs, prepared_target, mismatch):
    """A save of each package refuses, in both packages and with the same
    message, a config or a mesh other than the one it was prepared for."""
    tg, sg, ttg, tsg = graphs
    p = prepared_target
    other = dict(FAST, graph_smoothing_iterations=51)
    kw_j = ({"cfg": JP.PipelineConfig(**other)} if mismatch == "cfg" else {"target": sg})
    kw_t = ({"cfg": TP.PipelineConfig(**other)} if mismatch == "cfg" else {"target": tsg})
    for who, save in (("jax", lambda f: JP.save_prepared_target(f, p["jprep"], p["jcfg"], tg)),
                      ("port", lambda f: TP.save_prepared_target(f, p["tprep"], p["tcfg"], ttg))):
        path = str(tmp_path / f"{who}.npz")
        save(path)
        want = _message(lambda: JP.load_prepared_target(path, **kw_j))
        got = _message(lambda: TP.load_prepared_target(path, device="cpu", **kw_t))
        assert got == want, who


def test_load_prepared_target_builds_on_the_card_unless_asked(tmp_path,
                                                              prepared_target):
    path = str(tmp_path / "t.npz")
    TP.save_prepared_target(path, prepared_target["tprep"])
    if torch.cuda.is_available():
        assert TP.load_prepared_target(path)["vecs"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TP.load_prepared_target(path)
