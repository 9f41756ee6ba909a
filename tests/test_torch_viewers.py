"""The port's viewers: ``pyfocusr_tpu_torch.utils.html_viewer`` /
``utils.viz`` and the ``view_*`` / ``export_viewer_html`` methods of
``Focusr`` and ``Graph``, against ``pyfocusr_tpu``'s.

The cases of ``tests/test_html_viewer.py`` and ``tests/test_viewers.py``
(the latter with a stub ``itkwidgets``, which is installed neither here nor
on the card's host), on the port, plus: the same scene exported by both
packages is the same file, byte for byte, and so its decoded payloads are
equal; tensors export as their numpy values.  Registrations run on the CPU
(``device="cpu"``); the card's run of ``export_viewer_html`` on CUDA
tensors is a phase of ``chip_smoke.py``.
"""

import base64
import importlib
import inspect
import json
import re
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfocusr_tpu import Focusr as JFocusr
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
from pyfocusr_tpu.spectral.graph import Graph as JGraph
from pyfocusr_tpu.utils.html_viewer import export_html as jexport_html
from test_curvature_icp import make_sphere
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch.utils.html_viewer import export_html

torch.set_num_threads(1)


def _sphere_mesh():
    pts, tris = make_sphere(n_theta=8, n_phi=16)
    return TP.TriMesh(pts.astype(np.float32), tris.astype(np.int32),
                      {"height": pts[:, 2].astype(np.float32)})


def _scene_json(path):
    text = open(path, encoding="utf-8").read()
    m = re.search(r'<script id="scene" type="application/json">(.*?)</script>', text,
                  re.S)
    assert m, "embedded scene JSON missing"
    return text, json.loads(m.group(1))


def _f32(b64):
    return np.frombuffer(base64.b64decode(b64), "<f4")


def _u32(b64):
    return np.frombuffer(base64.b64decode(b64), "<u4")


VIEWER_METHODS = [
    ("Focusr", name) for name in (
        "view_aligned_spectral_coords", "view_meshes_colored_by_spectral_correspondences",
        "view_aligned_smoothed_spectral_coords", "view_meshes", "export_viewer_html")
] + [("Graph", name) for name in ("view_mesh_existing_scalars", "view_mesh_eig_vec",
                                  "view_mesh_features", "export_viewer_html")]


@pytest.mark.parametrize("cls,name", VIEWER_METHODS)
def test_viewer_signatures_match_jax(cls, name):
    jax_cls, port_cls = {"Focusr": (JFocusr, TP.Focusr), "Graph": (JGraph, TP.Graph)}[cls]
    assert inspect.signature(getattr(port_cls, name)) == inspect.signature(
        getattr(jax_cls, name))


def test_export_mesh_roundtrip(tmp_path):
    mesh = _sphere_mesh()
    out = export_html(tmp_path / "scene.html", meshes=[mesh], title="t<est>")
    text, data = _scene_json(out)
    assert not re.search(r'(src|href)\s*=\s*["\']https?://', text)
    assert "http://" not in json.dumps(data)
    assert "t&lt;est&gt;" in text
    (m,) = data["meshes"]
    assert m["n"] == mesh.n_points and m["f"] == mesh.n_triangles
    np.testing.assert_array_equal(_f32(m["pos"]).reshape(-1, 3), mesh.points)
    np.testing.assert_array_equal(_u32(m["idx"]).reshape(-1, 3),
                                  mesh.triangles.astype(np.uint32))
    s = m["scalars"]["height"]
    vals = _f32(s["b64"])
    np.testing.assert_array_equal(vals, mesh.point_data["height"])
    assert s["min"] == pytest.approx(float(vals.min()))
    assert s["max"] == pytest.approx(float(vals.max()))


def _scene(tmp_path, export, mesh_cls, name, mesh, point_sets):
    m = mesh_cls(mesh.points, mesh.triangles, dict(mesh.point_data))
    return export(tmp_path / name, meshes=[m, m], mesh_names=["a", "</script>b"],
                  point_sets=point_sets, point_set_names=["p"],
                  colors=[(1, 0, 0)], title="scene __DATA__ <1>", point_size=3.0)


def test_export_equals_jax_byte_for_byte(tmp_path):
    """The same scene through both packages: the same file, so the same
    decoded positions, indices, scalars and colours; CPU tensors give the
    numpy file."""
    mesh = _sphere_mesh()
    vals = mesh.point_data["height"].copy()
    vals[::5] = np.nan
    mesh = mesh.with_point_data("height", vals)
    pts = np.random.default_rng(0).normal(size=(40, 6)).astype(np.float32)
    want = _scene(tmp_path, jexport_html, JTriMesh, "jax.html",
                  JTriMesh(jnp.asarray(mesh.points), jnp.asarray(mesh.triangles),
                           {"height": jnp.asarray(vals)}), [jnp.asarray(pts)])
    got = _scene(tmp_path, export_html, TP.TriMesh, "port.html", mesh, [pts])
    as_tensors = TP.TriMesh(torch.as_tensor(mesh.points), torch.as_tensor(mesh.triangles),
                            {"height": torch.as_tensor(vals)})
    got_t = _scene(tmp_path, export_html, TP.TriMesh, "tensors.html", as_tensors,
                   [torch.as_tensor(pts)])
    jtext, jdata = _scene_json(want)
    text, data = _scene_json(got)
    assert open(got_t, encoding="utf-8").read() == text == jtext
    for jm, m in zip(jdata["meshes"], data["meshes"]):
        np.testing.assert_array_equal(_f32(m["pos"]), _f32(jm["pos"]))
        np.testing.assert_array_equal(_u32(m["idx"]), _u32(jm["idx"]))
        np.testing.assert_array_equal(_f32(m["scalars"]["height"]["b64"]),
                                      _f32(jm["scalars"]["height"]["b64"]))
        assert m["color"] == jm["color"]
    np.testing.assert_array_equal(_f32(data["pointSets"][0]["pos"]),
                                  _f32(jdata["pointSets"][0]["pos"]))


def test_export_point_sets_and_colors(tmp_path):
    rng = np.random.default_rng(0)
    pts_a = rng.normal(size=(50, 3)).astype(np.float32)
    pts_b = rng.normal(size=(30, 6)).astype(np.float32)  # extra dims dropped
    out = export_html(tmp_path / "pts.html", point_sets=[pts_a, torch.as_tensor(pts_b)],
                      point_set_names=["a", "b"], colors=[(1, 0, 0), (0, 0, 1)])
    _, data = _scene_json(out)
    assert [p["name"] for p in data["pointSets"]] == ["a", "b"]
    np.testing.assert_array_equal(_f32(data["pointSets"][1]["pos"]).reshape(-1, 3),
                                  pts_b[:, :3])
    assert data["pointSets"][0]["color"] == [1.0, 0.0, 0.0]


def test_export_requires_geometry(tmp_path):
    with pytest.raises(ValueError, match="at least one"):
        export_html(tmp_path / "empty.html")


def test_script_terminator_escaped(tmp_path):
    out = export_html(tmp_path / "esc.html", meshes=[_sphere_mesh()],
                      mesh_names=["</script>x"])
    text, data = _scene_json(out)
    assert data["meshes"][0]["name"] == "</script>x"
    body = re.search(r'<script id="scene" type="application/json">(.*?)</script>',
                     text, re.S).group(1)
    assert "</script>" not in body


def test_nan_scalars_and_adversarial_title(tmp_path):
    mesh = _sphere_mesh()
    vals = mesh.point_data["height"].copy()
    vals[::7] = np.nan
    mesh = mesh.with_point_data("height", vals)
    out = export_html(tmp_path / "nan.html", meshes=[mesh], title="run __DATA__ v2")
    text, data = _scene_json(out)
    s = data["meshes"][0]["scalars"]["height"]
    assert np.isfinite(s["min"]) and np.isfinite(s["max"])
    assert s["min"] == pytest.approx(float(vals[np.isfinite(vals)].min()))
    assert "run __DATA__ v2" in text
    assert text.count('"meshes"') == 1
    assert np.isnan(_f32(s["b64"])[::7]).all()


def test_script_breaking_names_escaped(tmp_path):
    m = TP.TriMesh(np.zeros((3, 3), np.float32), np.asarray([[0, 1, 2]], np.int32),
                   {"<!--<script>alert(1)</script>": np.arange(3, dtype=np.float32)})
    p = str(tmp_path / "v.html")
    export_html(p, meshes=[m], mesh_names=["<!--<script>"], title="t")
    html = open(p).read()
    start = html.index("application/json")
    payload = html[start:html.index("</script>", start)]
    assert "<" not in payload.replace("\\u003c", "")
    assert json.loads(payload[payload.index(">") + 1:])["meshes"][0]["name"] == "<!--<script>"


def _sphere_pair(warp=0.05):
    p1, t1 = make_sphere(n_theta=10, n_phi=20)
    p2 = p1 * (1.0 + warp * np.sin(3 * p1[:, [1]]))
    return (TP.TriMesh(p1.astype(np.float32), t1.astype(np.int32)),
            TP.TriMesh(p2.astype(np.float32), t1.astype(np.int32)))


def test_graph_export_viewer_html(tmp_path):
    pts, tris = make_sphere(n_theta=8, n_phi=16)
    g = TP.Graph(TP.TriMesh(torch.as_tensor(pts, dtype=torch.float32),
                            tris.astype(np.int32)),
                 n_spectral_features=3, list_features_to_calc=["max_curvature"], seed=0)
    g.get_graph_spectrum()
    out = g.export_viewer_html(tmp_path / "g.html", eig_vec=1, feature_idx=0)
    _, data = _scene_json(out)
    scal = data["meshes"][0]["scalars"]
    assert "eig_vec_1" in scal and "feature_0" in scal
    np.testing.assert_array_equal(_f32(scal["eig_vec_1"]["b64"]),
                                  g.eig_vecs[:, 1].numpy().astype(np.float32))
    np.testing.assert_array_equal(_f32(scal["feature_0"]["b64"]),
                                  np.asarray(g.node_features[0], np.float32))


@pytest.fixture(scope="module")
def small_reg():
    """The port's ``Focusr`` on ``tests/test_viewers.py``'s sphere pair."""
    target, source = _sphere_pair()
    reg = TP.Focusr(target, source, list_features_to_calc=["max_curvature"],
                    get_weighted_spectral_coords=False, rigid_before_non_rigid_reg=True,
                    non_rigid_max_iterations=15, graph_smoothing_iterations=10,
                    projection_smooth_iterations=2, n_coords_spectral_registration=150,
                    seed=0, device="cpu")
    reg.align_maps()
    reg.get_average_shape()
    return reg


def test_focusr_export_viewer_html(tmp_path, small_reg):
    reg = small_reg
    out = reg.export_viewer_html(tmp_path / "reg.html", include_spectral_coords=True,
                                 include_average=True, x_translation=50.0)
    _, data = _scene_json(out)
    assert [m["name"] for m in data["meshes"]] == ["target", "source",
                                                    "source transformed", "average"]
    for m in data["meshes"][:3]:
        assert "corresp_idx" in m["scalars"]
    corr = _f32(data["meshes"][1]["scalars"]["corresp_idx"]["b64"])
    np.testing.assert_array_equal(
        corr, np.asarray(reg.corresponding_target_idx_for_each_source_pt, np.float32))
    target = _f32(data["meshes"][0]["pos"]).reshape(-1, 3)
    np.testing.assert_array_equal(
        target, reg.graph_target.mesh.points.numpy() + np.float32([50.0, 0.0, 0.0]))
    assert len(data["pointSets"]) == 2
    np.testing.assert_array_equal(_f32(data["pointSets"][0]["pos"]).reshape(-1, 3),
                                  10.0 * reg.target_spectral_coords[:, :3].numpy())


class _StubViewer:
    calls = []

    def __init__(self, **kwargs):
        self.kwargs = kwargs
        _StubViewer.calls.append(kwargs)


@pytest.fixture()
def stub_itkwidgets(monkeypatch):
    mod = types.ModuleType("itkwidgets")
    mod.Viewer = _StubViewer
    monkeypatch.setitem(sys.modules, "itkwidgets", mod)
    import pyfocusr_tpu_torch.utils.viz as viz

    importlib.reload(viz)
    _StubViewer.calls = []
    yield viz
    monkeypatch.delitem(sys.modules, "itkwidgets", raising=False)
    importlib.reload(viz)


def test_view_methods_raise_without_itkwidgets(small_reg):
    with pytest.raises(ImportError, match="itkwidgets"):
        small_reg.view_meshes()
    with pytest.raises(ImportError, match="itkwidgets"):
        small_reg.graph_source.view_mesh_existing_scalars()


def test_focusr_viewers_render_with_stub(stub_itkwidgets, small_reg):
    reg = small_reg
    v = reg.view_aligned_spectral_coords(include_unaligned=True, include_rigid_aligned=True)
    assert isinstance(v, _StubViewer)
    assert len(v.kwargs["point_sets"]) == 4  # target / unaligned / rigid / non-rigid
    assert all(isinstance(p, np.ndarray) and p.shape[1] == 3
               for p in v.kwargs["point_sets"])
    v = reg.view_meshes_colored_by_spectral_correspondences()
    geoms = v.kwargs["geometries"]
    assert len(geoms) == 2
    np.testing.assert_array_equal(geoms[1]["points"],
                                  reg.graph_target.mesh.points.numpy() + np.float32([100, 0, 0]))
    np.testing.assert_array_equal(geoms[0]["point_data"]["corresp_idx"],
                                  reg.corresponding_target_idx_for_each_source_pt)
    v = reg.view_aligned_smoothed_spectral_coords()
    assert len(v.kwargs["point_sets"]) == 2
    v = reg.view_meshes(include_target=True, include_source=True,
                        include_transformed_target=True, include_average=True)
    assert len(v.kwargs["geometries"]) == 4
    reg.set_all_mesh_scalars_to_corresp_target_idx()  # scalar-setter path


def test_graph_viewers_render_with_stub(stub_itkwidgets, small_reg):
    g = small_reg.graph_source
    assert isinstance(g.view_mesh_existing_scalars(), _StubViewer)
    v = g.view_mesh_eig_vec(1)
    np.testing.assert_array_equal(v.kwargs["geometries"][0]["point_data"]["eig_vec"],
                                  g.eig_vecs[:, 1].numpy())
    assert isinstance(g.view_mesh_features(0), _StubViewer)


def test_view_meshes_without_results_raises(stub_itkwidgets):
    """``include_transformed_target`` / ``include_average`` before any
    final locations raise the reference's messages."""
    target, source = _sphere_pair()
    reg = TP.Focusr(target, source, list_features_to_calc=(), icp_register_first=False,
                    device="cpu")
    with pytest.raises(Exception, match="No corresponding points"):
        reg.view_meshes(include_transformed_target=True)
    with pytest.raises(Exception, match="No xyz correspondences"):
        reg.view_meshes(include_average=True)
