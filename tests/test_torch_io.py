"""Port parity for the mesh I/O (``pyfocusr_tpu_torch/io``, ``load_mesh`` /
``save_mesh``) and the ``vtk_functions`` module against ``pyfocusr_tpu``,
on the synthetic bone (``chip_smoke.synthetic_bone``, 642 vertices, with
its thickness scalar and a [N, 3] vector array).  The JAX package's own
tests of these read mesh files this repository lacks; these build their
meshes in code.

Gates, and why:
* every format ``io/mesh_formats`` writes (.vtk, .vtp, .ply, .obj, .stl):
  the port's file equal byte for byte to the JAX package's (the writers are
  copies), and the port's ``load_mesh`` equal outright to JAX's on that
  file (the readers are copies, minus JAX's native ASCII parser, which
  gives the same numbers); the round trip keeps the points within the
  format's precision (``%.10g`` text, f32 binary) and the point data where
  the format carries it;
* ``save_mesh`` takes the port's tensors as well as numpy;
* ``vtk_functions``: ICP's (s, R, t) within 1e-4 of JAX's (the gates of
  ``tests/test_torch_icp.py``), the curvature getters at the gate of
  ``tests/test_torch_focusr.py::test_curvature_matches_jax`` for the
  principal curvatures (within twice JAX's own distance from an f64
  evaluation, plus 1e-5 of the range: their discriminant amplifies f32
  rounding in both packages), a deep copy that shares no memory.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu import vtk_functions as jvf
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
from pyfocusr_tpu.mesh import load_mesh as j_load_mesh
from pyfocusr_tpu.mesh import save_mesh as j_save_mesh
from pyfocusr_tpu_torch.ops.curvature import principal_curvatures

torch.set_num_threads(1)

FEATURE = chip_smoke.FEATURE
FORMATS = (".vtk", ".vtp", ".ply", ".obj", ".stl")


@pytest.fixture(scope="module")
def bone():
    t = chip_smoke.synthetic_bone(TP, 2, levels=3)
    rng = np.random.default_rng(1)
    return t.with_point_data("vec", rng.normal(size=(t.n_points, 3)).astype(np.float32))


def _jax_mesh(m):
    return JTriMesh(np.asarray(m.points), np.asarray(m.triangles), dict(m.point_data))


@pytest.mark.parametrize("ext", FORMATS)
def test_save_load_round_trip_matches_jax(bone, ext, tmp_path):
    ours, theirs = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    TP.save_mesh(ours, bone)
    j_save_mesh(theirs, _jax_mesh(bone))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got, want = TP.load_mesh(ours), j_load_mesh(ours)
    assert isinstance(got.points, np.ndarray) and got.points.dtype == np.float32
    np.testing.assert_array_equal(got.points, np.asarray(want.points))
    np.testing.assert_array_equal(got.triangles, np.asarray(want.triangles))
    assert sorted(got.point_data) == sorted(want.point_data)
    for name in want.point_data:
        np.testing.assert_array_equal(got.point_data[name], np.asarray(want.point_data[name]))
    if ext == ".stl":  # a triangle soup, welded on read: the same vertex set
        assert got.n_points == bone.n_points
        return
    np.testing.assert_allclose(got.points, bone.points, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got.triangles, bone.triangles)
    if ext == ".obj":  # OBJ carries no per-vertex scalars
        return
    for name, vals in bone.point_data.items():
        vals = np.asarray(vals).reshape(bone.n_points, -1)
        # PLY's vertex properties are scalars: [N, C] comes back as name_c.
        cols = ([got.point_data[f"{name}_{c}"] for c in range(vals.shape[1])]
                if ext == ".ply" and vals.shape[1] > 1 else [got.point_data[name]])
        np.testing.assert_allclose(np.stack(cols, axis=-1).reshape(vals.shape), vals,
                                   rtol=1e-6, atol=1e-6)


def test_save_mesh_takes_tensors(bone, tmp_path):
    as_tensors = TP.TriMesh(torch.as_tensor(bone.points), torch.as_tensor(bone.triangles),
                            {k: torch.as_tensor(v) for k, v in bone.point_data.items()})
    TP.save_mesh(str(tmp_path / "t.vtk"), as_tensors)
    TP.save_mesh(str(tmp_path / "n.vtk"), bone)
    assert (tmp_path / "t.vtk").read_bytes() == (tmp_path / "n.vtk").read_bytes()
    with pytest.raises(ValueError, match="unsupported mesh extension"):
        TP.save_mesh(str(tmp_path / "x.off"), bone)


def test_vtk_functions_read_write_and_deep_copy(bone, tmp_path):
    p = str(tmp_path / "rt.vtk")
    TP.vtk_functions.write_vtk_mesh(p, bone)
    back = TP.vtk_functions.read_vtk_mesh(p)
    want = jvf.read_vtk_mesh(p)
    np.testing.assert_array_equal(back.points, np.asarray(want.points))
    copy = TP.vtk_functions.vtk_deep_copy(bone)
    assert copy is not bone and not np.shares_memory(copy.points, bone.points)
    np.testing.assert_array_equal(copy.points, bone.points)
    t_copy = TP.vtk_functions.vtk_deep_copy(TP.TriMesh(torch.as_tensor(bone.points),
                                                      bone.triangles))
    assert torch.is_tensor(t_copy.points)


@pytest.mark.parametrize("mode", ["rigid", "similarity"])
def test_icp_transform_matches_jax(bone, mode):
    rng = np.random.default_rng(2)
    angle = 0.2
    rot = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                    [0, 0, 1]], np.float32)
    moved = bone.with_points((np.asarray(bone.points) @ rot.T * 1.02
                              + np.array([3.0, -2.0, 1.0], np.float32)
                              + rng.normal(0, 0.05, bone.points.shape)).astype(np.float32))
    got = TP.vtk_functions.icp_transform(bone, moved, numberOfIterations=30,
                                         transform_mode=mode, device="cpu")
    want = jvf.icp_transform(_jax_mesh(bone), _jax_mesh(moved), numberOfIterations=30,
                             transform_mode=mode)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-4, rtol=1e-4)
    back = TP.vtk_functions.apply_transform(moved, got)
    jback = jvf.apply_transform(_jax_mesh(moved), want)
    np.testing.assert_allclose(back.points.numpy(), np.asarray(jback.points), atol=1e-3)
    with pytest.raises(ValueError, match="transform mode"):
        TP.vtk_functions.icp_transform(bone, bone, transform_mode="banana", device="cpu")


def test_curvature_getters_match_jax(bone):
    kmin, kmax = TP.vtk_functions.get_min_max_curvature_values(bone, device="cpu")
    jmin, jmax = jvf.get_min_max_curvature_values(_jax_mesh(bone))
    topo = TP.build_topology(bone.triangles, bone.n_points)
    exact = principal_curvatures(torch.as_tensor(bone.points).double(), bone.triangles,
                                 topo.edges, topo.edge_faces)
    for g, w, e in zip((kmin, kmax), (jmin, jmax), exact):
        w, e = np.asarray(w), e.numpy()
        bound = 2.0 * np.abs(w - e).max() + 1e-5 * np.ptp(w)
        assert np.abs(g - w).max() <= bound, (np.abs(g - w).max(), bound)
    (only_max,) = TP.vtk_functions.get_max_curvature(bone, device="cpu")
    (only_min,) = TP.vtk_functions.get_min_curvature(bone, device="cpu")
    np.testing.assert_array_equal(only_max, kmax)
    np.testing.assert_array_equal(only_min, kmin)
    out = TP.vtk_functions.get_node_curvatures(bone, curvature_type="max", device="cpu")
    assert torch.equal(out.point_data["max_curvature"], torch.as_tensor(kmax))
