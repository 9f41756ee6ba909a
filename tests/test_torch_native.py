"""The port's host library (``pyfocusr_tpu_torch/native.py`` over
``csrc/host/*.cpp``) against its plain numpy versions and the JAX package.

Each consumer's C++ path is held three ways on the same inputs: the port's
native path, the port's plain version (``mesh.build_topology_plain``,
``multires._luby_mis_numpy`` / ``decimate_plain``,
``ops.assignment.lap_host_plain``, ``io.vtk_io._read_ascii``) and the JAX
package's function, which takes its own ``_native.so`` when that is built
and numpy otherwise: all three must be equal, byte for byte (topology,
MIS, decimation, parse) or index for index (``lap_host``), so the test
holds on either of JAX's branches.  The build: a missing compiler and a
broken source raise, a changed source gets a new library name, and a
library is reused by its hash.  Inputs are built in code.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from pyfocusr_tpu.io.vtk_io import read_vtk_polydata as jread_vtk
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
from pyfocusr_tpu.mesh import build_topology as jbuild_topology
from pyfocusr_tpu.multires import decimate as jdecimate
from pyfocusr_tpu.ops.assignment import lap_host as jlap_host
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch import mesh as TM
from pyfocusr_tpu_torch import multires as TMR
from pyfocusr_tpu_torch import native
from pyfocusr_tpu_torch.io import vtk_io
from pyfocusr_tpu_torch.ops import _cuda_build
from pyfocusr_tpu_torch.ops import assignment as TA


def _assert_topology_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _hub():
    ring = np.arange(1, 40)
    return np.stack([np.zeros_like(ring[:-1]), ring[:-1], ring[1:]], axis=1), 40


def _soup(seed, n, f):
    return np.random.default_rng(seed).integers(0, n, size=(f, 3)), n


def _islands():
    rng = np.random.default_rng(2)
    tris = np.concatenate([rng.integers(0, 20, size=(30, 3)),
                           rng.integers(30, 50, size=(30, 3))])
    return tris, 60  # two islands, isolated vertices 20-29 and 50-59


def _degenerate():
    """Faces with repeated vertices, a duplicated face and a non-manifold
    edge (four faces on edge 0-1)."""
    tris = np.array([[0, 1, 2], [0, 1, 3], [1, 0, 4], [0, 1, 5], [2, 2, 3], [3, 3, 3],
                     [0, 1, 2], [4, 5, 6]])
    return tris, 8


def _bone():
    m = chip_smoke.synthetic_bone(TP, 1, 4)
    return np.asarray(m.triangles), m.n_points


TOPOLOGY_CASES = {
    "bone": (_bone, {}),
    "soup_small": (lambda: _soup(0, 50, 120), {}),
    "soup": (lambda: _soup(1, 200, 500), {}),
    "islands": (_islands, {}),
    "degenerate": (_degenerate, {}),
    "hub_capped": (_hub, {"degree_cap": 8}),
    "hub_capped_padded": (_hub, {"degree_cap": 8, "pad_degree": 12}),
    "hub_uncapped": (_hub, {"degree_cap": None}),
    "bone_padded": (_bone, {"pad_degree": 30}),
    "bone_capped": (_bone, {"degree_cap": 5}),
}


@pytest.mark.parametrize("case", sorted(TOPOLOGY_CASES))
def test_topology_equals_plain_and_jax(case):
    make, kw = TOPOLOGY_CASES[case]
    tris, n = make()
    got = TM.build_topology(tris, n, **kw)
    _assert_topology_equal(got, TM.build_topology_plain(tris, n, **kw))
    _assert_topology_equal(got, jbuild_topology(tris, n, **kw))


def test_topology_edge_cases():
    """No triangles (the plain path, as in JAX), out-of-range indices
    (JAX's message) and a pad narrower than the degree."""
    empty = TM.build_topology(np.zeros((0, 3), np.int64), 5)
    _assert_topology_equal(empty, jbuild_topology(np.zeros((0, 3), np.int64), 5))
    with pytest.raises(ValueError, match="triangle indices span"):
        TM.build_topology(np.array([[0, 1, 7]]), 5)
    with pytest.raises(ValueError, match="pad_degree 2 < degree"):
        TM.build_topology(*_hub(), degree_cap=8, pad_degree=2)


def test_main_paths_take_no_plain_version(monkeypatch, tmp_path):
    """With the library built, the topology, the decimation, ``lap_host``
    and the ASCII reader never call their plain versions."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran")

    for mod, name in ((TM, "build_topology_plain"), (TMR, "_luby_mis_numpy"),
                      (TMR, "_unique_edges_numpy"), (TA, "lap_host_plain"),
                      (vtk_io, "_read_ascii")):
        monkeypatch.setattr(mod, name, refuse)
    m = chip_smoke.synthetic_bone(TP, 1, 4)
    TM.build_topology(m.triangles, m.n_points)
    TMR.decimate(m, 300, seed=1)
    TA.lap_host(np.random.default_rng(0).random((20, 30)))
    TP.save_mesh(str(tmp_path / "m.vtk"), m)
    assert TP.load_mesh(str(tmp_path / "m.vtk")).n_points == m.n_points


def _edges(n, m, rng):
    e = rng.integers(0, n, size=(m, 2))
    e = e[e[:, 0] != e[:, 1]]
    e.sort(axis=1)
    key = np.unique(e[:, 0] * np.int64(n) + e[:, 1])
    return (key // n).astype(np.int64), (key % n).astype(np.int64)


@pytest.mark.parametrize("n,m", [(10, 15), (100, 300), (1000, 4000), (5000, 0)])
def test_mis_greedy_equals_luby(n, m):
    rng = np.random.default_rng(n)
    u, v = _edges(n, m, rng) if m else (np.zeros(0, np.int64), np.zeros(0, np.int64))
    for seed in range(3):
        prio = np.random.default_rng(seed).permutation(n).astype(np.int64)
        a = native.mis_greedy(u, v, n, prio)
        np.testing.assert_array_equal(a, TMR._luby_mis_numpy(u, v, n, prio))
        s = a == 1
        assert not np.any(s[u] & s[v])  # independent
        hit = np.bincount(np.concatenate([u[s[v]], v[s[u]]]), minlength=n) > 0
        assert (s | hit).all()  # maximal
    with pytest.raises(ValueError, match="permutation"):
        native.mis_greedy(u, v, n, np.zeros(n, np.int64))


@pytest.mark.parametrize("levels,target", [(4, 300), (5, 200)])
def test_decimate_equals_plain_and_jax(levels, target):
    m = chip_smoke.synthetic_bone(TP, 3, levels)
    got = TMR.decimate(m, target, seed=7)
    plain = TMR.decimate_plain(m, target, seed=7)
    want = jdecimate(JTriMesh(m.points, m.triangles, {}), target, seed=7)
    for other in (plain, want):
        np.testing.assert_array_equal(got[0].points, np.asarray(other[0].points))
        np.testing.assert_array_equal(got[0].triangles, np.asarray(other[0].triangles))
        np.testing.assert_array_equal(got[1], other[1])
        np.testing.assert_array_equal(got[2], other[2])
    # The caller's edges (the fine topology's) give the same decimation.
    edges = TM.build_topology(m.triangles, m.n_points).edges
    with_edges = TMR.decimate(m, target, seed=7, edges=edges)
    np.testing.assert_array_equal(with_edges[1], got[1])


def _lap_costs():
    rng = np.random.default_rng(0)
    return {
        "uniform_64": rng.random((64, 64)),
        "uniform_wide": rng.random((40, 70)),
        "uniform_tall": rng.random((70, 40)),
        "ties_int_50": rng.integers(0, 4, size=(50, 50)).astype(np.float64),
        "ties_int_wide": rng.integers(0, 3, size=(30, 45)).astype(np.float64),
        "ties_int_tall": rng.integers(0, 3, size=(45, 30)).astype(np.float64),
        "constant": np.ones((12, 12)),
        "one_row": rng.random((1, 9)),
    }


@pytest.mark.parametrize("case", sorted(_lap_costs()))
def test_lap_host_equals_plain_and_jax(case):
    cost = _lap_costs()[case]
    rows, cols = TA.lap_host(cost)
    for other in (TA.lap_host_plain(cost), jlap_host(cost)):
        np.testing.assert_array_equal(rows, np.asarray(other[0]))
        np.testing.assert_array_equal(cols, np.asarray(other[1]))
    from scipy.optimize import linear_sum_assignment

    r, c = linear_sum_assignment(cost)
    np.testing.assert_allclose(cost[rows, cols].sum(), cost[r, c].sum(), rtol=1e-12)


def test_lap_host_rejects_non_finite_and_takes_empty():
    cost = np.random.default_rng(1).random((6, 6))
    for bad in (np.nan, np.inf):
        c = cost.copy()
        c[2, 3] = bad
        for fn in (TA.lap_host, TA.lap_host_plain):
            with pytest.raises(ValueError, match="non-finite"):
                fn(c)
    for shape in ((0, 4), (4, 0)):
        rows, cols = TA.lap_host(np.zeros(shape))
        prow, pcol = TA.lap_host_plain(np.zeros(shape))
        assert rows.shape == cols.shape == prow.shape == pcol.shape == (0,)


def _vtk_files(tmp_path):
    """.vtk files the port's ``save_mesh`` writes, and hand-written ones
    with sections the native path hands to the python reader."""
    m = chip_smoke.synthetic_bone(TP, 1, 3)
    rng = np.random.default_rng(0)
    m = m.with_point_data("vec", rng.normal(size=(m.n_points, 3)).astype(np.float32))
    paths = {"bone": tmp_path / "bone.vtk", "bare": tmp_path / "bare.vtk"}
    TP.save_mesh(str(paths["bone"]), m)
    TP.save_mesh(str(paths["bare"]), TP.TriMesh(m.points, m.triangles, {}))
    paths["cells"] = tmp_path / "cells.vtk"
    paths["cells"].write_text(
        "# vtk DataFile Version 4.2\ncells\nASCII\nDATASET POLYDATA\n"
        "POINTS 4 double\n0 0 0\n1 0 0\n0 1 0\n0 0 1\nPOLYGONS 2 8\n3 0 1 2\n3 0 1 3\n"
        "CELL_DATA 2\nSCALARS area double\nLOOKUP_TABLE default\n7 8\n"
        "POINT_DATA 4\nSCALARS thickness double 1\nLOOKUP_TABLE default\n"
        "0.5 1.5 2.5 3.5\nFIELD FieldData 1\nf 2 4 float\n1 2 3 4 5 6 7 8\n")
    paths["v51"] = tmp_path / "v51.vtk"
    paths["v51"].write_text(
        "# vtk DataFile Version 5.1\nmesh\nASCII\nDATASET POLYDATA\nPOINTS 4 double\n"
        "0 0 0\n1 0 0\n0 1 0\n1 1 0.5\nPOLYGONS 3 6\nOFFSETS vtktypeint64\n0 3 6\n"
        "CONNECTIVITY vtktypeint64\n0 1 2 1 3 2\n")
    paths["quads_metadata"] = tmp_path / "quads.vtk"
    paths["quads_metadata"].write_text(
        "# vtk DataFile Version 4.2\nq\nASCII\nDATASET POLYDATA\nPOINTS 5 float\n"
        "0 0 0 1 0 0 1 1 0 0 1 0 0.5 0.5 1\nMETADATA\nINFORMATION 0\n\n"
        "POLYGONS 2 9\n4 0 1 2 3\n3 0 1 4\nPOINT_DATA 5\nSCALARS labels int\n5 3 2 1 0\n")
    return paths


def test_vtk_parse_equals_python_and_jax(tmp_path):
    for name, path in _vtk_files(tmp_path).items():
        got = vtk_io.read_vtk_polydata(str(path))
        raw = path.read_bytes()
        for other in (vtk_io._read_ascii(raw.decode("ascii")), jread_vtk(str(path))):
            np.testing.assert_array_equal(got[0], other[0], err_msg=name)
            np.testing.assert_array_equal(got[1], other[1], err_msg=name)
            assert sorted(got[2]) == sorted(other[2]), name
            for k in other[2]:
                np.testing.assert_array_equal(got[2][k], other[2][k], err_msg=f"{name} {k}")
        if name in ("bone", "bare", "cells"):  # structures the native path reads
            native_got = vtk_io._read_ascii_native(raw)
            np.testing.assert_array_equal(native_got[0], got[0])
    m = TP.load_mesh(str(tmp_path / "bone.vtk"))
    assert m.n_points == 642 and sorted(m.point_data) == ["thickness_change_(mm)", "vec"]


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path)
    lib = native.HostLibrary(compiler=str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+ not found.*fast_topology.cpp"):
        lib.load()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    """The name hashes the sources' bytes (not their paths): a copy of the
    sources names the same library, an edited one another; a broken source
    raises with the compiler's message, and a built library is reused."""
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    copies = []
    for src in native.HOST_SOURCES:
        dst = tmp_path / src.name
        dst.write_bytes(src.read_bytes())
        copies.append(dst)
    before = native.HostLibrary(sources=copies).path()
    assert before == native.HostLibrary().path()
    copies[2].write_text(copies[2].read_text() + "\n// edited\n")
    edited = native.HostLibrary(sources=copies)
    assert edited.path() != before
    assert edited.path().parent == tmp_path / "build"
    edited.load()
    assert edited.build_seconds > 0 and edited.path().exists()
    again = native.HostLibrary(sources=copies)
    again.load()
    assert again.build_seconds == 0.0
    copies[0].write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        native.HostLibrary(sources=copies).load()
    assert not list((tmp_path / "build").glob("*.tmp"))
