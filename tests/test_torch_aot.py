"""The port's registration artifacts (``pyfocusr_tpu_torch/utils/aot.py``),
the counterpart of ``tests/test_utils.py::TestAOTExport`` and
``TestAOTExecutableFormat``, on the CPU.

Gates, and why:
* the runner of either format against ``register_pair`` on the same
  draws: every output equal, bit for bit (the runner calls
  ``register_pair`` under the pinned config, so nothing may differ);
* the sidecar checks (config, shapes, sources, and for the compiled
  format the device, torch and CUDA versions): a ``ValueError`` naming the
  mismatch, raised before anything is installed, and exit 2 in the CLI;
* the compiled format's header is checked before anything is opened, and
  each library's sha256 before anything is written;
* a compiled artifact exported on the CPU serves a fresh interpreter with
  an empty build directory and neither ``g++`` nor ``nvcc`` reachable;
  processes that install one artifact at once all serve;
* JAX's artifacts are refused by both loaders; no module of the port,
  and not ``chip_smoke.py``, imports ``jax`` or ``pyfocusr_tpu``.
"""

import ast
import dataclasses
import hashlib
import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch import cli as TCLI
from pyfocusr_tpu_torch import native
from pyfocusr_tpu_torch.ops import _cuda_build
from pyfocusr_tpu_torch.utils import aot
from test_curvature_icp import make_sphere

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX's TestAOTExport configuration.
CFG = dict(icp_iterations=10, n_coords_spectral_ordering=150,
           n_coords_spectral_registration=100, non_rigid_max_iterations=10,
           non_rigid_n_eigens=30, graph_smoothing_iterations=10,
           projection_smooth_iterations=2, eig_cg_iters=60)
FAST = ["--non-rigid-max-iterations", "10", "--graph-smoothing-iterations", "10",
        "--n-coords-spectral-registration", "100", "--n-coords-spectral-ordering", "150"]
FORMATS = {"portable": (aot.export_registration, aot.load_registration, "reg.pt"),
           "compiled": (aot.export_registration_exec, aot.load_registration_exec,
                        "reg.ptexec")}


def _pair():
    pts, tris = make_sphere(n_theta=10, n_phi=20)
    t = TP.TriMesh(pts.astype(np.float32), tris)
    s = TP.TriMesh((pts * (1.0 + 0.05 * np.sin(3 * pts[:, [1]]))).astype(np.float32), tris)
    return t, s


@pytest.fixture(scope="module")
def graphs():
    t, s = _pair()
    return t, s, TP.mesh_to_graph_arrays(t, device="cpu"), TP.mesh_to_graph_arrays(s, device="cpu")


def _export(fmt, cfg, tg, sg, tmp_path):
    export, load, name = FORMATS[fmt]
    return export(cfg, tg, sg, str(tmp_path / name)), load


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_roundtrip_bit_equal_to_register_pair(graphs, tmp_path, fmt):
    _, _, tg, sg = graphs
    cfg = TP.PipelineConfig(**CFG)
    path, load = _export(fmt, cfg, tg, sg, tmp_path)
    assert os.path.exists(path + ".meta.json")
    runner = load(path, cfg=cfg, target=tg, source=sg)
    draws = TP.make_draws(3, cfg, tg.n_points, sg.n_points)
    for kw in (lambda: dict(generator=torch.Generator().manual_seed(3)),
               lambda: dict(draws=draws)):
        out, ref = runner(tg, sg, **kw()), TP.register_pair(tg, sg, cfg, **kw())
        assert sorted(out) == sorted(ref)
        for key in ref:
            assert torch.equal(out[key], ref[key]), key


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_sidecar_validation(graphs, tmp_path, monkeypatch, fmt):
    t, _, g, _ = graphs
    cfg = TP.PipelineConfig(**CFG)
    path, load = _export(fmt, cfg, g, g, tmp_path)
    load(path, cfg=cfg, target=g, source=g)
    # landmark_weight is fingerprint-normalized: still valid.
    aot.validate_artifact(path, cfg=dataclasses.replace(cfg, landmark_weight=7.0),
                          device="cpu")
    with pytest.raises(ValueError, match="different PipelineConfig"):
        load(path, cfg=dataclasses.replace(cfg, non_rigid_beta=10.0), device="cpu")
    g_pad = TP.mesh_to_graph_arrays(t, pad_n_points=t.n_points + 64, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        load(path, source=g_pad, device="cpu")
    # Another source tree: refused, sidecar or not.
    real_hash = aot.source_hash()
    monkeypatch.setattr(aot, "source_hash", lambda: "0" * 64)
    with pytest.raises(ValueError, match="other pyfocusr_tpu_torch sources"):
        aot.validate_artifact(path, device="cpu")
    monkeypatch.setattr(aot, "source_hash", lambda: real_hash)
    # Sidecar-less artifacts skip the sidecar's validation, as JAX's; the
    # runner still checks each input against the pinned shapes.
    os.remove(path + ".meta.json")
    runner = load(path, cfg=cfg, target=g, source=g_pad)
    with pytest.raises(ValueError, match="source shapes"):
        runner(g, g_pad)
    monkeypatch.setattr(aot, "source_hash", lambda: "0" * 64)
    with pytest.raises(ValueError, match="other pyfocusr_tpu_torch sources"):
        load(path, device="cpu")


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_export_rejects_padded_hungarian(graphs, tmp_path, fmt):
    t, _, _, _ = graphs
    g_pad = TP.mesh_to_graph_arrays(t, pad_n_points=t.n_points + 64, device="cpu")
    cfg = TP.PipelineConfig(initial_correspondence_type="hungarian",
                            n_coords_spectral_ordering=100,
                            n_coords_spectral_registration=80)
    with pytest.raises(ValueError, match="unpadded"):
        _export(fmt, cfg, g_pad, g_pad, tmp_path)
    assert not os.listdir(tmp_path)


def _rewrite(path, edit):
    """Rewrite a compiled artifact's manifest and library bytes by ``edit``."""
    raw = open(path, "rb").read()
    with zipfile.ZipFile(io.BytesIO(raw[len(aot._EXEC_MAGIC):])) as zf:
        files = {n: zf.read(n) for n in zf.namelist()}
    manifest = json.loads(files.pop("manifest.json"))
    edit(manifest, files)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for n, data in files.items():
            zf.writestr(n, data)
        zf.writestr("manifest.json", json.dumps(manifest))
    open(path, "wb").write(aot._EXEC_MAGIC + buf.getvalue())


def test_compiled_pins_and_checks(graphs, tmp_path, monkeypatch):
    """The compiled format's pins (device, torch, CUDA) and library checks
    refuse before anything is installed."""
    _, _, tg, sg = graphs
    cfg = TP.PipelineConfig(**CFG)
    path = aot.export_registration_exec(cfg, tg, sg, str(tmp_path / "reg.ptexec"))
    # An empty build directory for the libraries the artifact installs.
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", build_dir)
    meta_path = path + ".meta.json"
    meta = json.loads(open(meta_path).read())
    assert meta["format"] == "compiled" and meta["device"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    assert [lib["kind"] for lib in meta["libraries"]] == ["host"]  # no card here
    for key, value, match in (("device", {"name": "NVIDIA H100 80GB HBM3",
                                          "capability": [9, 0]}, "compiled for device"),
                              ("torch_version", "0.0.1", "torch_version"),
                              ("cuda_version", "11.0", "cuda_version")):
        open(meta_path, "w").write(json.dumps(dict(meta, **{key: value})))
        with pytest.raises(ValueError, match=match):
            aot.load_registration_exec(path, device="cpu")
    open(meta_path, "w").write(json.dumps(meta))
    assert not build_dir.exists()

    # The manifest inside is checked too, and every library before any is
    # written: a corrupt copy, and a CUDA library this tree does not build.
    def corrupt(manifest, files):
        name = f"lib/{manifest['libraries'][0]['name']}"
        files[name] = files[name][:-1] + bytes([files[name][-1] ^ 1])

    def foreign(manifest, files):
        manifest["libraries"].insert(0, {"name": "libpyfocusr_knn_0000000000000000.so",
                                         "kind": "cuda", "sha256": "0" * 64})

    def other_device(manifest, files):
        manifest["device"] = {"name": "NVIDIA H100 80GB HBM3", "capability": [9, 0]}

    def renamed(name):
        def edit(manifest, files):
            lib = manifest["libraries"][0]
            files[f"lib/{name}"] = files.pop(f"lib/{lib['name']}")
            lib["name"] = name
        edit.__name__ = "renamed_" + hashlib.sha256(name.encode()).hexdigest()[:8]
        return edit

    escapes = ["../escaped.so", str(tmp_path / "escaped.so"),
               "libpyfocusr_host_0123.so", "libpyfocusr_host_0123456789abcdef.so.x"]
    for edit, match in ((corrupt, "sha256"), (foreign, "not one this tree builds"),
                        (other_device, "compiled for device"),
                        *((renamed(n), "not a library file this tree builds")
                          for n in escapes)):
        p = str(tmp_path / f"{edit.__name__}.ptexec")
        open(p, "wb").write(open(path, "rb").read())
        _rewrite(p, edit)
        with pytest.raises(ValueError, match=match):
            aot.install_libraries(p, device="cpu")
        assert not build_dir.exists() and not (tmp_path / "escaped.so").exists()

    # A good artifact installs under its recorded name; a second install
    # keeps the file.
    manifest = aot.install_libraries(path, device="cpu")
    (lib,) = manifest["libraries"]
    installed = build_dir / lib["name"]
    assert hashlib.sha256(installed.read_bytes()).hexdigest() == lib["sha256"]
    stat = installed.stat()
    aot.install_libraries(path, device="cpu")
    assert installed.stat().st_mtime_ns == stat.st_mtime_ns
    # A loader given the manifest of that install does not install again.
    monkeypatch.setattr(aot, "_install", lambda *a: pytest.fail("installed twice"))
    runner = aot.load_registration_exec(path, cfg=cfg, target=tg, source=sg,
                                        installed=manifest)
    assert callable(runner)


def test_header_checked_before_anything_is_opened(tmp_path, monkeypatch):
    """A file without the magic header is refused before the zip is
    opened; a headered one reaches the zip reader."""
    opened = []
    real_zipfile = zipfile.ZipFile
    monkeypatch.setattr(zipfile, "ZipFile", lambda *a, **k: opened.append(a) or
                        real_zipfile(*a, **k))
    raw_zip = io.BytesIO()
    with real_zipfile(raw_zip, "w") as zf:
        zf.writestr("manifest.json", "{}")
    bad = tmp_path / "headerless.ptexec"
    bad.write_bytes(raw_zip.getvalue())
    with pytest.raises(ValueError, match="missing .* header"):
        aot.load_registration_exec(str(bad), device="cpu")
    assert not opened
    garbled = tmp_path / "garbled.ptexec"
    garbled.write_bytes(aot._EXEC_MAGIC + b"not a zip")
    with pytest.raises(zipfile.BadZipFile):
        aot.load_registration_exec(str(garbled), device="cpu")
    assert opened
    # Either loader names the other format.
    portable = tmp_path / "reg.pt"
    portable.write_bytes(aot._EXEC_MAGIC + raw_zip.getvalue())
    with pytest.raises(ValueError, match="load_registration_exec"):
        aot.load_registration(str(portable), device="cpu")


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    """A StableHLO artifact of JAX's ``export_registration``."""
    import jax.numpy as jnp

    from pyfocusr_tpu.mesh import TriMesh as JTriMesh
    from pyfocusr_tpu.pipeline import PipelineConfig as JConfig
    from pyfocusr_tpu.pipeline import mesh_to_graph_arrays as j_graph
    from pyfocusr_tpu.utils.aot import export_registration as j_export

    pts, tris = make_sphere(n_theta=10, n_phi=20)
    g = j_graph(JTriMesh(jnp.asarray(pts, jnp.float32), jnp.asarray(tris)))
    cfg = JConfig(icp_iterations=5, n_coords_spectral_ordering=100,
                  n_coords_spectral_registration=80, non_rigid_max_iterations=5,
                  non_rigid_n_eigens=20, graph_smoothing_iterations=5,
                  projection_smooth_iterations=1, eig_cg_iters=40)
    return j_export(cfg, g, g, str(tmp_path_factory.mktemp("jax_aot") / "reg.jaxexp"))


def test_jax_artifacts_are_refused(jax_artifact, tmp_path):
    for load in (aot.load_registration, aot.load_registration_exec):
        with pytest.raises(ValueError, match="JAX package"):
            load(jax_artifact, device="cpu")
    renamed = tmp_path / "reg.pt"
    renamed.write_bytes(open(jax_artifact, "rb").read())
    with pytest.raises(ValueError, match="not a pyfocusr_tpu_torch portable artifact"):
        aot.load_registration(str(renamed), device="cpu")
    renamed_exec = tmp_path / "reg.ptexec"
    renamed_exec.write_bytes(open(jax_artifact, "rb").read())
    with pytest.raises(ValueError, match="missing .* header"):
        aot.load_registration_exec(str(renamed_exec), device="cpu")


def _serve_cmd(args):
    return [sys.executable, "-c",
            f"import sys; sys.path.insert(0, {REPO!r}); "
            "from pyfocusr_tpu_torch import native; "
            "from pyfocusr_tpu_torch.cli import main; "
            f"rc = main({args!r}); "
            "print('HOST_BUILD_SECONDS', native.build_seconds()); sys.exit(rc)"]


def test_compiled_serves_fresh_process_without_compilers(tmp_path):
    """Exported on the CPU through ``register --aot x.ptexec``, served by
    fresh interpreters with an empty build directory and an empty PATH
    (no g++, no nvcc; CUDA_HOME empty too): nothing is built, every output
    equals the exporting run's.  Four at once install into one directory."""
    t, s = _pair()
    paths = {k: str(tmp_path / f"{k}.vtk") for k in ("t", "s")}
    TP.save_mesh(paths["t"], t)
    TP.save_mesh(paths["s"], s)
    art = str(tmp_path / "reg.ptexec")
    common = ["register", paths["t"], paths["s"], "--aot", art, "--device", "cpu"] + FAST
    rc = TCLI.main(common + ["-o", str(tmp_path / "export")])
    assert rc == 0 and os.path.exists(art)
    empty = tmp_path / "empty"
    empty.mkdir()
    env = {"PATH": str(empty), "CUDA_HOME": str(empty), "HOME": str(tmp_path),
           "PYFOCUSR_TPU_TORCH_BUILD_DIR": str(tmp_path / "fresh_build"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(_serve_cmd(common + ["-o", str(tmp_path / f"serve{i}")]),
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(4)]
    for i, proc in enumerate(procs):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-1500:]
        assert "HOST_BUILD_SECONDS 0.0" in out
        for name in ("correspondences.npy", "transformed_source.vtk"):
            assert (tmp_path / f"serve{i}" / name).read_bytes() == (
                tmp_path / "export" / name).read_bytes(), name
    assert [p.name for p in (tmp_path / "fresh_build").iterdir()] == [
        json.loads(open(art + ".meta.json").read())["libraries"][0]["name"]]
    # A changed config is refused with exit 2, as JAX's CLI does.
    proc = subprocess.run(_serve_cmd(common[:-len(FAST)] + ["--non-rigid-max-iterations",
                                                            "11"] + FAST[2:]),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and "different PipelineConfig" in proc.stderr


def test_register_aot_flag_portable(tmp_path):
    """``register --aot FILE`` (JAX's ``test_register_aot_flag``): the first
    invocation exports, the second serves with equal outputs; a changed
    config exits 2."""
    t, s = _pair()
    paths = {k: str(tmp_path / f"{k}.vtk") for k in ("t", "s")}
    TP.save_mesh(paths["t"], t)
    TP.save_mesh(paths["s"], s)
    art = tmp_path / "reg.pt"
    base = ["register", paths["t"], paths["s"], "--aot", str(art), "--device", "cpu"]
    assert TCLI.main(base + ["-o", str(tmp_path / "o1")] + FAST) == 0
    assert art.exists() and (tmp_path / "reg.pt.meta.json").exists()
    assert TCLI.main(base + ["-o", str(tmp_path / "o2")] + FAST) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "o1" / "correspondences.npy"),
                                  np.load(tmp_path / "o2" / "correspondences.npy"))
    assert TCLI.main(base + ["-o", str(tmp_path / "o3"), "--non-rigid-max-iterations",
                             "11"] + FAST[2:]) == 2


def test_warmup_export(tmp_path, capsys):
    t, s = _pair()
    paths = {k: str(tmp_path / f"{k}.vtk") for k in ("t", "s")}
    TP.save_mesh(paths["t"], t)
    TP.save_mesh(paths["s"], s)
    for name in ("w.pt", "w.ptexec"):
        assert TCLI.main(["warmup", paths["t"], paths["s"], "--export",
                          str(tmp_path / name), "--device", "cpu"] + FAST) == 0
        out = json.loads(capsys.readouterr().out)
        assert sorted(out) == ["compile_plus_first_run_s", "export", "export_s", "n_source",
                               "n_target"]
        meta = json.loads(open(tmp_path / f"{name}.meta.json").read())
        assert meta["format"] == ("compiled" if name.endswith(".ptexec") else "portable")
    assert native.build_seconds() is not None


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_port_imports_jax():
    """Every module of the port and ``chip_smoke.py``, read as source (the
    imports inside functions included), and the new entry points imported
    in a fresh interpreter where jax cannot be imported."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pyfocusr_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "pyfocusr_tpu")]
    assert not bad, bad
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'pyfocusr_tpu'): sys.modules[name] = None\n"
            "import pyfocusr_tpu_torch.cli, pyfocusr_tpu_torch.main, "
            "pyfocusr_tpu_torch.utils.aot\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
