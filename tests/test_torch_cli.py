"""Port parity for the command line: ``pyfocusr_tpu_torch.cli`` against
``pyfocusr_tpu.cli`` on the synthetic bone pair (``chip_smoke.
synthetic_bone`` subdivided 3 times: 642 vertices; seeds 2, 1 and 3; the
multires runs on seeds 2 and 1 subdivided 4 times: 2562 vertices).

JAX's ``cli.main`` runs as ``tests/test_cli.py`` runs it, in a fresh
interpreter on the CPU (here one interpreter for every JAX invocation of
the module, with its compilation cache in a temporary directory); the
port's runs in this process with ``--device cpu``.  The port's
``make_draws`` is replaced by JAX's draws for ``PRNGKey(s)``
(``test_torch_focusr.jax_make_draws``): the CLI's ``--seed s`` becomes
``torch.Generator().manual_seed(s)`` and the port hands ``make_draws``
``draw_seed`` of it, which the replacement maps back to ``s``.  Its
``make_cohort_draws`` is replaced by the draws of the key JAX's
``register_cohort`` took in the same round of the same invocation (the
JAX interpreter records each round's key and eigenvectors), and each
subject's solve takes the signs of JAX's eigenvectors
(``test_torch_cohort.jax_target_signs``, whose module says why).

Gates, and why:
* ``info``: the same JSON;
* ``convert``: the same JSON (paths aside) and the same file bytes (the
  port's writers are JAX's, byte for byte: ``tests/test_torch_io.py``);
* ``register`` (one source, two sources, a JAX-saved ``--save-prepared``
  file served with ``--prepared``; landmarks + features + transfer + html
  + quality; ``--feature-mode both`` with ``--features-in-adjacency`` and
  ``g-matrix``, each with ``--feature-weight``; ``--multires`` with
  ``--level-ratio`` and ``--checkpoint-dir``, its resume, and with
  landmarks and with features): the same output names and JSON keys,
  >= 95% equal correspondences and unique fractions within 0.02, the
  gates of ``tests/test_torch_focusr.py`` (eigenvector signs and f32
  rounding of two frameworks; CPD capped at 10 iterations on both sides,
  so no stop test in f32 noise decides the count);
* the resume: JAX's checkpoint file names, none written anew, and the
  first run's correspondences bit for bit, in each package;
* ``cohort``: the register gates per subject, the mean shape within a
  median of 1e-3 mm and a mean of 0.1 mm; ``ssm`` (``--template-index
  1 --n-modes 2``): template and mean within a median of 0.02 mm, motions
  rtol 2e-2, variances rtol 1e-2, modes |cos| >= 0.99 (each test says
  why); both: the same JSON keys and output names;
* the validation failures of ``tests/test_cli.py`` (landmarks, checkpoint,
  features, multires, warm start, ``--aot`` flags, ``convert``):
  the same exit code (2) and the same stderr, byte for byte;
* the helpers (``_output_stems``, ``_parse_landmark_file``,
  ``_landmark_pairs_for``, ``clamp_cohort_cfg``): JAX's results;
  ``_compute_node_features``: the same shapes and the 0..1 range,
  point_data columns within 1e-6 of JAX's, and curvature columns within
  ``tests/test_torch_focusr.py``'s bound for the principal curvatures
  (f32 rounding amplified by the discriminant: twice JAX's own distance
  from f64, plus 1e-5 of range).
"""

import collections
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu import cli as JCLI
from pyfocusr_tpu import pipeline as JP
from pyfocusr_tpu.mesh import TriMesh as JTriMesh
from pyfocusr_tpu_torch import cli as TCLI
from pyfocusr_tpu_torch.parallel import cohort as TC
from pyfocusr_tpu_torch.pipeline import draw_seed
from test_curvature_icp import make_sphere
from test_torch_cohort import _block_key, jax_target_signs
from test_torch_focusr import jax_make_draws
from test_torch_pipeline import _eig_block, _jax_draws, _solve_start

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORR_AGREE_MIN = 0.95
UNIQUE_DIFF_MAX = 0.02
FEATURE = chip_smoke.FEATURE
FAST = ["--non-rigid-max-iterations", "10", "--graph-smoothing-iterations", "10",
        "--n-coords-spectral-registration", "100", "--n-coords-spectral-ordering", "150"]
SEEDS = (0, 7)
# The multires runs decimate the 2562-vertex bones to ~600 vertices: from
# the 642 bones a coarse mesh of ~150 leaves the narrow eigensolver's last
# pairs unconverged in both packages and the coarse solves part ways.
MULTIRES_COARSE = "1000"
# The SSM's PCA runs on inputs that differ where a correspondence does (by
# up to an edge): measured 3.6e-3 relative on the variances and |cos| 0.9995
# and 0.9964 on the two modes (the second carries a ninth of the variance,
# so the same change of the covariance turns it more).
SSM_VARIANCE_RTOL = 1e-2
SSM_MODE_COS = 0.99


def _jax_cli_batch(runs: dict, tmp) -> dict:
    """Run JAX's ``cli.main`` on each argv of ``runs`` in one fresh
    interpreter on the CPU; {name: (exit code, stdout, stderr)}.  Each
    ``register_cohort`` call of a run is recorded in
    ``tmp/<name>_rounds.npz``: its key (``keys`` [R, 2]) and the subjects'
    eigenvectors (``vecs`` [R, B, N, k])."""
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import contextlib, io, json, sys\n"
        "import numpy as np\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from pyfocusr_tpu.cli import main\n"
        "from pyfocusr_tpu.parallel import cohort\n"
        "register_cohort, rounds = cohort.register_cohort, []\n"
        "def recorded(template, targets, cfg, key, *args, **kw):\n"
        "    res = register_cohort(template, targets, cfg, key, *args, **kw)\n"
        "    rounds.append((np.asarray(key), np.asarray(res[0]['eig_vecs_target'])))\n"
        "    return res\n"
        "cohort.register_cohort = recorded\n"
        "out = {}\n"
        "for name, argv in json.loads(sys.argv[1]).items():\n"
        "    o, e = io.StringIO(), io.StringIO()\n"
        "    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):\n"
        "        rc = main(argv)\n"
        "    out[name] = [rc, o.getvalue(), e.getvalue()]\n"
        "    if rounds:\n"
        f"        np.savez({str(tmp)!r} + f'/{{name}}_rounds.npz',\n"
        "                 keys=np.stack([k for k, _ in rounds]),\n"
        "                 vecs=np.stack([v for _, v in rounds]))\n"
        "        rounds.clear()\n"
        "print('RESULTS' + json.dumps(out))\n"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp / "jax_cache"))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(runs)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULTS"))
    return {k: tuple(v) for k, v in json.loads(line[len("RESULTS"):]).items()}


def _port_cli(argv):
    """The port's ``cli.main`` in this process: (exit code, stdout, stderr)."""
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = TCLI.main(argv)
    return rc, o.getvalue(), e.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The meshes every invocation reads, written by the port's writer."""
    d = tmp_path_factory.mktemp("cli_meshes")
    paths = {}
    for name, seed, levels in (("t", 2, 3), ("s", 1, 3), ("s2", 3, 3), ("t4", 2, 4),
                               ("s4", 1, 4)):
        paths[name] = str(d / f"{name}.vtk")
        TP.save_mesh(paths[name], chip_smoke.synthetic_bone(TP, seed, levels=levels))
    pts, tris = make_sphere(n_theta=10, n_phi=20)  # 182 vertices
    sphere = TP.TriMesh(pts.astype(np.float32), tris)
    paths["sphere"] = str(d / "sphere.vtk")
    TP.save_mesh(paths["sphere"], sphere)
    paths["disp3"] = str(d / "disp3.vtk")
    TP.save_mesh(paths["disp3"], sphere.with_point_data("disp", pts.astype(np.float32)))
    paths["disp1"] = str(d / "disp1.vtk")
    TP.save_mesh(paths["disp1"], sphere.with_point_data("disp", pts[:, 0].astype(np.float32)))
    texts = {
        "lm_idx": "10 10\n300 310\n600 590\n",
        "lm_many": "".join(f"{i} {i}\n" for i in range(600)),
        "lm_badint": "3.5 2\n",
        "lm_one": "0 0\n",
        "lm_200": "0 0\n" * 200,
    }
    for name, text in texts.items():
        paths[name] = str(d / f"{name}.txt")
        with open(paths[name], "w") as fh:
            fh.write(text)
    paths["missing"] = str(d / "nope.txt")
    paths["dir"] = str(d)
    return paths


def _success_runs(f, out):
    """name -> argv (without the port's ``--device``) of each run both
    packages make; outputs under ``out``."""
    t, s, s2 = f["t"], f["s"], f["s2"]
    t4, s4 = f["t4"], f["s4"]
    multires = ["register", t4, s4, "--multires", MULTIRES_COARSE, "--level-ratio", "2",
                "--checkpoint-dir", f"{out}/checkpoints"] + FAST
    return {
        "info": ["info", s],
        "convert_ply": ["convert", s, f"{out}/m.ply"],
        "convert_vtp": ["convert", s, f"{out}/m.vtp"],
        "register": ["register", t, s, "-o", f"{out}/single", "--quality"] + FAST,
        "register_seed7": ["register", t, s, "-o", f"{out}/seed7", "--seed", "7"] + FAST,
        "register_multi": ["register", t, s, s2, "-o", f"{out}/multi"] + FAST,
        "register_save_prepared": ["register", t, s, "-o", f"{out}/saved",
                                   "--save-prepared", f"{out}/prep.npz"] + FAST,
        "register_options": ["register", t, s, "-o", f"{out}/options",
                             "--landmarks", f["lm_idx"], "--landmark-weight", "200",
                             "--features", "curvature", "--transfer-point-data", "all",
                             "--html", "--quality"] + FAST,
        "register_features_both": ["register", t, s, "-o", f"{out}/features_both",
                                   "--features", "curvature", "--feature-mode", "both",
                                   "--features-in-adjacency", "--feature-weight", "2"] + FAST,
        "register_features_gmatrix": ["register", t, s, "-o", f"{out}/features_gmatrix",
                                      "--features", "max_curvature", "--feature-mode",
                                      "g-matrix", "--feature-weight", "0.5"] + FAST,
        # An intermediate level (2562 > 2 x 1000) and its checkpoints, then
        # the same invocation again into another directory: a resume.
        "register_multires": multires + ["-o", f"{out}/multires"],
        "register_multires_resume": multires + ["-o", f"{out}/multires_resume"],
        "register_multires_landmarks": ["register", t4, s4, "-o",
                                        f"{out}/multires_landmarks", "--multires",
                                        MULTIRES_COARSE, "--landmarks", f["lm_idx"],
                                        "--landmark-weight", "200"] + FAST,
        "register_multires_features": ["register", t4, s4, "-o", f"{out}/multires_features",
                                       "--multires", MULTIRES_COARSE, "--features",
                                       "curvature", "--features-in-adjacency"] + FAST,
        "cohort": ["cohort", t, s, s2, "-o", f"{out}/cohort"] + FAST,
        "ssm": ["ssm", t, s, s2, "-o", f"{out}/ssm", "--iterations", "2", "--sample", "1",
                "--project", s, "--html", "--template-index", "1", "--n-modes", "2"] + FAST,
    }


def _failure_runs(f):
    """name -> argv of each validation failure ``tests/test_cli.py`` checks."""
    t, s, d = f["t"], f["s"], f["dir"]
    sph = f["sphere"]
    return {
        "landmark_weight_without_landmarks": ["register", t, s, "--landmark-weight", "50",
                                              "-o", d],
        "landmarks_missing_file": ["register", t, s, "--landmarks", f["missing"], "-o", d],
        "landmarks_not_integer": ["register", t, s, "--landmarks", f["lm_badint"], "-o", d],
        "landmark_weight_zero": ["register", t, s, "--landmarks", f["lm_one"],
                                 "--landmark-weight", "0", "-o", d],
        "landmarks_above_subsample": ["register", t, s, "--landmarks", f["lm_many"],
                                      "--n-coords-spectral-registration", "500", "-o", d],
        "landmarks_above_effective_subsample": ["register", sph, sph, "--landmarks",
                                                f["lm_200"], "-o", d],
        "checkpoint_dir_without_multires": ["register", t, s, "-o", d, "--checkpoint-dir",
                                            f"{d}/ck"],
        "features_in_adjacency_without_features": ["register", t, s,
                                                   "--features-in-adjacency", "-o", d],
        "features_not_on_mesh": ["register", t, s, "--features", "no_such_array", "-o", d],
        "features_width_mismatch": ["register", f["disp3"], f["disp1"], "--features", "disp",
                                    "-o", d],
        "multires_multi_source": ["register", t, s, s, "--multires", "300", "-o", d],
        "multires_prepared": ["register", t, s, "--multires", "300", "--prepared",
                              f["missing"], "-o", d],
        "warm_from_with_prepared": ["register", t, s, "--warm-from", f["missing"],
                                    "--prepared", f["missing"], "-o", d],
        "warm_from_missing": ["register", t, s, "--warm-from", f["missing"], "-o", d],
        "aot_with_multires": ["register", t, s, "--aot", f"{d}/x.pt", "--multires", "100"],
        "aot_with_prepared": ["register", t, s, "--aot", f"{d}/x.pt", "--prepared",
                              f["missing"]],
        "aot_with_save_prepared": ["register", t, s, "--aot", f"{d}/x.pt",
                                   "--save-prepared", f"{d}/p.npz"],
        "aot_with_landmarks": ["register", t, s, "--aot", f"{d}/x.pt", "--landmarks",
                               f["lm_one"]],
        "convert_bad_extension": ["convert", s, f"{d}/m.xyz"],
    }


def _with_device(argv):
    return argv if argv[0] in ("info", "convert") else argv + ["--device", "cpu"]


@pytest.fixture(scope="module")
def port_draws_are_jax():
    """``make_draws`` of the port replaced by JAX's draws for the seed the
    CLI was given."""
    by_draw_seed = {draw_seed(torch.Generator().manual_seed(s)): s for s in SEEDS}
    port_make_draws = TP.pipeline.make_draws

    def make_draws(seed, cfg, n_target, n_source, n_landmarks=0, source_block=False,
                   real_target=None, real_source=None):
        if seed not in by_draw_seed:  # ssm --project's seeds: the port's own draws
            return port_make_draws(seed, cfg, n_target, n_source, n_landmarks,
                                   source_block, real_target, real_source)
        return jax_make_draws(by_draw_seed[seed], cfg, n_target, n_source, n_landmarks)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP.pipeline, "make_draws", make_draws)
        mp.setattr(TC, "make_cohort_draws", COHORT_ROUNDS)
        yield


class _JaxCohortRounds:
    """The port's ``make_cohort_draws`` replaced by the draws JAX's
    ``register_cohort`` made in the same round of the same invocation
    (``load`` takes the rounds ``_jax_cli_batch`` recorded), rebuilt from
    its key as ``test_torch_cohort._cohort_draws`` rebuilds them; ``refs``
    collects each subject solve's start with JAX's eigenvectors of it, for
    ``test_torch_cohort.jax_target_signs`` (that module's docstring says
    why the signs must be given)."""

    def __init__(self):
        self.rounds, self.refs = [], {}

    def load(self, path):
        with np.load(path) as z:
            self.rounds = list(zip(z["keys"], z["vecs"]))
        self.refs = {}

    def __call__(self, seed, cfg, template, targets):
        assert self.rounds, "the port made more cohort rounds than JAX"
        key, vecs = self.rounds.pop(0)
        key = jnp.asarray(key, jnp.uint32)
        jcfg = JP.PipelineConfig(**dataclasses.asdict(cfg))
        batch = targets.points.shape[0]

        def graph(mask):
            return types.SimpleNamespace(n_points=mask.shape[0],
                                         valid_mask=jnp.asarray(mask.cpu().numpy()))

        keys = jax.random.split(key, batch)
        tk = jax.random.fold_in(key, batch)
        solver = TP.pipeline._solver(cfg, template.n_points)
        block = (_eig_block(tk, template.n_points, jcfg) if solver == "wide"
                 else _solve_start(tk, template.n_points, jcfg, solver))
        pairs = [_jax_draws(keys[i], jcfg, graph(targets.valid_mask[i]),
                            graph(template.valid_mask)) for i in range(batch)]
        for pair, v in zip(pairs, vecs):
            if "eig_start_target" in pair:
                self.refs[_block_key(pair["eig_start_target"])] = v
        return {"pairs": pairs, "template_block": block}


COHORT_ROUNDS = _JaxCohortRounds()


def _mtimes(directory):
    return {str(p.relative_to(directory)): p.stat().st_mtime_ns
            for p in sorted(directory.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory, port_draws_are_jax):
    """Every run through both packages: {name: (jax, port, jax_out, port_out)};
    ``"checkpoints"``: the port's checkpoint files with their mtimes after
    the first multires run and after the resume."""
    root = tmp_path_factory.mktemp("cli_runs")
    jout, pout = root / "jax", root / "port"
    jout.mkdir()
    pout.mkdir()
    jax_res = _jax_cli_batch({**_success_runs(files, jout), **_failure_runs(files)}, root)
    out = {"checkpoints": []}
    for name, argv in _success_runs(files, pout).items():
        with contextlib.ExitStack() as stack:
            if name in ("cohort", "ssm"):
                COHORT_ROUNDS.load(root / f"{name}_rounds.npz")
                stack.enter_context(jax_target_signs(COHORT_ROUNDS.refs))
            port = _port_cli(_with_device(argv))
            if name in ("cohort", "ssm"):
                assert not COHORT_ROUNDS.rounds, "the port made fewer cohort rounds than JAX"
        out[name] = (jax_res[name], port, jout, pout)
        if name in ("register_multires", "register_multires_resume"):
            out["checkpoints"].append(_mtimes(pout / "checkpoints"))
    # The JAX-saved prepared state, served by the port.
    served = ["register", files["t"], files["s"], "-o", f"{pout}/served",
              "--prepared", f"{jout}/prep.npz"] + FAST
    out["jax_prepared_served"] = (jax_res["register_save_prepared"],
                                  _port_cli(_with_device(served)), jout, pout)
    for name, argv in _failure_runs(files).items():
        out[name] = (jax_res[name], _port_cli(_with_device(argv)), None, None)
    return out


def _gates(j_corr, p_corr, what):
    assert j_corr.shape == p_corr.shape and p_corr.dtype == j_corr.dtype, what
    agree = float((j_corr == p_corr).mean())
    n = j_corr.shape[-1]
    du = abs(len(np.unique(j_corr)) - len(np.unique(p_corr))) / n
    assert agree >= CORR_AGREE_MIN, (what, agree)
    assert du <= UNIQUE_DIFF_MAX, (what, du)


def test_info_same_json(runs):
    (jrc, jout, _), (prc, pout, _), _, _ = runs["info"]
    assert jrc == prc == 0
    assert json.loads(pout) == json.loads(jout)


@pytest.mark.parametrize("name,ext", [("convert_ply", "ply"), ("convert_vtp", "vtp")])
def test_convert_same_json_and_bytes(runs, name, ext):
    (jrc, jout, _), (prc, pout, _), jdir, pdir = runs[name]
    assert jrc == prc == 0
    jj, pj = json.loads(jout), json.loads(pout)
    assert jj.pop("output").replace(str(jdir), str(pdir)) == pj.pop("output")
    assert jj == pj
    assert (pdir / f"m.{ext}").read_bytes() == (jdir / f"m.{ext}").read_bytes()
    back = TP.load_mesh(str(pdir / f"m.{ext}"))
    assert back.n_points == pj["points"] and sorted(back.point_data) == pj["point_data"]


@pytest.mark.parametrize("name,sub,stems", [
    ("register", "single", [""]),
    ("register_seed7", "seed7", [""]),
    ("register_multi", "multi", ["s_", "s2_"]),
    ("register_save_prepared", "saved", [""]),
    ("register_options", "options", [""]),
    ("jax_prepared_served", "served", [""]),
    ("register_features_both", "features_both", [""]),
    ("register_features_gmatrix", "features_gmatrix", [""]),
    ("register_multires", "multires", [""]),
    ("register_multires_resume", "multires_resume", [""]),
    ("register_multires_landmarks", "multires_landmarks", [""]),
    ("register_multires_features", "multires_features", [""]),
])
def test_register_matches_jax(runs, name, sub, stems):
    (jrc, jout, jerr), (prc, pout, perr), jdir, pdir = runs[name]
    assert jrc == 0, jerr[-800:]
    assert prc == 0, perr[-800:]
    jj, pj = json.loads(jout), json.loads(pout)
    jj, pj = (jj, pj) if isinstance(jj, list) else ([jj], [pj])
    jsub = "saved" if name == "jax_prepared_served" else sub
    for stem, js, ps in zip(stems, jj, pj):
        assert sorted(js) == sorted(ps)
        assert js["outputs"] == ps["outputs"]
        if "quality" in js:
            assert sorted(js["quality"]) == sorted(ps["quality"])
        for key in ("n_source_points", "landmarks"):
            assert js.get(key) == ps.get(key)
        j_corr = np.load(jdir / jsub / f"{stem}correspondences.npy")
        p_corr = np.load(pdir / sub / f"{stem}correspondences.npy")
        _gates(j_corr, p_corr, f"{name} {stem}")
        assert abs(js["unique_correspondences"] - ps["unique_correspondences"]) <= (
            UNIQUE_DIFF_MAX * ps["n_source_points"])
        p_mesh = TP.load_mesh(str(pdir / sub / f"{stem}transformed_source.vtk"))
        j_mesh = TP.load_mesh(str(jdir / jsub / f"{stem}transformed_source.vtk"))
        assert sorted(p_mesh.point_data) == sorted(j_mesh.point_data)
        assert np.isfinite(p_mesh.points).all()


@pytest.mark.parametrize("name,corr_file", [("cohort", "cohort/cohort_correspondences.npy"),
                                            ("ssm", "ssm/ssm_modes.npz")])
def test_cohort_and_ssm_keys_match_jax(runs, name, corr_file):
    (jrc, jout, jerr), (prc, pout, perr), jdir, pdir = runs[name]
    assert jrc == 0, jerr[-800:]
    assert prc == 0, perr[-800:]
    jj, pj = json.loads(jout), json.loads(pout)
    assert sorted(jj) == sorted(pj)
    assert jj["outputs"] == pj["outputs"]
    for out in pj["outputs"]:
        assert (pdir / name / out).exists(), out
    if name == "cohort":
        assert np.load(pdir / corr_file).shape == np.load(jdir / corr_file).shape
        assert pj["devices_used"] == 1 and min(pj["unique_fraction_per_subject"]) > 0.3
    else:
        assert sorted(pj["projections"]) == sorted(jj["projections"])
        with np.load(pdir / corr_file) as pz, np.load(jdir / corr_file) as jz:
            assert {k: pz[k].shape for k in pz} == {k: jz[k].shape for k in jz}


def test_multires_checkpoint_resume_matches_jax(runs):
    """``--checkpoint-dir``: the first run writes the coarse stage of each
    level (the intermediate level in its ``level_<n>`` directory) under
    JAX's file names; the same invocation again resumes from them, writes
    none of them anew, and gives the first run's correspondences bit for
    bit, in each package."""
    (_, _, _), (_, _, _), jdir, pdir = runs["register_multires"]
    first, resumed = runs["checkpoints"]
    assert sorted(first) == sorted(_mtimes(jdir / "checkpoints"))
    assert "coarse.npz" in first and any(n.startswith("level_") for n in first)
    assert resumed == first
    for d in (jdir, pdir):
        np.testing.assert_array_equal(np.load(d / "multires_resume" / "correspondences.npy"),
                                      np.load(d / "multires" / "correspondences.npy"))


def _points(path):
    return np.asarray(TP.load_mesh(str(path)).points, np.float64)


def _check_points(want, got, median):
    """Per-vertex distances (mm): median and mean within the gates."""
    d = np.linalg.norm(np.asarray(want, np.float64) - np.asarray(got, np.float64), axis=-1)
    assert np.median(d) <= median and d.mean() <= 0.1, (np.median(d), d.mean())


def test_cohort_matches_jax(runs):
    """The cohort from JAX's draws (each subject's solve with JAX's
    eigenvector signs): per subject >= 95% equal correspondences and unique
    fractions within 0.02; the mean shape within a median of 1e-3 mm and a
    mean of 0.1 mm (``tests/test_torch_cohort.py``'s gates for the cohort
    mean: the vertices whose correspondence differs move by up to an
    edge)."""
    (_, jout, _), (_, pout, _), jdir, pdir = runs["cohort"]
    jc = np.load(jdir / "cohort" / "cohort_correspondences.npy")
    pc = np.load(pdir / "cohort" / "cohort_correspondences.npy")
    assert jc.shape == pc.shape == (2, 642)
    for b in range(jc.shape[0]):
        _gates(jc[b], pc[b], f"cohort subject {b}")
    np.testing.assert_allclose(json.loads(pout)["unique_fraction_per_subject"],
                               json.loads(jout)["unique_fraction_per_subject"],
                               atol=UNIQUE_DIFF_MAX)
    _check_points(_points(jdir / "cohort" / "mean_shape.vtk"),
                  _points(pdir / "cohort" / "mean_shape.vtk"), median=1e-3)


def test_ssm_matches_jax(runs):
    """The SSM from JAX's draws of both rounds, seeded from the second
    mesh, two modes: the template and the modes' mean within a median of
    0.02 mm and a mean of 0.1 mm, the motions within rtol 2e-2 (the gates of
    ``tests/test_torch_cohort.py`` for a template after Procrustes: a fit
    over every vertex, which the few differing correspondences move a
    little); the variances within rtol 1e-2 and each mode within |cos| >=
    0.99 up to sign (``SSM_VARIANCE_RTOL``, ``SSM_MODE_COS``: a PCA of
    those inputs)."""
    (_, jout, _), (_, pout, _), jdir, pdir = runs["ssm"]
    jj, pj = json.loads(jout), json.loads(pout)
    assert pj["iterations"] == jj["iterations"] == 2
    np.testing.assert_allclose(pj["template_motion_trace"], jj["template_motion_trace"],
                               rtol=2e-2)
    _check_points(_points(jdir / "ssm" / "ssm_template.vtk"),
                  _points(pdir / "ssm" / "ssm_template.vtk"), median=0.02)
    with np.load(jdir / "ssm" / "ssm_modes.npz") as jz, \
            np.load(pdir / "ssm" / "ssm_modes.npz") as pz:
        assert pz["modes"].shape == jz["modes"].shape == (2, 642, 3)
        _check_points(jz["mean"], pz["mean"], median=0.02)
        np.testing.assert_allclose(pz["motions"], jz["motions"], rtol=2e-2)
        np.testing.assert_allclose(pz["variances"], jz["variances"],
                                   rtol=SSM_VARIANCE_RTOL)
        for i in range(2):
            cos = abs(float(np.sum(pz["modes"][i].astype(np.float64) * jz["modes"][i])))
            assert cos >= SSM_MODE_COS, (i, cos)


@pytest.mark.parametrize("name", list(_failure_runs(collections.defaultdict(str))))
def test_validation_failures_match_jax(runs, name):
    """Exit code 2 and JAX's message, byte for byte."""
    (jrc, _, jerr), (prc, _, perr), _, _ = runs[name]
    assert jrc == 2, jerr[-500:]
    assert (prc, perr) == (jrc, jerr)


def test_output_stems_match_jax():
    for paths in (["a/mesh.vtk", "b/mesh.vtk", "c/other.ply"], ["x.vtk"],
                  ["a/mesh.vtk", "b/mesh.vtk", "c/mesh_1.vtk"]):
        assert TCLI._output_stems(paths) == JCLI._output_stems(paths)
    assert TCLI._output_stems(["a/mesh.vtk", "b/mesh.vtk", "c/mesh_1.vtk"])[2] == "mesh_1"


@pytest.mark.parametrize("text", [
    "# header comment\n3 17\n5, 2  # trailing comment\n\n",
    "0 0 0 1 1 1\n0.5, 0.5, 0.5, 2, 2, 2\n",
    "1 2 3\n", "1 2\n0 0 0 1 1 1\n", "# only comments\n",
    "0 0 0 1 1 1\nnan nan nan 2 2 2\n", "3.5 2\n",
])
def test_parse_landmark_file_matches_jax(tmp_path, text):
    p = tmp_path / "lm.txt"
    p.write_text(text)

    def call(fn):
        try:
            return fn(str(p))
        except ValueError as exc:
            return ("ValueError", str(exc))

    want, got = call(JCLI._parse_landmark_file), call(TCLI._parse_landmark_file)
    if want[0] == "ValueError":
        assert got == want
    else:
        assert got[0] == want[0] and got[1].dtype == want[1].dtype
        np.testing.assert_array_equal(got[1], want[1])


def test_landmark_pairs_for_matches_jax():
    tri = np.array([[0, 1, 2]], np.int32)
    m3 = TP.TriMesh(np.zeros((3, 3), np.float32), tri)
    m5 = TP.TriMesh(np.zeros((5, 3), np.float32), tri)
    with pytest.raises(ValueError, match="source index out of range"):
        TCLI._landmark_pairs_for("index", np.array([[4, 0]]), target=m5, source=m3)
    with pytest.raises(ValueError, match="target index out of range"):
        TCLI._landmark_pairs_for("index", np.array([[0, 4]]), target=m3, source=m5)
    pairs, snap = TCLI._landmark_pairs_for("index", np.array([[2, 4]]), target=m5, source=m3)
    assert snap is None
    np.testing.assert_array_equal(pairs, [[2, 4]])
    # Positions snap to the nearest vertices: JAX's pairs and distance.
    t = chip_smoke.synthetic_bone(TP, 2, levels=3)
    s = chip_smoke.synthetic_bone(TP, 1, levels=3)
    rows = np.concatenate([s.points[[5, 90]] + 0.01, t.points[[7, 200]] - 0.02], axis=1)
    jt, js = (JTriMesh(m.points, m.triangles, {}) for m in (t, s))
    want = JCLI._landmark_pairs_for("position", rows.astype(np.float64), jt, js)
    got = TCLI._landmark_pairs_for("position", rows.astype(np.float64), t, s, device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    # The snap distance against f64 (JAX's CPU route takes the matmul
    # identity, ~1e-4 off on these coordinates; the port differences).
    exact = max(np.linalg.norm(rows[:, :3] - s.points[got[0][:, 0]].astype(np.float64), axis=1)
                .max(), np.linalg.norm(rows[:, 3:] - t.points[got[0][:, 1]].astype(np.float64),
                                       axis=1).max())
    assert abs(got[1] - exact) <= 1e-6


def _normalized(x):
    """Graph's feature normalization (z-score capped at 3, then 0-1) in f64."""
    std = x.std()
    x = np.clip((x - x.mean()) / (std if std > 0 else 1.0), -3.0, 3.0)
    ptp = np.ptp(x)
    return (x - x.min()) / (ptp if ptp > 0 else 1.0)


@pytest.mark.parametrize("mesh", ["sphere", "bone"])
def test_compute_node_features_matches_jax(mesh):
    """Point_data columns within 1e-6 of JAX's; curvature columns within
    ``tests/test_torch_focusr.py``'s bound for the principal curvatures:
    twice JAX's own distance from the f64 evaluation (here of the
    normalized column) plus 1e-5 of the column's range."""
    from pyfocusr_tpu_torch.mesh import build_topology
    from pyfocusr_tpu_torch.ops import curvature as TCurv

    if mesh == "sphere":
        pts, tris = make_sphere(n_theta=10, n_phi=20)
        pts = pts.astype(np.float32)
    else:
        bone = chip_smoke.synthetic_bone(TP, 2, levels=3)
        pts, tris = np.asarray(bone.points, np.float32), np.asarray(bone.triangles)
    pd = {"t": (pts[:, 0] ** 2).astype(np.float32), "vec": pts.astype(np.float32)}
    tm = TP.TriMesh(pts, tris, pd)
    jm = JTriMesh(pts, tris, pd)
    topo = build_topology(tris, pts.shape[0])
    kmin, kmax = (_normalized(k.numpy()) for k in TCurv.principal_curvatures(
        torch.tensor(pts, dtype=torch.float64), tris, topo.edges, topo.edge_faces))
    # Graph's columns: computed features first, then point_data ones.
    for names, exact, data_cols in ((["curvature"], [kmin, kmax], []),
                                    (["t", "max_curvature"], [kmax], [1]),
                                    (["t", "vec"], [], [0, 1, 2, 3])):
        got = TCLI._compute_node_features(tm, names, device="cpu")
        want = np.asarray(JCLI._compute_node_features(jm, names))
        assert got.shape == want.shape == (pts.shape[0], len(exact) + len(data_cols))
        assert np.all(np.isfinite(got)) and got.min() >= 0.0 and got.max() <= 1.0
        np.testing.assert_allclose(got[:, data_cols], want[:, data_cols], atol=1e-6)
        for c, e in enumerate(exact):
            w, g = want[:, c].astype(np.float64), got[:, c].astype(np.float64)
            bound = 2.0 * np.abs(w - e).max() + 1e-5 * np.ptp(w)
            assert np.abs(g - w).max() <= bound, (names, c, np.abs(g - w).max(), bound)


def test_clamp_cohort_cfg():
    """JAX's rule (a closure inside its ``main``, :469): both subsample knobs
    clamped to the smallest mesh, nothing else changed."""
    t = TP.TriMesh(np.zeros((120, 3), np.float32), np.zeros((0, 3), np.int32))
    s = TP.TriMesh(np.zeros((90, 3), np.float32), np.zeros((0, 3), np.int32))
    got = TCLI.clamp_cohort_cfg(TP.PipelineConfig(), [t, s])
    assert (got.n_coords_spectral_ordering, got.n_coords_spectral_registration) == (90, 90)
    assert dataclasses.replace(got, n_coords_spectral_ordering=5000,
                               n_coords_spectral_registration=1000) == TP.PipelineConfig()


def test_device_defaults_to_the_card(files, monkeypatch):
    """Without ``--device`` a registering subcommand builds on the card
    and raises where there is none; ``info`` needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI.main(["register", files["t"], files["s"], "-o", files["dir"]])
    assert _port_cli(["info", files["sphere"]])[0] == 0


def test_one_card_note(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    TCLI._one_card_note(torch.device("cuda"), 8)
    TCLI._one_card_note(torch.device("cuda"), 6)  # 4 does not divide 6: JAX stays on one
    TCLI._one_card_note(torch.device("cpu"))
    err = capsys.readouterr().err
    assert err.count("note:") == 1 and "item 9" in err


def test_main_reexports_print_header(capsys):
    from pyfocusr_tpu_torch import main as TMAIN

    TMAIN.print_header("x")
    assert capsys.readouterr().out == "=" * 72 + "\nx\n" + "=" * 72 + "\n"
