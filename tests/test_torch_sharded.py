"""The port's sharded many-pair paths on four gloo ranks on the CPU
(``parallel/distributed.spawn``), held to the port's one-device results:
``register_cohort``, ``iterate_template`` and ``build_ssm_template`` over a
``'cohort'`` mesh, ``register_all_pairs`` over ``'pairs'`` (six pairs on
four ranks: padded to eight) and over a two-axis ``('pairs', 'model')``
mesh, ``register_pair_multires`` over ``'verts'``, the CLI's sharded
branch (``cli._rank_main``: ``cohort`` and ``register --multires``), and
JAX's error cases with JAX's types and messages.

Gates: the cohort's and all-pairs' lanes bit-equal to the one-device lanes
(each lane draws from its own generator and every rank runs one intra-op
thread, as this process does); the cohort mean within 1e-6 relative (the
all-reduce sums in another order); ``iterate_template``, whose later rounds
start from that mean, at ``tests/test_torch_cohort.py``'s gates: the
registration gates (>= 95% equal correspondences, weighted points median
<= 1e-3 mm), the template median <= 0.02 mm and mean <= 0.1 mm, motions
rtol 2e-2; multires at
``tests/test_bigmesh.py``'s gates.  Every rank must return the same global
arrays.

Per-lane randomness: a lane registered alone equals the same lane inside
the loop bit for bit, with the eigensolver's refill drawing from the lane's
generator: 162-vertex bones padded to 2048 rows take the wide solver with
a 256-column block, more columns than real rows, so the block is topped
up.

All ranks run in one spawned group (``ranks``); this module imports no JAX
at its top, because every rank imports it to find its function.
"""

import contextlib
import inspect
import io
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch import cli as TCLI
from pyfocusr_tpu_torch import multires as TMR
from pyfocusr_tpu_torch.ops import eigen
from pyfocusr_tpu_torch.parallel import cohort as TC
from pyfocusr_tpu_torch.parallel import distributed
from pyfocusr_tpu_torch.parallel import groupwise as TG

torch.set_num_threads(1)

N_RANKS = 4
# tests/test_torch_cohort.py's configuration.
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
CFG = TP.PipelineConfig(**KW)
# The multires runs: tests/test_torch_cli.py's FAST flags, the 642 bones
# decimated to ~200 vertices (a single jump).  Only the port's runs are
# compared, so the coarse solve's convergence does not matter here.
MR_KW = dict(non_rigid_max_iterations=10, graph_smoothing_iterations=10,
             n_coords_spectral_registration=100, n_coords_spectral_ordering=150)
MR_COARSE = 200
CLI_FAST = ["--non-rigid-max-iterations", "10", "--graph-smoothing-iterations", "10",
            "--n-coords-spectral-registration", "100", "--n-coords-spectral-ordering", "150"]
MR_MESHES = ((2, 3), (1, 3))  # (seed, levels) of the multires target and source
SEED = 0
CORR_AGREE_MIN = 0.95


def _gen():
    return torch.Generator().manual_seed(SEED)


def _np(res):
    return {k: v.numpy() for k, v in res.items()}


def _cohort_meshes():
    """Template (seed 2, 642 vertices) and four subjects: seed 1 at 642,
    seeds 3-5 at 2562 decimated to ~600 (so the cohort is padded)."""
    meshes = [chip_smoke.synthetic_bone(TP, 2, 3), chip_smoke.synthetic_bone(TP, 1, 3)]
    for seed in (3, 4, 5):
        meshes.append(TP.decimate(chip_smoke.synthetic_bone(TP, seed, 4), 600, seed=seed)[0])
    return meshes


def _capture(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    return rc, out.getvalue()


def _error(fn):
    """(type name, message) of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as exc:  # the types are compared by the tests
        return type(exc).__name__, str(exc)
    return None


def _rank_body(inp):
    """One rank: every sharded call of the file."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    cohort = init_device_mesh("cpu", (n,), mesh_dim_names=("cohort",))
    pairs = init_device_mesh("cpu", (n,), mesh_dim_names=("pairs",))
    pairs2 = init_device_mesh("cpu", (2, n // 2), mesh_dim_names=("pairs", "model"))
    verts = init_device_mesh("cpu", (n,), mesh_dim_names=("verts",))
    out = {}
    res, mean = TC.register_cohort(inp["template"], inp["subjects"], CFG, _gen(),
                                   device_mesh=cohort)
    out["register_cohort"] = (_np(res), mean.numpy())
    tmpl, res, motions = TC.iterate_template(inp["template"], inp["subjects"], CFG, _gen(),
                                             n_iterations=2, device_mesh=cohort)
    out["iterate_template"] = (tmpl.points.numpy(), _np(res), motions)
    tm, res, motions = TC.build_ssm_template(inp["meshes"][1:], CFG, _gen(), n_iterations=1,
                                             device_mesh=cohort)
    out["build_ssm_template"] = (np.asarray(tm.points), _np(res), motions)
    for name, mesh in (("register_all_pairs", pairs), ("register_all_pairs_2d", pairs2)):
        corr, index, res = TG.register_all_pairs(inp["meshes"][:3], CFG, _gen(),
                                                 device_mesh=mesh)
        out[name] = (corr, index, _np(res))
    fine, coarse = TMR.register_pair_multires(
        *inp["multires"], TP.PipelineConfig(**MR_KW), _gen(), coarse_n=MR_COARSE,
        level_ratio=0, device_mesh=verts)
    out["register_pair_multires"] = (_np(fine), coarse["correspondences"].numpy())
    out["errors"] = {
        "indivisible_cohort": _error(lambda: TC.register_cohort(
            inp["template"], TC.stack_graph_arrays(inp["graphs3"]), CFG, _gen(),
            device_mesh=cohort)),
        "all_pairs_wrong_axis": _error(lambda: TG.register_all_pairs(
            inp["meshes"][:3], CFG, _gen(), device_mesh=cohort)),
        "features_in_adjacency": _error(lambda: TMR.register_pair_multires(
            *inp["multires"], TP.PipelineConfig(include_features_in_adj_matrix=True),
            device_mesh=verts, node_features=inp["features"])),
    }
    out["cli"] = {name: _capture(TCLI._rank_main, argv, axis, "cpu")
                  for name, (argv, axis) in inp["cli"].items()}
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    meshes = _cohort_meshes()
    graphs = TC.pad_cohort(meshes[1:], device="cpu")
    mr = tuple(chip_smoke.synthetic_bone(TP, seed, lv) for seed, lv in MR_MESHES)
    d = tmp_path_factory.mktemp("sharded")
    # The CLI's cohort: five 642-vertex bones, unpadded (the CLI keeps
    # JAX's ICP landmark count, 2000, which a padded cohort refuses).
    paths = []
    for seed in (2, 1, 3, 4, 5):
        paths.append(str(d / f"bone{seed}.vtk"))
        TP.save_mesh(paths[-1], chip_smoke.synthetic_bone(TP, seed, 3))
    for name, m in zip(("t4", "s4"), mr):
        TP.save_mesh(str(d / f"{name}.vtk"), m)
    cli = {
        "cohort": (["cohort"] + paths + CLI_FAST, "cohort"),
        "multires": (["register", str(d / "t4.vtk"), str(d / "s4.vtk"), "--multires",
                      str(MR_COARSE), "--level-ratio", "0"] + CLI_FAST, "verts"),
    }
    return {
        "meshes": meshes,
        "template": TP.mesh_to_graph_arrays(meshes[0], device="cpu"),
        "subjects": TC.stack_graph_arrays(graphs),
        "graphs3": graphs[:3],
        "multires": mr,
        "features": (np.ones((mr[0].n_points, 1), np.float32),
                     np.ones((mr[1].n_points, 1), np.float32)),
        "dir": d,
        "cli": cli,
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    rank_inputs = dict(inputs, cli={
        name: (argv + ["-o", str(inputs["dir"] / f"{name}_sharded")], axis)
        for name, (argv, axis) in inputs["cli"].items()})
    rank_inputs.pop("dir")
    return distributed.spawn(_rank_body, N_RANKS, "gloo", "cpu", args=(rank_inputs,),
                             threads=1)


def _bit_equal(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (what, k)
        assert a[k].tobytes() == b[k].tobytes(), (what, k)


def _gates(want, got, what):
    """The registration gates: >= 95% equal correspondences, weighted
    points' |delta| median <= 1e-3 mm."""
    agree = float(np.mean(want["correspondences"] == got["correspondences"]))
    assert agree >= CORR_AGREE_MIN, (what, agree)
    delta = np.linalg.norm(want["weighted_points"] - got["weighted_points"], axis=-1)
    assert float(np.median(delta)) <= 1e-3, (what, float(np.median(delta)))


def test_every_rank_returns_the_same_results(ranks):
    def flat(x, prefix=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from flat(v, f"{prefix}/{k}")
        elif isinstance(x, (tuple, list)) and not isinstance(x, str):
            for i, v in enumerate(x):
                yield from flat(v, f"{prefix}/{i}")
        else:
            yield prefix, x

    first = dict(flat({k: v for k, v in ranks[0].items() if k != "cli"}))
    for other in ranks[1:]:
        got = dict(flat({k: v for k, v in other.items() if k != "cli"}))
        assert set(got) == set(first)
        for k, v in first.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def test_sharded_register_cohort(inputs, ranks):
    """Lanes bit-equal to the one-device lanes, the mean within 1e-6."""
    res, mean = TC.register_cohort(inputs["template"], inputs["subjects"], CFG, _gen())
    got, got_mean = ranks[0]["register_cohort"]
    assert list(got) == list(res)
    _bit_equal(_np(res), got, "register_cohort")
    np.testing.assert_allclose(got_mean, mean.numpy(), rtol=1e-6, atol=1e-6 * 40)


def test_sharded_iterate_template(inputs, ranks):
    tmpl, res, motions = TC.iterate_template(inputs["template"], inputs["subjects"], CFG,
                                             _gen(), n_iterations=2)
    got_pts, got, got_motions = ranks[0]["iterate_template"]
    delta = np.linalg.norm(got_pts - tmpl.points.numpy(), axis=1)
    assert float(np.median(delta)) <= 0.02 and float(delta.mean()) <= 0.1, delta
    np.testing.assert_allclose(got_motions, motions, rtol=2e-2)
    for b in range(res["correspondences"].shape[0]):
        _gates({k: v[b].numpy() for k, v in res.items()},
               {k: v[b] for k, v in got.items()}, f"lane {b}")


def test_sharded_build_ssm_template(inputs, ranks):
    """One round: the lanes bit-equal, the template from the mean."""
    tm, res, motions = TC.build_ssm_template(inputs["meshes"][1:], CFG, _gen(),
                                             n_iterations=1, device="cpu")
    got_pts, got, got_motions = ranks[0]["build_ssm_template"]
    _bit_equal(_np(res), got, "build_ssm_template")
    np.testing.assert_allclose(got_pts, np.asarray(tm.points), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_motions, motions, rtol=1e-5)


@pytest.fixture(scope="module")
def all_pairs(inputs):
    return TG.register_all_pairs(inputs["meshes"][:3], CFG, _gen(), device="cpu")


@pytest.mark.parametrize("name", ["register_all_pairs", "register_all_pairs_2d"])
def test_sharded_register_all_pairs(all_pairs, ranks, name):
    """Six pairs: padded to eight on the 'pairs' axis of four, three a
    rank on the ('pairs', 'model') mesh; bit-equal to one device."""
    corr, index, res = all_pairs
    got_corr, got_index, got = ranks[0][name]
    assert got_index == index and len(index) == 6
    np.testing.assert_array_equal(got_corr, corr)
    _bit_equal(_np(res), got, name)


def test_sharded_register_pair_multires(inputs, ranks):
    fine, coarse = TMR.register_pair_multires(
        *inputs["multires"], TP.PipelineConfig(**MR_KW), _gen(), coarse_n=MR_COARSE,
        level_ratio=0, device="cpu")
    got, got_coarse = ranks[0]["register_pair_multires"]
    np.testing.assert_array_equal(got_coarse, coarse["correspondences"].numpy())
    assert list(got) == list(fine)
    agree = np.mean(fine["correspondences"].numpy() == got["correspondences"])
    assert agree >= 0.99, agree
    for k in ("weighted_points", "average_points", "smoothed_target_coords",
              "source_projected_on_target"):
        np.testing.assert_allclose(got[k], fine[k].numpy(), rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.fixture(scope="module")
def jax_errors(inputs):
    """JAX's own errors for the same cases, on its virtual CPU devices."""
    import jax
    from jax.sharding import Mesh

    from pyfocusr_tpu import multires as JMR
    from pyfocusr_tpu import pipeline as JP
    from pyfocusr_tpu.mesh import TriMesh as JTriMesh
    from pyfocusr_tpu.parallel import cohort as JC
    from pyfocusr_tpu.parallel import groupwise as JG

    def mesh(name):
        return Mesh(np.asarray(jax.devices()[:N_RANKS]).reshape(N_RANKS), (name,))

    def jm(m):
        return JTriMesh(np.asarray(m.points), np.asarray(m.triangles))

    meshes = [jm(m) for m in inputs["meshes"]]
    graphs = JC.pad_cohort(meshes[1:4])
    jcfg = JP.PipelineConfig(**KW)
    return {
        "indivisible_cohort": _error(lambda: JC.register_cohort(
            JP.mesh_to_graph_arrays(meshes[0]), JC.stack_graph_arrays(graphs), jcfg,
            jax.random.PRNGKey(0), mesh("cohort"), prepared_template=False)),
        "all_pairs_wrong_axis": _error(lambda: JG.register_all_pairs(
            meshes[:3], jcfg, jax.random.PRNGKey(0), device_mesh=mesh("cohort"))),
        "features_in_adjacency": _error(lambda: JMR.register_pair_multires(
            *(jm(m) for m in inputs["multires"]),
            JP.PipelineConfig(include_features_in_adj_matrix=True), jax.random.PRNGKey(0),
            device_mesh=mesh("verts"), node_features=inputs["features"])),
    }


@pytest.mark.parametrize("case", ["indivisible_cohort", "all_pairs_wrong_axis",
                                  "features_in_adjacency"])
def test_sharded_errors_match_jax(jax_errors, ranks, case):
    want = jax_errors[case]
    assert want is not None and want[0] == "ValueError", want
    for r in ranks:
        assert r["errors"][case] == want


def _cli_outputs(out_dir):
    out = {}
    for name in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, name)
        out[name] = (np.load(path) if name.endswith(".npy")
                     else np.asarray(TP.load_mesh(path).points))
    return out


@pytest.mark.parametrize("name", ["cohort", "multires"])
def test_cli_sharded_branch_writes_the_one_device_outputs(inputs, ranks, name):
    """The CLI's sharded branch on the ranks: rank 0 alone prints, the
    same JSON (``devices_used`` the rank count, as JAX's) and the same
    files as ``--device cpu`` in this process."""
    argv, _ = inputs["cli"][name]
    one_dir = inputs["dir"] / f"{name}_one"
    rc, text = _capture(TCLI.main, argv + ["-o", str(one_dir), "--device", "cpu"])
    assert rc == 0
    got_rc, got_text = ranks[0]["cli"][name]
    assert got_rc == 0 and all(r["cli"][name] == (0, "") for r in ranks[1:])
    want, got = json.loads(text), json.loads(got_text)
    for d in (want, got):
        d.pop("seconds")
    if name == "cohort":
        assert want.pop("devices_used") == 1 and got.pop("devices_used") == N_RANKS
    assert got == want
    want_files = _cli_outputs(one_dir)
    got_files = _cli_outputs(inputs["dir"] / f"{name}_sharded")
    assert list(got_files) == list(want_files)
    for f, w in want_files.items():
        if f.endswith(".npy"):
            np.testing.assert_array_equal(got_files[f], w, err_msg=f)
        else:  # the mean shape, or the multires meshes: same gates as above
            np.testing.assert_allclose(got_files[f], w, rtol=2e-4, atol=2e-5 * 40, err_msg=f)


def test_one_card_cli_does_not_shard(inputs, monkeypatch):
    """``--device cpu`` (or a named card) never shards; ``--device`` the
    card shards ``register --multires`` over 'verts' (not with
    ``--features-in-adjacency``, which says so) and ``cohort`` / ``ssm``
    over 'cohort' when the card count divides the subjects."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    parse = TCLI._parser().parse_args
    argv, _ = inputs["cli"]["cohort"]
    mr, _ = inputs["cli"]["multires"]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert TCLI._shard_axis(parse(argv), cuda) == "cohort"  # 4 subjects
    assert TCLI._shard_axis(parse(argv[:-len(CLI_FAST) - 1]), cuda) is None  # 3 subjects
    assert TCLI._shard_axis(parse(["ssm"] + argv[1:5]), cuda) == "cohort"
    assert TCLI._shard_axis(parse(argv), cpu) is None
    assert TCLI._shard_axis(parse(argv), torch.device("cuda", 1)) is None
    assert TCLI._shard_axis(parse(mr), cuda) == "verts"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert TCLI._shard_axis(parse(mr + ["--features", "curvature",
                                            "--features-in-adjacency"]), cuda) is None
    assert "disables the multi-device fine refine" in err.getvalue()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TCLI._shard_axis(parse(argv), cuda) is None


# --- A failing rank ---


def _fail_on_rank_one(how):
    """Rank 1 raises (rank 0 waits in a barrier it never leaves) or dies
    without a word (rank 0 sleeps: a collective would fail on its own)."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        if how == "raise":
            raise ValueError("rank one refuses")
        os._exit(3)
    if how == "raise":
        dist.barrier()
    time.sleep(120)


def test_spawn_raises_a_ranks_exception_and_stops_the_others():
    with pytest.raises(ValueError, match="rank one refuses") as err:
        distributed.spawn(_fail_on_rank_one, 2, "gloo", "cpu", args=("raise",), threads=1)
    assert isinstance(err.value.__cause__, distributed.RemoteTraceback)
    assert "rank 1 of 2" in str(err.value.__cause__)
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code 3"):
        distributed.spawn(_fail_on_rank_one, 2, "gloo", "cpu", args=("exit",), threads=1)



def test_spawn_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """``spawn`` with its defaults runs NCCL ranks on the card; where no
    card is visible it raises before it starts any process (no CPU
    ranks)."""
    sig = inspect.signature(distributed.spawn)
    assert sig.parameters["backend"].default == "nccl"
    assert sig.parameters["device_type"].default == "cuda"
    monkeypatch.setattr(distributed.torch.cuda, "is_available", lambda: False)
    contexts = []
    monkeypatch.setattr(distributed.multiprocessing, "get_context",
                        lambda *a: contexts.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.spawn(_fail_on_rank_one, 2, args=("raise",))
    assert contexts == []

# --- Per-lane randomness ---

# The wide solver on graphs with fewer real rows than block columns: the
# block is rank-deficient, so every solve refills it from its generator.
WIDE_KW = dict(KW, icp_n_landmarks=150, eig_wide_block=256, eig_wide_chunks=2,
               eig_wide_chunks_warm=1)


def _wide_graph(seed):
    return TP.mesh_to_graph_arrays(chip_smoke.synthetic_bone(TP, seed, 2), device="cpu",
                                   pad_n_points=2048)


@pytest.fixture
def refills(monkeypatch):
    """The seeds of the generators the eigensolver's refills draw from."""
    seeds = []
    real = eigen._randn

    def counted(shape, generator, device):
        seeds.append(generator.initial_seed())
        return real(shape, generator, device)

    monkeypatch.setattr(eigen, "_randn", counted)
    return seeds


def test_one_lane_alone_equals_the_lane_in_the_loop(refills):
    template, subjects = _wide_graph(2), TC.stack_graph_arrays([_wide_graph(1), _wide_graph(3)])
    cfg = TP.PipelineConfig(**WIDE_KW)
    assert TP.pipeline._solver(cfg, template.n_points) == "wide"
    draws = TC.make_cohort_draws(SEED, cfg, template, subjects)
    res, _ = TC.register_cohort(template, subjects, cfg, draws=draws, prepared_template=False)
    seeds = [TC.lane_generator(d).initial_seed() for d in draws["pairs"]]
    # Both lanes refilled, each from its own generator only.
    assert seeds[0] != seeds[1] and set(refills) == set(seeds)
    refills.clear()
    alone = TP.register_pair(TC._lane(subjects, 1), template, cfg,
                             generator=TC.lane_generator(draws["pairs"][1]),
                             draws=draws["pairs"][1])
    assert set(refills) == {seeds[1]}
    for k, v in alone.items():
        assert v.numpy().tobytes() == res[k][1].numpy().tobytes(), k


def test_refill_draws_from_the_generator(refills):
    """The same seed gives the same eigenpairs, another seed others."""
    g = _wide_graph(1)
    cfg = TP.PipelineConfig(**WIDE_KW)
    block = np.random.default_rng(0).standard_normal((2048, 256)).astype(np.float32)

    def solve(seed):
        _, vecs, _ = TP.pipeline._spectrum(g, 5, cfg, torch.from_numpy(block),
                                           generator=torch.Generator().manual_seed(seed))
        return vecs.numpy()

    assert solve(1).tobytes() == solve(1).tobytes()
    assert set(refills) == {1}
    assert solve(1).tobytes() != solve(2).tobytes()
    assert set(refills) == {1, 2}


def test_lane_generator_hashes_the_draws():
    d = {"a": np.arange(5), "b": np.ones((2, 3), np.float32)}
    seed = TC.lane_generator(d).initial_seed()
    assert TC.lane_generator(dict(reversed(d.items()))).initial_seed() == seed
    assert TC.lane_generator({k: torch.from_numpy(v) for k, v in d.items()}
                             ).initial_seed() == seed
    other = dict(d, a=np.arange(1, 6))
    assert TC.lane_generator(other).initial_seed() != seed
