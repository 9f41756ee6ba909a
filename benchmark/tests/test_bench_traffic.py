"""The traffic generator: the same seed gives the same inputs."""

import numpy as np
import pytest
from conftest import load

from harness import bones, drive

ENTRY = drive.load_entry("register_pair")

SEEDS = [0, 7, 2**31 + 12345, 2**40 + 3, -5]


def test_bones_match_the_repository_formula():
    pts, tris = bones.bone(2, 3)
    assert pts.shape == (642, 3) and tris.shape == (1280, 3)
    again = bones.bone(2, 3)
    assert np.array_equal(pts, again[0]) and np.array_equal(tris, again[1])
    assert not np.array_equal(pts, bones.bone(3, 3)[0])
    ext = pts.max(axis=0) - pts.min(axis=0)
    assert np.all(ext > [28, 22, 68]) and np.all(ext < [38, 31, 84])


def test_bone_levels_give_the_cells_vertex_counts():
    assert bones.sphere(5)[0].shape[0] == 10242
    assert bones.sphere(4)[0].shape[0] == 2562


class FakeEntry:
    """The register_pair entry's draws without its set-up: the program's
    ``make_draws`` for 2562-vertex meshes."""

    def __init__(self, n=2562):
        import pyfocusr_tpu_torch as tp

        e = ENTRY.Entry.__new__(ENTRY.Entry)
        ga = type("G", (), {"n_points": n})()
        e.tp, e.cfg_obj = tp, tp.pipeline.config_from_dict(load_cfg())
        e.pool_seeds, e.target_ga, e.pool_ga = list(range(10, 18)), ga, [ga] * 8
        self.entry = e

    def draws(self, item):
        return self.entry.draws(item)


def test_item_draws_repeat_and_differ_by_item():
    e = FakeEntry()
    a, b, c = e.draws((3, 1)), e.draws((3, 1)), e.draws((3, 0))
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["cpd_omega"], c["cpd_omega"])
    assert not np.array_equal(e.draws((4, 1))["eig_block_target"], a["eig_block_target"])


def test_item_draws_shapes_and_ranges():
    d = FakeEntry(10242).draws((0, 0))
    assert d["icp_landmarks"].shape == (2000,)
    assert d["eigsort_target"].shape == (10000,) and d["eigsort_source"].shape == (10000,)
    assert d["cpd_source"].shape == (1000,) and d["cpd_target"].shape == (1000,)
    assert d["eig_block_target"].shape == (10242, 128)
    assert d["cpd_omega"].shape == (1000, 116)
    assert "eig_block_source" not in d
    for k in ("icp_landmarks", "eigsort_target", "cpd_source"):
        v = d[k]
        assert np.unique(v).size == v.size and int(v.min()) >= 0 and int(v.max()) < 10242


def test_uncovered_settings_are_refused():
    cfg = dict(load_cfg(), rigid_before_non_rigid_reg=True)
    with pytest.raises(ValueError):
        ENTRY.Entry(None, cfg, {}, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_order_and_sample_repeat_for_a_seed(seed):
    def order(s=seed):
        o = drive.Order(16, s)
        return [o.next() for _ in range(48)]

    a, b = order(), order()
    assert a == b
    for cycle in range(3):
        assert sorted(a[16 * cycle:16 * cycle + 16]) == list(range(16))
    assert order(seed + 1) != a
    s1 = drive.sample_calls(drive.sample_rng(seed), 16, 2)
    assert s1 == drive.sample_calls(drive.sample_rng(seed), 16, 2)
    assert len(set(s1)) == 2 and all(0 <= i < 16 for i in s1)


def test_traffic_files_state_the_generator_parameters():
    for name in ("bones_10k", "bones_40k"):
        t = load_traffic(name)
        assert callable(drive.load_entry(t["entry"]).Entry)
        assert t["subdivision_levels"] in (5, 6) and t["draws_per_source"] >= 1
        assert len(set(t["pool_seeds"])) == len(t["pool_seeds"]) == 8
        assert t["template_seed"] not in t["pool_seeds"]
        assert t["judge_pairs"] >= 1 and t["trace_pairs"] >= 1


def load_cfg():
    import json
    import os

    from conftest import BENCH_DIR

    with open(os.path.join(BENCH_DIR, "configs", "notebook_kd.json")) as f:
        return json.load(f)["pipeline_config"]


def load_traffic(name):
    import json
    import os

    from conftest import BENCH_DIR

    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def test_fixture_traffic_is_small():
    assert load("tiny_2k.json")["subdivision_levels"] == 4
