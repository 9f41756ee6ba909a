"""Port parity for the split-spectra schedule (``pyfocusr_tpu/pipeline.py:
822-911``, :1078-1090, :1196-1201) on the 2562-vertex synthetic bone pair:
both packages' threshold ``_SPLIT_SPECTRA_N`` is patched on the module
attribute to 2000, so the pair takes the schedule each package takes from
65000 vertices (nothing in the JAX package is edited).

JAX runs ``register_pair``, ``register_pair_prepared`` and
``register_pair_prepared_source`` with ``PRNGKey(0)``; the port gets the
draws JAX made (``test_torch_pipeline._jax_draws``, plus the source block
from ``split(key, 8)[1]`` that the split's cold source solve reads).  JAX's
default graphs carry its patch-dense plans, so JAX runs that filter
operator and the port its ELL one.  Gates:
``test_torch_pipeline._check_slice``.  Within the port, the
fused and the split schedules give the same target side bit for bit (the
JAX package's contract, :853-855), and the split's source solve runs cold
under ICP.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pyfocusr_tpu import pipeline as JP
from test_torch_pipeline import FAST, _check_slice, _eig_block, _jax_draws
import pyfocusr_tpu_torch as TP
from pyfocusr_tpu_torch.ops import eigen as TE

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
SPLIT_N = 2000
TARGET_KEYS = ("eig_vals_target", "eig_vecs_target", "smoothed_target_coords")


def _np(res):
    return {k: np.asarray(v) for k, v in res.items()}


def _port_graph(ga):
    return TP.graph_arrays_from_numpy(dataclasses.asdict(ga), device="cpu")


@pytest.fixture(scope="module")
def split():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "_SPLIT_SPECTRA_N", SPLIT_N)
        mp.setattr(TP.pipeline, "_SPLIT_SPECTRA_N", SPLIT_N)
        yield


@pytest.fixture(scope="module")
def runs(split, mesh_5k_target, mesh_5k_source):
    """Each entry point's JAX result and the port's, on the same draws."""
    tg = JP.mesh_to_graph_arrays(mesh_5k_target)
    sg = JP.mesh_to_graph_arrays(mesh_5k_source)
    assert tg.patch_plan is not None and sg.patch_plan is not None
    assert JP._want_split(tg, sg)
    ttg, tsg = _port_graph(tg), _port_graph(sg)
    jcfg = JP.PipelineConfig(**FAST)
    tcfg = TP.PipelineConfig(**FAST)
    keys = jax.random.split(KEY, 8)
    draws = _jax_draws(KEY, jcfg, tg, sg)
    draws["eig_block_source"] = _eig_block(keys[1], sg.n_points, jcfg)
    out = {"graphs": (ttg, tsg), "tcfg": tcfg, "draws": draws}

    out["pair"] = (_np(JP.register_pair(tg, sg, jcfg, KEY)),
                   TP.register_pair(ttg, tsg, tcfg, draws=draws))
    jprep = JP.prepare_target(tg, jcfg, keys[0])
    tprep = TP.prepare_target(ttg, tcfg, draws["eig_block_target"])
    TE.SOLVES.clear()
    out["prepared"] = (_np(JP.register_pair_prepared(jprep, tg, sg, jcfg, KEY)),
                       TP.register_pair_prepared(tprep, ttg, tsg, tcfg, draws=draws))
    out["prepared_solves"] = list(TE.SOLVES)
    jsrc = JP.prepare_source(sg, jcfg, keys[1])
    tsrc = TP.prepare_source(tsg, tcfg, draws["eig_block_source"])
    out["prepared_source"] = (
        _np(JP.register_pair_prepared_source(jsrc, tg, sg, jcfg, KEY)),
        TP.register_pair_prepared_source(tsrc, ttg, tsg, tcfg, draws=draws))
    return out


@pytest.mark.parametrize("entry", ["pair", "prepared", "prepared_source"])
def test_split_schedule_matches_jax(runs, entry):
    want, got = runs[entry]
    _check_slice(want, got)


def test_split_source_solve_runs_cold_under_icp(runs):
    """Under ICP the hoisted source solve is cold (the five-chunk schedule
    from ``eig_block_source``), not warm from the target's block."""
    (solve,) = runs["prepared_solves"]
    assert solve["n"] == runs["graphs"][1].n_points
    assert not solve["warm"] and solve["chunks"] == runs["tcfg"].eig_wide_chunks


def test_fused_and_split_agree_on_the_target_side(runs):
    ttg, tsg = runs["graphs"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP.pipeline, "_SPLIT_SPECTRA_N", 0)
        fused = TP.register_pair(ttg, tsg, runs["tcfg"], draws=runs["draws"])
    split = runs["pair"][1]
    for key in TARGET_KEYS:
        assert torch.equal(fused[key], split[key]), key
    np.testing.assert_allclose(fused["eig_vals_source"], split["eig_vals_source"],
                               rtol=1e-4)


def test_split_draws_add_the_source_block_last(split):
    cfg = TP.PipelineConfig(**FAST)
    with_split = TP.make_draws(0, cfg, 2562, 2562)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP.pipeline, "_SPLIT_SPECTRA_N", 0)
        fused = TP.make_draws(0, cfg, 2562, 2562)
    assert "eig_block_source" not in fused
    assert set(with_split) == set(fused) | {"eig_block_source"}
    for name, arr in fused.items():
        np.testing.assert_array_equal(with_split[name], arr)
    assert not TP.pipeline._want_split(1999, 1000)
    assert TP.pipeline._want_split(100, 2000)


def test_split_source_solve_starts_warm_without_icp(runs):
    """Without ICP the hoisted source solve starts from the hoisted target's
    block through the unmoved points and runs the warm schedule
    (``pyfocusr_tpu/pipeline.py:899-908``)."""
    ttg, tsg = runs["graphs"]
    cfg = TP.PipelineConfig(**dict(FAST, icp_register_first=False))
    draws = {k: v for k, v in runs["draws"].items() if k != "icp_landmarks"}
    TE.SOLVES.clear()
    res = TP.register_pair(ttg, tsg, cfg, draws=draws)
    target, source = TE.SOLVES
    assert (target["n"], target["warm"]) == (ttg.n_points, False)
    assert source["n"] == tsg.n_points and source["warm"]
    assert cfg.eig_wide_chunks_warm <= source["chunks"] <= cfg.eig_wide_chunks
    assert np.all(np.isfinite(res["weighted_points"].numpy()))
