"""The wide eigensolver's fused Chebyshev filter step of ``pyfocusr_tpu_torch``
(``ops/cheb_step_kernel.py`` over ``csrc/cheb_step.cu``) and its routing.

On the CPU, on the 2562-vertex synthetic bones (ELL width 6, no overflow
edges), a UV sphere whose poles overflow the ELL width, and the bones padded
as ``pipeline._pad_graph_arrays`` pads a graph (dead rows, extra ELL columns
pointing at row 0, mask 0):

* ``cheb_step_plain`` is the plain ELL step (``chip_smoke.ell_step``),
  ``op(t) - tprev`` and ``0.5 op(t)``, bit for bit, and ``chebyshev_ell``
  (two blocks a chunk, each step from the third written over the block two
  back) and the ELL factory's chunk are the step-by-step recurrence bit for
  bit after 1, 2, 3 and 33 steps, leaving their input as it was;
* the wide solver's eigenpairs are unchanged on the CPU: ``_spectrum``
  through the factory's chunk gives the bits of the same solve whose chunk
  is the recurrence run step by step over ``ell_product``
  (``chip_smoke.stepwise_filter``), on the 2562 bone and the hub graph;
* the factory gives the chunk on the CPU too; ``cheb_steps_fused`` stays 0
  there and nothing launches;
* the wrapper: its launch plan, its constants against the source's, its
  argument checks, and a CUDA tensor on a device without sm_90 raising
  before anything is built.

On a card (``gpu`` marker; the file imports no JAX, so ``python -m pytest
--noconftest tests/test_torch_cheb_step.py -m gpu`` runs there): the kernel
against the plain ELL step at 10242 and 40962 x 128, at a narrow width and
on a hub graph, within the gate; launches and ``cheb_steps_fused`` equal to
33 steps a chunk on one ``register_pair``; one chunk captured in a CUDA
graph, its replay equal to the eager chunk.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
import pyfocusr_tpu_torch as tp
from pyfocusr_tpu_torch import pipeline as P
from pyfocusr_tpu_torch.ops import cheb_step_kernel as CK
from pyfocusr_tpu_torch.utils import spans

torch.set_num_threads(1)

CFG = tp.PipelineConfig(**chip_smoke.BENCH_CFG)
DEG = CFG.eig_wide_degree
TOL = chip_smoke.CHEB_STEP_TOL_OF_SCALE


def _bones(levels=4, device="cpu"):
    return tp.mesh_to_graph_arrays(chip_smoke.synthetic_bone(tp, 2, levels), device=device)


def _graph(name, device="cpu"):
    if name == "bones":
        return _bones(device=device)
    if name == "hub":
        g = tp.mesh_to_graph_arrays(chip_smoke.uv_sphere(tp, *chip_smoke.CHEB_HUB),
                                    device=device)
        assert g.overflow.shape[0] > 0
        return g
    g = _bones(device=device)
    n, d = g.neighbors.shape
    return P._pad_graph_arrays(g, n + 37, d + 2, g.null_indicators.shape[1] + 1)


GRAPHS = ["bones", "hub", "padded"]


@pytest.fixture(scope="module")
def operands():
    return {name: chip_smoke.cheb_operands(torch, tp, _graph(name), CFG.eig_wide_block)
            for name in GRAPHS}


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("name", GRAPHS)
def test_plain_step_is_the_ell_op(operands, name, first):
    ops = operands[name]
    op, t, tprev = ops["op"], ops["t"], ops["tprev"]
    got = CK.cheb_step_plain(t, tprev, ops["neighbors"], ops["w_hat"], ops["a_diag"], first,
                             ops["overflow"], ops["ov_coef"])
    want = 0.5 * op(t) if first else op(t) - tprev
    assert torch.equal(got, want)


@pytest.mark.parametrize("deg", [1, 2, 3, DEG])
@pytest.mark.parametrize("name", GRAPHS)
def test_chunk_is_the_stepwise_recurrence(operands, name, deg):
    ops = operands[name]
    x = ops["t"].clone()
    got = CK.chebyshev_ell(x, deg, ops["neighbors"], ops["w_hat"], ops["a_diag"],
                           ops["overflow"], ops["ov_coef"])
    want = chip_smoke.cheb_reference(ops["op"], ops["t"], deg)
    assert torch.equal(x, ops["t"])
    assert torch.equal(got, want)
    assert torch.equal(ops["chunk"](x, deg), want) and torch.equal(x, ops["t"])
    assert chip_smoke.cheb_errors(torch, CK, ops, degrees=(deg,))[f"chunk_{deg}"] == 0.0


def _solve(g, device="cpu"):
    start = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (g.n_points, CFG.eig_wide_block)).astype(np.float32)).to(device)
    # SVQB refill noise, drawn where a block loses rank, from a seed.
    gen = torch.Generator(device=device).manual_seed(0)
    with spans.call() as rec:
        rec.stage("spectra")
        lams, vecs, _ = P._spectrum(g, CFG.n_total, CFG, start, generator=gen)
    return lams, vecs, rec


@pytest.mark.parametrize("name", ["bones", "hub"])
def test_wide_solver_unchanged_on_cpu(name):
    """The 2562 pair's target and the hub graph: the solve through the
    factory's chunk (``chebyshev_ell``'s plain version) equals bit for bit
    the same solve with each chunk run step by step over ``ell_product``,
    as before the kernel."""
    g = _graph(name)
    lams, vecs, rec = _solve(g)
    with chip_smoke.stepwise_filter(tp):
        lams_s, vecs_s, rec_s = _solve(g)
    assert rec.solves == rec_s.solves
    assert torch.equal(lams, lams_s) and torch.equal(vecs, vecs_s)


def test_cpu_factory_gives_the_chunk_without_launches(operands):
    """On CPU tensors the ELL factory gives the chunk as on CUDA tensors,
    through ``cheb_step_plain``: nothing launches and ``cheb_steps_fused``
    stays 0."""
    launches = CK.LAUNCHES
    for ops in operands.values():
        with spans.call() as rec:
            rec.stage("spectra")
            got = ops["chunk"](ops["t"], DEG)
        assert torch.equal(got, chip_smoke.cheb_reference(ops["op"], ops["t"], DEG))
        assert rec.total("cheb_steps_fused") == 0
    assert CK.LAUNCHES == launches


@pytest.mark.parametrize("n,b,aligned,want", [
    (40962, 128, True, (4, 32, 8)),
    (10242, 64, True, (4, 16, 16)),
    (10242, 14, True, (1, 16, 16)),
    (10242, 128, False, (1, 32, 8)),
    (10242, 136, True, (4, 32, 8)),
    (7, 1, True, (1, 1, 256)),
])
def test_plan(n, b, aligned, want):
    p = CK.plan(n, b, aligned)
    assert (p["vec"], p["lanes_per_row"], p["rows_per_block"]) == want
    assert p["lanes_per_row"] == 1 << p["lanes_log2"]
    assert p["blocks"] == -(-n // p["rows_per_block"]) and p["threads"] == CK.THREADS


def test_constants_match_the_source():
    src = (CK._LIBRARY.source).read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == CK.THREADS
    sig = re.search(r'extern "C" int pyfocusr_cheb_step_f32\((.*?)\)', src, re.S).group(1)
    assert sig.count(",") + 1 == len(CK._LIBRARY.functions["pyfocusr_cheb_step_f32"])


def test_cuda_wrapper_refuses_cpu_tensors(operands):
    ops = operands["bones"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        CK.cheb_step_cuda(ops["t"], ops["tprev"], torch.empty_like(ops["t"]),
                          ops["neighbors"], ops["w_hat"], ops["a_diag"], False)


class _FakeCuda:
    """A stand-in for a CUDA tensor: what the wrapper's checks read."""

    def __init__(self, x, dtype=None):
        self.shape, self.dtype = x.shape, dtype or x.dtype
        self.device = torch.device("cuda", 0)
        self._ptr = 4096 * (id(self) % 1000 + 1)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self._ptr

    def numel(self):
        return int(np.prod(self.shape))


def test_device_without_sm90_raises(monkeypatch, operands):
    ops = operands["bones"]
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (8, 0))

    def no_build():
        raise AssertionError("the library was loaded for a device without sm_90")

    monkeypatch.setattr(CK, "load_library", no_build)
    fake = {k: _FakeCuda(ops[k]) for k in ("t", "tprev", "w_hat", "a_diag")}
    out = _FakeCuda(ops["t"])
    launches = CK.LAUNCHES
    with pytest.raises(RuntimeError, match="sm_90a"):
        CK.cheb_step_cuda(fake["t"], fake["tprev"], out, _FakeCuda(ops["neighbors"]),
                          fake["w_hat"], fake["a_diag"], False)
    assert CK.LAUNCHES == launches


def test_cuda_wrapper_refuses_int64_neighbours(monkeypatch, operands):
    ops = operands["bones"]
    fake = {k: _FakeCuda(ops[k]) for k in ("t", "tprev", "w_hat", "a_diag")}
    with pytest.raises(ValueError, match="neighbors"):
        CK.cheb_step_cuda(fake["t"], fake["tprev"], _FakeCuda(ops["t"]),
                          _FakeCuda(ops["neighbors"], torch.int64), fake["w_hat"],
                          fake["a_diag"], False)


# --- On a card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bones_10242", "bones_40962", "narrow", "hub"])
def test_kernel_matches_the_ell_step_on_the_card(case):
    """Runs on a CUDA card only."""
    _card()
    if case == "hub":
        g, b = _graph("hub", "cuda"), CFG.eig_wide_block
    else:
        levels = 6 if case == "bones_40962" else 5
        g = _bones(levels, "cuda")
        b = chip_smoke.CHEB_NARROW_WIDTH if case == "narrow" else CFG.eig_wide_block
    ops = chip_smoke.cheb_operands(torch, tp, g, b)
    launches = CK.LAUNCHES
    ops["chunk"](ops["t"], 3)  # the factory's chunk: one launch a step
    assert CK.LAUNCHES == launches + 3
    errs = chip_smoke.cheb_errors(torch, CK, ops)
    assert max(errs.values()) <= TOL, errs


@pytest.mark.gpu
def test_register_pair_launches_33_steps_a_chunk():
    """Runs on a CUDA card only: one 'kd' pair at 10242 vertices."""
    _card()
    tg, sg = _bones(5, "cuda"), tp.mesh_to_graph_arrays(
        chip_smoke.synthetic_bone(tp, 1, 5), device="cuda")
    draws = tp.make_draws(0, CFG, tg.n_points, sg.n_points)
    tp.register_pair(tg, sg, CFG, draws=draws)  # builds and loads
    CK.LAUNCHES = 0
    tp.register_pair(tg, sg, CFG, draws=draws)
    torch.cuda.synchronize()
    rec = spans.RECORDS[-1]
    chunks = sum(s["chunks"] for s in rec.solves)
    assert len(rec.solves) == 2 and chunks >= 2
    assert CK.LAUNCHES == DEG * chunks
    assert rec.counter("spectra", "cheb_steps_fused") == rec.total("cheb_steps_fused") \
        == DEG * chunks


@pytest.mark.gpu
def test_chunk_captures_into_a_cuda_graph():
    """Runs on a CUDA card only."""
    _card()
    ops = chip_smoke.cheb_operands(torch, tp, _bones(5, "cuda"), CFG.eig_wide_block)
    equal, launches = chip_smoke.cheb_capture(torch, ops, DEG)
    assert equal and launches == DEG
