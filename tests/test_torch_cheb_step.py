"""The wide eigensolver's fused Chebyshev filter step of ``pyfocusr_tpu_torch``
(``ops/cheb_step_kernel.py`` over ``csrc/cheb_step.cu``) and its routing.

On the CPU, on the 2562-vertex synthetic bones (ELL width 6, no overflow
edges), a UV sphere whose poles overflow the ELL width, and the bones padded
as ``pipeline._pad_graph_arrays`` pads a graph (dead rows, extra ELL columns
pointing at row 0, mask 0):

* ``cheb_step_plain`` is the ELL factory's op, ``op(t) - tprev`` and
  ``0.5 op(t)``, bit for bit, and ``chebyshev_ell`` (two blocks a chunk, each
  step from the third written over the block two back) is the step-by-step
  recurrence bit for bit after 1, 2, 3 and 33 steps, leaving its input as
  it was; against the patch-dense factory's op it agrees within the
  operators' gate (``chip_smoke.CHEB_STEP_TOL_OF_SCALE`` of the result's
  scale: the two sum in different orders);
* the wide solver's eigenpairs on the 2562 pair are unchanged on the CPU:
  ``_spectrum`` takes the patch-dense operator where the graph carries a
  plan and the ELL one step by step where not, and a factory whose op
  offers the fused chunk (the plain one here) gives the same bits;
* ``cheb_steps_fused`` stays 0 on the CPU and nothing launches;
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
from pyfocusr_tpu_torch.ops import patch_dense
from pyfocusr_tpu_torch.utils import spans

torch.set_num_threads(1)

CFG = tp.PipelineConfig(**chip_smoke.BENCH_CFG)
DEG = CFG.eig_wide_degree
TOL = chip_smoke.CHEB_STEP_TOL_OF_SCALE


def _bones(levels=4, device="cpu", **kw):
    return tp.mesh_to_graph_arrays(chip_smoke.synthetic_bone(tp, 2, levels), device=device,
                                   **kw)


def _graph(name, device="cpu"):
    if name == "bones":
        return _bones(device=device, patch_blocks=False)
    if name == "hub":
        g = tp.mesh_to_graph_arrays(chip_smoke.uv_sphere(tp, *chip_smoke.CHEB_HUB),
                                    device=device)
        assert g.overflow.shape[0] > 0
        return g
    g = _bones(device=device, patch_blocks=False)
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
    assert torch.equal(x, ops["t"])
    assert torch.equal(got, chip_smoke.cheb_reference(ops["op"], ops["t"], deg))
    assert chip_smoke.cheb_errors(torch, CK, ops, degrees=(deg,))[f"chunk_{deg}"] == 0.0


def test_patch_dense_factory_agrees_with_the_fused_step(operands):
    g = _bones()
    assert g.patch_plan is not None
    ops = chip_smoke.cheb_operands(torch, tp, g, CFG.eig_wide_block)
    pd_op = patch_dense.patch_filter_factory(g.patch_plan, *ops["pieces"])(ops["c"], ops["e"])
    t, tprev = ops["t"], ops["tprev"]
    for first in (True, False):
        fused = CK.cheb_step_plain(t, tprev, ops["neighbors"], ops["w_hat"], ops["a_diag"],
                                   first)
        want = 0.5 * pd_op(t) if first else pd_op(t) - tprev
        assert float((fused - want).abs().max()) <= TOL * float(want.abs().max())
    chunk = CK.chebyshev_ell(t, 3, ops["neighbors"], ops["w_hat"], ops["a_diag"])
    want = chip_smoke.cheb_reference(pd_op, t, 3)
    assert float((chunk - want).abs().max()) <= TOL * float(want.abs().max())


def _fused_on_cpu(monkeypatch):
    """``pipeline.ell_filter_factory`` whose ops offer the fused chunk on the
    CPU too (its plain version), as they do on CUDA tensors.  Returns the
    list of the chunks' degrees run through it."""
    real = P.ell_filter_factory
    runs = []

    def factory_with_chunk(neighbors, overflow, sw, ov_sw, sd, mask):
        factory = real(neighbors, overflow, sw, ov_sw, sd, mask)

        def make(c, e):
            op = factory(c, e)
            alpha = 2.0 / e
            ov_coef = None if ov_sw is None else -(alpha * ov_sw)[:, None]
            op.chebyshev = lambda X, deg: runs.append(deg) or CK.chebyshev_ell(
                X, deg, neighbors, alpha * sw, alpha * (sd - c * mask), overflow, ov_coef)
            return op

        return make

    monkeypatch.setattr(P, "ell_filter_factory", factory_with_chunk)
    return runs


def _solve(g, device="cpu"):
    start = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (g.n_points, CFG.eig_wide_block)).astype(np.float32)).to(device)
    with spans.call() as rec:
        rec.stage("spectra")
        lams, vecs, _ = P._spectrum(g, CFG.n_total, CFG, start)
    return lams, vecs, rec


def test_wide_solver_unchanged_on_cpu(monkeypatch):
    """The 2562 pair's target: the ELL solve step by step, the same solve
    through the fused chunk's plain version bit for bit, and the graph with
    its patch plan through the patch-dense operator, as before the kernel."""
    g = _bones(patch_blocks=False)
    lams, vecs, rec = _solve(g)
    taken = []
    real_pd = P.patch_filter_factory
    monkeypatch.setattr(P, "patch_filter_factory",
                        lambda *a: taken.append(1) or real_pd(*a))
    _solve(_bones())
    assert taken == [1]
    launches = CK.LAUNCHES
    runs = _fused_on_cpu(monkeypatch)
    lams_f, vecs_f, rec_f = _solve(g)
    assert runs and set(runs) == {DEG}
    assert torch.equal(lams, lams_f) and torch.equal(vecs, vecs_f)
    assert rec.total("cheb_steps_fused") == 0 and rec_f.total("cheb_steps_fused") == 0
    assert CK.LAUNCHES == launches


def test_cpu_ops_offer_no_fused_chunk(operands):
    """CPU tensors keep the recurrence over the op: the ELL factory attaches
    the fused chunk on CUDA tensors only."""
    assert all(not hasattr(ops["op"], "chebyshev") for ops in operands.values())


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
    assert hasattr(ops["op"], "chebyshev")
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
