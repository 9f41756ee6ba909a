"""ICP of ``pyfocusr_tpu_torch`` with its loop on the device, and the 3x3
Umeyama close, against the plain loop and against the JAX package.

* The blocked loop (masked iterations, the flag read every ``ICP_BLOCK``
  iterations; on the CPU eagerly) must equal the plain loop (a host read per
  iteration) bit for bit: same iteration count, s, R, t and moved cloud, in
  rigid and similarity modes, stopping mid-block, under iteration caps of 1
  and 13, and with a source mask that zeroes rows; with at most
  ceil(it / ICP_BLOCK) + 1 host reads.
* Both loops stop at the iteration JAX's ``while_loop`` stops at (JAX run
  for ``it`` iterations equals JAX run for 100, and its mean motion in
  iteration it - 1 was still above the threshold), with R within 1e-4 and t
  within 1e-4 of the data scale, as ``test_icp_matches_jax`` holds the
  default loop.
* The plain close (``torch.linalg.svd`` in f64, rounded once to f32) after
  the port's moments equals ``pyfocusr_tpu.ops.icp.umeyama`` (an f32 SVD)
  within atol 1e-5 on R (t within 1e-5 of the data scale, s within rtol
  1e-5) on the covariances of the chip gate: a rotation, a reflection
  (det < 0), two nearly equal singular values, a rank-2 covariance,
  similarity mode with and without a reflection, and weights that zero
  rows.  The f32 SVD is exact to a few units in the last place, and R and s
  do not depend on an SVD's sign or order choices (``csrc/umeyama3.cu``).
* ``chip_smoke.close_emulated``, the close kernel's steps in numpy, from
  which the chip check counts the rotations of the close's bound, gives the
  plain close's bits on those covariances with fewer sweeps than the kernel
  runs.
* On a card (``gpu`` marker): the close kernel against the plain close (R
  within 1e-6, s within rtol 1e-6, t within 1e-6 of the scale), and the
  graph loop against the plain loop, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import CLOSE_CASES, close_case_points
from pyfocusr_tpu.ops import icp as JI
from pyfocusr_tpu_torch.ops import icp as TI
from pyfocusr_tpu_torch.ops import knn_kernel, umeyama_kernel

# One intra-op thread: torch's default of one per core oversubscribes the
# CPU beside JAX's thread pool and the other pytest workers.
torch.set_num_threads(1)


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    a = np.deg2rad(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def _icp_inputs(mesh, seed=0, n=700, scale=1.0, deg=8.0):
    tgt = np.asarray(mesh.points, np.float32)
    rng = np.random.default_rng(seed)
    lm = rng.choice(len(tgt), n, replace=False)
    R0 = _rot([0.3, 1.0, 0.2], deg)
    src = (scale * tgt[lm] @ R0.T + np.array([3.0, -2.0, 5.0])
           + rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    return src, tgt


def _mask(n, seed=4):
    m = np.ones(n, np.float32)
    m[np.random.default_rng(seed).choice(n, n // 5, replace=False)] = 0.0
    return m


# (name, mode, max_iterations, masked, similarity scale, rotation degrees)
LOOP_CASES = [
    ("rigid", "rigid", 100, False, 1.0, 8.0),
    ("similarity", "similarity", 100, False, 1.04, 8.0),
    ("cap_1", "rigid", 1, False, 1.0, 8.0),
    ("cap_13", "rigid", 13, False, 1.0, 25.0),
    ("source_mask", "rigid", 100, True, 1.0, 8.0),
    ("similarity_mask", "similarity", 60, True, 0.97, 15.0),
]


def _run_both(src, tgt, mode, max_it, mask):
    out = {}
    for loop in ("plain", "blocked"):
        (s, R, t), moved, it = TI.icp(
            torch.tensor(src), torch.tensor(tgt), mode=mode, max_iterations=max_it,
            source_mask=None if mask is None else torch.tensor(mask),
            return_iterations=True, loop=loop)
        out[loop] = (it, s, R, t, moved)
    return out["plain"], out["blocked"], dict(TI.ICP_STATS)


@pytest.mark.parametrize("case", LOOP_CASES, ids=[c[0] for c in LOOP_CASES])
def test_blocked_icp_loop_matches_plain_loop(mesh_5k_target, case):
    name, mode, max_it, masked, scale, deg = case
    src, tgt = _icp_inputs(mesh_5k_target, scale=scale, deg=deg)
    mask = _mask(len(src)) if masked else None
    if masked:  # rows the mask drops may lie anywhere
        src[mask == 0] += 40.0
    plain, blocked, stats = _run_both(src, tgt, mode, max_it, mask)
    it = plain[0]
    assert blocked[0] == it
    for a, b in zip(plain[1:], blocked[1:]):
        assert torch.equal(a, b), name
    K = TI.ICP_BLOCK
    assert stats["iterations"] == it and not stats["graph"]
    assert stats["host_reads"] <= -(-it // K) + 1, stats
    if max_it in (1, 13):
        assert it == max_it  # the cap stops these runs
    else:
        assert 1 < it < max_it


def test_blocked_icp_stops_mid_block(mesh_5k_target):
    """A tolerance stop that falls inside a block of replays: the masked
    iterations after it change nothing."""
    src, tgt = _icp_inputs(mesh_5k_target)
    plain, blocked, stats = _run_both(src, tgt, "rigid", 100, None)
    it = plain[0]
    assert (it - 1) % TI.ICP_BLOCK != 0, "the stop falls on a block's end here"
    assert stats["replays"] > it - 1  # masked iterations ran after the stop
    assert blocked[0] == it
    for a, b in zip(plain[1:], blocked[1:]):
        assert torch.equal(a, b)


def test_icp_zero_iterations_both_loops(mesh_5k_target):
    src, tgt = _icp_inputs(mesh_5k_target, n=50)
    for loop in ("plain", "blocked"):
        (s, R, t), moved, it = TI.icp(torch.tensor(src), torch.tensor(tgt),
                                      max_iterations=0, return_iterations=True,
                                      loop=loop)
        assert it == 0 and float(s) == 1.0 and torch.equal(R, torch.eye(3))
        assert torch.equal(moved, torch.tensor(src) + t)
    with pytest.raises(ValueError, match="loop"):
        TI.icp(torch.tensor(src), torch.tensor(tgt), loop="graph")


@pytest.mark.parametrize("loop", ["plain", "blocked"])
def test_icp_loop_matches_jax_bracket(mesh_5k_target, loop):
    src, tgt = _icp_inputs(mesh_5k_target, seed=3)
    mask = _mask(len(src), seed=5)
    (ts, tR, tt), _, it = TI.icp(torch.tensor(src), torch.tensor(tgt),
                                 source_mask=torch.tensor(mask), max_iterations=100,
                                 return_iterations=True, loop=loop)
    assert 1 < it < 100

    def jax_icp(max_it):
        (s, R, t), moved = JI.icp(jnp.asarray(src), jnp.asarray(tgt), max_iterations=max_it,
                                  source_mask=jnp.asarray(mask))
        return np.asarray(s), np.asarray(R), np.asarray(t), np.asarray(moved)

    at_it, at_max = jax_icp(it), jax_icp(100)
    for a, b in zip(at_it, at_max):  # JAX stopped at or before it ...
        np.testing.assert_array_equal(a, b)
    m2, m1 = jax_icp(it - 2)[3], jax_icp(it - 1)[3]  # ... and not before
    threshold = 1e-5 * (np.abs(tgt).max() + 1.0)
    motion = np.linalg.norm(m1 - m2, axis=1)
    assert (motion * mask).sum() / mask.sum() > threshold
    data_scale = float(np.abs(tgt).max())
    np.testing.assert_allclose(tR.numpy(), at_it[1], atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), at_it[2], atol=1e-4 * data_scale)
    np.testing.assert_allclose(float(ts), float(at_it[0]), rtol=1e-4)


def close_case(case):
    """``chip_smoke.py``'s points for a close case, and its with_scale."""
    return (*close_case_points(case), case[3])


@pytest.mark.parametrize("case", CLOSE_CASES, ids=[c[0] for c in CLOSE_CASES])
def test_plain_close_matches_jax_umeyama(case):
    src, dst, w, with_scale = close_case(case)
    js, jR, jt = map(np.asarray, JI.umeyama(jnp.asarray(src), jnp.asarray(dst), with_scale,
                                            weights=jnp.asarray(w)))
    ts, tR, tt = TI.umeyama(torch.tensor(src), torch.tensor(dst), with_scale,
                            weights=torch.tensor(w))
    scale = float(np.abs(dst[w > 0]).max())
    np.testing.assert_allclose(tR.numpy(), jR, atol=1e-5)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-5 * scale)
    # The covariance has the case's determinant sign and is proper.
    cov = TI._moments(torch.tensor(src), torch.tensor(dst),
                      torch.tensor(w) / float(w.sum()))[0].double().numpy()
    if case[1][2] > 0:  # a rank-2 covariance's sign is rounding noise
        assert np.sign(np.linalg.det(cov)) == case[2]
    assert abs(np.linalg.det(tR.double().numpy()) - 1.0) < 1e-5


@pytest.mark.parametrize("case", CLOSE_CASES, ids=[c[0] for c in CLOSE_CASES])
def test_close_emulation_matches_plain_close(case):
    """``chip_smoke.close_emulated``, the kernel's steps in numpy from which
    the chip check takes the close's bound, gives the plain close's bits,
    and needs fewer sweeps than the kernel runs."""
    src, dst, w, with_scale = close_case(case)
    moments = TI._moments(torch.tensor(src), torch.tensor(dst),
                          torch.tensor(w) / float(w.sum()))
    s, R, t = umeyama_kernel.umeyama_close_plain(*moments, with_scale)
    plain = torch.cat([s.view(1), R.flatten(), t])
    chain = chip_smoke.close_chain(moments, with_scale, plain)
    assert chain["emulated_equals_kernel"], case
    assert 1 <= chain["sweeps_needed"] < chip_smoke.close_sweeps(), chain
    assert chain["rotations"] <= 3 * chain["sweeps_needed"]


def test_close_dispatch_and_cuda_wrapper_checks():
    src, dst, w, _ = close_case(CLOSE_CASES[0])
    moments = TI._moments(torch.tensor(src), torch.tensor(dst),
                          torch.tensor(w) / float(w.sum()))
    before = umeyama_kernel.LAUNCHES
    got = umeyama_kernel.umeyama_close(*moments, False)
    want = umeyama_kernel.umeyama_close_plain(*moments, False)
    assert umeyama_kernel.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        umeyama_kernel.umeyama_close_cuda(*moments, False)


def test_knn_wrapper_out_checks():
    out = (torch.empty(5, 1), torch.empty(5, 1, dtype=torch.int32))
    knn_kernel._check_out(out, 5, 1, torch.device("cpu"))
    for bad in ((torch.empty(5, 2), out[1]), (out[0], out[1].long()),
                (torch.empty(5, 2)[:, :1], out[1])):
        with pytest.raises(ValueError, match="out="):
            knn_kernel._check_out(bad, 5, 1, torch.device("cpu"))
    r = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        knn_kernel.knn_cuda(r, r, 1, out=out, done=torch.zeros(1, dtype=torch.int32))


@pytest.mark.gpu
def test_close_kernel_and_graph_loop_match_plain_on_card(mesh_5k_target):
    """Runs on a CUDA card only: the close kernel against the plain close on
    the same card, and the captured ICP loop against the plain loop (both
    with the kernels), bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case in CLOSE_CASES:
        src, dst, w, with_scale = close_case(case)
        moments = TI._moments(torch.tensor(src).cuda(), torch.tensor(dst).cuda(),
                              (torch.tensor(w) / float(w.sum())).cuda())
        before = umeyama_kernel.LAUNCHES
        ks, kR, kt = umeyama_kernel.umeyama_close(*moments, with_scale)
        assert umeyama_kernel.LAUNCHES == before + 1
        ps, pR, pt = umeyama_kernel.umeyama_close_plain(*moments, with_scale)
        scale = float(np.abs(dst[w > 0]).max())
        assert float((kR - pR).abs().max()) <= 1e-6, case
        assert abs(float(ks - ps)) <= 1e-6 * abs(float(ps)), case
        assert float((kt - pt).abs().max()) <= 1e-6 * scale, case
    for mode in ("rigid", "similarity"):
        src, tgt = _icp_inputs(mesh_5k_target, scale=1.04 if mode == "similarity" else 1.0)
        runs = {}
        for loop in ("plain", "blocked"):
            (s, R, t), moved, it = TI.icp(torch.tensor(src).cuda(), torch.tensor(tgt).cuda(),
                                          mode=mode, return_iterations=True, loop=loop)
            runs[loop] = (it, s, R, t, moved)
        stats = TI.ICP_STATS
        assert stats["graph"] and runs["plain"][0] == runs["blocked"][0]
        assert stats["host_reads"] <= -(-runs["plain"][0] // TI.ICP_BLOCK) + 1
        for a, b in zip(runs["plain"][1:], runs["blocked"][1:]):
            assert torch.equal(a, b), mode
