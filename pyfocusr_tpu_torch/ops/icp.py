"""Iterative closest point (rigid / similarity) registration.

Counterpart of ``pyfocusr_tpu/ops/icp.py``: ``umeyama`` (:31),
``apply_rigid`` (:61) and ``icp`` (:67).  Each iteration is one
nearest-neighbour query (the k-NN kernel on CUDA) plus a closed-form
Umeyama/Kabsch update, ``umeyama_kernel.icp_step``: the matched rows'
moments, the 3x3 close, the moved source, the mean motion and the stop
test, in one kernel on CUDA (``torch.linalg.svd`` for the close on the
CPU).

The JAX ``lax.while_loop`` becomes a loop whose state (the moved cloud, s,
R, t, the last mean motion, the iteration count and a stop flag) lives on
the device: each iteration is masked by the flag and the host reads it
every ``ICP_BLOCK`` iterations; on a CUDA device one iteration is captured
as a CUDA graph and replayed (``utils/device_loop.py``, shared with CPD's EM
loops).  ``loop="plain"`` is the sequential loop that reads the stop test
each iteration, the plain version the blocked loop equals bit for bit.
"""

from __future__ import annotations

import torch

from ..utils import device_loop, spans
from ..utils.precision import f32_matmuls
from . import knn_kernel, umeyama_kernel

__all__ = ["ICP_BLOCK", "ICP_STATS", "umeyama", "icp", "apply_rigid"]

# ICP iterations between two host reads of the blocked loop's stop flag (on
# the card, replays of the captured iteration): the loop overshoots its
# convergence by at most K - 1 masked iterations, whose k-NN launches
# return at once on the flag, while the reads, each a wait for the device,
# drop eightfold.  The value of CPD's EM_BLOCK, for the same reason.
ICP_BLOCK = 8

# What the last blocked ICP loop did (``device_loop.reset_stats``).
ICP_STATS = {}


def _source_moments(src, wn):
    """The weighted mean of src, src centred on it, and its weighted
    variance, for weights ``wn`` [n] summing to 1 (fixed over an ICP run)."""
    mu_s = (src * wn[:, None]).sum(dim=0)
    sc = src - mu_s
    var_s = ((sc * sc).sum(dim=1) * wn).sum()
    return mu_s, sc, var_s


def _cross_moments(dst, wn, sc):
    """The weighted mean of dst and the 3x3 cross-covariance
    sum_i wn_i (dst_i - mu_d) sc_i^T."""
    w = wn[:, None]
    mu_d = (dst * w).sum(dim=0)
    cov = ((dst - mu_d) * w).T @ sc
    return cov, mu_d


def _moments(src, dst, wn):
    """(cov, var_s, mu_s, mu_d): the arguments of the close."""
    mu_s, sc, var_s = _source_moments(src, wn)
    cov, mu_d = _cross_moments(dst, wn, sc)
    return cov, var_s, mu_s, mu_d


def _start(source_points, target_points, source_mask):
    """ICP's fixed inputs and its starting point: the normalised weights wn,
    the source moments mu_s and var_s, the stop threshold 1e-5 * scale (the
    largest |coordinate| of the finite target rows, plus 1), the centroid
    match t0 (target centroid over finite, non-sentinel rows less the
    weighted source centroid) and the moved source src + t0."""
    wn = source_mask / torch.clamp(source_mask.sum(), min=1e-30)
    finite_t = (target_points.abs() < 1e29).all(dim=1).to(source_points.dtype)
    tn = finite_t / torch.clamp(finite_t.sum(), min=1e-30)
    t0 = (target_points * tn[:, None]).sum(dim=0) - (
        source_points * wn[:, None]
    ).sum(dim=0)
    scale = (target_points * finite_t[:, None]).abs().max() + 1.0
    mu_s, _, var_s = _source_moments(source_points, wn)
    return wn, mu_s, var_s, 1e-5 * scale, t0, source_points + t0


def umeyama(src, dst, with_scale: bool, weights=None):
    """Least-squares similarity/rigid transform mapping src -> dst: returns
    (scale s, rotation R [3, 3], translation t [3]) minimizing
    sum_i w_i ||dst_i - (s R src_i + t)||^2 (Umeyama 1991)."""
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    wn = weights / torch.clamp(weights.sum(), min=1e-30)
    return umeyama_kernel.umeyama_close(*_moments(src, dst, wn), with_scale)


def apply_rigid(points, s, R, t):
    return s * (points @ R.T) + t


@f32_matmuls
def icp(source_points, target_points, mode: str = "rigid",
        max_iterations: int = 100, source_mask=None, return_iterations=False,
        loop: str = "blocked"):
    """ICP registering source onto target, starting by matching centroids.

    Returns ((s, R, t), moved) with moved = s * source @ R.T + t; with
    ``return_iterations`` also the number of iterations run.  It stops once
    the mean motion of an iteration is <= 1e-5 * scale (NaN included), or
    after ``max_iterations``.

    ``loop="blocked"`` (the default): the masked iteration on the device,
    read every ``ICP_BLOCK`` iterations, captured as a CUDA graph on the card
    (two launches, the k-NN and the step, counted in their modules'
    ``LAUNCHES`` at each replay, masked ones included); ``ICP_STATS`` says
    what it did.
    ``loop="plain"``: one host read per iteration.  Both give the same
    values bit for bit."""
    with_scale = mode == "similarity"
    if mode not in ("rigid", "similarity"):
        raise ValueError("Error invalid transform mode")
    if loop not in ("blocked", "plain"):
        raise ValueError(f"loop must be 'blocked' or 'plain', got {loop!r}")
    dt, dev = source_points.dtype, source_points.device
    source_points = source_points.contiguous()
    if source_mask is None:
        source_mask = torch.ones(source_points.shape[0], dtype=dt, device=dev)
    source_mask = source_mask.contiguous()
    wn, mu_s, var_s, threshold, t0, moved = _start(source_points, target_points, source_mask)
    target_q = target_points.float().contiguous()
    on_card = dev.type == "cuda"
    if on_card:  # the k-NN's outputs, written by every iteration
        nn_out = (torch.empty((source_points.shape[0], 1), dtype=torch.float32, device=dev),
                  torch.empty((source_points.shape[0], 1), dtype=torch.int32, device=dev))

    s = torch.ones((), dtype=dt, device=dev)
    R = torch.eye(3, dtype=dt, device=dev)
    t = t0.clone()
    with spans.host_read("scalar_copy"):
        delta = torch.tensor(float("inf"), dtype=dt, device=dev)
    state = (s, R, t, moved, delta)  # updated in place by icp_step
    ctrl = torch.zeros((2,), dtype=torch.int32, device=dev)  # iterations, done

    def step():
        """One masked iteration: the k-NN from ``moved``, then ``icp_step``
        (the close, the update, the count and the flag).  On the card both
        kernels return at once where the int32 device flag is set; on the
        CPU the iteration is skipped."""
        query = moved.float().contiguous()
        if on_card:
            idx = knn_kernel.knn_cuda(target_q, query, 1, out=nn_out, done=ctrl[1:])[1]
        elif bool(ctrl[1] != 0):
            return
        else:
            idx = knn_kernel.knn_plain(target_q, query, 1)[1]
        umeyama_kernel.icp_step(target_q if on_card else target_points, idx, source_points,
                                source_mask, wn, mu_s, var_s, state, ctrl, threshold,
                                max_iterations, with_scale)

    it = 0
    with spans.span("icp/loop"):
        if loop == "plain":
            done = max_iterations <= 0
            while not done:
                step()
                with spans.host_read("flag_read"):
                    it, done = ctrl.tolist()
        else:
            device_loop.reset_stats(ICP_STATS, ICP_BLOCK)
            if max_iterations > 0:
                it = device_loop.run_blocked(
                    step, ctrl, max_iterations, ICP_BLOCK, ICP_STATS,
                    kernels=(knn_kernel, umeyama_kernel), what="ICP loop")
    spans.count("icp_iterations", it)
    if return_iterations:
        return (s, R, t), moved, it
    return (s, R, t), moved
