"""Iterative closest point (rigid / similarity) registration.

Counterpart of ``pyfocusr_tpu/ops/icp.py``: ``umeyama`` (:31),
``apply_rigid`` (:61) and ``icp`` (:67).  Each iteration is one
nearest-neighbour query (the k-NN kernel on CUDA) plus a closed-form
Umeyama/Kabsch update: the weighted moments in torch, then the 3x3 close
(``umeyama_kernel``: the hand-written kernel on CUDA, ``torch.linalg.svd``
on the CPU).

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

from ..utils import device_loop
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
    (its k-NN and close launches count in their modules' ``LAUNCHES`` at each
    replay, masked ones included); ``ICP_STATS`` says what it did.
    ``loop="plain"``: one host read per iteration.  Both give the same
    values bit for bit."""
    with_scale = mode == "similarity"
    if mode not in ("rigid", "similarity"):
        raise ValueError("Error invalid transform mode")
    if loop not in ("blocked", "plain"):
        raise ValueError(f"loop must be 'blocked' or 'plain', got {loop!r}")
    dt, dev = source_points.dtype, source_points.device
    if source_mask is None:
        source_mask = torch.ones(source_points.shape[0], dtype=dt, device=dev)
    wn = source_mask / torch.clamp(source_mask.sum(), min=1e-30)
    # Target centroid and scale over finite (non-sentinel) rows only.
    finite_t = (target_points.abs() < 1e29).all(dim=1).to(dt)
    tn = finite_t / torch.clamp(finite_t.sum(), min=1e-30)
    t0 = (target_points * tn[:, None]).sum(dim=0) - (
        source_points * wn[:, None]
    ).sum(dim=0)
    moved = source_points + t0
    scale = (target_points * finite_t[:, None]).abs().max() + 1.0
    threshold = 1e-5 * scale

    mu_s, sc, var_s = _source_moments(source_points, wn)
    target_q = target_points.float().contiguous()
    on_card = dev.type == "cuda"
    if on_card:  # the outputs of the kernels, written by every iteration
        nn_out = (torch.empty((source_points.shape[0], 1), dtype=torch.float32, device=dev),
                  torch.empty((source_points.shape[0], 1), dtype=torch.int32, device=dev))
        close_out = torch.empty((13,), dtype=torch.float32, device=dev)

    def iterate(moved, done):
        """One iteration from ``moved``: (s, R, t, new moved, mean motion).
        On the card the k-NN kernel returns at once where the int32 device
        flag ``done`` is set (its outputs then keep the last values)."""
        query = moved.float().contiguous()
        if on_card:
            idx = knn_kernel.knn_cuda(target_q, query, 1, out=nn_out, done=done)[1]
        else:
            idx = knn_kernel.knn_plain(target_q, query, 1)[1]
        matched = target_points.index_select(0, idx[:, 0])
        cov, mu_d = _cross_moments(matched, wn, sc)
        s, R, t = umeyama_kernel.umeyama_close(
            cov, var_s, mu_s, mu_d, with_scale, out=close_out if on_card else None)
        new_moved = apply_rigid(source_points, s, R, t)
        step = torch.linalg.norm(new_moved - moved, dim=1)
        delta = (torch.where(source_mask > 0, step, torch.zeros_like(step)) * wn).sum()
        return s, R, t, new_moved, delta

    s = torch.ones((), dtype=dt, device=dev)
    R = torch.eye(3, dtype=dt, device=dev)
    t = t0
    delta = torch.tensor(float("inf"), dtype=dt, device=dev)
    if loop == "plain":
        it = 0
        while it < max_iterations and bool(delta > threshold):
            s, R, t, moved, delta = iterate(moved, None)
            it += 1
    else:
        device_loop.reset_stats(ICP_STATS, ICP_BLOCK)
        it = 0
        if max_iterations > 0:
            t = t.clone()
            state = (s, R, t, moved, delta)  # the order iterate() returns
            ctrl = torch.zeros((2,), dtype=torch.int32, device=dev)  # it, done
            it_count, done_flag = ctrl[0], ctrl[1:]

            def step():
                done = done_flag[0] != 0
                for old, new in zip(state, iterate(moved, done_flag)):
                    old.copy_(torch.where(done, old, new))
                it_count.add_((~done).to(torch.int32))
                done_flag.copy_(((~(delta > threshold)) | (it_count >= max_iterations))
                                .to(torch.int32).reshape(1))

            it = device_loop.run_blocked(
                step, ctrl, max_iterations, ICP_BLOCK, ICP_STATS,
                kernels=(knn_kernel, umeyama_kernel), what="ICP loop")
    if return_iterations:
        return (s, R, t), moved, it
    return (s, R, t), moved
