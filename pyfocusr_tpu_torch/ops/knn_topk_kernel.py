"""Exact brute-force k-NN for k = 4..128: the hand-written Hopper kernel.

Counterpart of ``pyfocusr_tpu/ops/pallas_kernels.py:647-796``
(``_knn_kernel`` / ``knn_pallas``, which keeps a running top-k of up to
128 in one lane block) for the k that ``csrc/knn.cu`` leaves: its CUDA C++
source is ``csrc/knn_topk.cu``, built at first use by
``ops/_cuda_build.py``.  The contract is ``knn_kernel``'s (direct f32
differences, ascending, ties to the lower index, non-finite references at
1e30, ``(inf, nr)`` for a missing neighbour), and its plain version is
``knn_kernel.knn_plain``, which takes any k: the kernel equals it bit for
bit.  ``knn_kernel.knn_cuda`` dispatches k = 1..3 to ``csrc/knn.cu`` and
k = 4..128 here.

What bounds the kernel and what its design does about it is written at the
top of ``csrc/knn_topk.cu``: a warp owns four queries (one where ``plan``
finds four too few warps, and above k = 32) and keeps each one's sorted
list spread over its lanes; each lane tests its candidates against the
k-th distance held in its registers and the warp votes once every four
steps; at four queries a warp a winner is inserted at once by the whole
warp, at one query and k > 32 the winners wait in per-lane queues that a
bitonic sort merges into the list (FAISS's WarpSelect).
``insertions=`` (an int64 device tensor of one element) receives the number
of insertions the inputs needed, from which the bound counts the list work.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda_build import CudaLibrary, require_sm90

__all__ = ["LAUNCHES", "MAX_D", "MAX_K", "MIN_K", "knn_topk_cuda", "load_library", "plan"]

# Launch count of the CUDA kernel: the wrapper adds one per launch and does
# nothing else with it; callers reset it to 0 to count a run's launches.
LAUNCHES = 0

MIN_K = 4
MAX_K = 128
MAX_D = 16

# The launch plan (csrc/knn_topk.cu, where kWarps is the same number): a CTA
# of WARPS_PER_CTA warps, each owning 4 queries where that still gives the
# grid TARGET_WARPS_PER_SM warps a SM and k <= 32, else 1 query (ICP's 2000
# queries, and k > 32, where the kernel keeps thread queues and the list
# work outweighs the distances).  Measured on the card by
# tools/chip_phases.py --sweep.
WARPS_PER_CTA = 4
TARGET_WARPS_PER_SM = 12


def plan(nq: int, k: int, sms: int = 132) -> dict:
    """The grid for nq queries at k on a card of ``sms`` SMs: queries a
    warp, the CTAs and the grid's warps an SM."""
    qw = 4 if k <= 32 and -(-nq // 4) >= TARGET_WARPS_PER_SM * sms else 1
    ctas = -(-nq // (qw * WARPS_PER_CTA))
    return {"queries_per_warp": qw, "ctas": ctas, "warps_per_sm": ctas * WARPS_PER_CTA / sms}


_VP, _INT = ctypes.c_void_p, ctypes.c_int
_LIBRARY = CudaLibrary("knn_topk.cu", "knn_topk", "k-NN top-k", {
    "pyfocusr_knn_topk_f32": [
        _VP, _VP,  # ref, query
        _INT, _INT, _INT, _INT, _INT,  # nr nq d k qw
        _VP,  # done
        _VP, _VP,  # out_d, out_i
        _VP,  # insertions
        _INT, _VP,  # device, stream
    ],
})
# SMs of each card the wrapper has planned for.
_SMS = {}
# Filled by load_library(): seconds spent in nvcc (0.0 on a cache hit) and
# the compiler's register/shared-memory report.
BUILD_SECONDS = None
BUILD_LOG = ""


def load_library():
    """Build ``csrc/knn_topk.cu`` if its hashed library is missing, then
    load it."""
    global BUILD_SECONDS, BUILD_LOG
    lib = _LIBRARY.load()
    BUILD_SECONDS, BUILD_LOG = _LIBRARY.build_seconds, _LIBRARY.build_log
    return lib


def knn_topk_cuda(ref: torch.Tensor, query: torch.Tensor, k: int, out, done=None,
                  insertions=None):
    """Launch the kernel on the current stream into ``out`` = (f32 [nq, k],
    int32 [nq, k]), on ``plan``'s grid.  ``knn_kernel.knn_cuda`` has checked
    the inputs, the outputs and ``done``; this checks what only this kernel
    limits.  ``insertions``: an int64 [1] device tensor the kernel adds its
    count of list insertions to, or None.  Nothing is read back to the
    host."""
    global LAUNCHES
    d = ref.shape[1]
    if not MIN_K <= k <= MAX_K:
        raise ValueError(f"knn_topk_cuda takes {MIN_K} <= k <= {MAX_K}, got {k}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"knn_topk_cuda supports 1 <= D <= {MAX_D}, got {d}")
    if insertions is not None and (insertions.dtype != torch.int64
                                   or insertions.device != ref.device
                                   or insertions.numel() != 1):
        raise ValueError("knn_topk_cuda needs insertions as one int64 element on "
                         "the inputs' device")
    require_sm90(ref.device, "knn_topk_cuda")
    lib = load_library()
    out_d, out_i = out
    nr, nq = ref.shape[0], query.shape[0]
    if nq == 0:
        return out_d, out_i
    if ref.device not in _SMS:
        _SMS[ref.device] = torch.cuda.get_device_properties(ref.device).multi_processor_count
    qw = plan(nq, k, _SMS[ref.device])["queries_per_warp"]
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    err = lib.pyfocusr_knn_topk_f32(
        ref.data_ptr(), query.data_ptr(), nr, nq, d, k, qw,
        None if done is None else done.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(),
        None if insertions is None else insertions.data_ptr(),
        ref.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"knn top-k CUDA kernel launch failed: error {err}")
    LAUNCHES += 1
    return out_d, out_i
