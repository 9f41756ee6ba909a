"""Exact brute-force k-NN: the hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``pyfocusr_tpu/ops/pallas_kernels.py:647-796``
(``_knn_kernel`` / ``knn_pallas``).  The CUDA C++ source is
``csrc/knn.cu``; ``ops/_cuda_build.py`` compiles it for ``sm_90a`` with
``nvcc`` into a shared library with a plain C interface at first use, cached
under ``build/pyfocusr_tpu_torch/`` keyed on a hash of the source and the
flags, and loads it with ``ctypes``.

What bounds the kernel on the H100, and what its design does about it, is
written at the top of ``csrc/knn.cu``: the search is issue-bound (the data
is ~100 KB; each pair is 3 D unfused f32 instructions), so a thread owns
several queries and reads each reference point with one 16-byte shared
load, lanes and the CTAs of a thread-block cluster split the reference axis
(ICP's 2000 queries alone would fill a third of the card), and the partial
top-k lists merge through warp shuffles and distributed shared memory.
``plan`` reports the launch shape the library picks.

Contract (both versions, bit-identical to each other):

* squared distances are direct f32 sums over dimensions, in order, with the
  product and the sum rounded separately — never the matmul identity;
* ascending top-k, ties to the lower reference index;
* non-finite reference coordinates become 1e30 (those rows never win);
* a slot without a neighbour reports ``(inf, nr)``: fewer than k finite
  candidates, or a squared distance >= 1e29;
* Euclidean distances f32 ``[nq, k]``, indices int32 ``[nq, k]``.

``knn`` dispatches on where the tensors lie: CPU tensors take
``knn_plain``; CUDA tensors launch the kernel or raise.  There is no
fallback from one to the other.  ``knn_cuda`` can write into outputs the
caller allocated once and skip on a device flag (``out=``, ``done=``), so
that a loop captured as a CUDA graph allocates nothing for it.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda_build import CudaLibrary, require_sm90

__all__ = [
    "LAUNCHES",
    "MAX_D",
    "SUPPORTED_K",
    "knn",
    "knn_cuda",
    "knn_plain",
    "load_library",
    "plan",
]

# Launch count of the CUDA kernel: the wrapper adds one per launch and does
# nothing else with it; callers reset it to 0 to count a run's launches.
LAUNCHES = 0

SUPPORTED_K = (1, 2, 3)
MAX_D = 16

_LIBRARY = CudaLibrary("knn.cu", "knn", "k-NN", {
    "pyfocusr_knn_f32": [
        ctypes.c_void_p, ctypes.c_void_p,  # ref, query
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nr nq d k
        ctypes.c_void_p,  # done
        ctypes.c_void_p, ctypes.c_void_p,  # out_d, out_i
        ctypes.c_int, ctypes.c_void_p,  # device, stream
    ],
    "pyfocusr_knn_plan": [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # nq nr device out
    ],
})
_PLAN_FIELDS = ("query_tiles", "splits", "queries_per_cta", "threads_per_cta",
                "lanes_per_query", "queries_per_thread", "tile_points")
# Filled by load_library(): seconds spent in nvcc (0.0 on a cache hit) and
# the compiler's register/shared-memory report.
BUILD_SECONDS = None
BUILD_LOG = ""


def load_library():
    """Build ``csrc/knn.cu`` if its hashed library is missing, then load it."""
    global BUILD_SECONDS, BUILD_LOG
    lib = _LIBRARY.load()
    BUILD_SECONDS, BUILD_LOG = _LIBRARY.build_seconds, _LIBRARY.build_log
    return lib


def _check_inputs(ref: torch.Tensor, query: torch.Tensor, k: int):
    if ref.dim() != 2 or query.dim() != 2:
        raise ValueError(
            f"knn expects 2-D ref and query, got {tuple(ref.shape)} and "
            f"{tuple(query.shape)}"
        )
    if ref.shape[1] != query.shape[1]:
        raise ValueError(
            f"ref has D={ref.shape[1]} but query has D={query.shape[1]}"
        )
    if ref.dtype != torch.float32 or query.dtype != torch.float32:
        raise TypeError(f"knn needs float32, got {ref.dtype} and {query.dtype}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def plan(nq: int, nr: int, device=0) -> dict:
    """The launch shape the library picks for nq queries against nr
    references on ``device``: query tiles, the split of the reference axis
    (CTAs a cluster), and the kernel's constants."""
    out = (ctypes.c_int * len(_PLAN_FIELDS))()
    err = load_library().pyfocusr_knn_plan(nq, nr, torch.device(device).index or 0,
                                           ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"knn plan failed: CUDA error {err}")
    return dict(zip(_PLAN_FIELDS, out))


def _check_out(out, nq: int, k: int, device):
    """Raise unless ``out`` is (f32 [nq, k], int32 [nq, k]), contiguous, on
    ``device``."""
    out_d, out_i = out
    for t, dtype in ((out_d, torch.float32), (out_i, torch.int32)):
        if (tuple(t.shape) != (nq, k) or t.dtype != dtype or t.device != device
                or not t.is_contiguous()):
            raise ValueError(
                f"knn_cuda out= needs contiguous f32 and int32 [{nq}, {k}] on "
                f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def knn_cuda(ref: torch.Tensor, query: torch.Tensor, k: int, out=None,
             done=None):
    """Launch the CUDA kernel on the current stream.  Raises on anything the
    kernel does not take; never falls back to the plain version.

    ``out``: (f32 [nq, k], int32 [nq, k]) to write into, else allocated.
    ``done``: an int32 device tensor; where its first element is non-zero
    the kernel returns at once and leaves the outputs as they were.
    Nothing is read back to the host."""
    global LAUNCHES
    _check_inputs(ref, query, k)
    if ref.device.type != "cuda" or query.device != ref.device:
        raise ValueError(
            f"knn_cuda needs both tensors on one CUDA device, got {ref.device} "
            f"and {query.device}"
        )
    if not (ref.is_contiguous() and query.is_contiguous()):
        raise ValueError("knn_cuda needs contiguous ref and query")
    d = ref.shape[1]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"knn_cuda supports 1 <= D <= {MAX_D}, got {d}")
    if k not in SUPPORTED_K:
        raise ValueError(f"knn_cuda supports k in {SUPPORTED_K}, got {k}")
    nr, nq = ref.shape[0], query.shape[0]
    if max(nr, nq) * max(d, k) >= 2**31:
        raise ValueError("knn_cuda indexes with int32: input too large")
    if done is not None and (done.dtype != torch.int32 or done.device != ref.device):
        raise ValueError("knn_cuda needs done as an int32 tensor on the inputs' device")
    require_sm90(ref.device, "knn_cuda")
    lib = load_library()
    if out is None:
        out = (torch.empty((nq, k), dtype=torch.float32, device=ref.device),
               torch.empty((nq, k), dtype=torch.int32, device=ref.device))
    else:
        _check_out(out, nq, k, ref.device)
    out_d, out_i = out
    if nq == 0:
        return out_d, out_i
    # The launch is asynchronous.  Inputs a caller frees right after the
    # return stay valid for it: the caching allocator hands their memory
    # only to work queued later on this same stream.
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    err = lib.pyfocusr_knn_f32(
        ref.data_ptr(), query.data_ptr(), nr, nq, d, k,
        None if done is None else done.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), ref.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"knn CUDA kernel launch failed: error {err}")
    LAUNCHES += 1
    return out_d, out_i


# Rows of one [rows, nr] distance block in the plain version (~64 MB f32).
_PLAIN_BLOCK_ELEMS = 1 << 24


def knn_plain(ref: torch.Tensor, query: torch.Tensor, k: int):
    """Plain PyTorch version of the kernel, same contract, bit-identical
    results: chunked direct differences, then k rounds of first-argmin."""
    _check_inputs(ref, query, k)
    nq, d = query.shape
    nr = ref.shape[0]
    dev = ref.device
    out_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((nq, k), nr, dtype=torch.int32, device=dev)
    if nr == 0 or nq == 0:
        return out_d, out_i
    ref = torch.where(torch.isfinite(ref), ref, torch.full_like(ref, 1e30))
    kk = min(k, nr)
    rows = max(1, _PLAIN_BLOCK_ELEMS // nr)
    inf = torch.tensor(float("inf"), device=dev)
    for s in range(0, nq, rows):
        q = query[s : s + rows]
        acc = torch.zeros((q.shape[0], nr), dtype=torch.float32, device=dev)
        for c in range(d):
            diff = q[:, c, None] - ref[None, :, c]
            acc = acc + diff * diff
        # NaN (from a NaN query coordinate) never wins, as in the kernel.
        acc = torch.where(torch.isnan(acc), inf, acc)
        for t in range(kk):
            idx = torch.argmin(acc, dim=1)  # first minimum: lower index wins
            val = acc.gather(1, idx[:, None])[:, 0]
            bad = ~(val < 1e29)
            out_d[s : s + rows, t] = torch.where(
                bad, inf, torch.sqrt(torch.clamp(val, min=0.0))
            )
            out_i[s : s + rows, t] = torch.where(
                bad, torch.full_like(idx, nr), idx
            ).to(torch.int32)
            if t + 1 < kk:
                acc.scatter_(1, idx[:, None], inf.expand(idx.shape[0], 1))
    return out_d, out_i


def knn(ref: torch.Tensor, query: torch.Tensor, k: int):
    """k nearest reference rows of each query row: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if ref.device.type == "cpu" and query.device.type == "cpu":
        return knn_plain(ref, query, k)
    return knn_cuda(ref, query, k)
