"""Annealed Sinkhorn dual updates: the hand-written Hopper kernel, its plain
PyTorch version and the annealing loop over them.

Counterpart of ``pyfocusr_tpu/ops/pallas_kernels.py:265-396``
(``_lse_rows_kernel`` / ``_lse_rows_pallas``, ``_sinkhorn_phase``,
``sinkhorn_duals_streamed``).  The CUDA C++ source is ``csrc/lse_rows.cu``,
built at first use by ``ops/_cuda_build.py``.

One dual update is one logsumexp per row of the cost,

    out_i = -(m_i + log(max(s_i, 1e-30)) / inv_t),
    m_i = max_j (vec_j - C_ij),  s_i = sum_j exp(((vec_j - C_ij) - m_i) * inv_t),

taken along the rows of C with vec = g (the f update) and down the columns
of C with vec = f (the g update, ``transpose=True``).  The TPU version gets
the column update from the row kernel on a transpose made once; the CUDA
kernel reduces down the columns of C directly (coalesced across a warp's
lanes), so no second copy of the matrix exists.  What bounds the kernel and
what its design does about it is written at the top of ``csrc/lse_rows.cu``:
each call reads the matrix once and is bound by device-memory bandwidth.

Not carried from the TPU version: the 1e30 padding with masked duals (the
CUDA kernel masks the ragged edge by index), the ``tile_r`` block size, and
the bf16 cost stream (``cost_dtype`` / ``f32_tail_levels``), a TPU bandwidth
measure.  This module is float32 only.

``lse_rows`` dispatches on where the tensors lie: CPU tensors take
``lse_rows_plain``; CUDA tensors launch the kernel or raise.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda_build import CudaLibrary, require_sm90

__all__ = [
    "LAUNCHES",
    "load_library",
    "lse_rows",
    "lse_rows_cuda",
    "lse_rows_plain",
    "sinkhorn_duals_streamed",
    "temperatures",
]

# Launch count of the CUDA kernel: the wrapper adds one per dual update it
# launches and does nothing else with it; callers reset it to 0 to count a
# run's launches.
LAUNCHES = 0

_LIBRARY = CudaLibrary("lse_rows.cu", "lse_rows", "Sinkhorn row-logsumexp", {
    "pyfocusr_lse_rows_f32": [
        ctypes.c_void_p, ctypes.c_void_p,  # cost, vec
        ctypes.c_int, ctypes.c_int, ctypes.c_float,  # n_rows n_cols inv_t
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_void_p,  # device, stream
    ],
    "pyfocusr_lse_cols_f32": [
        ctypes.c_void_p, ctypes.c_void_p,  # cost, vec
        ctypes.c_int, ctypes.c_int, ctypes.c_float,  # n_rows n_cols inv_t
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # row_chunks part_m part_s
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_void_p,  # device, stream
    ],
})
# Filled by load_library(): seconds spent in nvcc (0.0 on a cache hit) and
# the compiler's register/shared-memory report.
BUILD_SECONDS = None
BUILD_LOG = ""

# The column pass splits the row axis so that about this many blocks (of 32
# columns x one row chunk) exist: a few waves over the card's 132 SMs.
_COL_BLOCKS_TARGET = 4096


def load_library():
    """Build ``csrc/lse_rows.cu`` if its hashed library is missing, then
    load it."""
    global BUILD_SECONDS, BUILD_LOG
    lib = _LIBRARY.load()
    BUILD_SECONDS, BUILD_LOG = _LIBRARY.build_seconds, _LIBRARY.build_log
    return lib


def _check_inputs(cost: torch.Tensor, vec: torch.Tensor, transpose: bool):
    if cost.dim() != 2 or vec.dim() != 1:
        raise ValueError(
            f"lse_rows expects a 2-D cost and a 1-D vec, got "
            f"{tuple(cost.shape)} and {tuple(vec.shape)}"
        )
    n_reduce = cost.shape[0] if transpose else cost.shape[1]
    if vec.shape[0] != n_reduce:
        raise ValueError(
            f"vec has {vec.shape[0]} entries but the reduced axis of the cost "
            f"{tuple(cost.shape)} (transpose={transpose}) has {n_reduce}"
        )
    if cost.dtype != torch.float32 or vec.dtype != torch.float32:
        raise TypeError(f"lse_rows needs float32, got {cost.dtype} and {vec.dtype}")


def _col_row_chunks(n_rows: int, n_cols: int) -> int:
    """Row chunks of the column pass (see ``_COL_BLOCKS_TARGET``); a chunk
    keeps at least 32 rows."""
    tiles = -(-n_cols // 32)
    return max(1, min(-(-_COL_BLOCKS_TARGET // tiles), n_rows // 32, 65535))


def lse_rows_cuda(cost, vec, inv_t: float, transpose: bool = False):
    """Launch the CUDA kernel on the current stream.  Raises on anything the
    kernel does not take; never falls back to the plain version."""
    global LAUNCHES
    _check_inputs(cost, vec, transpose)
    if cost.device.type != "cuda" or vec.device != cost.device:
        raise ValueError(
            f"lse_rows_cuda needs both tensors on one CUDA device, got "
            f"{cost.device} and {vec.device}"
        )
    if not (cost.is_contiguous() and vec.is_contiguous()):
        raise ValueError("lse_rows_cuda needs a contiguous cost and vec")
    n_rows, n_cols = cost.shape
    if max(n_rows, n_cols) >= 2**31:
        raise ValueError("lse_rows_cuda indexes rows and columns with int32")
    require_sm90(cost.device, "lse_rows_cuda")
    lib = load_library()
    dev = cost.device
    out = torch.empty((n_cols if transpose else n_rows,), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    if transpose:
        chunks = _col_row_chunks(n_rows, n_cols)
        part = torch.empty((2, chunks, n_cols), dtype=torch.float32, device=dev)
        err = lib.pyfocusr_lse_cols_f32(
            cost.data_ptr(), vec.data_ptr(), n_rows, n_cols, float(inv_t),
            chunks, part[0].data_ptr(), part[1].data_ptr(), out.data_ptr(),
            dev.index, stream,
        )
    else:
        err = lib.pyfocusr_lse_rows_f32(
            cost.data_ptr(), vec.data_ptr(), n_rows, n_cols, float(inv_t),
            out.data_ptr(), dev.index, stream,
        )
    if err != 0:
        raise RuntimeError(f"lse_rows CUDA kernel launch failed: error {err}")
    LAUNCHES += 1
    return out


def lse_rows_plain(cost, vec, inv_t: float, transpose: bool = False):
    """Plain PyTorch version of the kernel: the two-pass form of
    ``_lse_rows_kernel`` (max first, then the rescaled sum).  Makes two
    temporaries of the cost's size."""
    _check_inputs(cost, vec, transpose)
    dim = 0 if transpose else 1
    A = vec.unsqueeze(1 - dim) - cost
    m = A.amax(dim=dim)
    s = torch.exp((A - m.unsqueeze(dim)) * inv_t).sum(dim=dim)
    return -(m + torch.log(torch.clamp(s, min=1e-30)) / inv_t)


def lse_rows(cost, vec, inv_t: float, transpose: bool = False):
    """One Sinkhorn dual update: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if cost.device.type == "cpu" and vec.device.type == "cpu":
        return lse_rows_plain(cost, vec, inv_t, transpose)
    return lse_rows_cuda(cost, vec, inv_t, transpose)


def temperatures(T0: float, T_factor: float, levels: int):
    """The annealing schedule T0 * T_factor**level and its reciprocals, as
    python floats holding float32 values (the arithmetic of
    ``_sinkhorn_phase``)."""
    ts = torch.tensor(float(T0), dtype=torch.float32) * torch.tensor(
        float(T_factor), dtype=torch.float32
    ) ** torch.arange(levels, dtype=torch.float32)
    return ts.tolist(), (1.0 / ts).tolist()


def sinkhorn_duals_streamed(cost, T0, T_factor: float, levels: int,
                            iters_per_level: int, init=None):
    """Annealed Sinkhorn dual potentials (f, g) of the entropic relaxation
    of the assignment problem on ``cost`` f32 [n, n]: at each temperature
    T0 * T_factor**level, ``iters_per_level`` times

        f = lse_rows(cost, g, 1/T);  g = lse_rows(cost, f, 1/T, transpose=True)

    so every update reads the cost exactly once.  ``T0`` is a float or a
    0-d tensor (read to the host once).  ``init``: optional (f [n], g [n])
    duals to resume a schedule from; zeros when None.  ``levels=0`` returns
    the initial duals unchanged.
    """
    if cost.dim() != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(
            f"sinkhorn_duals_streamed requires a square cost, got {tuple(cost.shape)}"
        )
    n = cost.shape[0]
    if init is None:
        f = torch.zeros((n,), dtype=torch.float32, device=cost.device)
        g = torch.zeros((n,), dtype=torch.float32, device=cost.device)
    else:
        f = init[0].to(dtype=torch.float32, device=cost.device)
        g = init[1].to(dtype=torch.float32, device=cost.device)
    cost = cost.contiguous()
    _, inv_ts = temperatures(T0, T_factor, levels)
    for inv_t in inv_ts:
        for _ in range(iters_per_level):
            f = lse_rows(cost, g, inv_t)
            g = lse_rows(cost, f, inv_t, transpose=True)
    return f, g
