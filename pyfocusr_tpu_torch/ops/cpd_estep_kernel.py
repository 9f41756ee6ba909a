"""Streamed CPD E-step: the hand-written Hopper kernel and its plain PyTorch
version.

Counterpart of ``pyfocusr_tpu/ops/pallas_kernels.py:58-230``
(``cpd_estep_tiled``, ``_estep_den_kernel`` / ``_estep_row_kernel`` /
``cpd_estep_pallas``).  The CUDA C++ source is ``csrc/cpd_estep.cu``, built
at first use by ``ops/_cuda_build.py``.

Contract, that of ``cpd_estep_tiled``: for X f32 [N, D], TY f32 [M, D],
sigma2 and the outlier constant c (floats or 0-d tensors),

    den_n = max(sum_m exp(-|x_n - ty_m|^2 / 2 sigma2) + c, 1e-30)
    P1_m  = sum_n p_mn / den_n,     PX = (P / den) X
    Pt1   = 1 - c / den,            Np = sum P1
    L     = -sum_n log den_n + D N log(sigma2) / 2

returned as ``(Pt1 [N], P1 [M], PX [M, D], Np, L)``, with no max-rescaling
of the exponent (cycpd's raw exp).  The [M, N] responsibility matrix is never
formed: the plain version holds one [tile_m, N] slab at a time, the kernel
none.  Both take squared distances as direct differences sum_d (x_d -
ty_d)^2 rather than the JAX package's |x|^2 + |ty|^2 - 2 x.ty identity;
the identity cancels in f32 once sigma2 is small, the differences do not.

Not carried from the TPU version: the +-1e15 padding (the kernel masks the
ragged edge by index), the ``tile_m`` / ``tile_n`` block sizes, and the
``M N >= 4096^2`` dispatch between Pallas and XLA.  f32 only, 1 <= D <= 16.

``cpd_estep`` dispatches on where the tensors lie: CPU tensors take
``cpd_estep_plain``; CUDA tensors launch the kernel or raise.  There is no
fallback from one to the other.  One call of the kernel is two launches
(the den pass, then the row pass), each counted in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.precision import f32_matmuls
from ._cuda_build import CudaLibrary, require_sm90

__all__ = [
    "LAUNCHES",
    "MAX_D",
    "cpd_estep",
    "cpd_estep_cuda",
    "cpd_estep_plain",
    "load_library",
]

# Launch count of the CUDA kernel: the wrapper adds one per pass it launches
# (two per E-step) and does nothing else with it; callers reset it to 0 to
# count a run's launches.
LAUNCHES = 0

# Widest point dimension the kernel takes (its register arrays are padded
# to 3, 6, 8 or 16).
MAX_D = 16

_LIBRARY = CudaLibrary("cpd_estep.cu", "cpd_estep", "CPD E-step", {
    "pyfocusr_cpd_estep_den_f32": [
        ctypes.c_void_p, ctypes.c_void_p,  # X, TY
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # N, M, D
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # params, chunks, part
        ctypes.c_void_p, ctypes.c_void_p,  # den, inv_den
        ctypes.c_int, ctypes.c_void_p,  # device, stream
    ],
    "pyfocusr_cpd_estep_rows_f32": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # X, TY, inv_den
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # N, M, D
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # params, chunks, part
        ctypes.c_void_p,  # p1px
        ctypes.c_int, ctypes.c_void_p,  # device, stream
    ],
})
# Filled by load_library(): seconds spent in nvcc (0.0 on a cache hit) and
# the compiler's register/shared-memory report.
BUILD_SECONDS = None
BUILD_LOG = ""

# Each pass splits its reduced axis into chunks so that about this many
# blocks of 256 threads exist: one full wave at 8 blocks per SM on the
# card's 132 SMs.  A chunk keeps at least _MIN_CHUNK rows.
_BLOCKS_TARGET = 1056
_MIN_CHUNK = 256
_THREADS = 256


def load_library():
    """Build ``csrc/cpd_estep.cu`` if its hashed library is missing, then
    load it."""
    global BUILD_SECONDS, BUILD_LOG
    lib = _LIBRARY.load()
    BUILD_SECONDS, BUILD_LOG = _LIBRARY.build_seconds, _LIBRARY.build_log
    return lib


def _check_inputs(X: torch.Tensor, TY: torch.Tensor):
    if X.dim() != 2 or TY.dim() != 2 or X.shape[1] != TY.shape[1]:
        raise ValueError(
            f"cpd_estep expects X [N, D] and TY [M, D], got {tuple(X.shape)} "
            f"and {tuple(TY.shape)}"
        )
    if X.dtype != torch.float32 or TY.dtype != torch.float32:
        raise TypeError(f"cpd_estep needs float32, got {X.dtype} and {TY.dtype}")
    if not 1 <= X.shape[1] <= MAX_D:
        raise ValueError(f"cpd_estep takes 1 <= D <= {MAX_D}, got D = {X.shape[1]}")
    if X.shape[0] < 1 or TY.shape[0] < 1:
        raise ValueError("cpd_estep needs at least one point in X and in TY")


def _scalar(v, device) -> torch.Tensor:
    """A float or 0-d tensor as a 0-d f32 tensor on ``device`` (a float is
    filled in place there, not copied from the host)."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _chunks(n_owned: int, n_reduced: int) -> int:
    """Chunks of the reduced axis for a pass whose threads own
    ``n_owned`` rows (see ``_BLOCKS_TARGET``)."""
    blocks = -(-n_owned // _THREADS)
    return max(1, min(-(-_BLOCKS_TARGET // blocks), -(-n_reduced // _MIN_CHUNK), 65535))


def _finish(den, inv_den, P1, PX, sigma2, c, D: int):
    """Pt1, Np and L around the two passes (both versions share it)."""
    N = den.shape[0]
    L = -torch.log(den).sum() + D * N * torch.log(sigma2) / 2.0
    return 1.0 - c * inv_den, P1, PX, P1.sum(), L


def cpd_estep_cuda(X, TY, sigma2, c=0.0):
    """Launch the CUDA kernel (den pass, then row pass) on the current
    stream.  Raises on anything the kernel does not take; never falls back
    to the plain version.  sigma2 and c stay on the device."""
    global LAUNCHES
    _check_inputs(X, TY)
    if X.device.type != "cuda" or TY.device != X.device:
        raise ValueError(
            f"cpd_estep_cuda needs X and TY on one CUDA device, got {X.device} "
            f"and {TY.device}"
        )
    if not (X.is_contiguous() and TY.is_contiguous()):
        raise ValueError("cpd_estep_cuda needs contiguous X and TY")
    (N, D), M = X.shape, TY.shape[0]
    if max(N, M) >= 2**31:
        raise ValueError("cpd_estep_cuda indexes points with int32")
    require_sm90(X.device, "cpd_estep_cuda")
    lib = load_library()
    dev = X.device
    s2, cc = _scalar(sigma2, dev), _scalar(c, dev)
    params = torch.stack([1.0 / (2.0 * s2), cc]).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream

    den = torch.empty((N,), dtype=torch.float32, device=dev)
    inv_den = torch.empty((N,), dtype=torch.float32, device=dev)
    chunks = _chunks(N, M)
    part = torch.empty((chunks, N), dtype=torch.float32, device=dev)
    err = lib.pyfocusr_cpd_estep_den_f32(
        X.data_ptr(), TY.data_ptr(), N, M, D, params.data_ptr(), chunks,
        part.data_ptr(), den.data_ptr(), inv_den.data_ptr(), dev.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"cpd_estep den pass launch failed: error {err}")
    LAUNCHES += 1

    p1px = torch.empty((M * (D + 1),), dtype=torch.float32, device=dev)
    chunks = _chunks(M, N)
    part = torch.empty((chunks, M * (D + 1)), dtype=torch.float32, device=dev)
    err = lib.pyfocusr_cpd_estep_rows_f32(
        X.data_ptr(), TY.data_ptr(), inv_den.data_ptr(), N, M, D,
        params.data_ptr(), chunks, part.data_ptr(), p1px.data_ptr(),
        dev.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"cpd_estep row pass launch failed: error {err}")
    LAUNCHES += 1
    return _finish(den, inv_den, p1px[:M], p1px[M:].view(M, D), s2, cc, D)


@f32_matmuls
def cpd_estep_plain(X, TY, sigma2, c=0.0, tile_m: int = 2048):
    """Plain PyTorch version of the kernel, the port of ``cpd_estep_tiled``:
    both passes over M-tiles of TY, one [tile_m, N] slab at a time, with the
    kernel's distance formula (direct differences in dimension order) and
    its scaling exp(d2 * -(1 / (2 sigma2)))."""
    _check_inputs(X, TY)
    (N, D), M = X.shape, TY.shape[0]
    s2, cc = _scalar(sigma2, X.device), _scalar(c, X.device)
    neg_inv2s2 = -(1.0 / (2.0 * s2))

    def slab(ty):
        d2 = torch.zeros((ty.shape[0], N), dtype=torch.float32, device=X.device)
        for d in range(D):
            diff = ty[:, d : d + 1] - X[None, :, d]
            d2.addcmul_(diff, diff)
        return torch.exp(d2 * neg_inv2s2)

    tiles = [TY[s : s + tile_m] for s in range(0, M, tile_m)]
    den = torch.zeros((N,), dtype=torch.float32, device=X.device)
    for ty in tiles:
        den += slab(ty).sum(dim=0)
    den = torch.clamp(den + cc, min=1e-30)
    inv_den = 1.0 / den
    P1, PX = [], []
    for ty in tiles:
        Pn = slab(ty) * inv_den[None, :]
        P1.append(Pn.sum(dim=1))
        PX.append(Pn @ X)
    return _finish(den, inv_den, torch.cat(P1), torch.cat(PX), s2, cc, D)


def cpd_estep(X, TY, sigma2, c=0.0):
    """The streamed E-step: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if X.device.type == "cpu" and TY.device.type == "cpu":
        return cpd_estep_plain(X, TY, sigma2, c)
    return cpd_estep_cuda(X.contiguous(), TY.contiguous(), sigma2, c)
