"""Streamed CPD E-step: the hand-written Hopper kernel and its plain PyTorch
version.

Counterpart of ``pyfocusr_tpu/ops/pallas_kernels.py:58-230``
(``cpd_estep_tiled``, ``_estep_den_kernel`` / ``_estep_row_kernel`` /
``cpd_estep_pallas``).  The CUDA C++ source is ``csrc/cpd_estep.cu``, built
at first use by ``ops/_cuda_build.py``.

Contract, that of ``cpd_estep_tiled``: for X f32 [N, D], TY f32 [M, D],
sigma2 (a float or 0-d tensor) and the outlier weight w, with
c = (2 pi sigma2)^(D/2) w/(1-w) M/N (0 for w = 0),

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
The JAX functions take c itself; these take w and form c from sigma2, so
that the kernel reads sigma2 on the device and nothing else.

Not carried from the TPU version: the +-1e15 padding (the kernel masks the
ragged edge by index), the ``tile_m`` / ``tile_n`` block sizes, and the
``M N >= 4096^2`` dispatch between Pallas and XLA.  f32 only, any D >= 1,
as in the JAX package: the kernel's register-resident instances take D <= 16
and its tiled instance (``estep_den_wide`` / ``estep_row_wide``) any wider
D, the other cloud split across the CTAs of a thread-block cluster as
``plan`` chooses.

``estep_for(X, M, w)`` gives the E-step of one EM run: ``CudaEstep`` for a
CUDA X (its workspaces and outputs allocated once, each call two launches
and no allocation or host read, so it can be captured in a CUDA graph), the
plain version for a CPU X.  ``cpd_estep`` is one call of either.  There is
no fallback from one to the other.  Each launch (den pass, row pass) adds
one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.precision import f32_matmuls
from ._cuda_build import CudaLibrary, require_sm90

__all__ = [
    "LAUNCHES",
    "CudaEstep",
    "cpd_estep",
    "cpd_estep_cuda",
    "cpd_estep_plain",
    "estep_for",
    "load_library",
    "outlier_constant",
    "plan",
]

# Launch count of the CUDA kernel: the wrapper adds one per pass it launches
# (two per E-step) and does nothing else with it; a CUDA graph that holds
# the launches adds them at each replay (ops/cpd.py).  Callers reset it to 0
# to count a run's launches.
LAUNCHES = 0

# The launch plan of the tiled D > 16 instance (csrc/cpd_estep.cu, where
# kWideOwn, kThreads and kWideMaxSplit are the same numbers): a CTA of
# WIDE_THREADS threads owns WIDE_OWN output rows, and the other cloud is
# split across the `splits` CTAs of a thread-block cluster, doubled up to
# WIDE_MAX_SPLIT while the grid holds fewer than WIDE_CTAS_PER_SM CTAs a SM
# and each CTA keeps WIDE_MIN_POINTS points of the other cloud or more.
WIDE_OWN = 32
WIDE_THREADS = 128
WIDE_MAX_SPLIT = 8
WIDE_CTAS_PER_SM = 16
WIDE_MIN_POINTS = 128
REGISTER_MAX_D = 16


def _wide_splits(rows: int, other: int, sms: int) -> int:
    tiles = -(-rows // WIDE_OWN)
    splits = 1
    while (splits < WIDE_MAX_SPLIT and tiles * splits < WIDE_CTAS_PER_SM * sms
           and other // (2 * splits) >= WIDE_MIN_POINTS):
        splits *= 2
    return splits


def plan(N: int, M: int, D: int, sms: int = 132) -> dict:
    """The wide instance's grid for X [N, D] and TY [M, D] on a card of
    ``sms`` SMs: per pass (``den`` over the N rows of X, ``row`` over the M
    rows of TY) the cluster size ``splits``, the CTAs and the warps an SM.
    At D <= 16 the register instances take no split (``splits`` 1, the
    grid is the kernel's own)."""
    out = {}
    slabs = 1 if D <= 64 else -(-D // 64)
    for name, rows, other, z in (("den", N, M, 1), ("row", M, N, slabs)):
        if D <= REGISTER_MAX_D:
            out[name] = {"splits": 1}
            continue
        splits = _wide_splits(rows, other, sms)
        ctas = splits * -(-rows // WIDE_OWN) * z
        out[name] = {"splits": splits, "ctas": ctas,
                     "warps_per_sm": ctas * (WIDE_THREADS // 32) / sms}
    return out


_VP, _INT = ctypes.c_void_p, ctypes.c_int
_LIBRARY = CudaLibrary("cpd_estep.cu", "cpd_estep", "CPD E-step", {
    # N, M, D, den splits, row splits, out[2]
    "pyfocusr_cpd_estep_plan": [_INT, _INT, _INT, _INT, _INT, _VP],
    "pyfocusr_cpd_estep_den_f32": [
        _VP, _VP, _INT, _INT, _INT,  # X, TY, N, M, D
        _VP, ctypes.c_float, _VP, _VP,  # sigma2, outlier coefficient, done, 1/den
        _VP, _VP,  # block sums, counter
        _VP, _VP,  # Pt1, L
        _INT, _INT, _VP,  # splits, device, stream
    ],
    "pyfocusr_cpd_estep_rows_f32": [
        _VP, _VP, _INT, _INT, _INT,  # X, TY, N, M, D
        _VP, _VP, _VP,  # sigma2, done, 1/den
        _VP, _VP,  # block sums, counter
        _VP, _VP,  # p1px, Np
        _INT, _INT, _VP,  # splits, device, stream
    ],
})
# Filled by load_library(): seconds spent in nvcc (0.0 on a cache hit) and
# the compiler's register/shared-memory report.
BUILD_SECONDS = None
BUILD_LOG = ""


def load_library():
    """Build ``csrc/cpd_estep.cu`` if its hashed library is missing, then
    load it."""
    global BUILD_SECONDS, BUILD_LOG
    lib = _LIBRARY.load()
    BUILD_SECONDS, BUILD_LOG = _LIBRARY.build_seconds, _LIBRARY.build_log
    return lib


def outlier_constant(sigma2, w: float, D: int, M: int, N: int):
    """The uniform-outlier term c = (2 pi sigma2)^(D/2) w/(1-w) M/N of the
    E-step's denominator (0 for w = 0, the reference's setting)."""
    if w <= 0:
        return 0.0
    return (2.0 * math.pi * sigma2) ** (D / 2.0) * (w / (1.0 - w)) * (M / N)


def _check_inputs(X: torch.Tensor, TY: torch.Tensor):
    if X.dim() != 2 or TY.dim() != 2 or X.shape[1] != TY.shape[1]:
        raise ValueError(
            f"cpd_estep expects X [N, D] and TY [M, D], got {tuple(X.shape)} "
            f"and {tuple(TY.shape)}"
        )
    if X.dtype != torch.float32 or TY.dtype != torch.float32:
        raise TypeError(f"cpd_estep needs float32, got {X.dtype} and {TY.dtype}")
    if X.shape[1] < 1:
        raise ValueError("cpd_estep needs D >= 1")
    if X.shape[0] < 1 or TY.shape[0] < 1:
        raise ValueError("cpd_estep needs at least one point in X and in TY")


def _scalar(v, device) -> torch.Tensor:
    """A float or 0-d tensor as a 0-d f32 tensor on ``device`` (a float is
    filled in place there, not copied from the host)."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32).reshape(()).contiguous()
    return torch.full((), float(v), dtype=torch.float32, device=device)


class CudaEstep:
    """The kernel for one EM run: X f32 [N, D] on a CUDA device, TY of M
    rows, outlier weight w.  The workspaces and the outputs are allocated
    here, once; each call launches the den pass and the row pass on the
    current stream and returns views of the outputs, which the next call
    overwrites.  A call allocates nothing and reads nothing back to the
    host, so it can be captured in a CUDA graph.  The D > 16 instance
    runs on ``plan``'s grid."""

    def __init__(self, X: torch.Tensor, M: int, w: float = 0.0):
        _check_inputs(X, X)
        if X.device.type != "cuda":
            raise ValueError(f"CudaEstep needs X on a CUDA device, got {X.device}")
        if not X.is_contiguous():
            raise ValueError("CudaEstep needs a contiguous X")
        (N, D), dev = X.shape, X.device
        if max(N, M) >= 2**31 // (D + 1):
            raise ValueError("CudaEstep indexes points with int32")
        require_sm90(dev, "CudaEstep")
        self.lib = load_library()
        self.plan = plan(N, M, D, torch.cuda.get_device_properties(dev).multi_processor_count)
        self.splits = (self.plan["den"]["splits"], self.plan["row"]["splits"])
        blocks = (ctypes.c_int * 2)()
        err = self.lib.pyfocusr_cpd_estep_plan(N, M, D, *self.splits,
                                               ctypes.addressof(blocks))
        if err != 0:
            raise RuntimeError(f"cpd_estep plan failed: error {err}")
        den_blocks, row_blocks = blocks
        self.plan["den"]["blocks"], self.plan["row"]["blocks"] = den_blocks, row_blocks
        self.X, self.N, self.M, self.D = X, N, M, D
        self.coef = float(w / (1.0 - w) * (M / N)) if w > 0 else 0.0
        f32 = dict(dtype=torch.float32, device=dev)
        self.pt1 = torch.empty((N,), **f32)
        self.p1px = torch.empty((M * (D + 1),), **f32)
        self.scalars = torch.empty((2,), **f32)  # L, Np
        self.inv_den = torch.empty((N,), **f32)
        self.block_sums = torch.empty((den_blocks + row_blocks,), **f32)
        self.row_sums_ptr = self.block_sums.data_ptr() + 4 * den_blocks
        self.counters = torch.zeros((2,), dtype=torch.int32, device=dev)

    def __call__(self, TY: torch.Tensor, sigma2: torch.Tensor, done=None):
        """E-step outputs for TY f32 [M, D] (contiguous, on X's device) at the
        0-d f32 device tensor sigma2; when the int32 device flag ``done`` is
        given and non-zero, both passes return at once and the outputs keep
        their previous values."""
        self.den_pass(TY, sigma2, done)
        self.row_pass(TY, sigma2, done)
        M, D = self.M, self.D
        return (self.pt1, self.p1px[:M], self.p1px[M:].view(M, D),
                self.scalars[1], self.scalars[0])

    def _pointers(self, TY, sigma2, done):
        X, M, D = self.X, self.M, self.D
        if tuple(TY.shape) != (M, D) or TY.dtype != torch.float32 \
                or TY.device != X.device or not TY.is_contiguous():
            raise ValueError(
                f"CudaEstep was planned for a contiguous f32 TY [{M}, {D}] on "
                f"{X.device}, got {TY.dtype} {tuple(TY.shape)} on {TY.device}")
        if not (torch.is_tensor(sigma2) and sigma2.dtype == torch.float32
                and sigma2.numel() == 1 and sigma2.device == X.device):
            raise ValueError("CudaEstep needs sigma2 as a one-element f32 tensor on "
                             "X's device")
        if done is not None and (done.dtype != torch.int32 or done.device != X.device):
            raise ValueError("CudaEstep needs done as an int32 tensor on X's device")
        return (TY.data_ptr(), sigma2.data_ptr(), None if done is None else done.data_ptr(),
                X.device.index, torch.cuda.current_stream(X.device).cuda_stream)

    def den_pass(self, TY, sigma2, done=None):
        """The den pass alone (Pt1, L and 1/den for the row pass)."""
        global LAUNCHES
        ty, s2, done_ptr, dev, stream = self._pointers(TY, sigma2, done)
        err = self.lib.pyfocusr_cpd_estep_den_f32(
            self.X.data_ptr(), ty, self.N, self.M, self.D, s2, self.coef, done_ptr,
            self.inv_den.data_ptr(), self.block_sums.data_ptr(),
            self.counters.data_ptr(), self.pt1.data_ptr(), self.scalars.data_ptr(),
            self.splits[0], dev, stream,
        )
        if err != 0:
            raise RuntimeError(f"cpd_estep den pass launch failed: error {err}")
        LAUNCHES += 1

    def row_pass(self, TY, sigma2, done=None):
        """The row pass alone (P1, PX and Np), after a den pass."""
        global LAUNCHES
        ty, s2, done_ptr, dev, stream = self._pointers(TY, sigma2, done)
        err = self.lib.pyfocusr_cpd_estep_rows_f32(
            self.X.data_ptr(), ty, self.N, self.M, self.D, s2, done_ptr,
            self.inv_den.data_ptr(), self.row_sums_ptr, self.counters.data_ptr() + 4,
            self.p1px.data_ptr(), self.scalars.data_ptr() + 4, self.splits[1], dev, stream,
        )
        if err != 0:
            raise RuntimeError(f"cpd_estep row pass launch failed: error {err}")
        LAUNCHES += 1


def cpd_estep_cuda(X, TY, sigma2, w: float = 0.0):
    """One E-step through the CUDA kernel (den pass, then row pass) on the
    current stream, with outputs of its own.  Raises on anything the kernel
    does not take; never falls back to the plain version."""
    _check_inputs(X, TY)
    if X.device.type != "cuda" or TY.device != X.device:
        raise ValueError(
            f"cpd_estep_cuda needs X and TY on one CUDA device, got {X.device} "
            f"and {TY.device}"
        )
    if not (X.is_contiguous() and TY.is_contiguous()):
        raise ValueError("cpd_estep_cuda needs contiguous X and TY")
    return CudaEstep(X, TY.shape[0], w)(TY, _scalar(sigma2, X.device))


@f32_matmuls
def cpd_estep_plain(X, TY, sigma2, w: float = 0.0, tile_m: int = 2048):
    """Plain PyTorch version of the kernel, the port of ``cpd_estep_tiled``:
    both passes over M-tiles of TY, one [tile_m, N] slab at a time, with the
    kernel's distance formula (direct differences in dimension order) and
    exp(d2 * -(1 / (2 sigma2)))."""
    _check_inputs(X, TY)
    (N, D), M = X.shape, TY.shape[0]
    s2 = _scalar(sigma2, X.device)
    cc = _scalar(outlier_constant(s2, w, D, M, N), X.device)
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
    P1 = torch.cat(P1)
    L = -torch.log(den).sum() + D * N * torch.log(s2) / 2.0
    return 1.0 - cc * inv_den, P1, torch.cat(PX), P1.sum(), L


def estep_for(X, M: int, w: float = 0.0):
    """The streamed E-step of one EM run on X and M moving points, as a
    callable ``(TY, sigma2, done=None) -> (Pt1, P1, PX, Np, L)``: the plain
    version for a CPU X (``done`` unused), ``CudaEstep`` for a CUDA X."""
    if X.device.type == "cpu":
        return lambda TY, sigma2, done=None: cpd_estep_plain(X, TY, sigma2, w)
    return CudaEstep(X.contiguous(), M, w)


def cpd_estep(X, TY, sigma2, w: float = 0.0):
    """The streamed E-step: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if X.device.type == "cpu" and TY.device.type == "cpu":
        return cpd_estep_plain(X, TY, sigma2, w)
    return cpd_estep_cuda(X.contiguous(), TY.contiguous(), sigma2, w)
