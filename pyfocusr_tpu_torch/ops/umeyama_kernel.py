"""The 3x3 close of Umeyama's method and ICP's update step around it: the
hand-written Hopper kernels and their plain PyTorch versions.

The close takes the weighted moments of an ICP iteration to its similarity
transform, the SVD step of ``pyfocusr_tpu/ops/icp.py::umeyama`` (:31-58):

    U S Vt = svd(cov),  d = sign(det U det Vt),  R = U diag(1, 1, d) Vt,
    s = sum(S diag(1, 1, d)) / max(var_s, 1e-30)   (1 without scale),
    t = mu_d - s R mu_s.

No Pallas kernel stands behind it; the JAX package leaves it to
``jnp.linalg.svd`` inside its ``while_loop``.  In the port,
``torch.linalg.svd`` of a CUDA tensor waits for the host, so it cannot be
captured in the CUDA graph of an ICP iteration, and a one-thread f64 Jacobi
SVD (``csrc/umeyama3.cu``, built at first use by ``ops/_cuda_build.py``)
takes its place on the card.  Why the two agree up to rounding whatever
signs and order an SVD picks is written at the top of that source.

``icp_step`` is one ICP iteration after its k-NN, the body and stop test of
JAX's loop (``pyfocusr_tpu/ops/icp.py:110-129``) on state that lives on the
device: the matched rows' f64 moments, the close, the moved source, the
masked mean motion and the (count, done) pair.  On the card it is one
launch of ``icp_step_kernel`` (the close shared with ``umeyama3_kernel``),
so an ICP iteration is two launches, the k-NN and this.

``umeyama_close`` and ``icp_step`` dispatch on where their tensors lie: CPU
tensors take the plain versions, CUDA tensors launch the kernels or raise.
The plain versions run on CUDA tensors only where a test or
``chip_smoke.py`` holds a kernel to them.  Each launch of either kernel
adds one to ``LAUNCHES``.

The plain close deliberately departs from the JAX package's, which takes
the SVD in float32: it runs ``torch.linalg.svd`` and ``det`` in float64 and
rounds once, as the kernel does, so that a CPU run and a CUDA run give the
same bits but at a rounding boundary.  Against an f32 SVD the result moves
in its last bits (R within ~6e-7), and those bits are not harmless
downstream: the moved source (~1e-5 mm apart) turns a pair of its
near-degenerate eigenvectors inside their plane, and the nearest
neighbours in spectral coordinates, the initial correspondences, follow.
``tools/icp_close_bits.py`` measures each stage on several mesh pairs.  The
step keeps its moments, its moved rows and its motion in float64 for the
same reason, rounding each once.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda_build import CudaLibrary, require_sm90

__all__ = [
    "LAUNCHES",
    "MAX_CTAS",
    "ONE_CTA_MAX_ROWS",
    "THREADS",
    "icp_step",
    "icp_step_cuda",
    "icp_step_plain",
    "load_library",
    "plan",
    "umeyama_close",
    "umeyama_close_cuda",
    "umeyama_close_plain",
]

# Launch count of the CUDA kernel: the wrapper adds one per launch and does
# nothing else with it; a CUDA graph that holds the launch adds it at each
# replay (utils/device_loop.py).  Callers reset it to 0 to count a run's.
LAUNCHES = 0

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_LIBRARY = CudaLibrary("umeyama3.cu", "umeyama3", "Umeyama close", {
    "pyfocusr_umeyama3_f32": [
        _VP, _VP, _VP, _VP, _INT,  # cov, var_s, mu_s, mu_d, with_scale
        _VP, _INT, _VP,  # out, device, stream
    ],
    "pyfocusr_icp_step_f32": [
        _VP, _VP, _VP, _VP, _VP,  # target, idx, src, mask, wn
        _VP, _VP, _VP,  # mu_s, var_s, threshold
        _INT, _INT, _INT,  # n, max_iterations, with_scale
        _VP, _VP, _VP, _VP, _VP, _VP,  # s, R, t, moved, delta, ctrl
        _INT, _INT, _VP,  # ctas, device, stream
    ],
})
# The step kernel's CTA and its largest cluster (kThreads, kMaxCtas in
# csrc/umeyama3.cu; a CPU test holds the two equal).
THREADS = 512
MAX_CTAS = 16
# Source rows a cluster of one CTA takes, one a thread; above, the rows are
# split over more CTAs (``plan``), each thread holding up to kRows rows in
# registers (csrc/umeyama3.cu).  The rows' f64 arithmetic, ~2 SM clocks a
# row, is throughput-bound on one SM, and more CTAs cost less than it from
# about a thousand rows.  On one H100 80GB HBM3 at 700 W
# (tools/chip_phases.py icp --sweep), ms on 1 / 2 / 4 / 16 CTAs: 256 rows
# 0.00761 / 0.00766 / 0.00769 / 0.00807; 512 rows 0.00784 / 0.00794 /
# 0.00807 / 0.00829; 1024 rows 0.00887 / 0.00827 / 0.00825 / 0.00870;
# 2000 rows 0.01033 / 0.00897 / 0.00830 / 0.00862; 10242 rows 0.02329 /
# 0.01571 / 0.01214 / 0.00946.
ONE_CTA_MAX_ROWS = 512
# Filled by load_library(): seconds spent in nvcc (0.0 on a cache hit) and
# the compiler's register/shared-memory report.
BUILD_SECONDS = None
BUILD_LOG = ""


def load_library():
    """Build ``csrc/umeyama3.cu`` if its hashed library is missing, then
    load it."""
    global BUILD_SECONDS, BUILD_LOG
    lib = _LIBRARY.load()
    BUILD_SECONDS, BUILD_LOG = _LIBRARY.build_seconds, _LIBRARY.build_log
    return lib


def plan(n: int) -> dict:
    """The step kernel's grid for n source rows: one CTA of ``THREADS``
    threads up to ``ONE_CTA_MAX_ROWS`` rows, else one cluster of the fewest
    CTAs (a power of two, at most ``MAX_CTAS``) that keeps each CTA at or
    under that many."""
    ctas = 1
    while ctas < MAX_CTAS and n > ctas * ONE_CTA_MAX_ROWS:
        ctas *= 2
    return {"ctas": ctas, "threads": THREADS}


def _close_f64(cov, var_s, mu_s, mu_d, with_scale: bool):
    """The close of float64 moments by ``torch.linalg.svd`` and ``det``, in
    float64."""
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.ones(3, dtype=cov.dtype, device=cov.device)
    diag[2] = d
    R = U @ torch.diag(diag) @ Vt
    if with_scale:
        s = (S * diag).sum() / torch.clamp(var_s, min=1e-30)
    else:
        s = torch.ones((), dtype=cov.dtype, device=cov.device)
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def umeyama_close_plain(cov, var_s, mu_s, mu_d, with_scale: bool):
    """(s, R, t) from cov [3, 3], var_s (0-d), mu_s, mu_d [3] by
    ``torch.linalg.svd`` and ``det``, as ``pyfocusr_tpu.ops.icp.umeyama``
    closes, in float64 and rounded once to the inputs' type, as the kernel
    rounds its f64 result.  An f32 SVD would differ from the kernel in the
    last bits, and ICP carries such bits into the warm start of the
    eigensolver, whose result (and every later stage) moves with them."""
    dt = cov.dtype
    s, R, t = _close_f64(*(x.double() for x in (cov, var_s, mu_s, mu_d)), with_scale)
    return s.to(dt), R.to(dt), t.to(dt)


def umeyama_close_cuda(cov, var_s, mu_s, mu_d, with_scale: bool, out=None):
    """Launch the kernel on the current stream: one thread, nothing read back.
    ``out``: an f32 [13] device tensor to write (s, R row-major, t) into,
    else allocated.  Returns views (s 0-d, R [3, 3], t [3]) of it."""
    global LAUNCHES
    args = {"cov": (cov, (3, 3)), "var_s": (var_s, ()), "mu_s": (mu_s, (3,)),
            "mu_d": (mu_d, (3,))}
    dev = cov.device
    if dev.type != "cuda":
        raise ValueError(f"umeyama_close_cuda needs CUDA tensors, got {dev}")
    for name, (t, shape) in args.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"umeyama_close_cuda needs {name} as a contiguous f32 {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if out is None:
        out = torch.empty((13,), dtype=torch.float32, device=dev)
    elif (tuple(out.shape) != (13,) or out.dtype != torch.float32 or out.device != dev
          or not out.is_contiguous()):
        raise ValueError(f"umeyama_close_cuda out= needs a contiguous f32 [13] on {dev}")
    require_sm90(dev, "umeyama_close_cuda")
    lib = load_library()
    err = lib.pyfocusr_umeyama3_f32(
        cov.data_ptr(), var_s.data_ptr(), mu_s.data_ptr(), mu_d.data_ptr(),
        int(bool(with_scale)), out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"Umeyama close CUDA kernel launch failed: error {err}")
    LAUNCHES += 1
    return out[0], out[1:10].view(3, 3), out[10:13]


def umeyama_close(cov, var_s, mu_s, mu_d, with_scale: bool):
    """(s, R, t): the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    if cov.device.type == "cpu":
        return umeyama_close_plain(cov, var_s, mu_s, mu_d, with_scale)
    return umeyama_close_cuda(cov, var_s, mu_s, mu_d, with_scale)


def icp_step_plain(target, idx, src, mask, wn, mu_s, var_s, state, ctrl, threshold,
                   max_iterations: int, with_scale: bool):
    """One ICP iteration after its k-NN, in place, the plain version of
    ``icp_step_kernel``.  ``idx`` [n, 1] (or [n]): the nearest row of
    ``target`` [M, 3] for each row of ``src`` [n, 3]; ``mask``, ``wn`` [n]:
    the source mask and its normalised weights; ``mu_s`` [3], ``var_s``
    (0-d): the weighted mean and variance of ``src``; ``state``: the tensors
    (s 0-d, R [3, 3], t [3], moved [n, 3], delta 0-d); ``ctrl``: int32 [2],
    the iteration count and the done flag; ``threshold`` (0-d): the stop
    threshold of the mean motion.

    Where the flag is set it returns and writes nothing.  Otherwise the
    moments of the matched rows in float64, the close of ``_close_f64``,
    the moved source s src R^T + t in float64 from the rounded s, R, t,
    and the mean motion sum_i wn_i |new_i - moved_i| over the rows the mask
    keeps in float64 (a dropped row adds 0 even where its step is inf or
    NaN), each rounded once to the state's type; then the count grows by
    one and the flag is set where the motion is not above the threshold
    (NaN included) or the count reached ``max_iterations``."""
    if bool(ctrl[1] != 0):
        return
    s, R, t, moved, delta = state
    dt = moved.dtype
    w = wn.double()[:, None]
    matched = target.index_select(0, idx.reshape(-1).long()).double()
    src64 = src.double()
    sc = src64 - mu_s.double()
    mu_d = (matched * w).sum(dim=0)
    cov = ((matched - mu_d) * w).T @ sc
    new_s, new_R, new_t = (x.to(dt) for x in _close_f64(
        cov, var_s.double(), mu_s.double(), mu_d, with_scale))
    new_moved = ((src64 @ new_R.double().T) * new_s.double() + new_t.double()).to(dt)
    step = torch.linalg.norm(new_moved.double() - moved.double(), dim=1)
    new_delta = (torch.where(mask > 0, step, torch.zeros_like(step)) * w[:, 0]).sum().to(dt)
    for old, new in zip(state, (new_s, new_R, new_t, new_moved, new_delta)):
        old.copy_(new)
    ctrl[0] += 1
    ctrl[1] = int(not bool(new_delta > threshold) or int(ctrl[0]) >= max_iterations)


def _check_f32(name, x, shape, dev, dtype=torch.float32):
    if (tuple(x.shape) != tuple(shape) or x.dtype != dtype or x.device != dev
            or not x.is_contiguous()):
        raise ValueError(
            f"icp_step_cuda needs {name} as a contiguous {dtype} {tuple(shape)} on "
            f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}")


def _check_step_args(target, idx, src, mask, wn, mu_s, var_s, state, ctrl, threshold, dev):
    """Raise ``ValueError`` unless the step's tensors are what the kernel
    takes: all on ``dev``, contiguous, f32 (``idx`` and ``ctrl`` int32), src
    [n >= 1, 3], target [M >= 1, 3], idx [n, 1] or [n], mask and wn [n],
    mu_s [3], var_s and threshold 0-d, the state (s 0-d, R [3, 3], t [3],
    moved [n, 3], delta 0-d) and ctrl [2]."""
    if src.dim() != 2 or src.shape[1] != 3 or src.shape[0] < 1:
        raise ValueError(f"icp_step_cuda needs src as [n >= 1, 3], got {tuple(src.shape)}")
    n = src.shape[0]
    if target.dim() != 2 or target.shape[1] != 3 or target.shape[0] < 1:
        raise ValueError(f"icp_step_cuda needs target as [M >= 1, 3], got "
                         f"{tuple(target.shape)}")
    s, R, t, moved, delta = state
    for name, x, shape in (
            ("target", target, target.shape), ("src", src, (n, 3)), ("mask", mask, (n,)),
            ("wn", wn, (n,)), ("mu_s", mu_s, (3,)), ("var_s", var_s, ()),
            ("threshold", threshold, ()), ("s", s, ()), ("R", R, (3, 3)), ("t", t, (3,)),
            ("moved", moved, (n, 3)), ("delta", delta, ())):
        _check_f32(name, x, shape, dev)
    _check_f32("idx", idx, (n, 1) if idx.dim() == 2 else (n,), dev, torch.int32)
    _check_f32("ctrl", ctrl, (2,), dev, torch.int32)


def icp_step_cuda(target, idx, src, mask, wn, mu_s, var_s, state, ctrl, threshold,
                  max_iterations: int, with_scale: bool):
    """Launch ``icp_step_kernel`` on the current stream, the arguments and
    the in-place contract of ``icp_step_plain``; every tensor f32 (``idx``
    and ``ctrl`` int32) and contiguous on one card.  One cluster of
    ``plan(n)["ctas"]`` CTAs; nothing allocated, nothing read back."""
    global LAUNCHES
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"icp_step_cuda needs CUDA tensors, got {dev}")
    _check_step_args(target, idx, src, mask, wn, mu_s, var_s, state, ctrl, threshold, dev)
    s, R, t, moved, delta = state
    n = src.shape[0]
    require_sm90(dev, "icp_step_cuda")
    lib = load_library()
    err = lib.pyfocusr_icp_step_f32(
        target.data_ptr(), idx.data_ptr(), src.data_ptr(), mask.data_ptr(), wn.data_ptr(),
        mu_s.data_ptr(), var_s.data_ptr(), threshold.data_ptr(), n, int(max_iterations),
        int(bool(with_scale)), s.data_ptr(), R.data_ptr(), t.data_ptr(), moved.data_ptr(),
        delta.data_ptr(), ctrl.data_ptr(), plan(n)["ctas"], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ICP step CUDA kernel launch failed: error {err}")
    LAUNCHES += 1


def icp_step(target, idx, src, mask, wn, mu_s, var_s, state, ctrl, threshold,
             max_iterations: int, with_scale: bool):
    """One ICP iteration after its k-NN, in place (``icp_step_plain``'s
    contract): the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    step = icp_step_plain if src.device.type == "cpu" else icp_step_cuda
    step(target, idx, src, mask, wn, mu_s, var_s, state, ctrl, threshold,
         max_iterations, with_scale)
