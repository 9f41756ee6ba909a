"""The 3x3 close of Umeyama's method: the hand-written Hopper kernel and its
plain PyTorch version.

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

``umeyama_close`` dispatches on where ``cov`` lies: CPU tensors take
``umeyama_close_plain``, CUDA tensors launch the kernel or raise.  The plain
version runs on CUDA tensors only where a test or ``chip_smoke.py`` holds
the kernel to it.  Each launch adds one to ``LAUNCHES``.

The plain close deliberately departs from the JAX package's, which takes
the SVD in float32: it runs ``torch.linalg.svd`` and ``det`` in float64 and
rounds once, as the kernel does, so that a CPU run and a CUDA run give the
same bits but at a rounding boundary.  Against an f32 SVD the result moves
in its last bits (R within ~6e-7), and those bits are not harmless
downstream: the moved source (~1e-5 mm apart) turns a pair of its
near-degenerate eigenvectors inside their plane, and the nearest
neighbours in spectral coordinates, the initial correspondences, follow.
``tools/icp_close_bits.py`` measures each stage on several mesh pairs.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda_build import CudaLibrary, require_sm90

__all__ = [
    "LAUNCHES",
    "load_library",
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
})
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


def umeyama_close_plain(cov, var_s, mu_s, mu_d, with_scale: bool):
    """(s, R, t) from cov [3, 3], var_s (0-d), mu_s, mu_d [3] by
    ``torch.linalg.svd`` and ``det``, as ``pyfocusr_tpu.ops.icp.umeyama``
    closes, in float64 and rounded once to the inputs' type, as the kernel
    rounds its f64 result.  An f32 SVD would differ from the kernel in the
    last bits, and ICP carries such bits into the warm start of the
    eigensolver, whose result (and every later stage) moves with them."""
    dt = cov.dtype
    cov, var_s, mu_s, mu_d = (x.double() for x in (cov, var_s, mu_s, mu_d))
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


def umeyama_close(cov, var_s, mu_s, mu_d, with_scale: bool, out=None):
    """(s, R, t): the plain version for CPU tensors, the kernel for CUDA
    tensors (writing into ``out`` where given)."""
    if cov.device.type == "cpu":
        return umeyama_close_plain(cov, var_s, mu_s, mu_d, with_scale)
    return umeyama_close_cuda(cov, var_s, mu_s, mu_d, with_scale, out=out)
