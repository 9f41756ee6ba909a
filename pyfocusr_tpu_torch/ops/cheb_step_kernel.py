"""The wide eigensolver's Chebyshev filter step over the ELL table: the
hand-written Hopper kernel, its plain PyTorch version and the chunk's
three-term recurrence over them.

No TPU kernel stands behind it: the JAX package computes the step as XLA
products inside the filter loop of ``chebyshev_eigpairs_wide``
(``pyfocusr_tpu/ops/eigen.py``), over the ELL table or, for a TPU's matrix
unit, dense 128 x 128 patch blocks (not ported).
Here a step is one launch of ``csrc/cheb_step.cu`` (built at first use by
``ops/_cuda_build.py``), which reads the current and the previous block once
and writes one.  What bounds it and what its design does about that is
written at the top of the source.  Every wide solve's chunks, on every
device, run through :func:`chebyshev_ell`, the one place where the CPU and
CUDA routes part.

A step, over the ELL table (``pipeline.ell_filter_factory``: ``w_hat`` =
alpha s_i w_ij s_j, ``a_diag`` = alpha (sd - c mask), alpha = 2 / e):

    y_i   = a_diag_i t_i - sum_k w_hat_{i,k} t_{nbr(i,k)}  (+ overflow edges)
    out_i = 0.5 y_i on a chunk's first step,  y_i - tprev_i after it.

``chebyshev_ell`` runs a chunk's steps, t_1 = 0.5 y(X), t_{k+1} = y(t_k) -
t_{k-1}, and returns t_deg; the caller's X is left as it was.  It allocates
two blocks a chunk and writes each step from the third on over the block two
steps back (the kernel reads an element of tprev in the thread that writes
that element of out), so a step allocates nothing and reads nothing back: a
chunk can be captured in a CUDA graph.  Overflow edges (hub vertices above
the ELL width) are added after each launch by one ``index_add_``, halved on
the first step.

CPU tensors take ``cheb_step_plain``; CUDA tensors launch the kernel or
raise.  Each launch adds one to ``LAUNCHES``; on CUDA each chunk adds its
steps to the open call record's counter ``cheb_steps_fused``
(``utils/spans.py``), known on the host, so the count reads nothing.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import spans
from ._cuda_build import CudaLibrary, require_sm90

__all__ = [
    "LAUNCHES",
    "chebyshev_ell",
    "cheb_step_cuda",
    "cheb_step_plain",
    "ell_product",
    "load_library",
    "plan",
]

# Launch count of the CUDA kernel: the wrapper adds one per launch and does
# nothing else with it; callers reset it to 0 to count a run's launches.
LAUNCHES = 0

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_LIBRARY = CudaLibrary("cheb_step.cu", "cheb_step", "Chebyshev filter step", {
    "pyfocusr_cheb_step_f32": [
        _VP, _VP, _VP,  # t, tprev, out
        _VP, _VP, _VP,  # nbr, w, a_diag
        _INT, _INT, _INT,  # n, d, b
        _INT, _INT, _INT,  # vec, lanes_log2, first
        _INT, _VP,  # device, stream
    ],
})
# The kernel's CTA (kThreads in csrc/cheb_step.cu).
THREADS = 256
# Filled by load_library(): seconds spent in nvcc (0.0 on a cache hit) and
# the compiler's register/shared-memory report.
BUILD_SECONDS = None
BUILD_LOG = ""


def load_library():
    """Build ``csrc/cheb_step.cu`` if its hashed library is missing, then
    load it."""
    global BUILD_SECONDS, BUILD_LOG
    lib = _LIBRARY.load()
    BUILD_SECONDS, BUILD_LOG = _LIBRARY.build_seconds, _LIBRARY.build_log
    return lib


def plan(n: int, b: int, aligned: bool = True) -> dict:
    """The kernel's launch shape for n rows of b columns: float4 vectors
    where b is a multiple of 4 and the blocks are 16-byte ``aligned``, else
    single floats; a row takes the fewest lanes, a power of two up to 32,
    that cover its vectors (a warp holds 32 / lanes rows; wider rows loop
    over their columns)."""
    vec = 4 if b % 4 == 0 and aligned else 1
    units = b // vec
    lanes_log2 = 0
    while lanes_log2 < 5 and (1 << lanes_log2) < units:
        lanes_log2 += 1
    rows_per_block = (THREADS // 32) * (32 >> lanes_log2)
    return {"vec": vec, "lanes_per_row": 1 << lanes_log2, "lanes_log2": lanes_log2,
            "rows_per_block": rows_per_block, "threads": THREADS,
            "blocks": -(-n // rows_per_block)}


def ell_product(t, neighbors, w_hat, a_diag, overflow=None, ov_coef=None):
    """y = a_diag t - W_hat t over the ELL table, the filter step of
    ``pipeline.ell_filter_factory``'s chunks: one gather-einsum, one elementwise op
    and, where ``ov_coef`` [E, 1] (= -alpha ov_sw) is given, the overflow
    edges ``overflow`` int [E, 2] by ``index_add_``.  Returns a new tensor."""
    y = a_diag[:, None] * t - torch.einsum("nd,ndc->nc", w_hat, t[neighbors.long()])
    if ov_coef is not None:
        y.index_add_(0, overflow[:, 0], ov_coef * t[overflow[:, 1]])
    return y


def cheb_step_plain(t, tprev, neighbors, w_hat, a_diag, first: bool, overflow=None,
                    ov_coef=None):
    """One step as the step-by-step recurrence computes it: ``0.5 y`` where
    ``first``, else ``y - tprev``, y = :func:`ell_product`.  Returns a new
    tensor."""
    y = ell_product(t, neighbors, w_hat, a_diag, overflow, ov_coef)
    return 0.5 * y if first else y - tprev


def _check(name, x, shape, dev, dtype=torch.float32):
    if (tuple(x.shape) != tuple(shape) or x.dtype != dtype or x.device != dev
            or not x.is_contiguous()):
        raise ValueError(
            f"cheb_step_cuda needs {name} as a contiguous {dtype} {tuple(shape)} on {dev}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}")


def _check_args(t, tprev, out, neighbors, w_hat, a_diag, first):
    """Raise ``ValueError`` unless the step's tensors are what the kernel
    takes: one CUDA device, contiguous, f32 (``neighbors`` int32), t and out
    [n, b], tprev [n, b] unless ``first``, neighbors and w_hat [n, d >= 1],
    a_diag [n]; out not t.  Returns the device."""
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"cheb_step_cuda needs CUDA tensors, got {dev}")
    if t.dim() != 2 or neighbors.dim() != 2 or neighbors.shape[1] < 1:
        raise ValueError(f"cheb_step_cuda needs t [n, b] and neighbors [n, d >= 1], got "
                         f"{tuple(t.shape)} and {tuple(neighbors.shape)}")
    n, d = neighbors.shape
    for name, x, shape in (("t", t, (n, t.shape[1])), ("out", out, t.shape),
                           ("w_hat", w_hat, (n, d)), ("a_diag", a_diag, (n,))):
        _check(name, x, shape, dev)
    if not first:
        _check("tprev", tprev, t.shape, dev)
    _check("neighbors", neighbors, (n, d), dev, torch.int32)
    if out.data_ptr() == t.data_ptr() and t.numel():
        raise ValueError("cheb_step_cuda cannot write out over t (out may be tprev)")
    return dev


def _launcher(blocks, neighbors, w_hat, a_diag, dev):
    """launch(t, tprev, out, first) for steps among ``blocks`` (each [n, b]),
    with the table's pointers, the plan and the current stream taken once."""
    n, b = blocks[0].shape
    d = neighbors.shape[1]
    require_sm90(dev, "cheb_step_cuda")
    fn = load_library().pyfocusr_cheb_step_f32
    shape = plan(n, b, all(x.data_ptr() % 16 == 0 for x in blocks))
    fixed = (neighbors.data_ptr(), w_hat.data_ptr(), a_diag.data_ptr(), n, d, b,
             shape["vec"], shape["lanes_log2"])
    device, stream = dev.index, torch.cuda.current_stream(dev).cuda_stream

    def launch(t, tprev, out, first):
        global LAUNCHES
        err = fn(t.data_ptr(), tprev.data_ptr(), out.data_ptr(), *fixed, int(first),
                 device, stream)
        if err != 0:
            raise RuntimeError(f"Chebyshev step CUDA kernel launch failed: error {err}")
        LAUNCHES += 1

    return launch


def cheb_step_cuda(t, tprev, out, neighbors, w_hat, a_diag, first: bool):
    """Launch one step on the current stream into ``out`` (which may be
    ``tprev``; ``tprev`` is not read where ``first``): every tensor f32
    (``neighbors`` int32) and contiguous on one card.  No overflow edges.
    Nothing allocated, nothing read back.  Returns out."""
    dev = _check_args(t, tprev, out, neighbors, w_hat, a_diag, first)
    _launcher((t, tprev, out), neighbors, w_hat, a_diag, dev)(t, tprev, out, first)
    return out


def chebyshev_ell(X, deg: int, neighbors, w_hat, a_diag, overflow=None, ov_coef=None):
    """t_deg (t_1 where ``deg`` < 1) of a chunk's recurrence from X [N, b]
    (module docstring): CPU tensors by ``cheb_step_plain``, CUDA tensors one
    kernel launch a step (``neighbors`` int32 there) plus, where ``ov_coef``
    is given, the overflow edges' ``index_add_``.  X is not written."""
    X = X.contiguous()
    steps = max(deg, 1)
    blocks = [torch.empty_like(X) for _ in range(min(steps, 2))]
    if X.device.type == "cpu":
        def step(t, tprev, out, first):
            out.copy_(cheb_step_plain(t, tprev, neighbors, w_hat, a_diag, first,
                                      overflow, ov_coef))
    else:
        dev = _check_args(X, X, blocks[0], neighbors, w_hat, a_diag, True)
        launch = _launcher([X] + blocks, neighbors, w_hat, a_diag, dev)
        if ov_coef is not None:
            src, dst = overflow[:, 0], overflow[:, 1]
            coefs = {True: 0.5 * ov_coef, False: ov_coef}

        def step(t, tprev, out, first):
            launch(t, tprev, out, first)
            if ov_coef is not None:
                out.index_add_(0, src, coefs[first] * t.index_select(0, dst))
        spans.count("cheb_steps_fused", steps)
    prev, cur = X, blocks[0]
    step(X, X, cur, True)
    for k in range(steps - 1):
        out = blocks[1] if k == 0 else prev
        step(cur, prev, out, False)
        prev, cur = cur, out
    return cur
