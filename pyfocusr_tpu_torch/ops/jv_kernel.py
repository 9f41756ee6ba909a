"""Jonker-Volgenant Dijkstra augmentation: the hand-written Hopper kernel
and its plain PyTorch version.

Counterpart of ``pyfocusr_tpu/ops/pallas_kernels.py:422-621``
(``_jv_row_kernel`` / ``_jv_row_call`` / ``jv_device_pallas``), with the
semantics of ``pyfocusr_tpu/ops/assignment.py:314-403`` (phase 2 of
``_jv_device``).  The CUDA C++ source is ``csrc/jv.cu``, built at first use
by ``ops/_cuda_build.py``.

Given a square f32 cost, feasible duals ``(u0, v0)`` and the partial
matching ``(row4col0, col4row0)`` of the tight-edge bulk phase
(``assignment._bulk_match``), every row still free is augmented in
ascending order: a Dijkstra search over reduced costs finds the shortest
augmenting path, the duals take scipy ``_lsap``'s deferred updates, and the
matching is flipped along the path.  ``max_total_steps`` is a global budget
of Dijkstra steps; when it runs out the remaining rows stay at -1 (for
``assignment._greedy_complete``).  Whenever the budget is not hit the
result is the optimum.

Both versions return ``(col4row int32 [n], steps_used int32 0-d, u f32 [n],
v f32 [n])``.  The final duals are a certificate the JAX version drops:
``cost[i, j] - u[i] - v[j] >= 0`` everywhere and ``sum(u) + sum(v)`` equals
the assignment's cost, up to f32 rounding.

The two versions do the same f32 operations in the same order (there are no
products to contract), so they agree exactly: the same ``col4row``, the
same step count, the same duals.  What bounds the kernel and what its
design does about it is written at the top of ``csrc/jv.cu``.  In short,
the search is a chain of dependent steps (load a cost row at an address the
previous step chose, relax, take the argmin), so one launch of one
thread-block cluster of ``CLUSTER_SIZE`` CTAs runs all of it: each CTA owns
a contiguous range of columns and keeps their search state (17 bytes a
column) in its shared memory, loads only its slice of each row, and the
argmin is one exchange of candidates per step, written into every CTA's
shared memory and counted on its mbarrier (no cluster barrier per step).
Every CTA merges the same candidates, so all take the same decisions.
``MAX_N`` is the most columns the cluster's shared memory holds; a larger
problem raises.

``jv_device`` dispatches on where the tensors lie: CPU tensors take
``jv_device_plain``; CUDA tensors launch the kernel or raise.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda_build import CudaLibrary, require_sm90

__all__ = [
    "CLUSTER_SIZE",
    "LAUNCHES",
    "MAX_N",
    "THREADS_PER_CTA",
    "jv_device",
    "jv_device_cuda",
    "jv_device_plain",
    "library_config",
    "load_library",
    "smem_per_cta_bytes",
]

# Launch count of the CUDA kernel: the wrapper adds one per launch and does
# nothing else with it; callers reset it to 0 to count a run's launches.
LAUNCHES = 0

# The kernel's configuration, the constants kClusterSize, kThreads and kMaxN
# of csrc/jv.cu (``library_config`` reads them back from the built
# library): one cluster of 16 CTAs of 256 threads, each CTA holding at most
# 12800 columns' search state (17 bytes a column) in its shared memory.
CLUSTER_SIZE = 16
THREADS_PER_CTA = 256
MAX_N = CLUSTER_SIZE * 12800

_BIG = 1e30

_LIBRARY = CudaLibrary("jv.cu", "jv", "Jonker-Volgenant", {
    "pyfocusr_jv_f32": [
        ctypes.c_void_p, ctypes.c_int,  # cost, n
        ctypes.c_void_p, ctypes.c_int,  # free_rows, budget
        ctypes.c_void_p, ctypes.c_void_p,  # u, v
        ctypes.c_void_p, ctypes.c_void_p,  # row4col, col4row
        ctypes.c_void_p,  # steps_used
        ctypes.c_int, ctypes.c_void_p,  # device, stream
    ],
    "pyfocusr_jv_config": [ctypes.POINTER(ctypes.c_int)] * 4,
})
# Filled by load_library(): seconds spent in nvcc (0.0 on a cache hit) and
# the compiler's register/shared-memory report.
BUILD_SECONDS = None
BUILD_LOG = ""


def load_library():
    """Build ``csrc/jv.cu`` if its hashed library is missing, then load it."""
    global BUILD_SECONDS, BUILD_LOG
    lib = _LIBRARY.load()
    BUILD_SECONDS, BUILD_LOG = _LIBRARY.build_seconds, _LIBRARY.build_log
    return lib


def library_config() -> dict:
    """The configuration the built library reports: cluster size, threads
    per CTA, largest n, and the static shared memory of one CTA (the
    exchange slots; the dynamic part is 17 bytes a column)."""
    vals = [ctypes.c_int() for _ in range(4)]
    err = load_library().pyfocusr_jv_config(*[ctypes.byref(x) for x in vals])
    if err != 0:
        raise RuntimeError(f"pyfocusr_jv_config failed: error {err}")
    names = ("cluster_size", "threads_per_cta", "max_n", "static_smem_bytes")
    return dict(zip(names, (x.value for x in vals)))


def smem_per_cta_bytes(n: int, static_bytes: int) -> int:
    """Shared memory one CTA takes for an n-column problem: v, spc, path and
    row4col (16 bytes a column) and the byte mask rounded up to a word, for
    its ceil(n / CLUSTER_SIZE) columns, plus the static exchange slots."""
    width = -(-n // CLUSTER_SIZE)
    return 16 * width + 4 * (-(-width // 4)) + static_bytes


def _check_inputs(cost, u0, v0, row4col0, col4row0, max_total_steps):
    if cost.dim() != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(f"jv_device requires a square cost, got {tuple(cost.shape)}")
    n = cost.shape[0]
    if n < 1:
        raise ValueError("jv_device requires n >= 1")
    for name, t, dtype in (("u0", u0, torch.float32), ("v0", v0, torch.float32),
                           ("row4col0", row4col0, torch.int32),
                           ("col4row0", col4row0, torch.int32)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != cost.device:
            raise ValueError(f"{name} lies on {t.device}, the cost on {cost.device}")
    if cost.dtype != torch.float32:
        raise TypeError(f"jv_device needs a float32 cost, got {cost.dtype}")
    if not 0 <= int(max_total_steps) < 2**31:
        raise ValueError(f"max_total_steps must be in [0, 2**31), got {max_total_steps}")


def jv_device_cuda(cost, u0, v0, row4col0, col4row0, max_total_steps: int):
    """Launch the CUDA kernel (one cluster of ``CLUSTER_SIZE`` CTAs, one
    launch for all free rows) on the current stream.  Raises on anything the
    kernel does not take; never falls back to the plain version."""
    global LAUNCHES
    _check_inputs(cost, u0, v0, row4col0, col4row0, max_total_steps)
    if cost.device.type != "cuda":
        raise ValueError(f"jv_device_cuda needs CUDA tensors, got {cost.device}")
    if not cost.is_contiguous():
        raise ValueError("jv_device_cuda needs a contiguous cost")
    n = cost.shape[0]
    if n > MAX_N:
        raise ValueError(
            f"jv_device_cuda keeps 17 bytes of search state a column in the "
            f"shared memory of a {CLUSTER_SIZE}-CTA cluster: n <= {MAX_N}, got {n}"
        )
    require_sm90(cost.device, "jv_device_cuda")
    lib = load_library()
    dev = cost.device
    # The rows to augment, ascending, then n: the kernel stops at the first n.
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    free_rows = torch.sort(
        torch.where(col4row0 < 0, rows, torch.full_like(rows, n))
    ).values.contiguous()
    u = u0.clone().contiguous()
    v = v0.clone().contiguous()
    row4col = row4col0.clone().contiguous()
    col4row = col4row0.clone().contiguous()
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pyfocusr_jv_f32(
        cost.data_ptr(), n, free_rows.data_ptr(), int(max_total_steps),
        u.data_ptr(), v.data_ptr(), row4col.data_ptr(), col4row.data_ptr(),
        steps.data_ptr(), dev.index, stream,
    )
    if err == -2:
        raise RuntimeError(
            f"the card cannot schedule one cluster of {CLUSTER_SIZE} CTAs of "
            f"{THREADS_PER_CTA} threads (cudaOccupancyMaxActiveClusters is 0)")
    if err != 0:
        raise RuntimeError(f"jv CUDA kernel launch failed: error {err}")
    LAUNCHES += 1
    return col4row, steps, u, v


def jv_device_plain(cost, u0, v0, row4col0, col4row0, max_total_steps: int):
    """Plain PyTorch version of the kernel, same contract, identical
    results: a host loop over the free rows and over the Dijkstra steps of
    each, every step a handful of [n]-vector operations in the kernel's f32
    operation order.  Meant for CPU tensors (each step reads two scalars)."""
    _check_inputs(cost, u0, v0, row4col0, col4row0, max_total_steps)
    n = cost.shape[0]
    dev = cost.device
    u, v = u0.clone(), v0.clone()
    row4col, col4row = row4col0.clone(), col4row0.clone()
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    steps_left = int(max_total_steps)
    for i_start in torch.nonzero(col4row0 < 0)[:, 0].tolist():
        if steps_left <= 0:
            break
        spc = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
        path = torch.full((n,), -1, dtype=torch.int32, device=dev)
        scanned = torch.zeros((n,), dtype=torch.bool, device=dev)
        rvis = torch.zeros((n,), dtype=torch.bool, device=dev)
        i_cur, sink, steps = i_start, -1, 0
        min_val = torch.zeros((), dtype=torch.float32, device=dev)
        while sink < 0 and steps < steps_left:
            rvis[i_cur] = True
            r = ((min_val + cost[i_cur]) - u[i_cur]) - v
            better = ~scanned & (r < spc)
            spc = torch.where(better, r, spc)
            path[better] = i_cur
            masked = torch.where(scanned, big, spc)
            j1 = int(torch.argmin(masked))  # first minimum: lowest column
            min_val = masked[j1]
            scanned[j1] = True
            owner = int(row4col[j1])
            if owner < 0:
                sink = j1
            else:
                i_cur = owner
            steps += 1
        steps_left -= steps
        if sink < 0:
            break  # budget exhausted: this row and the rest stay free
        # Deferred dual updates (scipy _lsap), with col4row before the flip.
        spc_of_row = spc[col4row.clamp(0, n - 1).long()]
        rvis[i_start] = False
        u = torch.where(rvis, u + min_val - spc_of_row, u)
        u[i_start] += min_val
        v = torch.where(scanned, v - (min_val - spc), v)
        j = sink
        while j >= 0:
            i = int(path[j])
            row4col[j] = i
            j_next = int(col4row[i])
            col4row[i] = j
            j = j_next
    steps_used = torch.tensor(int(max_total_steps) - steps_left,
                              dtype=torch.int32, device=dev)
    return col4row, steps_used, u, v


def jv_device(cost, u0, v0, row4col0, col4row0, max_total_steps: int):
    """Augment every free row of the bulk matching: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if cost.device.type == "cpu":
        return jv_device_plain(cost, u0, v0, row4col0, col4row0, max_total_steps)
    return jv_device_cuda(cost, u0, v0, row4col0, col4row0, max_total_steps)
