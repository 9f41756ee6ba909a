"""Device meshes, collectives and rank processes for the sharded paths.

Counterpart of the JAX package's ``jax.sharding.Mesh`` / ``shard_map``
plumbing (``pyfocusr_tpu/parallel/{bigmesh,cohort,groupwise}.py``).  JAX
runs one controller over many devices; PyTorch runs one process per rank.
So a ``device_mesh`` here is a ``torch.distributed.device_mesh.DeviceMesh``
(``init_device_mesh(device_type, shape, mesh_dim_names=...)``) whose
dimension names are JAX's axis names (``'verts'``, ``'cohort'``,
``'pairs'``), every rank calls the same public function with the same
global inputs, computes its shard on its own device (:func:`rank_device`)
and gathers the result, so every rank returns JAX's global arrays.

The collectives are those of the group's backend for the tensor's device:
NCCL across cards, gloo for CPU ranks.  Gloo has no all-gather for CUDA
tensors (ranks sharing one card), so there :func:`all_gather` is an
all-reduce of a zero-filled buffer into which each rank wrote its own rows
(gloo's CUDA all-reduce, which copies through the host: that backend is
the caller's choice).

:func:`spawn` starts ``n_ranks`` processes (the ``spawn`` start method),
joins them in one process group through a ``FileStore`` in a fresh
temporary directory (no fixed port), runs ``fn(*args)`` on each and returns
every rank's return value; a rank's exception is raised again in the
caller.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

__all__ = [
    "check_axis",
    "axis_size",
    "axis_rank",
    "is_first_rank",
    "rank_device",
    "all_gather",
    "psum",
    "gather_results",
    "spawn",
]


def check_axis(device_mesh, axis: str, what: str) -> None:
    """Raise JAX's ``ValueError`` unless ``device_mesh`` has an ``axis``
    dimension (``what``: the sharded function)."""
    names = tuple(device_mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"{what} shards over a '{axis}' mesh axis; got axes {names}")


def axis_size(device_mesh, axis: str) -> int:
    """Number of ranks along ``axis``."""
    return int(device_mesh.size(device_mesh.mesh_dim_names.index(axis)))


def axis_rank(device_mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(device_mesh.get_local_rank(axis))


def is_first_rank(device_mesh) -> bool:
    """Whether this rank is at coordinate 0 along every axis of the mesh
    (the rank that writes what is written once)."""
    return not any(device_mesh.get_coordinate())


def rank_device(device_mesh) -> torch.device:
    """The device this rank computes on: its current CUDA device (which
    :func:`spawn` sets to rank mod the visible cards) for a CUDA mesh, else
    the CPU."""
    if device_mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather(x: torch.Tensor, device_mesh, axis: str) -> torch.Tensor:
    """``x`` of every rank along ``axis`` concatenated on dim 0 in rank
    order: ``jax.lax.all_gather(x, axis, tiled=True)``."""
    group = device_mesh.get_group(axis)
    n = axis_size(device_mesh, axis)
    x = x.contiguous()
    out = torch.zeros((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        r = axis_rank(device_mesh, axis)
        out[r * x.shape[0]:(r + 1) * x.shape[0]] = x
        dist.all_reduce(out, group=group)
        return out
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out


def psum(x: torch.Tensor, device_mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axis``: ``jax.lax.psum``."""
    out = x.clone()
    dist.all_reduce(out, group=device_mesh.get_group(axis))
    return out


def gather_results(results: dict, device_mesh, axis: str) -> dict:
    """Each tensor of ``results`` gathered along ``axis`` on its leading
    (shard) axis, key by key in sorted order (the same on every rank)."""
    return {k: all_gather(results[k], device_mesh, axis) for k in sorted(results)}


class RemoteTraceback(Exception):
    """The traceback of a rank's exception, chained to it when
    :func:`spawn` raises it again in the caller."""


# Seconds a collective may wait for the other ranks before it fails.
COLLECTIVE_TIMEOUT_S = 900.0


def _rank_main(rank, n_ranks, backend, device_type, store_path, threads, fn, args,
               results):
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n_ranks), rank=rank,
            world_size=n_ranks, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        out = fn(*args)
        dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except Exception as exc:  # the rank's boundary: reported to the caller
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps(exc)
        except Exception:
            payload = pickle.dumps(RuntimeError(f"{type(exc).__name__}: {exc}"))
        results.put((rank, False, (payload, tb)))


def spawn(fn, n_ranks: int, backend: str = "nccl", device_type: str = "cuda",
          args: tuple = (), threads: int | None = None):
    """Run ``fn(*args)`` on ``n_ranks`` new processes joined in one process
    group of ``backend`` ('nccl' or 'gloo') and return their return values
    in rank order.

    The ranks run on the card unless the caller asks for the CPU
    (``backend="gloo", device_type="cpu"``): with ``device_type`` 'cuda'
    and no visible card it raises before starting any process.
    ``fn`` must be importable by name (a module-level function), its
    arguments and return value picklable.  ``device_type`` 'cuda' sets each
    rank's CUDA device to rank mod the visible cards (so several gloo ranks
    may share one card); build the CUDA kernels in the caller first, so the
    ranks do not race the first ``nvcc``.  ``threads`` sets each rank's
    torch intra-op threads.  A collective fails after
    ``COLLECTIVE_TIMEOUT_S``.  When a rank raises, the others are
    terminated and its exception is raised here, chained to its traceback;
    a rank that dies without a word raises ``RuntimeError``."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present: distributed.spawn runs its ranks on the "
            "card by default; pass backend='gloo', device_type='cpu' for CPU ranks")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="pyfocusr_ranks_")
    store_path = os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        rank, n_ranks, backend, device_type, store_path, threads, fn, args, results))
        for rank in range(n_ranks)]
    try:
        for p in procs:
            p.start()
        got = {}
        while len(got) < n_ranks:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # A message may still be in flight from a rank that just
                    # ended: read once more before declaring it dead.
                    try:
                        rank, ok, payload = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {n_ranks} exited with code "
                            f"{procs[dead[0]].exitcode} and no result") from None
                else:
                    continue
            if not ok:
                exc_bytes, tb = payload
                raise pickle.loads(exc_bytes) from RemoteTraceback(
                    f"rank {rank} of {n_ranks}:\n{tb}")
            got[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=60.0)
        return [got[r] for r in range(n_ranks)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
