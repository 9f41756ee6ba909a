"""Build-and-load of the package's hand-written CUDA kernels.

No counterpart in ``pyfocusr_tpu`` (Pallas kernels are compiled by JAX).
Each source under ``csrc/`` has a plain C interface; it is compiled for
``sm_90a`` with ``nvcc`` into a shared library of its own at first use,
cached under ``build/pyfocusr_tpu_torch/`` (or
``$PYFOCUSR_TPU_TORCH_BUILD_DIR``) keyed on a hash of the source and the
flags (and of the headers under ``csrc/``, which a source may include), and
loaded with ``ctypes``.  One library per source keeps the builds
independent: several can compile at once (``nvcc`` runs in a subprocess, so
threads that each call one kernel module's ``load_library`` overlap).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "CudaLibrary", "require_sm90"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(
    os.environ.get(
        "PYFOCUSR_TPU_TORCH_BUILD_DIR",
        Path(__file__).resolve().parents[2] / "build" / "pyfocusr_tpu_torch",
    )
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def require_sm90(device, what: str):
    """Raise unless ``device`` is a compute-capability 9.0 card: the
    libraries hold sm_90a code only."""
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"{what} is built for sm_90a; device {device} has compute "
            f"capability {cap}"
        )


def _nvcc(what: str) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        f"nvcc not found (looked on PATH and in $CUDA_HOME/bin): the {what} "
        "CUDA kernel cannot be built"
    )


class CudaLibrary:
    """One ``csrc/<source>`` built into ``libpyfocusr_<stem>_<hash>.so``.

    ``functions`` maps each exported C function to its ``ctypes`` argument
    types (every function returns an ``int``: 0 or a CUDA error code).
    ``load()`` builds on the first call and returns the ``ctypes`` library;
    afterwards ``build_seconds`` holds the seconds spent in nvcc (0.0 on a
    cache hit) and ``build_log`` the compiler's register / shared-memory
    report.
    """

    def __init__(self, source: str, stem: str, what: str, functions: dict):
        self.source = CSRC_DIR / source
        self.stem = stem
        self.what = what
        self.functions = functions
        self.build_seconds = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self):
        headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"libpyfocusr_{self.stem}_{digest}.so"
        self.build_seconds = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(self.what), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {self.source}:\n"
                    f"{self.build_log}"
                )
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        lib = ctypes.CDLL(str(out))
        for name, argtypes in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib
