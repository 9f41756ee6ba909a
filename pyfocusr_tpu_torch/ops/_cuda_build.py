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
``library_path`` and ``compile_once`` (the hashed name, the build into a
temporary file renamed into place) also serve the host library of
``native.py``.
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

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "CudaLibrary", "compile_once",
           "library_path", "require_sm90"]

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


def library_path(stem: str, inputs: bytes, flags) -> Path:
    """``BUILD_DIR/libpyfocusr_<stem>_<hash>.so``, the hash over ``inputs``
    (the sources and whatever else decides the build) and ``flags``."""
    digest = hashlib.sha256(inputs + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpyfocusr_{stem}_{digest}.so"


def compile_once(out: Path, command, what: str):
    """Run ``command`` (a compiler command line without its output) with
    ``-o`` a temporary file beside ``out`` and rename that to ``out``, unless
    ``out`` exists.  The rename is atomic, so processes that build the same
    library at once never load half a file.  Returns (seconds in the
    compiler, its output); a failed build raises ``RuntimeError``."""
    if out.exists():
        return 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*command, "-o", str(tmp)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(command[0]).name} failed ({proc.returncode}) building {what}:\n{log}")
    os.replace(tmp, out)
    return seconds, log


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

    def path(self) -> Path:
        """The library's file, named by a hash of the source, the headers
        under ``csrc/`` and the flags (no compiler is asked)."""
        headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
        return library_path(self.stem, self.source.read_bytes() + headers, NVCC_FLAGS)

    def _build_and_load(self):
        out = self.path()
        if not out.exists():
            command = [_nvcc(self.what), *NVCC_FLAGS, str(self.source)]
            self.build_seconds, self.build_log = compile_once(out, command,
                                                              str(self.source))
        else:
            self.build_seconds = 0.0
        lib = ctypes.CDLL(str(out))
        for name, argtypes in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib
