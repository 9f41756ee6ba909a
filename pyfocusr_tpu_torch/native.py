"""The host library: the C++ fast paths of the topology, the decimator's
MIS, ``lap_host`` and the ASCII ``.vtk`` parse.

Counterpart of ``pyfocusr_tpu/native.py``: ``_load`` (:135, the
declarations), ``lap_jv_native`` (:199), ``topology_native`` (:219) with
``topology_fill_native`` (:263) and ``mis_greedy_native`` (:293), and the
parse calls of ``io/vtk_io._read_ascii_native`` (JAX ``io/vtk_io.py:
159-201``), over the
port's own copies of the three sources,
``csrc/host/{lap_jv,fast_topology,fast_parse}.cpp`` (the C ABI of
``native/*.cpp`` unchanged).

They are compiled with ``g++`` into one shared library at first use, under
``build/pyfocusr_tpu_torch/`` (or ``$PYFOCUSR_TPU_TORCH_BUILD_DIR``), named
by a hash of the sources, the flags and ``g++ --version``
(``ops/_cuda_build.library_path`` / ``compile_once``: a temporary file
renamed into place, so processes that build at once are safe).  No
``-march=native``: a library built on one host may be loaded on another
with the same hash, and the code gains nothing from it (``lap_jv`` only
subtracts, the topology and the MIS are integer code, the parse is
``strtod``).  A missing compiler or a failed build raises
``RuntimeError``; nothing falls back to numpy because the library is
missing.  ``use_prebuilt`` serves a library installed from a compiled
artifact (``utils/aot.py``) under its recorded name, with no compiler.
The numpy paths stay as the plain versions the tests compare with:
``mesh.build_topology_plain``, ``multires._luby_mis_numpy`` /
``_unique_edges_numpy`` / ``decimate_plain``, ``ops.assignment.
lap_host_plain`` and ``io.vtk_io._read_ascii``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .ops._cuda_build import compile_once, library_path

__all__ = ["HOST_SOURCES", "CXX_FLAGS", "HostLibrary", "build_seconds", "get_lib", "lap_jv",
           "library_file", "topo_edges", "topo_fill", "mis_greedy", "parse_doubles",
           "parse_longs", "use_prebuilt"]

HOST_SOURCES = tuple(
    Path(__file__).resolve().parent / "csrc" / "host" / name
    for name in ("lap_jv.cpp", "fast_topology.cpp", "fast_parse.cpp"))
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_FUNCTIONS = {  # name: (restype, argtypes), as JAX's ``_load`` declares them
    "lap_jv": (ctypes.c_int, [ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                              ctypes.c_int64, _i64p]),
    "parse_doubles": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                                       _i64p]),
    "parse_longs": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64, _i64p,
                                     ctypes.c_int64, _i64p]),
    "topo_edges": (ctypes.c_int64, [_i64p, ctypes.c_int64, ctypes.c_int64, _i32p, _i32p,
                                    _i64p]),
    "topo_fill": (ctypes.c_int64, [_i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                   _i32p, ctypes.POINTER(ctypes.c_float), _i32p, _i32p,
                                   _i64p]),
    "mis_greedy": (ctypes.c_int64, [_i64p, _i64p, ctypes.c_int64, ctypes.c_int64, _i64p,
                                    ctypes.POINTER(ctypes.c_int8)]),
}


class HostLibrary:
    """The sources built with ``compiler`` into one hashed library.
    ``load()`` builds on the first call and returns the ``ctypes`` library;
    afterwards ``build_seconds`` holds the seconds in the compiler (0.0 on
    a cache hit)."""

    def __init__(self, sources=HOST_SOURCES, compiler: str = "g++"):
        self.sources = tuple(Path(s) for s in sources)
        self.compiler = compiler
        self.build_seconds = None
        self.loaded_path = None
        self._prebuilt = None
        self._lib = None
        self._lock = threading.Lock()

    def use_prebuilt(self, path) -> None:
        """Load ``path`` instead of the hashed build at the next ``load()``:
        a library installed from a compiled artifact (``utils/aot.py``),
        whose name was recorded where it was built, so neither the compiler
        nor its version line is needed here.  No effect once loaded."""
        with self._lock:
            self._prebuilt = Path(path)

    def _what(self) -> str:
        return "the host library from " + ", ".join(str(s) for s in self.sources)

    def _cxx(self) -> str:
        found = shutil.which(self.compiler)
        if found is None:
            raise RuntimeError(f"{self.compiler} not found: {self._what()} cannot be built")
        return found

    def path(self) -> Path:
        """The library's file: its name hashes the sources, the flags and
        the compiler's version line."""
        version = subprocess.run([self._cxx(), "--version"], capture_output=True,
                                 check=True).stdout
        inputs = b"".join(s.read_bytes() for s in self.sources) + version
        return library_path("host", inputs, CXX_FLAGS)

    def load(self):
        with self._lock:
            if self._lib is None:
                if self._prebuilt is not None:
                    out, self.build_seconds = self._prebuilt, 0.0
                else:
                    out = self.path()
                    command = [self._cxx(), *CXX_FLAGS, *map(str, self.sources)]
                    self.build_seconds, _ = compile_once(out, command, self._what())
                lib = ctypes.CDLL(str(out))
                for name, (restype, argtypes) in _FUNCTIONS.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                self._lib, self.loaded_path = lib, out
            return self._lib


_HOST = HostLibrary()


def get_lib():
    """The package's host library, built at first use."""
    return _HOST.load()


def build_seconds():
    """Seconds the first ``get_lib`` spent in the compiler (0.0: cached)."""
    return _HOST.build_seconds


def library_file() -> Path:
    """The file of the package's host library, built at first use."""
    get_lib()
    return _HOST.loaded_path


def use_prebuilt(path) -> None:
    """Serve the package's host library from ``path`` (see
    ``HostLibrary.use_prebuilt``)."""
    _HOST.use_prebuilt(path)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def lap_jv(cost: np.ndarray) -> np.ndarray:
    """The column of each row of the exact LAP of ``cost`` (C++ JV, f64,
    ``csrc/host/lap_jv.cpp``).  Needs 0 < n_rows <= n_cols and finite
    entries (``lap_host`` checks both)."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n_rows, n_cols = cost.shape
    out = np.empty(n_rows, dtype=np.int64)
    rc = get_lib().lap_jv(_ptr(cost, ctypes.c_double), n_rows, n_cols,
                          _ptr(out, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"lap_jv returned {rc} on a {n_rows} x {n_cols} cost "
                         "(needs 0 < rows <= columns, finite entries)")
    return out


def topo_edges(tris: np.ndarray, n_points: int):
    """Pass 1 of the topology: (sorted unique undirected edges int32 [E,
    2], each edge's first two faces int32 [E, 2] (-1: none), the largest
    vertex degree (1 without edges)), or None when an index lies outside
    [0, n_points)."""
    tris64 = np.ascontiguousarray(tris, dtype=np.int64)
    n_faces = tris64.shape[0]
    cap = max(3 * n_faces, 1)
    edges = np.empty((cap, 2), np.int32)
    edge_faces = np.empty((cap, 2), np.int32)
    true_max = np.zeros(1, np.int64)
    n_edges = get_lib().topo_edges(
        _ptr(tris64, ctypes.c_int64), n_faces, n_points, _ptr(edges, ctypes.c_int32),
        _ptr(edge_faces, ctypes.c_int32), _ptr(true_max, ctypes.c_int64))
    if n_edges < 0:
        return None
    # copy(): a leading slice would keep the whole 3F-row scratch alive.
    return edges[:n_edges].copy(), edge_faces[:n_edges].copy(), int(true_max[0])


def topo_fill(edges: np.ndarray, n_points: int, max_deg: int):
    """Pass 2: (ELL neighbors int32 [N, max_deg] padded with the row's own
    index, mask f32 [N, max_deg], overflow (src, dst) int32 [O, 2],
    component labels int32 [N] numbered by lowest vertex, component
    count) from pass 1's edges."""
    edges = np.ascontiguousarray(edges, dtype=np.int32)
    n_edges = edges.shape[0]
    neighbors = np.tile(np.arange(n_points, dtype=np.int32)[:, None], (1, max_deg))
    mask = np.zeros((n_points, max_deg), np.float32)
    overflow = np.empty((max(2 * n_edges, 1), 2), np.int32)
    labels = np.empty(n_points, np.int32)
    n_comp = np.zeros(1, np.int64)
    n_ov = get_lib().topo_fill(
        _ptr(edges, ctypes.c_int32), n_edges, n_points, max_deg,
        _ptr(neighbors, ctypes.c_int32), _ptr(mask, ctypes.c_float),
        _ptr(overflow, ctypes.c_int32), _ptr(labels, ctypes.c_int32),
        _ptr(n_comp, ctypes.c_int64))
    return neighbors, mask, overflow[:n_ov].copy(), labels, int(n_comp[0])


def mis_greedy(u: np.ndarray, v: np.ndarray, n_points: int,
               prio: np.ndarray) -> np.ndarray:
    """The lexicographically-first maximal independent set of the graph of
    edges (u, v), visiting vertices by ascending ``prio`` (a permutation of
    0..n_points-1): int8 state, 1 seed, -1 blocked.  Equal to
    ``multires._luby_mis_numpy`` on the same inputs."""
    if n_points == 0:
        return np.zeros(0, np.int8)
    u = np.ascontiguousarray(u, dtype=np.int64)
    v = np.ascontiguousarray(v, dtype=np.int64)
    prio = np.ascontiguousarray(prio, dtype=np.int64)
    order = np.full(n_points, -1, np.int64)
    order[prio] = np.arange(n_points, dtype=np.int64)
    if (order < 0).any():
        raise ValueError("prio must be a permutation of 0..n_points-1 "
                         "(ascending-priority vertex order)")
    state = np.empty(n_points, np.int8)
    rc = get_lib().mis_greedy(_ptr(u, ctypes.c_int64), _ptr(v, ctypes.c_int64), len(u),
                              n_points, _ptr(order, ctypes.c_int64),
                              _ptr(state, ctypes.c_int8))
    if rc != 0:
        raise ValueError("mis_greedy: an edge index lies outside [0, n_points)")
    return state


def _parse(fn, dtype, ctype, raw: bytes, base: int, pos: int, count: int):
    out = np.empty(count, dtype)
    consumed = ctypes.c_int64(0)
    got = fn(ctypes.c_char_p(base + pos), len(raw) - pos, _ptr(out, ctype), count,
             ctypes.byref(consumed))
    if got != count:
        raise ValueError(f"expected {count} values, got {got}")
    return out, pos + consumed.value


def parse_doubles(raw: bytes, base: int, pos: int, count: int):
    """``count`` whitespace-separated doubles of ``raw`` from byte ``pos``:
    (values f64, the byte after the last).  ``base`` is the address of
    ``raw``'s buffer (``ctypes.cast(ctypes.c_char_p(raw),
    ctypes.c_void_p).value``), so no slice of the file is copied; the
    caller keeps ``raw`` alive."""
    return _parse(get_lib().parse_doubles, np.float64, ctypes.c_double, raw, base, pos,
                  count)


def parse_longs(raw: bytes, base: int, pos: int, count: int):
    """As :func:`parse_doubles`, for int64 connectivity."""
    return _parse(get_lib().parse_longs, np.int64, ctypes.c_int64, raw, base, pos, count)
