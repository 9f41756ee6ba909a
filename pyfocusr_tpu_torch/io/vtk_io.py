"""Dependency-free reader/writer for legacy VTK PolyData files.

A copy of ``pyfocusr_tpu/io/vtk_io.py`` (the port imports nothing of the
JAX package).  ASCII files take its native fast path (``_ByteKeywords`` /
``_read_ascii_native``, :133-299): the numeric payloads go through the
host library's parser (``native.py``, ``csrc/host/fast_parse.cpp``).  A
file whose structure that path does not handle is read by the
pure-python ``_read_ascii``, as in the JAX package; ``_read_ascii`` is
also the plain version the tests hold the fast path to.

The reference (pyfocusr) delegates mesh I/O to the VTK C++ library
(``vtk_functions.py:5-9`` — ``vtkPolyDataReader``).  Here the I/O boundary is a
small pure-numpy parser for the legacy ``.vtk`` format (both ASCII and
big-endian binary), which is all the bundled data uses
(``data/source_mesh.vtk:1-5`` is ``# vtk DataFile Version 4.2`` / ASCII /
POLYDATA with POINTS, POLYGONS and a POINT_DATA SCALARS array).

Only the features FOCUSR needs are implemented: POINTS, POLYGONS (triangles),
POINT_DATA with SCALARS / FIELD arrays.  Everything else is skipped with a
warning rather than an error so files written by other tools still load.
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np

from .. import native

__all__ = ["read_vtk_polydata", "write_vtk_polydata"]

_VTK_DTYPES = {
    "bit": np.uint8,
    "unsigned_char": np.uint8,
    "char": np.int8,
    "unsigned_short": np.uint16,
    "short": np.int16,
    "unsigned_int": np.uint32,
    "int": np.int32,
    "unsigned_long": np.uint64,
    "long": np.int64,
    "vtktypeint64": np.int64,
    "vtktypeuint64": np.uint64,
    "float": np.float32,
    "double": np.float64,
}


def _is_binary(header_bytes: bytes) -> bool:
    # The 3rd non-empty line of a legacy VTK file is "ASCII" or "BINARY".
    lines = [ln.strip() for ln in header_bytes.split(b"\n")]
    lines = [ln for ln in lines if ln]
    for ln in lines[:4]:
        if ln.upper() == b"BINARY":
            return True
        if ln.upper() == b"ASCII":
            return False
    raise ValueError("Not a legacy VTK file: missing ASCII/BINARY marker")


class _AsciiTokens:
    """Whole-file tokenizer: legacy ASCII VTK is whitespace-separated."""

    def __init__(self, text: str):
        self.tokens = text.split()
        self.pos = 0

    def next(self) -> str:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def peek(self):
        if self.pos >= len(self.tokens):
            return None
        return self.tokens[self.pos]

    def take_array(self, count: int, dtype) -> np.ndarray:
        out = np.array(self.tokens[self.pos : self.pos + count], dtype=dtype)
        if out.shape[0] != count:
            raise ValueError(
                f"VTK parse error: expected {count} values, got {out.shape[0]}"
            )
        self.pos += count
        return out

    def done(self) -> bool:
        return self.pos >= len(self.tokens)


def _triangulate_polys(data: np.ndarray) -> np.ndarray:
    """Convert a legacy POLYGONS connectivity stream ``[n, i0..in-1, ...]``
    into an (F, 3) int32 triangle array (fan-triangulating any n>3 polys)."""
    tris = []
    pos = 0
    n_total = data.shape[0]
    # Fast path: all triangles (the common case for FOCUSR meshes).
    if n_total % 4 == 0:
        maybe = data.reshape(-1, 4)
        if np.all(maybe[:, 0] == 3):
            return np.ascontiguousarray(maybe[:, 1:].astype(np.int32))
    while pos < n_total:
        n = int(data[pos])
        if n <= 0:
            # A corrupt count would make pos += 1 + n stall (n == -1) or
            # walk backwards — parse error, not an infinite loop.
            raise ValueError(
                f"invalid polygon vertex count {n} at stream offset {pos}"
            )
        verts = data[pos + 1 : pos + 1 + n]
        for t in range(1, n - 1):
            tris.append((verts[0], verts[t], verts[t + 1]))
        pos += 1 + n
    # reshape keeps the (F, 3) contract even when nothing survived (all
    # polys degenerate): np.asarray([]) alone would be shape (0,).
    return np.asarray(tris, dtype=np.int32).reshape(-1, 3)


def read_vtk_polydata(path: str):
    """Read a legacy VTK PolyData file.

    Returns ``(points f64[N,3], triangles i32[F,3], point_data: dict[str, ndarray])``.
    Replaces ``vtk_functions.read_vtk_mesh`` (reference ``vtk_functions.py:5-9``).

    ASCII files parse through the host library's tokenizer; a structure
    that path does not handle falls to the pure-python reader.
    """
    with open(path, "rb") as f:
        raw = f.read()
    if _is_binary(raw[:512]):
        return _read_binary(raw)
    native.get_lib()  # a failed build raises here, not inside the try below
    try:
        return _read_ascii_native(raw)
    except Exception:  # any structural surprise -> the tolerant python reader
        return _read_ascii(raw.decode("ascii", errors="replace"))


class _ByteKeywords:
    """Reads whitespace-delimited KEYWORD tokens from bytes; numeric payloads
    are consumed by the native parser between keywords."""

    def __init__(self, raw: bytes, pos: int):
        self.raw = raw
        self.pos = pos

    def skip_ws(self):
        raw, pos = self.raw, self.pos
        while pos < len(raw) and raw[pos] in b" \t\r\n":
            pos += 1
        self.pos = pos

    def next(self):
        self.skip_ws()
        raw, start = self.raw, self.pos
        pos = start
        while pos < len(raw) and raw[pos] not in b" \t\r\n":
            pos += 1
        self.pos = pos
        if start == pos:
            return None
        return raw[start:pos].decode("ascii", errors="replace")


def _read_ascii_native(raw: bytes):
    """ASCII reader: keyword scan in python, numeric payloads through the
    host library's parser (``native.parse_doubles`` / ``parse_longs``).
    Raises on any structure it does not handle; :func:`read_vtk_polydata`
    then reads the file with :func:`_read_ascii`."""
    # The address of raw's buffer and an offset, not raw[pos:]: a slice
    # would copy the rest of the file for every payload section.  ``raw``
    # outlives every call in this function.
    base = ctypes.cast(ctypes.c_char_p(raw), ctypes.c_void_p).value

    def parse_f64(pos: int, count: int):
        return native.parse_doubles(raw, base, pos, count)

    def parse_i64(pos: int, count: int):
        return native.parse_longs(raw, base, pos, count)

    # Skip the two header lines.
    pos = raw.index(b"\n") + 1
    pos = raw.index(b"\n", pos) + 1
    toks = _ByteKeywords(raw, pos)

    points = None
    triangles = np.zeros((0, 3), dtype=np.int32)
    point_data: dict[str, np.ndarray] = {}
    n_points = 0
    n_attr = 0  # tuple count of the current POINT_DATA/CELL_DATA section
    in_point_data = False

    while True:
        key = toks.next()
        if key is None:
            break
        k = key.upper()
        if k in ("ASCII", "BINARY"):
            continue
        elif k == "DATASET":
            if toks.next().upper() != "POLYDATA":
                raise ValueError("not POLYDATA")
        elif k == "POINTS":
            n_points = int(toks.next())
            toks.next()  # dtype name
            flat, toks.pos = parse_f64(toks.pos, n_points * 3)
            points = flat.reshape(n_points, 3)
        elif k == "POLYGONS":
            n_polys = int(toks.next())
            n_vals = int(toks.next())
            save = toks.pos
            peek = toks.next()
            if peek and peek.upper() == "OFFSETS":
                raise ValueError("5.1 layout -> python path")
            toks.pos = save
            data, toks.pos = parse_i64(toks.pos, n_vals)
            triangles = _triangulate_polys(data)
        elif k == "POINT_DATA":
            if int(toks.next()) != n_points:
                raise ValueError("POINT_DATA mismatch")
            in_point_data = True
            n_attr = n_points
        elif k == "CELL_DATA":
            # Size following attribute payloads by the CELL count (parsed
            # to stay stream-aligned, then discarded).
            n_attr = int(toks.next())
            in_point_data = False
        elif k == "SCALARS":
            name = toks.next()
            toks.next()  # dtype
            save = toks.pos
            maybe = toks.next()
            n_comp = 1
            if maybe and maybe.upper() != "LOOKUP_TABLE":
                # Optional numComp is spec-restricted to 1..4 — anything
                # else is the first data value (see the pure-python reader
                # for the ambiguity discussion).
                try:
                    maybe_comp = int(maybe)
                except ValueError:
                    maybe_comp = None
                if maybe_comp is not None and 1 <= maybe_comp <= 4:
                    n_comp = maybe_comp
                    save = toks.pos
                    maybe = toks.next()
            if maybe and maybe.upper() == "LOOKUP_TABLE":
                toks.next()  # table name
            else:
                toks.pos = save
            cnt = n_attr or n_points  # tolerate SCALARS before a section
            vals, toks.pos = parse_f64(toks.pos, cnt * n_comp)
            if in_point_data or not n_attr:
                point_data[name] = (
                    vals if n_comp == 1 else vals.reshape(cnt, n_comp)
                )
        elif k == "FIELD":
            toks.next()
            n_arrays = int(toks.next())
            for _ in range(n_arrays):
                name = toks.next()
                n_comp = int(toks.next())
                n_tuples = int(toks.next())
                toks.next()  # dtype
                vals, toks.pos = parse_f64(toks.pos, n_tuples * n_comp)
                if in_point_data and n_tuples == n_points:
                    point_data[name] = (
                        vals if n_comp == 1 else vals.reshape(n_tuples, n_comp)
                    )
        else:
            # METADATA, LOOKUP_TABLE definitions, strips, etc.: hand the whole
            # file to the tolerant pure-python reader.
            raise ValueError(f"unhandled section {key!r}")

    if points is None:
        raise ValueError("no POINTS")
    return points, triangles, point_data


def _read_ascii(text: str):
    # Drop the two header lines (version comment + title) before tokenizing.
    body = text.split("\n", 2)[2]
    toks = _AsciiTokens(body)
    points = None
    triangles = np.zeros((0, 3), dtype=np.int32)
    point_data: dict[str, np.ndarray] = {}
    n_points = 0
    n_attr = 0  # tuple count of the current POINT_DATA/CELL_DATA section
    in_point_data = False

    while not toks.done():
        key = toks.next().upper()
        if key == "ASCII" or key == "BINARY":
            continue
        elif key == "DATASET":
            kind = toks.next().upper()
            if kind != "POLYDATA":
                raise ValueError(f"Unsupported VTK dataset type: {kind}")
        elif key == "POINTS":
            n_points = int(toks.next())
            dtype = _VTK_DTYPES[toks.next().lower()]
            flat = toks.take_array(n_points * 3, dtype)
            points = flat.astype(np.float64).reshape(n_points, 3)
        elif key == "POLYGONS":
            n_polys = int(toks.next())
            n_vals = int(toks.next())
            # VTK >= 5.1 writes OFFSETS / CONNECTIVITY sub-blocks instead of
            # the flat [n, ids...] stream; n_vals == n_polys marks that layout
            # heuristically via the OFFSETS keyword following.
            if toks.peek() is not None and toks.peek().upper() == "OFFSETS":
                toks.next()  # OFFSETS
                toks.next()  # dtype
                offsets = toks.take_array(n_polys, np.int64)
                conn_kw = toks.next()
                if conn_kw is None or conn_kw.upper() != "CONNECTIVITY":
                    raise ValueError(
                        f"expected CONNECTIVITY after OFFSETS, got {conn_kw!r}"
                    )
                toks.next()  # dtype
                conn = toks.take_array(n_vals, np.int64)
                counts = np.diff(offsets)
                stream = []
                for c, start in zip(counts, offsets[:-1]):
                    stream.append([c])
                    stream.append(conn[start : start + c])
                # Empty stream -> no polygons; the raw CONNECTIVITY array
                # has no per-poly counts and must not reach the
                # triangulator (matches the binary path's np.zeros(0)).
                data = (
                    np.concatenate(stream)
                    if stream
                    else np.zeros(0, np.int64)
                )
                triangles = _triangulate_polys(data.astype(np.int64))
            else:
                data = toks.take_array(n_vals, np.int64)
                triangles = _triangulate_polys(data)
        elif key in ("VERTICES", "LINES", "TRIANGLE_STRIPS"):
            _ = int(toks.next())
            n_vals = int(toks.next())
            toks.take_array(n_vals, np.int64)
            warnings.warn(f"Skipping VTK {key} section")
        elif key == "POINT_DATA":
            n = int(toks.next())
            if n != n_points:
                raise ValueError("POINT_DATA count does not match POINTS")
            in_point_data = True
            n_attr = n
        elif key == "CELL_DATA":
            in_point_data = False
            # Attribute payloads inside CELL_DATA are sized by the CELL
            # count, not n_points — they are parsed (to keep the token
            # stream aligned) and discarded (TriMesh carries point data).
            n_attr = int(toks.next())
        elif key == "SCALARS":
            name = toks.next()
            dtype = _VTK_DTYPES[toks.next().lower()]
            n_comp = 1
            if toks.peek() is not None and toks.peek().upper() not in (
                "LOOKUP_TABLE",
            ):
                # Optional numComp: the spec restricts it to 1..4, which
                # disambiguates it from a first data value >= 5 (the line
                # boundary that formally separates header from data was
                # lost in whole-file tokenization).  1..4 without a
                # LOOKUP_TABLE line stays ambiguous; numComp wins, as a
                # wrong guess fails loudly in take_array rather than
                # silently misaligning.
                try:
                    maybe_comp = int(toks.peek())
                except ValueError:
                    maybe_comp = None
                if maybe_comp is not None and 1 <= maybe_comp <= 4:
                    n_comp = maybe_comp
                    toks.next()
            if toks.peek() is not None and toks.peek().upper() == "LOOKUP_TABLE":
                toks.next()
                toks.next()  # table name
            cnt = n_attr or n_points  # tolerate SCALARS before a section
            vals = toks.take_array(cnt * n_comp, dtype).astype(np.float64)
            if in_point_data or not n_attr:
                point_data[name] = (
                    vals if n_comp == 1 else vals.reshape(cnt, n_comp)
                )
        elif key == "FIELD":
            toks.next()  # field name
            n_arrays = int(toks.next())
            for _ in range(n_arrays):
                name = toks.next()
                n_comp = int(toks.next())
                n_tuples = int(toks.next())
                dtype = _VTK_DTYPES[toks.next().lower()]
                vals = toks.take_array(n_tuples * n_comp, dtype).astype(np.float64)
                if in_point_data and n_tuples == n_points:
                    point_data[name] = (
                        vals if n_comp == 1 else vals.reshape(n_tuples, n_comp)
                    )
        elif key in ("NORMALS", "VECTORS"):
            toks.next()  # name
            dtype = _VTK_DTYPES[toks.next().lower()]
            toks.take_array((n_attr or n_points) * 3, dtype)
        elif key == "LOOKUP_TABLE":
            name = toks.next()
            n = int(toks.next())
            toks.take_array(n * 4, np.float64)
        elif key == "METADATA":
            # Skip the METADATA block (INFORMATION m ... / NAME/DATA pairs).
            if toks.peek() is not None and toks.peek().upper() == "INFORMATION":
                toks.next()
                n_info = int(toks.next())
                for _ in range(n_info):
                    while toks.peek() is not None and toks.peek().upper() != "NAME":
                        toks.next()
                    toks.next()  # NAME
                    toks.next()  # name value
                    # consume until DATA token + one value
                    while toks.peek() is not None and toks.peek().upper() != "DATA":
                        toks.next()
                    toks.next()
                    toks.next()
        else:
            # Unknown token; skip.
            pass

    if points is None:
        raise ValueError("VTK file contains no POINTS section")
    return points, triangles, point_data


def _read_binary(raw: bytes):
    """Minimal big-endian legacy binary reader (POINTS/POLYGONS/SCALARS)."""
    # Split header region by lines; binary payloads follow keyword lines.
    pos = 0

    def next_line():
        nonlocal pos
        end = raw.index(b"\n", pos)
        line = raw[pos:end].decode("ascii", errors="replace").strip()
        pos = end + 1
        return line

    next_line()  # version
    next_line()  # title
    marker = next_line()
    if marker.upper() != "BINARY":
        raise ValueError(f"expected BINARY marker, got {marker!r}")
    points = None
    triangles = np.zeros((0, 3), dtype=np.int32)
    point_data: dict[str, np.ndarray] = {}
    n_points = 0
    n_attr = 0  # tuple count of the current POINT_DATA/CELL_DATA section
    in_point_data = False

    def read_array(count, np_dtype):
        nonlocal pos
        dt = np.dtype(np_dtype).newbyteorder(">")
        nbytes = dt.itemsize * count
        arr = np.frombuffer(raw[pos : pos + nbytes], dtype=dt).astype(np_dtype)
        if arr.shape[0] != count:
            # Truncated binary payload: frombuffer silently returns what is
            # available; a short mesh must be a loud parse error.
            raise ValueError(
                f"binary payload truncated: expected {count} values, "
                f"file has {arr.shape[0]}"
            )
        pos += nbytes
        if pos < len(raw) and raw[pos : pos + 1] == b"\n":
            pos += 1
        return arr

    while pos < len(raw):
        try:
            line = next_line()
        except ValueError:
            break
        if not line:
            continue
        parts = line.split()
        key = parts[0].upper()
        if key == "DATASET":
            if parts[1].upper() != "POLYDATA":
                raise ValueError(f"Unsupported dataset {parts[1]}")
        elif key == "POINTS":
            n_points = int(parts[1])
            dtype = _VTK_DTYPES[parts[2].lower()]
            points = read_array(n_points * 3, dtype).astype(np.float64).reshape(-1, 3)
        elif key == "POLYGONS":
            n_head = int(parts[1])
            n_vals = int(parts[2])
            # VTK >= 5.1 binary layout: OFFSETS / CONNECTIVITY sub-blocks.
            save = pos
            sub = next_line().split()
            if sub and sub[0].upper() == "OFFSETS":
                offsets = read_array(
                    n_head, _VTK_DTYPES[sub[1].lower()]
                ).astype(np.int64)
                sub2 = next_line().split()
                if not sub2 or sub2[0].upper() != "CONNECTIVITY":
                    raise ValueError(
                        f"expected CONNECTIVITY after OFFSETS, got {sub2!r}"
                    )
                conn = read_array(
                    n_vals, _VTK_DTYPES[sub2[1].lower()]
                ).astype(np.int64)
                counts = np.diff(offsets)
                stream = []
                for c, start in zip(counts, offsets[:-1]):
                    stream.append(np.asarray([c], np.int64))
                    stream.append(conn[start : start + c])
                data = (
                    np.concatenate(stream) if stream else np.zeros(0, np.int64)
                )
                triangles = _triangulate_polys(data)
            else:
                pos = save
                data = read_array(n_vals, np.int32).astype(np.int64)
                triangles = _triangulate_polys(data)
        elif key == "POINT_DATA":
            in_point_data = True
            n_attr = int(parts[1]) if len(parts) > 1 else n_points
        elif key == "CELL_DATA":
            in_point_data = False
            # Attribute payloads that follow are sized by the CELL count.
            n_attr = int(parts[1]) if len(parts) > 1 else 0
        elif key == "FIELD":
            # FIELD <name> <num_arrays>; each array:
            #   <name> <numComponents> <numTuples> <dataType>\n<binary payload>
            n_arrays = int(parts[2])
            for _ in range(n_arrays):
                spec = next_line().split()
                while not spec:  # tolerate blank separator lines
                    spec = next_line().split()
                a_name, n_comp, n_tup = spec[0], int(spec[1]), int(spec[2])
                dtype = _VTK_DTYPES[spec[3].lower()]
                vals = read_array(n_comp * n_tup, dtype).astype(np.float64)
                if in_point_data and n_tup == n_points:
                    point_data[a_name] = (
                        vals if n_comp == 1 else vals.reshape(n_tup, n_comp)
                    )
        elif key == "SCALARS":
            name = parts[1]
            dtype = _VTK_DTYPES[parts[2].lower()]
            n_comp = int(parts[3]) if len(parts) > 3 else 1
            # The LOOKUP_TABLE line is required by the spec but omitted by
            # some writers; in binary it is a full text line, so rewind if
            # absent instead of consuming payload bytes as text.
            save_lt = pos
            try:
                lt = next_line()
            except ValueError:  # payload with no further newline
                lt = ""
            if not lt.upper().startswith("LOOKUP_TABLE"):
                pos = save_lt
            cnt = n_attr or n_points
            vals = read_array(cnt * n_comp, dtype).astype(np.float64)
            if in_point_data or not n_attr:
                point_data[name] = (
                    vals if n_comp == 1 else vals.reshape(cnt, n_comp)
                )
    if points is None:
        raise ValueError("VTK file contains no POINTS section")
    return points, triangles, point_data


def write_vtk_polydata(path, points, triangles, point_data=None, title="pyfocusr_tpu output"):
    """Write a legacy ASCII VTK PolyData file readable by VTK and by
    :func:`read_vtk_polydata`.  The first point-data array becomes the active
    SCALARS (matching how the reference attaches correspondence indices,
    ``focusr.py:576-599``); additional arrays are emitted as FIELD data."""
    points = np.asarray(points, dtype=np.float64)
    triangles = np.asarray(triangles, dtype=np.int64)
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 4.2\n")
        f.write(f"{title}\n")
        f.write("ASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {n} double\n")
        np.savetxt(f, points, fmt="%.10g")
        if triangles.size:
            ntri = triangles.shape[0]
            f.write(f"POLYGONS {ntri} {ntri * 4}\n")
            conn = np.column_stack(
                [np.full(ntri, 3, dtype=np.int64), triangles]
            )
            np.savetxt(f, conn, fmt="%d")
        if point_data:
            f.write(f"POINT_DATA {n}\n")
            items = list(point_data.items())
            name0, arr0 = items[0]
            arr0 = np.asarray(arr0, dtype=np.float64)
            # The VTK SCALARS attribute caps numComp at 4 (and our readers
            # enforce that); wider arrays (e.g. spectral coordinates) must
            # go out as FIELD data or the file is unreadable.
            scalars_ok = arr0.ndim == 1 or arr0.shape[1] <= 4
            if not scalars_ok:
                items = [(name0, arr0)] + items[1:]
                f.write(f"FIELD extra {len(items)}\n")
                for name, arr in items:
                    arr = np.asarray(arr, dtype=np.float64)
                    n_comp = 1 if arr.ndim == 1 else arr.shape[1]
                    f.write(f"{name} {n_comp} {n} double\n")
                    np.savetxt(f, arr.reshape(n, -1), fmt="%.10g")
                return
            if arr0.ndim == 1:
                f.write(f"SCALARS {name0} double\nLOOKUP_TABLE default\n")
                np.savetxt(f, arr0, fmt="%.10g")
            else:
                f.write(f"SCALARS {name0} double {arr0.shape[1]}\nLOOKUP_TABLE default\n")
                np.savetxt(f, arr0, fmt="%.10g")
            if len(items) > 1:
                f.write(f"FIELD extra {len(items) - 1}\n")
                for name, arr in items[1:]:
                    arr = np.asarray(arr, dtype=np.float64)
                    n_comp = 1 if arr.ndim == 1 else arr.shape[1]
                    f.write(f"{name} {n_comp} {n} double\n")
                    np.savetxt(f, arr.reshape(n, -1), fmt="%.10g")
