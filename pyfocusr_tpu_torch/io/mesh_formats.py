"""Dependency-free PLY / OBJ / STL triangle-mesh readers and writers.

A copy of ``pyfocusr_tpu/io/mesh_formats.py`` (numpy only; the port imports
nothing of the JAX package).  The files it writes are the JAX package's,
byte for byte, so either package reads the other's.

The reference consumes only legacy ``.vtk`` PolyData (``vtk_functions.py:5-9``
via vtkPolyDataReader), but real mesh collections arrive as PLY/OBJ/STL
(and modern VTK pipelines emit XML ``.vtp`` — see :mod:`.vtp_io`); these
loaders widen the I/O boundary with the same zero-dependency,
numpy-only design as :mod:`.vtk_io`.  ``pyfocusr_tpu_torch.load_mesh`` /
``save_mesh`` dispatch on file extension, so every pipeline entry point
accepts any of the five formats transparently.

Format notes:

* **PLY**: ascii and binary_little/big_endian, arbitrary extra vertex
  scalar properties (-> ``point_data``), list-typed face property with
  fan-triangulation of quads+.  Writes ascii or binary_little_endian with
  point_data as extra float properties.
* **OBJ**: ``v``/``f`` records (``f`` entries may be ``v``, ``v/vt``,
  ``v//vn``, ``v/vt/vn``; negative indices resolved from the end), fan
  triangulation.  OBJ has no per-vertex scalar channel; ``point_data`` is
  dropped on write with a warning comment in the file.
* **STL**: binary (auto-detected) and ascii.  STL is a triangle soup;
  reading welds exactly-equal vertex coordinates so graph construction
  sees shared topology (bitwise equality — no tolerance merging).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = [
    "read_ply", "write_ply",
    "read_obj", "write_obj",
    "read_stl", "write_stl",
    "read_any", "write_any",
    "SUPPORTED_EXTENSIONS",
]

SUPPORTED_EXTENSIONS = (".vtk", ".vtp", ".ply", ".obj", ".stl")


def _fan_triangulate(faces):
    """List of index lists -> [F, 3] int32 via fan triangulation."""
    tris = []
    for f in faces:
        for i in range(1, len(f) - 1):
            tris.append((f[0], f[i], f[i + 1]))
    return np.asarray(tris, np.int32).reshape(-1, 3)


# ----------------------------------------------------------------------
# PLY
# ----------------------------------------------------------------------

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Read a PLY mesh -> (points f64[N,3], triangles i32[F,3], point_data).

    Extra scalar vertex properties beyond x/y/z become ``point_data``
    entries keyed by property name.
    """
    with open(path, "rb") as fh:
        raw = fh.read()
    if not raw.startswith(b"ply"):
        raise ValueError(f"{path}: not a PLY file")
    # Match end_header at a LINE START — a raw substring find would stop at
    # a comment that happens to contain the word and truncate the header.
    end, search = -1, 0
    while True:
        cand = raw.find(b"end_header", search)
        if cand < 0:
            break
        if raw[cand - 1: cand] in (b"\n", b"\r"):
            end = cand
            break
        search = cand + 1
    if end < 0:
        raise ValueError(f"{path}: missing end_header")
    header = raw[:end].decode("ascii", "replace").splitlines()
    body_start = raw.index(b"\n", end) + 1

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype_str | ('list', cdt, idt))])
    for line in header[1:]:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append((parts[4], ("list", parts[2], parts[3])))
            else:
                elements[-1][2].append((parts[2], parts[1]))
        elif parts[0] in ("comment", "obj_info"):
            continue

    if fmt is None:
        raise ValueError(f"{path}: PLY missing format line")
    swap = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)

    verts = None
    vert_props = None
    faces = []
    if fmt == "ascii":
        tokens = raw[body_start:].split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                ncol = len(props)
                arr = np.asarray(
                    tokens[pos: pos + count * ncol], dtype=np.float64
                ).reshape(count, ncol)
                pos += count * ncol
                verts, vert_props = arr, props
            elif name == "face":
                # Walk EVERY declared per-face property in order (legal PLY
                # allows scalars like 'property uchar quality' around the
                # vertex list; consuming only the list would misread the
                # scalar as the next face's vertex count).
                has_list = any(isinstance(p[1], tuple) for p in props)
                if not has_list:
                    raise ValueError(
                        f"{path}: face element has no list property"
                    )
                for _ in range(count):
                    for pname, ptype in props:
                        if isinstance(ptype, tuple):
                            n = int(tokens[pos]); pos += 1
                            vals = tokens[pos: pos + n]
                            pos += n
                            if pname in ("vertex_indices", "vertex_index"):
                                faces.append([int(t) for t in vals])
                        else:
                            pos += 1  # per-face scalar, not consumed
            else:  # skip unknown fixed-width element
                scal = [p for p in props if not isinstance(p[1], tuple)]
                if len(scal) != len(props):
                    raise ValueError(
                        f"{path}: cannot skip list-typed element {name!r}"
                    )
                pos += count * len(props)
    else:
        if swap is None:
            raise ValueError(f"{path}: unknown PLY format {fmt!r}")
        pos = body_start
        for name, count, props in elements:
            all_scalar = all(not isinstance(p[1], tuple) for p in props)
            if all_scalar:
                dt = np.dtype(
                    [(p[0], swap + _PLY_DTYPES[p[1]]) for p in props]
                )
                arr = np.frombuffer(raw, dtype=dt, count=count, offset=pos)
                pos += dt.itemsize * count
                if name == "vertex":
                    verts = np.stack(
                        [arr[p[0]].astype(np.float64) for p in props], axis=1
                    )
                    vert_props = props
            else:
                for _ in range(count):
                    n_read = 0
                    for pname, ptype in props:
                        if isinstance(ptype, tuple):
                            _, cdt, idt = ptype
                            cnp = np.dtype(swap + _PLY_DTYPES[cdt])
                            inp = np.dtype(swap + _PLY_DTYPES[idt])
                            n = int(np.frombuffer(raw, cnp, 1, pos)[0])
                            pos += cnp.itemsize
                            idxs = np.frombuffer(raw, inp, n, pos)
                            pos += inp.itemsize * n
                            if name == "face" and n_read == 0:
                                faces.append([int(i) for i in idxs])
                            n_read += 1
                        else:
                            pos += np.dtype(_PLY_DTYPES[ptype]).itemsize

    if verts is None:
        raise ValueError(f"{path}: PLY has no vertex element")
    names = [p[0] for p in vert_props]
    for axis in ("x", "y", "z"):
        if axis not in names:
            raise ValueError(f"{path}: PLY vertex element missing {axis!r}")
    points = verts[:, [names.index("x"), names.index("y"), names.index("z")]]
    point_data = {
        n: verts[:, i]
        for i, n in enumerate(names)
        if n not in ("x", "y", "z")
    }
    triangles = _fan_triangulate(faces)
    return points, triangles, point_data


def write_ply(path: str, points, triangles, point_data=None, binary=True):
    points = np.asarray(points, np.float64)
    triangles = np.asarray(triangles, np.int32)
    point_data = {
        k: np.asarray(v, np.float64) for k, v in (point_data or {}).items()
    }
    n, f = len(points), len(triangles)
    # PLY vertex properties are scalars: expand [N, C] point_data into one
    # property per component ('name' -> name_0..name_{C-1}); a reader gets
    # them back as separate scalar arrays.
    expanded = {}
    for k, v in point_data.items():
        if v.shape[0] != n:
            raise ValueError(
                f"point_data {k!r} has {v.shape[0]} rows for {n} vertices"
            )
        v2 = v.reshape(n, -1)
        if v2.shape[1] == 1:
            expanded[k] = v2
        else:
            for c in range(v2.shape[1]):
                expanded[f"{k}_{c}"] = v2[:, c : c + 1]
    head = ["ply"]
    head.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    head.append("comment written by pyfocusr_tpu")
    head.append(f"element vertex {n}")
    head += ["property float x", "property float y", "property float z"]
    for k in expanded:
        head.append(f"property float {k}")
    head.append(f"element face {f}")
    head.append("property list uchar int vertex_indices")
    head.append("end_header\n")
    header = "\n".join(head).encode("ascii")

    cols = [points.astype(np.float32)] + [
        expanded[k].astype(np.float32) for k in expanded
    ]
    vert = np.concatenate(cols, axis=1) if len(cols) > 1 else cols[0]
    with open(path, "wb") as fh:
        fh.write(header)
        if binary:
            fh.write(vert.astype("<f4").tobytes())
            face_dt = np.dtype([("c", "u1"), ("i", "<i4", (3,))])
            farr = np.empty(f, face_dt)
            farr["c"] = 3
            farr["i"] = triangles
            fh.write(farr.tobytes())
        else:
            for row in vert:
                fh.write((" ".join(f"{v:.9g}" for v in row) + "\n").encode())
            for t in triangles:
                fh.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())


# ----------------------------------------------------------------------
# OBJ
# ----------------------------------------------------------------------

def read_obj(path: str):
    """Read a Wavefront OBJ -> (points f64[N,3], triangles i32[F,3], {})."""
    pts = []
    faces = []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                pts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    v = int(tok.split("/")[0])
                    if v == 0:
                        # OBJ indices are 1-based (negative = from end);
                        # 0 is illegal but emitted by buggy exporters —
                        # raise here rather than produce an out-of-range
                        # triangle that crashes cryptically downstream.
                        raise ValueError(
                            f"{path}: illegal 0 face index (OBJ is 1-based)"
                        )
                    idx.append(v - 1 if v > 0 else len(pts) + v)
                faces.append(idx)
    points = np.asarray(pts, np.float64).reshape(-1, 3)
    return points, _fan_triangulate(faces), {}


def write_obj(path: str, points, triangles, point_data=None):
    points = np.asarray(points, np.float64)
    triangles = np.asarray(triangles, np.int64)
    with open(path, "w") as fh:
        fh.write("# written by pyfocusr_tpu\n")
        if point_data:
            fh.write(
                "# note: OBJ has no per-vertex scalar channel; point_data "
                f"keys dropped: {sorted(point_data)}\n"
            )
        for p in points:
            fh.write(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        for t in triangles:
            fh.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


# ----------------------------------------------------------------------
# STL
# ----------------------------------------------------------------------

def _weld(tri_pts: np.ndarray):
    """[F, 3, 3] triangle soup -> (points [N,3], triangles [F,3]) by
    bitwise-exact vertex welding (order of first appearance)."""
    flat = np.ascontiguousarray(tri_pts.reshape(-1, 3), np.float64)
    view = flat.view([("x", np.float64), ("y", np.float64), ("z", np.float64)])
    _, first, inv = np.unique(view, return_index=True, return_inverse=True)
    order = np.argsort(first)  # preserve first-appearance order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    points = flat[np.sort(first)]
    triangles = rank[inv].reshape(-1, 3).astype(np.int32)
    return points, triangles


def _stl_binary_tri_pts(raw: bytes, n_tri: int) -> np.ndarray:
    """Parse n_tri 50-byte binary STL records after the 84-byte header ->
    [n_tri, 3, 3] f64 vertex triples (shared by both binary branches)."""
    rec = np.dtype(
        [("n", "<f4", (3,)), ("v", "<f4", (3, 3)), ("attr", "<u2")]
    )
    arr = np.frombuffer(raw, rec, count=n_tri, offset=84)
    return arr["v"].astype(np.float64)


def read_stl(path: str):
    """Read an STL (binary or ascii) -> welded (points, triangles, {})."""
    with open(path, "rb") as fh:
        raw = fh.read()
    # Binary/ascii discrimination: the 'solid' prefix is NOT reliable
    # (real-world binary STLs put free text like 'solid Part1' in the
    # 80-byte header).  The robust test is the exact binary size identity
    # len == 84 + 50 * n_tri; only when that fails, fall back to the
    # ascii markers.
    is_binary = False
    if len(raw) >= 84:
        (n_tri_hdr,) = struct.unpack("<I", raw[80:84])
        is_binary = len(raw) == 84 + 50 * n_tri_hdr
    is_ascii = not is_binary and raw[:5] == b"solid"
    if is_ascii:
        toks = raw.decode("ascii", "replace").split()
        coords = []
        i = 0
        while i < len(toks):
            if toks[i] == "vertex":
                coords.append(
                    (float(toks[i + 1]), float(toks[i + 2]), float(toks[i + 3]))
                )
                i += 4
            else:
                i += 1
        if not coords:
            # 'solid' prefix but no ascii vertices.  A PROPER zero-triangle
            # ascii solid (has its 'endsolid' closer) is valid and empty;
            # otherwise retry as binary with trailing bytes tolerated
            # (text-mode transfers / exporter padding break the exact size
            # identity); only a file that is neither parses raises — never
            # return an empty mesh silently (including sub-84-byte junk,
            # which cannot be binary either).
            if b"endsolid" in raw:
                return (
                    np.zeros((0, 3), np.float64),
                    np.zeros((0, 3), np.int32),
                    {},
                )
            if len(raw) >= 84:
                (n_tri_hdr,) = struct.unpack("<I", raw[80:84])
                if n_tri_hdr > 0 and len(raw) >= 84 + 50 * n_tri_hdr:
                    points, triangles = _weld(
                        _stl_binary_tri_pts(raw, n_tri_hdr)
                    )
                    return points, triangles, {}
            raise ValueError(
                f"{path}: not a valid STL (binary size identity fails "
                "and no ascii 'vertex' records found)"
            )
        tri_pts = np.asarray(coords, np.float64).reshape(-1, 3, 3)
    else:
        if len(raw) < 84:
            raise ValueError(f"{path}: truncated binary STL")
        (n_tri,) = struct.unpack("<I", raw[80:84])
        tri_pts = _stl_binary_tri_pts(raw, n_tri)
    points, triangles = _weld(tri_pts)
    return points, triangles, {}


def write_stl(path: str, points, triangles, point_data=None, binary=True):
    points = np.asarray(points, np.float64)
    triangles = np.asarray(triangles, np.int64)
    tri_pts = points[triangles]  # [F, 3, 3]
    a = tri_pts[:, 1] - tri_pts[:, 0]
    b = tri_pts[:, 2] - tri_pts[:, 0]
    nrm = np.cross(a, b)
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-300), 0.0)
    if binary:
        rec = np.dtype(
            [("n", "<f4", (3,)), ("v", "<f4", (3, 3)), ("attr", "<u2")]
        )
        arr = np.zeros(len(triangles), rec)
        arr["n"] = nrm
        arr["v"] = tri_pts
        with open(path, "wb") as fh:
            fh.write(b"pyfocusr_tpu".ljust(80, b"\0"))
            fh.write(struct.pack("<I", len(triangles)))
            fh.write(arr.tobytes())
    else:
        with open(path, "w") as fh:
            fh.write("solid pyfocusr_tpu\n")
            for nv, tp in zip(nrm, tri_pts):
                fh.write(f"facet normal {nv[0]:.9g} {nv[1]:.9g} {nv[2]:.9g}\n")
                fh.write("  outer loop\n")
                for v in tp:
                    fh.write(f"    vertex {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
                fh.write("  endloop\nendfacet\n")
            fh.write("endsolid pyfocusr_tpu\n")


# ----------------------------------------------------------------------
# Extension dispatch
# ----------------------------------------------------------------------

def read_any(path: str):
    """(points, triangles, point_data) from .vtk/.vtp/.ply/.obj/.stl by extension."""
    low = path.lower()
    if low.endswith(".vtk"):
        from .vtk_io import read_vtk_polydata

        return read_vtk_polydata(path)
    if low.endswith(".vtp"):
        from .vtp_io import read_vtp

        return read_vtp(path)
    if low.endswith(".ply"):
        return read_ply(path)
    if low.endswith(".obj"):
        return read_obj(path)
    if low.endswith(".stl"):
        return read_stl(path)
    raise ValueError(
        f"unsupported mesh extension on {path!r}; expected one of "
        f"{SUPPORTED_EXTENSIONS}"
    )


def write_any(path: str, points, triangles, point_data=None):
    low = path.lower()
    if low.endswith(".vtk"):
        from .vtk_io import write_vtk_polydata

        return write_vtk_polydata(path, points, triangles, point_data or {})
    if low.endswith(".vtp"):
        from .vtp_io import write_vtp

        return write_vtp(path, points, triangles, point_data)
    if low.endswith(".ply"):
        return write_ply(path, points, triangles, point_data)
    if low.endswith(".obj"):
        return write_obj(path, points, triangles, point_data)
    if low.endswith(".stl"):
        return write_stl(path, points, triangles, point_data)
    raise ValueError(
        f"unsupported mesh extension on {path!r}; expected one of "
        f"{SUPPORTED_EXTENSIONS}"
    )
