"""Dependency-free reader/writer for VTK XML PolyData (``.vtp``) files.

A copy of ``pyfocusr_tpu/io/vtp_io.py`` (numpy only; the port imports
nothing of the JAX package).

The reference consumes only *legacy* ``.vtk`` PolyData (``vtk_functions.py:5-9``
uses ``vtkPolyDataReader``, which cannot read the XML formats), but modern
VTK/ParaView pipelines emit ``.vtp`` by default — a mesh collection produced
by any contemporary VTK workflow arrives in this format.  This module widens
the I/O boundary with the same zero-dependency, numpy+stdlib-only design as
:mod:`.vtk_io` / :mod:`.mesh_formats`.

Supported on read (everything VTK's own writer can produce for PolyData):

* ``format="ascii"`` DataArrays;
* ``format="binary"`` (inline base64) DataArrays, uncompressed or
  zlib-compressed (``compressor="vtkZLibDataCompressor"``; LZ4/LZMA raise a
  clear error — they require external libraries);
* ``format="appended"`` DataArrays with ``encoding="base64"`` or
  ``encoding="raw"`` appended sections;
* ``header_type`` UInt32 (the pre-1.0 default) and UInt64;
* both byte orders;
* multiple ``<Piece>`` elements (concatenated, connectivity re-offset);
* arbitrary polygon sizes (fan-triangulated like the legacy reader).

The writer emits a single-piece file as inline base64 (default), ascii, or
zlib-compressed inline base64 — all three readable by VTK/ParaView and by
this reader (the compressed path doubles as the reader's compression test
oracle).

Binary layout notes (matching VTK's XML writers; independently verified
against the format specification):

* every binary block is ``header || data`` where the *uncompressed* header
  is one header-type integer holding the data byte count;
* with compression the header is ``[nblocks, blocksize, last_partial_size,
  compressed_size_1..nblocks]`` and the data is the concatenated
  zlib-compressed blocks;
* inline base64 *uncompressed*: header+data form ONE base64 stream;
  inline base64 *compressed*: the header is base64-encoded SEPARATELY from
  the data stream and the two base64 strings are concatenated (the header
  is written before the compressed sizes are known, so it cannot share the
  data's 3-byte base64 groups);
* appended ``encoding="raw"``: plain bytes after the ``_`` marker, each
  DataArray at its ``offset``;  ``encoding="base64"``: each DataArray's
  block is its own base64 stream starting at ``offset`` (offsets count
  base64 characters, not decoded bytes).
"""

from __future__ import annotations

import base64
import re
import zlib
from xml.etree import ElementTree

import numpy as np

__all__ = ["read_vtp", "write_vtp"]

_XML_DTYPES = {
    "Int8": "i1", "UInt8": "u1",
    "Int16": "i2", "UInt16": "u2",
    "Int32": "i4", "UInt32": "u4",
    "Int64": "i8", "UInt64": "u8",
    "Float32": "f4", "Float64": "f8",
}

_NP_TO_XML = {
    np.dtype(np.int8): "Int8", np.dtype(np.uint8): "UInt8",
    np.dtype(np.int16): "Int16", np.dtype(np.uint16): "UInt16",
    np.dtype(np.int32): "Int32", np.dtype(np.uint32): "UInt32",
    np.dtype(np.int64): "Int64", np.dtype(np.uint64): "UInt64",
    np.dtype(np.float32): "Float32", np.dtype(np.float64): "Float64",
}


def _b64_len(nbytes: int) -> int:
    """Length in characters of the base64 encoding of ``nbytes`` bytes."""
    return 4 * ((nbytes + 2) // 3)


class _BlockDecoder:
    """Decodes one VTK XML binary block (header + payload) from a byte or
    base64-character stream."""

    def __init__(self, byte_order: str, header_type: str, compressor: str):
        self.bo = "<" if byte_order != "BigEndian" else ">"
        if header_type not in ("UInt32", "UInt64"):
            raise ValueError(f"unsupported vtp header_type {header_type!r}")
        self.hdr_dtype = np.dtype(self.bo + ("u4" if header_type == "UInt32" else "u8"))
        if compressor and compressor != "vtkZLibDataCompressor":
            raise ValueError(
                f"unsupported vtp compressor {compressor!r} "
                "(only vtkZLibDataCompressor / uncompressed are supported)"
            )
        self.compressed = bool(compressor)

    # -- raw byte streams (appended encoding="raw") ---------------------

    def from_raw(self, buf: bytes, offset: int) -> bytes:
        isz = self.hdr_dtype.itemsize
        if not self.compressed:
            (nbytes,) = np.frombuffer(buf, self.hdr_dtype, 1, offset)
            start = offset + isz
            return bytes(buf[start : start + int(nbytes)])
        nblocks = int(np.frombuffer(buf, self.hdr_dtype, 1, offset)[0])
        hdr = np.frombuffer(buf, self.hdr_dtype, 3 + nblocks, offset)
        sizes = hdr[3:].astype(np.int64)
        pos = offset + (3 + nblocks) * isz
        out = []
        for s in sizes:
            out.append(zlib.decompress(buf[pos : pos + int(s)]))
            pos += int(s)
        return b"".join(out)

    # -- base64 character streams (inline binary / appended base64) -----

    def from_b64(self, text: str, offset: int = 0) -> bytes:
        isz = self.hdr_dtype.itemsize
        if not self.compressed:
            # ONE base64 stream of header||data: decode enough for the
            # header, then the exact remainder.
            head = base64.b64decode(text[offset : offset + _b64_len(isz) + 4])
            (nbytes,) = np.frombuffer(head, self.hdr_dtype, 1)
            total = _b64_len(isz + int(nbytes))
            raw = base64.b64decode(text[offset : offset + total])
            return raw[isz : isz + int(nbytes)]
        # Compressed: base64(header) || base64(blocks) — the first header
        # integer (block count) determines the full header length.
        head = base64.b64decode(text[offset : offset + _b64_len(isz) + 4])
        nblocks = int(np.frombuffer(head, self.hdr_dtype, 1)[0])
        hdr_bytes = (3 + nblocks) * isz
        hdr_chars = _b64_len(hdr_bytes)
        hdr = np.frombuffer(
            base64.b64decode(text[offset : offset + hdr_chars]), self.hdr_dtype
        )
        sizes = hdr[3:].astype(np.int64)
        data_chars = _b64_len(int(sizes.sum()))
        raw = base64.b64decode(
            text[offset + hdr_chars : offset + hdr_chars + data_chars]
        )
        out, pos = [], 0
        for s in sizes:
            out.append(zlib.decompress(raw[pos : pos + int(s)]))
            pos += int(s)
        return b"".join(out)


def _split_appended(raw: bytes):
    """Excise the <AppendedData> payload (raw bytes are not valid XML).

    Returns (xml_bytes, payload, encoding) where ``payload`` is bytes for
    encoding="raw" or an ascii str for encoding="base64" (offsets index
    characters there), or (raw, None, None) when no appended section exists.
    """
    m = re.search(rb"<AppendedData[^>]*>", raw)
    if m is None:
        return raw, None, None
    enc_m = re.search(rb'encoding="([^"]+)"', m.group(0))
    encoding = enc_m.group(1).decode() if enc_m else "base64"
    end = raw.rindex(b"</AppendedData>")
    body = raw[m.end() : end]
    underscore = body.index(b"_")
    payload = body[underscore + 1 :]
    # VTK pads the section with whitespace before the closing tag; base64
    # offsets index the character stream as written.
    xml = raw[: m.end()] + b"</AppendedData>" + raw[end + len(b"</AppendedData>") :]
    if encoding == "raw":
        return xml, payload, encoding
    return xml, payload.decode("ascii").strip(), encoding


def _read_data_array(elem, decoder: _BlockDecoder, appended, byte_order: str):
    """One <DataArray> element -> flat numpy array (native byte order)."""
    dtype_name = elem.get("type")
    if dtype_name not in _XML_DTYPES:
        raise ValueError(f"unsupported vtp DataArray type {dtype_name!r}")
    bo = "<" if byte_order != "BigEndian" else ">"
    dtype = np.dtype(bo + _XML_DTYPES[dtype_name])
    fmt = elem.get("format", "ascii")
    if fmt == "ascii":
        text = elem.text or ""
        return np.array(text.split(), dtype=dtype.newbyteorder("="))
    if fmt == "binary":
        raw = decoder.from_b64((elem.text or "").strip())
    elif fmt == "appended":
        if appended is None:
            raise ValueError("vtp DataArray is 'appended' but file has no AppendedData")
        offset = int(elem.get("offset", "0"))
        if isinstance(appended, bytes):
            raw = decoder.from_raw(appended, offset)
        else:
            raw = decoder.from_b64(appended, offset)
    else:
        raise ValueError(f"unsupported vtp DataArray format {fmt!r}")
    return np.frombuffer(raw, dtype).astype(dtype.newbyteorder("="), copy=False)


def _triangulate_offsets(conn: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """XML connectivity+offsets -> (F, 3) int32 fan triangulation."""
    declared = int(offs[-1]) if offs.size else 0
    if conn.size != declared:
        # Trailing junk would either fabricate phantom triangles (fast
        # path) or be silently dropped (slow path) — both corruptions.
        raise ValueError(
            f"vtp connectivity holds {conn.size} indices but offsets "
            f"declare {declared}"
        )
    if offs.size and np.all(np.diff(offs, prepend=0) == 3):
        return np.ascontiguousarray(conn.reshape(-1, 3).astype(np.int32))
    tris = []
    start = 0
    for end in offs:
        end = int(end)
        n = end - start
        if n < 0:
            raise ValueError("vtp Polys offsets are not non-decreasing")
        verts = conn[start:end]
        for t in range(1, n - 1):
            tris.append((verts[0], verts[t], verts[t + 1]))
        start = end
    return np.asarray(tris, np.int32).reshape(-1, 3)


def read_vtp(path: str):
    """Read a VTK XML PolyData (``.vtp``) file.

    Returns ``(points f64[N,3], triangles i32[F,3], point_data)`` — the same
    contract as :func:`pyfocusr_tpu_torch.io.vtk_io.read_vtk_polydata`.  Verts,
    Lines and Strips cells are ignored (FOCUSR operates on triangle
    surfaces); PointData arrays become ``point_data`` entries ((N,) for one
    component, (N, C) otherwise).
    """
    with open(path, "rb") as fh:
        raw = fh.read()
    xml_bytes, appended, _enc = _split_appended(raw)
    root = ElementTree.fromstring(xml_bytes)
    if root.tag != "VTKFile" or root.get("type") != "PolyData":
        raise ValueError(f"{path!r} is not a VTK XML PolyData (.vtp) file")
    byte_order = root.get("byte_order", "LittleEndian")
    header_type = root.get("header_type", "UInt32")
    compressor = root.get("compressor", "")
    decoder = _BlockDecoder(byte_order, header_type, compressor)

    pieces = root.findall("./PolyData/Piece")
    if not pieces:
        raise ValueError(f"{path!r} contains no PolyData Piece")

    all_pts, all_tris, pd_parts = [], [], []
    n_before = 0
    for piece in pieces:
        pts_el = piece.find("./Points/DataArray")
        if pts_el is None:
            raise ValueError("vtp Piece has no Points DataArray")
        ncomp = int(pts_el.get("NumberOfComponents", "3"))
        if ncomp < 3:
            raise ValueError(
                f"vtp Points has NumberOfComponents={ncomp}; FOCUSR needs "
                "3-D points (embed 2-D meshes with a zero z column first)"
            )
        pts = _read_data_array(pts_el, decoder, appended, byte_order)
        pts = pts.reshape(-1, ncomp)[:, :3].astype(np.float64)
        n_pts = pts.shape[0]
        declared = piece.get("NumberOfPoints")
        if declared is not None and int(declared) != n_pts:
            raise ValueError(
                f"vtp Piece declares {declared} points but Points holds {n_pts}"
            )

        tris = np.zeros((0, 3), np.int32)
        polys = piece.find("Polys")
        if polys is not None:
            arrays = {a.get("Name"): a for a in polys.findall("DataArray")}
            if "connectivity" in arrays and "offsets" in arrays:
                conn = _read_data_array(
                    arrays["connectivity"], decoder, appended, byte_order
                ).astype(np.int64)
                offs = _read_data_array(
                    arrays["offsets"], decoder, appended, byte_order
                ).astype(np.int64)
                if conn.size and (conn.min() < 0 or conn.max() >= n_pts):
                    raise ValueError("vtp connectivity indexes out of range")
                tris = _triangulate_offsets(conn, offs)

        pd = {}
        pdata = piece.find("PointData")
        if pdata is not None:
            for arr_el in pdata.findall("DataArray"):
                name = arr_el.get("Name", f"array{len(pd)}")
                ncomp_a = int(arr_el.get("NumberOfComponents", "1"))
                vals = _read_data_array(arr_el, decoder, appended, byte_order)
                vals = vals.astype(np.float64)
                if vals.size != n_pts * ncomp_a:
                    raise ValueError(
                        f"vtp PointData {name!r} holds {vals.size} values "
                        f"for {n_pts} points x {ncomp_a} components"
                    )
                pd[name] = vals if ncomp_a == 1 else vals.reshape(n_pts, ncomp_a)

        all_pts.append(pts)
        all_tris.append(tris + n_before if tris.size else tris)
        pd_parts.append(pd)
        n_before += n_pts

    points = np.concatenate(all_pts, axis=0)
    triangles = np.concatenate(all_tris, axis=0) if all_tris else np.zeros((0, 3), np.int32)
    point_data: dict[str, np.ndarray] = {}
    # Keep only arrays present in EVERY piece (a per-piece-only array has no
    # well-defined value on the other pieces' points).
    if pd_parts:
        common = set(pd_parts[0])
        for pd in pd_parts[1:]:
            common &= set(pd)
        for name in pd_parts[0]:
            if name in common:
                point_data[name] = np.concatenate([pd[name] for pd in pd_parts], axis=0)
    return points, np.ascontiguousarray(triangles.astype(np.int32)), point_data


# ----------------------------------------------------------------------
# Writer
# ----------------------------------------------------------------------

def _encode_block(data: bytes, compress: bool) -> str:
    """Encode one binary block as the inline-base64 payload text."""
    hdr_t = np.dtype("<u8")
    if not compress:
        header = np.array([len(data)], hdr_t).tobytes()
        return base64.b64encode(header + data).decode("ascii")
    comp = zlib.compress(data)
    header = np.array([1, len(data), len(data), len(comp)], hdr_t).tobytes()
    # Compressed blocks: header and data are SEPARATE base64 streams.
    return (
        base64.b64encode(header).decode("ascii")
        + base64.b64encode(comp).decode("ascii")
    )


def _format_ascii(arr: np.ndarray) -> str:
    if arr.dtype.kind == "f":
        return " ".join(repr(float(v)) for v in arr.ravel())
    return " ".join(str(int(v)) for v in arr.ravel())


def write_vtp(path, points, triangles, point_data=None, binary=True, compress=False):
    """Write a VTK XML PolyData (``.vtp``) file.

    ``binary=True`` (default) emits inline base64 DataArrays (zlib-compressed
    when ``compress=True``); ``binary=False`` emits ascii.  Output loads in
    VTK/ParaView and round-trips through :func:`read_vtp`.
    """
    points = np.ascontiguousarray(np.asarray(points, np.float64))
    triangles = np.ascontiguousarray(np.asarray(triangles, np.int64))
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {points.shape}")
    if triangles.size == 0:
        triangles = triangles.reshape(0, 3)
    if triangles.ndim != 2 or triangles.shape[1] != 3:
        raise ValueError(f"triangles must be [F, 3], got {triangles.shape}")
    if triangles.size and (triangles.min() < 0 or triangles.max() >= len(points)):
        raise ValueError("triangles index out of range")
    n, f = len(points), len(triangles)
    conn = triangles.reshape(-1)
    offs = (np.arange(f, dtype=np.int64) + 1) * 3

    fmt = "binary" if binary else "ascii"

    def da(name, arr, ncomp):
        xml_t = _NP_TO_XML[arr.dtype]
        attrs = f'type="{xml_t}" NumberOfComponents="{ncomp}" format="{fmt}"'
        if name:
            # point_data keys come from arbitrary upstream files; unescaped
            # " & < would produce a file no XML parser can read back.
            from xml.sax.saxutils import quoteattr

            attrs = f"Name={quoteattr(name)} " + attrs
        body = (
            _encode_block(arr.tobytes(), compress)
            if binary
            else _format_ascii(arr)
        )
        return f"<DataArray {attrs}>\n{body}\n</DataArray>"

    parts = []
    comp_attr = ' compressor="vtkZLibDataCompressor"' if (binary and compress) else ""
    parts.append(
        '<VTKFile type="PolyData" version="1.0" '
        f'byte_order="LittleEndian" header_type="UInt64"{comp_attr}>'
    )
    parts.append("<PolyData>")
    parts.append(
        f'<Piece NumberOfPoints="{n}" NumberOfVerts="0" NumberOfLines="0" '
        f'NumberOfStrips="0" NumberOfPolys="{f}">'
    )
    if point_data:
        parts.append("<PointData>")
        for name, arr in point_data.items():
            arr = np.ascontiguousarray(np.asarray(arr, np.float64))
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
            if arr.reshape(len(arr), -1).shape[0] != n:
                raise ValueError(f"point_data[{name!r}] has wrong length")
            parts.append(da(name, arr, ncomp))
        parts.append("</PointData>")
    parts.append("<Points>")
    parts.append(da(None, points, 3))
    parts.append("</Points>")
    parts.append("<Polys>")
    parts.append(da("connectivity", conn, 1))
    parts.append(da("offsets", offs, 1))
    parts.append("</Polys>")
    parts.append("</Piece>")
    parts.append("</PolyData>")
    parts.append("</VTKFile>")
    with open(path, "w") as fh:
        fh.write("\n".join(parts) + "\n")
