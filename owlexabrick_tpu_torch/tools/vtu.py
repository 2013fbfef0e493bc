"""Pure-python VTK readers + the LANL-ocean converter (the port's copy of
``owlexabrick_tpu/tools/vtu.py``).

The reference links against VTK for two small tools (readVTU.cpp: VTU
hexahedra -> cells; fromVTK.cpp: polydata -> .tris).  VTK is not in this
environment, so this module includes a minimal dependency-free reader for
the subset those tools need:

  * XML .vtu UnstructuredGrid — ascii, inline-base64, and appended-raw
    data arrays, optional zlib compression, UInt32/UInt64 headers
  * legacy ASCII .vtk PolyData — POINTS + POLYGONS

convert_lanl_ocean mirrors readVTU.cpp: every hexahedron must be an
axis-aligned cube whose corners are multiples of a common factor
(5*500/4 for the deep-water set); emits .cells plus one .scalars file per
cell-data array.
"""

from __future__ import annotations

import base64
import struct
import sys
import xml.etree.ElementTree as ET
import zlib
from typing import Dict, List

import numpy as np

from ..io import formats
from ..core.types import TriangleMesh

_VTK_DTYPES = {
    "Float32": np.float32, "Float64": np.float64,
    "Int8": np.int8, "UInt8": np.uint8,
    "Int16": np.int16, "UInt16": np.uint16,
    "Int32": np.int32, "UInt32": np.uint32,
    "Int64": np.int64, "UInt64": np.uint64,
}

VTK_HEXAHEDRON = 12


def _decode_appended(buf: bytes, offset: int, dtype, header_dtype,
                     compressed: bool) -> np.ndarray:
    hsize = np.dtype(header_dtype).itemsize
    if not compressed:
        (nbytes,) = np.frombuffer(buf, header_dtype, 1, offset)
        start = offset + hsize
        return np.frombuffer(buf, dtype, int(nbytes) // np.dtype(dtype).itemsize, start)
    # compressed header: [nblocks, blocksize, lastsize, sizes...]
    nblocks = int(np.frombuffer(buf, header_dtype, 1, offset)[0])
    head = np.frombuffer(buf, header_dtype, 3 + nblocks, offset)
    sizes = head[3:]
    pos = offset + (3 + nblocks) * hsize
    raw = b""
    for s in sizes:
        raw += zlib.decompress(buf[pos : pos + int(s)])
        pos += int(s)
    return np.frombuffer(raw, dtype)


def _read_data_array(elem, appended: bytes, header_dtype, compressed):
    dtype = _VTK_DTYPES[elem.get("type")]
    fmt = elem.get("format", "ascii")
    if fmt == "ascii":
        return np.asarray((elem.text or "").split(), dtype=dtype)
    if fmt == "binary":
        data = base64.b64decode("".join((elem.text or "").split()))
        hsize = np.dtype(header_dtype).itemsize
        if compressed:
            # header block is base64'd separately; handle the common
            # single-block case
            nblocks = int(np.frombuffer(data, header_dtype, 1, 0)[0])
            head_len = (3 + nblocks) * hsize
            head = np.frombuffer(data, header_dtype, 3 + nblocks, 0)
            # the payload starts at the next 4-byte base64 boundary of the
            # original stream; re-decode conservatively
            raw = b"".join(
                zlib.decompress(data[head_len:])
                for _ in range(1)
            )
            return np.frombuffer(raw, dtype)
        (nbytes,) = np.frombuffer(data, header_dtype, 1, 0)
        return np.frombuffer(data, dtype, int(nbytes) // np.dtype(dtype).itemsize, hsize)
    if fmt == "appended":
        off = int(elem.get("offset", "0"))
        return _decode_appended(appended, off, dtype, header_dtype, compressed)
    raise ValueError(f"unsupported DataArray format {fmt}")


def read_vtu(path: str):
    """Returns (points (P,3) f64, cell_types (C,), connectivity, offsets,
    cell_data: dict name -> (C,) array)."""
    text = open(path, "rb").read()
    # appended raw section is not valid XML; split it off
    appended = b""
    marker = text.find(b'<AppendedData encoding="raw">')
    if marker >= 0:
        start = text.find(b"_", marker) + 1
        end = text.rfind(b"</AppendedData>")
        appended = text[start:end]
        text = text[: start - 1].split(b'<AppendedData encoding="raw">')[0] \
            + b"<AppendedData encoding=\"raw\"></AppendedData></VTKFile>"
    root = ET.fromstring(text)
    header_dtype = _VTK_DTYPES.get(root.get("header_type", "UInt32"))
    compressed = root.get("compressor") is not None
    byte_order = root.get("byte_order", "LittleEndian")
    if byte_order != "LittleEndian":
        raise ValueError("big-endian VTU not supported")

    piece = root.find(".//Piece")
    pts_elem = piece.find("Points/DataArray")
    points = np.asarray(
        _read_data_array(pts_elem, appended, header_dtype, compressed),
        np.float64,
    ).reshape(-1, 3)

    cells = piece.find("Cells")
    arrays = {e.get("Name"): e for e in cells.findall("DataArray")}
    conn = _read_data_array(arrays["connectivity"], appended, header_dtype,
                            compressed).astype(np.int64)
    offs = _read_data_array(arrays["offsets"], appended, header_dtype,
                            compressed).astype(np.int64)
    types = _read_data_array(arrays["types"], appended, header_dtype,
                             compressed).astype(np.int64)

    cell_data: Dict[str, np.ndarray] = {}
    cd = piece.find("CellData")
    if cd is not None:
        for e in cd.findall("DataArray"):
            cell_data[e.get("Name")] = np.asarray(
                _read_data_array(e, appended, header_dtype, compressed),
                np.float32,
            )
    return points, types, conn, offs, cell_data


def convert_lanl_ocean(paths: List[str], out_base: str,
                       common_factor: float = 5 * 500 / 4) -> int:
    """VTU hexes -> .cells + per-array .scalars (readVTU.cpp:100-302)."""
    lowers, levels = [], []
    scalar_accum: Dict[str, List[np.ndarray]] = {}
    for path in paths:
        points, types, conn, offs, cell_data = read_vtu(path)
        starts = np.concatenate([[0], offs[:-1]])
        hex_mask = types == VTK_HEXAHEDRON
        idx = np.stack(
            [conn[starts[hex_mask] + k] for k in range(8)], axis=1
        )  # (C, 8)
        corners = points[idx]  # (C, 8, 3)
        lo = corners.min(axis=1)
        hi = corners.max(axis=1)
        width = hi - lo
        if not np.allclose(width, width[:, :1], rtol=1e-6):
            raise ValueError("hex is not an axis-aligned cube")
        gi_lo = lo / common_factor
        gi = np.round(gi_lo)
        if not np.allclose(gi, gi_lo, atol=1e-6):
            raise ValueError("hex corner not a multiple of the common factor")
        w = np.round(width[:, 0] / common_factor).astype(np.int64)
        level = np.round(np.log2(np.maximum(w, 1))).astype(np.int32)
        if ((1 << level) != w).any():
            raise ValueError("hex width is not a power-of-two multiple")
        lowers.append(gi.astype(np.int32))
        levels.append(level)
        for name, vals in cell_data.items():
            scalar_accum.setdefault(name, []).append(
                vals[hex_mask].astype(np.float32)
            )

    lower = np.concatenate(lowers)
    level = np.concatenate(levels)
    formats.write_cells(out_base + ".cells", lower, level)
    for name, chunks in scalar_accum.items():
        formats.write_scalars(out_base + "." + name + ".scalars",
                              np.concatenate(chunks))
    print(
        f"#exa: lanl-ocean wrote {lower.shape[0]} cells and "
        f"{len(scalar_accum)} scalar arrays to {out_base}.*"
    )
    return lower.shape[0]


# ----------------------------------------------------------------------------
# legacy ASCII .vtk polydata -> .tris (tools/fromVTK/fromVTK.cpp)
# ----------------------------------------------------------------------------

def read_vtk_polydata(path: str) -> TriangleMesh:
    verts: List[List[float]] = []
    tris: List[List[int]] = []
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    n = len(tokens)
    while i < n:
        t = tokens[i].upper()
        if t == "POINTS":
            count = int(tokens[i + 1])
            i += 3
            for k in range(count):
                verts.append([float(tokens[i + 3 * k + j]) for j in range(3)])
            i += 3 * count
        elif t in ("POLYGONS", "TRIANGLE_STRIPS"):
            count = int(tokens[i + 1])
            i += 3
            for _ in range(count):
                m = int(tokens[i])
                poly = [int(tokens[i + 1 + j]) for j in range(m)]
                i += m + 1
                # fan-triangulate (tris and quads in the reference)
                for j in range(1, m - 1):
                    tris.append([poly[0], poly[j], poly[j + 1]])
        else:
            i += 1
    return TriangleMesh(
        vertices=np.asarray(verts, np.float32),
        indices=np.asarray(tris, np.int32).reshape(-1, 3),
    )


def convert_vtk_to_tris(paths: List[str], out_path: str) -> int:
    """Polydata -> .tris with vertex dedup (fromVTK.cpp)."""
    meshes = []
    for p in paths:
        m = read_vtk_polydata(p)
        # dedup vertices
        v, inv = np.unique(m.vertices, axis=0, return_inverse=True)
        meshes.append(
            TriangleMesh(vertices=v, indices=inv[m.indices].astype(np.int32))
        )
    formats.write_tris(out_path, meshes)
    total = sum(m.indices.shape[0] for m in meshes)
    print(f"#exa: wrote {len(meshes)} meshes, {total} triangles to {out_path}")
    return total


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: exa-vtu <in.vtu...> -o outbase   (LANL ocean hexes)")
        return 1
    out = "lanl"
    paths = []
    i = 0
    while i < len(argv):
        if argv[i] == "-o":
            out = argv[i + 1]
            i += 2
        else:
            paths.append(argv[i])
            i += 1
    convert_lanl_ocean(paths, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
