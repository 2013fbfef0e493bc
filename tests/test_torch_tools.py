"""PyTorch port, the converters and the builder CLI: ``tools/`` (artificial,
raw2cells, vtu, flash2cells, chombo, extract_embedded_colormaps),
``builder/__main__.py`` and the ColorMapper's constructors against the
JAX package's on the same seeded inputs.  Every file is compared byte
for byte; the HDF5 converters need h5py and skip without it."""

import io
import zlib

import numpy as np
import pytest

from owlexabrick_tpu.utils.png import write_png as j_write_png
from owlexabrick_tpu_torch.io import formats

from torch_threads import one_torch_thread  # noqa: F401


def _same_files(tmp_path, names):
    for n in names:
        a, b = (tmp_path / "j" / n).read_bytes(), (tmp_path / "p" / n).read_bytes()
        assert a == b, n


def _dirs(tmp_path):
    for s in ("j", "p"):
        (tmp_path / s).mkdir(exist_ok=True)
    return tmp_path / "j", tmp_path / "p"


def test_artificial_cli_bytes(tmp_path):
    from owlexabrick_tpu.tools.artificial import main as j_main
    from owlexabrick_tpu_torch.tools.artificial import main as p_main

    dj, dp = _dirs(tmp_path)
    g = tmp_path / "g.txt"
    g.write_text("0 0 0 6 6 6 0 0 1 2 3 4 5 6 7\n6 0 0 2 2 2 1 4\n"
                 "bad line is skipped\n16 0 0 3 2 5 2 0.5 1 -2 3 4 5 6 7.25\n")
    assert j_main([str(g), "-o", str(dj / "a")]) == 0
    assert p_main([str(g), "--o", str(dp / "a")]) == 0
    _same_files(tmp_path, ["a.cells", "a.scalars"])
    assert p_main([]) == 1


@pytest.mark.parametrize("fmt,dtype", [("float", np.float32),
                                       ("byte", np.uint8),
                                       ("double", np.float64)])
def test_raw2cells_cli_bytes(tmp_path, fmt, dtype):
    from owlexabrick_tpu.tools.raw2cells import main as j_main
    from owlexabrick_tpu_torch.tools.raw2cells import main as p_main

    dj, dp = _dirs(tmp_path)
    rng = np.random.default_rng(0)
    vol = rng.uniform(0, 200, (9, 8, 11))
    vol[:4, :4, :4] = 25
    raw = tmp_path / "v.raw"
    vol.astype(dtype).tofile(raw)
    args = ["11", "8", "9", fmt, str(raw)]
    assert j_main(args + [str(dj / "v"), "0.5", "3"]) == 0
    assert p_main(args + [str(dp / "v"), "0.5", "3", "2"]) == 0
    _same_files(tmp_path, ["v.cells", "v.scalars"])
    assert p_main(args + [str(dp / "v"), "0.5", "3", "4"]) == 1
    assert p_main(["1"]) == 1


def _appended_vtu(path, pts, conn, offs, types, arrays):
    """A zlib-compressed appended-raw VTU (UInt64 headers)."""
    blobs, offsets = [], []
    pos = 0

    def add(arr):
        nonlocal pos
        raw = np.ascontiguousarray(arr).tobytes()
        comp = zlib.compress(raw)
        head = np.asarray([1, len(raw), len(raw), len(comp)], np.uint64)
        blob = head.tobytes() + comp
        offsets.append(pos)
        blobs.append(blob)
        pos += len(blob)

    add(np.asarray(pts, np.float64))
    add(np.asarray(conn, np.int64))
    add(np.asarray(offs, np.int64))
    add(np.asarray(types, np.uint8))
    for v in arrays.values():
        add(np.asarray(v, np.float32))
    cd = "".join(
        f'<DataArray type="Float32" Name="{n}" format="appended" '
        f'offset="{offsets[4 + k]}"/>' for k, n in enumerate(arrays))
    head = (
        '<?xml version="1.0"?>\n<VTKFile type="UnstructuredGrid" '
        'version="1.0" byte_order="LittleEndian" header_type="UInt64" '
        'compressor="vtkZLibDataCompressor">\n<UnstructuredGrid>'
        f'<Piece NumberOfPoints="{len(pts)}" NumberOfCells="{len(types)}">'
        '<Points><DataArray type="Float64" NumberOfComponents="3" '
        f'format="appended" offset="{offsets[0]}"/></Points><Cells>'
        '<DataArray type="Int64" Name="connectivity" format="appended" '
        f'offset="{offsets[1]}"/>'
        '<DataArray type="Int64" Name="offsets" format="appended" '
        f'offset="{offsets[2]}"/>'
        '<DataArray type="UInt8" Name="types" format="appended" '
        f'offset="{offsets[3]}"/></Cells><CellData>{cd}</CellData>'
        '</Piece></UnstructuredGrid>\n<AppendedData encoding="raw">_')
    with open(path, "wb") as f:
        f.write(head.encode() + b"".join(blobs)
                + b"\n</AppendedData>\n</VTKFile>\n")


def _hexes():
    lowers = [(x, y, z) for z in (0, 1) for y in (0, 1) for x in (0, 1)]
    widths = [1] * 8 + [2, 4]
    lowers += [(2, 0, 0), (4, 0, 0)]
    pts, conn = [], []
    cf = 5 * 500 / 4
    for lo, w in zip(lowers, widths):
        base = len(pts)
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    pts.append((np.asarray(lo, float)
                                + np.asarray([dx, dy, dz]) * w) * cf)
        conn += [base + i for i in (0, 1, 3, 2, 4, 5, 7, 6)]
    n = len(lowers)
    return pts, conn, [8 * (i + 1) for i in range(n)], [12] * n


def test_vtu_cli_bytes(tmp_path):
    """Ascii and compressed appended-raw VTUs, one timestep each, through
    both packages' ``vtu`` CLI; and the reader's arrays."""
    from test_end_to_end import _write_vtu_hexes

    from owlexabrick_tpu.tools import vtu as J
    from owlexabrick_tpu_torch.tools import vtu as P

    dj, dp = _dirs(tmp_path)
    rng = np.random.default_rng(1)
    lowers = [(x, y, z) for z in (0, 1) for y in (0, 1) for x in (0, 1)]
    lowers.append((2, 0, 0))
    _write_vtu_hexes(str(tmp_path / "a.vtu"), lowers, [1] * 8 + [2],
                     5 * 500 / 4, {"temp": rng.uniform(0, 1, 9),
                                   "salt": rng.uniform(30, 40, 9)})
    pts, conn, offs, types = _hexes()
    _appended_vtu(str(tmp_path / "b.vtu"), pts, conn, offs, types,
                  {"temp": rng.uniform(0, 1, 10)})
    for name in ("a", "b"):
        assert J.main([str(tmp_path / f"{name}.vtu"), "-o",
                       str(dj / name)]) == 0
        assert P.main([str(tmp_path / f"{name}.vtu"), "-o",
                       str(dp / name)]) == 0
        ra, rb = (J.read_vtu(str(tmp_path / f"{name}.vtu")),
                  P.read_vtu(str(tmp_path / f"{name}.vtu")))
        for x, y in zip(ra[:4], rb[:4]):
            assert np.array_equal(x, y)
        assert ra[4].keys() == rb[4].keys()
    _same_files(tmp_path, ["a.cells", "a.temp.scalars", "a.salt.scalars",
                           "b.cells", "b.temp.scalars"])
    assert P.main([]) == 1


def test_vtk_polydata_to_tris_bytes(tmp_path):
    from owlexabrick_tpu.tools import vtu as J
    from owlexabrick_tpu_torch.tools import vtu as P

    dj, dp = _dirs(tmp_path)
    (tmp_path / "m.vtk").write_text(
        "# vtk DataFile Version 3.0\nmesh\nASCII\nDATASET POLYDATA\n"
        "POINTS 6 float\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n0 0 1\n1 0 0\n"
        "POLYGONS 3 13\n4 0 1 2 3\n3 0 1 4\n3 5 2 4\n")
    (tmp_path / "n.vtk").write_text(
        "# vtk DataFile Version 3.0\nstrip\nASCII\nDATASET POLYDATA\n"
        "POINTS 4 float\n0 0 2\n1 0 2\n0 1 2\n1 1 2\n"
        "TRIANGLE_STRIPS 1 5\n4 0 1 2 3\n")
    paths = [str(tmp_path / "m.vtk"), str(tmp_path / "n.vtk")]
    assert (J.convert_vtk_to_tris(paths, str(dj / "m.tris"))
            == P.convert_vtk_to_tris(paths, str(dp / "m.tris")))
    _same_files(tmp_path, ["m.tris"])


def test_flash2cells_bytes(tmp_path):
    h5py = pytest.importorskip("h5py")
    from owlexabrick_tpu.tools import flash2cells as J
    from owlexabrick_tpu_torch.tools import flash2cells as P

    dj, dp = _dirs(tmp_path)
    nb, n = 3, 4
    h5 = str(tmp_path / "flash.h5")
    with h5py.File(h5, "w") as f:
        f["refine level"] = np.asarray([1, 2, 2])
        f["node type"] = np.asarray([2, 1, 1])  # the root is not a leaf
        bnd = np.zeros((nb, 3, 2))
        bnd[0] = [[0, 8], [0, 8], [0, 8]]
        bnd[1] = [[0, 4], [0, 4], [0, 4]]
        bnd[2] = [[4, 8], [0, 4], [0, 4]]
        f["bounding box"] = bnd
        f["dens"] = np.random.default_rng(2).normal(size=(nb, n, n, n))
        f["flat"] = np.zeros(3)
    assert J.list_variables(h5) == P.list_variables(h5) == ["dens"]
    assert J.main([h5, "--var", "dens", "-o", str(dj / "fl")]) == 0
    assert P.main([h5, "--var", "dens", "-o", str(dp / "fl")]) == 0
    _same_files(tmp_path, ["fl.cells", "fl.scalars"])
    assert P.main([h5, "--list"]) == 0
    assert P.main([h5]) == 1 and P.main([]) == 1


def test_chombo_bytes(tmp_path):
    h5py = pytest.importorskip("h5py")
    from owlexabrick_tpu.tools import chombo as J
    from owlexabrick_tpu_torch.tools import chombo as P

    dj, dp = _dirs(tmp_path)
    n = 4
    h5 = str(tmp_path / "ch.h5")
    rng = np.random.default_rng(3)
    with h5py.File(h5, "w") as f:
        bnd = np.zeros((3, 3, 2))
        bnd[0] = [[0, 1], [0, 1], [0, 1]]
        bnd[1] = [[1, 3], [0, 2], [0, 2]]
        bnd[2] = [[3, 7], [0, 4], [0, 4]]
        f["bounding box"] = bnd
        f["dens"] = rng.uniform(0, 1, (3, n, n, n))
        f["temp"] = rng.uniform(1, 2, (3, n, n, n)).astype(np.float32)
    assert J.main([h5, "-o", str(dj / "ch"), "--vars", "dens,temp,velx"]) == 0
    assert P.main([h5, "-o", str(dp / "ch"), "--vars", "dens,temp,velx"]) == 0
    _same_files(tmp_path, ["ch.cells", "ch.dens", "ch.temp"])
    assert not (dp / "ch.velx").exists()
    with pytest.raises(ValueError):
        P.convert(h5, str(dp / "none"), ("velx",))


@pytest.fixture(scope="module")
def cells_file(tmp_path_factory):
    """Three levels side by side and nested, with duplicates (the same
    anchor at two levels), so every split strategy and the dedup run."""
    from owlexabrick_tpu.tools.artificial import parse_grids_text

    d = tmp_path_factory.mktemp("cells")
    lower, level, _ = parse_grids_text(
        "0 0 0 8 6 5 0 0 1 2 3 4 5 6 7\n8 0 0 4 4 4 1 1\n"
        "0 8 0 2 2 2 2 3\n16 0 0 3 3 3 1 2\n0 0 0 1 1 1 1 9\n")
    formats.write_cells(str(d / "c.cells"), lower, level)
    return d / "c.cells"


@pytest.mark.parametrize("flags", [
    [], ["--no-shift-planes"], ["--spatial-median"], ["--large-bricks"],
    ["--max-leaf-width", "3"], ["--no-planes", "-v", "--parallel"],
])
def test_builder_cli_bytes(tmp_path, cells_file, flags):
    """The port's builder CLI (native core, and the numpy builder with
    --python) writes the JAX CLI's .bricks and .kd byte for byte."""
    from owlexabrick_tpu.builder.__main__ import main as j_main
    from owlexabrick_tpu_torch.builder.__main__ import main as p_main

    dj, dp = _dirs(tmp_path)
    assert j_main([str(cells_file), "-o", str(dj / "b.bricks"), "-kd",
                   str(dj / "b.kd")] + flags) == 0
    for extra, kd in (([], "-kd"), (["--python"], "--kd")):
        assert p_main([str(cells_file), "-o", str(dp / "b.bricks"), kd,
                       str(dp / "b.kd")] + flags + extra) == 0
        _same_files(tmp_path, ["b.bricks", "b.kd"])


def test_builder_cli_errors(tmp_path, cells_file):
    from owlexabrick_tpu_torch.builder.__main__ import main as p_main

    with pytest.raises(SystemExit, match="no input"):
        p_main(["-o", str(tmp_path / "x.bricks")])
    with pytest.raises(SystemExit, match="no output"):
        p_main([str(cells_file)])
    with pytest.raises(SystemExit, match="un-recognized"):
        p_main([str(cells_file), "--frobnicate"])


def _strip_png(rgb):
    buf = io.BytesIO()
    j_write_png(buf, rgb)
    return buf.getvalue()


def test_colormapper_constructors_match():
    from owlexabrick_tpu.viewer.colormaps import ColorMapper as JC
    from owlexabrick_tpu_torch.viewer.colormaps import ColorMapper as PC
    from owlexabrick_tpu_torch.viewer.colormaps import colormap_colors

    t = np.linspace(-0.1, 1.1, 301)
    text = ("0.0,(0,0,0.6)\n 0.35 , ( 0 , 0.8 , 0.9 ) ;0.7,(1,0.9,0)\n\n"
            "1.0,(0.8,0,1e-1)")
    assert np.array_equal(JC.from_string(text)(t), PC.from_string(text)(t))
    cols = [(0, 0, 0), (1, 0.5, 0), (0.2, 0.4, 1.0)]
    assert np.array_equal(JC.from_colors(cols)(t), PC.from_colors(cols)(t))
    rgb = np.random.default_rng(4).integers(0, 256, (1, 37, 4)).astype(
        np.uint8)
    buf = _strip_png(rgb)
    assert np.array_equal(JC.from_png_bytes(buf).sample(128),
                          PC.from_png_bytes(buf).sample(128))
    assert np.array_equal(colormap_colors(PC.from_string(text), 128),
                          JC.from_string(text).sample(128))
    for bad in ("0.0,(1,2)", "x"):
        with pytest.raises(ValueError):
            PC.from_string(bad)
    with pytest.raises(ValueError):
        PC.from_string("0.5,(1,1,1)")


def test_extract_embedded_colormaps_matches(tmp_path):
    """A header of three embedded PNG strips: both packages decode the
    same strips and emit the same palette module."""
    from owlexabrick_tpu.tools import extract_embedded_colormaps as J
    from owlexabrick_tpu_torch.tools import extract_embedded_colormaps as P

    rng = np.random.default_rng(5)
    text = "// generated\n"
    for sym, _ in J.SYMBOL_NAMES:
        data = _strip_png(rng.integers(0, 256, (1, 16, 3)).astype(np.uint8))
        text += (f"static uint8_t {sym}[] = {{"
                 + ", ".join(f"0x{b:02x}" for b in data) + "};\n")
    header = tmp_path / "embedded_colormaps.h"
    header.write_text(text)
    a, b = J.decode_strips(str(header)), P.decode_strips(str(header))
    assert list(a) == list(b)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert P.main(["x", str(header), str(tmp_path / "p.py")]) == 0
    J.emit_module(a, str(tmp_path / "j.py"))
    assert (tmp_path / "j.py").read_bytes() == (tmp_path / "p.py").read_bytes()
    assert P.main(["x"]) == 1
