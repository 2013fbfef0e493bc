"""PyTorch port, file formats and host utils: ``io/`` (formats,
expression, config, xf_file), ``utils/png.py``'s writer, ``utils/text.py``
and ``utils/profiling.py`` against the JAX package's on the same seeded
inputs.  Files are compared byte for byte, read arrays exactly."""

import io as _io

import numpy as np
import pytest

from owlexabrick_tpu.core.types import TriangleMesh as JMesh
from owlexabrick_tpu.io import config as J_config
from owlexabrick_tpu.io import formats as J
from owlexabrick_tpu.io import xf_file as J_xf
from owlexabrick_tpu.io.expression import evaluate_postfix as j_postfix
from owlexabrick_tpu.utils import png as J_png
from owlexabrick_tpu_torch.core.types import TriangleMesh as PMesh
from owlexabrick_tpu_torch.io import config as P_config
from owlexabrick_tpu_torch.io import formats as P
from owlexabrick_tpu_torch.io import xf_file as P_xf
from owlexabrick_tpu_torch.io.expression import evaluate_postfix as p_postfix
from owlexabrick_tpu_torch.utils import png as P_png

from torch_threads import one_torch_thread  # noqa: F401


def _pair(tmp_path, name, write_j, write_p):
    """Write one file with each package; returns (jax path, port path)
    after asserting their bytes are equal."""
    pj, pp = tmp_path / f"j_{name}", tmp_path / f"p_{name}"
    write_j(str(pj))
    write_p(str(pp))
    assert pj.read_bytes() == pp.read_bytes(), name
    return str(pj), str(pp)


def _bricks_inputs(rng):
    sizes = rng.integers(1, 4, (5, 3)).astype(np.int32)
    lowers = rng.integers(-8, 64, (5, 3)).astype(np.int32)
    levels = rng.integers(0, 3, 5).astype(np.int32)
    ids = [rng.integers(-1, 200, int(np.prod(s))).astype(np.int32)
           for s in sizes]
    return lowers, sizes, levels, ids


def test_cells_and_scalars_bytes_and_readback(tmp_path):
    rng = np.random.default_rng(0)
    lower = rng.integers(-100, 1000, (257, 3))
    level = rng.integers(0, 5, 257)
    vals = rng.normal(size=257)
    pj, pp = _pair(tmp_path, "c.cells", lambda p: J.write_cells(p, lower, level),
                   lambda p: P.write_cells(p, lower, level))
    for a, b in zip(J.read_cells(pj), P.read_cells(pp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pj, pp = _pair(tmp_path, "s.scalars", lambda p: J.write_scalars(p, vals),
                   lambda p: P.write_scalars(p, vals))
    assert np.array_equal(J.read_scalars(pj), P.read_scalars(pp))
    with pytest.raises(ValueError):
        P.write_cells(str(tmp_path / "bad.cells"), lower, level[:-1])


def test_bricks_bytes_and_readback(tmp_path):
    lowers, sizes, levels, ids = _bricks_inputs(np.random.default_rng(1))
    pj, pp = _pair(
        tmp_path, "b.bricks",
        lambda p: J.write_bricks(p, lowers, sizes, levels, ids),
        lambda p: P.write_bricks(p, lowers, sizes, levels, ids))
    (jb, jid), (pb, pid) = J.read_bricks(pj), P.read_bricks(pp)
    for f in ("lower", "size", "level", "begin"):
        a, b = getattr(jb, f), getattr(pb, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(jid, pid)
    # the reference loader's checks: a truncated record and a cellID < -1
    raw = np.fromfile(pp, np.int32)
    raw[:-1].tofile(str(tmp_path / "trunc.bricks"))
    with pytest.raises(ValueError):
        P.read_bricks(str(tmp_path / "trunc.bricks"))
    raw[7] = -2
    raw.tofile(str(tmp_path / "neg.bricks"))
    with pytest.raises(ValueError):
        P.read_bricks(str(tmp_path / "neg.bricks"))
    with pytest.raises(ValueError):
        P.write_bricks(str(tmp_path / "x.bricks"), lowers, sizes, levels,
                       [i[:-1] for i in ids])


def test_tris_bytes_and_readback(tmp_path):
    rng = np.random.default_rng(2)
    meshes = []
    for nv, nt in ((4, 2), (9, 7)):
        meshes.append((rng.normal(size=(nv, 3)).astype(np.float32),
                       rng.integers(0, nv, (nt, 3)).astype(np.int32)))
    pj, pp = _pair(
        tmp_path, "m.tris",
        lambda p: J.write_tris(p, [JMesh(v, t) for v, t in meshes]),
        lambda p: P.write_tris(p, [PMesh(v, t) for v, t in meshes]))
    for a, b in zip(J.read_tris(pj), P.read_tris(pp)):
        assert np.array_equal(a.vertices, b.vertices)
        assert np.array_equal(a.indices, b.indices)


def test_kd_bytes_and_readback(tmp_path):
    rng = np.random.default_rng(3)
    n = 33
    args = (rng.integers(0, 4, n).astype(np.int32),
            rng.integers(-50, 5000, n).astype(np.int32),
            rng.integers(0, 1 << 30, n).astype(np.int32),
            rng.integers(0, 6, n).astype(np.int32))
    assert np.array_equal(J.pack_kd_nodes(*args), P.pack_kd_nodes(*args))
    pj, pp = _pair(tmp_path, "t.kd",
                   lambda p: J.write_kd(p, J.pack_kd_nodes(*args)),
                   lambda p: P.write_kd(p, P.pack_kd_nodes(*args)))
    a, b = J.read_kd(pj), P.read_kd(pp)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("tokens,nf", [
    (["%0", "%1", "+"], 2),
    (["%0", "%1", "-", "%1", "*", "3", "/"], 2),
    (["%0", "2", ">", "%0", "-1", "select"], 1),
    (["%0", "%1", "==", "%0", "%1", "!=", "<=", "1", ">="], 2),
    (["%0", "sqrt", "%1", "abs", "log", "**"], 2),
    (['"%0', "0.5", '**"'], 1),
    (["2.5"], 3),
])
def test_evaluate_postfix_matches(tokens, nf):
    rng = np.random.default_rng(4)
    fields = [rng.uniform(-2, 5, 17).astype(np.float32) for _ in range(nf)]
    a, b = j_postfix(tokens, fields), p_postfix(tokens, fields)
    assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("tokens", [
    ["%0", "+"], ["%5"], [], ['""'], ["%0", "%0"], ["1", "2", "select"],
    ["log"],
])
def test_evaluate_postfix_errors_match(tokens):
    f = [np.zeros(2, np.float32)]
    with pytest.raises(ValueError) as ej:
        j_postfix(tokens, f)
    with pytest.raises(ValueError) as ep:
        p_postfix(tokens, f)
    assert str(ej.value) == str(ep.value)


def test_parse_config_matches(tmp_path):
    """A .exa with two scalar files and value ranges, an expression
    field, a vector magnitude, a mesh and a remap: every Config field,
    ``voxel_from_world``, ``world_bounds`` and ``voxel_bounds`` equal."""
    rng = np.random.default_rng(5)
    lowers, sizes, levels, _ = _bricks_inputs(rng)
    n = int(sum(np.prod(s) for s in sizes))
    ids = np.arange(n, dtype=np.int32)
    splits = np.cumsum([int(np.prod(s)) for s in sizes])[:-1]
    J.write_bricks(str(tmp_path / "a.bricks"), lowers, sizes, levels,
                   np.split(ids, splits))
    for name in ("f0", "f1", "vx", "vy", "vz"):
        J.write_scalars(str(tmp_path / f"{name}.scalars"),
                        rng.uniform(-1, 3, n))
    J.write_tris(str(tmp_path / "m.tris"),
                 [JMesh(rng.normal(size=(3, 3)).astype(np.float32),
                        np.asarray([[0, 1, 2]], np.int32))])
    (tmp_path / "s.exa").write_text(
        "# a comment line\n"
        "bricks a.bricks  # trailing comment\n"
        "scalar rho f0.scalars\nvalue_range -1 2.5\n"
        "scalar t f1.scalars\n"
        'scalar mix expr "%0 %1 * 2 +"\n'
        "vector vel vx.scalars vy.scalars vz.scalars\nvalue_range 0 4\n"
        "triangles m.tris\n"
        "remap_from 0 0 0 64 64 64\nremap_to -1 -2 -3 1 2 3\n")
    a = J_config.parse_config(str(tmp_path / "s.exa"))
    b = P_config.parse_config(str(tmp_path / "s.exa"))
    for f in ("lower", "size", "level", "begin"):
        assert np.array_equal(getattr(a.bricks, f), getattr(b.bricks, f))
    assert np.array_equal(a.cell_ids, b.cell_ids)
    assert [f.name for f in a.scalar_fields] == [f.name for f in
                                                 b.scalar_fields]
    for fa, fb in zip(a.scalar_fields, b.scalar_fields):
        assert np.array_equal(fa.values, fb.values), fa.name
        assert fa.value_range == fb.value_range, fa.name
    assert len(a.surfaces) == len(b.surfaces) == 1
    assert np.array_equal(a.surfaces[0].vertices, b.surfaces[0].vertices)
    for x, y in zip(a.remap_from + a.remap_to, b.remap_from + b.remap_to):
        assert np.array_equal(x, y)
    assert np.array_equal(a.voxel_from_world(), b.voxel_from_world())
    for x, y in zip(a.world_bounds() + a.voxel_bounds(),
                    b.world_bounds() + b.voxel_bounds()):
        assert np.array_equal(x, y)
    (tmp_path / "bad.exa").write_text("value_range 0 1\n")
    with pytest.raises(ValueError):
        P_config.parse_config(str(tmp_path / "bad.exa"))
    (tmp_path / "bad2.exa").write_text("bricks a.bricks\nfrobnicate\n")
    with pytest.raises(ValueError, match="unknown token"):
        P_config.parse_config(str(tmp_path / "bad2.exa"))


def test_xf_file_and_camera_echo(tmp_path):
    rng = np.random.default_rng(6)
    alphas = rng.uniform(0, 1, 128)
    pj, pp = _pair(tmp_path, "t.xf", lambda p: J_xf.write_xf(p, alphas),
                   lambda p: P_xf.write_xf(p, alphas))
    assert np.array_equal(J_xf.read_xf(pj), P_xf.read_xf(pp))
    with pytest.raises(ValueError):
        P_xf.write_xf(str(tmp_path / "short.xf"), alphas[:-1])
    (tmp_path / "short.xf").write_bytes(b"\0" * 12)
    with pytest.raises(ValueError):
        P_xf.read_xf(str(tmp_path / "short.xf"))
    args = ([20, 15.5, -25e-3], np.asarray([4, 3, 3.125]), (0, 1, 0))
    assert J_xf.camera_echo(*args) == P_xf.camera_echo(*args)


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3), (5, 4, 4), (1, 33, 4)])
def test_write_png_bytes_match(shape):
    img = np.random.default_rng(7).integers(0, 256, shape).astype(np.uint8)
    a, b = _io.BytesIO(), _io.BytesIO()
    J_png.write_png(a, img)
    P_png.write_png(b, img)
    assert a.getvalue() == b.getvalue()
    b.seek(0)
    back = P_png.read_png(b)
    assert np.array_equal(back.reshape(img.shape), img)
    with pytest.raises(ValueError):
        P_png.write_png(_io.BytesIO(), img.astype(np.float32))


def test_text_and_profiling_utils():
    """``utils/text.py`` draws the JAX package's pixels (PIL here);
    ``utils/profiling.py``: FrameStats' bench line and
    ``cost_heatmap``."""
    from owlexabrick_tpu.utils import profiling as J_prof
    from owlexabrick_tpu.utils import text as J_text
    from owlexabrick_tpu_torch.utils import profiling as P_prof
    from owlexabrick_tpu_torch.utils import text as P_text

    for c in (3, 4):
        a = np.zeros((20, 40, c), np.uint8)
        b = a.copy()
        J_text.draw_text(a, "0.25 exa", 2, 4, scale=2)
        P_text.draw_text(b, "0.25 exa", 2, 4, scale=2)
        assert np.array_equal(a, b)
    assert J_text.text_size("7.5") == P_text.text_size("7.5")
    iters = np.arange(40, dtype=np.float32).reshape(5, 8)
    assert np.array_equal(J_prof.cost_heatmap(iters, 0.03),
                          P_prof.cost_heatmap(iters, 0.03))
    stats = P_prof.FrameStats(bench_frames=3)
    msgs = [stats.tick() for _ in range(4)]
    assert msgs[:3] == [None] * 3 and msgs[3].startswith(
        "#exa: bench avg over 3 frames")
