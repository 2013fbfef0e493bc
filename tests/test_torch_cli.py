"""PyTorch port, the offline viewer CLI: ``owlexabrick_tpu_torch.viewer.
offline`` (``--device cpu``) against the JAX package's CLI on the same
scene directory and command line, under the golden gate (every pixel
within 1/255, at least 99% bit-exact): the exact path (with the colour
bar, the default camera and the TF domain from the config's
``value_range``), the ``--dump-xf`` / ``--xf`` round trip, and the
stored goldens of ``tests/test_end_to_end.py`` rebuilt through the
port's own converters, builder CLI and viewer CLI.  The ``--fast``
branches are in ``test_torch_cli_fast.py``."""

import pathlib

import numpy as np
import pytest

from owlexabrick_tpu_torch.utils.png import golden_gate, read_png

from torch_threads import one_torch_thread  # noqa: F401

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
CAM = ["--camera", "20", "15", "25", "4", "3", "3", "0", "1", "0",
       "--fov", "45"]


def make_scene_dir(d, grids="0 0 0 6 6 6 0 0 1 2 3 4 5 6 7\n"
                            "6 0 0 2 2 2 1 4\n"):
    """artificial grids -> the port's builder CLI -> a two-field .exa
    (density and 7 - density, each with its value_range)."""
    from owlexabrick_tpu_torch.builder.__main__ import main as build_main
    from owlexabrick_tpu_torch.io import formats
    from owlexabrick_tpu_torch.tools.artificial import generate

    (d / "g.grids").write_text(grids)
    generate(str(d / "g.grids"), str(d / "d"))
    assert build_main([str(d / "d.cells"), "-o", str(d / "d.bricks")]) == 0
    dens = formats.read_scalars(str(d / "d.scalars"))
    formats.write_scalars(str(d / "inv.scalars"), 7.0 - dens)
    (d / "scene.exa").write_text(
        "bricks d.bricks\nscalar density d.scalars\nvalue_range 0 7\n"
        "scalar inv inv.scalars\nvalue_range 0 7\n")
    (d / "one.exa").write_text(
        "bricks d.bricks\nscalar density d.scalars\nvalue_range 0 7\n")
    return d


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_scene_dir(tmp_path_factory.mktemp("cli"))


def run_both(tmp_path, args, name="out.png"):
    """The JAX CLI and the port's CLI (``--device cpu``) on the same
    command line; returns (jax image, port image, port stdout lines)."""
    import contextlib
    import io

    from owlexabrick_tpu.viewer.offline import main as j_main
    from owlexabrick_tpu_torch.viewer.offline import main as p_main

    (tmp_path / "j").mkdir(exist_ok=True)
    (tmp_path / "p").mkdir(exist_ok=True)
    outs = []
    for sub, fn, extra in (("j", j_main, []), ("p", p_main,
                                               ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn(args + ["-o", str(tmp_path / sub / name)] + extra) == 0
        outs.append(buf.getvalue().splitlines())
    assert [l for l in outs[0] if "FPS" not in l and "wrote" not in l] == \
        [l for l in outs[1] if "FPS" not in l and "wrote" not in l]
    return (read_png(str(tmp_path / "j" / name)),
            read_png(str(tmp_path / "p" / name)), outs[1])


def assert_gate(got, want, what):
    ok, mx, exact = golden_gate(got, want)
    assert ok, f"{what}: max diff {mx}, exact {exact:.4f}"
    assert (got[..., :3] > 8).any(), f"{what}: blank"


def test_cli_exact_colorbar(scene_dir, tmp_path):
    """The exact path with the colour bar, and the default camera with
    no --range (the TF domain from value_range)."""
    a, b, lines = run_both(tmp_path, [
        str(scene_dir / "scene.exa"), "--size", "32", "24", *CAM,
        "--range", "0", "7", "--dt", "1.0", "--frames", "2",
        "--colorbar", "on"])
    assert b.shape == (24, 32, 4)
    assert_gate(b, a, "exact --colorbar")
    assert any(l.startswith("#viewer: --camera 20 15 25") for l in lines)
    a, b, _ = run_both(tmp_path, [str(scene_dir / "scene.exa"), "--size",
                                  "32", "24", "--dt", "1.0", "--frames", "1"],
                       "default.png")
    assert_gate(b, a, "default camera")


def test_cli_dump_xf_roundtrip(scene_dir, tmp_path):
    """--dump-xf writes the JAX CLI's .xf bytes; --xf reads it back into
    the same frame; an unknown flag is rejected."""
    from owlexabrick_tpu_torch.viewer.offline import main

    base = [str(scene_dir / "scene.exa"), "--size", "8", "8", "--frames",
            "1", "--dt", "1.0"]
    run_both(tmp_path, base + ["--dump-xf", str(tmp_path / "t.xf")])
    j_xf = (tmp_path / "t.xf").read_bytes()
    assert main(base + ["--dump-xf", str(tmp_path / "p.xf"), "-o",
                        str(tmp_path / "x.png"), "--device", "cpu"]) == 0
    assert (tmp_path / "p.xf").read_bytes() == j_xf and len(j_xf) == 512
    a, b, _ = run_both(tmp_path, base + ["--xf", str(tmp_path / "p.xf"),
                                         "--xf-scale", "2"], "xf.png")
    assert_gate(b, a, "--xf")
    with pytest.raises(SystemExit):
        main([str(scene_dir / "scene.exa"), "--frobnicate"])
    with pytest.raises(SystemExit):
        main(["--size", "8", "8"])
    with pytest.raises(SystemExit, match="invalid value"):
        main([str(scene_dir / "scene.exa"), "--ao", "maybe"])


@pytest.mark.parametrize("multi_field", [False, True])
def test_scene_from_config_and_rays_match(scene_dir, multi_field):
    """What the CLI builds first: ``scene_from_config`` (the region value
    ranges over channel 0, or over every field in multi-field DVR) and
    ``Camera.rays`` (the heat map's rays), equal to the JAX package's."""
    import dataclasses

    from test_torch_scene import _assert_same

    from owlexabrick_tpu.io.config import parse_config as j_parse
    from owlexabrick_tpu.render.camera import Camera as JCamera
    from owlexabrick_tpu.render.scene import scene_from_config as j_scene
    from owlexabrick_tpu_torch.io.config import parse_config
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.scene import scene_from_config

    exa = str(scene_dir / "scene.exa")
    ref, ref_r, _ = j_scene(j_parse(exa), multi_field_dvr=multi_field)
    got, got_r, _ = scene_from_config(parse_config(exa),
                                      multi_field_dvr=multi_field,
                                      device="cpu")
    _assert_same(ref_r, got_r)
    host = got.host_arrays()
    for f in dataclasses.fields(ref):
        _assert_same(getattr(ref, f.name), host[f.name], f.name)
    args = ([20, 15, 25], [4, 3, 3], [0, 1, 0], 45.0, 32, 24)
    jit = np.random.default_rng(8).uniform(0, 1, (24, 32, 2))
    for j in (None, jit):
        for a, b in zip(JCamera.look_at(*args).rays(32, 24, j),
                        Camera.look_at(*args).rays(32, 24, j)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cli_heatmap_bench_overlays(scene_dir, tmp_path, monkeypatch):
    """--heatmap (the exact march's region iterations in red, through
    ``Camera.rays``), --display-string, --custom-colormap and --no-pg;
    then --bench's numbered screenshot and its FrameStats line."""
    a, b, _ = run_both(tmp_path, [
        str(scene_dir / "scene.exa"), "--size", "32", "24", *CAM,
        "--dt", "1.0", "--no-pg", "--heatmap", "0.05",
        "--display-string", "exa", "--custom-colormap",
        "0,(0,0,1);1,(1,0,0)"], "heat.png")
    assert_gate(b, a, "--heatmap")
    assert b[..., 0].max() > 0
    import contextlib
    import io

    from owlexabrick_tpu.viewer.offline import main as j_main
    from owlexabrick_tpu_torch.viewer.offline import main as p_main

    shots = []
    for sub, fn, extra in (("jb", j_main, []),
                           ("pb", p_main, ["--device", "cpu"])):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn([str(scene_dir / "scene.exa"), "--size", "16", "12",
                       *CAM, "--dt", "1.0", "--bench", "2"] + extra) == 0
        assert "#exa: bench avg over 2 frames" in buf.getvalue()
        shots.append(read_png("bench_screenshot00000002.png"))
    assert shots[1].shape == (12, 16, 4)
    assert_gate(shots[1], shots[0], "--bench")


def test_cli_cuda_without_card_raises(scene_dir, tmp_path):
    """The CLI renders on the card unless asked for the CPU: without a
    card, the default device raises instead of falling back."""
    import torch

    from owlexabrick_tpu_torch.viewer.offline import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        main([str(scene_dir / "scene.exa"), "--size", "8", "8", "-o",
              str(tmp_path / "x.png")])


def test_cli_full_scene_golden(tmp_path):
    """``tests/test_end_to_end.py::test_full_scene_cli_golden`` through
    the port alone: an expression field, a mesh, iso, a contour plane
    and the tracer in one CLI run, against the stored golden."""
    from owlexabrick_tpu_torch.core.types import TriangleMesh
    from owlexabrick_tpu_torch.io import formats
    from owlexabrick_tpu_torch.viewer.offline import main

    d = make_scene_dir(tmp_path, "0 0 0 6 6 6 0 0 1 2 3 4 5 6 7\n"
                                 "6 0 0 2 2 2 1 4\n")
    v = np.asarray([[0.5, 0.5, 5.5], [7.5, 0.5, 4.5], [7.5, 7.5, 4.5],
                    [0.5, 7.5, 5.5]], np.float32)
    formats.write_tris(str(d / "m.tris"), [TriangleMesh(
        vertices=v, indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))])
    (d / "full.exa").write_text(
        "bricks d.bricks\nscalar density d.scalars\nvalue_range 0 7\n"
        "scalar inv inv.scalars\nvalue_range 0 7\n"
        'scalar combo expr "%0 %1 +"\ntriangles m.tris\n'
        "remap_from 0 0 0 8 8 8\nremap_to 0 0 0 8 8 8\n")
    out = str(tmp_path / "full.png")
    assert main([
        str(d / "full.exa"), "--size", "48", "36", *CAM, "--range", "0",
        "7", "--dt", "0.7", "--isovals", "3.5", "--isochans", "0",
        "--contourplane", "0", "0", "1", "0.4", "--contourchan", "0",
        "--tracer", "3", "--tracer-channels", "0", "1", "2",
        "--tracer-seeds", "16", "--tracer-steplen", "0.5", "--frames", "2",
        "-o", out, "--device", "cpu"]) == 0
    assert_gate(read_png(out), read_png(str(GOLDEN_DIR / "e2e_full_cli.png")),
                "e2e_full_cli")


def test_cli_vtu_series_goldens(tmp_path):
    """``tests/test_end_to_end.py::test_vtu_time_series`` through the
    port alone: a VTU time series -> the port's vtu CLI -> its builder
    CLI (bricked once) -> its viewer CLI, each timestep against its
    stored golden."""
    from test_end_to_end import _write_vtu_hexes

    from owlexabrick_tpu_torch.builder.__main__ import main as build_main
    from owlexabrick_tpu_torch.tools.vtu import main as vtu_main
    from owlexabrick_tpu_torch.viewer.offline import main as view_main

    cf = 5 * 500 / 4
    lowers = [(x, y, z) for z in (0, 1) for y in (0, 1) for x in (0, 1)]
    lowers.append((2, 0, 0))
    vals = {0: np.concatenate([np.linspace(0.1, 0.8, 8), [1.0]]),
            1: np.concatenate([np.linspace(0.8, 0.1, 8), [0.3]])}
    for t in (0, 1):
        _write_vtu_hexes(str(tmp_path / f"step{t}.vtu"), lowers,
                         [1] * 8 + [2], cf, {"temp": vals[t]})
        assert vtu_main([str(tmp_path / f"step{t}.vtu"), "-o",
                         str(tmp_path / f"step{t}")]) == 0
    assert build_main([str(tmp_path / "step0.cells"), "-o",
                       str(tmp_path / "series.bricks")]) == 0
    imgs = []
    for t in (0, 1):
        (tmp_path / f"step{t}.exa").write_text(
            f"bricks series.bricks\nscalar temp step{t}.temp.scalars\n")
        out = str(tmp_path / f"vtu_t{t}.png")
        assert view_main([
            str(tmp_path / f"step{t}.exa"), "--size", "32", "24",
            "--camera", "14", "9", "13", "2", "1", "1", "0", "1", "0",
            "--fov", "45", "--range", "0", "1", "--dt", "0.7",
            "--frames", "1", "-o", out, "--device", "cpu"]) == 0
        img = read_png(out)
        assert_gate(img, read_png(str(GOLDEN_DIR / f"e2e_vtu_t{t}.png")),
                    f"e2e_vtu_t{t}")
        imgs.append(img.astype(int))
    assert np.abs(imgs[1] - imgs[0]).max() > 16

