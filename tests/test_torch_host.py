"""PyTorch port, host side: the port's jax-free copies of the JAX
package's host helpers (level grids, knots, colormaps, frame state, the
camera-derived integers) must equal the reference's exactly."""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from owlexabrick_tpu.bench_scene import synthetic_volume as ref_synthetic_volume
from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.render.camera import Camera as RefCamera
from owlexabrick_tpu.render.frame import make_frame_state as ref_make_fs
from owlexabrick_tpu.render.pallas_sweep import tile_shape as ref_tile_shape
from owlexabrick_tpu.tools.artificial import parse_grids_text
from owlexabrick_tpu.tools.raw2cells import volume_to_cells as ref_v2c
from owlexabrick_tpu.viewer.colormaps import COLORMAP_NAMES
from owlexabrick_tpu.viewer.colormaps import colormap_colors as ref_colors
from owlexabrick_tpu_torch import bench_scene, interop
from owlexabrick_tpu_torch.render import slabs as P
from owlexabrick_tpu_torch.render.camera import Camera
from owlexabrick_tpu_torch.render.frame import make_frame_state
from owlexabrick_tpu_torch.render.sweep import tile_shape
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells
from owlexabrick_tpu_torch.viewer.colormaps import colormap_colors

from conftest import EX3, EX4

PKG = pathlib.Path(__file__).resolve().parent.parent / "owlexabrick_tpu_torch"


def test_port_imports_without_jax():
    """The port imports no jax, in a fresh interpreter, module by
    module; no source file of the port names jax in an import."""
    mods = sorted(
        "owlexabrick_tpu_torch." + ".".join(
            p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import owlexabrick_tpu_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'owlexabrick_tpu.'))]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert res.returncode == 0, res.stderr
    for p in PKG.rglob("*.py"):
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax"))
                        or "owlexabrick_tpu." in s and "import" in s
                        and not s.startswith("#")), (p, line)


@pytest.mark.parametrize("name", COLORMAP_NAMES)
def test_colormap_colors_every_palette(name):
    assert np.array_equal(colormap_colors(name, 128), ref_colors(name, 128))


def test_frame_state_and_interop():
    cam = Camera.look_at([1.0, 2.0, 30.0], [4.0, 4.0, 4.0], [0, 1, 0],
                         40.0, 48, 32)
    rcam = RefCamera.look_at([1.0, 2.0, 30.0], [4.0, 4.0, 4.0], [0, 1, 0],
                             40.0, 48, 32)
    for f in ("pos", "dir00", "dir_du", "dir_dv"):
        assert np.array_equal(getattr(cam, f), getattr(rcam, f))
    kw = dict(xf_domains=[[0.0, 7.0]], dt=1.0, opacity_scale=0.8,
              colormap="Paraview Cool Warm")
    fs = make_frame_state(cam, 1, **kw)
    ref = ref_make_fs(rcam, 1, **kw)
    moved = interop.frame_state_from_reference(ref)
    for f in dataclasses.fields(fs):
        a = np.asarray(getattr(fs, f.name))
        assert np.array_equal(a, np.asarray(getattr(ref, f.name))), f.name
        assert np.array_equal(a, np.asarray(getattr(moved, f.name))), f.name


def _assert_grids_equal(ref, got):
    assert got.levels == tuple(ref.levels)
    assert got.y_bin == tuple(ref.y_bin)
    assert got.num_channels == ref.num_channels and got.axis == ref.axis
    for name in ("vals", "masks", "vrange_zy"):
        for a, b in zip(getattr(ref, name), getattr(got, name)):
            a = np.asarray(a)
            b = b.cpu().numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert np.array_equal(a, b), name
    for a, b in zip(ref.origins, got.origins):
        assert np.array_equal(np.asarray(a), b)
    for name in ("zranges",):
        assert np.array_equal(np.asarray(getattr(ref, name)),
                              getattr(got, name).cpu().numpy())
    assert np.array_equal(np.asarray(ref.bounds_lo), got.bounds_lo)
    assert np.array_equal(np.asarray(ref.bounds_hi), got.bounds_hi)


@pytest.mark.parametrize("text", [EX3, EX4], ids=["EX3", "EX4"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_level_grids_bit_equal(text, axis):
    """Cell scatter and brick scatter of the port == the reference's
    build_level_grids, bit for bit, for every sweep axis."""
    lower, level, scal = parse_grids_text(text)
    scene, bricks, *_ = scene_from_cells(lower, level, [scal])
    ref = R.build_level_grids(bricks, scene.scalars, axis=axis, device=False)
    _assert_grids_equal(ref, P.level_grids_from_cells(
        lower, level, scal[None], axis=axis, device="cpu"))
    _assert_grids_equal(ref, P.build_level_grids(
        bricks, scene.scalars, axis=axis, device="cpu"))
    _assert_grids_equal(ref, interop.level_grids_from_reference(
        ref, device="cpu"))


@pytest.mark.parametrize("kind", ["blobs", "exajet"])
def test_slab_scene_grids_match_brick_route(kind):
    """bench_scene.slab_scene_grids skips the brick builder; its grids
    equal the reference route (volume -> cells -> bricks -> grids)."""
    n = 32
    if kind == "blobs":
        vol = ref_synthetic_volume(n)
        assert np.array_equal(vol, bench_scene.synthetic_volume(n))
    else:
        from owlexabrick_tpu.bench_scene import exajet_pattern_volume

        vol = exajet_pattern_volume(n)
        assert np.array_equal(vol, bench_scene.exajet_pattern_volume(n))
    lower, level, scal = ref_v2c(vol, 0.004, 3)
    for a, b in zip((lower, level, scal), volume_to_cells(vol, 0.004, 3)):
        assert np.array_equal(a, b)
    scene, bricks, *_ = scene_from_cells(lower, level, [scal])
    ref = R.build_level_grids(bricks, scene.scalars, axis=2, device=False)
    got, meta = bench_scene.slab_scene_grids(kind, n, device="cpu")
    _assert_grids_equal(ref, got)
    assert meta["n_cells"] == lower.shape[0]


def _luts():
    """Alpha-scaled LUTs of several palettes/opacity curves."""
    out = []
    rng = np.random.default_rng(3)
    for name, opac, scale in (
            ("Jet", np.linspace(0, 1, 128), 0.7),
            ("Paraview Cool Warm", np.linspace(0, 1, 128) ** 2, 1.0),
            ("Matplotlib Plasma", np.clip(np.linspace(-0.5, 1.5, 128), 0, 1), 0.3),
            ("Custom", np.full(128, 0.5), 1.0),
            ("Jet", rng.uniform(0, 1, 128), 1.0)):
        lut = np.concatenate([colormap_colors(name, 128),
                              np.asarray(opac, np.float32)[:, None]], 1)
        lut[:, 3] *= np.float32(scale)
        out.append(lut.astype(np.float32))
    return out


@pytest.mark.parametrize("i", range(5))
def test_compress_pwl_matches_reference(i):
    lut = _luts()[i]
    got = P.compress_pwl([lut])
    ref = R.compress_pwl([lut])
    assert (got is None) == (ref is None)
    if got is not None:
        for f in ("pos", "sd", "base", "cum"):
            assert np.array_equal(getattr(got, f),
                                  np.asarray(getattr(ref, f))), f
        assert tuple(got.tau) == tuple(ref.tau)


@pytest.mark.parametrize("hw", [(24, 24), (64, 96), (1080, 1920),
                                (540, 1920), (135, 240), (1024, 2048)])
@pytest.mark.parametrize("tiles", [(0, 0), (16, 128)])
def test_tile_shape_matches(hw, tiles):
    assert tile_shape(*hw, tiles) == ref_tile_shape(*hw, tiles)


def _golden_scene_grids():
    lower, level, scal = volume_to_cells(bench_scene.synthetic_volume(32),
                                         0.004, 3)
    scene, bricks, *_ = scene_from_cells(lower, level, [scal])
    ref = R.build_level_grids(bricks, scene.scalars, axis=2, device=False)
    return ref, interop.level_grids_from_reference(ref, device="cpu")


@pytest.mark.parametrize("eye,fov,hw", [
    ((16.0, 16.0, 67.2), 45.0, (64, 96)),     # golden camera: no crop
    ((16.0, 20.0, 40.0), 8.0, (64, 96)),      # zoomed in: crop engages
    ((10.0, 12.0, -30.0), 20.0, (72, 40)),    # from -z: flipped sweep
])
@pytest.mark.parametrize("stride", [False, True])
def test_camera_integers_match(eye, fov, hw, stride):
    """y crop, y-window hints and chunk depth equal the reference's."""
    ref, got = _golden_scene_grids()
    h, w = hw
    cam = Camera.look_at(eye, [eye[0], eye[1], 16.0], [0, 1, 0], fov, w, h)
    pos, d00, du, dv = P.permute_camera(cam, 2)
    kw = dict(num_channels=1, nslabs=36, chunk=12, adaptive_stride=stride)
    rcfg = R.SlabConfig(**kw)
    pcfg = P.SlabConfig(**kw)
    crop = P.y_crop_for_camera(got, pcfg, pos, d00, dv, h)
    assert crop == R.y_crop_for_camera(ref, rcfg, pos, d00, dv, h)
    hints = P.ky_hints_for_camera(got, pcfg, pos, d00, dv, h, w)
    assert hints == R.ky_hints_for_camera(ref, rcfg, pos, d00, dv, h, w)
    for budget in (7, 1):
        for c in (None, crop):
            g_r = ref if c is None else R.crop_grids_y(ref, c)
            g_p = got if c is None else P.crop_grids_y(got, c)
            assert P.effective_chunk(
                g_p, dataclasses.replace(pcfg, chunk_budget_mb=budget),
                h, w, hints) == R.effective_chunk(
                g_r, dataclasses.replace(rcfg, chunk_budget_mb=budget),
                h, w, hints)
    if eye[1] == 20.0:
        assert crop is not None
        _assert_grids_equal(R.crop_grids_y(ref, crop),
                            P.crop_grids_y(got, crop))


def test_jitter_constants_match_jax_random():
    """chip_smoke.py renders the goldens with the JAX Renderer's jitter
    written as constants; they are jax.random's (renderer.py:453-458)."""
    import chip_smoke

    for f, (jx, jy) in chip_smoke.GOLDEN_JITTER.items():
        key = jax.random.fold_in(jax.random.PRNGKey(0x51AB), f)
        assert jx == float(jax.random.uniform(jax.random.fold_in(key, 0),
                                              ())) - 0.5
        assert jy == float(jax.random.uniform(jax.random.fold_in(key, 1),
                                              ())) - 0.5


def test_default_jitter_matches_jax_random():
    """The Renderer's default jitter (numpy Threefry-2x32) equals the JAX
    Renderer's jax.random jitter bit for bit on frames 0-63."""
    from owlexabrick_tpu_torch.render.renderer import default_jitter

    base = jax.random.PRNGKey(0x51AB)
    for f in range(64):
        key = jax.random.fold_in(base, f)
        want = tuple(float(jax.random.uniform(jax.random.fold_in(key, d),
                                              ())) - 0.5 for d in (0, 1))
        assert default_jitter(f) == want, f


def test_cuda_device_without_card_raises():
    """No fallback: asking for the card where there is none raises, and
    the kernel wrapper refuses CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from owlexabrick_tpu_torch.render.renderer import Renderer
    from owlexabrick_tpu_torch.render.sweep import sweep_chunk_cuda

    lower, level, scal = parse_grids_text(EX3)
    with pytest.raises(RuntimeError):
        Renderer((lower, level, scal[None]), 8, 8, device="cuda")
    with pytest.raises(ValueError):
        sweep_chunk_cuda(None, torch.zeros(2, 2), torch.ones(1), None, 1.0,
                         2, 2, act_f=None, act_all_f=None)
